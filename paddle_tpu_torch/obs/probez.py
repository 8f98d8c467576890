"""Active correctness probing (the port of paddle_tpu/obs/probez.py).

Metrics, traces and the memory ledger are PASSIVE: they report how fast
and how big, and none of them can see a replica that serves wrong
answers at perfect latency (a corrupted KV block, a stale weight, an int8
scale-pool bug). This module is the active leg:

  config_fingerprint  deterministic identity of (model config,
                      ServingConfig, torch / CUDA versions and the card's
                      name, PADDLE_TPU_* env) — the key goldens are minted
                      under. Surfaced on every engine's /statusz.

  GoldenStore         host-side pinned golden chains, keyed by
                      (fingerprint, variant), minted ONCE per fingerprint
                      through the reference `generate_static_ragged`.

  Prober              injects golden-canary requests through the REAL
                      serving path (`submit()` + the normal step loop —
                      paged admission, prefix-cache hit AND miss
                      variants, spec decode when configured) and
                      asserts the output chain is BITWISE equal to the
                      pinned golden. Probe requests are tagged end to end
                      and kept out of user-facing SLO/latency/goodput
                      accounting; results feed their own `probe_*` metric
                      families. A failure is a structured `{"probe_fail"}`
                      row naming the variant and the first diverging
                      position, with the memz census attached.

  InvariantAuditor    deep host-side audits on the
                      `TelemetryServer.add_poller` cadence: BlockPool
                      conservation (free + refcounted ≡ capacity, trash
                      block never issued), per-owner block lists ≅
                      refcounts (prefix shares and trie retains
                      included — EXACT accounting), radix-trie ↔ pool
                      cross-check (every device-cached block live,
                      refcounted, off the free list), and int8 scale-pool
                      co-residency. Rendered as `invariant_*` gauges with
                      structured `{"invariant_violation"}` findings on
                      transition.

On the card the static reference and the paged engine attend through
different kernels, so a bf16 chain can differ from its golden at an
argmax near-tie; the Prober stays bitwise (as the JAX one is) and the
caller judges a failure's margin.

Threading: the ServingEngine is NOT internally synchronized — when a
poller thread probes while another thread drives submit()/step(), both
must share one lock around every engine call. `Prober(lock=...)` /
`InvariantAuditor(lock=...)` take that shared lock; they default to a
private one (sufficient when the prober is the only concurrent caller,
e.g. probing an otherwise idle replica).
"""
from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

__all__ = ["config_fingerprint", "GoldenStore", "Prober",
           "InvariantAuditor"]


# ------------------------------------------------------------ fingerprint

def _json_safe(v):
    """Deterministic JSON coercion: callables/objects hash by qualified
    name, never by repr (a function repr embeds its memory address —
    identical replicas would fingerprint apart)."""
    if isinstance(v, (int, float, str, bool, type(None))):
        return v
    if isinstance(v, (list, tuple)):
        return [_json_safe(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _json_safe(x) for k, x in sorted(v.items())}
    if callable(v):
        return "callable:" + getattr(v, "__qualname__",
                                     type(v).__name__)
    return f"{type(v).__module__}.{type(v).__name__}"


def config_fingerprint(model_config, serving_config=None,
                       env: Optional[dict] = None) -> dict:
    """Deterministic fingerprint of everything that decides what bytes a
    greedy chain contains: model config, ServingConfig envelope, the
    torch and CUDA versions with the card's name (None on a host with no
    card), and the PADDLE_TPU_* environment. Two replicas with equal
    `sha` must produce bit-identical output for the same prompt — which
    is why goldens are keyed by it."""
    card = torch.cuda.get_device_name(0) \
        if torch.cuda.is_available() else None
    if env is None:
        env = {k: v for k, v in os.environ.items()
               if k.startswith("PADDLE_TPU_")}
    components = {
        "model": _json_safe(dict(vars(model_config))
                            if not isinstance(model_config, dict)
                            else model_config),
        "serving": _json_safe(dict(vars(serving_config))
                              if serving_config is not None
                              and not isinstance(serving_config, dict)
                              else (serving_config or {})),
        "versions": {"torch": torch.__version__,
                     "cuda": torch.version.cuda, "card": card},
        "env": {k: env[k] for k in sorted(env)},
    }
    blob = json.dumps(components, sort_keys=True,
                      separators=(",", ":")).encode("utf-8")
    return {"sha": hashlib.sha256(blob).hexdigest()[:16],
            "components": components}


# ------------------------------------------------------------ golden store

class GoldenStore:
    """Host-side pinned golden chains keyed by (fingerprint sha,
    variant). One store shared across a fleet's probers means each
    golden is minted ONCE per model+config fingerprint — replicas with
    the same fingerprint ride the same pinned truth, and a replica
    whose fingerprint drifted simply mints (and fails) under its own
    key, which is what makes drift explain probe misses."""

    def __init__(self):
        self._chains: Dict[tuple, np.ndarray] = {}
        self._lock = threading.Lock()
        self.minted_total = 0

    def __len__(self):
        return len(self._chains)

    def get(self, sha: str, variant: str) -> Optional[np.ndarray]:
        with self._lock:
            return self._chains.get((sha, variant))

    def get_or_mint(self, sha: str, variant: str,
                    mint: Callable[[], np.ndarray]) -> np.ndarray:
        with self._lock:
            chain = self._chains.get((sha, variant))
            if chain is None:
                chain = np.asarray(mint(), dtype=np.int64)
                self._chains[(sha, variant)] = chain
                self.minted_total += 1
        return chain


# ----------------------------------------------------------------- prober

class _VariantState:
    __slots__ = ("prompt", "pass_total", "fail_total", "noise_total",
                 "failing", "last_status", "last_reason",
                 "last_latency_s", "last_divergence", "last_ts")

    def __init__(self, prompt: np.ndarray):
        self.prompt = prompt
        self.pass_total = 0
        self.fail_total = 0
        self.noise_total = 0            # rejected/timeout: prober noise
        self.failing = False
        self.last_status: Optional[str] = None
        self.last_reason: Optional[str] = None
        self.last_latency_s: Optional[float] = None
        self.last_divergence: Optional[int] = None
        self.last_ts: Optional[float] = None

    def to_dict(self) -> dict:
        return {"pass_total": self.pass_total,
                "fail_total": self.fail_total,
                "noise_total": self.noise_total,
                "failing": self.failing,
                "last_status": self.last_status,
                "last_reason": self.last_reason,
                "last_latency_s": self.last_latency_s,
                "first_divergence": self.last_divergence,
                "prompt_tokens": int(self.prompt.shape[0])}


class Prober:
    """Golden-canary correctness sentinel for ONE engine/replica.

    `probe_once()` is one cycle: every variant submits through the real
    `submit()` path (tagged `probe=True`, so user-facing SLO/latency/
    goodput accounting never sees it), rides the normal step loop to a
    terminal status, and its generated chain is compared BITWISE to the
    pinned golden. Per-variant pass/fail is a transition state machine:
    one structured `{"probe_fail"}` row (memz
    census attached) on entry into failure, one inert `{"probe_clear"}`
    row on recovery — never a row per failing cycle. Rejected/timed-out
    probes (a draining or saturated replica) are prober NOISE, not
    correctness failures.

    Variants adapt to the engine's config so probes cover the
    executables users actually ride:

      decode       always — plain admission + chunked greedy decode
      prefix_miss  prefix_cache engines: a sub-block prompt that can
                   never be cached, so EVERY cycle runs the full
                   prefill miss path
      prefix_hit   prefix_cache engines: a block-aligned pinned prompt —
                   first cycle seeds the trie, every later cycle is the
                   zero-prefill hit + COW path (the path a corrupted
                   cached block breaks)
      spec         spec_decode engines: a block-aligned prompt whose
                   cached chain prompt-lookup-drafts its own future —
                   the verify executable end-to-end

    Call `warm()` during engine warmup: it mints the goldens (the
    reference `generate_static_ragged` executable compiles there) and
    runs one cycle, so steady-state probing adds ZERO jit cache misses.
    """

    def __init__(self, engine, *, store: Optional[GoldenStore] = None,
                 max_new_tokens: Optional[int] = None,
                 replica: Optional[str] = None, seed: int = 1217,
                 max_steps: int = 512, lock=None,
                 clock: Callable[[], float] = time.monotonic):
        self.engine = engine
        self.store = store if store is not None else GoldenStore()
        self.replica = replica
        self.max_steps = int(max_steps)
        self.lock = lock if lock is not None else threading.Lock()
        self.clock = clock
        self.auditor = None             # serve_telemetry composes one in
        cfg = engine.config
        self.k = cfg.max_new_tokens if max_new_tokens is None \
            else min(int(max_new_tokens), cfg.max_new_tokens)
        self.fingerprint = engine.fingerprint()
        self.cycles_total = 0
        self.failures_total = 0
        self.last_fail: Optional[dict] = None
        self._vstates: Dict[str, _VariantState] = {}
        rng = np.random.RandomState(seed)
        for name, prompt in self._build_variants(cfg, rng):
            self._vstates[name] = _VariantState(prompt)

    # ------------------------------------------------------- construction
    def _build_variants(self, cfg, rng):
        vocab = int(self.engine.model.config.vocab_size)

        def prompt(n):
            return rng.randint(1, vocab, (n,)).astype(np.int64)

        out = [("decode", prompt(max(1, min(cfg.prompt_cap, 8))))]
        if cfg.paged and cfg.prefix_cache:
            bs = cfg.kv_block
            aligned = min(2 * bs, (cfg.prompt_cap // bs) * bs)
            if aligned >= bs:
                # sub-block length: never forms a full block, so the trie
                # never caches it — every cycle is a genuine miss
                out.append(("prefix_miss",
                            prompt(max(1, min(bs - 1, cfg.prompt_cap)))))
                out.append(("prefix_hit", prompt(aligned)))
                if cfg.spec_decode:
                    out.append(("spec", prompt(aligned)))
        return out

    @property
    def variants(self) -> Dict[str, np.ndarray]:
        return {name: st.prompt for name, st in self._vstates.items()}

    @property
    def failing(self) -> bool:
        return any(st.failing for st in self._vstates.values())

    # ------------------------------------------------------------ goldens
    def _mint(self, prompt: np.ndarray) -> np.ndarray:
        """The reference chain: `generate_static_ragged` on the same
        prompt under the engine's exact sampling/dtype envelope — the
        oracle the engine's bit-identity acceptance tests already pin,
        so golden == engine output is the DEFINITION of healthy."""
        cfg = self.engine.config
        cap = int(cfg.prompt_cap)
        ids = np.zeros((1, cap), np.int64)
        ids[0, :prompt.shape[0]] = prompt
        out = self.engine.model.generate_static_ragged(
            ids, [int(prompt.shape[0])], max_new_tokens=self.k,
            temperature=cfg.temperature, top_k=cfg.top_k,
            top_p=cfg.top_p, seed=cfg.seed,
            eos_token_id=cfg.eos_token_id,
            weight_dtype=cfg.weight_dtype, cache_dtype=cfg.cache_dtype)
        return out[0, cap:cap + self.k].cpu().numpy()

    def golden(self, variant: str) -> np.ndarray:
        st = self._vstates[variant]
        return self.store.get_or_mint(self.fingerprint["sha"], variant,
                                      lambda: self._mint(st.prompt))

    def probe_blocks(self, variant: str = "prefix_hit") -> List[int]:
        """The pool blocks the variant's cached prefix currently maps —
        the blocks a targeted corruption test flips (the next hit-path
        probe attends them and must diverge)."""
        prefix = getattr(self.engine, "_prefix", None)
        if prefix is None or variant not in self._vstates:
            return []
        blocks, _ = prefix.match(self._vstates[variant].prompt)
        return list(blocks)

    def warm(self) -> "Prober":
        """Mint every golden + run TWO cycles: all probe-side
        executables (the reference generator included) lower HERE,
        keeping the steady-state zero-jit-miss invariant intact with
        the prober attached. Two cycles because the first seeds the
        prefix trie (miss-path executables) and only the second rides
        the zero-prefill full-hit admission path."""
        for name in self._vstates:
            self.golden(name)
        self.probe_once()
        self.probe_once()
        return self

    # ------------------------------------------------------------ probing
    def _run_one(self, variant: str, st: _VariantState) -> dict:
        eng = self.engine
        golden = self.golden(variant)
        t0 = self.clock()
        req = eng.submit(st.prompt, max_new_tokens=self.k, probe=True)
        steps = 0
        while req.status in ("queued", "active") and \
                steps < self.max_steps:
            eng.step()
            steps += 1
        latency = self.clock() - t0
        res = {"variant": variant, "status": req.status,
               "reason": req.reason, "latency_s": latency,
               "request": req.id, "steps": steps}
        if req.status == "done":
            tokens = np.asarray(req.tokens, dtype=np.int64)
            if tokens.shape == golden.shape and \
                    bool(np.array_equal(tokens, golden)):
                res["status"] = "pass"
            else:
                diff = np.nonzero(tokens[:golden.shape[0]] !=
                                  golden[:tokens.shape[0]])[0] \
                    if tokens.shape[0] and golden.shape[0] else np.array([0])
                pos = int(diff[0]) if diff.size else \
                    int(min(tokens.shape[0], golden.shape[0]))
                res.update(status="fail", first_divergence=pos,
                           expected=int(golden[pos])
                           if pos < golden.shape[0] else None,
                           got=int(tokens[pos])
                           if pos < tokens.shape[0] else None)
        elif req.status in ("rejected", "timeout"):
            res["status"] = "noise"     # replica-state refusal, not a
            #                             correctness verdict
        else:                           # "error" / stuck past max_steps:
            # the sentinel cannot confirm correctness — that IS failing
            res["status"] = "fail"
            res["first_divergence"] = None
            if req.status in ("queued", "active"):
                res["reason"] = "stalled"
        return res

    def probe_once(self) -> dict:
        """One full probe cycle over every variant: each runs through the
        real serving path under the shared engine lock, and the
        per-variant transition state machine advances."""
        eng = self.engine
        results = {}
        with self.lock:
            self.cycles_total += 1
            for variant, st in self._vstates.items():
                res = self._run_one(variant, st)
                results[variant] = res
                st.last_status = res["status"]
                st.last_reason = res.get("reason")
                st.last_latency_s = res["latency_s"]
                st.last_ts = time.time()
                if res["status"] == "pass":
                    st.pass_total += 1
                    if st.failing:
                        st.failing = False
                        st.last_divergence = None
                        eng.metrics._emit({"probe_clear":
                                           {"variant": variant,
                                            "replica": self.replica},
                                           "ts": time.time()})
                elif res["status"] == "fail":
                    st.fail_total += 1
                    st.last_divergence = res.get("first_divergence")
                    if not st.failing:
                        st.failing = True
                        self.failures_total += 1
                        self._emit_fail(variant, res)
                else:
                    st.noise_total += 1
        return {"results": results, "failing": self.failing}

    def _emit_fail(self, variant: str, res: dict):
        """The first-class failure event: one structured row on the
        transition into failure, with the memz census as the forensics
        snapshot at the moment of divergence."""
        eng = self.engine
        body = {"variant": variant, "replica": self.replica,
                "request": res.get("request"),
                "reason": res.get("reason"),
                "first_divergence": res.get("first_divergence"),
                "expected": res.get("expected"),
                "got": res.get("got"),
                "fingerprint": self.fingerprint["sha"]}
        memz = getattr(eng, "_memz", None)
        if memz is not None:
            try:
                body["memz_census"] = memz.census()
            except Exception:           # noqa: BLE001 — forensics must
                pass                    # never mask the failure itself
        self.last_fail = dict(body, ts=time.time())
        eng.metrics._emit({"probe_fail": body, "ts": time.time()})

    # ---------------------------------------------------------- reporting
    def probez(self, _query: Optional[dict] = None) -> dict:
        """The /probez payload: overall state, per-variant sentinel
        detail, golden/fingerprint identity, and the invariant auditor's
        summary when one rides along."""
        if not self._vstates:
            state = "idle"
        elif self.failing:
            state = "failing"
        elif any(st.pass_total for st in self._vstates.values()):
            state = "passing"
        else:
            state = "idle"
        out = {"state": state,
               "replica": self.replica,
               "fingerprint": self.fingerprint["sha"],
               "cycles_total": self.cycles_total,
               "failures_total": self.failures_total,
               "goldens": len(self.store),
               "max_new_tokens": self.k,
               "variants": {n: st.to_dict()
                            for n, st in self._vstates.items()}}
        if self.last_fail is not None:
            out["last_fail"] = {k: v for k, v in self.last_fail.items()
                                if k != "memz_census"}
        if self.auditor is not None:
            out["invariants"] = self.auditor.summary()
        return out

    def metrics_text(self, prefix: str = "paddle_tpu_probe") -> str:
        """The probe_* families — deliberately a SEPARATE producer from
        ServingMetrics: a no-prober replica's user-facing exposition is
        byte-identical by construction (the probe/SLO isolation
        guarantee is structural, not subtractive)."""
        p = prefix
        items = sorted(self._vstates.items())
        lines = [f"# HELP {p}_pass_total probe cycles whose chain "
                 f"matched the pinned golden bitwise",
                 f"# TYPE {p}_pass_total counter"]
        lines += [f'{p}_pass_total{{variant="{n}"}} {st.pass_total}'
                  for n, st in items]
        lines += [f"# HELP {p}_fail_total probe cycles that diverged "
                  f"from the golden (or could not complete)",
                  f"# TYPE {p}_fail_total counter"]
        lines += [f'{p}_fail_total{{variant="{n}"}} {st.fail_total}'
                  for n, st in items]
        lines += [f"# HELP {p}_noise_total probes rejected/expired by "
                  f"replica state (draining/overload) — not verdicts",
                  f"# TYPE {p}_noise_total counter"]
        lines += [f'{p}_noise_total{{variant="{n}"}} {st.noise_total}'
                  for n, st in items]
        lat = [(n, st.last_latency_s) for n, st in items
               if st.last_latency_s is not None]
        if lat:
            lines += [f"# HELP {p}_last_latency_seconds wall time of "
                      f"the variant's most recent probe",
                      f"# TYPE {p}_last_latency_seconds gauge"]
            lines += [f'{p}_last_latency_seconds{{variant="{n}"}} '
                      f'{v:.6g}' for n, v in lat]
        lines += [f"# HELP {p}_failing replica currently failing "
                  f"correctness probes (the router ejection signal)",
                  f"# TYPE {p}_failing gauge",
                  f"{p}_failing {1 if self.failing else 0}",
                  f"# HELP {p}_cycles_total probe cycles run",
                  f"# TYPE {p}_cycles_total counter",
                  f"{p}_cycles_total {self.cycles_total}"]
        return "\n".join(lines) + "\n"


# ------------------------------------------------------ invariant auditor

class InvariantAuditor:
    """Deep host-side invariant audits over one paged engine — the
    checks per-request code paths can't afford to run, scheduled on the
    `TelemetryServer.add_poller` cadence (or driven synchronously).

    Checks (all pure host reads — an audit never syncs the device):

      pool_conservation   free + refcounted ≡ capacity_blocks, the free
                          list and refcount table are disjoint, and the
                          trash block (0) was never issued
      owner_refcounts     EXACT accounting: every block's refcount ==
                          its occurrences across per-owner row lists +
                          its device trie nodes — COW/prefix shares and
                          trie retains all reconciled
      trie_pool           every device-cached trie node maps a live
                          block: non-trash, absent from the free list,
                          refcount >= 1; device-node count matches the
                          cache's own counter
      scale_coresidency   int8 pools: every layer's scale planes match
                          their code planes' geometry (scales shard,
                          spill and COW WITH their codes or quantized
                          attention reads garbage)

    Violations are transition events: one `{"invariant_violation"}`
    structured row when a check flips to
    violating, one inert `{"invariant_clear"}` on recovery. A check
    that trips is re-run once before it counts — the audit may race a
    concurrent engine step when no shared lock is passed, and real
    violations persist while mid-step transients vanish."""

    CHECKS = ("pool_conservation", "owner_refcounts", "trie_pool",
              "scale_coresidency")

    def __init__(self, engine, *, lock=None):
        self.engine = engine
        self.lock = lock if lock is not None else threading.Lock()
        self.audits_total = 0
        self.violations_total = 0
        self.skipped_total = 0
        self._ok = {c: True for c in self.CHECKS}
        self.findings: List[dict] = []      # bounded recent violations

    # ------------------------------------------------------------ checks
    def _check_pool_conservation(self, pool) -> List[str]:
        bad = []
        free, refs = list(pool._free), dict(pool._refs)
        if len(free) + len(refs) != pool.capacity_blocks:
            bad.append(f"free({len(free)}) + refcounted({len(refs)}) "
                       f"!= capacity({pool.capacity_blocks})")
        overlap = set(free) & set(refs)
        if overlap:
            bad.append(f"blocks both free and refcounted: "
                       f"{sorted(overlap)[:8]}")
        if 0 in refs or 0 in free:
            bad.append("trash block 0 was issued")
        return bad

    def _trie_device_blocks(self, prefix) -> List[int]:
        blocks = []
        stack = list(prefix._root.children.values())
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            if n.block >= 1:            # SPILLED (-1) lives on the host
                blocks.append(n.block)
        return blocks

    def _check_owner_refcounts(self, pool, prefix) -> List[str]:
        bad = []
        expected: Dict[int, int] = {}
        for owner, row in list(pool._rows.items()):
            for b in list(row):
                expected[b] = expected.get(b, 0) + 1
        if prefix is not None:
            for b in self._trie_device_blocks(prefix):
                expected[b] = expected.get(b, 0) + 1
        refs = dict(pool._refs)
        for b, want in expected.items():
            have = refs.get(b, 0)
            if have != want:
                bad.append(f"block {b}: refcount {have} != "
                           f"{want} (rows + trie)")
        for b in refs:
            if b not in expected:
                bad.append(f"block {b}: refcount {refs[b]} with no "
                           f"owner row or trie node")
        return bad[:8]

    def _check_trie_pool(self, pool, prefix) -> List[str]:
        if prefix is None:
            return []
        bad = []
        free = set(pool._free)
        device = self._trie_device_blocks(prefix)
        for b in device:
            if b in free:
                bad.append(f"trie block {b} is on the free list")
            if pool.refcount(b) < 1:
                bad.append(f"trie block {b} has refcount "
                           f"{pool.refcount(b)}")
        if len(device) != prefix.cached_blocks:
            bad.append(f"trie walk found {len(device)} device blocks, "
                       f"cache counter says {prefix.cached_blocks}")
        return bad[:8]

    def _check_scale_coresidency(self, pool, pools) -> List[str]:
        if pool.cache_dtype != "int8" or pools is None:
            return []
        bad = []
        for i, layer in enumerate(pools):
            if len(layer) != 4:
                bad.append(f"layer {i}: int8 pool tuple has "
                           f"{len(layer)} planes, want 4")
                continue
            kc, ks, vc, vs = layer
            for tag, codes, scales in (("k", kc, ks), ("v", vc, vs)):
                if codes.dtype != torch.int8:
                    bad.append(f"layer {i} {tag}-codes dtype "
                               f"{codes.dtype}")
                if tuple(scales.shape) != tuple(codes.shape[:-1]):
                    bad.append(f"layer {i} {tag}-scales shape "
                               f"{tuple(scales.shape)} does not cover "
                               f"codes {tuple(codes.shape)}")
                if codes.shape[0] != pool.num_blocks:
                    bad.append(f"layer {i} {tag}-codes holds "
                               f"{codes.shape[0]} blocks, pool has "
                               f"{pool.num_blocks}")
        return bad[:8]

    def _run_checks(self) -> Dict[str, List[str]]:
        eng = self.engine
        if not eng.config.paged:
            return {c: [] for c in self.CHECKS}
        pool = eng._pool
        prefix = getattr(eng, "_prefix", None)
        pools = getattr(eng, "_pools", None)
        return {
            "pool_conservation": self._check_pool_conservation(pool),
            "owner_refcounts": self._check_owner_refcounts(pool, prefix),
            "trie_pool": self._check_trie_pool(pool, prefix),
            "scale_coresidency": self._check_scale_coresidency(pool,
                                                               pools),
        }

    # ------------------------------------------------------------- audit
    def audit(self) -> dict:
        """One audit pass; the poller entry point. Returns the summary
        (also served inside /probez)."""
        with self.lock:
            try:
                found = self._run_checks()
                if any(found.values()):
                    # double-check: a lock-free audit can race one
                    # engine step mid-mutation; real violations persist
                    found = self._run_checks()
            except RuntimeError:
                # host dict resized under the walk — skip this cycle,
                # the next one sees a quiescent snapshot
                self.skipped_total += 1
                return self.summary()
            self.audits_total += 1
            for check, bad in found.items():
                if bad and self._ok[check]:
                    self._ok[check] = False
                    self.violations_total += 1
                    body = {"check": check, "detail": bad}
                    self.findings.append(dict(body, ts=time.time()))
                    del self.findings[:-64]
                    self.engine.metrics._emit(
                        {"invariant_violation": body,
                         "ts": time.time()})
                elif not bad and not self._ok[check]:
                    self._ok[check] = True
                    self.engine.metrics._emit(
                        {"invariant_clear": {"check": check},
                         "ts": time.time()})
        return self.summary()

    @property
    def violating(self) -> bool:
        return not all(self._ok.values())

    def summary(self) -> dict:
        return {"ok": dict(self._ok),
                "violating": self.violating,
                "audits_total": self.audits_total,
                "violations_total": self.violations_total,
                "skipped_total": self.skipped_total,
                "findings": self.findings[-4:]}

    def metrics_text(self, prefix: str = "paddle_tpu_invariant") -> str:
        p = prefix
        lines = [f"# HELP {p}_ok deep invariant check currently "
                 f"holding (0 = violated)",
                 f"# TYPE {p}_ok gauge"]
        lines += [f'{p}_ok{{check="{c}"}} {1 if ok else 0}'
                  for c, ok in sorted(self._ok.items())]
        lines += [f"# HELP {p}_audits_total audit passes completed",
                  f"# TYPE {p}_audits_total counter",
                  f"{p}_audits_total {self.audits_total}",
                  f"# HELP {p}_violations_total checks that flipped "
                  f"into violation",
                  f"# TYPE {p}_violations_total counter",
                  f"{p}_violations_total {self.violations_total}",
                  f"# HELP {p}_skipped_total audit passes skipped on a "
                  f"concurrent-mutation race",
                  f"# TYPE {p}_skipped_total counter",
                  f"{p}_skipped_total {self.skipped_total}"]
        return "\n".join(lines) + "\n"
