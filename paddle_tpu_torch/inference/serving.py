"""Continuous-batching GPT serving (the port of
paddle_tpu/inference/serving.py's padded and paged engines).

  ServingEngine   admits prompts into a bounded queue and serves them.
                  paged=False (the default) runs the static decode stack:
                  each step takes up to max_batch queued requests as one
                  fixed [max_batch, prompt_cap] right-padded batch,
                  prefills it (`prefill_static`) and decodes it in a
                  [1, c, c, ...] chunk schedule (`decode_static`), each row
                  finishing at chunk granularity.
                  paged=True serves with
                  slot-level continuous batching over a paged KV block pool
                  (inference/kv_cache.py): each batch slot runs its own
                  request, a finished row frees its blocks at once, and a
                  queued request is spliced into the vacated slot
                  mid-flight (one [1, prompt_cap] prefill per admission,
                  then the row joins the next [B, decode_chunk] decode
                  chunk). An oversubscribed pool makes admission wait for
                  freed blocks; only a request that could never fit is
                  rejected.

                  Three options share the multi-token paged-attention
                  kernel (a [B, S] query window at per-row offsets):
                  prefix_cache   a radix trie (inference/prefix_cache.py)
                                 maps cached full blocks of a prompt into
                                 the new request's table; a partial hit
                                 prefills only the suffix, a full hit
                                 prefills nothing and re-decodes the last
                                 prompt token (copy-on-write of the last
                                 block when it is shared);
                  prefill_chunk  prompts prefill in [1, prefill_chunk]
                                 windows, one per engine step, between
                                 decode chunks;
                  spec_decode    each decode step verifies spec_k drafted
                                 tokens (from the trie, or a callable) in
                                 one [B, spec_k + 1] window; greedy output
                                 equals the plain chain.

  RequestTrace    per-request timestamps (enqueue -> admit -> prefill ->
                  first token -> finish) and the engine-call windows the
                  request rode.

  ServingMetrics  log-bucketed TTFT / TPOT / e2e / queue-wait histograms,
                  the speculative accept-length histogram, queue and KV
                  gauges, request, token, prefix and spec counters.

  model_draft_fn  turns a (small) GPT into a `spec_draft` callable that
                  drafts through its `generate_static_ragged`.

Greedy engine output equals the JAX engine's and the JAX
`generate_static_ragged`'s token chains per request (tests). On a CUDA
model every attention call of the paged serving path runs a hand-written
paged-attention kernel, and under weight_dtype="int8" every projection and
the LM head of either engine run the hand-written int8 GEMM.

Not ported yet: the host spill tier (spill_host_bytes; its own item of
queue A in ROADMAP.md), shards > 1 (multi-GPU slice), and the graph-lint,
recompile accounting, per-request JSONL rows, Prometheus text, telemetry
server, memz, chaos, probe and fleet-router hooks.
"""
from __future__ import annotations

import math
import time
from bisect import bisect_left
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from .kv_cache import BlockPool
from .prefix_cache import PrefixCache


# --------------------------------------------------------------- requests

@dataclass
class RequestTrace:
    """Timestamps of one request's life (engine clock seconds) and the
    engine-call windows it rode, as (name, t0, t1) tuples ("prefill",
    "suffix_prefill", "prefill_chunk", "decode", "spec_verify"). finish
    is stamped at the end of the decode chunk in which
    the row hit EOS or its budget."""
    t_enqueue: Optional[float] = None
    t_admit: Optional[float] = None
    t_prefill_done: Optional[float] = None
    t_first_token: Optional[float] = None
    t_finish: Optional[float] = None
    batch_id: Optional[int] = None
    events: List[tuple] = field(default_factory=list)

    @property
    def queue_s(self) -> Optional[float]:
        if self.t_admit is None or self.t_enqueue is None:
            return None
        return self.t_admit - self.t_enqueue

    @property
    def ttft_s(self) -> Optional[float]:
        if self.t_first_token is None or self.t_enqueue is None:
            return None
        return self.t_first_token - self.t_enqueue

    @property
    def e2e_s(self) -> Optional[float]:
        if self.t_finish is None or self.t_enqueue is None:
            return None
        return self.t_finish - self.t_enqueue

    def tpot_s(self, n_out: int) -> Optional[float]:
        """Per-output-token time over the post-first-token stretch."""
        if self.t_finish is None or self.t_first_token is None or n_out < 2:
            return None
        return (self.t_finish - self.t_first_token) / (n_out - 1)


@dataclass(eq=False)     # holds an ndarray: identity, not value, equality
class Request:
    """One admitted (or refused) generation request."""
    id: int
    prompt: np.ndarray                      # 1-D int token ids
    max_new_tokens: int
    status: str = "queued"   # queued|active|done|rejected|timeout|error
    reason: Optional[str] = None            # rejection/timeout detail
    deadline_s: Optional[float] = None      # max queue wait before admit
    tokens: Optional[np.ndarray] = None     # generated ids (done only)
    n_out: int = 0                          # tokens up to & incl. EOS
    # speculative decoding: draft tokens proposed for this request across
    # its verify windows, and how many the target accepted
    spec_proposed: int = 0
    spec_accepted: int = 0
    trace: RequestTrace = field(default_factory=RequestTrace)

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])


# ---------------------------------------------------------------- metrics

class LogHistogram:
    """Fixed-memory histogram with log-spaced bucket bounds
    lo * 10^(k / per_decade) up to hi (or the explicit `bounds`), plus an
    overflow bucket. Percentiles interpolate inside the containing bucket
    and clamp to the observed min/max."""

    def __init__(self, lo: float = 1e-4, hi: float = 1e3,
                 per_decade: int = 10,
                 bounds: Optional[Sequence[float]] = None):
        if bounds is not None:
            self.bounds = [float(b) for b in bounds]
        else:
            n = int(math.ceil(per_decade * math.log10(hi / lo))) + 1
            self.bounds = [lo * 10.0 ** (k / per_decade) for k in range(n)]
        self.counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.sum = 0.0
        self._min: Optional[float] = None
        self._max: Optional[float] = None

    def observe(self, v: float):
        v = float(v)
        if v != v:
            raise ValueError("cannot observe NaN")
        self.counts[bisect_left(self.bounds, v)] += 1
        self.count += 1
        self.sum += v
        self._min = v if self._min is None else min(self._min, v)
        self._max = v if self._max is None else max(self._max, v)

    def percentile(self, q: float) -> Optional[float]:
        """q in [0, 1]."""
        if not self.count:
            return None
        target = q * self.count
        cum = 0.0
        for i, c in enumerate(self.counts):
            if not c:
                continue
            if cum + c >= target:
                lower = self.bounds[i - 1] if i > 0 else \
                    min(self._min, self.bounds[0])
                upper = self.bounds[i] if i < len(self.bounds) else self._max
                val = lower + (target - cum) / c * (upper - lower)
                return min(max(val, self._min), self._max)
            cum += c
        return self._max

    def summary(self) -> dict:
        return {"count": self.count,
                "mean": self.sum / self.count if self.count else None,
                "p50": self.percentile(0.50),
                "p90": self.percentile(0.90),
                "p99": self.percentile(0.99)}


class ServingMetrics:
    """Request-level serving telemetry: histograms, gauges and counters.
    The JAX package's per-request JSONL rows and Prometheus exposition
    arrive with the telemetry slice."""

    HISTS = ("ttft_seconds", "tpot_seconds", "e2e_seconds", "queue_seconds",
             "spec_accept_len")

    def __init__(self):
        self.hists = {name: LogHistogram() for name in self.HISTS
                      if name != "spec_accept_len"}
        # tokens emitted per verify window (1..spec_k+1): half-integer
        # bounds resolve every integer exactly
        self.hists["spec_accept_len"] = LogHistogram(
            bounds=[i + 0.5 for i in range(33)])
        self.counters = {"requests": 0, "completed": 0, "rejected": 0,
                         "overloaded": 0, "timeout": 0, "errors": 0,
                         "tokens_in": 0, "tokens_out": 0, "batches": 0,
                         # prefix cache: admissions that mapped >= 1 cached
                         # block / none, and prompt tokens whose prefill
                         # was skipped because their KV was pooled
                         "prefix_hit": 0, "prefix_miss": 0,
                         "prefill_tokens_saved": 0,
                         # speculative decoding: windows, draft tokens
                         # proposed / accepted, and each draft's source
                         "spec_windows": 0, "spec_proposed": 0,
                         "spec_accepted": 0, "spec_drafts_trie": 0,
                         "spec_drafts_model": 0}
        self.gauges = {"queue_depth": 0, "inflight": 0,
                       "batch_fill_ratio": None, "kv_occupancy": None,
                       "kv_slots_occupancy": None, "kv_shared_tokens": None}

    def record_request(self, req: Request):
        self.counters["requests"] += 1
        t = req.trace
        if req.status == "done":
            self.counters["completed"] += 1
            self.counters["tokens_in"] += req.prompt_len
            self.counters["tokens_out"] += req.n_out
            for name, val in (("ttft_seconds", t.ttft_s),
                              ("tpot_seconds", t.tpot_s(req.n_out)),
                              ("e2e_seconds", t.e2e_s),
                              ("queue_seconds", t.queue_s)):
                if val is not None:
                    self.hists[name].observe(max(val, 0.0))
        elif req.status == "timeout":
            self.counters["timeout"] += 1
            # expired requests carry the longest queue waits there are
            if t.t_finish is not None and t.t_enqueue is not None:
                self.hists["queue_seconds"].observe(
                    max(t.t_finish - t.t_enqueue, 0.0))
        elif req.status == "rejected":
            self.counters["rejected"] += 1
            if req.reason == "overloaded":
                self.counters["overloaded"] += 1
        elif req.status == "error":
            self.counters["errors"] += 1

    def record_batch(self, *, n_real: int, capacity: int, kv_tokens: int,
                     kv_slots: int, kv_capacity: int, queue_depth: int,
                     kv_shared_tokens: int = 0):
        """kv_tokens = live (attendable) KV rows, each distinct block
        counted once; kv_slots = rows the reserved blocks pin; kv_capacity
        = total pooled rows; kv_shared_tokens = rows the live requests
        read from blocks they mapped shared from the prefix cache."""
        self.counters["batches"] += 1
        self.gauges["batch_fill_ratio"] = n_real / max(capacity, 1)
        self.gauges["kv_occupancy"] = kv_tokens / max(kv_capacity, 1)
        self.gauges["kv_slots_occupancy"] = kv_slots / max(kv_capacity, 1)
        self.gauges["queue_depth"] = queue_depth
        self.gauges["kv_shared_tokens"] = kv_shared_tokens

    def summary(self) -> dict:
        out = {**{f"{k}_total": v for k, v in self.counters.items()},
               **self.gauges}
        for name in self.HISTS:
            if self.hists[name].count:
                out[name] = self.hists[name].summary()
        return out


# ----------------------------------------------------------------- engine

@dataclass
class ServingConfig:
    """Fixed-shape envelope of a ServingEngine (every field of the JAX
    ServingConfig). Options that belong to later slices raise
    NotImplementedError naming the slice."""
    max_batch: int = 4              # batch slots (dummies fill the rest)
    prompt_cap: int = 64            # right-padding cap; longer = rejected
    max_new_tokens: int = 32        # per-request budget ceiling
    decode_chunk: Optional[int] = None  # tokens per decode call;
    #                                 default max_new_tokens-1 = one chunk
    queue_capacity: int = 256       # bounded admission queue
    # queue depth at/above this sheds new requests as "overloaded" before
    # the queue hits capacity; None = shed only at queue_capacity
    queue_high_watermark: Optional[int] = None
    deadline_s: Optional[float] = None  # default queue-wait deadline
    eos_token_id: Optional[int] = None
    pad_token_id: int = 0
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    weight_dtype: Optional[str] = None   # "int8" -> weight-only int8 GEMMs
    cache_dtype: Optional[str] = None    # "int8" -> int8 KV caches / pools
    paged: bool = False             # False: the padded static engine
    kv_block: int = 16              # KV rows per pool block
    kv_blocks: Optional[int] = None  # total pool blocks INCL. trash block;
    #                            default = worst case for max_batch rows
    shards: Optional[int] = None
    # prefix cache: cached full blocks of a prompt map shared into the new
    # request's table; a full hit skips prefill, a partial hit prefills
    # only the suffix. prefix_cache_bytes is the LRU budget for cached
    # blocks (None = bounded by the pool; admission reclaims under
    # pressure)
    prefix_cache: bool = False
    prefix_cache_bytes: Optional[int] = None
    spill_host_bytes: Optional[int] = None
    # speculative decoding: each decode step verifies spec_k drafted
    # tokens plus the pending one in one [B, spec_k + 1] window; greedy
    # only. spec_draft "trie" drafts from the prefix cache's cached
    # continuations (requires prefix_cache=True; block-granular, so keep
    # kv_block below the typical generation length); a callable
    # (context tokens, k) -> up to k token ids fills the trie's misses
    spec_decode: bool = False
    spec_k: int = 4
    spec_draft: object = "trie"
    # chunked prefill: prompts prefill in [1, prefill_chunk] windows, one
    # per engine step, so a long prompt never stalls the decode batch
    prefill_chunk: Optional[int] = None
    lint: object = None

    def __post_init__(self):
        if self.max_batch < 1 or self.prompt_cap < 1 \
                or self.max_new_tokens < 1:
            raise ValueError("max_batch, prompt_cap and max_new_tokens "
                             "must be >= 1")
        if self.decode_chunk is None:
            self.decode_chunk = max(1, self.max_new_tokens - 1)
        elif self.decode_chunk < 1:
            raise ValueError(f"decode_chunk must be >= 1, "
                             f"got {self.decode_chunk}")
        if self.queue_high_watermark is not None and \
                not (1 <= self.queue_high_watermark <= self.queue_capacity):
            raise ValueError(
                f"queue_high_watermark must be in [1, queue_capacity="
                f"{self.queue_capacity}], got {self.queue_high_watermark}")
        if self.prefix_cache and not self.paged:
            raise ValueError("prefix_cache=True requires paged=True (the "
                             "trie shares BLOCK-pool blocks; the padded "
                             "engine has no blocks to share)")
        if self.spill_host_bytes is not None and not self.prefix_cache:
            raise ValueError("spill_host_bytes requires prefix_cache="
                             "True (the spill tier holds EVICTED trie "
                             "blocks; without the trie nothing is ever "
                             "evicted into it)")
        if self.spec_decode:
            if not self.paged:
                raise ValueError("spec_decode=True requires paged=True "
                                 "(the verify call runs the [B, k] "
                                 "multi-token kernel over the block "
                                 "pool)")
            if not (1 <= self.spec_k <= 31):
                # keeps the spec_accept_len histogram's exact-integer
                # buckets (counts <= 32 = spec_k + 1) honest
                raise ValueError(f"spec_k must be in [1, 31], "
                                 f"got {self.spec_k}")
            if self.temperature > 0.0:
                raise ValueError(
                    "spec_decode=True requires greedy sampling "
                    "(temperature=0): the bit-exact acceptance rule is "
                    "argmax equality; sampled speculative decoding needs "
                    "a rejection-sampling rule this engine does not "
                    "implement")
            if self.spec_draft == "trie":
                if not self.prefix_cache:
                    raise ValueError(
                        "spec_draft='trie' requires prefix_cache=True "
                        "(prompt-lookup drafts are the radix trie's "
                        "cached continuation tokens); pass a callable "
                        "spec_draft to use a draft model instead")
            elif not callable(self.spec_draft):
                raise ValueError(f"spec_draft must be 'trie' or a "
                                 f"callable (context, k) -> tokens; got "
                                 f"{self.spec_draft!r}")
        if self.prefill_chunk is not None:
            if not self.paged:
                raise ValueError("prefill_chunk requires paged=True (the "
                                 "chunk windows write pool blocks via "
                                 "the start-offset executable)")
            if not (1 <= self.prefill_chunk <= self.prompt_cap):
                raise ValueError(
                    f"prefill_chunk must be in [1, prompt_cap="
                    f"{self.prompt_cap}], got {self.prefill_chunk}")
        if self.weight_dtype not in (None, "int8"):
            raise ValueError(f"weight_dtype must be None or 'int8' (weight-"
                             f"only int8 GEMMs); got {self.weight_dtype!r}")
        later = (
            ("spill_host_bytes", self.spill_host_bytes is not None,
             "the host spill tier (its own item of queue A in ROADMAP.md)"),
            ("shards", (self.shards or 1) > 1, "the multi-GPU slice"),
            ("lint", self.lint is not None,
             "the observability slice (graph lint)"))
        for name, on, where in later:
            if on:
                raise NotImplementedError(
                    f"ServingConfig.{name} is not ported to PyTorch yet: it "
                    f"comes with {where}")
        if self.paged:
            # the padded engine checks cache_dtype (None, the model dtype
            # or "int8") at its first prefill, as the JAX engine does
            if self.cache_dtype not in (None, "int8"):
                raise ValueError(f"paged cache_dtype must be None or "
                                 f"'int8'; got {self.cache_dtype!r}")
            if self.kv_block < 1:
                raise ValueError(f"kv_block must be >= 1, "
                                 f"got {self.kv_block}")
            if self.kv_blocks is None:
                # worst case: every slot holds a cap prompt decoding its
                # full budget (+1 for the trash block); smaller pools
                # oversubscribe
                self.kv_blocks = self.max_batch * self.table_width + 1

    @property
    def row_kv_rows(self) -> int:
        """Worst-case KV rows one request writes: cap prompt + full budget
        minus the never-written last sampled token."""
        return self.prompt_cap + self.max_new_tokens - 1

    @property
    def table_width(self) -> int:
        """Block-table columns per batch slot (worst-case blocks/row)."""
        return -(-self.row_kv_rows // self.kv_block)

    @property
    def chunk_schedule(self) -> List[int]:
        """Padded engine: decode-call sizes per batch, [1, c, c, ...]
        covering max_new_tokens (the tail chunk still runs full width and
        over-generated tokens are truncated per row)."""
        if self.max_new_tokens == 1:
            return [1]
        k = math.ceil((self.max_new_tokens - 1) / self.decode_chunk)
        return [1] + [self.decode_chunk] * k

    @property
    def max_len(self) -> int:
        """Padded engine: KV rows per batch row, the prompt cap plus the
        chunk schedule's worst-case cache writes (the last sampled token
        is never written)."""
        return self.prompt_cap + max(sum(self.chunk_schedule), 2) - 1


class ServingEngine:
    """Continuous-batching serving loop.

    Synchronous: `submit()` enqueues and `step()` serves; `drain()` loops
    until the queue (and, paged, the slots) are empty. Padded
    (paged=False): a step runs ONE fixed-shape micro-batch of up to
    max_batch queued requests to completion. Paged: a step splices queued
    requests into free slots, advances chunked prefills by one window and
    runs ONE decode chunk (or speculative verify window) over the live
    slots. Not internally synchronized: hold one lock around every engine
    call when several threads drive it. The engine runs on the model's
    device; caches and pools are allocated there and updated in place.
    `clock` is injectable (tests drive deadlines deterministically)."""

    def __init__(self, model, config: ServingConfig, *,
                 metrics: Optional[ServingMetrics] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.model = model
        self.config = config
        self.metrics = metrics or ServingMetrics()
        self.clock = clock
        self._queue: deque = deque()
        self._next_id = 0
        self._batch_id = 0
        if not config.paged:
            return
        B, MB = config.max_batch, config.table_width
        self._pool = BlockPool.for_model(model, num_blocks=config.kv_blocks,
                                         block_size=config.kv_block,
                                         cache_dtype=config.cache_dtype)
        self._pools = self._pool.make_pools()
        self._slots: List[Optional[Request]] = [None] * B
        self._tables = np.zeros((B, MB), np.int32)
        self._lens = np.zeros((B,), np.int32)
        self._pending = np.zeros((B,), np.int32)
        self._done = np.ones((B,), bool)
        self._calls = 0            # sampling seed cursor
        # (physical live tokens, reserved rows, logical shared tokens) at
        # the last step's decode entry
        self._kv_snapshot = (0, 0, 0)
        # per slot: lens tokens living in blocks mapped shared from the
        # prefix cache (the kv_shared_tokens gauge)
        self._shared_tok = np.zeros((B,), np.int64)
        self._prefix = PrefixCache(
            self._pool, byte_budget=config.prefix_cache_bytes) \
            if config.prefix_cache else None
        # chunked prefill: next prompt position to prefill per slot; -1 =
        # not mid-prefill (a decode row)
        self._prefill_pos = np.full((B,), -1, np.int64)
        # speculative decoding: the trie drafts first, this callable fills
        # its misses
        self._draft_fn = config.spec_draft \
            if callable(config.spec_draft) else None

    # -- admission ------------------------------------------------------
    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    @property
    def busy(self) -> bool:
        """Work remains: queued requests or live slots still decoding."""
        return bool(self._queue) or (self.config.paged
                                     and bool(self._live()))

    def _refusal(self, plen: int, want: int) -> Optional[str]:
        """Why a request is statically unservable, or None."""
        cfg = self.config
        if want < 1:
            return "max_new_tokens"
        if plen < 1 or plen > cfg.prompt_cap:
            return "prompt_shape"
        if cfg.paged and not self._pool.fits_ever(plen + want - 1):
            return "kv_oom"
        return None

    def submit(self, prompt, max_new_tokens: Optional[int] = None,
               deadline_s: Optional[float] = None) -> Request:
        """Admit one prompt into the bounded queue. Returns the Request:
        status "queued" on success, "rejected" with a reason otherwise
        (prompt_shape: outside [1, prompt_cap]; kv_oom: the paged pool
        could not hold it even drained; overloaded / queue_full: load
        shed)."""
        cfg = self.config
        prompt = np.asarray(prompt, dtype=np.int64).reshape(-1)
        want = cfg.max_new_tokens if max_new_tokens is None \
            else min(int(max_new_tokens), cfg.max_new_tokens)
        req = Request(id=self._next_id, prompt=prompt, max_new_tokens=want,
                      deadline_s=cfg.deadline_s if deadline_s is None
                      else deadline_s)
        self._next_id += 1
        req.trace.t_enqueue = self.clock()
        reason = self._refusal(req.prompt_len, want)
        if reason is None and cfg.queue_high_watermark is not None and \
                len(self._queue) >= cfg.queue_high_watermark:
            reason = "overloaded"
        if reason is None and len(self._queue) >= cfg.queue_capacity:
            reason = "queue_full"
        if reason is not None:
            req.status, req.reason = "rejected", reason
            self.metrics.record_request(req)
            return req
        self._queue.append(req)
        self.metrics.gauges["queue_depth"] = len(self._queue)
        return req

    # -- the slot-level batching loop -------------------------------------
    def _live(self) -> List[int]:
        return [i for i, r in enumerate(self._slots) if r is not None]

    def step(self) -> List[Request]:
        """One engine step; returns every request that reached a terminal
        status in it (served rows and queue-deadline timeouts). Padded: the
        next micro-batch (`_run_batch`). Paged: splice queued requests
        into free slots (the prefix cache decides what each must prefill),
        advance every chunked prefill by one window, then run ONE decode
        chunk (or speculative verify window) over the decodable slots. If
        a device call raises, the in-flight requests are recorded as
        status "error" (paged: the pool and the prefix cache are rebuilt)
        and the exception propagates."""
        if not self.config.paged:
            return self._step_padded()
        live = []
        try:
            finished, expired, admitted = self._admit_paged()
            pf_done, pf_ran = self._advance_prefill()
            finished.extend(pf_done)
            live = self._decodable()
            if live:
                if self.config.spec_decode:
                    finished.extend(self._decode_chunk_spec(live))
                else:
                    finished.extend(self._decode_chunk_paged(live))
        except BaseException:
            now = self.clock()
            for i, r in enumerate(self._slots):
                if r is not None:
                    r.status, r.reason = "error", "engine_exception"
                    r.trace.t_finish = now
                    self.metrics.record_request(r)
                    self._slots[i] = None
                    self._clear_slot(i)
            # a failed call may have left the pools half-written; the
            # reset wipes the refcounts, so the cache drops its entries
            # without releasing them
            if self._prefix is not None:
                self._prefix.clear(release=False)
            self._pool.reset()
            self._pools = self._pool.make_pools()
            self.metrics.gauges["inflight"] = 0
            raise
        self.metrics.gauges["inflight"] = len(self._live())
        if admitted or pf_ran or live:
            # the batch the step served: rows live at decode entry (or, on
            # an admission-only step, the requests that finished there)
            n_real = len(live) if live else min(len(finished),
                                                len(self._slots))
            kv_tokens, kv_slots, kv_shared = self._kv_snapshot
            self.metrics.record_batch(
                n_real=n_real, capacity=len(self._slots),
                kv_tokens=kv_tokens, kv_slots=kv_slots,
                kv_capacity=self._pool.capacity_tokens,
                queue_depth=len(self._queue), kv_shared_tokens=kv_shared)
        return expired + finished

    def drain(self, max_batches: Optional[int] = None) -> List[Request]:
        """step() until the queue empties and every live slot finishes
        (or max_batches steps ran); returns the terminal requests."""
        out: List[Request] = []
        n = 0
        while self.busy:
            if max_batches is not None and n >= max_batches:
                break
            out.extend(self.step())
            n += 1
        return out

    def summary(self) -> dict:
        return self.metrics.summary()

    def _expire(self, req: Request, now: float) -> bool:
        """Time out a queued request whose wait passed its deadline (a
        terminal outcome: its queue wait is its life); True if it did."""
        if req.deadline_s is None or \
                now - req.trace.t_enqueue <= req.deadline_s:
            return False
        req.status, req.reason = "timeout", "queue_deadline"
        req.trace.t_finish = now
        self.metrics.record_request(req)
        return True

    # -- the padded engine ------------------------------------------------
    def _admit(self):
        """Pop up to max_batch requests, expiring the deadline-blown.
        Returns (admitted, expired): both are terminal outcomes the caller
        surfaces (a timeout is a served SLO miss)."""
        now = self.clock()
        admitted: List[Request] = []
        expired: List[Request] = []
        while self._queue and len(admitted) < self.config.max_batch:
            req = self._queue.popleft()
            if self._expire(req, now):
                expired.append(req)
                continue
            req.status = "active"
            req.trace.t_admit = now
            req.trace.batch_id = self._batch_id
            admitted.append(req)
        self.metrics.gauges["queue_depth"] = len(self._queue)
        return admitted, expired

    def _step_padded(self) -> List[Request]:
        reqs, expired = self._admit()
        if not reqs:
            return expired
        try:
            return expired + self._run_batch(reqs)
        except BaseException:
            now = self.clock()
            for r in reqs:
                if r.status == "active":
                    r.status, r.reason = "error", "engine_exception"
                    r.trace.t_finish = now
                    self.metrics.record_request(r)
            self.metrics.gauges["inflight"] = 0
            raise

    def _run_batch(self, reqs: List[Request]) -> List[Request]:
        """Serve one micro-batch to completion: a fixed [max_batch,
        prompt_cap] right-padded batch (unfilled rows are 1-token pad
        dummies whose outputs are dropped), one `prefill_static`, then the
        [1, c, c, ...] chunk schedule through `decode_static` on a donated
        state. A row finishes at the end of the chunk in which it hit EOS
        or its budget; the schedule stops early once every row has its
        budget or every real row hit EOS."""
        cfg = self.config
        self.metrics.gauges["inflight"] = len(reqs)
        batch_id = self._batch_id
        self._batch_id += 1
        B, cap = cfg.max_batch, cfg.prompt_cap
        ids = np.full((B, cap), cfg.pad_token_id, dtype=np.int64)
        lens = np.ones((B,), dtype=np.int32)
        for i, r in enumerate(reqs):
            ids[i, :r.prompt_len] = r.prompt
            lens[i] = r.prompt_len
        need = max(r.max_new_tokens for r in reqs)
        t_pf0 = self.clock()
        st = self.model.prefill_static(
            ids, max_len=cfg.max_len, prompt_lens=lens,
            weight_dtype=cfg.weight_dtype, cache_dtype=cfg.cache_dtype)
        st["last_logits"].cpu()        # host sync: the prefill has run
        t_prefill = self.clock()
        for r in reqs:
            r.trace.t_prefill_done = t_prefill
            r.trace.events.append(("prefill", t_pf0, t_prefill))
        parts: List[np.ndarray] = []
        schedule = cfg.chunk_schedule
        for ci, chunk in enumerate(schedule):
            t_c0 = self.clock()
            # a fresh seed per (batch, chunk): each decode_static call
            # starts its own sampling stream
            toks, st = self.model.decode_static(
                st, chunk, temperature=cfg.temperature, top_k=cfg.top_k,
                top_p=cfg.top_p, seed=cfg.seed + batch_id * len(schedule)
                + ci, eos_token_id=cfg.eos_token_id, return_state=True,
                donate_cache=True)
            parts.append(toks.cpu().numpy())       # host sync per chunk
            t_chunk = self.clock()
            if ci == 0:
                for r in reqs:
                    r.trace.t_first_token = t_chunk
            # the window rides every row still in flight at chunk entry
            for r in reqs:
                if r.trace.t_finish is None:
                    r.trace.events.append(("decode", t_c0, t_chunk))
            produced = sum(p.shape[1] for p in parts)
            so_far = np.concatenate(parts, axis=1)
            for i, r in enumerate(reqs):
                if r.trace.t_finish is None and \
                        (produced >= r.max_new_tokens or
                         _hit_eos(so_far[i, :r.max_new_tokens],
                                  cfg.eos_token_id)):
                    r.trace.t_finish = t_chunk
            if produced >= need:
                break
            if cfg.eos_token_id is not None and \
                    bool(st["done"][:len(reqs)].all()):
                break               # every real row hit EOS: stop early
        gen = np.concatenate(parts, axis=1)
        for i, r in enumerate(reqs):
            row = gen[i, :r.max_new_tokens]
            r.tokens = row
            r.n_out = _n_out(row, cfg.eos_token_id)
            r.status = "done"
            if r.trace.t_finish is None:
                r.trace.t_finish = t_chunk
            self.metrics.record_request(r)
        # live tokens: real prompt rows plus the decode rows written (the
        # last sampled token is returned but never written); every
        # admitted row pins a full max_len slab, which is the gap the
        # paged engine closes
        kv_tokens = int(lens[:len(reqs)].sum()) + \
            int((gen.shape[1] - 1) * len(reqs))
        self.metrics.record_batch(
            n_real=len(reqs), capacity=B, kv_tokens=kv_tokens,
            kv_slots=len(reqs) * cfg.max_len,
            kv_capacity=B * cfg.max_len, queue_depth=len(self._queue))
        self.metrics.gauges["inflight"] = 0
        return reqs

    def _clear_slot(self, slot: int):
        self._tables[slot] = 0         # trash block: writes go nowhere
        self._lens[slot] = 0
        self._pending[slot] = 0
        self._done[slot] = True
        self._shared_tok[slot] = 0
        self._prefill_pos[slot] = -1

    def _decodable(self) -> List[int]:
        """Live slots whose prefill completed: the decode batch. Rows
        still mid-(chunked-)prefill are left out and neutralized in the
        shipped device state (`_ship_decode_state`)."""
        return [i for i in self._live() if self._prefill_pos[i] < 0]

    def _ship_decode_state(self):
        """The per-slot vectors a decode or verify call takes, as device
        tensors: tables [B, MB], lens [B], pending [B], done [B]. Empty
        slots and rows still mid-chunked-prefill ship a trash table row,
        lens 0 and done=True, so the fixed-[B] call cannot write into (or
        attend) their blocks; their host state is untouched."""
        tables, lens = self._tables, self._lens
        pending, done = self._pending, self._done
        pf = self._prefill_pos >= 0
        if pf.any():
            tables, lens = tables.copy(), lens.copy()
            pending, done = pending.copy(), done.copy()
            tables[pf] = 0
            lens[pf] = 0
            pending[pf] = 0
            done[pf] = True
        dev = self.model.device
        return tuple(torch.from_numpy(a).to(dev)
                     for a in (tables, lens, pending, done))

    def _kv_physical(self):
        """(physical live tokens, logical shared tokens) over live slots.
        Physical occupancy counts each distinct block once: walk every
        live slot's blocks in position order, credit each block its live
        rows, and take the max where two slots map the same block. Shared
        tokens sum the per-slot volume read from blocks mapped shared."""
        bs = self._pool.block_size
        rows: dict = {}
        shared = 0
        for s in self._live():
            ln = int(self._lens[s])
            shared += int(self._shared_tok[s])
            for j, blk in enumerate(self._pool.owned(self._slots[s].id)):
                r = min(max(ln - j * bs, 0), bs)
                if r == 0:
                    break
                rows[blk] = max(rows.get(blk, 0), r)
        return sum(rows.values()), shared

    def _snapshot_kv(self):
        phys, shared = self._kv_physical()
        self._kv_snapshot = (
            phys, self._pool.used_blocks * self._pool.block_size, shared)

    def _insert_prefix(self, req: Request, blocks, written: int,
                       tokens=None):
        """Cache the request's blocks whose KV is written: the full
        blocks among positions [0, written). The partial tail keeps taking
        decode writes and is never shared. `tokens` defaults to the
        prompt; the spec-decode finish passes prompt + generated chain so
        later identical traffic zero-prefills and drafts from it."""
        if self._prefix is None:
            return
        bs = self._pool.block_size
        toks = req.prompt if tokens is None else tokens
        n_full = min(int(written), len(toks)) // bs
        if n_full:
            self._prefix.insert(toks[:n_full * bs], blocks[:n_full])

    def warmup_prefix_cache(self, vocab_size: int, *, seed: int = 2,
                            clear: bool = True):
        """Run the prefix-cache paths once before measuring: a full-prefill
        miss, an identical block-aligned repeat (the COW copy), and a
        mid-prefix divergence (suffix prefill), each to completion so
        decode (and, with spec_decode, a verify window drafted from the
        first run's cached chain) runs too. `clear=True` then drops the
        warmup's cached prefixes so measured traffic starts cold."""
        if self._prefix is None:
            raise ValueError("warmup_prefix_cache needs "
                             "ServingConfig(prefix_cache=True)")
        bs = self.config.kv_block
        aligned = (self.config.prompt_cap // bs) * bs
        if aligned < max(bs, 2):
            raise ValueError(f"prompt_cap {self.config.prompt_cap} holds "
                             f"no full kv_block ({bs}); nothing to warm")
        rng = np.random.RandomState(seed)
        p = rng.randint(1, vocab_size, (aligned,)).astype(np.int64)
        for prompt in (p, p):        # miss, then aligned full hit (COW)
            self.submit(prompt)
            self.drain()
        if aligned > bs:             # partial hit -> suffix prefill
            d = p.copy()
            d[bs:] = rng.randint(1, vocab_size, (aligned - bs,))
            self.submit(d)
            self.drain()
        if clear:
            self._prefix.clear()
        return self

    def _cow_copy(self, src: int, dst: int):
        """Copy pool block `src` into private block `dst` in every layer's
        planes (codes and scales for int8): the copy-on-write an aligned
        full-prefix hit needs before its re-decode of the last prompt
        token writes inside the last shared block."""
        for layer in self._pools:
            for plane in layer:
                plane[dst] = plane[src]

    def _admit_paged(self):
        """Fill every free slot from the queue: consult the prefix trie,
        map shared blocks and allocate fresh ones, prefill what the cache
        does not hold yet, and install the row for the next decode chunk.
        When the head of the queue does not fit the free blocks, admission
        waits for live rows to free theirs. Returns (finished, expired,
        admitted): a budget-1 or instant-EOS request finishes here.

        With the prefix cache, admission splits three ways on the matched
        full-block token count t against the prompt length plen:
          t == 0           full prefill;
          0 < t < plen-1   partial hit: prefill ONLY the suffix (start=t,
                           attending the shared prefix blocks);
          t >= plen-1      zero-prefill hit: the last prompt token
                           re-enters as the pending decode token (lens =
                           plen-1). When t == plen that re-decode would
                           write INTO the last shared block, which is
                           first copied into a private block.
        With prefill_chunk, admission only installs the slot and
        `_advance_prefill` prefills from position t window by window."""
        cfg = self.config
        bs = self._pool.block_size
        finished: List[Request] = []
        expired: List[Request] = []
        admitted = 0
        free = [i for i, r in enumerate(self._slots) if r is None]
        while self._queue and free:
            now = self.clock()
            req = self._queue[0]
            if self._expire(req, now):
                self._queue.popleft()
                expired.append(req)
                continue
            plen = req.prompt_len
            need_rows = plen + req.max_new_tokens - 1
            matched, t = ([], 0) if self._prefix is None \
                else self._prefix.match(req.prompt)
            # an aligned full hit shares every matched block but the last,
            # which becomes a private copy (the re-decode writes in it)
            cow = t == plen and t > 0
            shared = matched[:-1] if cow else matched
            blocks = self._pool.alloc(req.id, need_rows, shared=shared)
            if blocks is None and self._prefix is not None:
                # cached-but-idle prefixes are soft capacity: evict LRU
                # refcount-free entries before deciding to wait, sparing
                # the whole matched run (shared plus the COW source)
                n_fresh = self._pool.blocks_needed(need_rows) - len(shared)
                if self._prefix.reclaim(n_fresh, protect=matched):
                    blocks = self._pool.alloc(req.id, need_rows,
                                              shared=shared)
                if blocks is None and not self._live():
                    # nothing in flight will free blocks, so waiting
                    # cannot help: drop the hit, reclaim freely and
                    # prefill in full rather than starve on the request's
                    # own protected prefix
                    matched, t, cow, shared = [], 0, False, []
                    if self._prefix.reclaim(
                            self._pool.blocks_needed(need_rows)):
                        blocks = self._pool.alloc(req.id, need_rows)
            if blocks is None:
                break            # wait for live rows to free their blocks
            self._queue.popleft()
            slot = free.pop(0)
            req.status = "active"
            req.trace.t_admit = now
            req.trace.batch_id = self._batch_id
            # installed BEFORE the device call, so a failing prefill is
            # recorded as an error by step()'s handler
            self._slots[slot] = req
            table_row = self._pool.table_row(req.id, self._tables.shape[1])
            self._tables[slot] = table_row
            self._shared_tok[slot] = len(shared) * bs
            admitted += 1
            if self._prefix is not None:
                self.metrics.counters[
                    "prefix_hit" if t else "prefix_miss"] += 1
            if t >= plen - 1 and t > 0:
                # zero-prefill admission: every prompt position but the
                # re-decoded last one is served from cached blocks
                if cow:
                    self._cow_copy(matched[-1], int(blocks[len(shared)]))
                self._lens[slot] = plen - 1
                self._pending[slot] = int(req.prompt[plen - 1])
                self._done[slot] = False
                req._chunks = []
                req._produced = 0
                req.trace.t_prefill_done = now   # nothing to prefill
                self.metrics.counters["prefill_tokens_saved"] += plen - 1
                # only positions < t hold written KV yet
                self._insert_prefix(req, blocks, t)
            elif cfg.prefill_chunk is not None:
                self._prefill_pos[slot] = t
                req._chunks = []
                req._produced = 0
                self.metrics.counters["prefill_tokens_saved"] += t
            else:
                suffix = plen - t
                ids = np.full((1, cfg.prompt_cap), cfg.pad_token_id,
                              dtype=np.int64)
                ids[0, :suffix] = req.prompt[t:]
                t_pf0 = self.clock()
                self._pools, first = self.model.prefill_paged(
                    ids, np.asarray([suffix], np.int32), self._pools,
                    table_row[None], temperature=cfg.temperature,
                    top_k=cfg.top_k, top_p=cfg.top_p,
                    seed=cfg.seed + self._calls,
                    weight_dtype=cfg.weight_dtype,
                    cache_dtype=cfg.cache_dtype,
                    start=None if t == 0 else np.asarray([t], np.int32))
                tok = int(first.cpu()[0])         # host sync: TTFT is known
                self._calls += 1
                req.trace.events.append(
                    ("prefill" if t == 0 else "suffix_prefill", t_pf0,
                     self.clock()))
                self.metrics.counters["prefill_tokens_saved"] += t
                if self._complete_prefill(slot, req, tok, self.clock()):
                    finished.append(req)
                    free.insert(0, slot)
            self._batch_id += 1
        self.metrics.gauges["queue_depth"] = len(self._queue)
        if admitted:
            self._snapshot_kv()
        return finished, expired, admitted

    def _advance_prefill(self):
        """One [1, prefill_chunk] prefill window for every slot still
        mid-chunked-prefill, at its next position (start = offset). The
        final window's sampled token is the request's first token and the
        row joins the next decode chunk. Returns (finished, ran): a
        budget-1 or instant-EOS request finishes when its prefill lands."""
        cfg = self.config
        finished: List[Request] = []
        if cfg.prefill_chunk is None:
            return finished, False
        pc = cfg.prefill_chunk
        ran = False
        for slot in self._live():
            off = int(self._prefill_pos[slot])
            if off < 0:
                continue
            req = self._slots[slot]
            plen = req.prompt_len
            clen = min(pc, plen - off)
            final = off + clen >= plen
            ids = np.full((1, pc), cfg.pad_token_id, dtype=np.int64)
            ids[0, :clen] = req.prompt[off:off + clen]
            t_pf0 = self.clock()
            self._pools, first = self.model.prefill_paged(
                ids, np.asarray([clen], np.int32), self._pools,
                self._tables[slot][None], temperature=cfg.temperature,
                top_k=cfg.top_k, top_p=cfg.top_p,
                seed=cfg.seed + self._calls, weight_dtype=cfg.weight_dtype,
                cache_dtype=cfg.cache_dtype,
                start=np.asarray([off], np.int32))
            # only the final window's token is used: syncing the others
            # would put a host round trip on every window
            tok = int(first.cpu()[0]) if final else 0
            self._calls += 1
            ran = True
            req.trace.events.append(("prefill_chunk", t_pf0, self.clock()))
            off += clen
            if not final:
                self._prefill_pos[slot] = off
                continue
            self._prefill_pos[slot] = -1
            if self._complete_prefill(slot, req, tok, self.clock()):
                finished.append(req)
        return finished, ran

    def _complete_prefill(self, slot: int, req: Request, tok: int,
                          tp: float) -> bool:
        """The sampled token becomes the row's pending and first token,
        the prompt's full blocks enter the prefix cache, and a budget-1 or
        instant-EOS request finishes on the spot. Returns True when it did
        (the slot is free again)."""
        cfg = self.config
        req.trace.t_prefill_done = tp
        req.trace.t_first_token = tp  # sampled with the prefill
        self._lens[slot] = req.prompt_len
        self._pending[slot] = tok
        hit_eos = cfg.eos_token_id is not None and tok == cfg.eos_token_id
        self._done[slot] = hit_eos
        req._chunks = [np.asarray([tok], np.int64)]
        req._produced = 1
        # insert BEFORE any instant finish: the cache's retain must land
        # while the request still holds its blocks
        self._insert_prefix(req, self._pool.owned(req.id), req.prompt_len)
        if req._produced >= req.max_new_tokens or hit_eos:
            self._finish_paged_row(slot, tp)
            return True
        return False

    def _decode_chunk_paged(self, live: List[int]) -> List[Request]:
        """One fixed-shape [B, decode_chunk] decode call over every slot;
        finish and free each row that hit EOS or its budget."""
        cfg = self.config
        c = cfg.decode_chunk
        self._snapshot_kv()
        tables, lens, pending, done = self._ship_decode_state()
        t_c0 = self.clock()
        toks, self._pools, _, done_d = self.model.decode_paged(
            self._pools, tables, lens, pending, done, c,
            temperature=cfg.temperature, top_k=cfg.top_k, top_p=cfg.top_p,
            seed=cfg.seed + self._calls, eos_token_id=cfg.eos_token_id,
            weight_dtype=cfg.weight_dtype, cache_dtype=cfg.cache_dtype)
        arr = toks.cpu().numpy()                     # host sync per chunk
        self._calls += 1
        t = self.clock()
        pend_new = arr[:, -1].astype(np.int32)
        done_new = done_d.cpu().numpy().copy()
        pf = self._prefill_pos >= 0        # mid-prefill rows rode as
        pend_new[pf] = self._pending[pf]   # neutralized dummies: their
        done_new[pf] = self._done[pf]      # real state survives
        self._pending = pend_new
        self._done = done_new
        finished: List[Request] = []
        for slot in live:
            req = self._slots[slot]
            req.trace.events.append(("decode", t_c0, t))
            take = min(c, req.max_new_tokens - req._produced)
            req._chunks.append(arr[slot, :take])
            req._produced += take
            if req.trace.t_first_token is None:
                # zero-prefill admission: this chunk's first token is the
                # request's first token
                req.trace.t_first_token = t
            self._lens[slot] += c     # the device wrote c rows regardless
            if req._produced >= req.max_new_tokens or \
                    _hit_eos(arr[slot, :take], cfg.eos_token_id):
                self._finish_paged_row(slot, t)
                finished.append(req)
        return finished

    def _draft_context(self, req: Request) -> List[int]:
        """The slot's draft context: prompt plus every emitted token (the
        pending token included, since drafts continue after it), kept
        incrementally so each window costs O(new tokens)."""
        ctx = getattr(req, "_ctx", None)
        if ctx is None:
            ctx = req._ctx = [int(t) for t in req.prompt]
            req._ctx_chunks = 0
        for c in req._chunks[req._ctx_chunks:]:
            ctx.extend(int(t) for t in c)
        req._ctx_chunks = len(req._chunks)
        return ctx

    def _draft_for_slot(self, slot: int):
        """Up to spec_k draft tokens for the slot's next positions and
        their source ("trie" | "model" | None): the trie first, then the
        callable."""
        cfg = self.config
        req = self._slots[slot]
        context = self._draft_context(req)
        if self._prefix is not None:
            d = self._prefix.lookup_continuation(context, cfg.spec_k)
            if d:
                return np.asarray(d, np.int32), "trie"
        if self._draft_fn is not None:
            d = np.asarray(self._draft_fn(context, cfg.spec_k)).reshape(-1)
            if d.size:
                return d[:cfg.spec_k].astype(np.int32), "model"
        return None, None

    def _decode_chunk_spec(self, live: List[int]) -> List[Request]:
        """One speculative verify window over the slot batch: a
        [B, spec_k + 1] call through model.verify_paged. Rows with a draft
        advance by their accepted length + 1; rows without one ride along
        on pad drafts and advance by >= 1 (a pad that matches the chain is
        a real acceptance: every emitted token is the argmax). A step
        where no row has a draft runs the plain decode chunk."""
        cfg = self.config
        B = len(self._slots)
        drafts = np.full((B, cfg.spec_k), cfg.pad_token_id, np.int32)
        src = {}
        for slot in live:
            d, tag = self._draft_for_slot(slot)
            if d is not None:
                drafts[slot, :len(d)] = d
                src[slot] = (tag, len(d))
        if not src:
            return self._decode_chunk_paged(live)
        self._snapshot_kv()
        tables, lens, pending, done = self._ship_decode_state()
        t_c0 = self.clock()
        toks, n_acc, self._pools, done_d = self.model.verify_paged(
            self._pools, tables, lens, pending, drafts, done,
            eos_token_id=cfg.eos_token_id, weight_dtype=cfg.weight_dtype,
            cache_dtype=cfg.cache_dtype)
        arr = toks.cpu().numpy()                    # host sync per window
        acc = n_acc.cpu().numpy()
        done_new = done_d.cpu().numpy()
        self._calls += 1
        t = self.clock()
        finished: List[Request] = []
        mt = self.metrics
        for slot in live:
            req = self._slots[slot]
            req.trace.events.append(("spec_verify", t_c0, t))
            n_emit = int(acc[slot]) + 1
            take = min(n_emit, req.max_new_tokens - req._produced)
            fresh = arr[slot, :take]
            req._chunks.append(fresh)
            req._produced += take
            if req.trace.t_first_token is None:
                req.trace.t_first_token = t
            self._lens[slot] += n_emit   # the accepted frontier
            self._pending[slot] = np.int32(arr[slot, n_emit - 1])
            self._done[slot] = bool(done_new[slot])
            if slot in src:
                # acceptance covers drafted rows and real draft tokens
                # only; a budget-truncated final window credits only the
                # accepted drafts it emitted
                tag, dlen = src[slot]
                used = min(int(acc[slot]), take, dlen)
                req.spec_proposed += dlen
                req.spec_accepted += used
                mt.counters["spec_windows"] += 1
                mt.counters["spec_proposed"] += dlen
                mt.counters["spec_accepted"] += used
                mt.counters["spec_drafts_trie" if tag == "trie"
                            else "spec_drafts_model"] += 1
                mt.hists["spec_accept_len"].observe(take)
            if req._produced >= req.max_new_tokens or \
                    _hit_eos(fresh, cfg.eos_token_id):
                self._finish_paged_row(slot, t)
                finished.append(req)
        return finished

    def _finish_paged_row(self, slot: int, t: float):
        """Terminal bookkeeping for one slot: its blocks free at once, so
        the next admission can splice a queued request into the slot.
        With spec decode and the prefix cache, the written chain (prompt +
        generated, minus the never-written last token) enters the trie
        first, so the next identical request zero-prefills it and drafts
        its continuation from it."""
        req = self._slots[slot]
        row = np.concatenate(req._chunks)[:req.max_new_tokens]
        req.tokens = row.astype(np.int64)
        req.n_out = _n_out(req.tokens, self.config.eos_token_id)
        req.status = "done"
        req.trace.t_finish = t
        if self.config.spec_decode and self._prefix is not None:
            chain = np.concatenate([req.prompt, req.tokens[:req.n_out]])
            self._insert_prefix(req, self._pool.owned(req.id),
                                req.prompt_len + req._produced - 1,
                                tokens=chain)
        self._pool.free(req.id)
        self._slots[slot] = None
        self._clear_slot(slot)
        self.metrics.record_request(req)


def _hit_eos(row: np.ndarray, eos: Optional[int]) -> bool:
    return eos is not None and bool((row == eos).any())


def _n_out(row: np.ndarray, eos: Optional[int]) -> int:
    """Tokens a row really produced: up to and including the first EOS."""
    if eos is None:
        return int(row.shape[0])
    hits = np.nonzero(row == eos)[0]
    return int(hits[0]) + 1 if hits.size else int(row.shape[0])


def synthetic_traffic(n_requests: int, *, prompt_cap: int, vocab_size: int,
                      rate: float = 50.0, seed: int = 0, min_len: int = 1,
                      length_dist: str = "uniform") -> List[dict]:
    """Open-loop synthetic workload: Poisson arrivals at `rate` req/s,
    ragged prompt lengths in [min_len, prompt_cap]. Returns
    [{"at": arrival_offset_s, "prompt": ids}] sorted by arrival.
    length_dist "uniform" draws lengths uniformly; "longtail" draws
    Pareto-shaped (alpha 1.1) lengths clipped to the cap: mostly short
    prompts with a heavy tail of cap-length ones. The same seed gives the
    JAX package's traffic exactly (both draw from numpy)."""
    if length_dist not in ("uniform", "longtail"):
        raise ValueError(f"unknown length_dist {length_dist!r}")
    rng = np.random.RandomState(seed)
    gaps = rng.exponential(1.0 / max(rate, 1e-9), size=n_requests)
    at = np.cumsum(gaps) - gaps[0]
    out = []
    for i in range(n_requests):
        if length_dist == "longtail":
            ln = min(prompt_cap, min_len + int(rng.pareto(1.1) * min_len))
        else:
            ln = int(rng.randint(min_len, prompt_cap + 1))
        out.append({"at": float(at[i]),
                    "prompt": rng.randint(1, vocab_size,
                                          (ln,)).astype(np.int64)})
    return out


def shared_prefix_traffic(n_requests: int, *, n_prefixes: int,
                          prefix_len: int, prompt_cap: int,
                          vocab_size: int, rate: float = 50.0,
                          seed: int = 0) -> List[dict]:
    """System-prompt workload: every request draws one of `n_prefixes`
    fixed token prefixes (`prefix_len` tokens) followed by a fresh random
    suffix, Poisson arrivals at `rate` req/s. After each prefix's first
    request, every later one sharing it can admit with only its suffix
    prefilled. Returns [{"at", "prompt", "prefix_id"}] sorted by arrival;
    the same seed gives the JAX package's traffic exactly."""
    if not (1 <= prefix_len < prompt_cap):
        raise ValueError(f"prefix_len must be in [1, prompt_cap), got "
                         f"{prefix_len} vs cap {prompt_cap}")
    if n_prefixes < 1:
        raise ValueError(f"n_prefixes must be >= 1, got {n_prefixes}")
    rng = np.random.RandomState(seed)
    prefixes = rng.randint(1, vocab_size,
                           (n_prefixes, prefix_len)).astype(np.int64)
    gaps = rng.exponential(1.0 / max(rate, 1e-9), size=n_requests)
    at = np.cumsum(gaps) - gaps[0]
    out = []
    for i in range(n_requests):
        p = int(rng.randint(0, n_prefixes))
        ln = int(rng.randint(1, prompt_cap - prefix_len + 1))
        suffix = rng.randint(1, vocab_size, (ln,)).astype(np.int64)
        out.append({"at": float(at[i]),
                    "prompt": np.concatenate([prefixes[p], suffix]),
                    "prefix_id": p})
    return out


def repeated_traffic(n_requests: int, *, n_prompts: int, prompt_len: int,
                     vocab_size: int, rate: float = 50.0,
                     seed: int = 0) -> List[dict]:
    """Agentic / retry workload: every request is one of `n_prompts`
    fixed prompts repeated verbatim, Poisson arrivals at `rate` req/s.
    After each prompt's first completion, later identical requests
    zero-prefill from the trie and draft their whole continuation from
    the cached chain. Returns [{"at", "prompt", "prompt_id"}] sorted by
    arrival; the same seed gives the JAX package's traffic exactly."""
    if n_prompts < 1 or prompt_len < 1:
        raise ValueError(f"need n_prompts >= 1 and prompt_len >= 1, got "
                         f"{n_prompts}, {prompt_len}")
    rng = np.random.RandomState(seed)
    prompts = rng.randint(1, vocab_size,
                          (n_prompts, prompt_len)).astype(np.int64)
    gaps = rng.exponential(1.0 / max(rate, 1e-9), size=n_requests)
    at = np.cumsum(gaps) - gaps[0]
    out = []
    for i in range(n_requests):
        p = int(rng.randint(0, n_prompts))
        out.append({"at": float(at[i]), "prompt": prompts[p].copy(),
                    "prompt_id": p})
    return out


def model_draft_fn(draft_model, *, window: int = 32):
    """A speculative draft source for ``ServingConfig(spec_draft=...)``
    from a (small) GPTForCausalLM: the returned callable greedily
    continues the last `window` context tokens through
    ``draft_model.generate_static_ragged`` on a fixed [1, window] batch,
    the length riding as data. Each call pays a full window prefill in the
    draft model, which is cheap when the drafter is much smaller than the
    target."""
    def fn(context, k):
        ctx = np.asarray(context, dtype=np.int64)[-window:]
        ln = int(ctx.shape[0])
        ids = np.zeros((1, window), np.int64)
        ids[0, :ln] = ctx
        out = draft_model.generate_static_ragged(ids, [ln],
                                                 max_new_tokens=int(k))
        return out[0, window:window + int(k)].cpu().numpy()
    return fn


__all__: Sequence[str] = ["RequestTrace", "Request", "ServingMetrics",
                          "ServingConfig", "ServingEngine",
                          "synthetic_traffic", "shared_prefix_traffic",
                          "repeated_traffic", "model_draft_fn"]
