"""Continuous-batching GPT serving (the port of
paddle_tpu/inference/serving.py's padded and paged engines and their ops
surface).

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

                  Four options extend it; all but the spill tier run
                  the multi-token paged-attention kernel (a [B, S] query
                  window at per-row offsets):
                  prefix_cache   a radix trie (inference/prefix_cache.py)
                                 maps cached full blocks of a prompt into
                                 the new request's table; a partial hit
                                 prefills only the suffix, a full hit
                                 prefills nothing and re-decodes the last
                                 prompt token (copy-on-write of the last
                                 block when it is shared);
                  spill_host_bytes  the host spill tier: a prefix block
                                 the trie evicts copies to host memory
                                 instead of vanishing, and a later hit
                                 rehydrates it with one host->device copy
                                 per payload tensor;
                  prefill_chunk  prompts prefill in [1, prefill_chunk]
                                 windows, one per engine step, between
                                 decode chunks;
                  spec_decode    each decode step verifies spec_k drafted
                                 tokens (from the trie, or a callable) in
                                 one [B, spec_k + 1] window; greedy output
                                 equals the plain chain.

  RequestTrace    per-request timestamps (enqueue -> admit -> prefill ->
                  first token -> finish), a trace id, and the engine-call
                  windows the request rode.

  ServingMetrics  log-bucketed TTFT / TPOT / e2e / queue-wait histograms,
                  the speculative accept-length histogram, queue and KV
                  gauges, request, token, prefix and spec counters, one
                  JSONL row per terminal request, and the Prometheus text.
                  Probe requests are accounted apart.

  The ops surface: `preflight` / `submit(enqueue_at=, probe=)`, graceful
  drain (`begin_drain`, `drain(seal=True)`, `resume_admission`),
  `health`, `statusz`, `fingerprint`, `attach_memory_ledger`,
  `metrics_registry` and `serve_telemetry` (obs/: /metrics, /healthz,
  /statusz, /tracez, /memz, /probez, SLO burn rates, golden-canary probes,
  invariant audits). A scrape reads host counters only.

  model_draft_fn  turns a (small) GPT into a `spec_draft` callable that
                  drafts through its `generate_static_ragged`.

  shards=N        tensor-parallel paged serving on N ranks, one process a
                  card: every rank builds the model under a mesh with an
                  ``mp`` axis of N (`distributed.build_mesh`, `fleet.init`)
                  and the same engine; the pools hold the rank's
                  num_heads / N heads. Rank 0 of the mp group is the
                  LEADER and drives the engine (submit / step / drain and
                  everything on the host); the others call `follow()`,
                  which runs each device op the leader sends
                  (inference/sharded.py) and returns when the leader's
                  engine is `close()`d. Greedy chains equal the
                  single-card engine's.

Greedy engine output equals the JAX engine's and the JAX
`generate_static_ragged`'s token chains per request (tests). On a CUDA
model every attention call of the paged serving path runs a hand-written
paged-attention kernel, and under weight_dtype="int8" every projection and
the LM head of either engine run the hand-written int8 GEMM.

Not ported yet: the graph lint and the engine's chaos injector
(ROADMAP.md, queue A).
"""
from __future__ import annotations

import json
import logging
import math
import time
import uuid
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..analysis.findings import ConfigValidationError, Finding, Findings
from ..profiler import StepMonitor
from ..profiler._metrics import (LogHistogram, counter_lines, gauge_lines,
                                 histogram_lines)
from . import executables
from .kv_cache import BlockPool, HostSpillTier, to_host
from .prefix_cache import PrefixCache

_logger = logging.getLogger("paddle_tpu_torch.inference.serving")


# --------------------------------------------------------------- requests

@dataclass
class RequestTrace:
    """Timestamps of one request's life (engine clock seconds) and the
    engine-call windows it rode, as (name, t0, t1) tuples ("prefill",
    "suffix_prefill", "prefill_chunk", "decode", "spec_verify"). finish
    is stamped at the end of the decode chunk in which the row hit EOS or
    its budget. `trace_id` names the request across the JSONL rows and
    the /tracez ring; `span_tree()` renders the stamps and windows as one
    tree (a zero-prefill cache hit shows no prefill window)."""
    t_enqueue: Optional[float] = None
    t_admit: Optional[float] = None
    t_prefill_done: Optional[float] = None
    t_first_token: Optional[float] = None
    t_finish: Optional[float] = None
    batch_id: Optional[int] = None
    trace_id: Optional[str] = None
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

    def to_dict(self) -> dict:
        d = {k: getattr(self, k) for k in
             ("t_enqueue", "t_admit", "t_prefill_done", "t_first_token",
              "t_finish", "batch_id")}
        return {k: v for k, v in d.items() if v is not None}

    def span_tree(self) -> dict:
        """The request root span plus its children: the derived queue
        span and every engine-call window this request rode, in time
        order."""
        spans = []
        if self.t_enqueue is not None and self.t_admit is not None:
            spans.append({"name": "queue", "t0": self.t_enqueue,
                          "t1": self.t_admit})
        for name, a, b in self.events:
            spans.append({"name": name, "t0": a, "t1": b})
        spans.sort(key=lambda s: s["t0"])
        return {"trace_id": self.trace_id,
                "t0": self.t_enqueue, "t1": self.t_finish,
                "spans": spans}


@dataclass(eq=False)     # holds an ndarray: identity, not value, equality
class Request:
    """One admitted (or refused) generation request."""
    id: int
    prompt: np.ndarray                      # 1-D int token ids
    max_new_tokens: int
    status: str = "queued"   # queued|active|done|rejected|timeout|error
    reason: Optional[str] = None            # rejection/timeout detail
    # True: the refusal is replica-local (overloaded, draining,
    # queue_full: retry elsewhere); False: terminal everywhere (kv_oom,
    # prompt_shape); None until a rejection stamps it
    retriable: Optional[bool] = None
    deadline_s: Optional[float] = None      # max queue wait before admit
    tokens: Optional[np.ndarray] = None     # generated ids (done only)
    n_out: int = 0                          # tokens up to & incl. EOS
    # speculative decoding: draft tokens proposed for this request across
    # its verify windows, and how many the target accepted
    spec_proposed: int = 0
    spec_accepted: int = 0
    # golden-canary probes ride submit() and the decode path but stay out
    # of the user-facing accounting (they feed the probe_* families)
    probe: bool = False
    trace: RequestTrace = field(default_factory=RequestTrace)

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    def record(self) -> dict:
        """The JSONL payload ServingMetrics streams per terminal request
        (the JAX package's keys)."""
        t = self.trace
        rec = {"id": self.id, "status": self.status,
               "prompt_tokens": self.prompt_len,
               "output_tokens": self.n_out,
               "spans": t.to_dict()}
        if t.trace_id is not None:
            rec["trace_id"] = t.trace_id
        if self.probe:
            rec["probe"] = True
        if self.retriable is not None:
            rec["retriable"] = self.retriable
        if t.events:
            rec["events"] = [[n, round(a, 6), round(b, 6)]
                             for n, a, b in t.events]
        if self.reason:
            rec["reason"] = self.reason
        if self.spec_proposed:
            rec["spec"] = {"proposed": self.spec_proposed,
                           "accepted": self.spec_accepted,
                           "accept_rate": round(
                               self.spec_accepted / self.spec_proposed, 4)}
        for key, val in (("queue_s", t.queue_s), ("ttft_s", t.ttft_s),
                         ("tpot_s", t.tpot_s(self.n_out)),
                         ("e2e_s", t.e2e_s)):
            if val is not None:
                rec[key] = round(val, 6)
        return rec


# which refusals a router may retry on another replica, and which are
# terminal everywhere (identically configured replicas refuse them too)
_REJECT_RETRIABLE = {
    "draining": True,
    "overloaded": True,
    "queue_full": True,
    "prompt_shape": False,
    "kv_oom": False,
    "max_new_tokens": False,
}


# ---------------------------------------------------------------- metrics

class ServingMetrics:
    """Request-level serving telemetry: histograms, gauges and counters.

    Latency series are LogHistograms: percentiles derive from bucket
    counts, so memory stays O(buckets). `record_request` consumes a
    terminal Request; `observe_call` records one synchronous predictor
    call (e2e only). `jsonl_path` streams one row per request,
    `on_record` is the exporter hook, `trace_buffer` (an
    obs.TraceBuffer) receives every user request's record for /tracez,
    `summary()` returns the aggregate dict and `metrics_text()` the
    Prometheus text (the JAX package's family names and help strings).
    Probe requests go to `probe_counters` / `probe_reject_reasons` and
    `probe_metrics_text()` only."""

    HISTS = (("ttft_seconds", "time to first token (enqueue -> token 1)"),
             ("tpot_seconds", "per-output-token time after the first"),
             ("e2e_seconds", "end-to-end request latency"),
             ("queue_seconds", "queue wait (enqueue -> admit)"),
             ("spec_accept_len", "tokens emitted per speculative verify "
                                 "window (accepted drafts + the bonus "
                                 "token)"))

    def __init__(self, *, jsonl_path: Optional[str] = None,
                 on_record: Optional[Callable[[dict], None]] = None,
                 trace_buffer=None,
                 hist_lo: float = 1e-4, hist_hi: float = 1e3,
                 per_decade: int = 10):
        self.jsonl_path = jsonl_path
        self.on_record = on_record
        self.trace_buffer = trace_buffer
        self.hists = {name: LogHistogram(lo=hist_lo, hi=hist_hi,
                                         per_decade=per_decade)
                      for name, _ in self.HISTS
                      if name != "spec_accept_len"}
        # tokens emitted per verify window (1..spec_k+1): half-integer
        # bounds resolve every integer exactly
        self.hists["spec_accept_len"] = LogHistogram(
            bounds=[i + 0.5 for i in range(33)])
        self.counters = {"requests": 0, "completed": 0, "rejected": 0,
                         "overloaded": 0, "timeout": 0, "errors": 0,
                         "tokens_in": 0, "tokens_out": 0, "items": 0,
                         "batches": 0,
                         # prefix cache: admissions that mapped >= 1 cached
                         # block / none, and prompt tokens whose prefill
                         # was skipped because their KV was pooled
                         "prefix_hit": 0, "prefix_miss": 0,
                         "prefill_tokens_saved": 0,
                         # speculative decoding: windows, draft tokens
                         # proposed / accepted, and each draft's source
                         "spec_windows": 0, "spec_proposed": 0,
                         "spec_accepted": 0, "spec_drafts_trie": 0,
                         "spec_drafts_model": 0,
                         # admission stalls on the free list (episodes)
                         "mem_pressure_episodes": 0}
        self.gauges = {"queue_depth": 0, "inflight": 0,
                       "batch_fill_ratio": None, "kv_occupancy": None,
                       "kv_slots_occupancy": None, "kv_shared_tokens": None}
        self.probe_counters = {"requests": 0, "completed": 0,
                               "rejected": 0, "timeout": 0, "errors": 0}
        self.probe_reject_reasons: Dict[str, int] = {}

    # -- recording ------------------------------------------------------
    def observe_call(self, e2e_s: float, items: int = 1):
        """One synchronous predictor call: e2e latency and item (batch-row)
        count."""
        self.counters["requests"] += 1
        self.counters["completed"] += 1
        self.counters["items"] += int(items)
        self.hists["e2e_seconds"].observe(e2e_s)

    def record_request(self, req: Request):
        if req.probe:
            return self._record_probe_request(req)
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
        rec = req.record()
        if self.trace_buffer is not None:
            self.trace_buffer.add(rec)
        return self._emit({"request": rec, "ts": time.time()})

    def _record_probe_request(self, req: Request) -> dict:
        pc = self.probe_counters
        pc["requests"] += 1
        if req.status == "done":
            pc["completed"] += 1
        elif req.status == "rejected":
            pc["rejected"] += 1
            reason = req.reason or "unknown"
            self.probe_reject_reasons[reason] = \
                self.probe_reject_reasons.get(reason, 0) + 1
        elif req.status == "timeout":
            pc["timeout"] += 1
        elif req.status == "error":
            pc["errors"] += 1
        # a row key of its own: consumers of {"request"} rows never see
        # probe traffic
        return self._emit({"probe_request": req.record(),
                           "ts": time.time()})

    def probe_metrics_text(self,
                           prefix: str = "paddle_tpu_probe_serving") \
            -> str:
        """The engine-side probe families. A separate producer on purpose:
        metrics_text() is byte-identical with or without a prober."""
        lines: List[str] = []
        helps = {"requests": "probe requests observed at terminal "
                             "status",
                 "completed": "probe requests served to completion",
                 "rejected": "probe requests refused at submit "
                             "(prober noise, never user-facing "
                             "rejected_total)",
                 "timeout": "probe requests expired in queue",
                 "errors": "probe requests lost to engine exceptions"}
        for name, value in self.probe_counters.items():
            lines.extend(counter_lines(prefix, f"{name}_total", value,
                                       helps[name]))
        if self.probe_reject_reasons:
            p = prefix
            lines += [f"# HELP {p}_rejected_reason_total probe "
                      f"rejections by reason (the probe label "
                      f"dimension of the submit taxonomy)",
                      f"# TYPE {p}_rejected_reason_total counter"]
            lines += [f'{p}_rejected_reason_total{{reason="{r}"}} {c}'
                      for r, c in
                      sorted(self.probe_reject_reasons.items())]
        return "\n".join(lines) + "\n"

    def _emit(self, row: dict) -> dict:
        """One emission path for per-request and structured rows: the JSONL
        append and the exporter hook stay in lockstep."""
        if self.jsonl_path:
            with open(self.jsonl_path, "a") as f:
                f.write(json.dumps(row) + "\n")
        if self.on_record is not None:
            self.on_record(row)
        return row

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
        self.gauges["kv_shared_tokens"] = kv_shared_tokens
        self.gauges["queue_depth"] = queue_depth

    # -- reporting ------------------------------------------------------
    def summary(self) -> dict:
        out = {**{f"{k}_total": v for k, v in self.counters.items()},
               **self.gauges}
        for name, _ in self.HISTS:
            h = self.hists[name]
            if h.count:
                out[name] = h.summary()
        return out

    def flush(self) -> dict:
        """Drain-time flush: zero the liveness gauges and emit one terminal
        `{"drain": summary}` row."""
        for k in ("queue_depth", "inflight"):
            self.gauges[k] = 0
        for k in ("batch_fill_ratio", "kv_occupancy",
                  "kv_slots_occupancy", "kv_shared_tokens"):
            self.gauges[k] = None
        return self._emit({"drain": self.summary(), "ts": time.time()})

    def metrics_text(self, prefix: str = "paddle_tpu_serving") -> str:
        """Prometheus text exposition, through the same renderer as
        StepMonitor.metrics_text, so one page carries both."""
        lines: List[str] = []
        helps = {"requests": "requests observed (all terminal statuses)",
                 "completed": "requests finished successfully",
                 "rejected": "requests refused at submit "
                             "(queue full / shape / draining)",
                 "overloaded": "requests shed at the queue high-watermark "
                               "(subset of rejected)",
                 "timeout": "requests expired in queue past their deadline",
                 "errors": "requests lost to an engine exception "
                           "mid-batch",
                 "tokens_in": "prompt tokens admitted",
                 "tokens_out": "tokens generated (up to and incl. EOS)",
                 "items": "batch rows processed by profiled predictor "
                          "calls",
                 "batches": "micro-batches executed",
                 "prefix_hit": "admissions that mapped >= 1 cached "
                               "prefix block",
                 "prefix_miss": "admissions that found no cached prefix",
                 "prefill_tokens_saved": "prompt tokens whose prefill "
                                         "was skipped (KV already "
                                         "pooled)",
                 "spec_windows": "speculative verify windows run "
                                 "(drafted rows only)",
                 "spec_proposed": "draft tokens proposed to the target "
                                  "model",
                 "spec_accepted": "draft tokens the target accepted "
                                  "(longest matching prefix)",
                 "spec_drafts_trie": "verify windows whose draft came "
                                     "from the prefix-trie prompt "
                                     "lookup",
                 "spec_drafts_model": "verify windows whose draft came "
                                      "from the draft-model hook",
                 "mem_pressure_episodes": "admission stalls waiting on "
                                          "KV blocks (one per episode, "
                                          "not per step)"}
        for name, value in self.counters.items():
            lines.extend(counter_lines(prefix, f"{name}_total", value,
                                       helps[name]))
        ghelp = {"queue_depth": "requests waiting in the admission queue",
                 "inflight": "requests currently being served",
                 "batch_fill_ratio": "real rows / batch capacity of the "
                                     "last micro-batch",
                 "kv_occupancy": "live (attendable) KV rows / pooled "
                                 "capacity — true-token occupancy",
                 "kv_slots_occupancy": "allocation-granular KV rows "
                                       "(padded slots / reserved blocks) "
                                       "/ pooled capacity",
                 "kv_shared_tokens": "logical KV rows served from "
                                     "shared prefix blocks (summed over "
                                     "requests)"}
        for name, value in self.gauges.items():
            lines.extend(gauge_lines(prefix, name, value, ghelp[name]))
        for name, help_ in self.HISTS:
            lines.extend(histogram_lines(prefix, name, self.hists[name],
                                         help_))
        return "\n".join(lines) + "\n"


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
    # tensor-parallel serving: the pools' head axis over the active mesh's
    # mp axis of this many ranks (one process a card; module docstring).
    # None/1 without a mesh = one card. Requires paged=True.
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
        if self.shards is not None:
            if self.shards < 1:
                raise ValueError(f"shards must be >= 1, got {self.shards}")
            if self.shards > 1 and not self.paged:
                raise ConfigValidationError(Finding(
                    "config", "sharded_requires_paged", "error",
                    f"shards={self.shards} requires paged=True: tensor-"
                    f"parallel serving shards the paged block pools' head "
                    f"axis over the mp mesh; the padded static engine has "
                    f"no pools to shard",
                    executable="ServingConfig",
                    data={"shards": self.shards, "paged": False}))
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
        if self.lint is not None:
            raise NotImplementedError(
                "ServingConfig.lint is not ported to PyTorch yet: it comes "
                "with the graph lint, which reads XLA HLO (ROADMAP.md, "
                "queue A item 8)")
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
    call when several threads drive it (`serve_telemetry`'s probe and
    audit pollers hold `srv.prober.lock`; a thread stepping the engine
    beside them must share it, so that one thread at a time launches on
    the device, on the current stream). The engine runs on the model's
    device; caches and pools are allocated there and updated in place.
    `clock` is injectable (tests drive deadlines deterministically).

    Sharded (`ServingConfig(paged=True, shards=N)`): construct it on every
    rank of the mesh's mp group, after the model; the leader (the group's
    first rank) serves and `close()`s it, the others `follow()`. Every
    device call of the paged engine is one op of the runner
    (`inference/sharded.py`). shards=1 under a mesh with an ``mp`` axis is
    the same engine over a world of one."""

    def __init__(self, model, config: ServingConfig, *,
                 metrics: Optional[ServingMetrics] = None,
                 monitor: Optional[StepMonitor] = None,
                 chaos=None,
                 clock: Callable[[], float] = time.monotonic):
        if chaos is not None:
            raise NotImplementedError(
                "ServingEngine(chaos=...) is not ported to PyTorch yet: "
                "the fault injector comes with its own slice (ROADMAP.md, "
                "queue A item 6)")
        self.model = model
        self.config = config
        self.metrics = metrics or ServingMetrics()
        # the batch monitor: step walls and the compile counters
        self.monitor = monitor or StepMonitor(unit="tokens/s",
                                              track_memory=False)
        self.clock = clock
        self._memz = None              # attach_memory_ledger
        self._mem_pressure_t0 = None   # oversubscription-wait episode
        self._prober = None            # serve_telemetry
        self._invariants = None
        self._fingerprint = None
        self._queue: deque = deque()
        self._draining = False         # graceful drain: stop admitting
        self._next_id = 0
        self._batch_id = 0
        self._t_start = self.clock()   # statusz uptime anchor
        # trace ids stay unique across engine incarnations
        self._run_id = uuid.uuid4().hex[:8]
        self._max_depth = 0            # deepest (prefill + chunks) batch
        self._rejected_shapes = set()  # shape deltas warned once each
        self._shape_sig = (((config.max_batch, config.prompt_cap), "int64"),
                           ((config.max_batch,), "int32"))
        self._spill = None
        self._shards = int(config.shards or 1)
        self._runner = None
        self._group = None
        self._tables_bytes = 0
        if not config.paged:
            return
        group, control = self._mp_groups(model, config)
        B, MB = config.max_batch, config.table_width
        self._pool = BlockPool.for_model(model, num_blocks=config.kv_blocks,
                                         block_size=config.kv_block,
                                         cache_dtype=config.cache_dtype)
        self._pools = self._pool.make_pools()
        if group is not None:
            self._start_sharded(group, control)
        self._slots: List[Optional[Request]] = [None] * B
        self._tables = np.zeros((B, MB), np.int32)
        self._lens = np.zeros((B,), np.int32)
        self._pending = np.zeros((B,), np.int32)
        self._done = np.ones((B,), bool)
        self._calls = 0            # sampling seed cursor
        self._paged_seen = set()   # kinds of device call already built
        # (physical live tokens, reserved rows, logical shared tokens) at
        # the last step's decode entry
        self._kv_snapshot = (0, 0, 0)
        # per slot: lens tokens living in blocks mapped shared from the
        # prefix cache (the kv_shared_tokens gauge)
        self._shared_tok = np.zeros((B,), np.int64)
        self._prefix = PrefixCache(
            self._pool, byte_budget=config.prefix_cache_bytes) \
            if config.prefix_cache else None
        if self._prefix is not None and config.spill_host_bytes is not None:
            # the cache owns the trie mechanics, the engine owns the
            # device pools: both copy directions are closures over it
            self._spill = HostSpillTier(
                bytes_per_block=self._pool.payload_bytes,
                byte_budget=config.spill_host_bytes)
            self._prefix.attach_spill(self._spill, reader=self.read_block,
                                      writer=self._spill_write)
        # chunked prefill: next prompt position to prefill per slot; -1 =
        # not mid-prefill (a decode row)
        self._prefill_pos = np.full((B,), -1, np.int64)
        # speculative decoding: the trie drafts first, this callable fills
        # its misses
        self._draft_fn = config.spec_draft \
            if callable(config.spec_draft) else None

    # -- tensor-parallel serving: the mp group and the runner -------------
    def _mp_groups(self, model, config):
        """The engine's mp group and its gloo twin, or (None, None) for the
        one-card engine (shards None or 1 without a mesh). Checks the
        configuration against the process group, the model and the
        mesh."""
        import torch.distributed as dist
        from ..distributed.mesh import get_mesh
        n = self._shards
        mesh = get_mesh()
        if n == 1 and (mesh is None or "mp" not in mesh.shape):
            return None, None
        if not dist.is_initialized():
            raise ValueError(
                f"shards={n} needs an initialised process group, one rank "
                f"a device (distributed.init_parallel_env or spawn)")
        world = dist.get_world_size()
        if n > world:
            raise ValueError(
                f"shards={n} needs {n} ranks (one device each); the "
                f"process group has {world}")
        nh = model.config.num_heads
        if nh % n != 0:
            raise ValueError(f"shards={n} must divide num_heads={nh} (pools "
                             f"shard the head axis)")
        if mesh is None or mesh.axis_size("mp") != n:
            raise ValueError(
                f"shards={n} needs the active mesh's mp axis of {n} "
                f"(distributed.build_mesh or fleet.init); the mesh is "
                f"{None if mesh is None else mesh.shape}")
        mg = getattr(model, "mp_group", None)
        if (1 if mg is None else mg.nranks) != n:
            raise ValueError(
                f"the model's mp degree is {1 if mg is None else mg.nranks}, "
                f"shards={n}: build the model under the mesh")
        return mesh.group("mp"), mesh.control_group("mp")

    def _start_sharded(self, group, control):
        """Gather the replicated serving tables, quantize once (int8
        weights: the row-parallel scales' max all-reduces), check that
        every rank holds the same configuration, then start the runner.
        Every rank of the group runs this, in the same order."""
        from ..distributed.collective import all_gather
        from .sharded import ShardRunner
        cfg, model = self.config, self.model
        self._group = group
        self._tables_bytes = model.gather_serving_tables(group)
        model._q8(cfg.weight_dtype)
        digest = _config_digest(model.config, cfg)
        seen = all_gather(torch.tensor([digest], dtype=torch.int64),
                          group=control)
        if len(set(seen.view(-1).tolist())) != 1:
            raise ValueError("sharded engine: the ranks hold different "
                             "model or serving configurations")
        B, MB = cfg.max_batch, cfg.table_width
        words = B * MB + B * (4 + cfg.spec_k) + cfg.prompt_cap + MB + 64
        self._runner = ShardRunner(group, control, self._handlers(), words)

    @property
    def is_leader(self) -> bool:
        """True on the rank that drives the engine (always, unsharded)."""
        return self._runner is None or self._runner.is_leader

    def _leader_only(self, what: str):
        if not self.is_leader:
            raise RuntimeError(
                f"{what}() on a follower: rank {self._group.ranks[0]} leads "
                f"this sharded engine; the other ranks call follow()")

    def follow(self):
        """A follower's whole part: run the leader's device ops on this
        rank's pools until the leader closes the engine (returns) or fails
        (raises)."""
        if self._runner is None:
            raise RuntimeError("follow() is for the followers of a sharded "
                               "engine (ServingConfig(shards=N))")
        self._runner.follow()

    def close(self):
        """Release the followers (sharded leader; a no-op otherwise)."""
        if self._runner is not None:
            self._runner.close()

    def runner_summary(self) -> Optional[dict]:
        """The runner's ops and their host cost a call (None unsharded)."""
        return None if self._runner is None else self._runner.summary()

    def _dev(self, op: str, *arrays, extra=None):
        """Run one device op: on every rank through the runner, or here."""
        if self._runner is None:
            return getattr(self, "_op_" + op)(*arrays, extra=extra)
        return self._runner.call(op, *arrays, extra=extra)

    def _handlers(self):
        from .sharded import OPS
        return {op: getattr(self, "_op_" + op) for op in OPS
                if hasattr(self, "_op_" + op)}

    # the device ops: host vectors in (int64 when they came through the
    # runner), the model's entry points on this rank's pools
    def _op_prefill(self, ids, lens, table, start, seed, extra=None):
        cfg = self.config
        self._pools, first = self.model.prefill_paged(
            ids, lens, self._pools, table, temperature=cfg.temperature,
            top_k=cfg.top_k, top_p=cfg.top_p, seed=int(seed),
            weight_dtype=cfg.weight_dtype, cache_dtype=cfg.cache_dtype,
            start=None if int(start[0]) < 0 else start)
        return first

    def _op_decode(self, tables, lens, pending, done, chunk, seed,
                   extra=None):
        cfg = self.config
        toks, self._pools, _, done_d = self.model.decode_paged(
            self._pools, tables, lens, pending, done, int(chunk),
            temperature=cfg.temperature, top_k=cfg.top_k, top_p=cfg.top_p,
            seed=int(seed), eos_token_id=cfg.eos_token_id,
            weight_dtype=cfg.weight_dtype, cache_dtype=cfg.cache_dtype)
        return toks, done_d

    def _op_verify(self, tables, lens, pending, drafts, done, extra=None):
        cfg = self.config
        toks, n_acc, self._pools, done_d = self.model.verify_paged(
            self._pools, tables, lens, pending, drafts, done,
            eos_token_id=cfg.eos_token_id, weight_dtype=cfg.weight_dtype,
            cache_dtype=cfg.cache_dtype)
        return toks, n_acc, done_d

    def _op_cow(self, src, dst, extra=None):
        s, d = int(src), int(dst)
        for layer in self._pools:
            for plane in layer:
                plane[d] = plane[s]

    def _op_reset(self, extra=None):
        self._pools = self._pool.make_pools()

    def _op_reference(self, ids, lens, new, extra=None):
        cfg = self.config
        return self.model.generate_static_ragged(
            ids, lens, max_new_tokens=int(new), temperature=cfg.temperature,
            top_k=cfg.top_k, top_p=cfg.top_p, seed=cfg.seed,
            eos_token_id=cfg.eos_token_id, weight_dtype=cfg.weight_dtype,
            cache_dtype=cfg.cache_dtype)

    def _op_spill_read(self, block, extra=None):
        """One block's full-width host payload: this rank's head slice, or
        every rank's gathered on the leader (followers return None)."""
        from ..distributed.collective import all_gather
        stacks = self._pool.block_stacks(self._pools, int(block))
        if self._shards == 1:
            return to_host(stacks)
        parts = [all_gather(st, group=self._group) for st in stacks]
        if not self.is_leader:
            return None
        # [n, 2L, bs, h(, D)] -> [2L, bs, n * h(, D)], rank-major heads
        return to_host(tuple(p.movedim(0, 2).flatten(2, 3) for p in parts))

    def _op_spill_write(self, block, extra=None):
        """Write one full-width payload into pool block `block`: the
        leader's host payload, broadcast over the mp group, each rank
        keeping its head slice."""
        from ..distributed.collective import broadcast
        pool = self._pool
        if self._shards == 1:
            self._pools = pool.write_block(self._pools, int(block), extra)
            return
        from . import executables
        executables.note_process(pool._spill_sig())
        dev, h = self._pools[0][0].device, pool.num_heads
        full = (2 * pool.num_layers, pool.block_size, h * self._shards,
                pool.head_dim)
        specs = ((full, torch.int8), (full[:3], torch.float32)) \
            if pool.cache_dtype == "int8" else ((full, pool.dtype),)
        bufs = [t.to(dev, non_blocking=True) for t in extra] \
            if self.is_leader else \
            [torch.empty(shp, dtype=dt, device=dev) for shp, dt in specs]
        r = self._group.rank
        stacks = []
        for b in bufs:
            broadcast(b, src=self._group.ranks[0], group=self._group)
            stacks.append(b[:, :, r * h:(r + 1) * h])
        self._pools = pool.write_stacks(self._pools, int(block),
                                        tuple(stacks))

    def read_block(self, block: int) -> tuple:
        """Pool block `block`'s full-width host payload (the spill tier's
        serialization; on a sharded engine the ranks' head slices
        gathered)."""
        return self._dev("spill_read", np.asarray(int(block)))

    def generate_reference(self, ids, lens, max_new_tokens: int):
        """The model's `generate_static_ragged` under the engine's
        sampling and dtype envelope (the probes' goldens); on a sharded
        engine every rank runs it."""
        return self._dev("reference", np.asarray(ids, np.int64),
                         np.asarray(lens, np.int64),
                         np.asarray(int(max_new_tokens)))

    # -- compile accounting ---------------------------------------------
    def _sig_common(self):
        cfg = self.config
        return (str(self.model.dtype),
                "q8" if cfg.weight_dtype == "int8" else "full")

    def _note_paged(self, kind: str, *shape) -> None:
        """Record the paged device call's executable signature, as the
        JAX engine's model keys it (executables.py)."""
        cfg = self.config
        pool = self._pool
        cdt, q8 = self._sig_common()
        c8 = "c8" if cfg.cache_dtype == "int8" else "fp"
        geo = (pool.num_blocks, pool.block_size, self._tables.shape[1])
        eos = cfg.eos_token_id
        samp = (float(cfg.temperature), int(cfg.top_k), float(cfg.top_p))
        if kind == "paged_prefill":
            width, ofs = shape
            sig = (kind, 1, width) + geo + samp + (cdt, q8, c8, ofs,
                                                   self._shards)
        elif kind == "paged_decode":
            sig = (kind, len(self._slots)) + geo + (shape[0],) + samp \
                + (eos, cdt, q8, c8, self._shards)
        elif kind == "paged_verify":
            sig = (kind, len(self._slots), shape[0]) + geo \
                + (eos, cdt, q8, c8, self._shards)
        else:                                   # paged_cow
            sig = (kind, pool.num_blocks, pool.block_size, pool.num_layers,
                   cdt, pool.cache_dtype, self._shards)
        executables.note(self.model, sig)

    def _note_static(self, kind: str, chunk: int = 0,
                     resume: bool = False) -> None:
        cfg = self.config
        cdt, q8 = self._sig_common()
        c8 = "c8" if cfg.cache_dtype == "int8" else "cfull"
        B, cap, L = cfg.max_batch, cfg.prompt_cap, cfg.max_len
        if kind == "prefill":
            sig = ("prefill", B, cap, L, cdt, q8, c8, "ragged")
        else:
            sig = ("decode", B, cap, L, int(chunk), float(cfg.temperature),
                   int(cfg.top_k), float(cfg.top_p), cfg.eos_token_id, cdt,
                   q8, c8, "ragged", "resume" if resume else "fresh", "st",
                   "don")
        executables.note(self.model, sig)

    # -- admission ------------------------------------------------------
    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    @property
    def busy(self) -> bool:
        """Work remains: queued requests or live slots still decoding."""
        return bool(self._queue) or (self.config.paged
                                     and bool(self._live()))

    def preflight(self, prompt, max_new_tokens: Optional[int] = None):
        """Static admission check: Findings for everything about this
        request that would need another executable shape or is statically
        unservable. Empty findings = admissible (queue capacity is
        submit()'s business). `submit` refuses with the first finding's
        code: max_new_tokens, prompt_shape or kv_oom."""
        cfg = self.config
        p = np.asarray(prompt, dtype=np.int64).reshape(-1)
        want = cfg.max_new_tokens if max_new_tokens is None \
            else min(int(max_new_tokens), cfg.max_new_tokens)
        out = Findings()
        if want < 1:
            out.add(Finding(
                "config", "max_new_tokens", "error",
                f"token budget {want} < 1 is unservable (the caller "
                f"asked to pay for nothing)", executable="serving"))
        plen = int(p.shape[0])
        if plen < 1 or plen > cfg.prompt_cap:
            out.add(Finding(
                "recompile_hazard", "prompt_shape", "error",
                f"prompt length {plen} would force a new prefill "
                f"executable: input_ids [{cfg.max_batch}, "
                f"{cfg.prompt_cap}] -> [{cfg.max_batch}, {plen}] (outside "
                f"[1, {cfg.prompt_cap}])", executable="serving_batch",
                data={"prompt_len": plen, "cap": cfg.prompt_cap}))
        if cfg.paged and plen >= 1 and want >= 1 \
                and not self._pool.fits_ever(plen + want - 1):
            msg = (f"request needs {plen + want - 1} KV rows — more than "
                   f"the whole pool holds even fully drained")
            data = {"rows": plen + want - 1}
            if self._memz is not None:
                top = self._memz.top_owners(3)
                if top:
                    data["top_owners"] = top
                    msg += "; top HBM owners: " + ", ".join(
                        f"{t['owner']}={t['bytes']}B" for t in top)
            out.add(Finding("config", "kv_oom", "error", msg,
                            executable="serving", data=data))
        return out

    def submit(self, prompt, max_new_tokens: Optional[int] = None,
               deadline_s: Optional[float] = None,
               enqueue_at: Optional[float] = None,
               probe: bool = False) -> Request:
        """Admit one prompt into the bounded queue. Returns the Request:
        status "queued" on success, "rejected" with a reason otherwise
        (draining; the preflight's prompt_shape / kv_oom / max_new_tokens;
        overloaded / queue_full: load shed), with `retriable` saying
        whether another replica may serve it. `enqueue_at` backdates the
        enqueue for open-loop replay: queue wait and TTFT are then
        measured from the scheduled arrival; a future time clamps to now.
        `probe=True` tags a golden-canary request, accounted apart from
        user traffic."""
        self._leader_only("submit")
        cfg = self.config
        prompt = np.asarray(prompt, dtype=np.int64).reshape(-1)
        want = cfg.max_new_tokens if max_new_tokens is None \
            else min(int(max_new_tokens), cfg.max_new_tokens)
        req = Request(id=self._next_id, prompt=prompt, max_new_tokens=want,
                      probe=probe,
                      deadline_s=cfg.deadline_s if deadline_s is None
                      else deadline_s)
        self._next_id += 1
        req.trace.trace_id = f"{self._run_id}-{req.id}"
        now = self.clock()
        req.trace.t_enqueue = now if enqueue_at is None \
            else min(enqueue_at, now)
        reason = None
        if self._draining:
            reason = "draining"
        else:
            pf = self.preflight(prompt, want)
            if pf:
                reason = pf[0].code
                plen = int(prompt.shape[0])
                if reason == "prompt_shape" and \
                        plen not in self._rejected_shapes:
                    # warn once per offending shape; nothing was built
                    self._rejected_shapes.add(plen)
                    self.monitor.record_compile(
                        "serving_reject",
                        (((cfg.max_batch, plen), "int64"),
                         self._shape_sig[1]),
                        prev_sig=self._shape_sig, count=False)
        if reason is None and cfg.queue_high_watermark is not None and \
                len(self._queue) >= cfg.queue_high_watermark:
            reason = "overloaded"
        if reason is None and len(self._queue) >= cfg.queue_capacity:
            reason = "queue_full"
        if reason is not None:
            req.status, req.reason = "rejected", reason
            req.retriable = _REJECT_RETRIABLE.get(reason, False)
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
        status "error" (paged: an out-of-memory first dumps the memory
        ledger's post-mortem, then the pool and the prefix cache are
        rebuilt) and the exception propagates. Each step is one record of
        the batch monitor; a step whose device calls include one never
        run before records a compile (executables.py)."""
        self._leader_only("step")
        if not self.config.paged:
            return self._step_padded()
        b0 = executables.builds()
        ran = set()
        self.monitor.begin_step()
        out_tokens = 0
        spill0 = (self._spill.spilled_total, self._spill.rehydrated_total) \
            if self._spill is not None else (0, 0)
        live = []
        try:
            finished, expired, admit_ran = self._admit_paged()
            ran |= admit_ran
            pf_done, pf_ran = self._advance_prefill()
            ran |= pf_ran
            finished.extend(pf_done)
            live = self._decodable()
            if live:
                if self.config.spec_decode:
                    done, out_tokens, dec_ran = self._decode_chunk_spec(live)
                    ran |= dec_ran
                else:
                    done, out_tokens = self._decode_chunk_paged(live)
                    ran.add("decode")
                finished.extend(done)
        except BaseException as step_exc:
            # the post-mortem runs BEFORE the recovery below resets the
            # pool: it must show the occupancy that failed
            if self._memz is not None:
                from ..obs.memz import looks_like_oom
                if looks_like_oom(step_exc):
                    inflight = [
                        {"id": r.id, "prompt_len": len(r.prompt),
                         "n_out": r.n_out}
                        for r in self._slots if r is not None]
                    self._memz.post_mortem(
                        error=step_exc,
                        context={"site": "serving.step",
                                 "batch_id": self._batch_id,
                                 "queue_depth": len(self._queue),
                                 "inflight": inflight})
            now = self.clock()
            for i, r in enumerate(self._slots):
                if r is not None:
                    r.status, r.reason = "error", "engine_exception"
                    r.trace.t_finish = now
                    self.metrics.record_request(r)
                    self._slots[i] = None
                    self._pool.free(r.id)
                    self._clear_slot(i)
            # a failed call may have left the pools half-written; the
            # reset wipes the refcounts, so the cache drops its entries
            # without releasing them
            if self._prefix is not None:
                self._prefix.clear(release=False)
            self._pool.reset()
            if self._runner is not None and self._runner.broken:
                self._op_reset()    # the followers are gone
            else:
                self._dev("reset")
            self.metrics.gauges["inflight"] = 0
            self.monitor.end_step(items=0)
            raise
        self.metrics.gauges["inflight"] = len(self._live())
        if ran:
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
        if self._spill is not None:
            if self._spill.spilled_total > spill0[0]:
                ran.add("spill")
            if self._spill.rehydrated_total > spill0[1]:
                ran.add("rehydrate")
        # a build while every kind this step ran was already built is
        # shape churn: a recompile
        dm = executables.builds() - b0
        if dm:
            self.monitor.record_compile(
                "serving_batch", (("executable_builds", dm),),
                prev_sig=(("executable_builds", 0),)
                if ran and ran <= self._paged_seen else None)
        self._paged_seen |= ran
        self.monitor.end_step(items=out_tokens)
        return expired + finished

    @property
    def draining(self) -> bool:
        return self._draining

    def begin_drain(self):
        """Enter graceful-drain mode: submit() refuses new work with a
        structured "draining" rejection (retriable) while queued and
        in-flight requests keep being served."""
        self._draining = True
        return self

    def resume_admission(self):
        """Leave drain mode (a cancelled shutdown)."""
        self._draining = False
        return self

    def drain(self, max_batches: Optional[int] = None,
              seal: bool = False) -> List[Request]:
        """step() until the queue empties and every live slot finishes
        (or max_batches steps ran); returns the terminal requests.
        `seal=True` is the graceful-shutdown form: stop admitting first
        (begin_drain), and once empty flush the liveness gauges and emit
        the terminal summary row; the engine then refuses traffic until
        resume_admission()."""
        self._leader_only("drain")
        if seal:
            self.begin_drain()
        out: List[Request] = []
        n = 0
        while self.busy:
            if max_batches is not None and n >= max_batches:
                break
            got = self.step()
            n += 1
            if not got and not self.busy:
                break
            out.extend(got)
        if seal:
            if not self.busy:
                self.metrics.flush()
            else:
                _logger.warning(
                    "drain(seal=True) hit max_batches=%s with work "
                    "remaining (queue+slots still busy): terminal "
                    "metrics flush skipped, engine left in drain mode — "
                    "call drain() again to finish", max_batches)
        return out

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
            self.monitor.end_step(items=0)
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
        b0 = executables.builds()
        self.monitor.begin_step()
        t_pf0 = self.clock()
        self._note_static("prefill")
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
            self._note_static("decode", chunk, resume=ci > 0)
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
        out_tokens = 0
        for i, r in enumerate(reqs):
            row = gen[i, :r.max_new_tokens]
            r.tokens = row
            r.n_out = _n_out(row, cfg.eos_token_id)
            r.status = "done"
            if r.trace.t_finish is None:
                r.trace.t_finish = t_chunk
            out_tokens += r.n_out
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
        # compile accounting per chunk DEPTH: a batch that stops early
        # never ran the deeper chunks, whose first build later is no churn
        depth = 1 + len(parts)
        dm = executables.builds() - b0
        if dm:
            self.monitor.record_compile(
                "serving_batch", (("executable_builds", dm),),
                prev_sig=(("executable_builds", 0),)
                if depth <= self._max_depth else None)
        self._max_depth = max(self._max_depth, depth)
        self.monitor.end_step(items=out_tokens)
        return reqs

    # -- the paged engine -------------------------------------------------
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
        """The per-slot host vectors a decode or verify call takes:
        tables [B, MB], lens [B], pending [B], done [B]. Empty slots and
        rows still mid-chunked-prefill ship a trash table row, lens 0 and
        done=True, so the fixed-[B] call cannot write into (or attend)
        their blocks; their host state is untouched."""
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
        return tables, lens, pending, done

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
        first run's cached chain) runs too. With the spill tier, every
        cached block then goes through the host tier and back (the spill
        and rehydrate copies). `clear=True` then drops the warmup's cached
        prefixes so measured traffic starts cold."""
        self._leader_only("warmup_prefix_cache")
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
        if self._spill is not None:
            self._prefix.evict(self._prefix.cached_blocks)
            self.submit(p)
            self.drain()
        if clear:
            self._prefix.clear()
        return self

    def _spill_write(self, blk: int, payload):
        """Rehydrate one spilled full-width payload into pool block `blk`
        (the pools are updated in place; sharded, every rank writes its
        head slice)."""
        self._dev("spill_write", np.asarray(int(blk)), extra=payload)

    def _cow_copy(self, src: int, dst: int):
        """Copy pool block `src` into private block `dst` in every layer's
        planes (codes and scales for int8): the copy-on-write an aligned
        full-prefix hit needs before its re-decode of the last prompt
        token writes inside the last shared block. Shard-local: each rank
        copies its heads, no collective."""
        self._note_paged("paged_cow")
        self._dev("cow", np.asarray(int(src)), np.asarray(int(dst)))

    def _admit_paged(self):
        """Fill every free slot from the queue: consult the prefix trie,
        map shared blocks and allocate fresh ones, prefill what the cache
        does not hold yet, and install the row for the next decode chunk.
        When the head of the queue does not fit the free blocks, admission
        waits for live rows to free theirs (one mem_pressure row per
        episode). Returns (finished, expired, ran_tags): a budget-1 or
        instant-EOS request finishes here.

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
        `_advance_prefill` prefills from position t window by window.
        Probe admissions stay out of the prefix counters."""
        cfg = self.config
        bs = self._pool.block_size
        finished: List[Request] = []
        expired: List[Request] = []
        ran = set()
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
                self._mem_pressure_enter(req, need_rows)
                break            # wait for live rows to free their blocks
            self._mem_pressure_exit()
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
            if self._prefix is not None and not req.probe:
                self.metrics.counters[
                    "prefix_hit" if t else "prefix_miss"] += 1
            if t >= plen - 1 and t > 0:
                # zero-prefill admission: every prompt position but the
                # re-decoded last one is served from cached blocks
                if cow:
                    self._cow_copy(matched[-1], int(blocks[len(shared)]))
                    ran.add("cow")
                self._lens[slot] = plen - 1
                self._pending[slot] = int(req.prompt[plen - 1])
                self._done[slot] = False
                req._chunks = []
                req._produced = 0
                req.trace.t_prefill_done = now   # nothing to prefill
                if not req.probe:
                    self.metrics.counters["prefill_tokens_saved"] += \
                        plen - 1
                # only positions < t hold written KV yet
                self._insert_prefix(req, blocks, t)
            elif cfg.prefill_chunk is not None:
                self._prefill_pos[slot] = t
                req._chunks = []
                req._produced = 0
                if t and not req.probe:
                    self.metrics.counters["prefill_tokens_saved"] += t
            else:
                suffix = plen - t
                ids = np.full((1, cfg.prompt_cap), cfg.pad_token_id,
                              dtype=np.int64)
                ids[0, :suffix] = req.prompt[t:]
                t_pf0 = self.clock()
                self._note_paged("paged_prefill", cfg.prompt_cap,
                                 "abs" if t == 0 else "ofs")
                first = self._dev(
                    "prefill", ids, np.asarray([suffix], np.int32),
                    table_row[None], np.asarray([t if t else -1], np.int32),
                    np.asarray(cfg.seed + self._calls))
                tok = int(first.cpu()[0])         # host sync: TTFT is known
                self._calls += 1
                ran.add("prefill" if t == 0 else "prefix_prefill")
                req.trace.events.append(
                    ("prefill" if t == 0 else "suffix_prefill", t_pf0,
                     self.clock()))
                if t and not req.probe:
                    self.metrics.counters["prefill_tokens_saved"] += t
                if self._complete_prefill(slot, req, tok, self.clock()):
                    finished.append(req)
                    free.insert(0, slot)
            self._batch_id += 1
        if not self._queue:
            # the waiting head left some other way (deadline expiry):
            # close the episode
            self._mem_pressure_exit()
        self.metrics.gauges["queue_depth"] = len(self._queue)
        if ran:
            self._snapshot_kv()
        return finished, expired, ran

    def _advance_prefill(self):
        """One [1, prefill_chunk] prefill window for every slot still
        mid-chunked-prefill, at its next position (start = offset). The
        final window's sampled token is the request's first token and the
        row joins the next decode chunk. Returns (finished, ran_tags): a
        budget-1 or instant-EOS request finishes when its prefill lands."""
        cfg = self.config
        finished: List[Request] = []
        ran = set()
        if cfg.prefill_chunk is None:
            return finished, ran
        pc = cfg.prefill_chunk
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
            self._note_paged("paged_prefill", pc, "ofs")
            first = self._dev(
                "prefill", ids, np.asarray([clen], np.int32),
                self._tables[slot][None], np.asarray([off], np.int32),
                np.asarray(cfg.seed + self._calls))
            # only the final window's token is used: syncing the others
            # would put a host round trip on every window
            tok = int(first.cpu()[0]) if final else 0
            self._calls += 1
            ran.add("prefill_chunk")
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

    def _decode_chunk_paged(self, live: List[int]):
        """One fixed-shape [B, decode_chunk] decode call over every slot;
        finish and free each row that hit EOS or its budget. Returns
        (finished, real tokens)."""
        cfg = self.config
        c = cfg.decode_chunk
        self._snapshot_kv()
        tables, lens, pending, done = self._ship_decode_state()
        t_c0 = self.clock()
        self._note_paged("paged_decode", c)
        toks, done_d = self._dev("decode", tables, lens, pending, done,
                                 np.asarray(c),
                                 np.asarray(cfg.seed + self._calls))
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
        out_tokens = 0
        for slot in live:
            req = self._slots[slot]
            req.trace.events.append(("decode", t_c0, t))
            take = min(c, req.max_new_tokens - req._produced)
            req._chunks.append(arr[slot, :take])
            req._produced += take
            out_tokens += take
            if req.trace.t_first_token is None:
                # zero-prefill admission: this chunk's first token is the
                # request's first token
                req.trace.t_first_token = t
            self._lens[slot] += c     # the device wrote c rows regardless
            if req._produced >= req.max_new_tokens or \
                    _hit_eos(arr[slot, :take], cfg.eos_token_id):
                self._finish_paged_row(slot, t)
                finished.append(req)
        return finished, out_tokens

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

    def _decode_chunk_spec(self, live: List[int]):
        """One speculative verify window over the slot batch: a
        [B, spec_k + 1] call through model.verify_paged. Rows with a draft
        advance by their accepted length + 1; rows without one ride along
        on pad drafts and advance by >= 1 (a pad that matches the chain is
        a real acceptance: every emitted token is the argmax). A step
        where no row has a draft runs the plain decode chunk. Returns
        (finished, real tokens, ran_tags); probe windows stay out of the
        spec counters."""
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
            finished, out_tokens = self._decode_chunk_paged(live)
            return finished, out_tokens, {"decode"}
        self._snapshot_kv()
        tables, lens, pending, done = self._ship_decode_state()
        t_c0 = self.clock()
        self._note_paged("paged_verify", cfg.spec_k + 1)
        toks, n_acc, done_d = self._dev("verify", tables, lens, pending,
                                        drafts, done)
        arr = toks.cpu().numpy()                    # host sync per window
        acc = n_acc.cpu().numpy()
        done_new = done_d.cpu().numpy()
        self._calls += 1
        t = self.clock()
        finished: List[Request] = []
        out_tokens = 0
        mt = self.metrics
        for slot in live:
            req = self._slots[slot]
            req.trace.events.append(("spec_verify", t_c0, t))
            n_emit = int(acc[slot]) + 1
            take = min(n_emit, req.max_new_tokens - req._produced)
            fresh = arr[slot, :take]
            req._chunks.append(fresh)
            req._produced += take
            out_tokens += take
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
                if not req.probe:
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
        return finished, out_tokens, {"spec_verify"}

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

    # -- reporting ------------------------------------------------------
    def summary(self) -> dict:
        s = self.metrics.summary()
        s["batch_step"] = self.monitor.report()
        return s

    def metrics_text(self, prefix: str = "paddle_tpu_serving") -> str:
        """The request metrics and the batch monitor's block: one page."""
        return self.metrics.metrics_text(prefix=prefix) + \
            self.monitor.metrics_text(prefix=f"{prefix}_batch")

    # -- ops surface ----------------------------------------------------
    def health(self) -> dict:
        """The /healthz payload: drain state, queue depth against its
        shed thresholds, inflight rows and the shed/goodput counters. Host
        reads only; safe from any thread at scrape rate."""
        cfg, m = self.config, self.metrics
        inflight = len(self._live()) if cfg.paged \
            else m.gauges["inflight"]
        return {"status": "draining" if self._draining else "ok",
                "draining": self._draining,
                "queue_depth": len(self._queue),
                "queue_capacity": cfg.queue_capacity,
                "queue_high_watermark": cfg.queue_high_watermark,
                "inflight": inflight,
                "overloaded_total": m.counters["overloaded"],
                "rejected_total": m.counters["rejected"],
                "requests_total": m.counters["requests"],
                "completed_total": m.counters["completed"],
                "kv_occupancy": m.gauges["kv_occupancy"]}

    def fingerprint(self) -> dict:
        """Deterministic config/build identity: the key goldens are minted
        under. Cached (every component is process-stable)."""
        if self._fingerprint is None:
            from ..obs.probez import config_fingerprint
            self._fingerprint = config_fingerprint(self.model.config,
                                                   self.config)
        return self._fingerprint

    def statusz(self) -> dict:
        """The /statusz payload: engine identity and config envelope,
        compile accounting (the JAX engine's counters; in place of its
        jit cache misses, the kernel libraries this process loaded),
        KV / prefix-cache / spill occupancy, the fingerprint, the
        counters and gauges, and the memory ledger's block."""
        from ..ops.cuda.build import loaded_libraries
        out = {"engine": {"run_id": self._run_id,
                          "uptime_s": round(self.clock() - self._t_start,
                                            3),
                          "draining": self._draining,
                          "paged": self.config.paged,
                          "requests_submitted": self._next_id,
                          "batches": self._batch_id},
               "config": {k: (v if isinstance(v, (int, float, str, bool,
                                                  type(None)))
                              else repr(v))
                          for k, v in vars(self.config).items()},
               "compile": {"compiles": self.monitor.compiles,
                           "recompiles": self.monitor.recompiles,
                           "kernel_libraries": loaded_libraries()},
               "fingerprint": self.fingerprint(),
               "counters": dict(self.metrics.counters),
               "gauges": dict(self.metrics.gauges)}
        if self.config.paged:
            pool = self._pool
            kv_tokens, kv_slots, kv_shared = self._kv_snapshot
            out["kv"] = {"blocks_total": pool.num_blocks,
                         "block_size": pool.block_size,
                         "used_blocks": pool.used_blocks,
                         "capacity_tokens": pool.capacity_tokens,
                         "live_tokens": kv_tokens,
                         "slot_tokens": kv_slots,
                         "shared_tokens": kv_shared,
                         "cache_dtype": pool.cache_dtype}
            if self._prefix is not None:
                out["prefix_cache"] = {
                    "cached_blocks": self._prefix.cached_blocks,
                    "cached_bytes": self._prefix.cached_bytes,
                    "spilled_blocks": self._prefix.spilled_blocks,
                    "byte_budget": self._prefix.byte_budget}
            if self._spill is not None:
                out["spill"] = self._spill.stats()
        if self._memz is not None:
            out["memory"] = self._memz.statusz_block()
        return out

    def attach_memory_ledger(self, ledger=None):
        """Wire a MemoryLedger (by default one on the model's device) to
        this engine's owners and return it. Reader-backed owners over
        accounting the engine already keeps (a ledger read never syncs):

          model_params   the parameters' bytes (a rank's shard)
          serving_tables the replicated wte (and untied head) a sharded
                         engine gathered
          kv_pool        the pool's full reservation (num_blocks x
                         bytes_per_block: the sum of the pool tensors'
                         bytes, a rank's heads), `used_bytes` as detail
          prefix_cache   retained-block bytes, an OVERLAY (they live
                         inside kv_pool's reservation)
          spill_host     the host spill tier (device=False: never summed
                         against device memory)

        The pool's `on_change` observer re-samples the pool and cache
        owners on every alloc/free, so the delta ring is the growth
        curve; ledger rows ride the metrics' structured-row stream."""
        if ledger is None:
            from ..obs.memz import MemoryLedger
            ledger = MemoryLedger(device=self.model.device)
        self._memz = ledger

        def _params_bytes():
            return int(sum(p.numel() * p.element_size()
                           for p in self.model.parameters()))
        ledger.register("model_params", _params_bytes, kind="params",
                        replace=True)
        if self._runner is not None:
            ledger.register("serving_tables", lambda: self._tables_bytes,
                            kind="params", replace=True)
        if self.config.paged:
            pool = self._pool

            def _pool_bytes():
                bpb = pool.bytes_per_block
                return {"bytes": pool.num_blocks * bpb,
                        "used_bytes": pool.used_blocks * bpb,
                        "used_blocks": pool.used_blocks,
                        "free_blocks": pool.free_blocks}
            ledger.register("kv_pool", _pool_bytes, kind="kv",
                            meta={"shards": self._shards,
                                  "block_size": pool.block_size,
                                  "num_blocks": pool.num_blocks},
                            replace=True)
            pool.on_change = lambda: ledger.sample("kv_pool",
                                                   "prefix_cache")
            if self._prefix is not None:
                prefix = self._prefix
                ledger.register(
                    "prefix_cache",
                    lambda: {"bytes": prefix.cached_bytes,
                             "cached_blocks": prefix.cached_blocks,
                             "spilled_blocks": prefix.spilled_blocks},
                    kind="kv", overlay=True, replace=True)
            if self._spill is not None:
                spill = self._spill
                ledger.register("spill_host",
                                lambda: int(spill.host_bytes),
                                kind="spill", device=False, replace=True)
        if ledger.on_row is None:
            ledger.on_row = self.metrics._emit
        self.monitor.memz = ledger
        ledger.sample()
        return ledger

    def _mem_pressure_enter(self, req, need_rows: int):
        if self._mem_pressure_t0 is not None:
            return                       # already inside the episode
        self._mem_pressure_t0 = self.clock()
        body = {"request": req.id, "need_rows": int(need_rows),
                "free_blocks": self._pool.free_blocks,
                "used_blocks": self._pool.used_blocks,
                "queue_depth": len(self._queue)}
        if self._memz is not None:
            body["top_owners"] = self._memz.top_owners(3)
        self.metrics._emit({"mem_pressure": body, "ts": time.time()})
        self.metrics.counters["mem_pressure_episodes"] += 1

    def _mem_pressure_exit(self):
        if self._mem_pressure_t0 is None:
            return
        waited = self.clock() - self._mem_pressure_t0
        self._mem_pressure_t0 = None
        self.metrics._emit({"mem_pressure_clear":
                            {"waited_s": round(waited, 6),
                             "free_blocks": self._pool.free_blocks},
                            "ts": time.time()})

    def metrics_registry(self, prefix: str = "paddle_tpu_serving"):
        """The engine's exposition producers composed through the
        collision-checked obs.MetricsRegistry: the /metrics source of
        `serve_telemetry`."""
        from ..obs import MetricsRegistry
        reg = MetricsRegistry()
        reg.register("serving",
                     lambda: self.metrics.metrics_text(prefix=prefix))
        reg.register("serving_batch",
                     lambda: self.monitor.metrics_text(
                         prefix=f"{prefix}_batch"))
        if self._spill is not None:
            reg.register("spill",
                         lambda: self._spill.metrics_text(
                             prefix=f"{prefix}_spill"))
        if self._memz is not None:
            reg.register("memz",
                         lambda: self._memz.metrics_text(
                             prefix="paddle_tpu"))
        if self._prober is not None:
            # separate producers: an exposition without a prober is
            # byte-identical by construction
            reg.register("probe", self._prober.metrics_text)
            reg.register("probe_serving", self.metrics.probe_metrics_text)
        if self._invariants is not None:
            reg.register("invariant", self._invariants.metrics_text)
        return reg

    def serve_telemetry(self, *, host: str = "127.0.0.1", port: int = 0,
                        slo=None, poll_interval: Optional[float] = None,
                        registry=None, trace_capacity: int = 256,
                        flightrec=None, prober=None,
                        probe_interval: Optional[float] = None,
                        invariant_interval: Optional[float] = None):
        """Boot the replica's ops surface: a started obs.TelemetryServer
        wired to this engine — /metrics from `metrics_registry()` (and the
        SLO monitor's burn gauges), /healthz from `health()`, /statusz
        from `statusz()`, /tracez from the metrics' tail-sampling
        TraceBuffer (attached here when none is), /memz from the memory
        ledger (attached here when none is), /probez with a prober.
        Returns the server; `.close()` it on shutdown.

        `slo` is an obs.SLOMonitor or a parse_slo spec string; with
        `poll_interval` a server poller thread drives slo.poll(). `prober`
        is an obs.Prober or True to build one; with `probe_interval` a
        poller runs its cycles. `invariant_interval` schedules the
        InvariantAuditor's audits (paged engines). Both of those pollers
        hold the prober's lock; a thread stepping the engine beside them
        must share it (`srv.prober.lock`).

        `flightrec` is an obs.FlightRecorder: it attaches to this engine's
        StepMonitor (captures advance at the engine's step brackets), taps
        the metrics' structured rows (the SLO monitor's alerts and the
        probes' failures among them) as capture triggers, exports its
        counters on /metrics, and mounts the /profilez route. It rides
        `srv.flightrec`; detaching at shutdown stays with the caller
        (`flightrec.detach()`)."""
        from ..obs import (InvariantAuditor, Prober, SLOMonitor,
                           TelemetryServer, TraceBuffer)
        if self.metrics.trace_buffer is None:
            self.metrics.trace_buffer = TraceBuffer(trace_capacity)
        if self._memz is None:
            self.attach_memory_ledger()
        if prober is True:
            prober = Prober(self)
        if prober is not None:
            self._prober = prober
        if self.config.paged and (prober is not None or
                                  invariant_interval is not None):
            auditor = InvariantAuditor(
                self, lock=prober.lock if prober is not None else None)
            self._invariants = auditor
            if prober is not None:
                prober.auditor = auditor
        elif invariant_interval is not None:
            raise ValueError("invariant_interval needs a paged engine "
                             "(the audits walk the block pool)")
        reg = registry if registry is not None else self.metrics_registry()
        if isinstance(slo, str):
            slo = SLOMonitor(slo, self.metrics)
        if slo is not None:
            reg.register("slo", slo.metrics_text)
        elif poll_interval is not None:
            raise ValueError("poll_interval needs an slo monitor/spec "
                             "to poll")
        routes = {"/memz": self._memz.memz}
        if prober is not None:
            routes["/probez"] = prober.probez
        if flightrec is not None:
            # monitor: step brackets + recompile/numerics rows; metrics:
            # every structured row, slo_alert included (the SLO monitor
            # emits through metrics._emit, so tapping on_alert too would
            # count each alert twice)
            flightrec.attach(monitor=self.monitor, metrics=self.metrics)
            reg.register("flightrec", flightrec.metrics_text)
            routes["/profilez"] = flightrec.profilez
        srv = TelemetryServer(reg, host=host, port=port,
                              health=self.health, status=self.statusz,
                              tracez=self.metrics.trace_buffer,
                              routes=routes)
        srv.slo = slo
        srv.flightrec = flightrec
        srv.prober = prober
        srv.invariants = self._invariants
        if slo is not None and poll_interval is not None:
            srv.add_poller(slo.poll, poll_interval, name="slo")
        if prober is not None and probe_interval is not None:
            srv.add_poller(prober.probe_once, probe_interval,
                           name="probe")
        if self._invariants is not None and \
                invariant_interval is not None:
            srv.add_poller(self._invariants.audit, invariant_interval,
                           name="invariants")
        return srv.start()


def _config_digest(model_config, config) -> int:
    """An int64 digest of the model's and the engine's configuration
    (callables by name only: their reprs differ between processes)."""
    import hashlib

    def clean(v):
        return getattr(v, "__qualname__", "callable") if callable(v) else v
    text = repr((sorted(vars(model_config).items()),
                 sorted((k, clean(v)) for k, v in vars(config).items())))
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8],
                          "little", signed=True)


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
