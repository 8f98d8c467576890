"""Paged continuous-batching GPT serving (the port of the paged path of
paddle_tpu/inference/serving.py).

  ServingEngine   admits prompts into a bounded queue and serves them with
                  slot-level continuous batching over a paged KV block pool
                  (inference/kv_cache.py): each batch slot runs its own
                  request, a finished row frees its blocks at once, and a
                  queued request is spliced into the vacated slot
                  mid-flight (one [1, prompt_cap] prefill per admission,
                  then the row joins the next [B, decode_chunk] decode
                  chunk). An oversubscribed pool makes admission wait for
                  freed blocks; only a request that could never fit is
                  rejected.

  RequestTrace    per-request timestamps (enqueue -> admit -> prefill ->
                  first token -> finish) and the engine-call windows the
                  request rode.

  ServingMetrics  log-bucketed TTFT / TPOT / e2e / queue-wait histograms,
                  queue and KV gauges, request and token counters.

Greedy engine output equals the JAX engine's and the JAX
`generate_static_ragged`'s token chains per request (tests). On a CUDA
model every decode step runs the hand-written paged-attention kernels.

Not ported yet: the padded engine (paged=False) and weight_dtype="int8"
(static-decode slice), prefix_cache / spec_decode / prefill_chunk (prefix
slice, kernels #3-#4), shards > 1 (multi-GPU slice), and the graph-lint,
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


# --------------------------------------------------------------- requests

@dataclass
class RequestTrace:
    """Timestamps of one request's life (engine clock seconds) and the
    engine-call windows it rode, as (name, t0, t1) tuples ("prefill",
    "decode"). finish is stamped at the end of the decode chunk in which
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
    trace: RequestTrace = field(default_factory=RequestTrace)

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])


# ---------------------------------------------------------------- metrics

class LogHistogram:
    """Fixed-memory latency histogram with log-spaced bucket bounds
    lo * 10^(k / per_decade) up to hi, plus an overflow bucket.
    Percentiles interpolate inside the containing bucket and clamp to the
    observed min/max."""

    def __init__(self, lo: float = 1e-4, hi: float = 1e3,
                 per_decade: int = 10):
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

    HISTS = ("ttft_seconds", "tpot_seconds", "e2e_seconds", "queue_seconds")

    def __init__(self):
        self.hists = {name: LogHistogram() for name in self.HISTS}
        self.counters = {"requests": 0, "completed": 0, "rejected": 0,
                         "overloaded": 0, "timeout": 0, "errors": 0,
                         "tokens_in": 0, "tokens_out": 0, "batches": 0}
        self.gauges = {"queue_depth": 0, "inflight": 0,
                       "batch_fill_ratio": None, "kv_occupancy": None,
                       "kv_slots_occupancy": None}

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
                     kv_slots: int, kv_capacity: int, queue_depth: int):
        """kv_tokens = live (attendable) KV rows; kv_slots = rows the
        reserved blocks pin; kv_capacity = total pooled rows."""
        self.counters["batches"] += 1
        self.gauges["batch_fill_ratio"] = n_real / max(capacity, 1)
        self.gauges["kv_occupancy"] = kv_tokens / max(kv_capacity, 1)
        self.gauges["kv_slots_occupancy"] = kv_slots / max(kv_capacity, 1)
        self.gauges["queue_depth"] = queue_depth

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
    weight_dtype: Optional[str] = None   # "int8": static-decode slice
    cache_dtype: Optional[str] = None    # "int8" -> int8 KV pools
    paged: bool = False             # the only engine this port has is paged
    kv_block: int = 16              # KV rows per pool block
    kv_blocks: Optional[int] = None  # total pool blocks INCL. trash block;
    #                            default = worst case for max_batch rows
    shards: Optional[int] = None
    prefix_cache: bool = False
    prefix_cache_bytes: Optional[int] = None
    spill_host_bytes: Optional[int] = None
    spec_decode: bool = False
    spec_k: int = 4
    spec_draft: object = "trie"
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
        later = (
            ("prefix_cache", self.prefix_cache,
             "the prefix-cache slice (kernels #3-#4)"),
            ("spill_host_bytes", self.spill_host_bytes is not None,
             "the prefix-cache slice"),
            ("spec_decode", self.spec_decode,
             "the prefix-cache / spec-decode slice (kernels #3-#4)"),
            ("prefill_chunk", self.prefill_chunk is not None,
             "the prefix-cache / chunked-prefill slice (kernels #3-#4)"),
            ("shards", (self.shards or 1) > 1, "the multi-GPU slice"),
            ("weight_dtype", self.weight_dtype is not None,
             "the static-decode slice (int8_matmul, kernel #5)"),
            ("lint", self.lint is not None,
             "the observability slice (graph lint)"))
        for name, on, where in later:
            if on:
                raise NotImplementedError(
                    f"ServingConfig.{name} is not ported to PyTorch yet: it "
                    f"comes with {where}")
        if self.cache_dtype not in (None, "int8"):
            raise ValueError(f"paged cache_dtype must be None or 'int8'; "
                             f"got {self.cache_dtype!r}")
        if self.kv_block < 1:
            raise ValueError(f"kv_block must be >= 1, got {self.kv_block}")
        if self.kv_blocks is None:
            # worst case: every slot holds a cap prompt decoding its full
            # budget (+1 for the trash block); smaller pools oversubscribe
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


class ServingEngine:
    """Paged continuous-batching serving loop.

    Synchronous: `submit()` enqueues, `step()` splices queued requests
    into free slots and runs ONE decode chunk over the live slots,
    `drain()` loops until the queue and the slots are empty. Not
    internally synchronized: hold one lock around every engine call when
    several threads drive it. The engine runs on the model's device; the
    pools are allocated there and updated in place. `clock` is
    injectable (tests drive deadlines deterministically)."""

    def __init__(self, model, config: ServingConfig, *,
                 metrics: Optional[ServingMetrics] = None,
                 clock: Callable[[], float] = time.monotonic):
        if not config.paged:
            raise NotImplementedError(
                "ServingConfig(paged=False): the padded engine runs the "
                "static decode stack, ported with the static-decode slice; "
                "use paged=True")
        self.model = model
        self.config = config
        self.metrics = metrics or ServingMetrics()
        self.clock = clock
        self._queue: deque = deque()
        self._next_id = 0
        self._batch_id = 0
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
        self._kv_snapshot = (0, 0)   # (live tokens, reserved rows)

    # -- admission ------------------------------------------------------
    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    @property
    def busy(self) -> bool:
        """Work remains: queued requests or live slots still decoding."""
        return bool(self._queue) or bool(self._live())

    def _refusal(self, plen: int, want: int) -> Optional[str]:
        """Why a request is statically unservable, or None."""
        cfg = self.config
        if want < 1:
            return "max_new_tokens"
        if plen < 1 or plen > cfg.prompt_cap:
            return "prompt_shape"
        if not self._pool.fits_ever(plen + want - 1):
            return "kv_oom"
        return None

    def submit(self, prompt, max_new_tokens: Optional[int] = None,
               deadline_s: Optional[float] = None) -> Request:
        """Admit one prompt into the bounded queue. Returns the Request:
        status "queued" on success, "rejected" with a reason otherwise
        (prompt_shape: outside [1, prompt_cap]; kv_oom: the pool could
        not hold it even drained; overloaded / queue_full: load shed)."""
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
        """One engine step: splice queued requests into free slots
        (prefill into fresh blocks), then run ONE decode chunk over the
        live slots. Returns every request that reached a terminal status
        this step (served rows and queue-deadline timeouts). If a device
        call raises, the in-flight requests are recorded as status
        "error", the pool is rebuilt, and the exception propagates."""
        try:
            finished, expired, admitted = self._admit_paged()
            live = self._live()
            if live:
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
            # a failed call may have left the pools half-written
            self._pool.reset()
            self._pools = self._pool.make_pools()
            self.metrics.gauges["inflight"] = 0
            raise
        self.metrics.gauges["inflight"] = len(self._live())
        if admitted or live:
            # the batch the step served: rows live at decode entry (or, on
            # an admission-only step, the requests that finished there)
            n_real = len(live) if live else min(len(finished),
                                                len(self._slots))
            kv_tokens, kv_slots = self._kv_snapshot
            self.metrics.record_batch(
                n_real=n_real, capacity=len(self._slots),
                kv_tokens=kv_tokens, kv_slots=kv_slots,
                kv_capacity=self._pool.capacity_tokens,
                queue_depth=len(self._queue))
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

    def _clear_slot(self, slot: int):
        self._tables[slot] = 0         # trash block: writes go nowhere
        self._lens[slot] = 0
        self._pending[slot] = 0
        self._done[slot] = True

    def _snapshot_kv(self):
        live_tokens = int(sum(int(self._lens[s]) for s in self._live()))
        self._kv_snapshot = (live_tokens, self._pool.used_blocks
                             * self._pool.block_size)

    def _admit_paged(self):
        """Fill every free slot from the queue: allocate the request's
        worst-case blocks, prefill its prompt into them ([1, prompt_cap],
        right-padded), and install the row for the next decode chunk.
        When the head of the queue does not fit the free blocks, admission
        waits for live rows to free theirs. Returns (finished, expired,
        admitted) — a budget-1 or instant-EOS request finishes here."""
        cfg = self.config
        finished: List[Request] = []
        expired: List[Request] = []
        admitted = 0
        free = [i for i, r in enumerate(self._slots) if r is None]
        while self._queue and free:
            now = self.clock()
            req = self._queue[0]
            if req.deadline_s is not None and \
                    now - req.trace.t_enqueue > req.deadline_s:
                self._queue.popleft()
                req.status, req.reason = "timeout", "queue_deadline"
                req.trace.t_finish = now
                self.metrics.record_request(req)
                expired.append(req)
                continue
            plen = req.prompt_len
            if self._pool.alloc(req.id, plen + req.max_new_tokens - 1) \
                    is None:
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
            ids = np.full((1, cfg.prompt_cap), cfg.pad_token_id,
                          dtype=np.int64)
            ids[0, :plen] = req.prompt
            t_pf0 = self.clock()
            self._pools, first = self.model.prefill_paged(
                ids, np.asarray([plen], np.int32), self._pools,
                table_row[None], temperature=cfg.temperature,
                top_k=cfg.top_k, top_p=cfg.top_p,
                seed=cfg.seed + self._calls, cache_dtype=cfg.cache_dtype)
            tok = int(first.cpu()[0])         # host sync: TTFT is known
            self._calls += 1
            admitted += 1
            req.trace.events.append(("prefill", t_pf0, self.clock()))
            if self._complete_prefill(slot, req, tok, self.clock()):
                finished.append(req)
                free.insert(0, slot)
            self._batch_id += 1
        self.metrics.gauges["queue_depth"] = len(self._queue)
        if admitted:
            self._snapshot_kv()
        return finished, expired, admitted

    def _complete_prefill(self, slot: int, req: Request, tok: int,
                          tp: float) -> bool:
        """The sampled token becomes the row's pending and first token;
        a budget-1 or instant-EOS request finishes on the spot. Returns
        True when it did (the slot is free again)."""
        cfg = self.config
        req.trace.t_prefill_done = tp
        req.trace.t_first_token = tp  # sampled with the prefill
        self._lens[slot] = req.prompt_len
        self._pending[slot] = tok
        hit_eos = cfg.eos_token_id is not None and tok == cfg.eos_token_id
        self._done[slot] = hit_eos
        req._chunks = [np.asarray([tok], np.int64)]
        req._produced = 1
        if req._produced >= req.max_new_tokens or hit_eos:
            self._finish_paged_row(slot, tp)
            return True
        return False

    def _ship_decode_state(self):
        """The per-slot vectors a decode call takes, as device tensors:
        tables [B, MB], lens [B], pending [B], done [B]. Empty slots ship
        trash tables and done=True, so their rows write block 0 and their
        tokens are ignored."""
        dev = self.model.device
        return (torch.from_numpy(self._tables).to(dev),
                torch.from_numpy(self._lens).to(dev),
                torch.from_numpy(self._pending).to(dev),
                torch.from_numpy(self._done).to(dev))

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
            cache_dtype=cfg.cache_dtype)
        arr = toks.cpu().numpy()                     # host sync per chunk
        self._calls += 1
        t = self.clock()
        self._pending = arr[:, -1].astype(np.int32)
        self._done = done_d.cpu().numpy().copy()
        finished: List[Request] = []
        for slot in live:
            req = self._slots[slot]
            req.trace.events.append(("decode", t_c0, t))
            take = min(c, req.max_new_tokens - req._produced)
            req._chunks.append(arr[slot, :take])
            req._produced += take
            self._lens[slot] += c     # the device wrote c rows regardless
            if req._produced >= req.max_new_tokens or \
                    _hit_eos(arr[slot, :take], cfg.eos_token_id):
                self._finish_paged_row(slot, t)
                finished.append(req)
        return finished

    def _finish_paged_row(self, slot: int, t: float):
        """Terminal bookkeeping for one slot: its blocks free at once, so
        the next admission can splice a queued request into the slot."""
        req = self._slots[slot]
        row = np.concatenate(req._chunks)[:req.max_new_tokens]
        req.tokens = row.astype(np.int64)
        req.n_out = _n_out(req.tokens, self.config.eos_token_id)
        req.status = "done"
        req.trace.t_finish = t
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


__all__: Sequence[str] = ["RequestTrace", "Request", "ServingMetrics",
                          "ServingConfig", "ServingEngine",
                          "synthetic_traffic"]
