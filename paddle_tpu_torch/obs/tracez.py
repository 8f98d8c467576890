"""TraceBuffer — bounded per-request trace retention with TAIL sampling
(the port of paddle_tpu/obs/tracez.py; stdlib only).

A serving replica finishes thousands of requests per second; logging every
trace is the thing per-request JSONL is for (offline). `/tracez` answers a
different question — "show me why p99 was slow, NOW" — which head
sampling (keep 1-in-N) is structurally unable to answer: the traces that
explain a tail latency are, by definition, in the tail. This buffer
samples at the TAIL, after the request's outcome is known:

  - every non-`done` request (rejected / timeout / error) is retained —
    failures are always evidence;
  - every `done` request whose end-to-end latency lands at or above the
    `slow_quantile` (default p90: the slowest decile) of ALL latencies
    observed so far is retained — the quantile estimate derives from a
    log-bucket histogram over the full stream, so admission stays O(1)
    and the "slow" bar tracks the live distribution, not the buffer;
  - fast successes pass through a recency window (the newest ones stay
    until capacity pressure evicts them) so `/tracez` also shows what
    NORMAL looks like next to the outliers.

Eviction under a full buffer is priority-ordered: oldest fast-`done`
entry first, then oldest slow-`done`, then (only when the buffer is all
failures) the oldest failure. Capacity is a hard bound — the buffer can
never grow past it regardless of traffic shape.

Records are plain dicts (the `Request.record()` payload: status, span
stamps, window events, derived latencies, trace_id), so the buffer is
engine-agnostic and JSON-serializable as-is.
"""
from __future__ import annotations

import threading
from typing import List, Optional

from ..profiler._metrics import LogHistogram

__all__ = ["TraceBuffer", "chrome_trace"]


def chrome_trace(records) -> dict:
    """Render request trace records (TraceBuffer.snapshot() /
    Request.record() dicts) as Chrome trace-event JSON — the format
    ui.perfetto.dev and chrome://tracing load directly. One process per
    request (named by trace_id + status), two lanes: `request` carries
    the root span and the derived queue span, `engine` carries every
    engine-call window the request rode (prefill/decode/spec_verify
    chunks). Timestamps are microseconds relative to the earliest
    enqueue across the batch, so the view opens on a shared timeline."""
    out = []
    bases = []
    for rec in records:
        t = (rec.get("spans") or {}).get("t_enqueue")
        if t is not None:
            bases.append(float(t))
    t_base = min(bases) if bases else 0.0

    def us(t):
        return round((float(t) - t_base) * 1e6, 3)

    for i, rec in enumerate(records):
        pid = i + 1
        spans = rec.get("spans") or {}
        label = f"req {rec.get('trace_id') or rec.get('id')} " \
                f"[{rec.get('status')}]"
        out.append({"ph": "M", "pid": pid, "name": "process_name",
                    "args": {"name": label}})
        out.append({"ph": "M", "pid": pid, "tid": 0,
                    "name": "thread_name", "args": {"name": "request"}})
        out.append({"ph": "M", "pid": pid, "tid": 1,
                    "name": "thread_name", "args": {"name": "engine"}})
        t_enq = spans.get("t_enqueue")
        t_adm = spans.get("t_admit")
        t_fin = spans.get("t_finish")
        t_tok = spans.get("t_first_token")
        if t_enq is not None and t_fin is not None:
            args = {k: rec[k] for k in ("queue_s", "ttft_s", "tpot_s",
                                        "e2e_s", "reason") if k in rec}
            out.append({"ph": "X", "pid": pid, "tid": 0,
                        "name": "request",
                        "cat": rec.get("status") or "request",
                        "ts": us(t_enq),
                        "dur": round((t_fin - t_enq) * 1e6, 3),
                        "args": args})
        if t_enq is not None and t_adm is not None:
            out.append({"ph": "X", "pid": pid, "tid": 0, "name": "queue",
                        "cat": "queue", "ts": us(t_enq),
                        "dur": round((t_adm - t_enq) * 1e6, 3)})
        if t_tok is not None:
            out.append({"ph": "I", "pid": pid, "tid": 0,
                        "name": "first_token", "s": "t",
                        "ts": us(t_tok)})
        for ev in rec.get("events") or []:
            name, a, b = ev[0], ev[1], ev[2]
            out.append({"ph": "X", "pid": pid, "tid": 1, "name": name,
                        "cat": "engine", "ts": us(a),
                        "dur": round((b - a) * 1e6, 3)})
    return {"traceEvents": out, "displayTimeUnit": "ms"}


class TraceBuffer:
    """See module docstring. `capacity` bounds retained traces;
    `slow_quantile` sets the always-keep latency bar (0.9 = slowest
    decile). Thread-safe: the engine adds from its serving thread while
    the telemetry server snapshots from request-handler threads."""

    def __init__(self, capacity: int = 256, *, slow_quantile: float = 0.9,
                 hist_lo: float = 1e-4, hist_hi: float = 1e3,
                 per_decade: int = 20):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if not (0.0 < slow_quantile < 1.0):
            raise ValueError(f"slow_quantile must be in (0, 1), "
                             f"got {slow_quantile}")
        self.capacity = int(capacity)
        self.slow_quantile = float(slow_quantile)
        self._hist = LogHistogram(lo=hist_lo, hi=hist_hi,
                                  per_decade=per_decade)
        self._entries: List[dict] = []          # insertion-ordered
        self._seq = 0
        self.seen = 0
        self.evicted = 0
        self._lock = threading.Lock()

    # ---------------------------------------------------------- admission
    def add(self, record: dict):
        """Admit one terminal request record. Classification happens here
        (tail sampling: the outcome is known), eviction keeps the bound."""
        status = record.get("status")
        e2e = record.get("e2e_s")
        with self._lock:
            self.seen += 1
            self._seq += 1
            slow = False
            if status == "done" and e2e is not None:
                # the bar BEFORE this observation joins the stream: the
                # first request is never "slow relative to itself"
                bar = self._hist.percentile(self.slow_quantile) \
                    if self._hist.count else None
                self._hist.observe(max(float(e2e), 0.0))
                slow = bar is not None and e2e >= bar
            entry = {"seq": self._seq, "slow": slow, "record": record}
            self._entries.append(entry)
            while len(self._entries) > self.capacity:
                self._evict_one()
        return self

    def _evict_one(self):
        """Oldest fast success first, then oldest slow success, then —
        only when everything retained is a failure — the oldest entry."""
        victim = None
        for e in self._entries:                 # oldest-first scan
            st = e["record"].get("status")
            if st == "done" and not e["slow"]:
                victim = e
                break
        if victim is None:
            for e in self._entries:
                if e["record"].get("status") == "done":
                    victim = e
                    break
        if victim is None:
            victim = self._entries[0]
        self._entries.remove(victim)
        self.evicted += 1

    # ---------------------------------------------------------- reporting
    def snapshot(self, *, limit: Optional[int] = None,
                 status: Optional[str] = None,
                 order: str = "recent") -> List[dict]:
        """Retained records, newest first (`order="recent"`) or slowest
        first (`order="slowest"` — the p99 post-mortem view); `status`
        filters on the record's terminal status."""
        if order not in ("recent", "slowest"):
            raise ValueError(f"order must be 'recent' or 'slowest', "
                             f"got {order!r}")
        with self._lock:
            entries = list(self._entries)
        if status is not None:
            entries = [e for e in entries
                       if e["record"].get("status") == status]
        if order == "slowest":
            entries.sort(key=lambda e: (
                -(e["record"].get("e2e_s") or 0.0), -e["seq"]))
        else:
            entries.sort(key=lambda e: -e["seq"])
        if limit is not None:
            entries = entries[:max(int(limit), 0)]
        return [dict(e["record"], _slow=e["slow"]) for e in entries]

    def summary(self) -> dict:
        with self._lock:
            by_status: dict = {}
            slow = 0
            for e in self._entries:
                st = e["record"].get("status") or "unknown"
                by_status[st] = by_status.get(st, 0) + 1
                slow += 1 if e["slow"] else 0
            return {"capacity": self.capacity,
                    "retained": len(self._entries),
                    "retained_slow": slow,
                    "by_status": by_status,
                    "seen": self.seen, "evicted": self.evicted,
                    "slow_quantile": self.slow_quantile,
                    "slow_bar_s": self._hist.percentile(
                        self.slow_quantile)}

    def clear(self):
        with self._lock:
            self._entries.clear()
        return self
