"""Goodput timeline — wall-clock attribution spans for one training job
(the port of paddle_tpu/profiler/timeline.py; host-only, the same segment
files).

The observability stack can say how fast a step is (StepMonitor), whether
its numerics are healthy (debugging) and what a request experienced
(serving traces) — this module answers the remaining question: where did
the JOB's wall-clock go? Every second of a run is attributed to one
category of a FIXED taxonomy (CATEGORIES below): productive step compute
is goodput, everything else — compile, input stalls, blocking checkpoint
work, restart downtime, replayed steps — is badput, and whatever no span
claims is idle. `profiler.goodput.GoodputReport` aggregates the spans
into goodput% + a per-category badput breakdown and enforces the
conservation property (categorized + idle ≡ wall within ε).

Design:

  - `SpanRecorder` is thread-safe and monotonic-clock based: span
    endpoints come from ``time.monotonic()`` relative to the recorder's
    birth, so NTP jumps can't corrupt durations. Each segment file
    additionally records its birth ``time.time()`` anchor, which is how
    segments from DIFFERENT processes (a job that died and restarted)
    stitch onto one absolute timeline.
  - Spans are ring-buffered in memory (`capacity` newest kept for live
    reporting) and appended to a JSONL segment file (one open file
    handle, one flushed line per span — the same one-row-per-event
    convention as StepMonitor's JSONL stream). A SIGKILL mid-run loses
    nothing already flushed; the stitcher tolerates a missing exit stamp.
  - `mark_exit(reason=...)` stamps the segment's end — the preemption
    handler calls it so the gap to the next segment's first span is
    attributable as `restart_downtime`.
  - Instrumented seams (jit.TrainStep here; the JAX package's data
    loader, checkpoint manager and elastic fleet too) find the recorder via
    the module-global `current()` (set with `install()` /
    `installed()`), or via an explicit `timeline=` handle. When no
    recorder is installed the per-step cost is one attribute read.

Recorder overhead is part of the contract: one `record()` is a lock, a
deque append and one buffered JSONL line — tests assert the per-span
cost stays under 1% of the CPU toy's median step wall.
"""
from __future__ import annotations

import contextlib
import glob as _glob
import json
import os
import threading
import time
import uuid
from collections import deque
from typing import Any, Dict, List, Optional

# The fixed badput taxonomy. `step` is the goodput category; a stitched
# report recategorizes post-restart re-runs of already-seen steps as
# `replay`. Everything else is badput by definition; un-spanned wall time
# is `idle` (computed, never recorded).
CATEGORIES = ("compile", "input_wait", "step", "ckpt_blocking",
              "ckpt_drain", "restart_downtime", "replay", "eval", "other")
GOODPUT_CATEGORY = "step"

SEGMENT_SUFFIX = ".timeline.jsonl"


class Span:
    """One attributed interval. `t0`/`t1` are seconds relative to the
    owning segment's monotonic birth; `abs0`/`abs1` (epoch seconds) exist
    once the segment anchor is applied (load_segments / live recorder)."""

    __slots__ = ("cat", "t0", "t1", "step", "steps", "meta", "abs0", "abs1")

    def __init__(self, cat: str, t0: float, t1: float,
                 step: Optional[int] = None, steps: int = 1,
                 meta: Optional[dict] = None,
                 abs0: Optional[float] = None, abs1: Optional[float] = None):
        self.cat = cat
        self.t0 = t0
        self.t1 = t1
        self.step = step
        self.steps = steps
        self.meta = meta
        self.abs0 = abs0
        self.abs1 = abs1

    @property
    def dur(self) -> float:
        return self.t1 - self.t0

    def to_row(self) -> dict:
        row: Dict[str, Any] = {"cat": self.cat,
                               "t0": round(self.t0, 6),
                               "t1": round(self.t1, 6)}
        if self.step is not None:
            row["step"] = self.step
        if self.steps != 1:
            row["steps"] = self.steps
        if self.meta:
            row["meta"] = self.meta
        return row

    def __repr__(self):
        s = f" step={self.step}" if self.step is not None else ""
        return f"Span({self.cat}, {self.t0:.4f}..{self.t1:.4f}{s})"


class SpanRecorder:
    """Record attribution spans for ONE process segment of a job.

        rec = SpanRecorder("run/seg.timeline.jsonl", meta={"job": "gpt"})
        with rec.span("step", step=12):
            train_step(batch)
        rec.mark_exit(reason="preemption")
        rec.close()

    `path=None` keeps spans in memory only (tests / ad-hoc use).
    `now()` is the recorder's clock — instrumentation that measures a
    wait itself passes explicit `record(cat, t0, t1)` endpoints from it.
    """

    def __init__(self, path: Optional[str] = None, *,
                 capacity: int = 65536, meta: Optional[dict] = None,
                 start_step: Optional[int] = None, flush_every: int = 64):
        self.path = path
        self.segment_id = uuid.uuid4().hex[:12]
        self.wall0 = time.time()
        self._mono0 = time.monotonic()
        self.meta = dict(meta or {})
        self.start_step = start_step
        self._spans: deque = deque(maxlen=int(capacity))
        self._lock = threading.Lock()
        self._f = None
        self._exit: Optional[dict] = None
        self.dropped = 0          # spans evicted from the ring (file keeps all)
        # flush cadence: fsync-less flush per line costs ~50µs — most of
        # a record() — so rows flush every `flush_every` spans plus on
        # mark_exit/close. A real SIGKILL can lose the unflushed tail
        # (it delivers no exit stamp either); the stitcher then measures
        # downtime from the last flushed span — a slight overestimate,
        # on the side that makes badput look worse, never better.
        self._flush_every = max(1, int(flush_every))
        self._unflushed = 0
        # pre-first-span init accounting: install()
        # stamps an anchor; the first record() materializes the
        # install->first-span gap as an `other` span when it is big
        # enough to matter — the report's wall starts at its first span,
        # so un-anchored build/init time would be silently excluded
        self._init_anchor: Optional[float] = None
        self.init_gap_min_s = 0.02
        if path is not None:
            d = os.path.dirname(os.path.abspath(path))
            os.makedirs(d, exist_ok=True)
            self._f = open(path, "a")
            self._write_row({"segment": {
                "id": self.segment_id, "pid": os.getpid(),
                "wall0": self.wall0,
                "start_step": start_step, "meta": self.meta}},
                flush=True)

    # ------------------------------------------------------------- clock
    def now(self) -> float:
        """Seconds since this recorder's birth (monotonic)."""
        return time.monotonic() - self._mono0

    def anchor_init(self):
        """Called by install(): remember 'now' so the wall between
        install and the first recorded span becomes a visible
        `other`-category init span instead of leaking out of the
        goodput ledger. A no-op once spans exist (re-installs of a
        seasoned recorder must not fabricate init time)."""
        with self._lock:
            if not self._spans and self._init_anchor is None:
                self._init_anchor = self.now()

    def _write_row(self, row: dict, flush: bool = False):
        if self._f is None:
            return
        self._f.write(json.dumps(row) + "\n")
        self._unflushed += 1
        if flush or self._unflushed >= self._flush_every:
            self._f.flush()
            self._unflushed = 0

    # ------------------------------------------------------------ record
    def record(self, cat: str, t0: float, t1: float, *,
               step: Optional[int] = None, steps: int = 1,
               **meta) -> Span:
        """Attribute [t0, t1) (recorder-relative seconds, from `now()`)
        to `cat`. Categories are CLOSED — an unknown one raises, because
        a typo'd category would silently leak time out of the
        conservation ledger."""
        if cat not in CATEGORIES:
            raise ValueError(
                f"unknown timeline category {cat!r}; the taxonomy is "
                f"fixed: {CATEGORIES}")
        sp = Span(cat, float(t0), float(t1), step=step, steps=int(steps),
                  meta=meta or None,
                  abs0=self.wall0 + t0, abs1=self.wall0 + t1)
        with self._lock:
            anchor, self._init_anchor = self._init_anchor, None
            if anchor is not None and not self._spans \
                    and t0 - anchor >= self.init_gap_min_s:
                # materialize the install->first-span gap (see
                # anchor_init); sub-threshold gaps stay implicit so fast
                # installs keep recording exactly what they recorded
                isp = Span("other", anchor, float(t0),
                           meta={"init": True},
                           abs0=self.wall0 + anchor,
                           abs1=self.wall0 + t0)
                self._spans.append(isp)
                self._write_row(isp.to_row())
            if len(self._spans) == self._spans.maxlen:
                self.dropped += 1
            self._spans.append(sp)
            if self._f is not None:
                if meta:
                    self._write_row(sp.to_row())
                else:
                    # hot path: hand-format the row — json.dumps costs
                    # ~a third of a record() and plain rows need none
                    # of it (cat is vetted above, the rest is numeric)
                    line = f'{{"cat":"{cat}","t0":{sp.t0:.6f},' \
                           f'"t1":{sp.t1:.6f}'
                    if step is not None:
                        line += f',"step":{int(step)}'
                    if sp.steps != 1:
                        line += f',"steps":{sp.steps}'
                    self._f.write(line + "}\n")
                    self._unflushed += 1
                    if self._unflushed >= self._flush_every:
                        self._f.flush()
                        self._unflushed = 0
        return sp

    @contextlib.contextmanager
    def span(self, cat: str, *, step: Optional[int] = None,
             steps: int = 1, **meta):
        """Context-manager form of record(): times the body."""
        t0 = self.now()
        try:
            yield self
        finally:
            self.record(cat, t0, self.now(), step=step, steps=steps, **meta)

    def mark_exit(self, reason: Optional[str] = None, *,
                  step: Optional[int] = None, **meta):
        """Stamp the segment's end — the restart-downtime anchor. The
        preemption handler calls this right before raising Preempted;
        chaos tools call it where the simulated SIGKILL landed.
        Idempotent (the first stamp wins: a poll-retry after a failed
        emergency save must not move the recorded death time)."""
        with self._lock:
            if self._exit is not None:
                return
            self._exit = {"t": self.now(), "reason": reason, "step": step,
                          **({"meta": meta} if meta else {})}
            self._write_row({"exit": self._exit}, flush=True)

    # ------------------------------------------------------------- views
    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    @property
    def exit_info(self) -> Optional[dict]:
        return self._exit

    def flush(self):
        with self._lock:
            if self._f is not None:
                self._f.flush()
                self._unflushed = 0

    def close(self):
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


# ------------------------------------------------- module-global recorder

_current: Optional[SpanRecorder] = None
_current_lock = threading.Lock()


def current() -> Optional[SpanRecorder]:
    """The installed recorder (None when goodput accounting is off).
    Instrumented seams call this on their hot path — it is one module
    attribute read."""
    return _current


def install(rec: Optional[SpanRecorder]) -> Optional[SpanRecorder]:
    """Install `rec` as the process-wide recorder; returns the previous
    one (restore it when done — or use `installed()`). Installing a
    fresh recorder anchors its init accounting: wall spent between here
    and its first span lands as an `other` init span (anchor_init)."""
    global _current
    with _current_lock:
        prev, _current = _current, rec
    if rec is not None:
        try:
            rec.anchor_init()
        except AttributeError:
            pass                    # duck-typed recorder without anchors
    return prev


@contextlib.contextmanager
def installed(rec: SpanRecorder):
    prev = install(rec)
    try:
        yield rec
    finally:
        install(prev)


# ------------------------------------------------------ segment loading

class Segment:
    """One loaded segment file: absolute-time spans + the exit stamp."""

    def __init__(self, *, segment_id: str, wall0: float,
                 spans: List[Span], exit_row: Optional[dict] = None,
                 meta: Optional[dict] = None, path: Optional[str] = None,
                 start_step: Optional[int] = None):
        self.segment_id = segment_id
        self.wall0 = wall0
        self.spans = spans
        self.exit_row = exit_row
        self.meta = meta or {}
        self.path = path
        self.start_step = start_step

    @property
    def start(self) -> Optional[float]:
        """Absolute start: first span start (spans are append-ordered but
        not guaranteed sorted — threads interleave)."""
        return min((s.abs0 for s in self.spans), default=None)

    @property
    def end(self) -> Optional[float]:
        """Absolute end: last span end, or the exit stamp if later (a
        segment that died while blocked recorded no span for the tail)."""
        end = max((s.abs1 for s in self.spans), default=None)
        if self.exit_row is not None:
            ex = self.wall0 + self.exit_row["t"]
            end = ex if end is None else max(end, ex)
        return end

    @property
    def max_step(self) -> Optional[int]:
        return max((s.step for s in self.spans if s.step is not None),
                   default=None)


def from_recorder(rec: SpanRecorder) -> Segment:
    """Segment view of a LIVE recorder (ring only — prefer files for
    full-fidelity reports)."""
    return Segment(segment_id=rec.segment_id, wall0=rec.wall0,
                   spans=rec.spans(), exit_row=rec.exit_info,
                   meta=rec.meta, start_step=rec.start_step)


def _load_one(path: str) -> List[Segment]:
    """Parse one JSONL file. A file normally holds one segment, but an
    append-reused path (a restarted process writing to the same file)
    holds several — each `segment` header starts a new one."""
    segs: List[Segment] = []
    cur: Optional[Segment] = None
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                row = json.loads(line)
            except json.JSONDecodeError:
                continue          # torn tail line from a kill mid-write
            if "segment" in row:
                hdr = row["segment"]
                cur = Segment(segment_id=hdr.get("id", "?"),
                              wall0=float(hdr.get("wall0", 0.0)),
                              spans=[], meta=hdr.get("meta"),
                              path=path,
                              start_step=hdr.get("start_step"))
                segs.append(cur)
                continue
            if cur is None:       # header lost: synthesize an anchor
                cur = Segment(segment_id="?", wall0=0.0, spans=[],
                              path=path)
                segs.append(cur)
            if "exit" in row:
                cur.exit_row = row["exit"]
                continue
            if "cat" not in row:
                continue
            sp = Span(row["cat"], float(row["t0"]), float(row["t1"]),
                      step=row.get("step"), steps=int(row.get("steps", 1)),
                      meta=row.get("meta"))
            sp.abs0 = cur.wall0 + sp.t0
            sp.abs1 = cur.wall0 + sp.t1
            cur.spans.append(sp)
    return segs


def load_segments(paths) -> List[Segment]:
    """Load segments from files, directories (all `*.timeline.jsonl`
    under them) or glob patterns; returns them sorted by absolute start
    time — the stitch order GoodputReport consumes."""
    if isinstance(paths, (str, os.PathLike)):
        paths = [paths]
    files: List[str] = []
    for p in paths:
        p = os.fspath(p)
        if os.path.isdir(p):
            files.extend(sorted(_glob.glob(
                os.path.join(p, "**", "*" + SEGMENT_SUFFIX),
                recursive=True)))
        elif os.path.exists(p):
            files.append(p)
        else:
            hits = sorted(_glob.glob(p))
            if not hits:
                raise FileNotFoundError(f"no timeline segments match {p!r}")
            files.extend(hits)
    segs: List[Segment] = []
    for f in files:
        segs.extend(_load_one(f))
    segs = [s for s in segs if s.spans or s.exit_row is not None]
    segs.sort(key=lambda s: (s.start if s.start is not None
                             else s.wall0 + (s.exit_row or {}).get("t", 0)))
    return segs
