"""paddle_tpu_torch.profiler — the paddle.profiler API over
`torch.profiler` (the port of paddle_tpu/profiler/__init__.py), plus the
step telemetry of the port.

The reference composes a host tracer and a CUPTI device tracer into an
event tree exported as chrome tracing (platform/profiler/profiler.h:47,
chrometracing_logger.cc), driven from python by paddle.profiler.Profiler
with a step scheduler (profiler/profiler.py:344, make_scheduler:117).
Here the tracer is `torch.profiler.profile` with CPU activity and, on a
card, CUDA activity (CUPTI through Kineto); `RecordEvent` and
`annotate_layers` open `torch.profiler.record_function` scopes, so user
annotations appear in the same capture. Step scheduling, the state machine
(CLOSED/READY/RECORD/RECORD_AND_RETURN), `on_trace_ready` callbacks and
the summary surface keep the reference semantics; each RECORD window's
capture is written to `trace_dir` as a gzipped chrome trace, and
`summary(views=...)` parses the newest one through `trace_analysis`.

Also here: `StepMonitor` (per-step telemetry), `timeline.SpanRecorder`
(goodput spans) and `goodput.GoodputReport`, and the Prometheus
exposition primitives (`_metrics`).
"""
from __future__ import annotations

import contextlib
import enum
import json
import os
import time
from collections import defaultdict
from typing import Callable, Iterable, Optional


class ProfilerTarget(enum.Enum):
    CPU = 0
    GPU = 1
    CUSTOM_DEVICE = 2
    TPU = 3      # accepted for API parity with the JAX package


class ProfilerState(enum.Enum):
    """reference: profiler/profiler.py ProfilerState."""
    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3


def make_scheduler(*, closed: int, ready: int, record: int, repeat: int = 0,
                   skip_first: int = 0) -> Callable[[int], ProfilerState]:
    """reference: profiler/profiler.py:117 make_scheduler — cycle through
    CLOSED*closed → READY*ready → RECORD*record, repeated `repeat` times."""
    period = closed + ready + record

    def scheduler(step: int) -> ProfilerState:
        if step < skip_first:
            return ProfilerState.CLOSED
        s = step - skip_first
        if repeat > 0 and s >= repeat * period:
            return ProfilerState.CLOSED
        pos = s % period
        if pos < closed:
            return ProfilerState.CLOSED
        if pos < closed + ready:
            return ProfilerState.READY
        if pos == period - 1:
            return ProfilerState.RECORD_AND_RETURN
        return ProfilerState.RECORD
    return scheduler


def _default_scheduler(step: int) -> ProfilerState:
    return ProfilerState.RECORD


def export_chrome_tracing(dir_name: str, worker_name: str = None) -> Callable:
    """reference: profiler/profiler.py:215 — an on_trace_ready callback
    writing the window's capture as chrome tracing JSON into `dir_name`:
    the `torch.profiler` trace (host ops, annotations and the card's
    kernels), or with `timer_only` the host RecordEvents alone."""

    def handler(prof: "Profiler"):
        os.makedirs(dir_name, exist_ok=True)
        name = worker_name or f"host_{os.getpid()}"
        path = os.path.join(dir_name,
                            f"{name}_{time.time_ns()}.pt.trace.json")
        src = prof._last_capture
        if src is not None and os.path.exists(src):
            from .trace_analysis import load_events
            events = load_events(src)
        else:
            events = [{
                "name": e["name"], "ph": "X", "pid": os.getpid(), "tid": 0,
                "ts": e["start"] * 1e6, "dur": (e["end"] - e["start"]) * 1e6,
                "cat": "host",
            } for e in prof._host_events]
        with open(path, "w") as f:
            json.dump({"traceEvents": events}, f)
        prof._last_export = path
    return handler


def export_protobuf(dir_name: str, worker_name: str = None) -> Callable:
    return export_chrome_tracing(dir_name, worker_name)


class RecordEvent:
    """User-scope annotation (reference: paddle.profiler.RecordEvent). A
    `torch.profiler.record_function` scope, so it shows in the capture,
    and an entry of the host-side event list for summary()."""

    def __init__(self, name: str, event_type=None):
        self.name = name
        self._ann = None
        self._start = None

    def begin(self):
        import torch
        self._ann = torch.profiler.record_function(self.name)
        self._ann.__enter__()
        self._start = time.perf_counter()
        return self

    def end(self):
        if self._ann is not None:
            self._ann.__exit__(None, None, None)
            self._ann = None
        if self._start is not None and _active_profiler is not None \
                and _active_profiler._recording:
            _active_profiler._host_events.append({
                "name": self.name, "start": self._start,
                "end": time.perf_counter()})
        self._start = None

    def __enter__(self):
        return self.begin()

    def __exit__(self, *exc):
        self.end()
        return False


_active_profiler: Optional["Profiler"] = None


class Profiler:
    """reference: paddle.profiler.Profiler (profiler/profiler.py:344).

    Each RECORD window runs one `torch.profiler.profile` (CPU activity,
    and CUDA activity when a card is present; `record_shapes` and
    `profile_memory` pass through) and, when the window closes, writes
    its chrome trace to `trace_dir` as ``host_<pid>_<n>.pt.trace.json.gz``
    (`last_capture`). The closing step waits for the card first, so the
    capture holds the window's kernels. `timer_only` records host events
    and step times without the tracer."""

    def __init__(self, *, targets: Iterable[ProfilerTarget] = None,
                 scheduler=None, on_trace_ready: Callable = None,
                 timer_only: bool = False, record_shapes: bool = False,
                 profile_memory: bool = False, trace_dir: str = None):
        self.targets = list(targets) if targets else [ProfilerTarget.GPU]
        if scheduler is None:
            self._scheduler = _default_scheduler
        elif callable(scheduler):
            self._scheduler = scheduler
        else:  # (start, end) tuple form
            lo, hi = scheduler
            self._scheduler = make_scheduler(closed=lo, ready=0, record=hi - lo,
                                             repeat=1)
        self.on_trace_ready = on_trace_ready
        self.timer_only = timer_only
        self.record_shapes = record_shapes
        self.profile_memory = profile_memory
        self._trace_dir = trace_dir or "./profiler_log"
        self.step_num = 0
        self._state = ProfilerState.CLOSED
        self._recording = False
        self._tracer = None          # the running torch.profiler.profile
        # the last closed window's torch.profiler.profile (its
        # key_averages() stay readable)
        self.last_tracer = None
        self._captures = 0
        self._host_events = []
        self._step_times = []
        self._recorded_steps = 0
        self._step_t0 = None
        self._last_capture = None
        self._last_export = None

    @property
    def last_capture(self) -> Optional[str]:
        """The newest capture's trace file (None before one closed)."""
        return self._last_capture

    # -- lifecycle ------------------------------------------------------
    def start(self):
        global _active_profiler
        _active_profiler = self
        self._state = self._scheduler(self.step_num)
        self._apply_state()
        self._step_t0 = time.perf_counter()
        return self

    def stop(self):
        global _active_profiler
        self._stop_tracer()
        if self._recording and self.on_trace_ready:
            self.on_trace_ready(self)
        self._recording = False
        self._state = ProfilerState.CLOSED
        _active_profiler = None

    def step(self, num_steps: int = 1):
        now = time.perf_counter()
        if self._step_t0 is not None:
            self._step_times.append(now - self._step_t0)
        if self._recording:
            # the step just closed ran under RECORD — these are the steps
            # inside the capture (summary's per-step denominator)
            self._recorded_steps += num_steps
        self._step_t0 = now
        self.step_num += num_steps
        new_state = self._scheduler(self.step_num)
        if new_state != self._state:
            if self._state == ProfilerState.RECORD_AND_RETURN and self.on_trace_ready:
                # the handler reads the closed window's capture
                self._stop_tracer()
                self.on_trace_ready(self)
            self._state = new_state
            self._apply_state()

    def _apply_state(self):
        want_record = self._state in (ProfilerState.RECORD,
                                      ProfilerState.RECORD_AND_RETURN)
        if want_record and not self._recording:
            self._recording = True
            # new capture window: each RECORD phase writes its own trace
            # and summary(views=) parses only the newest, so the
            # per-step denominator restarts with it
            self._recorded_steps = 0
            if not self.timer_only:
                self._start_tracer()
        elif not want_record and self._recording:
            self._recording = False
            self._stop_tracer()

    def _start_tracer(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        tracer = profile(activities=acts, record_shapes=self.record_shapes,
                         profile_memory=self.profile_memory)
        tracer.start()
        self._tracer = tracer

    def _stop_tracer(self):
        tracer, self._tracer = self._tracer, None
        if tracer is None:
            return
        import torch
        from .trace_analysis import export_capture
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        tracer.stop()
        self._captures += 1
        self._last_capture = export_capture(tracer, os.path.join(
            self._trace_dir,
            f"host_{os.getpid()}_{self._captures}.pt.trace.json.gz"))
        self.last_tracer = tracer

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # -- reporting ------------------------------------------------------
    def summary(self, sorted_by=None, op_detail=True, thread_sep=False,
                time_unit="ms", views=None, steps=None) -> str:
        """Summary tables (reference: profiler_statistic.py summaries).

        Default: host-event table. With `views` (SummaryView members or
        names), device tables are parsed from the newest capture under
        `trace_dir` via profiler.trace_analysis — KernelView gives per-op
        device time, DeviceView per-lane busy + category split,
        DistributedView collectives + the compute/comm overlap ratio (a
        CPU-only capture has no GPU lane: the tables read the host's
        operators). `steps` divides device totals into per-step figures
        (defaults to the steps counted while recording)."""
        if views is not None:
            from . import trace_analysis
            want = views if isinstance(views, (list, tuple)) else [views]
            parts = []
            device_views = [v for v in want
                            if getattr(v, "name", str(v)) != "OverView"]
            if any(getattr(v, "name", str(v)) == "OverView" for v in want):
                parts.append(self.summary(time_unit=time_unit))
            if device_views:
                if steps is None and self._recorded_steps:
                    steps = self._recorded_steps
                try:
                    parts.append(trace_analysis.summarize(
                        self._trace_dir, views=device_views, steps=steps))
                except FileNotFoundError as e:
                    parts.append(f"(no device trace: {e})")
            return "\n\n".join(parts)
        unit = {"s": 1.0, "ms": 1e3, "us": 1e6}[time_unit]
        agg = defaultdict(lambda: [0, 0.0])
        for e in self._host_events:
            a = agg[e["name"]]
            a[0] += 1
            a[1] += e["end"] - e["start"]
        lines = [f"{'Event':<40}{'Calls':>8}{'Total(' + time_unit + ')':>16}"
                 f"{'Avg(' + time_unit + ')':>16}"]
        for name, (calls, total) in sorted(agg.items(), key=lambda kv: -kv[1][1]):
            lines.append(f"{name:<40}{calls:>8}{total * unit:>16.3f}"
                         f"{total / calls * unit:>16.3f}")
        if self._step_times:
            tot = sum(self._step_times)
            lines.append(f"{'[steps] ' + str(len(self._step_times)):<40}"
                         f"{len(self._step_times):>8}{tot * unit:>16.3f}"
                         f"{tot / len(self._step_times) * unit:>16.3f}")
        return "\n".join(lines)


@contextlib.contextmanager
def profile(**kwargs):
    p = Profiler(**kwargs)
    p.start()
    try:
        yield p
    finally:
        p.stop()


class SortedKeys(enum.Enum):
    """reference: profiler/profiler_statistic.py SortedKeys — summary sort
    orders."""
    CPUTotal = 0
    CPUAvg = 1
    CPUMax = 2
    CPUMin = 3
    GPUTotal = 4
    GPUAvg = 5
    GPUMax = 6
    GPUMin = 7


class SummaryView(enum.Enum):
    """reference: profiler SummaryView — which table summary() prints."""
    DeviceView = 0
    OverView = 1
    ModelView = 2
    DistributedView = 3
    KernelView = 4
    OperatorView = 5
    MemoryView = 6
    MemoryManipulationView = 7
    UDFView = 8


def load_profiler_result(filename: str):
    """reference: profiler.load_profiler_result — reload an exported trace
    (chrome tracing JSON, gzipped or not)."""
    import gzip
    opener = gzip.open if filename.endswith(".gz") else open
    with opener(filename, "rt") as f:
        return json.load(f)


# -- module-scoped tracing ----------------------------------------------


class _AnnotationHandle:
    """Returned by annotate_layers; .remove() restores original forwards."""

    def __init__(self, entries, paths):
        self._entries = entries
        self.paths = paths

    def remove(self):
        for layer, prev in self._entries:
            if prev is None:
                layer.__dict__.pop("forward", None)
            else:
                layer.__dict__["forward"] = prev
        self._entries = []


def annotate_layers(model, root: str = None) -> _AnnotationHandle:
    """Wrap every submodule's forward in a `torch.profiler.record_function`
    scope named by its qualified layer path (e.g. `GPTForCausalLM/gpt/h/0`)
    so a capture attributes host ops and kernel launches to model modules.

    Returns a handle: `.paths` lists the annotation names, `.remove()`
    restores the original forwards (a scope costs a host call per layer
    per step: remove it outside profiling windows)."""
    import torch
    root = root or type(model).__name__
    entries, paths = [], []
    for name, layer in model.named_modules():
        path = root if not name else f"{root}/{name.replace('.', '/')}"
        prev = layer.__dict__.get("forward")  # instance-level override, if any
        fwd = layer.forward                   # bound method or override
        if getattr(fwd, "_pt_annotation", None):
            continue

        def _make(f, p):
            def annotated_forward(*args, **kwargs):
                with torch.profiler.record_function(p):
                    return f(*args, **kwargs)
            annotated_forward._pt_annotation = p
            return annotated_forward

        layer.__dict__["forward"] = _make(fwd, path)
        entries.append((layer, prev))
        paths.append(path)
    return _AnnotationHandle(entries, paths)


from .monitor import StepMonitor, shape_delta  # noqa: E402,F401
from ._metrics import LogHistogram  # noqa: E402,F401
from . import trace_analysis  # noqa: E402,F401
from . import timeline  # noqa: E402,F401
from . import goodput  # noqa: E402,F401
from .timeline import SpanRecorder  # noqa: E402,F401
from .goodput import GoodputReport  # noqa: E402,F401

__all__ = ["ProfilerTarget", "ProfilerState", "make_scheduler",
           "export_chrome_tracing", "export_protobuf", "RecordEvent",
           "Profiler", "profile", "SortedKeys", "SummaryView",
           "load_profiler_result", "annotate_layers", "StepMonitor",
           "shape_delta", "LogHistogram", "trace_analysis", "timeline",
           "goodput", "SpanRecorder", "GoodputReport"]
