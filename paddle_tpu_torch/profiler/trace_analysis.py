"""Device-trace analytics over a `torch.profiler` capture (the port of
paddle_tpu/profiler/trace_analysis.py): chrome trace -> op and lane
summary tables.

The reference profiler fuses a host tracer and a CUPTI device tracer into
one event tree and renders op-level summary tables
(profiler_statistic.py). Here the tracer is `torch.profiler` with CUDA
activity (CUPTI through Kineto): `export_chrome_trace` writes the capture
as a chrome `*.trace.json` (`Profiler` and the flight recorder gzip it to
`*.trace.json.gz`). This module parses that file into the same summary
surface as the JAX module:

  - KernelView:      per-op-name device-time totals
  - DeviceView:      per-lane busy time + a fusion/collective/copy/compute
                     category split
  - DistributedView: a per-collective ledger (name, calls, bytes, bus
                     bandwidth, overlapped-vs-exposed time) plus the whole-
                     step compute/communication overlap ratio

Device lanes. The device ops are the capture's GPU events: `cat`
``kernel``, ``gpu_memcpy`` and ``gpu_memset`` (``Kernel`` / ``Memcpy`` /
``Memset`` in older Kineto exports), one lane per (device pid, stream
tid). The host's CUDA API calls (``cuda_runtime`` and the like), its
operators (``cpu_op``), annotations (``user_annotation`` and their GPU
shadows ``gpu_user_annotation``) and flow events are not device ops.
A capture with no GPU event (a CPU-only `torch.profiler` run) falls back
to the host's ``cpu_op`` events, keeping only the innermost operator of
each nest (an operator that contains another on its thread would count
its children's time twice), as the JAX module falls back to the XLA CPU
client's threads; `host_lanes` says which was read.

Categories (`classify_op`): collective — NCCL kernels (``nccl`` in the
name); copy — memcpy / memset and PyTorch's copy kernels
(``copy_kernel``, ``CatArrayBatchedCopy``); fusion — the port's own
hand-written kernels (`PORT_KERNELS`, the `__global__` functions that
`ops.cuda.build.kernel_names` reads from `ops/cuda/csrc/`, matched as
whole identifiers in the demangled or mangled name); compute —
everything else (cuBLAS GEMMs, PyTorch's elementwise and reduction
kernels).

Used by `Profiler.summary(views=...)`, `obs.flightrec.FlightRecorder`'s
/profilez and `StepMonitor.record_overlap`.
"""
from __future__ import annotations

import glob
import gzip
import json
import os
import re
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

from ..ops.cuda.build import kernel_names

# the port's hand-written kernels: every __global__ function under
# ops/cuda/csrc/, read from the sources
PORT_KERNELS = tuple(kernel_names())
# a whole identifier: not inside a longer one (a mangled name puts its
# length digits before it and an upper-case code after it)
_PORT_RE = re.compile(r"(?<![A-Za-z_])(?:" + "|".join(PORT_KERNELS)
                      + r")(?![a-z0-9_])")
_COPY_MARKERS = ("memcpy", "memset", "copy_kernel", "catarraybatchedcopy")
# the GPU activity categories of a Kineto chrome trace (current, older)
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset", "memcpy",
                     "memset")
HOST_OP_CATEGORIES = ("cpu_op", "operator")


def classify_op(name: str) -> str:
    """Category of a device op name: collective|fusion|copy|compute (see
    the module docstring)."""
    low = name.lower()
    if "nccl" in low:
        return "collective"
    if any(m in low for m in _COPY_MARKERS):
        return "copy"
    if _PORT_RE.search(name):
        return "fusion"
    return "compute"


# trace-event arg keys that carry the op's data volume (the JAX module's
# keys; Kineto's kernel events carry none, its memcpy events "bytes");
# take the first present.
_BYTES_ARG_KEYS = ("bytes_accessed", "bytes accessed", "bytes",
                   "size_bytes", "shape_bytes")


def event_bytes(e: dict) -> Optional[int]:
    """Data volume an event's args declare, or None when the capture
    carries no byte stat (the ledger then reports bytes/bandwidth as
    unknown rather than guessing from op names)."""
    args = e.get("args")
    if not isinstance(args, dict):
        return None
    for key in _BYTES_ARG_KEYS:
        v = args.get(key)
        if v is None:
            continue
        try:
            return int(float(v))
        except (TypeError, ValueError):
            continue
    return None


def find_trace_file(path: str) -> Optional[str]:
    """Newest `*.trace.json.gz` (or `.trace.json`) under a file/dir path."""
    if os.path.isfile(path):
        return path
    hits = []
    for pat in ("**/*.trace.json.gz", "**/*.trace.json"):
        hits.extend(glob.glob(os.path.join(path, pat), recursive=True))
    return max(hits, key=os.path.getmtime) if hits else None


def load_events(path: str) -> List[dict]:
    """traceEvents list of a chrome-tracing capture (.json or .json.gz)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    return data.get("traceEvents", [])


def export_capture(prof, dest: str) -> str:
    """Write a stopped `torch.profiler.profile`'s chrome trace to `dest`,
    gzipped (fastest level) when `dest` ends in ``.gz``. Returns dest."""
    import shutil
    import tempfile
    folder = os.path.dirname(os.path.abspath(dest))
    os.makedirs(folder, exist_ok=True)
    if not dest.endswith(".gz"):
        prof.export_chrome_trace(dest)
        return dest
    fd, tmp = tempfile.mkstemp(suffix=".json", dir=folder)
    os.close(fd)
    try:
        prof.export_chrome_trace(tmp)
        with open(tmp, "rb") as f, \
                gzip.open(dest, "wb", compresslevel=1) as g:
            shutil.copyfileobj(f, g, 1 << 20)
    finally:
        os.remove(tmp)
    return dest


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Union of [start, end) intervals, sorted and merged."""
    if not intervals:
        return []
    intervals = sorted(intervals)
    out = [list(intervals[0])]
    for s, e in intervals[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]

def _overlap_us(a: List[Tuple[float, float]],
                b: List[Tuple[float, float]]) -> float:
    """Total length of the intersection of two merged interval lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


# the exposition series of collective_rows(), as the JAX package names them
# (StepMonitor.record_collectives adopts them as gauges); a None getter
# value drops the sample
_COLLECTIVE_SERIES = (
    ("collective_seconds", "device seconds per collective op",
     lambda r: r["dur_us"] / 1e6 if r.get("dur_us") is not None else None),
    ("collective_exposed_seconds", "collective seconds NOT hidden under "
     "compute — the wall the step pays",
     lambda r: r["exposed_us"] / 1e6
     if r.get("exposed_us") is not None else None),
    ("collective_bytes", "bytes moved per collective op",
     lambda r: r.get("bytes")),
    ("collective_bus_gbps", "achieved bus bandwidth per collective op",
     lambda r: r.get("bus_gbps")),
)


def collective_series_lines(rows: List[dict], prefix: str) -> List[str]:
    """Per-op labeled gauge families for a set of collective_rows(), and
    the bytes summed per wire dtype where rows carry one."""
    from ._metrics import labeled_gauge_lines
    lines: List[str] = []
    for name, help_, get in _COLLECTIVE_SERIES:
        lines += labeled_gauge_lines(
            prefix, name, "op", [(r["name"], get(r)) for r in rows],
            help_)
    by_dt: Dict[str, int] = {}
    for r in rows:
        dt, b = r.get("dtype"), r.get("bytes")
        if dt and b is not None:
            by_dt[dt] = by_dt.get(dt, 0) + int(b)
    lines += labeled_gauge_lines(
        prefix, "collective_bytes_by_dtype", "dtype",
        sorted(by_dt.items()),
        "bytes moved per collective wire dtype")
    return lines


def format_collective_rows(rows: List[dict],
                           steps: Optional[int] = None,
                           top: int = 20) -> List[str]:
    """Render collective_rows() as table lines (DistributedView's; the
    JAX package's collective ledger prints the same rows through it).
    Header + one line per op; the caller adds its own title and
    totals/overlap footer. None columns print as '-'."""
    div = max(steps or 1, 1)
    unit = "ms/step" if steps else "ms"
    lines = [f"{unit:>10}  {'exposed':>9}  {'hidden%':>7}  {'calls':>6}  "
             f"{'MB':>9}  {'GB/s':>7}  {'dtype':>6}  op"]
    for r in rows[:top]:
        mb = f"{r['bytes'] / 1e6:9.2f}" if r["bytes"] is not None \
            else f"{'-':>9}"
        bus = f"{r['bus_gbps']:7.1f}" if r["bus_gbps"] is not None \
            else f"{'-':>7}"
        dur = f"{r['dur_us'] / div / 1e3:10.3f}" \
            if r["dur_us"] is not None else f"{'-':>10}"
        exp = f"{r['exposed_us'] / div / 1e3:9.3f}" \
            if r["exposed_us"] is not None else f"{'-':>9}"
        hidden = f"{(1.0 - r['exposed_frac']) * 100.0:7.1f}" \
            if r["exposed_frac"] is not None else f"{'-':>7}"
        # a wire dtype only static inventories carry; trace rows print '-'
        dt = f"{(r.get('dtype') or '-')[:6]:>6}"
        lines.append(f"{dur}  {exp}  {hidden}  {r['calls']:6d}  "
                     f"{mb}  {bus}  {dt}  {r['name'][:70]}")
    return lines


def _innermost(events: List[dict]) -> List[dict]:
    """The events of each (pid, tid) lane that contain no other event of
    that lane: a host operator nests its callees (aten::linear holds
    aten::addmm), and only the innermost carry time once."""
    lanes = defaultdict(list)
    for e in events:
        lanes[(e.get("pid"), e.get("tid"))].append(e)
    out = []
    for lane in lanes.values():
        # by start, the longer first: a parent precedes its children
        lane.sort(key=lambda e: (e["ts"], -e["dur"]))
        for i, e in enumerate(lane):
            end = e["ts"] + e["dur"]
            nxt = lane[i + 1] if i + 1 < len(lane) else None
            if nxt is None or nxt["ts"] >= end:
                out.append(e)
    out.sort(key=lambda e: e["ts"])
    return out


class TraceAnalysis:
    """Parsed device lanes of one captured trace.

    `steps` (optional) divides totals into per-step figures — the caller
    knows how many training steps ran inside the capture. `window=(lo, hi)`
    keeps only events whose start falls into that fraction of the capture
    span (steady-window trimming: drop warmup/drain at the edges).
    """

    def __init__(self, events: Iterable[dict], steps: Optional[int] = None,
                 window: Tuple[float, float] = (0.0, 1.0)):
        events = list(events)   # two passes below; a generator would drain
        self.steps = steps
        self.pid_name: Dict[int, str] = {}
        self.tid_name: Dict[Tuple[int, int], str] = {}
        for e in events:
            if e.get("ph") == "M":
                if e.get("name") == "process_name":
                    self.pid_name[e.get("pid")] = e.get("args", {}).get("name", "")
                elif e.get("name") == "thread_name":
                    self.tid_name[(e.get("pid"), e.get("tid"))] = \
                        e.get("args", {}).get("name", "")

        def complete(e, cats):
            return (e.get("ph") == "X" and "dur" in e
                    and str(e.get("cat", "")).lower() in cats)

        raw = [e for e in events if complete(e, DEVICE_CATEGORIES)]
        self.host_lanes = False
        if not raw:
            raw = _innermost([e for e in events
                              if complete(e, HOST_OP_CATEGORIES)])
            self.host_lanes = bool(raw)
        if raw and window != (0.0, 1.0):
            t0 = min(e["ts"] for e in raw)
            t1 = max(e["ts"] + e["dur"] for e in raw)
            span = max(t1 - t0, 1e-9)
            lo, hi = t0 + window[0] * span, t0 + window[1] * span
            raw = [e for e in raw if lo <= e["ts"] <= hi]
        self.device_events = raw

    # ---------------------------------------------------------------- ops
    def op_totals(self) -> List[dict]:
        """Per-op-name rows sorted by total device time (descending)."""
        agg = defaultdict(lambda: {"dur_us": 0.0, "calls": 0})
        for e in self.device_events:
            a = agg[e["name"]]
            a["dur_us"] += e["dur"]
            a["calls"] += 1
        total = sum(a["dur_us"] for a in agg.values()) or 1.0
        rows = [{"name": n, "dur_us": a["dur_us"], "calls": a["calls"],
                 "pct": 100.0 * a["dur_us"] / total,
                 "category": classify_op(n)}
                for n, a in agg.items()]
        rows.sort(key=lambda r: -r["dur_us"])
        return rows

    def total_device_us(self) -> float:
        return sum(e["dur"] for e in self.device_events)

    def category_totals(self) -> Dict[str, float]:
        out = defaultdict(float)
        for e in self.device_events:
            out[classify_op(e["name"])] += e["dur"]
        return dict(out)

    # ------------------------------------------------------------- lanes
    def lane_busy(self) -> List[dict]:
        """Per device lane: merged busy time (overlap-free) and op count."""
        lanes = defaultdict(list)
        for e in self.device_events:
            lanes[(e.get("pid"), e.get("tid"))].append(
                (e["ts"], e["ts"] + e["dur"]))
        rows = []
        for (pid, tid), iv in sorted(lanes.items()):
            merged = _union(iv)
            busy = sum(e - s for s, e in merged)
            name = self.pid_name.get(pid, f"pid{pid}")
            tname = self.tid_name.get((pid, tid), "")
            rows.append({"lane": f"{name}/{tname}" if tname else name,
                         "busy_us": busy, "ops": len(iv)})
        return rows

    # --------------------------------------------------------- distributed
    def collective_rows(self) -> List[dict]:
        """The per-collective ledger: one row per collective op name.

        Each row decomposes that collective's device time against the
        union of ALL non-collective device compute:

          dur_us         summed durations of the op's events
          busy_us        overlap-free union span of the op's events (the
                         denominator for exposure — back-to-back async
                         chunks must not double-count)
          overlapped_us  busy time with compute running concurrently
          exposed_us     busy - overlapped: wall time the step PAYS for
                         this collective (the number scheduling work must
                         drive to zero)
          bytes          data volume from the capture's byte stats (None
                         when the capture carries none)
          bus_gbps       bytes / busy_us — achieved bus bandwidth (None
                         without bytes)

        Sorted by exposed_us descending: the top row is the collective to
        attack first. sum(overlapped_us)/sum(busy_us) over the rows equals
        overlap()'s whole-step ratio up to interval-union bookkeeping, so
        the ledger IS the decomposition of the overlap_ratio gauge."""
        comp: List[Tuple[float, float]] = []
        groups: Dict[str, dict] = {}
        for e in self.device_events:
            iv = (e["ts"], e["ts"] + e["dur"])
            if classify_op(e["name"]) != "collective":
                comp.append(iv)
                continue
            g = groups.setdefault(e["name"],
                                  {"intervals": [], "dur_us": 0.0,
                                   "calls": 0, "bytes": None})
            g["intervals"].append(iv)
            g["dur_us"] += e["dur"]
            g["calls"] += 1
            b = event_bytes(e)
            if b is not None:
                g["bytes"] = (g["bytes"] or 0) + b
        comp_u = _union(comp)
        rows = []
        for name, g in groups.items():
            iv_u = _union(g["intervals"])
            busy = sum(e - s for s, e in iv_u)
            ovl = _overlap_us(iv_u, comp_u)
            exposed = max(busy - ovl, 0.0)
            nbytes = g["bytes"]
            bus = None
            if nbytes is not None and busy > 0:
                bus = nbytes / (busy * 1e-6) / 1e9     # bytes/s -> GB/s
            rows.append({"name": name, "calls": g["calls"],
                         "dur_us": g["dur_us"], "busy_us": busy,
                         "overlapped_us": ovl, "exposed_us": exposed,
                         "exposed_frac": exposed / busy if busy else 0.0,
                         "bytes": nbytes,
                         "bus_gbps": bus,
                         # a wire dtype: traces do not carry one
                         "dtype": None})
        rows.sort(key=lambda r: (-r["exposed_us"], -r["busy_us"]))
        return rows

    def overlap(self) -> dict:
        """Compute/communication overlap over the device lanes.

        collective_us:   union span of collective ops
        compute_busy_us: union span of non-collective device ops
        overlapped_us:   collective time with compute running concurrently
        ratio:           overlapped / collective (1.0 = fully hidden)
        """
        coll, comp = [], []
        for e in self.device_events:
            iv = (e["ts"], e["ts"] + e["dur"])
            (coll if classify_op(e["name"]) == "collective" else comp).append(iv)
        coll_u, comp_u = _union(coll), _union(comp)
        coll_us = sum(e - s for s, e in coll_u)
        comp_us = sum(e - s for s, e in comp_u)
        ovl = _overlap_us(coll_u, comp_u)
        return {"collective_us": coll_us, "compute_busy_us": comp_us,
                "overlapped_us": ovl,
                "ratio": (ovl / coll_us) if coll_us > 0 else None}

    # -------------------------------------------------------------- views
    def _per_step(self, us: float) -> float:
        return us / (self.steps or 1)

    def kernel_view(self, top: int = 45) -> str:
        """Per-op device-time table (reference KernelView)."""
        rows = self.op_totals()
        n = self.steps
        hdr = (f"{'ms/step' if n else 'ms':>10}  {'%':>5}  {'calls':>6}  "
               f"{'category':<10}  op")
        lines = ["---- KernelView (device op time"
                 + (f", {n} steps" if n else "") + ") ----", hdr]
        for r in rows[:top]:
            lines.append(f"{self._per_step(r['dur_us']) / 1e3:10.3f}  "
                         f"{r['pct']:5.1f}  {r['calls']:6d}  "
                         f"{r['category']:<10}  {r['name'][:100]}")
        tot = self.total_device_us()
        lines.append(f"{'total':>10}  {self._per_step(tot) / 1e3:.3f} ms"
                     + (f"/step over {n} steps" if n else ""))
        return "\n".join(lines)

    def device_view(self) -> str:
        """Per-lane busy time + category split (reference DeviceView)."""
        lines = ["---- DeviceView (device lanes) ----",
                 f"{'busy ms':>10}  {'ops':>7}  lane"]
        for r in self.lane_busy():
            lines.append(f"{self._per_step(r['busy_us']) / 1e3:10.3f}  "
                         f"{r['ops']:7d}  {r['lane'][:90]}")
        cats = self.category_totals()
        total = sum(cats.values()) or 1.0
        lines.append("category split: " + ", ".join(
            f"{k} {v / total * 100:.1f}%" for k, v in
            sorted(cats.items(), key=lambda kv: -kv[1])))
        return "\n".join(lines)

    def distributed_view(self, top: int = 20) -> str:
        """Per-collective ledger + overlap ratio (reference
        DistributedView). Columns: total device ms, EXPOSED ms (the part
        compute does not hide — the actionable number), bytes moved and
        achieved bus bandwidth where the capture carries byte stats."""
        rows = self.collective_rows()
        lines = ["---- DistributedView (collective ledger) ----"]
        if not rows:
            lines.append("no collective ops in capture (single-chip step)")
        else:
            lines += format_collective_rows(rows, steps=self.steps,
                                            top=top)
        ov = self.overlap()
        if ov["ratio"] is not None:
            lines.append(
                f"collective {self._per_step(ov['collective_us']) / 1e3:.3f} ms"
                f", overlapped with compute "
                f"{self._per_step(ov['overlapped_us']) / 1e3:.3f} ms "
                f"(overlap ratio {ov['ratio']:.2f})")
        return "\n".join(lines)


def analyze(path_or_events, steps: Optional[int] = None,
            window: Tuple[float, float] = (0.0, 1.0)) -> TraceAnalysis:
    """TraceAnalysis from a trace file, a directory of captures (newest
    wins), or an already-loaded traceEvents list."""
    if isinstance(path_or_events, str):
        f = find_trace_file(path_or_events)
        if f is None:
            raise FileNotFoundError(
                f"no *.trace.json[.gz] under {path_or_events!r} — was the "
                "device trace captured? (Profiler(timer_only=True) and "
                "a tracer that failed to start skip it)")
        events = load_events(f)
    else:
        events = list(path_or_events)
    return TraceAnalysis(events, steps=steps, window=window)


# ------------------------------------------------- kernel-level diffing
# given two captures, name the kernels that got slower

def kernel_diff(base: "TraceAnalysis", cand: "TraceAnalysis") -> dict:
    """Kernel-granularity regression attribution between two captures.

    Per op name (union of both captures): per-step device time in each
    (`a_us`/`b_us` — the `steps` each analysis was built with normalizes
    unequal capture lengths), the absolute and relative delta, the op's
    occupancy of its step (`a_pct`/`b_pct`: share of total device time)
    and a status — `common`, `new` (only in the candidate) or `vanished`
    (only in the baseline). Collectives additionally diff their EXPOSED
    time (the wall the step pays). Rows sort by |delta| descending: the
    top row is where the regression lives."""
    rows_a = {r["name"]: r for r in base.op_totals()}
    rows_b = {r["name"]: r for r in cand.op_totals()}
    div_a = max(base.steps or 1, 1)
    div_b = max(cand.steps or 1, 1)
    kernels = []
    for name in set(rows_a) | set(rows_b):
        ra, rb = rows_a.get(name), rows_b.get(name)
        a_us = ra["dur_us"] / div_a if ra else 0.0
        b_us = rb["dur_us"] / div_b if rb else 0.0
        kernels.append({
            "name": name, "category": (rb or ra)["category"],
            "status": ("common" if ra and rb
                       else ("new" if rb else "vanished")),
            "a_us": a_us, "b_us": b_us,
            "a_calls": ra["calls"] if ra else 0,
            "b_calls": rb["calls"] if rb else 0,
            "delta_us": b_us - a_us,
            "delta_pct": ((b_us - a_us) / a_us * 100.0
                          if a_us > 0 else None),
            "a_pct": ra["pct"] if ra else 0.0,
            "b_pct": rb["pct"] if rb else 0.0})
    kernels.sort(key=lambda r: (-abs(r["delta_us"]), r["name"]))
    total_a = base.total_device_us() / div_a
    total_b = cand.total_device_us() / div_b
    coll_a = {r["name"]: r for r in base.collective_rows()}
    coll_b = {r["name"]: r for r in cand.collective_rows()}
    collectives = []
    for name in set(coll_a) | set(coll_b):
        ea = coll_a[name]["exposed_us"] / div_a if name in coll_a else 0.0
        eb = coll_b[name]["exposed_us"] / div_b if name in coll_b else 0.0
        collectives.append({
            "name": name,
            "a_exposed_us": ea, "b_exposed_us": eb,
            "delta_us": eb - ea,
            "delta_pct": ((eb - ea) / ea * 100.0 if ea > 0 else None)})
    collectives.sort(key=lambda r: (-abs(r["delta_us"]), r["name"]))
    return {"kernels": kernels, "collectives": collectives,
            "total": {"a_us": total_a, "b_us": total_b,
                      "delta_us": total_b - total_a,
                      "delta_pct": ((total_b - total_a) / total_a * 100.0
                                    if total_a > 0 else None)}}


def diff_regressions(diff: dict, *, regress_pct: float,
                     min_us: float = 50.0) -> List[dict]:
    """The kernels a --regress-pct gate fails on: common kernels whose
    per-step time grew STRICTLY more than `regress_pct` percent, and new
    kernels that appeared at all — both above the `min_us` noise floor
    (per-step device time; sub-floor ops jitter across captures). A
    capture diffed against itself regresses nothing at any threshold."""
    out = []
    for r in diff["kernels"]:
        if r["status"] == "new":
            if r["b_us"] >= min_us:
                out.append(dict(r, reason="new kernel"))
        elif r["status"] == "common":
            if (r["delta_pct"] is not None
                    and r["delta_pct"] > regress_pct
                    and r["delta_us"] >= min_us):
                out.append(dict(r, reason=(
                    f"+{r['delta_pct']:.1f}% "
                    f"(+{r['delta_us'] / 1e3:.3f} ms)")))
    return out


def format_kernel_diff(diff: dict, top: int = 30) -> str:
    """Human table over kernel_diff()'s rows (perf_diff's stdout)."""
    lines = ["---- KernelDiff (per-step device time, baseline -> "
             "candidate) ----",
             f"{'base ms':>10}  {'cand ms':>10}  {'delta ms':>10}  "
             f"{'delta%':>8}  {'occ%':>11}  op"]
    for r in diff["kernels"][:top]:
        dp = f"{r['delta_pct']:8.1f}" if r["delta_pct"] is not None \
            else f"{r['status']:>8}"
        occ = f"{r['a_pct']:5.1f}>{r['b_pct']:5.1f}"
        lines.append(f"{r['a_us'] / 1e3:10.3f}  {r['b_us'] / 1e3:10.3f}  "
                     f"{r['delta_us'] / 1e3:10.3f}  {dp}  {occ}  "
                     f"{r['name'][:70]}")
    t = diff["total"]
    tp = f"{t['delta_pct']:+.1f}%" if t["delta_pct"] is not None else "-"
    lines.append(f"total: {t['a_us'] / 1e3:.3f} -> {t['b_us'] / 1e3:.3f} "
                 f"ms/step ({tp})")
    if diff["collectives"]:
        lines.append("collective exposed-time deltas:")
        for r in diff["collectives"]:
            dp = f"{r['delta_pct']:+.1f}%" if r["delta_pct"] is not None \
                else "new"
            lines.append(f"  {r['a_exposed_us'] / 1e3:10.3f}  "
                         f"{r['b_exposed_us'] / 1e3:10.3f}  {dp:>8}  "
                         f"{r['name'][:70]}")
    return "\n".join(lines)


def summarize(path: str, views=None, steps: Optional[int] = None) -> str:
    """Render the requested views (names or SummaryView members) from the
    newest capture under `path`."""
    an = analyze(path, steps=steps)
    parts = []
    for v in views or ("kernel",):
        name = getattr(v, "name", str(v)).lower()
        if "kernel" in name or "operator" in name:
            parts.append(an.kernel_view())
        elif "device" in name:
            parts.append(an.device_view())
        elif "dist" in name:
            parts.append(an.distributed_view())
        else:
            parts.append(f"(view {name!r} has no device-trace table)")
    return "\n\n".join(parts)
