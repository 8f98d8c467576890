"""GoodputReport — aggregate a job's timeline spans into goodput% and a
per-category badput breakdown, with a conservation guarantee (the port of
paddle_tpu/profiler/goodput.py; host-only).

Definitions (over one or more stitched `timeline` segments):

  wall        last attributed instant − first attributed instant, across
              ALL segments — restart gaps included (that is the point).
  goodput     time inside `step` spans that were NOT re-runs of already-
              executed steps. goodput% = goodput / wall.
  badput      every other category: `compile`, `input_wait`,
              `ckpt_blocking`, `ckpt_drain`, `restart_downtime`,
              `replay`, `eval`, `other`.
  idle        wall − union(all spans): host time no seam attributed
              (python between-step overhead, un-instrumented work).

Cross-segment attribution (the restart story):

  - `replay`: a `step` span in segment N whose step index was already
    reached by an earlier segment is re-categorized as replay — work the
    job did twice because the checkpoint cadence lagged the kill. The
    replayed-STEP count additionally includes compile-span re-runs (the
    first re-executed step after a restart usually rides a fresh
    compile; its time stays `compile`, its step still counts replayed).
  - `restart_downtime`: the gap between one segment's end (its exit
    stamp, or last span when a SIGKILL outran the stamp) and the next
    segment's first span. Explicit `restart_downtime` spans (recorded by
    the JAX package's `fleet.elastic.run_with_restarts`) take
    precedence; only the uncovered remainder of each gap is derived, so
    supervisor-recorded and stitch-derived downtime never double count.

Conservation: by construction categorized(union) + idle == wall; the
CHECKED property is that the per-category sums tell the same story —
`sum(categories) + idle − wall` equals the spans' mutual overlap, which
must stay under ε (the seams are designed non-overlapping), and idle
must never go negative. `check_conservation()` enforces both;
tests/test_torch_goodput.py asserts it on a TrainStep loop and on
segments stitched across a restart.

Rendering: `table()` is the human attribution table,
`metrics_text()` the Prometheus gauges (shared `_metrics` conventions —
`goodput_ratio`, labeled `badput_seconds{category="..."}`), `summary()`
the JSON-able dict the JAX package's chaos tool and CLI read.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ._metrics import format_value, gauge_lines
from .timeline import (CATEGORIES, GOODPUT_CATEGORY, Segment, Span,
                       SpanRecorder, from_recorder, load_segments)
from .trace_analysis import _overlap_us, _union

BADPUT_CATEGORIES = tuple(c for c in CATEGORIES if c != GOODPUT_CATEGORY)


class ConservationError(AssertionError):
    """The attribution ledger does not balance: spans double-count wall
    time (overlap) beyond ε, or idle went negative."""


def _coerce_segments(source) -> List[Segment]:
    if isinstance(source, SpanRecorder):
        return [from_recorder(source)]
    if isinstance(source, Segment):
        return [source]
    out: List[Segment] = []
    for s in source:
        if isinstance(s, SpanRecorder):
            out.append(from_recorder(s))
        elif isinstance(s, Segment):
            out.append(s)
        else:
            raise TypeError(f"expected Segment/SpanRecorder, got {type(s)}")
    # stitch order is absolute start time (load_segments pre-sorts; live
    # recorders passed by hand may not be)
    out.sort(key=lambda s: s.start if s.start is not None else s.wall0)
    return out


class GoodputReport:
    """See module docstring.

        report = GoodputReport(load_segments(run_dir))
        report.check_conservation()
        print(report.table())
        print(f"goodput {report.goodput_ratio:.1%}")

    `eps`: conservation tolerance in seconds (absolute).
    """

    def __init__(self, segments, *, eps: float = 0.05):
        self.segments = _coerce_segments(segments)
        self.eps = float(eps)
        # one report describes ONE job: stitching unrelated runs (e.g. a
        # chaos --sweep's per-seed subdirs through one CLI call) would
        # recategorize every later run's steps as "replay" of the
        # earlier ones and collapse goodput to garbage. Segments that
        # declare a run identity (meta["run"]) must agree.
        runs = {s.meta.get("run") for s in self.segments
                if s.meta and s.meta.get("run") is not None}
        if len(runs) > 1:
            raise ValueError(
                f"timeline segments belong to {len(runs)} different runs "
                f"({sorted(runs)}): goodput attribution is per-job — "
                f"report each run separately (pass the run's own "
                f"segment files/subdirectory)")
        self.category_s: Dict[str, float] = {c: 0.0 for c in CATEGORIES}
        self.replayed_steps: set = set()
        # restarts = worker segments beyond the first. A supervisor
        # segment (run_with_restarts(timeline=...)) carries ONLY
        # restart_downtime spans and describes the outages, not an extra
        # process incarnation — it must not inflate the count.
        workers = [s for s in self.segments
                   if not (s.spans and all(sp.cat == "restart_downtime"
                                           for sp in s.spans))]
        self.restarts = max(0, len(workers) - 1)
        self.derived_downtime_s = 0.0
        self._stitch()

    # ------------------------------------------------------------ stitch
    def _stitch(self):
        intervals: List[Tuple[float, float]] = []   # every attributed span
        explicit_down: List[Tuple[float, float]] = []
        prev_max_step: Optional[int] = None
        self.spans: List[Tuple[str, Span]] = []     # (final category, span)

        for seg in self.segments:
            seg_max = prev_max_step
            for sp in seg.spans:
                cat = sp.cat
                covered = ()
                if sp.step is not None:
                    covered = range(sp.step - sp.steps + 1, sp.step + 1)
                if prev_max_step is not None and sp.step is not None \
                        and cat in (GOODPUT_CATEGORY, "compile"):
                    replayed = [k for k in covered if k <= prev_max_step]
                    if replayed:
                        self.replayed_steps.update(replayed)
                        # time attribution: a re-run `step` is replay
                        # badput; a re-run under a `compile` span stays
                        # compile (a fresh process pays compile whether
                        # or not the step is a re-run)
                        if cat == GOODPUT_CATEGORY and \
                                len(replayed) == len(covered):
                            cat = "replay"
                self.spans.append((cat, sp))
                self.category_s[cat] += sp.dur
                intervals.append((sp.abs0, sp.abs1))
                if cat == "restart_downtime":
                    explicit_down.append((sp.abs0, sp.abs1))
                if sp.step is not None:
                    m = max(covered)
                    seg_max = m if seg_max is None else max(seg_max, m)
            prev_max_step = seg_max

        # restart gaps: segment end -> next segment start, minus whatever
        # an elastic supervisor already recorded explicitly
        down_u = _union(explicit_down)
        for a, b in zip(self.segments, self.segments[1:]):
            end, start = a.end, b.start
            if end is None or start is None or start <= end:
                continue
            gap = (end, start)
            uncovered = (gap[1] - gap[0]) - _overlap_us(down_u, [gap])
            if uncovered > 0:
                self.category_s["restart_downtime"] += uncovered
                self.derived_downtime_s += uncovered
                intervals.append(gap)

        starts = [s.start for s in self.segments if s.start is not None]
        ends = [s.end for s in self.segments if s.end is not None]
        self.start = min(starts) if starts else None
        self.end = max(ends) if ends else None
        self.wall_s = (self.end - self.start) \
            if self.start is not None and self.end is not None else 0.0
        self.categorized_s = sum(
            e - s for s, e in _union(intervals))
        self.idle_s = self.wall_s - self.categorized_s
        # the conservation residual: what per-category sums over-claim
        # relative to the union — nonzero means spans overlapped
        self.overlap_s = sum(self.category_s.values()) - self.categorized_s

    # ------------------------------------------------------------- sums
    @property
    def goodput_s(self) -> float:
        return self.category_s[GOODPUT_CATEGORY]

    @property
    def badput_s(self) -> float:
        return sum(self.category_s[c] for c in BADPUT_CATEGORIES)

    @property
    def goodput_ratio(self) -> Optional[float]:
        return self.goodput_s / self.wall_s if self.wall_s > 0 else None

    # ----------------------------------------------------- conservation
    def check_conservation(self, eps: Optional[float] = None) -> dict:
        """Enforce the ledger balance (module docstring). Returns the
        balance detail; raises ConservationError when it does not hold
        within ε."""
        eps = self.eps if eps is None else float(eps)
        # the residual of "sum(categories) + idle ≡ wall" IS the spans'
        # mutual overlap (idle is wall − union by construction), so two
        # checks cover the ledger: no double counting, no negative idle
        residual = sum(self.category_s.values()) + self.idle_s - self.wall_s
        detail = {"wall_s": self.wall_s,
                  "categorized_s": self.categorized_s,
                  "idle_s": self.idle_s,
                  "overlap_s": self.overlap_s,
                  "residual_s": residual, "eps": eps}
        if self.overlap_s > eps:
            raise ConservationError(
                f"timeline spans double-count {self.overlap_s:.4f}s of "
                f"wall time (> eps {eps}): instrumented seams must not "
                f"nest — {detail}")
        if self.idle_s < -eps:
            raise ConservationError(
                f"idle went negative ({self.idle_s:.4f}s < -{eps}): span "
                f"endpoints extend past the segment window — {detail}")
        return detail

    # ---------------------------------------------------------- summary
    def summary(self) -> dict:
        return {
            "wall_s": round(self.wall_s, 6),
            "goodput_s": round(self.goodput_s, 6),
            "goodput_ratio": (round(self.goodput_ratio, 6)
                              if self.goodput_ratio is not None else None),
            "idle_s": round(self.idle_s, 6),
            "overlap_s": round(self.overlap_s, 6),
            "badput_s": {c: round(self.category_s[c], 6)
                         for c in BADPUT_CATEGORIES},
            "restarts": self.restarts,
            "replayed_steps": len(self.replayed_steps),
            "derived_downtime_s": round(self.derived_downtime_s, 6),
            "segments": len(self.segments),
            "spans": len(self.spans),
        }

    def table(self) -> str:
        """The human attribution table: one row per category, descending
        by seconds, goodput and idle called out."""
        lines = ["---- Goodput attribution "
                 f"({len(self.segments)} segment"
                 f"{'s' if len(self.segments) != 1 else ''}, "
                 f"{self.restarts} restart"
                 f"{'s' if self.restarts != 1 else ''}) ----",
                 f"{'seconds':>12}  {'% wall':>7}  category"]

        def pct(v):
            return 100.0 * v / self.wall_s if self.wall_s > 0 else 0.0

        rows = [(self.category_s[c], c) for c in CATEGORIES
                if self.category_s[c] > 0]
        rows.append((self.idle_s, "idle"))
        for sec, cat in sorted(rows, reverse=True):
            tag = " (goodput)" if cat == GOODPUT_CATEGORY else ""
            lines.append(f"{sec:12.3f}  {pct(sec):6.1f}%  {cat}{tag}")
        lines.append(f"{self.wall_s:12.3f}  {100.0 if self.wall_s else 0.0:6.1f}%  wall")
        gr = self.goodput_ratio
        lines.append(f"goodput {gr:.1%}" if gr is not None
                     else "goodput n/a (no wall time)")
        if self.replayed_steps:
            lines.append(f"replayed steps: {len(self.replayed_steps)} "
                         f"({min(self.replayed_steps)}.."
                         f"{max(self.replayed_steps)})")
        return "\n".join(lines)

    def metrics_text(self, prefix: str = "paddle_tpu") -> str:
        """Prometheus gauges via the shared profiler._metrics renderer:
        scalar gauges plus ONE labeled `badput_seconds` family (one
        sample per taxonomy category — zero categories included, so a
        dashboard's queries never 404 on a healthy job)."""
        lines: List[str] = []
        lines += gauge_lines(prefix, "goodput_ratio", self.goodput_ratio,
                             "goodput fraction of job wall time")
        lines += gauge_lines(prefix, "goodput_seconds",
                             round(self.goodput_s, 6),
                             "productive step-compute seconds")
        lines += gauge_lines(prefix, "wall_seconds", round(self.wall_s, 6),
                             "attributed job wall time (restart gaps "
                             "included)")
        lines += gauge_lines(prefix, "idle_seconds", round(self.idle_s, 6),
                             "wall time no seam attributed")
        full = f"{prefix}_badput_seconds" if prefix else "badput_seconds"
        lines += [f"# HELP {full} badput seconds by taxonomy category",
                  f"# TYPE {full} gauge"]
        for c in BADPUT_CATEGORIES:
            lines.append(
                f'{full}{{category="{c}"}} '
                f"{format_value(round(self.category_s[c], 6))}")
        lines += gauge_lines(prefix, "restarts_total", self.restarts,
                             "restarts observed in the stitched timeline")
        lines += gauge_lines(prefix, "replayed_steps_total",
                             len(self.replayed_steps),
                             "steps re-executed after restarts")
        return "\n".join(lines) + "\n"


def report_from(paths, *, eps: float = 0.05) -> GoodputReport:
    """GoodputReport straight from segment files/dirs/globs."""
    return GoodputReport(load_segments(paths), eps=eps)
