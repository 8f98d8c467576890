"""Declarative SLOs over the serving histograms (the port of
paddle_tpu/obs/slo.py; stdlib only), evaluated as MULTI-WINDOW BURN
RATES — the alerting math of the SRE workbook, computed purely from the
log-bucket histograms the serving layer already keeps.

An SLO target like ``ttft_p99=0.5`` reads "99% of requests get their
first token within 0.5 s". Its error budget is 1%; the BURN RATE over a
window is (fraction of bad requests in the window) / budget — burn 1.0
spends the budget exactly at the objective's horizon, burn 14.4 spends a
30-day budget in 2 days. An alert fires only when BOTH the long and the
short window burn above the threshold: the long window proves the breach
is sustained (no paging on one slow request), the short window proves it
is STILL happening (no paging an hour after recovery).

Windowing over cumulative histograms: `SLOMonitor.poll()` snapshots each
target's (bad, total) counts; window deltas come from differencing the
newest snapshot against the one at/before the window's left edge. No
per-request retention — memory is O(snapshots within the long window).

Bad-count resolution is bucket-granular: a threshold inside a populated
bucket counts that bucket's observations as GOOD (the bucket's upper
bound is the effective threshold — relative slack bounded by the bucket
ratio, ~26% at the default 10/decade). Pin thresholds to bucket bounds
(or raise per_decade) where that slack matters.

Targets (`parse_slo` grammar, comma-separated ``key=value``):
  ``ttft_pNN`` / ``tpot_pNN`` / ``e2e_pNN`` / ``queue_pNN`` = latency
  bound in seconds (``500ms`` / ``2s`` suffixes accepted);
  ``goodput`` = completion-ratio floor in [0, 1): budget = 1 - floor,
  bad = terminal requests that did NOT complete (rejected / timeout /
  error) — the serving-side goodput.

Alerts are STRUCTURED events through the metrics emission path (the
per-request JSONL stream / on_record hook): one ``{"slo_alert": ...}``
row on the transition into breach, one ``{"slo_clear": ...}`` row on
recovery — never a log-spam row per poll.
"""
from __future__ import annotations

import re
import threading
import time
from bisect import bisect_left
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

from ..profiler._metrics import (LogHistogram, counter_lines, format_value,
                                 gauge_lines)

__all__ = ["SLOTarget", "SLOMonitor", "parse_slo", "evaluate_slo",
           "format_slo_table"]

_HISTS = {"ttft": "ttft_seconds", "tpot": "tpot_seconds",
          "e2e": "e2e_seconds", "queue": "queue_seconds"}
_KEY_RE = re.compile(r"^(ttft|tpot|e2e|queue)_p(\d{1,2}(?:\.\d+)?)$")


@dataclass(frozen=True)
class SLOTarget:
    """One declarative objective. `hist` is None for the goodput floor."""
    name: str                   # "ttft_p99" | "goodput"
    objective: float            # fraction of requests that must be good
    hist: Optional[str] = None  # ServingMetrics histogram name
    threshold_s: Optional[float] = None   # latency bound (hist targets)

    @property
    def budget(self) -> float:
        return 1.0 - self.objective

    def describe(self) -> str:
        if self.hist is None:
            return f"goodput >= {self.objective:g}"
        return (f"{self.objective:.4g} of requests "
                f"{self.hist} <= {self.threshold_s:g}s")


def _parse_seconds(text: str) -> float:
    text = text.strip()
    if text.endswith("ms"):
        return float(text[:-2]) / 1e3
    if text.endswith("s"):
        return float(text[:-1])
    return float(text)


def parse_slo(spec: str) -> List[SLOTarget]:
    """``"ttft_p99=500ms,e2e_p99=2s,goodput=0.95"`` -> targets."""
    targets: List[SLOTarget] = []
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        if "=" not in item:
            raise ValueError(f"SLO item {item!r} is not key=value")
        key, _, val = item.partition("=")
        key = key.strip()
        if key == "goodput":
            floor = float(val)
            if not (0.0 <= floor < 1.0):
                raise ValueError(f"goodput floor must be in [0, 1), "
                                 f"got {floor}")
            targets.append(SLOTarget("goodput", objective=floor))
            continue
        m = _KEY_RE.match(key)
        if not m:
            raise ValueError(
                f"unknown SLO key {key!r}: expected goodput or one of "
                f"{'/'.join(_HISTS)}_pNN")
        q = float(m.group(2)) / 100.0
        if not (0.0 < q < 1.0):
            raise ValueError(f"percentile out of range in {key!r}")
        targets.append(SLOTarget(key, objective=q,
                                 hist=_HISTS[m.group(1)],
                                 threshold_s=_parse_seconds(val)))
    if not targets:
        raise ValueError(f"no SLO targets in {spec!r}")
    return targets


def _hist_good_count(hist: LogHistogram, threshold: float) -> int:
    """Observations <= threshold, at bucket granularity: the bucket
    CONTAINING the threshold counts good — its upper bound is the
    effective threshold (module docstring). Anything less would flag
    requests BELOW the target as violations (100 requests at 450ms
    against a 500ms target must burn zero budget, whatever bucket
    boundary 500ms falls inside). The +Inf overflow bucket is the one
    exception: it has no upper bound to stand in for the threshold, so
    it always counts bad."""
    k = bisect_left(hist.bounds, threshold)
    return sum(hist.counts[:min(k + 1, len(hist.bounds))])


def _target_counts(target: SLOTarget, metrics) -> Tuple[int, int]:
    """(bad, total) for one target from a ServingMetrics instance."""
    if target.hist is None:
        total = metrics.counters["requests"]
        return total - metrics.counters["completed"], total
    h = metrics.hists[target.hist]
    return h.count - _hist_good_count(h, target.threshold_s), h.count


def evaluate_slo(targets: List[SLOTarget], metrics) -> List[dict]:
    """Whole-history evaluation (a benchmark's pass/fail gate): burn over
    everything the metrics saw. `ok` iff burn <= 1.0 — i.e. the run as a
    whole met the objective."""
    rows = []
    for t in targets:
        bad, total = _target_counts(t, metrics)
        frac = bad / total if total else 0.0
        burn = frac / t.budget if t.budget > 0 else (
            0.0 if bad == 0 else float("inf"))
        rows.append({"target": t.name, "objective": t.describe(),
                     "total": total, "bad": bad,
                     "bad_fraction": round(frac, 6),
                     "attainment": round(1.0 - frac, 6),
                     "burn": round(burn, 4), "ok": burn <= 1.0})
    return rows


def format_slo_table(rows: List[dict], *, title: str = "SLO") -> str:
    lines = [f"---- {title} burn rates ----",
             f"  {'target':<12} {'total':>7} {'bad':>6} {'attain':>8} "
             f"{'burn':>8}  verdict"]
    for r in rows:
        lines.append(
            f"  {r['target']:<12} {r['total']:>7} {r['bad']:>6} "
            f"{r['attainment'] * 100:>7.2f}% {r['burn']:>8.2f}  "
            f"{'ok' if r['ok'] else 'BREACH'} ({r['objective']})")
    return "\n".join(lines)


class SLOMonitor:
    """Multi-window burn-rate evaluation over a live ServingMetrics.

    `poll()` at any cadence (the telemetry server's scrape, the engine
    loop, a timer thread): each call snapshots the targets' cumulative
    (bad, total) counts, evaluates both windows and manages the per-
    target breach state machine. `clock` is injectable — tests drive the
    windows deterministically.

    Defaults are the SRE-workbook page pair: long 1h / short 5m at burn
    14.4 (a 30-day budget gone in 2 days). For CI-scale runs pass small
    windows and burn_threshold ~1.
    """

    def __init__(self, targets, metrics, *,
                 long_s: float = 3600.0, short_s: float = 300.0,
                 burn_threshold: float = 14.4,
                 clock: Callable[[], float] = time.monotonic,
                 on_alert: Optional[Callable[[dict], None]] = None):
        if isinstance(targets, str):
            targets = parse_slo(targets)
        self.targets = list(targets)
        if not self.targets:
            raise ValueError("SLOMonitor needs at least one target")
        if not (0 < short_s <= long_s):
            raise ValueError(f"need 0 < short_s <= long_s, "
                             f"got {short_s}, {long_s}")
        self.metrics = metrics
        self.long_s = float(long_s)
        self.short_s = float(short_s)
        self.burn_threshold = float(burn_threshold)
        self.clock = clock
        self.on_alert = on_alert
        # snapshots: (t, {target_name: (bad, total)}) — pruned past the
        # long window (one extra kept as the left-edge anchor)
        self._snaps: List[Tuple[float, dict]] = []
        self._breaching = {t.name: False for t in self.targets}
        self.alerts: List[dict] = []            # alert AND clear events
        self.alerts_total = 0
        self._last_eval: List[dict] = []
        # the class docstring invites poll() from the telemetry server's
        # scrape path — a ThreadingHTTPServer runs handlers on multiple
        # threads, so the snapshot deque and the breach state machine
        # are serialized here (same contract as obs.TraceBuffer); alert
        # sinks fire OUTSIDE the lock so a slow JSONL write or hook
        # cannot stall a concurrent scrape
        self._lock = threading.Lock()

    # ------------------------------------------------------------ windows
    def _window_burn(self, name: str, budget: float, now: float,
                     window: float) -> Optional[float]:
        """Burn over [now - window, now] from snapshot deltas; None when
        the window saw no traffic."""
        newest = self._snaps[-1][1][name]
        edge = now - window
        anchor = None
        for t, counts in self._snaps:           # oldest -> newest
            if t <= edge:
                anchor = counts[name]
            else:
                break
        if anchor is None:
            # window predates history: burn over everything we have —
            # a monitor younger than its window alerts on its whole life
            anchor = self._snaps[0][1][name]
        dbad = newest[0] - anchor[0]
        dtotal = newest[1] - anchor[1]
        if dtotal <= 0:
            return None
        frac = dbad / dtotal
        if budget <= 0:
            return 0.0 if dbad == 0 else float("inf")
        return frac / budget

    def poll(self, now: Optional[float] = None) -> List[dict]:
        """Snapshot + evaluate; returns per-target window figures. Fires
        the structured alert/clear events on breach transitions."""
        now = self.clock() if now is None else float(now)
        counts = {t.name: _target_counts(t, self.metrics)
                  for t in self.targets}
        events: List[dict] = []
        with self._lock:
            if self._snaps and now < self._snaps[-1][0]:
                raise ValueError(f"poll time went backwards "
                                 f"({now} < {self._snaps[-1][0]})")
            self._snaps.append((now, counts))
            # prune: keep one snapshot at/before the long window's edge
            edge = now - self.long_s
            while len(self._snaps) >= 2 and self._snaps[1][0] <= edge:
                self._snaps.pop(0)
            out = []
            for t in self.targets:
                b_long = self._window_burn(t.name, t.budget, now,
                                           self.long_s)
                b_short = self._window_burn(t.name, t.budget, now,
                                            self.short_s)
                breach = (b_long is not None and b_short is not None
                          and b_long >= self.burn_threshold
                          and b_short >= self.burn_threshold)
                row = {"target": t.name, "objective": t.describe(),
                       "burn_long": b_long, "burn_short": b_short,
                       "window_long_s": self.long_s,
                       "window_short_s": self.short_s,
                       "threshold": self.burn_threshold,
                       "breaching": breach}
                out.append(row)
                if breach != self._breaching[t.name]:
                    self._breaching[t.name] = breach
                    kind = "slo_alert" if breach else "slo_clear"
                    event = {kind: dict(row), "ts": time.time()}
                    if breach:
                        self.alerts_total += 1
                    self.alerts.append(event)
                    events.append(event)
            self._last_eval = out
        for event in events:
            emit = getattr(self.metrics, "_emit", None)
            if emit is not None:
                emit(event)
            if self.on_alert is not None:
                self.on_alert(event)
        return out

    @property
    def breaching(self) -> bool:
        with self._lock:
            return any(self._breaching.values())

    # ---------------------------------------------------------- reporting
    def summary(self) -> dict:
        with self._lock:
            return {"targets": [t.name for t in self.targets],
                    "breaching": sorted(k for k, v in
                                        self._breaching.items() if v),
                    "alerts_total": self.alerts_total,
                    "last_eval": list(self._last_eval)}

    def metrics_text(self, prefix: str = "paddle_tpu_slo") -> str:
        """Burn gauges (labeled per target+window) + the alert counter,
        via the shared renderer — registry-composable like every other
        block."""
        with self._lock:
            last_eval = list(self._last_eval)
        lines: List[str] = []
        full = f"{prefix}_burn_rate" if prefix else "burn_rate"
        lines += [f"# HELP {full} SLO error-budget burn rate by target "
                  f"and window",
                  f"# TYPE {full} gauge"]
        for row in last_eval:
            for win, key in (("long", "burn_long"), ("short",
                                                     "burn_short")):
                v = row[key]
                if v is None:
                    continue
                v = v if v in (float("inf"),) else round(v, 6)
                lines.append(f'{full}{{target="{row["target"]}",'
                             f'window="{win}"}} {format_value(v)}')
        lines += gauge_lines(prefix, "breaching",
                             1 if self.breaching else 0,
                             "any SLO target currently in multi-window "
                             "breach")
        lines += counter_lines(prefix, "alerts_total", self.alerts_total,
                               "SLO burn-rate alerts fired (breach "
                               "transitions)")
        return "\n".join(lines) + "\n"

    def table(self) -> str:
        with self._lock:
            last_eval = list(self._last_eval)
        lines = [f"---- SLO burn (long {self.long_s:g}s / short "
                 f"{self.short_s:g}s, threshold "
                 f"{self.burn_threshold:g}) ----"]
        for row in last_eval:
            def fmt(v):
                return "n/a" if v is None else f"{v:8.2f}"
            lines.append(
                f"  {row['target']:<12} long {fmt(row['burn_long'])}  "
                f"short {fmt(row['burn_short'])}  "
                f"{'BREACH' if row['breaching'] else 'ok'} "
                f"({row['objective']})")
        return "\n".join(lines)
