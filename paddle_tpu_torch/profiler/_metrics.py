"""Shared Prometheus-exposition primitives for the observability layer
(the port of paddle_tpu/profiler/_metrics.py; stdlib only).

One renderer serves every `/metrics` surface in the package —
`StepMonitor.metrics_text()` (step gauges) and the serving
layer's `ServingMetrics` (request histograms/gauges/counters) — so the
exposition format cannot drift between them. The format is the Prometheus
text format 0.0.4: `# HELP` + `# TYPE` headers, one sample per line,
histograms as cumulative `_bucket{le="..."}` lines plus `_sum`/`_count`.

`LogHistogram` is the latency aggregate the serving layer records into:
log-spaced buckets (no per-observation retention — a serving process
observes millions of requests), with p50/p90/p99 DERIVED from the bucket
counts by linear interpolation inside the containing bucket. The relative
error of a derived percentile is bounded by the bucket ratio
(10^(1/per_decade) − 1: ~26% at the default 10/decade, ~12% at 20/decade);
the JAX package's tests check the math against numpy on known samples,
and `tests/test_torch_metrics.py` holds this copy to that one.
"""
from __future__ import annotations

import math
import re
from bisect import bisect_left
from typing import Iterable, List, Optional, Sequence


def format_value(v) -> str:
    """One sample value: integers stay integral, floats use repr-shortest."""
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    f = float(v)
    if f != f:
        return "NaN"
    if f in (float("inf"), float("-inf")):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _header(prefix: str, name: str, kind: str, help_: str) -> List[str]:
    full = f"{prefix}_{name}" if prefix else name
    return [f"# HELP {full} {help_}", f"# TYPE {full} {kind}"]


def gauge_lines(prefix: str, name: str, value, help_: str,
                labels: Optional[dict] = None) -> List[str]:
    """Render one gauge (or nothing when value is None)."""
    if value is None:
        return []
    full = f"{prefix}_{name}" if prefix else name
    lab = ""
    if labels:
        lab = "{" + ",".join(f'{k}="{v}"' for k, v in labels.items()) + "}"
    return _header(prefix, name, "gauge", help_) + \
        [f"{full}{lab} {format_value(value)}"]


def labeled_gauge_lines(prefix: str, name: str, label_key: str,
                        samples, help_: str) -> List[str]:
    """Render one gauge family with MULTIPLE labeled samples (gauge_lines
    renders exactly one): `samples` is an iterable of (label_value,
    value) pairs; pairs with a None value are skipped, and a family with
    no surviving samples renders nothing."""
    kept = [(lv, v) for lv, v in samples if v is not None]
    if not kept:
        return []
    full = f"{prefix}_{name}" if prefix else name
    return _header(prefix, name, "gauge", help_) + \
        [f'{full}{{{label_key}="{lv}"}} {format_value(v)}'
         for lv, v in kept]


def counter_lines(prefix: str, name: str, value, help_: str) -> List[str]:
    """Render one counter; by convention `name` should end in `_total`."""
    if value is None:
        return []
    full = f"{prefix}_{name}" if prefix else name
    return _header(prefix, name, "counter", help_) + \
        [f"{full} {format_value(value)}"]


def histogram_lines(prefix: str, name: str, hist: "LogHistogram",
                    help_: str) -> List[str]:
    """Render one histogram: cumulative le-buckets, +Inf, _sum, _count.
    Empty buckets are elided (scrape size), but cumulativity and the
    +Inf == _count invariant hold regardless."""
    full = f"{prefix}_{name}" if prefix else name
    lines = _header(prefix, name, "histogram", help_)
    cum = 0
    for bound, count in zip(hist.bounds, hist.counts):
        cum += count
        if count:
            lines.append(
                f'{full}_bucket{{le="{format_value(bound)}"}} {cum}')
    lines.append(f'{full}_bucket{{le="+Inf"}} {hist.count}')
    lines.append(f"{full}_sum {format_value(hist.sum)}")
    lines.append(f"{full}_count {hist.count}")
    return lines


# ------------------------------------------------------------- parsing

class ExpositionError(ValueError):
    """The text does not conform to the Prometheus exposition format the
    renderers above promise (malformed sample, missing/duplicated HELP or
    TYPE, interleaved families, ...)."""


_SAMPLE_RE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)'            # metric name
    r'(\{[^}]*\})? '                          # optional label set
    r'(-?\d+(\.\d+)?([eE][-+]?\d+)?|[+-]Inf|NaN)$')

_FAMILY_SUFFIX_RE = re.compile(r"_(bucket|sum|count)$")


def parse_exposition(text: str) -> dict:
    """Parse text-format 0.0.4 output from the renderers above into an
    ordered ``{family: {"type", "help", "samples"}}`` dict, enforcing the
    structural invariants a scraper relies on:

      - every sample line matches the sample grammar,
      - every family declares HELP then TYPE, exactly once, BEFORE its
        first sample,
      - a family's lines are contiguous (no interleaving — the producer
        of the merged page must not shuffle blocks line-wise),
      - no duplicate sample (same name + label set).

    Histogram-specific invariants (cumulative buckets, +Inf == _count)
    are the job of `obs.registry.lint_exposition`, which builds on this.
    Raises ExpositionError; an empty/whitespace text parses to {}.
    """
    families: dict = {}
    current: Optional[str] = None
    seen_samples = set()
    for ln, line in enumerate(text.split("\n"), 1):
        if not line.strip():
            continue
        if line.startswith("# HELP ") or line.startswith("# TYPE "):
            parts = line.split(None, 3)
            if len(parts) < 4:
                raise ExpositionError(f"line {ln}: truncated {parts[1]} "
                                      f"line: {line!r}")
            kind, name, rest = parts[1], parts[2], parts[3]
            fam = families.get(name)
            if fam is None:
                if kind == "TYPE":
                    raise ExpositionError(
                        f"line {ln}: TYPE for {name} before its HELP")
                families[name] = {"help": rest, "type": None, "samples": []}
            else:
                if fam["samples"] or (kind == "HELP") \
                        or (kind == "TYPE" and fam["type"] is not None):
                    raise ExpositionError(
                        f"line {ln}: duplicate {kind} for family {name}")
                fam["type"] = rest.strip()
            current = name
            continue
        if line.startswith("#"):
            continue                         # comments are legal noise
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ExpositionError(f"line {ln}: malformed sample: {line!r}")
        base, labels = m.group(1), m.group(2) or ""
        fam_name = base if base in families \
            else _FAMILY_SUFFIX_RE.sub("", base)
        fam = families.get(fam_name)
        if fam is None or fam["type"] is None:
            raise ExpositionError(
                f"line {ln}: sample {base!r} has no preceding HELP/TYPE "
                f"declaration")
        if fam_name != current:
            raise ExpositionError(
                f"line {ln}: family {fam_name} resumed after other "
                f"families — samples must be contiguous per family")
        key = (base, labels)
        if key in seen_samples:
            raise ExpositionError(
                f"line {ln}: duplicate sample {base}{labels}")
        seen_samples.add(key)
        fam["samples"].append((base, labels, m.group(3)))
    for name, fam in families.items():
        if fam["type"] is None:
            raise ExpositionError(f"family {name} has HELP but no TYPE")
    return families


class LogHistogram:
    """Fixed-memory latency histogram with log-spaced buckets.

    Bucket upper bounds are lo·10^(k/per_decade) for k = 0..n (n chosen so
    the last bound covers `hi`), plus an implicit +Inf overflow bucket.
    `observe()` is O(log buckets); percentiles interpolate linearly inside
    the containing bucket and clamp to the observed min/max so the edges
    (p0/p100) are exact.
    """

    def __init__(self, lo: float = 1e-4, hi: float = 1e3,
                 per_decade: int = 10,
                 bounds: Optional[Sequence[float]] = None):
        if bounds is not None:
            self.bounds = [float(b) for b in bounds]
        else:
            if not (0 < lo < hi):
                raise ValueError(f"need 0 < lo < hi, got {lo}, {hi}")
            n = int(math.ceil(per_decade * math.log10(hi / lo))) + 1
            self.bounds = [lo * 10.0 ** (k / per_decade) for k in range(n)]
        self.counts = [0] * (len(self.bounds) + 1)   # last = overflow
        self.count = 0
        self.sum = 0.0
        self._min: Optional[float] = None
        self._max: Optional[float] = None

    def observe(self, v: float):
        v = float(v)
        if v != v:       # refuse NaN loudly: it would poison sum/mean
            raise ValueError("cannot observe NaN")
        self.counts[bisect_left(self.bounds, v)] += 1
        self.count += 1
        self.sum += v
        self._min = v if self._min is None else min(self._min, v)
        self._max = v if self._max is None else max(self._max, v)

    @property
    def mean(self) -> Optional[float]:
        return self.sum / self.count if self.count else None

    def percentile(self, q: float) -> Optional[float]:
        """q in [0, 1]. Derived from buckets — see class docstring for the
        error bound."""
        if not self.count:
            return None
        if not (0.0 <= q <= 1.0):
            raise ValueError(f"q must be in [0, 1], got {q}")
        target = q * self.count
        cum = 0.0
        for i, c in enumerate(self.counts):
            if not c:
                continue
            if cum + c >= target:
                lower = self.bounds[i - 1] if i > 0 else \
                    min(self._min, self.bounds[0])
                upper = self.bounds[i] if i < len(self.bounds) else self._max
                frac = (target - cum) / c
                val = lower + frac * (upper - lower)
                return min(max(val, self._min), self._max)
            cum += c
        return self._max

    def quantiles(self, qs: Iterable[float]) -> dict:
        return {q: self.percentile(q) for q in qs}

    def summary(self) -> dict:
        """The standard percentile triplet + count/mean — what a serving
        report() embeds per latency series."""
        return {"count": self.count,
                "mean": self.mean,
                "p50": self.percentile(0.50),
                "p90": self.percentile(0.90),
                "p99": self.percentile(0.99)}
