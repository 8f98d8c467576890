"""MetricsRegistry — one collision-checked Prometheus page per process
(the port of paddle_tpu/obs/registry.py; stdlib only).

Every exposition producer in the package renders its own block through
the shared `profiler._metrics` formatter (`ServingMetrics.metrics_text`,
`StepMonitor.metrics_text`, `GoodputReport.metrics_text`, the obs SLO
monitor). Until now composing them was caller-side string concatenation
— which silently breaks the moment two blocks emit the same metric
family (Prometheus drops or double-counts, depending on the scraper).
The registry is the composition point the telemetry server scrapes:

    reg = MetricsRegistry()
    reg.register("serving", engine.metrics.metrics_text)
    reg.register("goodput", report.metrics_text)
    page = reg.render()        # collision-checked, lint-clean, or raises

`render()` parses every producer's block (`_metrics.parse_exposition`),
REJECTS any metric family emitted by two producers (naming both), and
lints the merged page with the promtool-style checks below — so a bad
producer fails the scrape loudly instead of poisoning dashboards.

`lint_exposition(text)` is the pure-python promtool stand-in the tests
and the CI smoke leg run over endpoint payloads: structural invariants
from the parser plus per-type rules (counters end in `_total`, histogram
buckets cumulative with ascending `le` and `+Inf == _count`).
"""
from __future__ import annotations

from typing import Callable, Dict, List

from ..profiler._metrics import ExpositionError, parse_exposition

__all__ = ["ExpositionError", "MetricsCollisionError", "MetricsRegistry",
           "lint_exposition"]


class MetricsCollisionError(ExpositionError):
    """Two registered producers emit the same metric family."""


def lint_exposition(text: str) -> dict:
    """Validate one exposition page; returns the parsed family dict.

    Checks (on top of `parse_exposition`'s structural grammar):
      - counter family names end in ``_total`` (the package convention —
        a counter that does not say so gets graphed as a gauge),
      - histogram families carry ``_sum`` and ``_count`` samples,
        bucket ``le`` bounds strictly ascend, bucket counts are
        cumulative (non-decreasing), the last bucket is ``+Inf`` and its
        count equals ``_count``.
    """
    families = parse_exposition(text)
    for name, fam in families.items():
        kind = fam["type"]
        if kind == "counter" and not name.endswith("_total"):
            raise ExpositionError(
                f"counter family {name} does not end in _total")
        if kind != "histogram":
            continue
        buckets: List[tuple] = []
        count = None
        has_sum = False
        for base, labels, value in fam["samples"]:
            if base == f"{name}_bucket":
                le = labels[1:-1].split("=", 1)[1].strip('"')
                buckets.append((le, float(value)))
            elif base == f"{name}_count":
                count = float(value)
            elif base == f"{name}_sum":
                has_sum = True
        if not buckets or count is None or not has_sum:
            raise ExpositionError(
                f"histogram {name} is missing bucket/_sum/_count samples")
        if buckets[-1][0] != "+Inf":
            raise ExpositionError(
                f"histogram {name}: last bucket must be le=\"+Inf\"")
        les = [float(le) for le, _ in buckets[:-1]]
        if any(b <= a for a, b in zip(les, les[1:])):
            raise ExpositionError(
                f"histogram {name}: le bounds must strictly ascend")
        counts = [c for _, c in buckets]
        if any(b < a for a, b in zip(counts, counts[1:])):
            raise ExpositionError(
                f"histogram {name}: bucket counts must be cumulative")
        if buckets[-1][1] != count:
            raise ExpositionError(
                f"histogram {name}: +Inf bucket ({buckets[-1][1]:.0f}) "
                f"!= _count ({count:.0f})")
    return families


class MetricsRegistry:
    """Named exposition producers -> one checked `/metrics` page.

    A producer is a zero-argument callable returning exposition text
    (typically a bound ``metrics_text``/``functools.partial`` carrying
    its prefix). Blocks render in registration order. The registry holds
    no metric state of its own — every ``render()`` re-invokes the
    producers, so the page is always live.

    Thread-safety: register/unregister and render take a snapshot of the
    producer dict under the GIL; producers themselves read host-side
    counters/gauges (plain dict reads), which is the same guarantee the
    JSONL/on_record paths already rely on.
    """

    def __init__(self):
        self._producers: Dict[str, Callable[[], str]] = {}

    def register(self, name: str, producer: Callable[[], str]):
        if not callable(producer):
            raise TypeError(f"producer for {name!r} must be a "
                            f"zero-argument callable returning exposition "
                            f"text; got {producer!r}")
        if name in self._producers:
            raise ValueError(f"producer {name!r} already registered "
                             f"(unregister it first)")
        self._producers[name] = producer
        return self

    def unregister(self, name: str) -> bool:
        return self._producers.pop(name, None) is not None

    @property
    def producers(self) -> List[str]:
        return list(self._producers)

    def render(self, *, validate: bool = True) -> str:
        """The merged page. Collision-checks family names across
        producers always; ``validate=True`` additionally lints every
        block (cheap: one regex pass per line at scrape rate)."""
        owners: Dict[str, str] = {}
        blocks: List[str] = []
        for name, producer in list(self._producers.items()):
            block = producer()
            if not block or not block.strip():
                continue
            fams = lint_exposition(block) if validate \
                else parse_exposition(block)
            for fam in fams:
                prev = owners.get(fam)
                if prev is not None:
                    raise MetricsCollisionError(
                        f"metric family {fam} emitted by both "
                        f"{prev!r} and {name!r} — give one producer a "
                        f"distinct prefix")
                owners[fam] = name
            blocks.append(block if block.endswith("\n") else block + "\n")
        return "".join(blocks)
