"""paddle_tpu_torch.debugging — numerics observability of the port's
training step (the port of paddle_tpu/debugging).

When a 10k-step run NaNs at step 7,312 it tells you which layer, which
quantity, and hands you a replayable dump — without a host sync per step.

Three pieces:

  sentinel  — per-layer tensor stats (finite/nan/inf counts, absmax, mean,
              l2) reduced ON THE DEVICE and stacked once a step into one
              compact [rows, 6] tensor. Install with
              ``check_layer_numerics(model)``; TrainStep(numerics=...) does
              it for you and adds per-layer grad rows + the found-inf
              scalar that `skip_nonfinite_updates` reads.
  anomaly   — host-side detectors over the fetched stream: NaN/Inf naming
              the layer path, grad-norm explosion (rolling z-score), loss
              spike, dead layer. Each fires a structured NumericsEvent.
  dump      — on a firing event, the offending batch + params/opt-state +
              step + dropout generator state + stats tree persist to
              ``dump_dir``; ``replay()`` re-runs the failure.

Typical wiring::

    cfg = debugging.NumericsConfig(every_n_steps=10, dump_dir="dumps/")
    step = TrainStep(model, opt, loss_fn, numerics=cfg)
    ...
    step.numerics_stats()        # on-demand fetch -> StatsTree
    cfg.detector.events          # everything that fired

The legacy surface (paddle.amp.debugging.check_numerics,
TensorCheckerConfig, FLAGS_check_nan_inf) is a facade over this package —
see paddle_tpu_torch/amp/debugging.py.
"""
from __future__ import annotations

from typing import Callable, Optional

from .sentinel import (STAT_NAMES, N_STATS, StatsTree, StatsCollector,
                       array_stats, merge_stat_rows, merge_stacked,
                       collect_stats, active_collector, check_layer_numerics,
                       grad_layer_groups, grad_stat_rows, found_inf,
                       model_param_stats)
from .anomaly import AnomalyDetector, NumericsEvent, write_events_jsonl
from .dump import (write_dump, load_dump, replay, Dump, ReplayResult,
                   tree_spec, tree_build, tree_leaves)

__all__ = [
    "STAT_NAMES", "N_STATS", "StatsTree", "StatsCollector", "array_stats",
    "collect_stats", "active_collector", "check_layer_numerics",
    "found_inf", "model_param_stats", "AnomalyDetector", "NumericsEvent",
    "write_events_jsonl", "write_dump", "load_dump", "replay", "Dump",
    "ReplayResult", "NumericsConfig",
]


class NumericsConfig:
    """Configuration for TrainStep's numerics mode.

    every_n_steps: fetch + detect cadence. 0 = never automatically — stats
        stay on the device and ``TrainStep.numerics_stats()`` fetches on
        demand; the step pays only the device reductions.
    grad_stats: add per-layer gradient rows (and the global grad-norm
        scalar) to the stats tree.
    skip_nonfinite_updates: skip the parameter/optimizer update when the
        found-inf sentinel fires (one scalar read a step) — parameters
        never ingest a NaN, so the dump on disk holds the exact pre-step
        state and the run can continue (GradScaler semantics; the
        reference's check_nan_inf-and-abort is `raise_on_nonfinite`).
    dump_dir: where anomaly dumps land (None = no dumps).
    detector / on_event / monitor: the AnomalyDetector consuming fetches, a
        callback fired per NumericsEvent, and a profiler.StepMonitor that
        records events + loss/grad-norm into its JSONL stream.
    raise_on_nonfinite: raise FloatingPointError on a fetched NaN/Inf event
        (after dumping) — FLAGS_check_nan_inf abort semantics.
    """

    def __init__(self, every_n_steps: int = 0, grad_stats: bool = True,
                 skip_nonfinite_updates: bool = True,
                 dump_dir: Optional[str] = None,
                 detector: Optional[AnomalyDetector] = None,
                 on_event: Optional[Callable[[NumericsEvent], None]] = None,
                 monitor=None, raise_on_nonfinite: bool = False):
        self.every_n_steps = int(every_n_steps)
        self.grad_stats = grad_stats
        self.skip_nonfinite_updates = skip_nonfinite_updates
        self.dump_dir = dump_dir
        self.detector = detector or AnomalyDetector()
        self.on_event = on_event
        self.monitor = monitor
        self.raise_on_nonfinite = raise_on_nonfinite

    @classmethod
    def coerce(cls, numerics) -> Optional["NumericsConfig"]:
        """Normalize TrainStep's `numerics=` argument: None/False -> None,
        True -> defaults, a NumericsConfig passes through."""
        if numerics is None or numerics is False:
            return None
        if numerics is True:
            return cls()
        if isinstance(numerics, cls):
            return numerics
        if hasattr(numerics, "to_numerics_config"):   # TensorCheckerConfig
            return numerics.to_numerics_config()
        raise TypeError(
            f"numerics must be bool or NumericsConfig, got {type(numerics)}")
