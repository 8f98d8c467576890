"""Step telemetry of the port: the Prometheus exposition primitives
(`_metrics`) and `StepMonitor`, the engine's batch monitor."""
from .monitor import StepMonitor, shape_delta

__all__ = ["StepMonitor", "shape_delta"]
