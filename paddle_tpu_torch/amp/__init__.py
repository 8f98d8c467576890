"""Loss scaling (the port of paddle_tpu/amp's GradScaler)."""
from .grad_scaler import AmpScaler, GradScaler

__all__ = ["GradScaler", "AmpScaler"]
