"""Loss scaling (the port of paddle_tpu/amp's GradScaler) and
`amp.debugging`, the numerics-debugging facade."""
from .grad_scaler import AmpScaler, GradScaler
from . import debugging

__all__ = ["GradScaler", "AmpScaler", "debugging"]
