"""Layer-level helpers of the port (the port of paddle_tpu/nn's gradient
clipping)."""
from .clip import ClipGradByGlobalNorm

__all__ = ["ClipGradByGlobalNorm"]
