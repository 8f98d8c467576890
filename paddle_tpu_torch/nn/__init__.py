"""Layer-level helpers of the port (the port of paddle_tpu/nn's gradient
clipping and its routing LayerNorm)."""
from . import functional
from .clip import ClipGradByGlobalNorm
from .layers import LayerNorm

__all__ = ["ClipGradByGlobalNorm", "LayerNorm", "functional"]
