"""Layer-level helpers of the port (the port of paddle_tpu/nn's gradient
clips, its routing LayerNorm and the vision trunk's conv, batch-norm and
pooling layers)."""
from . import functional, layout
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .layers import (AdaptiveAvgPool2D, BatchNorm, BatchNorm1D, BatchNorm2D,
                     BatchNorm3D, Conv2D, LayerNorm, MaxPool2D)

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "LayerNorm", "Conv2D", "BatchNorm", "BatchNorm1D", "BatchNorm2D",
           "BatchNorm3D", "MaxPool2D", "AdaptiveAvgPool2D", "functional",
           "layout"]
