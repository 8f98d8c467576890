"""Layers of the port whose forward routes through the port's ops."""
from .conv import Conv2D
from .norm import (BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D,
                   LayerNorm)
from .pooling import AdaptiveAvgPool2D, MaxPool2D

__all__ = ["LayerNorm", "Conv2D", "BatchNorm", "BatchNorm1D", "BatchNorm2D",
           "BatchNorm3D", "MaxPool2D", "AdaptiveAvgPool2D"]
