"""Pooling layers (the port of paddle_tpu/nn/layers/pooling.py's
MaxPool2D and AdaptiveAvgPool2D)."""
from __future__ import annotations

from torch import nn

from .. import functional as F


class MaxPool2D(nn.Module):
    """Max pooling with -inf padding; `ceil_mode` is accepted and ignored,
    as in the JAX package; `return_mask` is refused (see
    `nn.functional.max_pool2d`)."""

    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, data_format="NCHW", name=None):
        super().__init__()
        self.k, self.s, self.p = kernel_size, stride, padding
        self.return_mask, self.ceil_mode = return_mask, ceil_mode
        self.data_format = data_format

    def forward(self, x):
        return F.max_pool2d(x, self.k, self.s, self.p, self.ceil_mode,
                            self.return_mask, self.data_format)


class AdaptiveAvgPool2D(nn.Module):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__()
        self.output_size, self.data_format = output_size, data_format

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.output_size, self.data_format)
