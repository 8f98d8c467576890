"""Conv2D (the port of paddle_tpu/nn/layers/conv.py's `_ConvNd` and
`Conv2D`): weight ``[out, in / groups, kh, kw]`` (the JAX package's and
PyTorch's layout agree), an optional bias ``[out]``, both drawn from
Uniform(+-1 / sqrt(fan_in)) as in the JAX package."""
from __future__ import annotations

import math

import torch
from torch import nn

from ...device import resolve_device
from .. import functional as F


class Conv2D(nn.Module):
    """2-D convolution through `nn.functional.conv2d`. `bias_attr=False`
    means no bias; other `weight_attr` / `bias_attr` objects (Paddle's
    ParamAttr) are refused. `padding_mode` is stored and unused, as in the
    JAX package. `generator` draws the initial values (a fresh one seeded
    0 if None). ``device`` defaults to CUDA (raising without a card)."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 device=None, dtype=None, generator=None):
        super().__init__()
        if in_channels % groups or out_channels % groups:
            raise ValueError("channels must be divisible by groups")
        for attr in (weight_attr, bias_attr):
            if attr is not None and attr is not False:
                raise NotImplementedError(
                    "Conv2D(weight_attr=/bias_attr=ParamAttr) comes with the "
                    "rest of the Paddle API surface (ROADMAP queue A); "
                    "bias_attr=False drops the bias")
        k = tuple(kernel_size) if isinstance(kernel_size, (list, tuple)) \
            else (kernel_size,) * 2
        self._in_channels, self._out_channels = in_channels, out_channels
        self._kernel_size = k
        self._stride, self._padding, self._dilation = stride, padding, \
            dilation
        self._groups, self._data_format = groups, data_format
        self._padding_mode = padding_mode
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.weight = nn.Parameter(torch.empty(
            out_channels, in_channels // groups, *k, **kw))
        self.bias = None if bias_attr is False else \
            nn.Parameter(torch.empty(out_channels, **kw))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        if generator is None:
            generator = torch.Generator(device=self.weight.device)
            generator.manual_seed(0)
        bound = 1.0 / math.sqrt(self.weight[0].numel())
        self.weight.uniform_(-bound, bound, generator=generator)
        if self.bias is not None:
            self.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={self._kernel_size}, stride={self._stride}")
