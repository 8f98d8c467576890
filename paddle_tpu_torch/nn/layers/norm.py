"""LayerNorm and the batch norms (the port of
paddle_tpu/nn/layers/norm.py's LayerNorm, `_BatchNormBase`,
BatchNorm1D/2D/3D and BatchNorm)."""
from __future__ import annotations

import torch
from torch import nn

from ...device import resolve_device
from .. import functional as F


class LayerNorm(torch.nn.LayerNorm):
    """`torch.nn.LayerNorm` (same parameters, state dict and isinstance)
    whose forward goes through `nn.functional.layer_norm`: the fused
    LayerNorm where the opt-in PADDLE_TPU_FUSED_LN=1 and its shape rule
    hold, `torch.nn.functional.layer_norm` otherwise. ``device`` defaults
    to CUDA (raising without a card)."""

    def __init__(self, normalized_shape, eps=1e-5, elementwise_affine=True,
                 bias=True, device=None, dtype=None):
        super().__init__(normalized_shape, eps=eps,
                         elementwise_affine=elementwise_affine, bias=bias,
                         device=resolve_device(device), dtype=dtype)

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight,
                            self.bias, self.eps)


class _BatchNormBase(nn.Module):
    """Batch norm over every axis but the channel, through
    `nn.functional.batch_norm`: `weight` (ones) and `bias` (zeros), and the
    running statistics in the JAX package's buffers ``_mean`` (zeros) and
    ``_variance`` (ones), updated in train() mode by Paddle's rule
    (momentum 0.9 on the old value, the biased batch variance).
    `use_global_stats` normalises with the buffers in train() mode too;
    `weight_attr=False` / `bias_attr=False` drop the affine terms.
    ``device`` defaults to CUDA (raising without a card)."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, device=None, dtype=None):
        super().__init__()
        for attr in (weight_attr, bias_attr):
            if attr is not None and attr is not False:
                raise NotImplementedError(
                    "BatchNorm(weight_attr=/bias_attr=ParamAttr) comes with "
                    "the rest of the Paddle API surface (ROADMAP queue A)")
        self._num_features = num_features
        self._momentum, self._epsilon = momentum, epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.weight = None if weight_attr is False else \
            nn.Parameter(torch.ones(num_features, **kw))
        self.bias = None if bias_attr is False else \
            nn.Parameter(torch.zeros(num_features, **kw))
        self.register_buffer("_mean", torch.zeros(num_features, **kw))
        self.register_buffer("_variance", torch.ones(num_features, **kw))

    def forward(self, x):
        return F.batch_norm(x, self._mean, self._variance, self.weight,
                            self.bias, training=self.training,
                            momentum=self._momentum, epsilon=self._epsilon,
                            data_format=self._data_format,
                            use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return f"num_features={self._num_features}, momentum={self._momentum}"


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    pass


class BatchNorm(_BatchNormBase):
    """The legacy Paddle signature; `act="relu"` applies a ReLU after, any
    other `act` nothing (as in the JAX package)."""

    def __init__(self, num_channels, act=None, momentum=0.9, epsilon=1e-5,
                 param_attr=None, bias_attr=None, data_layout="NCHW",
                 use_global_stats=None, device=None, dtype=None, **kw):
        super().__init__(num_channels, momentum, epsilon, param_attr,
                         bias_attr, data_layout, use_global_stats,
                         device=device, dtype=dtype)
        self._act = act

    def forward(self, x):
        out = super().forward(x)
        if self._act == "relu":
            return torch.relu(out)
        return out
