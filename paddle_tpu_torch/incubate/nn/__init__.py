"""Fused layers and functional ops (the port of paddle_tpu/incubate/nn):
`FusedLinear`, `FusedBiasDropoutResidualLayerNorm` and the fused
transformer layers of `fused_transformer`."""
import torch
from torch import nn

from ...device import resolve_device
from ...nn.initializer import xavier_normal_
from . import functional
from .fused_transformer import (FusedEcMoe, FusedFeedForward,
                                FusedMultiHeadAttention,
                                FusedMultiTransformer,
                                FusedTransformerEncoderLayer)

__all__ = ["functional", "FusedLinear", "FusedBiasDropoutResidualLayerNorm",
           "FusedMultiHeadAttention", "FusedFeedForward",
           "FusedTransformerEncoderLayer", "FusedMultiTransformer",
           "FusedEcMoe"]


class FusedLinear(nn.Module):
    """Linear through `functional.fused_linear`. ``weight`` keeps the JAX
    package's layout, ``[in, out]`` (``[out, in]`` under
    `transpose_weight`), and is marked ``keeps_paddle_layout`` so the
    weight converter and the int8 moments leave it as it is; Xavier-normal
    init from ``seed``, zero bias (none with ``bias_attr=False``).
    ``device`` defaults to CUDA (raising without a card)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, transpose_weight=False, name=None,
                 device=None, dtype=None, seed: int = 0):
        super().__init__()
        kw = dict(device=resolve_device(device),
                  dtype=dtype or torch.float32)
        self.transpose_weight = transpose_weight
        shape = ((out_features, in_features) if transpose_weight
                 else (in_features, out_features))
        self.weight = nn.Parameter(torch.empty(shape, **kw))
        self.weight.keeps_paddle_layout = True
        xavier_normal_(self.weight, torch.Generator(
            device=kw["device"]).manual_seed(seed))
        self.bias = None if bias_attr is False else \
            nn.Parameter(torch.zeros(out_features, **kw))

    def forward(self, x):
        return functional.fused_linear(x, self.weight, self.bias,
                                       transpose_weight=self.transpose_weight)


class FusedBiasDropoutResidualLayerNorm(nn.Module):
    """LayerNorm(residual + dropout(x + bias)) with its own ``ln_scale``
    (ones) and ``ln_bias`` (zeros); dropout in ``train()`` mode only, its
    masks drawn from ``dropout_generator`` (seeded with ``seed``).
    ``device`` defaults to CUDA (raising without a card)."""

    def __init__(self, embed_dim, dropout_rate=0.5, weight_attr=None,
                 bias_attr=None, epsilon=1e-5, name=None, device=None,
                 dtype=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        kw = dict(device=dev, dtype=dtype or torch.float32)
        self.dropout_rate = dropout_rate
        self.epsilon = epsilon
        self.ln_scale = nn.Parameter(torch.ones(embed_dim, **kw))
        self.ln_bias = nn.Parameter(torch.zeros(embed_dim, **kw))
        self.dropout_generator = torch.Generator(device=dev).manual_seed(seed)

    def forward(self, x, residual, bias=None):
        return functional.fused_bias_dropout_residual_layer_norm(
            x, residual, bias, self.ln_scale, self.ln_bias,
            dropout_rate=self.dropout_rate if self.training else 0.0,
            ln_epsilon=self.epsilon, generator=self.dropout_generator)
