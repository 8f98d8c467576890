"""Functional layers of the port (the port of paddle_tpu/nn/functional.py's
`layer_norm` routing)."""
from __future__ import annotations

import torch

from ..ops.layer_norm import fused_layer_norm, fused_layer_norm_supported


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    """LayerNorm over the trailing `normalized_shape` axes. Over one axis,
    where `fused_layer_norm_supported(x.shape)` holds (the opt-in
    PADDLE_TPU_FUSED_LN=1 and the kernel's shape rule), it runs the fused
    LayerNorm (kernel #8 on CUDA); otherwise
    `torch.nn.functional.layer_norm`, as `torch.nn.LayerNorm` does."""
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    normalized_shape = tuple(normalized_shape)
    if len(normalized_shape) == 1 and \
            fused_layer_norm_supported(tuple(x.shape)):
        return fused_layer_norm(x, weight, bias, eps=epsilon)
    return torch.nn.functional.layer_norm(x, normalized_shape, weight, bias,
                                          epsilon)
