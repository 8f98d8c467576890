"""LayerNorm (the port of paddle_tpu/nn/layers/norm.py's LayerNorm)."""
from __future__ import annotations

import torch

from .. import functional as F


class LayerNorm(torch.nn.LayerNorm):
    """`torch.nn.LayerNorm` (same parameters, state dict and isinstance)
    whose forward goes through `nn.functional.layer_norm`: the fused
    LayerNorm where the opt-in PADDLE_TPU_FUSED_LN=1 and its shape rule
    hold, `torch.nn.functional.layer_norm` otherwise."""

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight,
                            self.bias, self.eps)
