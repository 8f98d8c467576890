"""Gradient clipping by global norm (the port of
paddle_tpu/nn/__init__.py's ClipGradByGlobalNorm)."""
from __future__ import annotations

from typing import List

import torch


class ClipGradByGlobalNorm:
    """Scale every gradient by min(1, clip_norm / max(||g||, 1e-12)), the
    norm taken in f32 over all gradients together. An optimizer or
    TrainStep applies it; the object only carries `clip_norm`."""

    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def __call__(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """The clipped gradients, each in its own dtype."""
        if not grads:
            return grads
        total = torch.sqrt(sum(g.float().square().sum() for g in grads))
        scale = torch.clamp(self.clip_norm / torch.clamp(total, min=1e-12),
                            max=1.0)
        return [g * scale.to(g.dtype) for g in grads]
