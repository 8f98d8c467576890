"""Gradient clipping (the port of paddle_tpu/nn/__init__.py's
ClipGradByGlobalNorm, ClipGradByNorm and ClipGradByValue, with the JAX
eager `Optimizer.step`'s arithmetic). An optimizer or TrainStep applies
the clip as `clip(grads)`; the object carries its thresholds.

Under a tensor-parallel mesh, TrainStep calls ``clip(grads, sharded,
group)``: `sharded` flags the gradients of parameters split over the
``mp`` group (`group`, a `distributed.Group`). Their squares are summed
over the group, as the reference's HybridParallelOptimizer does, while a
replicated gradient, the same on every rank, counts once. Under ZeRO
stage 2-3 a rank holds its own parameters' gradients only: TrainStep
passes those and the shard group (`shard_group`), and both sums run over
it as well, so each gradient counts once across the shards. Under an
expert-parallel mesh `expert` flags the gradients of the MoE experts a
rank holds (E / ep of them, `ep_split`); their squares are summed over
`expert_group`, so each expert counts once. The JAX package needs no
such rule: its gradients are global arrays."""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..distributed.collective import all_reduce


def _norm_scale(sq_sum, clip_norm):
    """min(1, clip_norm / max(sqrt(sq_sum), 1e-12)) as a f32 0-d tensor."""
    return torch.clamp(clip_norm / torch.clamp(torch.sqrt(sq_sum),
                                               min=1e-12), max=1.0)


class ClipGradByGlobalNorm:
    """Scale every gradient by min(1, clip_norm / max(||g||, 1e-12)), the
    norm taken in f32 over all gradients together. `group_name` is
    accepted and unused, as in the JAX package."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = clip_norm

    def __call__(self, grads: List[torch.Tensor],
                 sharded: Optional[Sequence[bool]] = None,
                 group=None, shard_group=None,
                 device=None, expert: Optional[Sequence[bool]] = None,
                 expert_group=None) -> List[torch.Tensor]:
        """The clipped gradients, each in its own dtype (see the module
        docstring for `sharded`, `group`, `shard_group`, `expert` and
        `expert_group`; `device` holds the sums when a shard has no
        gradient)."""
        if shard_group is not None:
            return self._sharded_clip(grads, sharded, group, shard_group,
                                      device)
        if not grads:
            return grads
        if expert_group is not None and expert and any(expert):
            return self._expert_clip(grads, sharded, group, expert,
                                     expert_group)
        if group is None or not sharded or not any(sharded):
            sq = sum(g.float().square().sum() for g in grads)
        else:
            sq = sum(g.float().square().sum()
                     for g, s in zip(grads, sharded) if s)
            all_reduce(sq, group=group)
            sq = sq + sum(g.float().square().sum()
                          for g, s in zip(grads, sharded) if not s)
        scale = _norm_scale(sq, self.clip_norm)
        return [g * scale.to(g.dtype) for g in grads]

    def _expert_clip(self, grads, sharded, group, expert, expert_group):
        """The squares of [mp-split, replicated, expert] gradients, the
        first summed over mp, the last over ep."""
        flags = list(sharded) if sharded else [False] * len(grads)
        sq = torch.zeros(3, dtype=torch.float32, device=grads[0].device)
        for g, s, x in zip(grads, flags, expert):
            sq[0 if s else 2 if x else 1] += g.float().square().sum()
        split, rep, ex = sq[0].clone(), sq[1], sq[2].clone()
        if group is not None:
            all_reduce(split, group=group)
        all_reduce(ex, group=expert_group)
        scale = _norm_scale(split + rep + ex, self.clip_norm)
        return [g * scale.to(g.dtype) for g in grads]

    def _sharded_clip(self, grads, sharded, group, shard_group, device):
        """The squares of this shard's gradients, [split over mp,
        replicated], summed over the shard group, the split part then over
        mp."""
        flags = list(sharded) if sharded else [False] * len(grads)
        dev = grads[0].device if grads else device
        sq = torch.zeros(2, dtype=torch.float32, device=dev)
        for g, s in zip(grads, flags):
            sq[0 if s else 1] += g.float().square().sum()
        all_reduce(sq, group=shard_group)
        split, rep = sq[0], sq[1]
        if group is not None:
            split = split.clone()
            all_reduce(split, group=group)
        scale = _norm_scale(split + rep, self.clip_norm)
        return [g * scale.to(g.dtype) for g in grads]


class ClipGradByNorm:
    """Scale each gradient by min(1, clip_norm / max(||g||, 1e-12)), its
    own norm taken in f32."""

    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def __call__(self, grads: List[torch.Tensor],
                 sharded: Optional[Sequence[bool]] = None,
                 group=None, shard_group=None,
                 device=None, expert: Optional[Sequence[bool]] = None,
                 expert_group=None) -> List[torch.Tensor]:
        # a ZeRO shard holds whole parameters: each norm is local
        out = []
        for i, g in enumerate(grads):
            sq = g.float().square().sum()
            if group is not None and sharded and sharded[i]:
                all_reduce(sq, group=group)
            elif expert_group is not None and expert and expert[i]:
                all_reduce(sq, group=expert_group)
            out.append(g * _norm_scale(sq, self.clip_norm).to(g.dtype))
        return out


class ClipGradByValue:
    """Clamp every gradient element into [min, max]; `min` defaults to
    -max."""

    def __init__(self, max, min=None):  # noqa: A002
        self.max = max
        self.min = -max if min is None else min

    def __call__(self, grads: List[torch.Tensor], sharded=None,
                 group=None, shard_group=None,
                 device=None, expert=None,
                 expert_group=None) -> List[torch.Tensor]:
        return [torch.clamp(g, self.min, self.max) for g in grads]
