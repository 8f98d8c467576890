"""DGC: top-k sparsified gradient exchange (the port of
paddle_tpu/distributed/dgc.py).

Reference: the DGC operator and DGCMomentumOptimizer: each worker sends
only the top-k entries of its gradient per step (k = (1 - sparsity) n),
keeps the rest as error feedback, and the ring all-reduce becomes an
all-gather of (values, indices).

Here every rank is one process: `sparse_allreduce` takes the rank's own
tensor, all-gathers the (values, int64 indices) pairs of every rank's
top-k over a process `Group` (2 k D elements on the wire instead of the
dense all-reduce's 2 n) and scatter-adds them into a dense tensor.
`dgc_value_and_grad` is the whole DGC step of a pure data-parallel run.

The wire math per tensor of n elements over D workers:
  dense all-reduce   ~ 2 n       elements on the ring
  DGC all-gather     ~ 2 k D     (values + indices), k = (1 - sparsity) n
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from .collective import Group, ReduceOp, all_gather, all_reduce


def sparse_allreduce(x, group: Optional[Group] = None,
                     sparsity: float = 0.999, residual=None):
    """Top-k sparsified sum over `group` with error feedback; every rank
    calls it with its own `x` (and its own `residual`, the same shape, or
    None). Returns (the dense sum of every rank's top-k entries, what this
    rank kept back)."""
    flat = x.reshape(-1).float()
    if residual is not None:
        flat = flat + residual.reshape(-1).float()
    n = flat.numel()
    k = max(1, int(n * (1.0 - sparsity)))
    _, idx = torch.topk(flat.abs(), k)
    sent = flat[idx]                          # the signed top-k values
    kept = flat.clone()
    kept[idx] = 0.0                           # the error feedback
    if group is None or group.nranks == 1:
        all_vals, all_idx = sent[None], idx[None]
    else:
        all_vals = all_gather(sent, group=group)      # [D, k]
        all_idx = all_gather(idx, group=group)        # [D, k]
    dense = torch.zeros(n, dtype=torch.float32, device=flat.device)
    dense.index_add_(0, all_idx.reshape(-1), all_vals.reshape(-1))
    return dense.reshape(x.shape).to(x.dtype), kept.reshape(x.shape)


def _rows(a, group: Group):
    """This rank's rows of a batch leaf (dim 0 cut into D equal parts)."""
    if not torch.is_tensor(a) or a.dim() == 0:
        return a
    d, r = group.nranks, group.rank
    if a.shape[0] % d:
        raise ValueError(f"batch size {a.shape[0]} does not split over the "
                         f"{d} ranks of {group}")
    k = a.shape[0] // d
    return a[r * k:(r + 1) * k]


def dgc_value_and_grad(loss_fn, params: Sequence[torch.Tensor], batch,
                       group: Optional[Group] = None,
                       sparsity: float = 0.999, residuals=None):
    """(loss, compressed gradients, new residuals) of a pure data-parallel
    step. `loss_fn(params, local_batch)` is ONE rank's loss (no reduction
    inside: the DGC exchange is the reduction); `batch` is the global
    batch (a tensor or a tuple of them), cut on dim 0 into the group's
    ranks as the JAX step's P(axis) cuts it; `residuals` are this rank's
    own error-feedback state, one f32 tensor a parameter (the JAX
    package's [D, ...] stack's row r; None starts at zero). The mean over
    the ranks is folded in (each rank sends g / D), so the result drops in
    where the dense averaged gradient would; the loss is the ranks'
    mean."""
    if group is None:
        from .mesh import axis_group
        group = axis_group("dp")
    if group is None:
        from .collective import get_group
        group = get_group()
    d = group.nranks
    params = list(params)
    if residuals is None:
        residuals = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for p in params]
    local = tuple(_rows(a, group) for a in batch) \
        if isinstance(batch, (tuple, list)) else _rows(batch, group)
    loss = loss_fn(params, local)
    grads = torch.autograd.grad(loss, params)
    outs, news = [], []
    for g, r in zip(grads, residuals):
        s, nr = sparse_allreduce(g / d, group, sparsity, residual=r)
        outs.append(s)
        news.append(nr)
    loss = loss.detach().float().clone()
    all_reduce(loss, ReduceOp.AVG, group=group)
    return loss, outs, news
