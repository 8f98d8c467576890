"""Fused LM head + softmax cross-entropy (the port of
paddle_tpu/ops/pallas/linear_ce.py).

Per-token loss of logits = x @ W^T (w_layout "vh", W [V, H], the tied
embedding) or x @ W ("hv", W [H, V], an untied head) without the [T, V]
logits ever reaching device memory in the forward. The forward saves the
per-token logsumexp; the backward is closed-form,

    dlogits[t, v] = g[t] * (exp(logits[t, v] - lse[t]) - 1{v == label[t]})

rebuilt in `bwd_chunks` token chunks in x's dtype, then dx = dlogits @ W
and dW = dlogits^T @ x with f32 accumulation. As in the JAX package these
backward products are plain matmuls, not a kernel.

The forward routes by device and by nothing else: a CUDA tensor runs the
hand-written kernel (ops/cuda/linear_ce.py, kernel #11), which launches or
raises; a CPU tensor runs the plain version. The JAX gate's platform test
has no counterpart; its shape rule is `use_linear_ce`.

The vocab-parallel route (`vocab_parallel_linear_cross_entropy`) is the
head split over the ``mp`` ranks of a mesh, W's vocabulary rows (or
columns, "hv") cut into contiguous shards: each rank runs the unchanged
forward on its shard with its labels shifted by the shard's offset (a
label outside the shard gold 0, the kernel's rule), the ranks' per-token
(lse_r, loss_r) are all-gathered and `vocab_parallel_merge` turns them
into the global lse and loss. The backward is the one above on the local
shard with the global lse: it gives the shard's dW and a partial dx,
which is all-reduced over ``mp``. `linear_cross_entropy_shards` is the
same forward and merge over shards held by one process.
"""
from __future__ import annotations

import torch

from .attention import _on_cuda
from .cuda.linear_ce import linear_ce_fwd_cuda

# the #11 launches made through the vocab-parallel route (each also counts
# in the wrapper's own LAUNCHES["linear_ce_fwd"])
VOCAB_PARALLEL_LAUNCHES = {"linear_ce_fwd": 0}


def use_linear_ce(t, h, v) -> bool:
    """The JAX gate's shape rule: MXU-friendly hidden size, whole token
    sublanes and a vocabulary worth fusing."""
    return h % 128 == 0 and t % 8 == 0 and v >= 1024


def _mm_f32(a, b):
    """a @ b with an f32 result: f32 operands multiply as they are; bf16
    operands keep the card's f32 accumulator (`out_dtype`) on CUDA, and
    are widened first on the CPU."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _gold(logits, labels):
    """logits[t, labels[t]], 0 where the label is outside [0, V) (the
    kernel's rule: a label matches no column)."""
    v = logits.shape[-1]
    ok = (labels >= 0) & (labels < v)
    g = logits.gather(-1, labels.clamp(0, v - 1).long()[:, None])[:, 0]
    return torch.where(ok, g, torch.zeros_like(g))


def linear_cross_entropy_reference(x, w, labels, w_layout="vh",
                                   return_lse=False):
    """The plain version: f32 logits (the operands widened first, so the
    products are exact and autograd applies), logsumexp and gold logit.
    Returns f32 [T] losses (and the lse with return_lse)."""
    if w_layout not in ("vh", "hv"):
        raise ValueError(f"w_layout must be 'vh' or 'hv'; got {w_layout!r}")
    wf = w.float()
    logits = x.float() @ (wf.t() if w_layout == "vh" else wf)
    lse = torch.logsumexp(logits, dim=-1)
    loss = lse - _gold(logits, labels)
    return (loss, lse) if return_lse else loss


def _linear_ce_bwd(x, w, labels, lse, g, w_layout, bwd_chunks):
    """The JAX package's default ("onehot") backward, chunk by chunk."""
    t = x.shape[0]
    nc = max(1, int(bwd_chunks))
    while t % nc:
        nc -= 1
    ct = t // nc
    wt = w.t()
    dxs, dw = [], None
    for c in range(nc):
        sl = slice(c * ct, (c + 1) * ct)
        xc, lc, gc = x[sl], labels[sl].long(), g[sl].float()
        p = _mm_f32(xc, w.t() if w_layout == "vh" else w)
        p.sub_(lse[sl][:, None]).exp_()
        v = p.shape[1]
        ok = (lc >= 0) & (lc < v)
        rows = torch.arange(ct, device=x.device)[ok]
        p[rows, lc[ok]] -= 1.0
        dlog = (p * gc[:, None]).to(x.dtype)
        del p
        if w_layout == "vh":
            dxs.append(_mm_f32(dlog, w).to(x.dtype))
            dwc = _mm_f32(dlog.t(), xc)
        else:
            dxs.append(_mm_f32(dlog, wt).to(x.dtype))
            dwc = _mm_f32(xc.t(), dlog)
        dw = dwc if dw is None else dw + dwc
    dx = torch.cat(dxs, dim=0) if len(dxs) > 1 else dxs[0]
    return dx, dw.to(w.dtype)


def _fwd(x, w, labels, w_layout):
    """(loss, lse) of the forward: kernel #11 on a CUDA tensor, the plain
    version on a CPU tensor."""
    if _on_cuda(x):
        return linear_ce_fwd_cuda(x, w, labels, w_layout=w_layout)
    return linear_cross_entropy_reference(x, w, labels, w_layout,
                                          return_lse=True)


class _LinearCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, labels, w_layout, bwd_chunks):
        loss, lse = _fwd(x, w, labels, w_layout)
        ctx.save_for_backward(x, w, labels, lse)
        ctx.w_layout, ctx.bwd_chunks = w_layout, bwd_chunks
        return loss

    @staticmethod
    def backward(ctx, g):
        x, w, labels, lse = ctx.saved_tensors
        dx, dw = _linear_ce_bwd(x, w, labels, lse, g, ctx.w_layout,
                                ctx.bwd_chunks)
        return dx, dw, None, None, None


def linear_cross_entropy(x, w, labels, *, w_layout="vh", bwd_chunks=None):
    """Per-token softmax cross-entropy of x @ W^T ("vh", W [V, H]) or
    x @ W ("hv", W [H, V]); x [T, H], labels [T] integer. Returns f32 [T]
    losses; differentiable in x and W."""
    if w_layout not in ("vh", "hv"):
        raise ValueError(f"w_layout must be 'vh' or 'hv'; got {w_layout!r}")
    return _LinearCE.apply(x, w, labels, w_layout,
                           2 if bwd_chunks is None else int(bwd_chunks))


# ------------------------------------------------ the vocab-parallel route
def vocab_parallel_merge(lse, loss):
    """The global (loss [T], lse [T]) from the shards' stacked per-token
    values lse, loss [mp, T] (f32): each shard's gold logit is lse_r -
    loss_r (0 where the label lies outside the shard), the global lse is
    the logsumexp of the lse_r and the gold logit their sum."""
    glse = torch.logsumexp(lse, dim=0)
    return glse - (lse - loss).sum(dim=0), glse


def _shard_fwd(x, w, labels, w_layout, offset):
    """(loss_r, lse_r) of one vocabulary shard starting at `offset`."""
    v = w.shape[0] if w_layout == "vh" else w.shape[1]
    local = labels.long() - offset
    loss, lse = _fwd(x, w, local, w_layout)
    if _on_cuda(x):
        VOCAB_PARALLEL_LAUNCHES["linear_ce_fwd"] += 1
    return loss, lse, local, v


def linear_cross_entropy_shards(x, w_shards, labels, *, w_layout="vh"):
    """The vocab-parallel forward over shards held by one process: W's
    contiguous vocabulary shards in order (each [V_r, H] "vh" or [H, V_r]
    "hv"), the forward run on each, then `vocab_parallel_merge`. Returns
    f32 (loss [T], lse [T])."""
    if w_layout not in ("vh", "hv"):
        raise ValueError(f"w_layout must be 'vh' or 'hv'; got {w_layout!r}")
    lses, losses, off = [], [], 0
    for w in w_shards:
        loss, lse, _, v = _shard_fwd(x, w, labels, w_layout, off)
        lses.append(lse)
        losses.append(loss)
        off += v
    return vocab_parallel_merge(torch.stack(lses), torch.stack(losses))


class _VocabParallelCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, labels, w_layout, bwd_chunks, group):
        from ..distributed.collective import all_gather
        v = w.shape[0] if w_layout == "vh" else w.shape[1]
        loss, lse, local, _ = _shard_fwd(x, w, labels, w_layout,
                                         group.rank * v)
        both = all_gather(torch.stack([lse, loss]), group=group)
        loss, lse = vocab_parallel_merge(both[:, 0], both[:, 1])
        ctx.save_for_backward(x, w, local, lse)
        ctx.w_layout, ctx.bwd_chunks, ctx.group = w_layout, bwd_chunks, group
        return loss

    @staticmethod
    def backward(ctx, g):
        from ..distributed.collective import all_reduce
        x, w, local, lse = ctx.saved_tensors
        dx, dw = _linear_ce_bwd(x, w, local, lse, g, ctx.w_layout,
                                ctx.bwd_chunks)
        all_reduce(dx, group=ctx.group)
        return dx, dw, None, None, None, None


def vocab_parallel_linear_cross_entropy(x, w, labels, group, *,
                                        w_layout="vh", bwd_chunks=None):
    """`linear_cross_entropy` with W split over the ranks of `group` (a
    `distributed.Group`): `w` is this rank's contiguous vocabulary shard,
    rank r's starting at r * V_r; x [T, H] and the global labels [T] are
    the same on every rank. Returns the f32 [T] losses of the whole
    vocabulary on every rank; differentiable in x (the gradient
    all-reduced over the group) and in the shard."""
    if w_layout not in ("vh", "hv"):
        raise ValueError(f"w_layout must be 'vh' or 'hv'; got {w_layout!r}")
    return _VocabParallelCE.apply(x, w, labels, w_layout,
                                  2 if bwd_chunks is None else
                                  int(bwd_chunks), group)
