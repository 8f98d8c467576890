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
"""
from __future__ import annotations

import torch

from .attention import _on_cuda
from .cuda.linear_ce import linear_ce_fwd_cuda


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


class _LinearCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, labels, w_layout, bwd_chunks):
        if _on_cuda(x):
            loss, lse = linear_ce_fwd_cuda(x, w, labels, w_layout=w_layout)
        else:
            loss, lse = linear_cross_entropy_reference(
                x, w, labels, w_layout, return_lse=True)
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
