"""Flash attention (the port of paddle_tpu/ops/pallas/flash_attention.py's
`flash_attention`): differentiable attention on [B, S, H, D] with the
per-row logsumexp saved for a FlashAttention-2 backward.

`flash_attention` routes by device and by nothing else: for CUDA tensors
it runs the hand-written kernels (ops/cuda/flash_attention.py, kernel #6:
forward, dQ pass, dK/dV pass) inside a torch.autograd.Function, which
launch or raise; for CPU tensors it runs `flash_attention_reference`, the
plain version, under ordinary autograd.

Semantics follow the JAX wrapper: `scale` defaults to 1/sqrt(D) of the
unpadded head dim; `kv_len` <= 0 raises and `kv_len >= s_k` means none;
key columns >= kv_len score -1e30; under `causal` the mask is q_idx >=
k_idx aligned top-left, also when s_q != s_k (the kernel's convention; the
JAX `attention_reference` aligns bottom-right). Head dims are padded to a
multiple of 16 here, which is all `mma.sync` needs; the TPU kernel's block
sizes and autotuning are TPU tiling and have no counterpart.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .attention import _on_cuda
from .cuda.flash_attention import flash_bwd_cuda, flash_fwd_cuda

_NEG = -1e30


def _score_mask(s_q, s_k, causal, kv_len, device):
    """[s_q, s_k] keep-mask: key column < kv_len and, under causal, q_idx
    >= k_idx (top-left); None when nothing is masked."""
    keep = None
    if causal:
        keep = torch.ones((s_q, s_k), dtype=torch.bool,
                          device=device).tril()
    if kv_len is not None:
        cols = torch.arange(s_k, device=device)[None, :] < kv_len
        keep = cols if keep is None else keep & cols
    return keep


def _scores(q, k, causal, scale, kv_len):
    """f32 scores [B, H, Sq, Sk], masked ones -1e30."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    keep = _score_mask(q.shape[1], k.shape[1], causal, kv_len, q.device)
    return s if keep is None else s.masked_fill(~keep, _NEG)


def flash_forward_reference(q, k, v, causal=False, scale=None, kv_len=None):
    """The plain version of the forward kernel: (out in q's dtype, lse
    [B, H, Sq] f32). f32 scores and softmax, masked scores -1e30,
    probabilities rounded to the input dtype before the product with v (as
    the kernel rounds P). Differentiable through autograd."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = _scores(q, k, causal, scale, kv_len)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype).float(),
                       v.float()).to(q.dtype)
    return out, torch.logsumexp(s, dim=-1)


def flash_attention_reference(q, k, v, causal=False, scale=None,
                              kv_len=None):
    """The plain version of the kernels' function (the output of
    `flash_forward_reference`), differentiable through autograd."""
    return flash_forward_reference(q, k, v, causal, scale, kv_len)[0]


def flash_bwd_reference(q, k, v, out, lse, dout, causal=False, scale=None,
                        kv_len=None):
    """The plain version of the backward kernels on their inputs (the
    FlashAttention-2 backward, as the JAX kernels compute it): delta =
    rowsum(dout * out) in f32 from `out` as given, P = exp(s - lse) from the
    saved lse, dS = P * (dout v^T - delta); P and dS rounded to the input
    dtype before their products; dv = P^T dout, dq = scale dS k, dk =
    scale dS^T q. Returns (dq, dk, dv) in q's dtype. Delta comes from the
    rounded output, so where the true dq of a row is near zero (a causal
    row over two keys) it differs from autograd's, as the kernels do."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.exp(_scores(q, k, causal, scale, kv_len) - lse[..., None])
    do = dout.float()
    delta = (do * out.float()).sum(-1).transpose(1, 2)[..., None]
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", do, v.float()) - delta)
    p, ds = (t.to(q.dtype).float() for t in (p, ds))
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


class _FlashAttention(torch.autograd.Function):
    """Forward kernel; the backward runs the dQ and dK/dV kernels from the
    saved q, k, v, out and f32 lse (FlashAttention-2)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, kv_len):
        out, lse = flash_fwd_cuda(q, k, v, causal=causal, scale=scale,
                                  kv_len=kv_len)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale, ctx.kv_len = causal, scale, kv_len
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd_cuda(q, k, v, out, lse, dout,
                                    causal=ctx.causal, scale=ctx.scale,
                                    kv_len=ctx.kv_len)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal: bool = False, scale=None,
                    kv_len: int = None):
    """Differentiable flash attention on [B, S, H, D] tensors (q [B, Sq,
    H, D], k and v [B, Sk, H, D]); returns [B, Sq, H, D] in q's dtype.

    kv_len: the number of valid key rows; rows >= kv_len (zero padding)
    get -1e30 scores, so their probability and dk/dv are exactly zero."""
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    s_k = k.shape[1]
    if kv_len is not None and kv_len <= 0:
        # every key masked would average v instead of failing
        raise ValueError(f"flash_attention: kv_len must be positive, got "
                         f"{kv_len}")
    if kv_len is not None and kv_len >= s_k:
        kv_len = None
    if not _on_cuda(q):
        return flash_attention_reference(q, k, v, causal=causal,
                                         scale=scale, kv_len=kv_len)
    pad = (-d) % 16
    if pad:
        q, k, v = (F.pad(t, (0, pad)) for t in (q, k, v))
    out = _FlashAttention.apply(q, k, v, bool(causal), float(scale),
                                None if kv_len is None else int(kv_len))
    return out[..., :d] if pad else out
