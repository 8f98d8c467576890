"""Flash attention (the port of paddle_tpu/ops/pallas/flash_attention.py's
`flash_attention` and `flash_attention_packed`): differentiable attention
on [B, S, H, D] with the per-row logsumexp saved for a FlashAttention-2
backward, and the same on the packed [B, S, nh * 128] layout of a qkv
projection, whose gradients come back in that layout.

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
multiple of 16 here, the depth of one tensor-core product step; the TPU
kernel's block sizes and autotuning are TPU tiling and have no
counterpart.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .attention import _on_cuda
from .cuda.flash_attention import (flash_bwd_cuda, flash_fwd_cuda,
                                   flash_packed_bwd_cuda,
                                   flash_packed_fwd_cuda)

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


# ------------------------------------------ kernel #7: the packed layout
def _heads(t, num_heads):
    return t.unflatten(-1, (num_heads, t.shape[-1] // num_heads))


def flash_packed_forward_reference(q, k, v, num_heads, causal=False,
                                   scale=None, kv_len=None):
    """The plain version of the packed forward: `flash_forward_reference`
    on the [B, S, nh, hd] views; returns (out [B, Sq, nh * hd], lse [B,
    nh, Sq] f32). Differentiable through autograd."""
    out, lse = flash_forward_reference(_heads(q, num_heads),
                                       _heads(k, num_heads),
                                       _heads(v, num_heads), causal, scale,
                                       kv_len)
    return out.flatten(2), lse


def flash_packed_bwd_reference(q, k, v, out, lse, dout, num_heads,
                               causal=False, scale=None, kv_len=None):
    """The plain version of the packed backward kernels on their inputs
    (`flash_bwd_reference` on the [B, S, nh, hd] views); returns (dq, dk,
    dv) [B, S, nh * hd] in q's dtype."""
    grads = flash_bwd_reference(*(_heads(t, num_heads) for t in
                                  (q, k, v, out)), lse,
                                _heads(dout, num_heads), causal, scale,
                                kv_len)
    return tuple(g.flatten(2) for g in grads)


class _FlashAttentionPacked(torch.autograd.Function):
    """#7 on three packed tensors: the forward kernel on their head views;
    the backward returns dq, dk and dv, each [B, S, nh * hd]."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads, causal, scale, kv_len):
        out, lse = flash_packed_fwd_cuda(q, k, v, num_heads, causal=causal,
                                         scale=scale, kv_len=kv_len)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (num_heads, causal, scale, kv_len)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        nh, causal, scale, kv_len = ctx.args
        dq, dk, dv = flash_packed_bwd_cuda(q, k, v, out, lse, dout, nh,
                                           causal=causal, scale=scale,
                                           kv_len=kv_len)
        return dq, dk, dv, None, None, None, None


class _FlashAttentionPackedQKV(torch.autograd.Function):
    """#7 on one packed projection qkv [B, S, 3 * nh * hd] (q, k and v its
    column thirds): the backward writes dq, dk and dv straight into the
    column slices of one d(qkv), so autograd never zero-fills and sums a
    full-width gradient per slice."""

    @staticmethod
    def forward(ctx, qkv, num_heads, causal, scale):
        q, k, v = qkv.chunk(3, dim=-1)
        out, lse = flash_packed_fwd_cuda(q, k, v, num_heads, causal=causal,
                                         scale=scale)
        ctx.save_for_backward(qkv, out, lse)
        ctx.args = (num_heads, causal, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, out, lse = ctx.saved_tensors
        nh, causal, scale = ctx.args
        dqkv = torch.empty_like(qkv, memory_format=torch.contiguous_format)
        flash_packed_bwd_cuda(*qkv.chunk(3, dim=-1), out, lse, dout, nh,
                              causal=causal, scale=scale,
                              **dict(zip(("dq", "dk", "dv"),
                                         dqkv.chunk(3, dim=-1))))
        return dqkv, None, None, None


def _packed_args(q, k, num_heads, scale, kv_len):
    """(scale, kv_len, whether the packed kernels take the shape): the JAX
    wrapper's rules. Its row blocks halve from 256 until they divide the
    sequence, and below 8 rows, or at head_dim != 128, it reshapes onto
    the [B, S, H, D] kernel."""
    hd = q.shape[-1] // num_heads
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    s_k = k.shape[1]
    if kv_len is not None and kv_len <= 0:
        raise ValueError(f"flash_attention_packed: kv_len must be positive, "
                         f"got {kv_len}")
    if kv_len is not None and kv_len >= s_k:
        kv_len = None
    packed = hd == 128 and q.shape[1] % 8 == 0 and s_k % 8 == 0
    return float(scale), kv_len, packed


def flash_attention_packed(q, k, v, num_heads: int, causal: bool = False,
                           scale=None, kv_len: int = None):
    """Flash attention on packed [B, S, num_heads * head_dim] tensors (q
    [B, Sq, .], k and v [B, Sk, .]; for instance the column slices of a qkv
    projection, taken without a copy); returns [B, Sq, num_heads *
    head_dim] in q's dtype, and dq, dk and dv come back in the same
    layout. head_dim == 128 only: other shapes are reshaped onto
    `flash_attention`, as in the JAX wrapper. On CUDA tensors kernel #7
    (#6's kernels on the packed views) runs; on CPU tensors its plain
    version, under autograd."""
    scale, kv_len, packed = _packed_args(q, k, num_heads, scale, kv_len)
    if not packed:
        out = flash_attention(_heads(q, num_heads), _heads(k, num_heads),
                              _heads(v, num_heads), causal=causal,
                              scale=scale, kv_len=kv_len)
        return out.flatten(2)
    if not _on_cuda(q):
        return flash_packed_forward_reference(q, k, v, num_heads, causal,
                                              scale, kv_len)[0]
    return _FlashAttentionPacked.apply(
        q, k, v, int(num_heads), bool(causal), scale,
        None if kv_len is None else int(kv_len))


def flash_attention_packed_qkv(qkv, num_heads: int, causal: bool = False,
                               scale=None):
    """`flash_attention_packed` on the column thirds of one projection qkv
    [B, S, 3 * num_heads * head_dim], differentiated into one d(qkv) (GPT's
    packed route). Shapes the packed kernels do not take go through
    `flash_attention_packed` on the three slices."""
    q, k, v = qkv.chunk(3, dim=-1)
    scale, _, packed = _packed_args(q, k, num_heads, scale, None)
    if not packed or not _on_cuda(qkv):
        return flash_attention_packed(q, k, v, num_heads, causal, scale)
    return _FlashAttentionPackedQKV.apply(qkv, int(num_heads), bool(causal),
                                          scale)
