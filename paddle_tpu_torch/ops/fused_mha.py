"""Fused whole-sequence multi-head attention for short sequences (the port
of paddle_tpu/ops/pallas/fused_mha.py): attention on the packed projection
output ``qkv [B, S, 3 * nh * hd]`` laid out ``[q heads | k heads | v
heads]``, with an int `kv_len` or per-row `lens` key mask, an optional
causal mask and attention-probability dropout drawn inside the kernel.

`fused_mha` routes by device and by nothing else: for CUDA tensors the
hand-written kernels (ops/cuda/fused_mha.py, kernel #9: the forward and
the backward), which launch or raise; for CPU tensors the plain versions
here. Both run inside one torch.autograd.Function that saves qkv, the
seed and the lens, as the JAX custom VJP does, and on the bf16 kernel
route the forward's log-sum-exp (f32 [B, nh, S]: 1/32 of the output's
bytes at head dim 64); the backward recomputes the softmax from it and
returns d(qkv) in the packed layout.

The function (`fused_mha_reference` and `fused_mha_bwd_reference`, what
the JAX kernel bodies compute): f32 scores times the scale; the causal
mask (row >= col) and then the kv_len or lens mask set masked scores to
-1e30; an f32 softmax; the dropout keep-scale; the probabilities rounded
to v's dtype before their product with v. Backward: the softmax VJP with
the exact in-row term r = rowsum(dsigma * sigma) (not a delta from the
rounded output), dS rounded to q's dtype and the dropped probabilities to
dO's dtype before their products. A row whose every key is masked (lens
<= 0) averages all S keys, as the JAX kernel does.

Dropout. The JAX kernel seeds the TPU's own PRNG with seed + b * nh + h;
that generator has no CUDA counterpart, so the port defines one stateless
counter-based generator, `dropout_bits`: for (b, h, row, col) the bits
are fmix32(fmix32(fmix32(seed + b * nh + h) + row) + col) in uint32
arithmetic (murmur3's finaliser). An entry is kept iff bits >= floor(p *
2^32), and kept entries are scaled by 1 / (1 - p), JAX's rule. The
kernels and the plain versions compute the same bits (here with int64
tensor ops masked to 32 bits), and the backward regenerates the forward's
mask. Dropout agrees with the JAX package by statistics only: the TPU's
bits cannot be reproduced. The seed is an int32 tensor of one element on
the device (a model draws it from its `dropout_generator` each call), so
no host sync is needed to start the kernel.

The TPU kernel's head grouping (`heads_per_program`,
``PADDLE_TPU_FUSED_MHA_G``) plans TPU VMEM and does not change the
result; it has no counterpart here.
"""
from __future__ import annotations

import math
import numbers
import os

import torch

from .attention import _on_cuda, attention_reference
from .cuda.fused_mha import (fused_mha_bwd_cuda, fused_mha_fwd_cuda,
                             keep_threshold)

_NEG = -1e30
_M32 = 0xFFFFFFFF


def use_fused_mha(s, num_heads, head_dim, max_seq=768) -> bool:
    """The JAX gate minus its platform test: whole sublanes per head, the
    packed width in 128-lane rows, a short sequence. Also head_dim <= 256,
    the widest head the kernel takes (no model of the repo has a wider
    one). ``PADDLE_TPU_FUSED_MHA=0`` forces the non-fused route."""
    if os.environ.get("PADDLE_TPU_FUSED_MHA") == "0":
        return False
    return (head_dim % 8 == 0 and head_dim * num_heads % 128 == 0
            and s <= max_seq and head_dim <= 256)


# ------------------------------------------------------------ dropout bits
def _mul32(x, c: int):
    """(x * c) mod 2^32 for int64 x in [0, 2^32) without overflowing int64
    (the product is split at c's 16-bit halves)."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _fmix32(h):
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def dropout_bits(seed, b, nh, s_q, s_k, device=None):
    """uint32 values (as int64) [b, nh, s_q, s_k] of the generator the
    kernels use: fmix32(fmix32(fmix32(seed + bi * nh + h) + row) + col)."""
    seed = torch.as_tensor(seed, device=device).reshape(-1)[:1].long()
    heads = torch.arange(b * nh, device=seed.device).reshape(b, nh)
    k1 = _fmix32((seed + heads) & _M32)
    rows = torch.arange(s_q, device=seed.device)
    cols = torch.arange(s_k, device=seed.device)
    r = _fmix32((k1[..., None] + rows) & _M32)
    return _fmix32((r[..., None] + cols) & _M32)


def keep_scale(seed, p, b, nh, s, device=None):
    """f32 [b, nh, s, s]: 1 / (1 - p) where kept, 0 where dropped."""
    keep = dropout_bits(seed, b, nh, s, s, device) >= keep_threshold(p)
    inv = torch.tensor(1.0 / (1.0 - p), dtype=torch.float32,
                       device=keep.device)
    return torch.where(keep, inv, torch.zeros((), device=keep.device))


# ---------------------------------------------------------- plain versions
def _unpack(qkv, nh):
    b, s, f3 = qkv.shape
    a = qkv.reshape(b, s, 3, nh, f3 // (3 * nh))
    return a[:, :, 0], a[:, :, 1], a[:, :, 2]


def _sigma(q, k, scale, kv_len, lens, causal):
    """f32 softmax [B, nh, S, S] of the masked f32 scores."""
    s_q, s_k = q.shape[1], k.shape[1]
    sc = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    neg = torch.tensor(_NEG, dtype=torch.float32, device=q.device)
    if causal:
        keep = torch.ones((s_q, s_k), dtype=torch.bool,
                          device=q.device).tril()
        sc = torch.where(keep, sc, neg)
    cols = torch.arange(s_k, device=q.device)
    if lens is not None:
        live = cols[None, :] < lens.to(q.device).long()[:, None]  # [B, Sk]
        sc = torch.where(live[:, None, None, :], sc, neg)
    elif kv_len is not None:
        sc = torch.where(cols < kv_len, sc, neg)
    m = sc.amax(-1, keepdim=True)
    p = torch.exp(sc - m)
    return p / p.sum(-1, keepdim=True)


def fused_mha_reference(qkv, num_heads, *, scale=None, kv_len=None,
                        lens=None, causal=False, dropout_p=0.0, seed=None):
    """The plain version of the forward kernel on [B, S, 3F]; returns
    [B, S, F] in qkv's dtype. Differentiable through autograd."""
    q, k, v = _unpack(qkv, num_heads)
    b, s, nh, hd = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    p = _sigma(q, k, scale, kv_len, lens, causal)
    if dropout_p > 0.0:
        p = p * keep_scale(seed, dropout_p, b, nh, s, qkv.device)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return out.reshape(b, s, nh * hd).to(qkv.dtype)


def fused_mha_bwd_reference(qkv, dout, num_heads, *, scale=None,
                            kv_len=None, lens=None, causal=False,
                            dropout_p=0.0, seed=None):
    """The plain version of the backward kernel: d(qkv) [B, S, 3F] in
    qkv's dtype from qkv and dO [B, S, F], as the JAX backward kernel
    computes it (exact in-row term, dS and the dropped probabilities
    rounded before their products)."""
    q, k, v = _unpack(qkv, num_heads)
    b, s, nh, hd = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    do = dout.to(qkv.dtype).reshape(b, s, nh, hd)
    sigma = _sigma(q, k, scale, kv_len, lens, causal)
    dpd = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    if dropout_p > 0.0:
        m = keep_scale(seed, dropout_p, b, nh, s, qkv.device)
        pd, dsig = sigma * m, dpd * m
    else:
        pd, dsig = sigma, dpd
    dv = torch.einsum("bhqk,bqhd->bkhd", pd.to(do.dtype).float(), do.float())
    r = (dsig * sigma).sum(-1, keepdim=True)
    ds = (sigma * (dsig - r)).to(q.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    return torch.cat([t.reshape(b, s, nh * hd) for t in (dq, dk, dv)],
                     dim=-1).to(qkv.dtype)


# ----------------------------------------------------------------- router
def _packed(t):
    """`t` itself when contiguous and 16-byte aligned, else a contiguous
    copy: the kernels read their inputs in place, so the router hands
    them only such tensors, on either device."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


class _FusedMHA(torch.autograd.Function):
    """Forward kernel (or plain forward); the backward recomputes from the
    saved qkv, seed and lens, and the kernels' lse."""

    @staticmethod
    def forward(ctx, qkv, seed, lens, num_heads, scale, kv_len, causal,
                dropout_p):
        kw = dict(scale=scale, kv_len=kv_len, lens=lens, causal=causal,
                  dropout_p=dropout_p, seed=seed)
        if _on_cuda(qkv):
            out, lse = fused_mha_fwd_cuda(qkv, num_heads, **kw)
        else:
            out, lse = fused_mha_reference(qkv, num_heads, **kw), None
        ctx.save_for_backward(qkv, seed, lens, lse)
        ctx.num_heads, ctx.scale, ctx.kv_len = num_heads, scale, kv_len
        ctx.causal, ctx.dropout_p = causal, dropout_p
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, seed, lens, lse = ctx.saved_tensors
        kw = dict(scale=ctx.scale, kv_len=ctx.kv_len, lens=lens,
                  causal=ctx.causal, dropout_p=ctx.dropout_p, seed=seed)
        dout = _packed(dout.to(qkv.dtype))
        if _on_cuda(qkv):
            dqkv = fused_mha_bwd_cuda(qkv, dout, lse, ctx.num_heads, **kw)
        else:
            dqkv = fused_mha_bwd_reference(qkv, dout, ctx.num_heads, **kw)
        return dqkv, None, None, None, None, None, None, None


def fused_mha(qkv, num_heads, *, scale=None, kv_len=None, causal=False,
              dropout_p=0.0, dropout_seed=None):
    """Fused short-sequence attention on the packed projection output.

    qkv: [B, S, 3 * nh * hd], ``[q heads | k heads | v heads]``.
    kv_len: an int count of valid key rows (``>= S`` means no mask), or
        per-row valid lengths ``[B]`` of a right-padded batch. Query rows
        past a row's length attend its valid keys like any other row; the
        loss masks them out.
    dropout_p: attention-probability dropout; needs `dropout_seed`, an
        int or an int tensor of one element (kept on the device).
    Returns [B, S, nh * hd] in qkv's dtype, differentiable in qkv."""
    b, s, f3 = qkv.shape
    hd = f3 // 3 // num_heads
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    if dropout_p > 0.0 and dropout_seed is None:
        raise ValueError("fused_mha: dropout_p > 0 requires dropout_seed")
    lens = None
    if kv_len is not None and not (isinstance(kv_len, numbers.Integral)
                                   and not isinstance(kv_len, bool)):
        lens = torch.as_tensor(kv_len, device=qkv.device)
        if lens.numel() != b:
            raise ValueError(f"fused_mha: per-row kv_len must have B={b} "
                             f"entries; got shape {tuple(lens.shape)}")
        lens = lens.reshape(b).to(torch.int32).contiguous()
        kv_len = None
    if kv_len is not None and kv_len <= 0:
        raise ValueError(f"fused_mha: kv_len must be positive, got {kv_len}")
    if kv_len is not None and kv_len >= s:
        kv_len = None
    seed = None
    if dropout_p > 0.0:
        seed = torch.as_tensor(dropout_seed, device=qkv.device)
        seed = seed.reshape(-1)[:1].to(torch.int32).contiguous()
    return _FusedMHA.apply(_packed(qkv), seed, lens, int(num_heads),
                           float(scale),
                           None if kv_len is None else int(kv_len),
                           bool(causal), float(dropout_p))


def mha_reference_packed(qkv, num_heads, *, scale=None, kv_len=None,
                         causal=False, score_dtype=None):
    """The non-fused route with fused_mha's signature (no dropout):
    unpack, run the shared reference attention, repack."""
    q, k, v = _unpack(qkv, num_heads)
    b, s = qkv.shape[:2]
    mask = None
    if kv_len is not None and kv_len < s:
        mask = (torch.arange(s, device=qkv.device) < kv_len)[None, None,
                                                              None, :]
    out = attention_reference(q, k, v, mask=mask, is_causal=causal,
                              scale=scale, score_dtype=score_dtype)
    return out.reshape(b, s, -1)
