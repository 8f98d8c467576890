"""Fused short-sequence multi-head attention with a periodic additive bias
(the port of paddle_tpu/ops/pallas/fused_mha_bias.py): Swin's window
attention, W_g windows batched into one sequence of S = W_g * N tokens.

    out[p] = softmax(q[p] k[p]^T * scale + bias[p mod R]) v[p]   per head

on the packed projection output ``qkv [B, S, 3 * nh * hd]`` laid out
``[q heads | k heads | v heads]``, with ``bias [R, nh, S, S]`` (f32) shared
by the batch rows of one period index (B a multiple of R). The bias
carries -1e9 between the grouped windows (finite: no row is fully
masked), the tiled relative-position table and the shifted-window masks;
it is differentiable, and its gradient is summed over the batch rows that
share a period index, so autograd reaches the relative-position table.

`fused_mha_bias` routes by device and by nothing else: for CUDA tensors
the hand-written kernels (ops/cuda/fused_mha_bias.py, kernel #10: the
forward and the backward with d(bias)), which launch or raise; for CPU
tensors the plain versions here. Both run inside one
torch.autograd.Function that saves qkv and the bias, as the JAX custom VJP
does, and in bf16 on CUDA also the forward's row statistics and its
live-block plan (`fused_mha_bias_plan`): the bf16 kernels visit only the
(64-row, 64-key) blocks of the bias that hold an entry above -5e8.

The function (`fused_mha_bias_reference` and
`fused_mha_bias_bwd_reference`, what the JAX kernel bodies compute): f32
scores times the scale plus the f32 bias, an f32 softmax, the
probabilities rounded to v's dtype before their product with v.
Backward: dsigma = dO v^T in f32, the softmax VJP with the exact in-row
term r = rowsum(dsigma * sigma) (not a delta from the rounded output),
ds = sigma * (dsigma - r) in f32; d(bias)[r] = sum over t of ds[t * R + r]
in f32; ds rounded to q's dtype before dQ = ds k * scale and dK = ds^T q *
scale, sigma rounded to dO's dtype before dV = sigma^T dO.
"""
from __future__ import annotations

import math
import os

import torch

from .attention import _on_cuda
from .cuda.fused_mha_bias import (fused_mha_bias_bwd_cuda,
                                  fused_mha_bias_fwd_cuda)
from .fused_mha import _packed, _unpack

# the TPU kernel's VMEM budget, kept so the port groups windows exactly as
# the JAX package does (see use_fused_mha_bias)
_VMEM_BUDGET = 10 * 1024 * 1024


def use_fused_mha_bias(s, num_heads, head_dim) -> bool:
    """The JAX gate minus its platform test: whole sublanes per head, S <=
    512, and the TPU kernel's VMEM plan for the resident bias and d(bias)
    blocks at one head per program. That plan means nothing on an H100;
    it is kept verbatim because it decides the window group size W_g
    (Swin tries 8, 4, 2), so the port groups windows exactly as the JAX
    package does. Also head_dim <= 256, the widest head the kernel takes
    (no model of the repo has a wider one). ``PADDLE_TPU_FUSED_MHA_BIAS=0``
    forces the non-fused route."""
    if os.environ.get("PADDLE_TPU_FUSED_MHA_BIAS") == "0":
        return False
    if head_dim % 8 or s > 512 or head_dim > 256:
        return False
    return (num_heads * s * s * 4 + 6 * s * s * 4) <= _VMEM_BUDGET


# the plan's tiles (query rows x keys) and its liveness threshold: the
# values ops/cuda/csrc/fused_mha_bias.cu's PT and kLive hold
PLAN_TILE = 64
PLAN_LIVE = -5e8


# ---------------------------------------------------------- plain versions
def fused_mha_bias_plan(bias):
    """The live-block plan of a bias [R, nh, S, S]: uint8 [R, nh, nt, nt]
    (nt = ceil(S / PLAN_TILE)), 1 where the (query tile, key tile) block
    holds an entry above PLAN_LIVE. A query tile holding a row with no such entry
    keeps every key tile (the full softmax of that row is near-uniform
    over all keys). Read from the bias values alone; the plain twin of the
    kernels' plan pass."""
    r_n, nh, s, _ = bias.shape
    tile = PLAN_TILE
    nt = -(-s // tile)
    pad = nt * tile - s
    live = torch.nn.functional.pad(bias > PLAN_LIVE, (0, pad, 0, pad))
    blocks = live.reshape(r_n, nh, nt, tile, nt, tile)
    plan = blocks.any(dim=5).any(dim=3)
    rows = live.any(dim=-1)[..., :s]                      # [R, nh, S]
    rows = torch.nn.functional.pad(rows, (0, pad), value=True)
    dead = ~rows.reshape(r_n, nh, nt, tile).all(dim=-1)   # a dead row
    plan = plan | dead[..., None]
    return plan.to(torch.uint8)


def _sigma(q, k, bias, scale):
    """f32 softmax [B, nh, S, S] of the f32 scores plus bias[p mod R]."""
    b, s, nh, _ = q.shape
    r_n = bias.shape[0]
    sc = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    # batch row p = t * R + r takes bias[r]
    sc = (sc.reshape(b // r_n, r_n, nh, s, s) + bias.float()).reshape(
        b, nh, s, s)
    m = sc.amax(-1, keepdim=True)
    p = torch.exp(sc - m)
    return p / p.sum(-1, keepdim=True)


def fused_mha_bias_reference(qkv, bias, num_heads, *, scale=None):
    """The plain version of the forward kernel: qkv [B, S, 3F] and bias
    [R, nh, S, S] -> [B, S, F] in qkv's dtype. Differentiable through
    autograd."""
    q, k, v = _unpack(qkv, num_heads)
    b, s, nh, hd = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    p = _sigma(q, k, bias, scale)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return out.reshape(b, s, nh * hd).to(qkv.dtype)


def fused_mha_bias_bwd_reference(qkv, bias, dout, num_heads, *, scale=None):
    """The plain version of the backward kernel: (d(qkv) [B, S, 3F] in
    qkv's dtype, d(bias) [R, nh, S, S] f32) from qkv, the bias and dO
    [B, S, F], as the JAX backward kernel computes them."""
    q, k, v = _unpack(qkv, num_heads)
    b, s, nh, hd = q.shape
    r_n = bias.shape[0]
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    do = dout.to(qkv.dtype).reshape(b, s, nh, hd)
    sigma = _sigma(q, k, bias, scale)
    dsig = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", sigma.to(do.dtype).float(),
                      do.float())
    r = (dsig * sigma).sum(-1, keepdim=True)
    ds_f32 = sigma * (dsig - r)
    dbias = ds_f32.reshape(b // r_n, r_n, nh, s, s).sum(0)
    ds = ds_f32.to(q.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    dqkv = torch.cat([t.reshape(b, s, nh * hd) for t in (dq, dk, dv)],
                     dim=-1).to(qkv.dtype)
    return dqkv, dbias


# ----------------------------------------------------------------- router
class _FusedMHABias(torch.autograd.Function):
    """Forward kernel (or plain forward); the backward recomputes the
    softmax from the saved qkv and bias (plain, f32 kernels) or from the
    forward's row statistics and plan (bf16 kernels)."""

    @staticmethod
    def forward(ctx, qkv, bias, num_heads, scale):
        if _on_cuda(qkv):
            out, ml, plan = fused_mha_bias_fwd_cuda(qkv, bias, num_heads,
                                                    scale=scale)
        else:
            out = fused_mha_bias_reference(qkv, bias, num_heads,
                                           scale=scale)
            ml = plan = None
        ctx.save_for_backward(qkv, bias, ml, plan)
        ctx.num_heads, ctx.scale = num_heads, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, bias, ml, plan = ctx.saved_tensors
        dout = _packed(dout.to(qkv.dtype))
        if _on_cuda(qkv):
            dqkv, dbias = fused_mha_bias_bwd_cuda(
                qkv, bias, dout, ml, plan, ctx.num_heads, scale=ctx.scale)
        else:
            dqkv, dbias = fused_mha_bias_bwd_reference(
                qkv, bias, dout, ctx.num_heads, scale=ctx.scale)
        return dqkv, dbias, None, None


def fused_mha_bias(qkv, num_heads, bias, *, scale=None,
                   heads_per_program=None):
    """Batched-window attention with an additive per-head bias.

    qkv: [B, S, 3 * nh * hd], ``[q heads | k heads | v heads]``.
    bias: [R, nh, S, S] additive logits bias; batch row p uses
        bias[p mod R] (B must be a multiple of R). Differentiable: its
        gradient is summed over the batch rows that share a period index,
        and comes back in the bias's dtype (the kernels work in f32).
    heads_per_program: the TPU kernel's head group per program, a VMEM
        knob. It is checked as the JAX package checks it (nh % G == 0, and
        G * hd a multiple of 128 unless G == nh) and changes nothing here.
        The JAX function's `interpret` flag is TPU-only and not taken.
    Returns [B, S, nh * hd] in qkv's dtype, differentiable in qkv and
    bias."""
    b, s, f3 = qkv.shape
    hd = f3 // 3 // num_heads
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    r_n, bnh, bs1, bs2 = bias.shape
    if bnh != num_heads or bs1 != s or bs2 != s:
        raise ValueError(f"fused_mha_bias: bias {tuple(bias.shape)} does "
                         f"not match (R, {num_heads}, {s}, {s})")
    if b % r_n:
        raise ValueError(f"fused_mha_bias: batch {b} not a multiple of "
                         f"bias period {r_n}")
    g = heads_per_program
    if g and (num_heads % g or ((g * hd) % 128 and g != num_heads)):
        raise ValueError(
            f"fused_mha_bias: heads_per_program={g} invalid for nh="
            f"{num_heads} hd={hd} (need nh%G==0 and (G*hd)%128==0, or "
            f"G==nh)")
    return _FusedMHABias.apply(_packed(qkv), _packed(bias.float()),
                               int(num_heads), float(scale))
