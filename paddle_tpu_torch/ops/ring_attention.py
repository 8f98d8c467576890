"""Sequence-parallel attention over a mesh axis (the port of
paddle_tpu/ops/ring_attention.py).

Each rank of the mesh's ``sp`` group holds the [B, S/sp, H, D] shards of
q, k and v for its S/sp positions (rank i: positions i S/sp .. (i + 1)
S/sp - 1; H is the rank's heads under ``mp``). Two schedules, as in the
JAX package:

- **ring**: K/V rotate around the group n - 1 times (`collective.rotate`:
  one `batch_isend_irecv` a step, waited for before the next block;
  starting it under the current block measured no gain on four H100s,
  PERF.md). Each block the rank holds runs flash
  attention kernel #6's forward (`flash_fwd_cuda`: out and the f32 row
  logsumexp): the diagonal block causally (its queries and keys share
  positions, so #6's top-left mask is right), earlier blocks without a
  mask, later blocks of a causal ring not at all (in the JAX ring they
  add exact zeros). The blocks' (out, lse) merge in f32 by log-sum-exp.
  The backward rotates K/V again and carries f32 dK/dV accumulators
  around the ring, one more step bringing them home; each block runs #6's
  dQ and dK/dV passes with the MERGED out and lse, so P = exp(s - lse)
  is the block's share of the global softmax and delta = rowsum(dout ·
  out) the global one. A rank keeps O(S/sp) activations, which is what
  the JAX ring's `jax.checkpoint` buys. On CPU tensors the same schedule
  runs #6's plain versions (`flash_forward_reference`,
  `flash_bwd_reference`), so its algebra is tested on the CPU.
- **ulysses**: an all-to-all over the group (`collective.all_to_all_dims`,
  its backward the inverse) re-shards q, k and v from [B, S/n, H, D] to
  [B, S, H/n, D], `functional_attention` (#6 on the card) attends the
  whole sequence for the rank's H/n heads, and the all-to-all back
  returns [B, S/n, H, D].

Routing follows the JAX package: no mesh, no such axis or an axis of one
rank attends the given tensors densely (`functional_attention`, the
JAX fallback's function); an unknown schedule raises; Ulysses whose
rank's head count does not divide by sp takes the ring. The inputs are
the rank's shards, so the JAX check that S divides by sp sits where the
sequence is cut (`models.gpt.GPTModel.forward`).

The port's blocks round each block's output to the input dtype before
the f32 merge (the kernel's output), where the JAX ring keeps f32
accumulators across blocks (ROADMAP C1).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from .attention import _on_cuda, functional_attention
from .cuda.flash_attention import (flash_bwd_dkv_cuda, flash_bwd_dq_cuda,
                                   flash_delta, flash_fwd_cuda)
from .flash_attention import flash_bwd_reference, flash_forward_reference

SCHEDULES = ("ring", "ulysses")


def _block_fwd(q, kb, vb, causal, scale):
    """(out in q's dtype, lse [B, H, s] f32) of q against one K/V block."""
    if _on_cuda(q):
        return flash_fwd_cuda(q, kb, vb, causal=causal, scale=scale)
    return flash_forward_reference(q, kb, vb, causal=causal, scale=scale)


def _block_bwd(q, kb, vb, out, lse, dout, delta, causal, scale):
    """(dq, dk, dv) of one block from the merged out and lse."""
    if _on_cuda(q):
        kw = dict(causal=causal, scale=scale)
        dq = flash_bwd_dq_cuda(q, kb, vb, dout, lse, delta, **kw)
        dk, dv = flash_bwd_dkv_cuda(q, kb, vb, dout, lse, delta, **kw)
        return dq, dk, dv
    return flash_bwd_reference(q, kb, vb, out, lse, dout, causal=causal,
                               scale=scale)


def _merge(acc, lse, out, blk_lse):
    """Fold one block's (out, lse) into the f32 running (acc, lse)."""
    out = out.float()
    if acc is None:
        return out, blk_lse
    new = torch.logaddexp(lse, blk_lse)
    a = torch.exp(lse - new).transpose(1, 2)[..., None]
    b = torch.exp(blk_lse - new).transpose(1, 2)[..., None]
    return acc * a + out * b, new


def _active(src, rank, causal):
    """Whether block `src` reaches the queries of `rank` (a causal ring
    skips the later blocks)."""
    return not causal or src <= rank


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, causal, scale):
        from ..distributed import collective as C
        n, r = group.nranks, group.rank
        kb, vb, acc, lse = k, v, None, None
        for t in range(n):
            if t:
                kb, vb = C.rotate((kb, vb), group)
            src = (r - t) % n
            if _active(src, r, causal):
                acc, lse = _merge(acc, lse, *_block_fwd(
                    q, kb, vb, causal and src == r, scale))
        out = acc.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.group, ctx.causal, ctx.scale = group, causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        from ..distributed import collective as C
        q, k, v, out, lse = ctx.saved_tensors
        group, causal, scale = ctx.group, ctx.causal, ctx.scale
        n, r = group.nranks, group.rank
        dout = dout.to(q.dtype).contiguous()
        delta = flash_delta(out, dout) if _on_cuda(q) else None
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros_like(dk)
        kb, vb = k, v
        for t in range(n):
            if t:
                kb, vb, dk, dv = C.rotate((kb, vb, dk, dv), group)
            src = (r - t) % n
            if _active(src, r, causal):
                bq, bk, bv = _block_bwd(q, kb, vb, out, lse, dout, delta,
                                        causal and src == r, scale)
                dq += bq
                dk += bk
                dv += bv
        # one more step carries each accumulator home to its block's owner
        dk, dv = C.rotate((dk, dv), group)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None)


def _ring(q, k, v, group, causal, scale):
    d = q.shape[-1]
    pad = (-d) % 16 if _on_cuda(q) else 0
    if pad:
        # #6 takes head dims in whole 16-column steps (as flash_attention
        # pads them); zero columns leave the scores as they are
        q, k, v = (F.pad(t, (0, pad)) for t in (q, k, v))
    out = _Ring.apply(q, k, v, group, bool(causal), float(scale))
    return out[..., :d] if pad else out


def _ulysses(q, k, v, group, causal, scale):
    from ..distributed.collective import all_to_all_dims
    # one all-to-all for q, k and v: heads split, the sequence joined
    qkv = all_to_all_dims(torch.stack((q, k, v)), group, 3, 2)
    out = functional_attention(qkv[0], qkv[1], qkv[2], is_causal=causal,
                               scale=scale)
    return all_to_all_dims(out, group, 1, 2)


def _sp_attention(q, k, v, *, axis: str, causal: bool,
                  scale: Optional[float], schedule: Optional[str],
                  group=None):
    """Dispatch on `group` or the active mesh's `axis` group (module
    docstring); q, k and v are the rank's [B, S/sp, H, D] shards."""
    if group is None:
        from ..distributed.mesh import axis_group
        group = axis_group(axis)
    if not schedule or group is None or group.nranks == 1:
        return functional_attention(q, k, v, is_causal=causal, scale=scale)
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown sequence-parallel schedule {schedule!r}; "
                         "expected 'ring', 'ulysses', or None")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if schedule == "ulysses" and q.shape[2] % group.nranks == 0:
        return _ulysses(q, k, v, group, causal, scale)
    # heads that do not divide by sp: the ring always works
    return _ring(q, k, v, group, causal, scale)


def ring_attention(q, k, v, *, axis: str = "sp", is_causal: bool = False,
                   scale: Optional[float] = None, group=None):
    """Ring (blockwise) attention over the rank's sequence shards along
    mesh axis `axis` (or over `group`); dense attention without such an
    axis, so the same model runs on one card."""
    return _sp_attention(q, k, v, axis=axis, causal=is_causal, scale=scale,
                         schedule="ring", group=group)


def ulysses_attention(q, k, v, *, axis: str = "sp", is_causal: bool = False,
                      scale: Optional[float] = None, group=None):
    """DeepSpeed-Ulysses-style head all-to-all sequence parallelism."""
    return _sp_attention(q, k, v, axis=axis, causal=is_causal, scale=scale,
                         schedule="ulysses", group=group)


def sequence_parallel_attention(q, k, v, *, axis: str = "sp",
                                is_causal: bool = False,
                                scale: Optional[float] = None,
                                schedule: str = "ring", group=None):
    """The generic entry: `schedule` in {"ring", "ulysses"}."""
    return _sp_attention(q, k, v, axis=axis, causal=is_causal, scale=scale,
                         schedule=schedule, group=group)
