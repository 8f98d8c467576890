"""Fused functional ops (the port of paddle_tpu/incubate/nn/functional.py).

`fused_matmul_bias`, `fused_linear` and
`fused_bias_dropout_residual_layer_norm` are plain tensor expressions, as
in the JAX package, whose "fusion" is an XLA property and which has no
Pallas kernel for them. `_ln` (a two-pass LayerNorm, like ``jnp.var``) and
`_drop` (inverted dropout with its mask drawn from a ``torch.Generator``)
are shared with the fused transformer layers.

`fused_linear_cross_entropy` is the fused LM head + softmax
cross-entropy over [B, S, H] hidden states. Where
`ops.linear_ce.use_linear_ce` holds, the hidden states flatten into the
fused kernel route (`ops.linear_ce.linear_cross_entropy`: kernel #11 on
CUDA, its plain version on the CPU). Otherwise the sequence is cut into
chunks whose f32 logits are recomputed in the backward
(`torch.utils.checkpoint` per chunk, in place of `jax.checkpoint`), so one
chunk of logits is live at a time. With an ``mp_group`` of more than one
rank, `weight` is this rank's contiguous vocabulary shard and the loss runs
the vocab-parallel route (`ops.linear_ce.vocab_parallel_linear_cross_entropy`:
the same forward per shard, kernel #11 on CUDA, merged over the group) at
any shape.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ...ops.linear_ce import (linear_cross_entropy, use_linear_ce,
                              vocab_parallel_linear_cross_entropy)


def _ln(x, scale, bias, eps):
    """LayerNorm over the last dim with the variance taken about the mean
    (two passes), then the optional scale and bias."""
    mu = x.mean(dim=-1, keepdim=True)
    xc = x - mu
    y = xc * torch.rsqrt(xc.square().mean(dim=-1, keepdim=True) + eps)
    if scale is not None:
        y = y * scale
    if bias is not None:
        y = y + bias
    return y


def _drop(x, p, generator=None):
    """Inverted dropout: keep with probability 1 - p (a draw from
    `generator`, the default generator when None), kept entries scaled by
    1 / (1 - p). p == 0 returns x."""
    if not p:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) \
        < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def fused_matmul_bias(x, y, bias=None, transpose_x=False, transpose_y=False,
                      name=None):
    """x @ y (either operand transposed over its last two dims first),
    plus `bias`."""
    if transpose_x:
        x = x.transpose(-1, -2)
    if transpose_y:
        y = y.transpose(-1, -2)
    out = x @ y
    return out if bias is None else out + bias


def fused_linear(x, weight, bias=None, transpose_weight=False, name=None):
    """x @ weight + bias with weight [in, out] ([out, in] under
    transpose_weight), the JAX package's layout."""
    return fused_matmul_bias(x, weight, bias, transpose_y=transpose_weight)


def fused_bias_dropout_residual_layer_norm(
        x, residual, bias=None, ln_scale=None, ln_bias=None,
        dropout_rate=0.5, ln_epsilon=1e-5, training=True, name=None,
        generator=None):
    """LayerNorm(residual + dropout(x + bias)); dropout only where
    `training` and dropout_rate > 0, its mask drawn from `generator`."""
    if bias is not None:
        x = x + bias
    x = _drop(x, dropout_rate if training else 0.0, generator)
    return _ln(x + residual, ln_scale, ln_bias, ln_epsilon)


def _chunk_loss(xc, weight, lc):
    logits = torch.einsum("bch,vh->bcv", xc, weight).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, lc[..., None].long())[..., 0]
    return lse - gold


def fused_linear_cross_entropy_array(x, weight, labels, *, chunk_size=128,
                                     transpose_weight=False, mp_group=None):
    """x [B, S, H]; weight [V, H] ([H, V] with transpose_weight), or this
    rank's vocabulary shard of it under an `mp_group` of more than one
    rank; labels [B, S] integer. Returns the per-token loss [B, S]
    float32."""
    B, S, H = x.shape
    if mp_group is not None and mp_group.nranks > 1:
        per_tok = vocab_parallel_linear_cross_entropy(
            x.reshape(B * S, H), weight, labels.reshape(B * S), mp_group,
            w_layout="hv" if transpose_weight else "vh")
        return per_tok.reshape(B, S)
    V = weight.shape[-1] if transpose_weight else weight.shape[0]
    if weight.dim() == 2 and use_linear_ce(B * S, H, V):
        per_tok = linear_cross_entropy(
            x.reshape(B * S, H), weight, labels.reshape(B * S),
            w_layout="hv" if transpose_weight else "vh")
        return per_tok.reshape(B, S)
    if transpose_weight:
        weight = weight.t()
    C = min(chunk_size, S)
    while S % C:
        C -= 1
    losses = [checkpoint(_chunk_loss, x[:, c:c + C], weight,
                         labels[:, c:c + C], use_reentrant=False)
              for c in range(0, S, C)]
    return torch.cat(losses, dim=1)


def fused_linear_cross_entropy(x, weight, labels, chunk_size=128,
                               transpose_weight=False, name=None,
                               mp_group=None):
    """Tensor-level entry point of fused_linear_cross_entropy_array."""
    return fused_linear_cross_entropy_array(
        x, weight, labels, chunk_size=chunk_size,
        transpose_weight=transpose_weight, mp_group=mp_group)
