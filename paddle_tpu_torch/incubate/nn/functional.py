"""Fused LM head + softmax cross-entropy over [B, S, H] hidden states (the
port of paddle_tpu/incubate/nn/functional.py's
`fused_linear_cross_entropy(_array)`).

Where `ops.linear_ce.use_linear_ce` holds, the hidden states flatten into
the fused kernel route (`ops.linear_ce.linear_cross_entropy`: kernel #11
on CUDA, its plain version on the CPU). Otherwise the sequence is cut into
chunks whose f32 logits are recomputed in the backward
(`torch.utils.checkpoint` per chunk, in place of `jax.checkpoint`), so one
chunk of logits is live at a time.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ...ops.linear_ce import linear_cross_entropy, use_linear_ce


def _chunk_loss(xc, weight, lc):
    logits = torch.einsum("bch,vh->bcv", xc, weight).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, lc[..., None].long())[..., 0]
    return lse - gold


def fused_linear_cross_entropy_array(x, weight, labels, *, chunk_size=128,
                                     transpose_weight=False):
    """x [B, S, H]; weight [V, H] ([H, V] with transpose_weight); labels
    [B, S] integer. Returns the per-token loss [B, S] float32."""
    B, S, H = x.shape
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
                               transpose_weight=False, name=None):
    """Tensor-level entry point of fused_linear_cross_entropy_array."""
    return fused_linear_cross_entropy_array(
        x, weight, labels, chunk_size=chunk_size,
        transpose_weight=transpose_weight)
