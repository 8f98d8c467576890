"""Mixture-of-experts layer (the port of
paddle_tpu/incubate/distributed/models/moe/moe_layer.py): GShard-style
top-k routing with a static expert capacity, the experts stacked as
``w1 [E, M, H]``, ``b1 [E, H]``, ``w2 [E, H, M]``, ``b2 [E, M]`` and the
router ``gate_weight [M, E]`` (the JAX package's names and shapes, so state
dicts line up).

The router logits are f32 products of the tokens and ``gate_weight``
(bf16 operands keep the card's f32 accumulator), softmaxed into probs.
Each token picks its top-k experts (ties to the lower expert index, as
``lax.top_k`` breaks them); top-k > 1 renormalises the picked
probabilities, top-1 (the switch gate) keeps the raw one so the router
learns from the task loss. Assignments are ranked slot-major: every
slot-0 assignment outranks every slot-1 assignment, and an assignment
whose rank within its expert reaches the capacity ``_capacity(N, E, k,
cf)`` is dropped.

Two routes compute the same function, picked by PADDLE_TPU_MOE_GATHER as
in the JAX package (unset or "1": the index route; any other value: the
one-hot route):
  index    each kept (token, slot) id is scattered into its ``[E * C]``
           slot (dropped ones to a sentinel, empty slots read an appended
           zero row), the tokens are gathered into ``[E, C, M]``, the
           experts run as two batched matmuls, and one gather of ``[N, k,
           M]`` rows weighted by ``gate_vals * keep`` combines them;
  one-hot  the ``[N, E, C]`` combine and dispatch tensors and three
           einsums.
The JAX package's expert-parallel sharding constraints (and its
old-runtime partitioner workaround) have no counterpart on one device.

The load-balance auxiliary loss (gshard, switch) is ``E * sum_e
mean(probs)_e * frac_e`` with frac the top-1 slot's share per expert; the
naive gate's is 0. It is left on the layer as ``aux_loss`` (f32).
Gradients reach the router through the combine weights and the aux loss,
never through the integer routing.

Drop-rate telemetry: `record_drop_rate(True)` resets and enables a count
of kept and assigned (token, slot) pairs over every forward until
`record_drop_rate(False)`; `measured_drop_rate()` reads it. While it is
off it costs nothing; while it is on each forward syncs the host once.
A checkpoint region being recomputed in the backward is not counted.
"""
from __future__ import annotations

import functools
import math
import os
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .....device import resolve_device
from .....distributed.recompute import replaying
from .....nn.initializer import xavier_uniform_
from .....ops.linear_ce import _mm_f32
from .gate import BaseGate

__all__ = ["MoELayer", "record_drop_rate", "measured_drop_rate"]


def _capacity(num_tokens: int, num_experts: int, top_k: int,
              capacity_factor: float) -> int:
    """Slots per expert: ceil(cf * k * N / E) padded up to a multiple of
    4, at least 4."""
    c = int(math.ceil(capacity_factor * top_k * num_tokens / num_experts))
    return max(4, c + (-c) % 4)


_DROP_REC = {"on": False, "kept": 0, "assigned": 0}


def record_drop_rate(on: bool = True):
    """Toggle (and reset) the drop-rate count."""
    _DROP_REC.update(on=bool(on), kept=0, assigned=0)


def measured_drop_rate():
    """The fraction of (token, slot) assignments dropped since the count
    was enabled, or None if no forward was counted."""
    a = _DROP_REC["assigned"]
    return None if a == 0 else 1.0 - _DROP_REC["kept"] / a


def _record_keeps(kept, assigned):
    if _DROP_REC["on"] and not replaying():
        _DROP_REC["kept"] += int(kept)
        _DROP_REC["assigned"] += int(assigned)


def _topk(probs, top_k: int):
    """(gate values, expert ids) [N, k] of the top-k probabilities, ties
    to the lower expert id (a stable descending sort); top-k > 1
    renormalises the values over the picked experts."""
    idx = torch.sort(probs, dim=-1, descending=True,
                     stable=True).indices[:, :top_k]
    gate_vals = probs.gather(1, idx)
    if top_k > 1:
        denom = gate_vals.sum(dim=-1, keepdim=True)
        gate_vals = gate_vals / torch.clamp(denom, min=1e-9)
    return gate_vals, idx


def _topk_routing(probs, top_k: int, capacity: int):
    """The index form of the routing: (gate_vals, expert ids, capacity
    slots, keep flags) [N, k] and the top-1 fraction per expert [E]. One
    cumulative count over the slot-major flattening ranks every slot-0
    assignment before every slot-1 assignment."""
    n, e = probs.shape
    gate_vals, idx = _topk(probs, top_k)
    flat = idx.t().reshape(-1)                                   # [k * N]
    ohf = F.one_hot(flat, e)
    frac_top1 = ohf[:n].to(probs.dtype).mean(dim=0)
    pos = torch.cumsum(ohf, dim=0) - 1
    locs = pos.gather(1, flat[:, None])[:, 0].reshape(top_k, n).t()
    return gate_vals, idx, locs, locs < capacity, frac_top1


def _topk_dispatch(probs, top_k: int, capacity: int):
    """The one-hot form: combine weights [N, E, C], the boolean dispatch
    mask and the top-1 fraction per expert."""
    n, e = probs.shape
    gate_vals, idx = _topk(probs, top_k)
    slots = torch.arange(capacity, device=probs.device)
    combine = probs.new_zeros((n, e, capacity))
    counts = torch.zeros(e, dtype=torch.long, device=probs.device)
    frac_top1 = None
    for slot in range(top_k):
        oh = F.one_hot(idx[:, slot], e)                          # [N, E]
        if frac_top1 is None:
            frac_top1 = oh.to(probs.dtype).mean(dim=0)
        pos = torch.cumsum(oh, dim=0) - 1 + counts
        counts = counts + oh.sum(dim=0)
        loc = (pos * oh).sum(dim=-1)                             # [N]
        keep = (loc < capacity).to(probs.dtype)
        loc_oh = (loc[:, None] == slots).to(probs.dtype)         # [N, C]
        combine = combine + (gate_vals[:, slot] * keep)[:, None, None] \
            * oh.to(probs.dtype)[:, :, None] * loc_oh[:, None, :]
    return combine, combine > 0, frac_top1


class _RouterLogits(torch.autograd.Function):
    """tokens [N, M] @ gate_weight [M, E] with an f32 result; the
    gradients are f32 products rounded to each operand's dtype."""

    @staticmethod
    def forward(ctx, tokens, gw):
        ctx.save_for_backward(tokens, gw)
        return _mm_f32(tokens, gw)

    @staticmethod
    def backward(ctx, g):
        tokens, gw = ctx.saved_tensors
        g = g.float()
        d_tok = (g @ gw.float().t()).to(tokens.dtype) \
            if ctx.needs_input_grad[0] else None
        d_gw = (tokens.float().t() @ g).to(gw.dtype) \
            if ctx.needs_input_grad[1] else None
        return d_tok, d_gw


def _gather_mode() -> bool:
    env = os.environ.get("PADDLE_TPU_MOE_GATHER")
    return True if env is None else env == "1"


def _experts(expert_in, w1, b1, w2, b2, activation):
    h = activation(torch.bmm(expert_in, w1) + b1[:, None, :])
    return torch.bmm(h, w2) + b2[:, None, :]


def _moe_forward(x, gw, w1, b1, w2, b2, *, top_k, capacity_factor,
                 gate_type, activation, ext_logits=None):
    """y [B, S, M] in x's dtype and the f32 auxiliary loss."""
    b, s, m = x.shape
    e = w1.shape[0]
    n = b * s
    tokens = x.reshape(n, m)
    if ext_logits is None:
        logits = _RouterLogits.apply(tokens, gw)
    else:
        logits = ext_logits.reshape(n, e).float()
    probs = torch.softmax(logits, dim=-1)
    cap = _capacity(n, e, top_k, capacity_factor)
    me = probs.mean(dim=0)
    if _gather_mode():
        gate_vals, idx, locs, keeps, frac = _topk_routing(probs, top_k, cap)
        if _DROP_REC["on"]:
            _record_keeps(keeps.sum(), keeps.numel())
        safe_pos = torch.where(keeps, idx * cap + locs,
                               torch.full_like(idx, e * cap))     # [N, k]
        tok_ids = torch.arange(n, device=x.device)[:, None].expand(n, top_k)
        src = torch.full((e * cap + 1,), n, dtype=torch.long,
                         device=x.device)
        src.scatter_(0, safe_pos.reshape(-1), tok_ids.reshape(-1))
        tokens_ext = torch.cat([tokens, tokens.new_zeros((1, m))])
        expert_in = tokens_ext[src[:e * cap]].reshape(e, cap, m)
        out = _experts(expert_in, w1, b1, w2, b2, activation)
        out_ext = torch.cat([out.reshape(e * cap, m), out.new_zeros((1, m))])
        rows = out_ext[safe_pos]                                  # [N, k, M]
        w_all = (gate_vals * keeps.to(probs.dtype)).to(x.dtype)
        y = torch.bmm(w_all[:, None, :], rows)[:, 0]
    else:
        combine, dispatch, frac = _topk_dispatch(probs, top_k, cap)
        if _DROP_REC["on"]:
            _record_keeps(dispatch.sum(), n * top_k)
        expert_in = torch.einsum("nec,nm->ecm", dispatch.to(x.dtype), tokens)
        out = _experts(expert_in, w1, b1, w2, b2, activation)
        y = torch.einsum("nec,ecm->nm", combine.to(x.dtype), out)
    if gate_type in ("gshard", "switch"):
        aux = e * (me * frac).sum()
    else:
        aux = probs.new_zeros(())
    return y.reshape(b, s, m), aux.float()


_GELU = functools.partial(F.gelu, approximate="tanh")


class MoELayer(nn.Module):
    """Top-k routed expert FFN. `gate`: "naive" (top-k, no aux loss),
    "gshard" (top-2 and the load-balance loss), "switch" (top-1 and the
    load-balance loss), or a `BaseGate`. `activation` defaults to the tanh
    GELU (``jax.nn.gelu``'s default). The aux loss of the latest forward is
    ``aux_loss``; add it to the training loss. `moe_group` (the JAX
    package's expert-parallel group) has no counterpart on one device and
    must be None. ``device`` defaults to CUDA (raising without a card);
    the weights draw from ``seed``: Xavier-uniform for ``gate_weight``,
    ``w1`` and ``w2`` (the JAX package's fans), zeros for ``b1`` and
    ``b2``."""

    def __init__(self, d_model: int, d_hidden: int, num_experts: int,
                 gate="gshard", top_k: Optional[int] = None,
                 capacity_factor: float = 1.25, activation=None,
                 moe_group=None, name=None, device=None, dtype=None,
                 seed: int = 0):
        super().__init__()
        if moe_group is not None:
            raise NotImplementedError(
                "MoELayer(moe_group=...): expert parallelism across devices "
                "comes with a later multi-GPU slice (ROADMAP.md, queue item "
                "A4); the layer runs all experts on one device")
        if isinstance(gate, BaseGate):
            if top_k is None:
                top_k = gate.top_k
            gate = gate.gate_type
        if gate not in ("naive", "gshard", "switch"):
            raise ValueError(f"unknown gate {gate!r}")
        self.d_model, self.d_hidden = d_model, d_hidden
        self.num_experts = num_experts
        self.gate_type = gate
        self.top_k = top_k if top_k is not None else \
            (1 if gate == "switch" else 2)
        if gate == "switch" and self.top_k != 1:
            raise ValueError("switch gate is top-1 by definition")
        self.capacity_factor = capacity_factor
        self._activation = activation if activation is not None else _GELU
        self.aux_loss = None
        kw = dict(device=resolve_device(device),
                  dtype=dtype or torch.float32)
        e, m, h = num_experts, d_model, d_hidden
        self.gate_weight = nn.Parameter(torch.empty(m, e, **kw))
        self.w1 = nn.Parameter(torch.empty(e, m, h, **kw))
        self.b1 = nn.Parameter(torch.zeros(e, h, **kw))
        self.w2 = nn.Parameter(torch.empty(e, h, m, **kw))
        self.b2 = nn.Parameter(torch.zeros(e, m, **kw))
        g = torch.Generator(device=kw["device"]).manual_seed(seed)
        for p in (self.gate_weight, self.w1, self.w2):
            xavier_uniform_(p, g)

    def forward(self, x, gate_logits=None):
        """x [B, S, M]; `gate_logits` [B, S, E], router logits computed
        elsewhere, route in place of the layer's own projection."""
        y, self.aux_loss = _moe_forward(
            x, self.gate_weight, self.w1, self.b1, self.w2, self.b2,
            top_k=self.top_k, capacity_factor=self.capacity_factor,
            gate_type=self.gate_type, activation=self._activation,
            ext_logits=gate_logits)
        return y

    def extra_repr(self):
        return (f"d_model={self.d_model}, d_hidden={self.d_hidden}, "
                f"num_experts={self.num_experts}, gate={self.gate_type}, "
                f"top_k={self.top_k}, "
                f"capacity_factor={self.capacity_factor}")
