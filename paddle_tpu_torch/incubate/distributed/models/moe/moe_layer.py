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
  index    each kept (token, slot) writes its token into its ``[E * C]``
           slot (a dropped one into a zero row of its own past them; no
           index repeats, so the backward gathers instead of
           accumulating), the experts run on ``[E, C, M]`` as two batched
           matmuls, and one gather of ``[N, k, M]`` rows weighted by
           ``gate_vals * keep`` combines them;
  one-hot  the ``[N, E, C]`` combine and dispatch tensors and three
           einsums.

The batch across ranks. The JAX layer routes the GLOBAL batch: its
capacity counts every token of the step and its slot ranks run over
the global flattened [B, S]. Under a token group of more than one rank
(`distributed.mesh.loss_group`: `TrainStep(mesh=)` sets it to the dp x
sp ranks, which hold different rows or row slices of one batch) the
port computes the same: the capacity of the global token count; each
(token, slot)'s rank in the JAX slot-major order (every slot-0
assignment first; within a slot row by row, a row's slices in sp order
(`token_coords`), position by position), from one all-gather a layer of
the per-(row, slot, expert) counts, which gives each rank its exclusive
prefix; and the aux loss's means over the global tokens (the sum of
probabilities through an all-reduce whose backward all-reduces too, so
the router gets the global gradient). The experts run per token, so
each rank runs its own kept tokens through them.

Expert parallelism: under an ``ep`` mesh axis at construction, or with
`moe_group` a Group, the layer holds E/ep experts (``w1 b1 w2 b2`` cut
on dim 0, marked ``ep_split``; the JAX pspec ``P("ep", ...)``). Every ep
rank of a data-parallel row holds the same tokens (the JAX
``data_axes=("dp",)``), so the routing is computed identically on each;
a rank runs its experts' slots and the expert outputs are all-gathered
over ep (the backward takes the rank's slice). The tokens entering the
expert region pass an identity whose backward all-reduces over ep, so
dx and the router's gradient count every rank's experts.

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
from .....distributed.collective import Group, all_gather, all_reduce
from .....distributed.mesh import axis_group, loss_group
from .....distributed.mpu import _Identity, shard_of
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


def _global_slots(idx, rows: int, num_experts: int, group=None):
    """The JAX slot ranks over the token group's global batch (this
    rank's batch without a group): (locs [N, k] of this rank's (token,
    slot)s, the global slot-0 count per expert [E]). idx [N, k] are the
    rank's expert ids, its tokens [rows, N / rows] row-major; the group's
    `token_coords` give each member's (dp, sp) place (row order without
    them)."""
    n, k = idx.shape
    e = num_experts
    oh = F.one_hot(idx, e).reshape(rows, n // rows, k, e)
    within = torch.cumsum(oh, dim=1) - oh       # earlier positions of a row
    counts = oh.sum(dim=1)
    if group is None:
        counts, coords, rank = counts[None], [(0, 0)], 0
    else:
        counts = all_gather(counts.contiguous(), group=group)
        coords = getattr(group, "token_coords", None) or \
            [(i, 0) for i in range(group.nranks)]
        rank = group.rank
    dp_n = 1 + max(c[0] for c in coords)
    sp_n = 1 + max(c[1] for c in coords)
    grid = counts.new_zeros((dp_n, sp_n, rows, k, e))
    grid[[c[0] for c in coords], [c[1] for c in coords]] = counts
    # [k, segments, E], the segments (dp, row, sp) in the global order
    seg = grid.permute(3, 0, 2, 1, 4).reshape(k, dp_n * rows * sp_n, e)
    before = torch.cumsum(seg, dim=1) - seg
    per_slot = seg.sum(dim=1)                                     # [k, E]
    slot_off = torch.cumsum(per_slot, dim=0) - per_slot
    a, b = coords[rank]
    mine = (a * rows + torch.arange(rows, device=idx.device)) * sp_n + b
    off = (before[:, mine] + slot_off[:, None]).permute(1, 0, 2)  # [r, k, E]
    locs = (within + off[:, None]).gather(
        -1, idx.reshape(rows, n // rows, k, 1))[..., 0]
    return locs.reshape(n, k), per_slot[0]


def _topk_routing(probs, top_k: int, capacity: int, rows: int = 1,
                  group=None):
    """The routing of the tokens [rows, N / rows] (the token group's
    global batch under `group`): (gate_vals, expert ids, capacity slots,
    keep flags) [N, k] and the top-1 fraction per expert [E]. The slots
    rank every slot-0 assignment before every slot-1 assignment
    (`_global_slots`)."""
    n, e = probs.shape
    gate_vals, idx = _topk(probs, top_k)
    locs, top1 = _global_slots(idx, rows, e, group)
    n_all = n * (1 if group is None else group.nranks)
    return gate_vals, idx, locs, locs < capacity, \
        top1.to(probs.dtype) / n_all


def _combine(gate_vals, idx, locs, keeps, num_experts: int, capacity: int):
    """The one-hot combine weights [N, E, C]: each kept (token, slot)'s
    gate value at its expert and slot."""
    w = gate_vals * keeps.to(gate_vals.dtype)
    return (w[:, :, None, None]
            * F.one_hot(idx, num_experts).to(w.dtype)[..., None]
            * F.one_hot(locs.clamp_max(capacity - 1), capacity).to(
                w.dtype)[:, :, None, :]).sum(dim=1)


def _topk_dispatch(probs, top_k: int, capacity: int):
    """The one-hot form of one batch's routing: combine weights [N, E, C],
    the boolean dispatch mask and the top-1 fraction per expert."""
    gate_vals, idx, locs, keeps, frac = _topk_routing(probs, top_k,
                                                      capacity)
    combine = _combine(gate_vals, idx, locs, keeps, probs.shape[1],
                       capacity)
    return combine, combine > 0, frac


class _SumOverGroup(torch.autograd.Function):
    """A sum over the group's ranks whose backward sums the gradients
    too: every rank's loss holds the global term, and the step averages
    the ranks' gradients. Without a group it is the identity."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        if group is not None:
            all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        if ctx.group is not None:
            all_reduce(g, group=ctx.group)
        return g, None


class _GatherExperts(torch.autograd.Function):
    """[E/ep, ...] of each ep rank -> [E, ...]; the backward keeps the
    rank's slice."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather(x.contiguous(), group=group).flatten(0, 1)

    @staticmethod
    def backward(ctx, g):
        gr = ctx.group
        return g.unflatten(0, (gr.nranks, -1))[gr.rank], None


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


def _experts(expert_in, w1, b1, w2, b2, activation, ep_group=None):
    """The experts on their slots [E_local, C, M]; under `ep_group` the
    ranks' outputs gathered into [E, C, M]."""
    h = activation(torch.bmm(expert_in, w1) + b1[:, None, :])
    out = torch.bmm(h, w2) + b2[:, None, :]
    return out if ep_group is None else _GatherExperts.apply(out, ep_group)


def _moe_forward(x, gw, w1, b1, w2, b2, *, top_k, capacity_factor,
                 gate_type, activation, ext_logits=None, ep_group=None,
                 token_group=None):
    """y [B, S, M] in x's dtype and the f32 auxiliary loss. w1 .. b2 hold
    the experts of this ep rank (all of them without `ep_group`);
    `token_group` routes the tokens of its ranks as one batch."""
    b, s, m = x.shape
    e = gw.shape[1]
    n = b * s
    tokens = x.reshape(n, m)
    if ext_logits is None:
        logits = _RouterLogits.apply(tokens, gw)
    else:
        logits = ext_logits.reshape(n, e).float()
    probs = torch.softmax(logits, dim=-1)
    n_all = n * (1 if token_group is None else token_group.nranks)
    cap = _capacity(n_all, e, top_k, capacity_factor)
    me = _SumOverGroup.apply(probs.sum(dim=0), token_group) / n_all
    gate_vals, idx, locs, keeps, frac = _topk_routing(probs, top_k, cap, b,
                                                      token_group)
    if _DROP_REC["on"]:
        _record_keeps(keeps.sum(), keeps.numel())
    # the experts' slice of the slots, and the tokens as the expert
    # region sees them (their gradient summed over the ep ranks)
    lo, hi = 0, e
    x_ep = tokens
    if ep_group is not None:
        lo = ep_group.rank * w1.shape[0]
        hi = lo + w1.shape[0]
        x_ep = _Identity.apply(tokens, ep_group)
    if _gather_mode():
        nk = n * top_k
        # a dropped (token, slot) takes a zero row of its own past the E * C
        # slots, so no index repeats and neither backward accumulates
        # duplicates (one shared row serialises the sort-based backward;
        # under a token group most slots are other ranks')
        pos = torch.where(keeps, idx * cap + locs, e * cap + torch.arange(
            nk, device=x.device).reshape(n, top_k))               # [N, k]
        # each kept token written into its slot (a slot takes at most one)
        slots = x_ep.new_zeros((e * cap + nk, m)).index_put(
            (pos.reshape(-1),), x_ep.repeat_interleave(top_k, dim=0))
        expert_in = slots[lo * cap:hi * cap].reshape(hi - lo, cap, m)
        out = _experts(expert_in, w1, b1, w2, b2, activation, ep_group)
        out_ext = torch.cat([out.reshape(e * cap, m), out.new_zeros((nk, m))])
        rows = out_ext[pos]                                       # [N, k, M]
        w_all = (gate_vals * keeps.to(probs.dtype)).to(x.dtype)
        y = torch.bmm(w_all[:, None, :], rows)[:, 0]
    else:
        combine = _combine(gate_vals, idx, locs, keeps, e, cap)
        expert_in = torch.einsum("nec,nm->ecm",
                                 (combine[:, lo:hi] > 0).to(x.dtype), x_ep)
        out = _experts(expert_in, w1, b1, w2, b2, activation, ep_group)
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
    ``aux_loss``; add it to the training loss. `moe_group` is the
    expert-parallel group (default: the active mesh's ``ep`` group, None
    without one): the layer then holds E / nranks experts (module
    docstring). ``device`` defaults to CUDA (raising without a card);
    the weights draw from ``seed``: Xavier-uniform for ``gate_weight``,
    ``w1`` and ``w2`` (the JAX package's fans, drawn whole and cut under
    ep), zeros for ``b1`` and ``b2``."""

    def __init__(self, d_model: int, d_hidden: int, num_experts: int,
                 gate="gshard", top_k: Optional[int] = None,
                 capacity_factor: float = 1.25, activation=None,
                 moe_group=None, name=None, device=None, dtype=None,
                 seed: int = 0):
        super().__init__()
        if moe_group is None:
            moe_group = axis_group("ep")
        elif not isinstance(moe_group, Group):
            raise TypeError(f"MoELayer(moe_group=...) takes a distributed."
                            f"Group (the expert-parallel ranks); got "
                            f"{type(moe_group).__name__}")
        self.ep_group = moe_group if moe_group is not None and \
            moe_group.nranks > 1 else None
        ep = 1 if self.ep_group is None else self.ep_group.nranks
        if num_experts % ep:
            raise ValueError(f"MoELayer: {num_experts} experts do not split "
                             f"over the {ep} ranks of the ep group")
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
        el = e // ep
        self.gate_weight = nn.Parameter(torch.empty(m, e, **kw))
        self.w1 = nn.Parameter(torch.empty(el, m, h, **kw))
        self.b1 = nn.Parameter(torch.zeros(el, h, **kw))
        self.w2 = nn.Parameter(torch.empty(el, h, m, **kw))
        self.b2 = nn.Parameter(torch.zeros(el, m, **kw))
        g = torch.Generator(device=kw["device"]).manual_seed(seed)
        with torch.no_grad():
            for p in (self.gate_weight, self.w1, self.w2):
                full = torch.empty((e,) + tuple(p.shape[1:]), **kw) \
                    if p is not self.gate_weight and ep > 1 else p
                xavier_uniform_(full, g)
                if full is not p:
                    p.copy_(shard_of(full, 0, 1, self.ep_group.rank, ep))
        if ep > 1:
            for p in (self.w1, self.b1, self.w2, self.b2):
                p.ep_split = (0, 1)

    def forward(self, x, gate_logits=None):
        """x [B, S, M]; `gate_logits` [B, S, E], router logits computed
        elsewhere, route in place of the layer's own projection."""
        tg = loss_group()
        y, self.aux_loss = _moe_forward(
            x, self.gate_weight, self.w1, self.b1, self.w2, self.b2,
            top_k=self.top_k, capacity_factor=self.capacity_factor,
            gate_type=self.gate_type, activation=self._activation,
            ext_logits=gate_logits, ep_group=self.ep_group,
            token_group=tg if tg is not None and tg.nranks > 1 else None)
        return y

    def extra_repr(self):
        return (f"d_model={self.d_model}, d_hidden={self.d_hidden}, "
                f"num_experts={self.num_experts}, gate={self.gate_type}, "
                f"ep={1 if self.ep_group is None else self.ep_group.nranks}, "
                f"top_k={self.top_k}, "
                f"capacity_factor={self.capacity_factor}")
