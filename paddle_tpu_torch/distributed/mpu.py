"""Tensor-parallel layers, "mpu" (the port of paddle_tpu/distributed/mpu.py).

The JAX layers hold the full weight under a PartitionSpec and let XLA's
partitioner insert the collectives. Here, as in the reference
(fleet/layers/mpu/mp_layers.py), each rank holds its own shard and the
layer calls the collectives itself, through four autograd functions over
the ``mp`` group (mp_ops.py):

  _c_identity     identity forward, all-reduce of the gradient backward;
  _mp_allreduce   all-reduce forward, identity backward;
  _c_split        this rank's slice of the last dim forward, all-gather
                  backward;
  _c_concat       all-gather of the last dim forward, this rank's slice
                  backward.

The layers keep ``nn.Linear``'s ``[out, in]`` weights (the transpose of
the JAX ``[in, out]``) and ``nn.Embedding``'s ``[V, H]`` table:

  ColumnParallelLinear   out features split over mp: rank r holds rows
                         [r out/mp, (r+1) out/mp) of the weight and the
                         bias, or, with ``groups`` = g, that slice of each
                         of the g equal groups of out features (GPT's qkv,
                         g = 3: the heads of q, of k and of v);
  RowParallelLinear      in features split: rank r holds that slice of
                         the weight's columns; the partial products are
                         all-reduced, then the replicated bias is added;
  VocabParallelEmbedding rank r holds the contiguous vocabulary rows
                         [r V/mp, (r+1) V/mp): a masked lookup of those
                         ids (others give zeros), all-reduced (the
                         reference's c_embedding);
  ParallelCrossEntropy   cross-entropy of vocab-sharded logits.

A sharded parameter carries ``mp_split = (dim, groups)`` (in place of
Paddle's ``is_distributed`` flag, a name torch tensors already own);
`shard_of` / `gather_shards` cut and rejoin full tensors by that rule. The group is the ``mp_group`` passed in, else the active
mesh's ``mp`` group. Without a mesh, or with one rank on ``mp``, the layers
are exactly ``nn.Linear`` / ``nn.Embedding``: same parameters, same
forward, no collective.

`get_rng_state_tracker` keeps named ``torch.Generator``s (the reference's
RNGStatesTracker): `model_parallel_random_seed` adds a replicated stream
("global_seed": the same on every mp rank, different on each dp rank) and
a local one ("local_seed": different on every rank), and `rng_state(name)`
makes one of them the default generator of its device for a region.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from . import mesh as _mesh
from .collective import Group, ReduceOp, all_gather, all_reduce

MODEL_PARALLEL_RNG = "local_seed"
GLOBAL_RNG = "global_seed"


def resolve_mp_group(group: Optional[Group] = None) -> Optional[Group]:
    """`group` if it has more than one rank, else the active mesh's mp
    group; None where there is nothing to shard over."""
    if group is not None:
        return group if group.nranks > 1 else None
    return _mesh.axis_group("mp")


# ----------------------------------------------------------- shard rules
def shard_of(full: torch.Tensor, dim: int, groups: int, rank: int,
             n: int) -> torch.Tensor:
    """Rank `rank`'s shard of `full` over `n` ranks: dim `dim` seen as
    [groups, n, c], index `rank` of the middle axis (a contiguous slice
    when groups is 1)."""
    size = full.shape[dim]
    if size % (groups * n):
        raise ValueError(f"dim {dim} of {tuple(full.shape)} does not split "
                         f"into {groups} groups over {n} ranks")
    v = full.unflatten(dim, (groups, n, size // (groups * n)))
    return v.select(dim + 1, rank).flatten(dim, dim + 1).contiguous()


def gather_shards(shards, dim: int, groups: int) -> torch.Tensor:
    """The inverse of `shard_of`: the full tensor from every rank's shard
    (in rank order)."""
    c = shards[0].shape[dim] // groups
    st = torch.stack([s.unflatten(dim, (groups, c)) for s in shards],
                     dim=dim + 1)
    return st.flatten(dim, dim + 2)


def _mark(p: torch.Tensor, dim: int, groups: int = 1):
    p.mp_split = (dim, groups)


# ------------------------------------------------- autograd collectives
class _Identity(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        all_reduce(g, group=ctx.group)
        return g, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def _gather_last(x, group, groups):
    parts = all_gather(x.contiguous(), group=group)   # [n, ..., out_local]
    c = x.shape[-1] // groups
    parts = parts.unflatten(-1, (groups, c))          # [n, ..., groups, c]
    return parts.movedim(0, -2).flatten(-3)           # [..., groups*n*c]


def _slice_last(x, group, groups):
    return shard_of(x, x.dim() - 1, groups, group.rank, group.nranks)


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, groups):
        ctx.group, ctx.groups = group, groups
        return _slice_last(x, group, groups)

    @staticmethod
    def backward(ctx, g):
        return _gather_last(g, ctx.group, ctx.groups), None, None


class _Concat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, groups):
        ctx.group, ctx.groups = group, groups
        return _gather_last(x, group, groups)

    @staticmethod
    def backward(ctx, g):
        return _slice_last(g, ctx.group, ctx.groups), None, None


def _c_identity(x, group: Optional[Group] = None):
    g = resolve_mp_group(group)
    return x if g is None else _Identity.apply(x, g)


def _mp_allreduce(x, group: Optional[Group] = None):
    g = resolve_mp_group(group)
    return x if g is None else _AllReduce.apply(x, g)


def _c_split(x, group: Optional[Group] = None, groups: int = 1):
    g = resolve_mp_group(group)
    return x if g is None else _Split.apply(x, g, groups)


def _c_concat(x, group: Optional[Group] = None, groups: int = 1):
    g = resolve_mp_group(group)
    return x if g is None else _Concat.apply(x, g, groups)


# ------------------------------------------------------------- layers
class ColumnParallelLinear(nn.Linear):
    """Reference: mp_layers.py ColumnParallelLinear. y = x W^T + b with the
    out features split over mp (`groups` equal groups split each on its
    own); the output stays split unless `gather_output`."""

    def __init__(self, in_features: int, out_features: int, weight_attr=None,
                 has_bias: bool = True, gather_output: bool = True,
                 fuse_matmul_bias: bool = False, mp_group=None, name=None, *,
                 groups: int = 1, device=None, dtype=None):
        g = resolve_mp_group(mp_group)
        n = 1 if g is None else g.nranks
        if out_features % (groups * n):
            raise ValueError(f"ColumnParallelLinear: {out_features} out "
                             f"features do not split into {groups} groups "
                             f"over {n} ranks")
        super().__init__(in_features, out_features // n, bias=bool(has_bias),
                         device=device, dtype=dtype)
        self.group, self.groups = g, groups
        self.gather_output = gather_output
        self.full_out_features = out_features
        if g is not None:
            _mark(self.weight, 0, groups)
            if self.bias is not None:
                _mark(self.bias, 0, groups)

    def forward(self, x):
        if self.group is None:
            return super().forward(x)
        y = F.linear(_Identity.apply(x, self.group), self.weight, self.bias)
        return _Concat.apply(y, self.group, self.groups) \
            if self.gather_output else y


class RowParallelLinear(nn.Linear):
    """Reference: mp_layers.py RowParallelLinear. The in features are
    split over mp: the input's last dim arrives split
    (`input_is_parallel`) or is split here; the partial products are
    all-reduced and the replicated bias added after."""

    def __init__(self, in_features: int, out_features: int, weight_attr=None,
                 has_bias: bool = True, input_is_parallel: bool = False,
                 fuse_matmul_bias: bool = False, mp_group=None, name=None, *,
                 device=None, dtype=None):
        g = resolve_mp_group(mp_group)
        n = 1 if g is None else g.nranks
        if in_features % n:
            raise ValueError(f"RowParallelLinear: {in_features} in features "
                             f"do not split over {n} ranks")
        super().__init__(in_features // n, out_features, bias=bool(has_bias),
                         device=device, dtype=dtype)
        self.group = g
        self.input_is_parallel = input_is_parallel
        self.full_in_features = in_features
        if g is not None:
            _mark(self.weight, 1)

    def forward(self, x):
        if self.group is None:
            return super().forward(x)
        if not self.input_is_parallel:
            x = _Split.apply(x, self.group, 1)
        y = _AllReduce.apply(F.linear(x, self.weight), self.group)
        return y if self.bias is None else y + self.bias


class VocabParallelEmbedding(nn.Embedding):
    """Reference: mp_layers.py VocabParallelEmbedding. Rank r holds the
    vocabulary rows [vocab_start, vocab_start + V / mp)."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 weight_attr=None, mp_group=None, name=None, *, device=None,
                 dtype=None):
        g = resolve_mp_group(mp_group)
        n = 1 if g is None else g.nranks
        if num_embeddings % n:
            raise ValueError(f"VocabParallelEmbedding: vocabulary "
                             f"{num_embeddings} does not split over {n} "
                             f"ranks")
        super().__init__(num_embeddings // n, embedding_dim, device=device,
                         dtype=dtype)
        self.group = g
        self.full_num_embeddings = num_embeddings
        self.vocab_start = 0 if g is None else g.rank * (num_embeddings // n)
        if g is not None:
            _mark(self.weight, 0)

    def forward(self, ids):
        if self.group is None:
            return super().forward(ids)
        local = ids - self.vocab_start
        outside = (local < 0) | (local >= self.num_embeddings)
        out = F.embedding(local.masked_fill(outside, 0), self.weight)
        out = out.masked_fill(outside[..., None], 0.0)
        return _AllReduce.apply(out, self.group)


class ParallelCrossEntropy(nn.Module):
    """Reference: mp_layers.py ParallelCrossEntropy. Per-token softmax
    cross-entropy in f32 of logits whose last dim is this rank's
    vocabulary slice (all of it without a group): shape labels[..., None],
    0 where the label is `ignore_index`."""

    def __init__(self, mp_group=None, name=None, ignore_index: int = -100):
        super().__init__()
        self.group = resolve_mp_group(mp_group)
        self.ignore_index = ignore_index

    def forward(self, logits, labels):
        lg = logits.float()
        lb = labels[..., None] if labels.dim() == lg.dim() - 1 else labels
        lb = lb.long()
        g = self.group
        if g is None:
            lse = torch.logsumexp(lg, dim=-1, keepdim=True)
            picked = lg.gather(-1, lb.clamp(min=0))
        else:
            v = lg.shape[-1]
            m = lg.detach().amax(dim=-1, keepdim=True)
            all_reduce(m, ReduceOp.MAX, group=g)
            s = _AllReduce.apply((lg - m).exp().sum(-1, keepdim=True), g)
            lse = m + s.log()
            local = lb - g.rank * v
            inside = (local >= 0) & (local < v)
            picked = lg.gather(-1, local.clamp(0, v - 1)) * inside
            picked = _AllReduce.apply(picked, g)
        loss = lse - picked
        return torch.where(lb == self.ignore_index, torch.zeros_like(loss),
                           loss)


def split(x, size, operation: str = "linear", axis: int = 0,
          num_partitions: int = 1, gather_out: bool = True, weight_attr=None,
          bias_attr=None, name=None):
    """Reference: paddle.distributed.split. Builds the tensor-parallel
    layer for `size` on x's device and returns its output: "linear" with
    axis 0 a RowParallelLinear (input split here), axis 1 a
    ColumnParallelLinear; "embedding" a VocabParallelEmbedding."""
    g = resolve_mp_group(None)
    n = 1 if g is None else g.nranks
    if num_partitions not in (1, n):
        raise ValueError(f"split: num_partitions {num_partitions} != the mp "
                         f"degree {n}")
    kw = dict(device=x.device)
    if operation == "linear":
        kw["dtype"] = x.dtype
        has_bias = bias_attr is not False
        layer = RowParallelLinear(size[0], size[1], has_bias=has_bias, **kw) \
            if axis == 0 else ColumnParallelLinear(
                size[0], size[1], has_bias=has_bias, gather_output=gather_out,
                **kw)
    elif operation == "embedding":
        layer = VocabParallelEmbedding(size[0], size[1], **kw)
    else:
        raise ValueError(f"unsupported operation {operation!r}")
    return layer(x)


# ------------------------------------------------------------------ rng
class RNGStatesTracker:
    """Named explicit generators (the reference's RNGStatesTracker)."""

    def __init__(self):
        self._gens: Dict[str, torch.Generator] = {}

    def reset(self):
        self._gens.clear()

    def add(self, name: str, seed: int, device=None):
        if name in self._gens:
            raise ValueError(f"rng state {name!r} already exists")
        g = torch.Generator(device=device or "cpu")
        g.manual_seed(int(seed))
        self._gens[name] = g
        return g

    def get_generator(self, name: str = MODEL_PARALLEL_RNG) -> torch.Generator:
        if name not in self._gens:
            raise KeyError(f"rng state {name!r} was never added")
        return self._gens[name]

    def generators(self) -> tuple:
        return tuple(self._gens.values())

    def get_states_tracker(self) -> Dict[str, torch.Tensor]:
        return {k: g.get_state() for k, g in self._gens.items()}

    def set_states_tracker(self, states: Dict[str, torch.Tensor]):
        for k, s in states.items():
            self._gens[k].set_state(s)

    @contextlib.contextmanager
    def rng_state(self, name: str = MODEL_PARALLEL_RNG):
        """Within the region the default generator of the tracked
        generator's device draws from the tracked stream (which then
        advances); the default stream is restored after."""
        gen = self.get_generator(name)
        cuda = gen.device.type == "cuda"
        idx = gen.device.index if gen.device.index is not None \
            else (torch.cuda.current_device() if cuda else None)
        saved = torch.cuda.get_rng_state(idx) if cuda else \
            torch.get_rng_state()
        (torch.cuda.set_rng_state(gen.get_state(), idx) if cuda
         else torch.set_rng_state(gen.get_state()))
        try:
            yield gen
        finally:
            gen.set_state(torch.cuda.get_rng_state(idx) if cuda
                          else torch.get_rng_state())
            (torch.cuda.set_rng_state(saved, idx) if cuda
             else torch.set_rng_state(saved))


_tracker = RNGStatesTracker()


def get_rng_state_tracker() -> RNGStatesTracker:
    return _tracker


def replicated_seed(seed: int) -> int:
    """The seed of a stream replicated over mp: `seed` on dp rank 0, a
    different one on each other dp rank."""
    return int(seed) + 1000003 * _mesh.mesh_axis_rank("dp")


def model_parallel_random_seed(seed: int = 0, device=None):
    """Reference: fleet.meta_parallel.model_parallel_random_seed. Resets
    the tracker with GLOBAL_RNG (`replicated_seed(seed)`) and
    MODEL_PARALLEL_RNG (different on every rank of the mesh)."""
    _tracker.reset()
    _tracker.add(GLOBAL_RNG, replicated_seed(seed), device)
    _tracker.add(MODEL_PARALLEL_RNG, int(seed) * 1024 + 100 +
                 _mesh.mesh_axis_rank("mp") + 1000003 *
                 _mesh.mesh_axis_rank("dp"), device)
