"""Group sharding, ZeRO stages 1-3 (the port of
paddle_tpu/distributed/sharding.py).

Reference: the dygraph group-sharded stack: GroupShardedOptimizerStage2
(optimizer state), GroupShardedStage2 (gradients), GroupShardedStage3
(parameters, gathered on use), and the public `group_sharded_parallel`.

The JAX package marks the optimizer (`shard_optimizer_state`) and the
parameters (`shard_parameter_specs`) and lets XLA's partitioner shard
them. The port keeps the marks and runs ZeRO itself on `jit.TrainStep`,
which reads them (`ZeroRuntime`), over the shard axis: ``sdp`` when the
mesh has it with more than one rank, else ``dp``.

Layout: whole-parameter ownership (the reference's ``param2rank``). The
trainable parameters, in the model's order, are cut into contiguous runs
of about equal bytes, one run a rank of the shard group; a rank keeps the
optimizer state of its own run only. A whole parameter never straddles
two ranks, so the int8 Adam moments (blocks of 2048 in the JAX element
order, an ``nn.Linear`` weight's transpose) are the unsharded step's codes
with no alignment rule, and the owner's update is the one-card update
of the same gradient.

  stage 1 ("os")     gradients averaged over the data axis as without
                     ZeRO; each rank updates its own parameters and
                     optimizer state, then every parameter is broadcast
                     from its owner (in buckets);
  stage 2 ("os_g")   + the gradients of a run are reduced to its owner
                     as the backward lands them (a reduce in place of the
                     all-reduce: the reduce-scatter's traffic), and the
                     other ranks drop them;
  stage 3 ("p_g_os") + a rank holds only its own parameters' data; the
                     others are gathered (broadcast from their owners)
                     before each unit's forward and again before its
                     backward, then freed. A unit is an element of a
                     ModuleList (a transformer block); the parameters
                     outside every unit are gathered for the whole step.

When the data axis is not the shard axis (a ``{"dp": 2, "sdp": 2}``
mesh), the shard ranks see the same rows: a rank averages its own
parameters' gradients over the data axis and drops the others.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence

import torch

from . import mesh as _mesh
from .collective import BUCKET_BYTES, Group, all_reduce, broadcast, reduce

_LEVELS = {"os": 1, "os_g": 2, "p_g_os": 3}


def shard_parameter_specs(model, axis: str = "sdp"):
    """Stage-3 mark: TrainStep holds each trainable parameter of `model`
    on its owner alone (see the module docstring); without it a stage-3
    optimizer shards state and gradients only, as in the JAX package.
    No mark at one rank of `axis`."""
    if _mesh.mesh_axis_size(axis) <= 1:
        return model
    model._zero_param_axis = axis
    return model


def shard_optimizer_state(optimizer, stage: int = 1, axis: str = "sdp"):
    """Stages 1-2 mark: TrainStep shards `optimizer`'s state over `axis`
    (reference: GroupShardedOptimizerStage2's param2rank)."""
    optimizer._sharding_stage = int(stage)
    optimizer._sharding_axis = axis
    return optimizer


def group_sharded_parallel(model, optimizer, level: str = "os_g",
                           scaler=None, group=None, offload: bool = False,
                           sync_buffers: bool = False,
                           buffer_max_size: int = 0, segment_size: int = 0,
                           sync_comm: bool = False):
    """Reference: distributed/sharding/group_sharded.py, same signature;
    returns (model, optimizer, scaler). `level` is "os", "os_g" or
    "p_g_os"; the other options are accepted and unused, as in the JAX
    package."""
    stage = _LEVELS.get(level)
    if stage is None:
        raise ValueError(f"level must be one of {list(_LEVELS)}, got "
                         f"{level!r}")
    axis = "sdp" if _mesh.mesh_axis_size("sdp") > 1 else "dp"
    shard_optimizer_state(optimizer, stage=stage, axis=axis)
    if stage >= 3:
        shard_parameter_specs(model, axis=axis)
    return model, optimizer, scaler


def contiguous_owners(sizes: Sequence[int], n: int) -> List[int]:
    """The owner (0..n-1) of each item: contiguous runs in order, cut
    where the running total crosses a multiple of total / n (an item
    goes to the run its middle byte falls in)."""
    total = float(sum(sizes)) or 1.0
    out, acc, last = [], 0.0, 0
    for s in sizes:
        r = min(n - 1, int((acc + s / 2.0) * n / total))
        last = max(last, r)
        out.append(last)
        acc += s
    return out


def _runs(idxs, key, nbytes, limit=BUCKET_BYTES):
    """idxs cut into runs of equal key(i), each at most `limit` bytes (a
    larger item alone)."""
    runs, cur, size = [], [], 0
    for i in idxs:
        if cur and (key(i) != key(cur[0]) or size + nbytes(i) > limit):
            runs.append(cur)
            cur, size = [], 0
        cur.append(i)
        size += nbytes(i)
    if cur:
        runs.append(cur)
    return runs


def _in_backward() -> bool:
    return torch._C._current_graph_task_id() != -1


def _free(p):
    p.data.untyped_storage().resize_(0)


class ZeroRuntime:
    """The ZeRO runtime of one TrainStep (see the module docstring).
    `params` are the step's trainable parameters in order; `group` is
    this rank's shard group (None at one rank: every parameter is then
    this rank's, and the stage runs with no collective), `data_group`
    the group the batch is split over (None when it has one rank) and
    `gather_group` a second communicator over the shard group's ranks
    that carries stage 3's gathers, so that they never queue behind the
    gradient reduces."""

    def __init__(self, stage: int, names, params, group: Optional[Group],
                 data_group: Optional[Group] = None, model=None,
                 gather_group: Optional[Group] = None):
        self.stage = int(stage)
        self.names, self.params = list(names), list(params)
        self.index = {n: i for i, n in enumerate(self.names)}
        self.group, self.data_group = group, data_group
        self.gather_group = gather_group or group
        self.degree = 1 if group is None else group.nranks
        self.rank = 0 if group is None else group.rank
        nb = [p.numel() * p.element_size() for p in self.params]
        self.owner = contiguous_owners(nb, self.degree)
        self.owned = [o == self.rank for o in self.owner]
        # the gradient exchange is a reduce to the owner when the batch is
        # split over the shard axis itself
        self.reduce_mode = group is not None and data_group is not None \
            and data_group.ranks == group.ranks
        key = (lambda i: (self.owner[i], self.params[i].dtype))
        order = list(range(len(self.params)))
        # stage 1/2's parameter broadcast buckets, stage >= 2's gradient
        # units (in the order the backward lands them)
        self.buckets = _runs(order, key, nb.__getitem__)
        self.units = [sorted(u) for u in _runs(order[::-1], key,
                                               nb.__getitem__)]
        self.live = [True] * len(self.params)
        self.root3: List[int] = []
        if self.stage >= 3:
            self._install(model)

    # ------------------------------------------------------- placement
    def src(self, i) -> int:
        """The global rank of parameter i's owner."""
        return self.owner[i] if self.group is None else \
            self.group.ranks[self.owner[i]]

    # ------------------------------------------- stage 2: the gradients
    def issue(self, k: int, grads):
        """Start unit k's exchange; `grads` maps its indices to this
        rank's gradients."""
        idxs = self.units[k]
        flat = torch.cat([grads[i].reshape(-1) for i in idxs])
        work = None
        if self.reduce_mode:
            work = reduce(flat, self.src(idxs[0]), group=self.group,
                          sync_op=False, keep_input=False)
        elif self.owned[idxs[0]] and self.data_group is not None:
            work = all_reduce(flat, group=self.data_group, sync_op=False)
        if not self.owned[idxs[0]]:
            flat = None          # the collective keeps its buffer alive
        return idxs, flat, work

    def finish(self, pending, out):
        """Wait for a unit; the owner's averaged gradients land in out."""
        idxs, flat, work = pending
        if work is not None:
            work.wait()
        if flat is None:
            return out
        d = 1 if self.data_group is None else self.data_group.nranks
        if d > 1:
            flat.div_(d)
        off = 0
        for i in idxs:
            n = self.params[i].numel()
            out[i] = flat[off:off + n].view(self.params[i].shape)
            off += n
        return out

    # ------------------------------------- stages 1/2: the parameters
    @torch.no_grad()
    def broadcast_params(self):
        """Every parameter from its owner, in buckets (after an update)."""
        if self.group is None:
            return
        for idxs in self.buckets:
            src = self.src(idxs[0])
            ps = [self.params[i] for i in idxs]
            flat = torch.cat([p.reshape(-1) for p in ps])
            broadcast(flat, src=src, group=self.group)
            if not self.owned[idxs[0]]:
                off = 0
                for p in ps:
                    p.copy_(flat[off:off + p.numel()].view(p.shape))
                    off += p.numel()

    # ------------------------------------------ stage 3: the parameters
    def _install(self, model):
        """Units from the model's ModuleLists; free what is not ours and
        wrap each unit's forward (and recompute_segments) to gather on
        use."""
        if model is None:
            raise ValueError("ZeRO stage 3 needs the model")
        for n, p in zip(self.names, self.params):
            if not p.is_contiguous() or p.storage_offset() != 0 or \
                    p.untyped_storage().nbytes() != p.numel() * \
                    p.element_size():
                raise ValueError(f"ZeRO stage 3: parameter {n} does not own "
                                 f"its storage whole (a view or a slice)")
        by_id = {id(p): i for i, p in enumerate(self.params)}
        taken, units = set(), []
        for name, mod in model.named_modules():
            if not isinstance(mod, torch.nn.ModuleList) or any(
                    name.startswith(t + ".") or name == t for t in taken):
                continue
            for j, child in enumerate(mod):
                idxs = sorted(by_id[id(p)] for p in child.parameters()
                              if id(p) in by_id)
                if idxs:
                    units.append((child, idxs))
            taken.add(name)
        inside = {i for _, idxs in units for i in idxs}
        self.root3 = [i for i in range(len(self.params)) if i not in inside]
        for child, idxs in units:
            for attr in ("forward", "recompute_segments"):
                if hasattr(child, attr):
                    setattr(child, attr, self._wrapped(getattr(child, attr),
                                                       idxs))
        self.free(list(range(len(self.params))))

    def _wrapped(self, inner, idxs):
        def run(*a, **kw):
            self.gather(idxs)
            out = inner(*a, **kw)
            if not _in_backward():
                self._after_forward(idxs, out)
            return out
        return run

    def _after_forward(self, idxs, out):
        """Free the unit; in a graph, gather it again when the backward
        reaches its output."""
        outs = out if isinstance(out, (tuple, list)) else (out,)
        t = next((o for o in outs if torch.is_tensor(o) and
                  o.requires_grad), None)
        if t is not None:
            t.register_hook(lambda g: self.gather(idxs))
        self.free(idxs)

    @torch.no_grad()
    def gather(self, idxs):
        """Make parameters idxs whole on every rank: each run of one
        owner broadcast from it. Every rank of the shard group calls it
        at the same point, so the runs agree."""
        todo = [i for i in idxs if not self.live[i]]
        if not todo:
            return None
        nb = lambda i: self.params[i].numel() * \
            self.params[i].element_size()          # noqa: E731
        for run in _runs(todo, lambda i: (self.owner[i],
                                          self.params[i].dtype), nb):
            ps = [self.params[i] for i in run]
            mine = self.owned[run[0]]
            if mine:
                flat = torch.cat([p.reshape(-1) for p in ps])
            else:
                for p in ps:
                    p.data.untyped_storage().resize_(p.numel() *
                                                     p.element_size())
                flat = torch.empty(sum(p.numel() for p in ps),
                                   dtype=ps[0].dtype, device=ps[0].device)
            if self.gather_group is not None:
                broadcast(flat, src=self.src(run[0]),
                          group=self.gather_group)
            if not mine:
                off = 0
                for p in ps:
                    p.data.copy_(flat[off:off + p.numel()].view(p.shape))
                    off += p.numel()
        for i in todo:
            self.live[i] = True
        return None

    def free(self, idxs):
        """Drop the data of the parameters idxs that are not this rank's
        (stage 3)."""
        for i in idxs:
            if self.live[i]:
                self.live[i] = False
                if not self.owned[i]:
                    _free(self.params[i])

    def gather_root(self):
        """The parameters outside every unit, gathered for the step."""
        self.gather(self.root3)

    @contextlib.contextmanager
    def gathered(self):
        """Every parameter whole inside the block (an evaluation forward
        or a checkpoint read); freed again after."""
        if self.stage < 3:
            yield
            return
        every = list(range(len(self.params)))
        self.gather(every)
        try:
            yield
        finally:
            self.free(every)

    # ------------------------------------------------- whole tensors
    @torch.no_grad()
    def full_param(self, i) -> torch.Tensor:
        """A whole copy of parameter i on every rank (collective under
        stage 3)."""
        if self.stage < 3 or self.live[i]:
            return self.params[i].detach().clone()
        self.gather([i])
        out = self.params[i].detach().clone()
        self.free([i])
        return out

    @torch.no_grad()
    def full_state(self, i, state, template) -> Dict[str, torch.Tensor]:
        """Parameter i's optimizer state on every rank, broadcast from its
        owner (`template()` makes a rank's zero state of the same
        layout)."""
        st = state if self.owned[i] else template()
        out = {}
        for k in sorted(st):
            v = st[k].detach().clone() if self.owned[i] else st[k]
            if self.group is not None:
                broadcast(v, src=self.src(i), group=self.group)
            out[k] = v
        return out
