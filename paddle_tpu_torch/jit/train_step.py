"""The training step (the port of paddle_tpu/jit/train_step.py's TrainStep
with its telemetry options).

    step = TrainStep(model, AdamW(...), lambda ids, labels:
                     model.loss(ids, labels))
    loss = step(ids, labels)          # updates the model in place

One call runs the forward, the backward and the optimizer update eagerly,
in the JAX step's order:
  * `grad_accum_steps` > 1 splits every batch tensor on dim 0 into
    microbatches; the loss is their mean and the gradients accumulate, each
    divided by the count, in the parameter dtype;
  * with a GradScaler the loss is scaled before the backward and the
    gradients unscaled before anything reads them; a non-finite gradient
    skips the whole update (parameters and optimizer state), and then the
    scaler's rule moves the scale;
  * the optimizer's gradient clip applies (ClipGradByGlobalNorm,
    ClipGradByNorm or ClipGradByValue; the JAX step applies the first
    only and skips the other two);
  * the forward runs eagerly in the model's own mode, so a model in
    train() mode updates its batch-norm running statistics at every
    forward, once per microbatch (the JAX step's trace never does, and
    keeps the initial statistics);
  * steps are numbered from 1 and the learning rate is read at every call
    (the caller steps a scheduler); `run_steps(n, *stacked)` runs n steps
    from batches stacked on dim 0 with the learning rate read once, as the
    JAX scan does.

Telemetry, as in the JAX step:
  * `numerics` (True or a debugging.NumericsConfig): every module records
    a stats row of its output while the forward runs (a collect scope
    closed before the backward, so a recomputed region's second forward
    records nothing); per-layer gradient rows, the global grad norm and a
    found-inf scalar follow. The rows stack into one [rows, 6] tensor
    that stays on the device until the `every_n_steps` fetch
    (`numerics_stats()`), which runs the detectors, routes events to the
    monitor, `on_event` and a dump (`dump_dir`), and may raise.
    `skip_nonfinite_updates` reads the found-inf scalar once a step and
    skips the update, as the GradScaler path does;
  * `monitor` (a profiler.StepMonitor): one `end_step` a call with the
    call's host wall time, and `record_compile` on the first call of a
    new batch signature — the JAX step compiles one executable per
    signature, and the port keeps that bookkeeping though it builds
    none (`run_steps[n=...]` is a kind of its own);
  * `timeline` (a profiler.timeline.SpanRecorder, else the installed
    one): a `compile` span for such a first call, `step` spans after;
  * `memz` (an obs.MemoryLedger): `train_params` and `train_opt_state`
    register as owners read from the tensors' sizes, and a device
    out-of-memory error leaves a post-mortem before it propagates.
`state_dict()` / `set_state_dict()` carry the step, parameters, optimizer
state, optimizer scalars and the scaler, in the JAX layout (`params` and
`opt` keyed by parameter name).

With ``mesh`` (a `distributed.Mesh` over the axes ``dp``, ``sdp``,
``ep``, ``sp`` and ``mp``, the model built under it), each process is
one rank of the run:
  * every call takes the GLOBAL batch, as the JAX step does, and each
    rank uses its rows along the one axis `data_axes` names (dim 0 cut
    into that axis' size; with accumulation, each microbatch of the
    global batch is cut); ranks along the other axes see the same rows
    (the data axis is called ``dp`` below): ``ep`` ranks hold the same
    tokens, as JAX's ``data_axes=("dp",)`` gives them, and a
    sequence-parallel GPT takes its ``sp`` rank's positions itself;
  * the TOKEN group (`Mesh.token_group`: ``dp`` x ``sp``, else ``dp``)
    holds the ranks whose tokens differ: a `loss_mask` mean inside
    GPT's loss is the global masked mean, the mask's count all-reduced
    over it (`distributed.mesh.data_parallel_loss`), so the ranks' mean
    is neither a mean of per-rank means nor different from the
    single-process loss, and the MoE layer routes the group's tokens as
    one batch; every rank returns the global loss;
  * after the backward and the accumulation the gradients are averaged
    over the token group in flattened buckets of at most `BUCKET_BYTES`
    (unless `grad_comm` or ZeRO stage 2-3 exchange them, below);
  * the gradient clip sums the squares of ``mp``-sharded gradients over
    ``mp``, those of ``ep``-sharded experts over ``ep``, and counts
    replicated ones once; the GradScaler's found-inf flag is
    max-reduced over all ranks, so every rank skips the same steps;
  * the telemetry options see this rank's own view: the numerics rows
    and grad norm are of its shards, the monitor, timeline and memory
    ledger time and count its own process; `state_dict()` holds its
    shards (`convert.gather_state` joins them).
A mesh whose axes have one rank each changes nothing: the step is
bitwise the step without it.

`grad_comm` ("f32" or "int8", on a mesh whose only axis is the data
axis; not with ``sp`` or ``ep``, ROADMAP A4) replaces the bucketed
average by one exchange per `grad_layer_groups` group, started in the
backward as soon as the group's last gradient lands (a hook on every
parameter), so that it runs under the rest of the backward: "int8" is
`distributed.quant_collectives`' int8 all-reduce with per-chunk scales
(0/1-d leaves, or those `grad_comm_f32_fallback(name, shape)` picks, on
an f32 lane), "f32" every leaf on the f32 lane. The groups start in one
fixed order on every rank (the reverse of the parameters', the order the
backward lands them; a group that lands early waits for the ones before
it; the ranks compare their groups when the step is built), and the step
waits for all of them before the clip.

ZeRO (`distributed.group_sharded_parallel` or `shard_optimizer_state`
mark the optimizer; `distributed.sharding` has the layout) shards the
optimizer state (stage 1), the gradients (stage 2: each run of
parameters reduced to its owner as the backward lands it) and the
parameters (stage 3: gathered on use) over the shard axis (not on a mesh
with ``sp`` or ``ep``, ROADMAP A4); the clip then
sums the owners' squares over the shard group (and over ``mp`` for split
parameters), and found-inf stays a world MAX. `state_dict()` /
`set_state_dict()` give and take whole tensors under every stage (a
collective: every rank calls them).

Graph lint, preemption and chaos hooks are later slices; asking for one
raises. Options that only tune the JAX compilation (donation) are not
accepted.
"""
from __future__ import annotations

import collections
import functools
import logging
import time
import weakref
from typing import Callable, Dict

import numpy as np
import torch

from ..amp.grad_scaler import GradScaler, found_inf
from ..device import resolve_device
from ..distributed.collective import (BUCKET_BYTES, ReduceOp, all_reduce,
                                      get_group)
from ..distributed.mesh import axis_group, data_parallel_loss
from ..optimizer.lr import LRScheduler
from ..profiler.timeline import current as _tl_current

_logger = logging.getLogger("paddle_tpu_torch.jit.train_step")

# option -> (what brings it, ROADMAP.md queue item)
_LATER = {"preemption": ("the resilience slice", "A6"),
          "chaos": ("the resilience slice", "A6"),
          "lint": ("the tooling slice", "A8")}


# the in-backward exchanges left open before the oldest is finished
INFLIGHT = 4


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _signature(batch):
    """The batch's abstract signature: (shape, dtype) per leaf, as the
    JAX step keys its executables."""
    from ..debugging.dump import tree_leaves
    return tuple((tuple(a.shape), _dtype_name(a.dtype))
                 if torch.is_tensor(a) else ((), type(a).__name__)
                 for a in tree_leaves(batch))


def _grad_hook(ref, i, g):
    step = ref()
    return None if step is None else step._on_grad(i, g)


class _Landing:
    """The gradient exchange started while the backward runs: `units` are
    lists of parameter indices in the order their exchanges start (the
    same on every rank); when a unit's last gradient lands, its exchange
    and those of the completed units after it start (`start(k, grads,
    seed)` returns a pending exchange; `seed` is `begin`'s), and at most
    INFLIGHT exchanges are left open before the oldest is finished
    (`finish(pending, out)` writes its gradients into out), so the
    buffers in flight stay bounded. `end` starts what never landed (an
    unused parameter's zeros) and finishes the rest."""

    def __init__(self, units, start, finish):
        self.units = [list(u) for u in units]
        self.unit_of = {i: k for k, u in enumerate(self.units) for i in u}
        self._start, self._finish = start, finish
        self.active = False

    def agree(self, group, params, device):
        """Raise unless every rank of `group` built the same units (their
        parameter indices, shapes and dtypes): the exchanges start in the
        units' order, so the ranks then issue the same collectives in the
        same order. One int64 MAX all-reduce, when the step is built."""
        if group is None or group.nranks == 1:
            return
        import hashlib
        key = repr([[(i, tuple(params[i].shape), str(params[i].dtype))
                     for i in u] for u in self.units])
        h = int.from_bytes(hashlib.sha1(key.encode()).digest()[:7], "big")
        t = torch.tensor([h, -h], dtype=torch.int64, device=device)
        all_reduce(t, ReduceOp.MAX, group=group)
        if int(t[0]) != h or int(t[1]) != -h:
            raise RuntimeError(
                f"the ranks of {group} built different gradient exchange "
                f"units ({len(self.units)} here): every rank must build the "
                f"same model and parameter list")

    def begin(self, n: int, seed: int = 0):
        self.seed = seed
        self.got = [{} for _ in self.units]
        self.next = 0
        self.pending = collections.deque()
        self.out = [None] * n
        self.active = True

    def land(self, i, g):
        self.got[self.unit_of[i]][i] = g
        self._drain()

    def _drain(self, params=None):
        while self.next < len(self.units):
            k = self.next
            got = self.got[k]
            if len(got) < len(self.units[k]):
                if params is None:
                    return
                for i in self.units[k]:
                    if i not in got:
                        got[i] = torch.zeros(params[i].shape,
                                             dtype=params[i].dtype,
                                             device=params[i].device)
            self.pending.append(self._start(k, got, self.seed))
            self.got[k] = None
            self.next += 1
            while len(self.pending) > INFLIGHT:
                self._finish(self.pending.popleft(), self.out)

    def end(self, params):
        """Every unit started and finished: the exchanged gradients."""
        try:
            self._drain(params)
            while self.pending:
                self._finish(self.pending.popleft(), self.out)
        finally:
            self.active = False
        return self.out


def _tensor(x, device):
    """A state-dict entry (tensor or numpy array) as a new tensor on
    device: never the caller's own, which the step's in-place updates
    would change."""
    if torch.is_tensor(x):
        return x.detach().to(device=device, copy=True)
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":      # ml_dtypes bf16 from JAX
        x = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        x = torch.from_numpy(np.array(a))
    return x.to(device=device)


class TrainStep:
    """Eager forward, backward and update of `loss_fn(*batch)` over the
    model's trainable parameters, with the JAX step's telemetry options
    (module docstring). ``device`` defaults to CUDA (raising without a
    card); the model must live on it."""

    def __init__(self, model, optimizer, loss_fn: Callable, mesh=None,
                 data_axes=("dp",), grad_accum_steps: int = 1, monitor=None,
                 numerics=None, scaler: GradScaler = None, lint=None,
                 preemption=None, chaos=None, timeline=None, memz=None,
                 grad_comm=None, grad_comm_chunk: int = 256,
                 grad_comm_stochastic: bool = False,
                 grad_comm_f32_fallback=None, device=None):
        asked = dict(lint=lint, preemption=preemption, chaos=chaos)
        for opt_name, value in asked.items():
            if value is not None and value is not False:
                what, item = _LATER[opt_name]
                raise NotImplementedError(
                    f"TrainStep({opt_name}=...) is not ported yet; it comes "
                    f"with {what} (ROADMAP.md, queue item {item})")
        self.device = resolve_device(device)
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.grad_accum_steps = max(1, int(grad_accum_steps))
        # profiler.StepMonitor (assignable after construction too)
        self.monitor = monitor
        # profiler.timeline.SpanRecorder; falls back to the installed one
        self.timeline = timeline
        # obs.MemoryLedger: params / opt state register at the first call
        self.memz = memz
        self._memz_registered = False
        self._param_names, self._params = [], []
        for name, p in model.named_parameters():
            if p.requires_grad:
                if p.device.type != self.device.type:
                    raise ValueError(f"parameter {name} lives on "
                                     f"{p.device}, the step on "
                                     f"{self.device}; pass device="
                                     f"{p.device.type!r}")
                self._param_names.append(name)
                self._params.append(p)
        self._set_mesh(mesh, data_axes)
        self._scaler = scaler if (scaler is not None
                                  and scaler.is_enable()) else None
        self._opt_state = None
        self._step_i = 0
        self._grad_groups = []    # [(path, [param indices])]
        self._landing = None      # the in-backward exchange (_Landing)
        self._in_step = False
        self._grad_bytes = 0      # the gradients this rank kept, last step
        self._setup_grad_comm(grad_comm, grad_comm_chunk,
                              grad_comm_stochastic, grad_comm_f32_fallback)
        self._setup_zero()
        self._hooks = []
        if self._landing is not None or (self._zero is not None
                                         and self._zero.stage >= 3):
            # through a weak reference: a parameter's hook must not keep
            # the step (and so the model) alive
            ref = weakref.ref(self)
            self._hooks = [p.register_hook(functools.partial(
                _grad_hook, ref, i)) for i, p in enumerate(self._params)]
        # the batch signatures the JAX step would have compiled for, and
        # the last one per kind (the recompilation detector's input)
        self._signatures = set()
        self._last_sig = {}
        self._numerics = None
        self._sentinel_handle = None
        self._act_paths = []      # activation row paths, filled at 1st step
        self._last_aux = None     # latest step's aux (device tensors)
        self._last_loss = None
        self._last_batch = None
        self._last_gen_state = None
        if numerics is not None:
            self.set_numerics(numerics)

    def _set_mesh(self, mesh, data_axes):
        """The mesh's groups: the data axis (batch rows), the token group
        (gradient average, the loss count; the data group without sp), mp
        and ep (the clip) and the world (found-inf); None where a group
        has one rank."""
        self.mesh = mesh
        self.data_axes = tuple(data_axes)
        self._rows = self._dp = self._mp = self._ep = self._world = None
        self._sharded = [getattr(p, "mp_split", None) is not None
                         for p in self._params]
        self._expert = [getattr(p, "ep_split", None) is not None
                        for p in self._params]
        if mesh is None:
            if any(self._sharded) or any(self._expert):
                raise ValueError("the model holds tensor- or expert-"
                                 "parallel shards; pass its mesh: "
                                 "TrainStep(mesh=...)")
            return
        if len(self.data_axes) != 1:
            raise ValueError(
                f"TrainStep(data_axes={data_axes!r}): the port splits the "
                f"batch over ONE mesh axis; several would split dim 0 over "
                f"their product, and its rows, loss count and gradient "
                f"average would need a process group over that product, "
                f"which the mesh does not build")
        extra = set(mesh.axis_names) - {"dp", "sdp", "ep", "sp", "mp"}
        if extra:
            raise NotImplementedError(
                f"TrainStep(mesh=...) with axes {sorted(extra)}: dp, sdp, "
                f"ep, sp and mp are ported; pipeline parallelism comes with "
                f"a later multi-GPU slice (ROADMAP.md, queue item A4)")
        if self.data_axes[0] not in ("dp", "sdp"):
            raise ValueError(
                f"TrainStep(data_axes={data_axes!r}): the batch splits over "
                f"'dp' or 'sdp'; a tensor-parallel rank needs its group's "
                f"rows")
        spep = {"sp", "ep"} & set(mesh.axis_names)
        if spep and self.data_axes != ("dp",):
            raise ValueError(f"TrainStep(data_axes={data_axes!r}) on a mesh "
                             f"with {sorted(spep)}: the batch splits over "
                             f"'dp' there")
        # the batch rows' group, and the token group (named _dp: the data
        # group itself without sp)
        self._rows = axis_group(self.data_axes[0], mesh)
        self._dp = mesh.token_group() if "sp" in mesh.axis_names \
            else self._rows
        self._mp = axis_group("mp", mesh)
        self._ep = axis_group("ep", mesh)
        if mesh.size > 1:
            self._world = get_group()
            if self.device.type == "cuda" and self._world.backend != "nccl":
                raise ValueError("a CUDA step needs an NCCL process group")

    def _setup_grad_comm(self, grad_comm, chunk, stochastic, fallback):
        """The per-layer-group exchange of `grad_comm` (the JAX step's
        preconditions and plan)."""
        self.grad_comm = grad_comm
        self.grad_comm_chunk = int(chunk)
        self.grad_comm_stochastic = bool(stochastic)
        self._comm_groups = None
        self._comm_flip = frozenset()
        if grad_comm is None:
            return
        if grad_comm not in ("f32", "int8"):
            raise ValueError(f"grad_comm={grad_comm!r}: expected None, "
                             "'f32' or 'int8'")
        mesh = self.mesh
        if mesh is not None and {"sp", "ep"} & set(mesh.axis_names):
            raise NotImplementedError(
                "TrainStep(grad_comm=...) on a mesh with an sp or ep axis "
                "comes with a later slice (ROADMAP.md, queue item A4): its "
                "exchange would average over the token group")
        if mesh is None:
            raise ValueError("grad_comm requires TrainStep(mesh=...) — "
                             "there is no gradient sync to replace "
                             "without a data-parallel mesh")
        if len(self.data_axes) != 1 or \
                tuple(mesh.axis_names) != self.data_axes:
            raise ValueError(
                f"grad_comm needs a pure data-parallel mesh whose only "
                f"axis is {self.data_axes!r} (got mesh axes "
                f"{tuple(mesh.axis_names)}): the exchange averages each "
                f"layer group over that one axis")
        if self.grad_accum_steps > 1:
            raise ValueError("grad_comm with grad_accum_steps>1 is not "
                             "supported yet — the accumulation loop would "
                             "need the sync after its last microbatch")
        from ..debugging import grad_layer_groups
        from ..distributed import quant_collectives as QC
        from ..optimizer.optimizer import _jax_order
        self._grad_groups = grad_layer_groups(self._param_names,
                                              type(self.model).__name__)
        shapes = [tuple(p.shape) for p in self._params]
        if grad_comm == "int8":
            plan = QC.build_comm_groups(self._param_names, shapes,
                                        self._grad_groups, fallback)
        else:
            # every leaf on the f32 lane: the overlap without quantization
            plan = [(path, (), tuple(idxs))
                    for path, idxs in self._grad_groups]
        self._comm_groups = plan
        g = self._dp
        scale_group = mesh.twin(self.data_axes[0]) \
            if grad_comm == "int8" and g is not None else None
        # the int8 lane flattens an nn.Linear weight in the JAX element
        # order, so its chunks are the JAX package's
        self._comm_flip = frozenset(
            i for i, (n, p) in enumerate(zip(self._param_names,
                                             self._params))
            if _jax_order(n, p))
        sync = QC.GroupSync(g, self.grad_comm_chunk, self.grad_comm_stochastic,
                            scale_group=scale_group, flip=self._comm_flip)
        n = len(plan)
        # the backward lands the groups in about the reverse of the
        # parameters' order: unit k is group n - 1 - k
        self._landing = _Landing(
            [list(q) + list(f) for _, q, f in plan[::-1]],
            lambda k, got, seed: sync.start(got, plan[n - 1 - k], n - 1 - k,
                                            seed),
            sync.finish)
        self._landing.agree(g, self._params, self.device)

    def _setup_zero(self):
        """ZeRO's runtime, when the optimizer is marked (distributed.
        sharding; stage 3 also needs the model marked); its shard group
        is the marked axis' (None at one rank)."""
        from ..distributed import sharding as SH
        self._zero = None
        stage = int(getattr(self.optimizer, "_sharding_stage", 0) or 0)
        if not stage:
            return
        if stage >= 2 and self.grad_comm is not None:
            raise ValueError(f"grad_comm with ZeRO stage {stage}: the stage "
                             f"reduces each gradient to its owner in place "
                             f"of the all-reduce grad_comm replaces; use "
                             f"stage 1 ('os') with grad_comm")
        axis = getattr(self.optimizer, "_sharding_axis", "sdp")
        if self.mesh is not None and {"sp", "ep"} & set(
                self.mesh.axis_names):
            raise NotImplementedError(
                "ZeRO on a mesh with an sp or ep axis comes with a later "
                "slice (ROADMAP.md, queue item A4)")
        if getattr(self.model, "_zero_param_axis", None) is None:
            # the parameters stay whole unless shard_parameter_specs marked
            # the model (as the JAX step keeps their specs)
            stage = min(stage, 2)
        mesh = self.mesh
        group = axis_group(axis, mesh) if mesh is not None else None
        gather = mesh.twin(axis) if stage >= 3 and group is not None \
            else None
        self._zero = SH.ZeroRuntime(stage, self._param_names, self._params,
                                    group, self._dp, self.model, gather)
        if stage >= 2:
            z = self._zero
            self._landing = _Landing(z.units, lambda k, got, seed:
                                     z.issue(k, got), z.finish)
            self._landing.agree(z.group if z.reduce_mode else z.data_group,
                                self._params, self.device)

    def _on_grad(self, i, g):
        """A parameter's gradient landed in the step's backward: stage 3
        frees the parameter (its last use is behind), and an exchange in
        flight takes the gradient (the backward keeps an empty stand-in,
        so the gradient is not held twice)."""
        if not self._in_step:
            return None
        zero = self._zero
        if zero is not None and zero.stage >= 3:
            zero.free([i])
        lan = self._landing
        if lan is None or not lan.active:
            return None
        lan.land(i, g)
        return torch.zeros((), dtype=g.dtype, device=g.device).expand(
            g.shape)

    def __del__(self):
        for h in getattr(self, "_hooks", ()):
            h.remove()

    @property
    def zero(self):
        """The ZeRO runtime (distributed.sharding.ZeroRuntime), or None."""
        return self._zero

    def gathered(self):
        """A context in which every parameter is whole (ZeRO stage 3
        holds a rank's own only between steps); a no-op otherwise."""
        import contextlib
        return self._zero.gathered() if self._zero is not None \
            else contextlib.nullcontext()

    def set_numerics(self, numerics):
        """(Re)configure the numerics mode after construction: installs the
        module sentinels + per-layer grad grouping; the next call counts as
        a new executable, as the JAX step recompiles with the stats tree
        among its outputs. Pass None/False to disable."""
        from ..debugging import (NumericsConfig, check_layer_numerics,
                                 grad_layer_groups)
        self._numerics = NumericsConfig.coerce(numerics)
        zero = getattr(self, "_zero", None)
        if self._numerics is not None and zero is not None and \
                zero.stage >= 2:
            self._numerics = None
            raise ValueError("TrainStep(numerics=...) with ZeRO stage >= 2: "
                             "its per-layer gradient rows need every "
                             "gradient, and a rank keeps its own only")
        if self._numerics is not None:
            if self._sentinel_handle is None:
                # idempotent: reuses hooks another handle already installed
                self._sentinel_handle = check_layer_numerics(self.model)
            if self._numerics.grad_stats and not self._grad_groups:
                self._grad_groups = grad_layer_groups(
                    self._param_names, type(self.model).__name__)
        if self._signatures:
            self._signatures.clear()
            # a deliberate rebuild, not shape instability
            self._last_sig.clear()

    # ------------------------------------------------------------------
    def _init_opt_state(self):
        """Each parameter's state (None where ZeRO gives it to another
        rank)."""
        zero = self._zero
        return [self.optimizer.init_state(p, name=n)
                if zero is None or zero.owned[i] else None
                for i, (p, n) in enumerate(zip(self._params,
                                               self._param_names))]

    def _ensure_opt_state(self):
        if self._opt_state is None:
            self._opt_state = self._init_opt_state()

    def _grads(self, batch, scale):
        """(mean loss f32, gradients in the parameter dtype, activation
        stats rows or None) over the microbatches of `batch`, the backward
        run on the scaled loss."""
        accum = self.grad_accum_steps
        numerics = self._numerics
        if accum == 1:
            micro = [batch]
        else:
            for a in batch:
                if not torch.is_tensor(a) or a.dim() == 0:
                    raise ValueError("grad_accum_steps requires batched "
                                     "tensor inputs; got a scalar leaf")
                if a.shape[0] % accum:
                    raise ValueError(f"batch size {a.shape[0]} is not "
                                     f"divisible by grad_accum_steps="
                                     f"{accum}")
            micro = list(zip(*(a.chunk(accum, dim=0) for a in batch)))
        if self._rows is not None:
            micro = [tuple(self._dp_rows(a) for a in mb) for mb in micro]
        zero, landing = self._zero, self._landing
        loss_sum, acc, micro_rows = None, None, []
        for mb in micro:
            if zero is not None and zero.stage >= 3:
                zero.gather_root()
            if numerics is not None:
                from ..debugging.sentinel import collect_stats
                # the scope closes before the backward: a recomputed
                # region's second forward records no rows
                with collect_stats() as col, data_parallel_loss(self._dp):
                    loss = self.loss_fn(*mb).float()
                micro_rows.append(col.stacked())
                if col.paths and not self._act_paths:
                    self._act_paths.extend(col.paths)
            else:
                with data_parallel_loss(self._dp):
                    loss = self.loss_fn(*mb).float()
            scaled = loss * scale if scale is not None else loss
            if landing is not None and accum == 1:
                # the exchanges start inside the backward (_on_grad)
                landing.begin(len(self._params), self._comm_seed)
                try:
                    torch.autograd.grad(scaled, self._params,
                                        allow_unused=True)
                finally:
                    grads = landing.end(self._params)
                return (self._loss_mean(loss.detach()), grads,
                        micro_rows[0] if micro_rows else None)
            grads = torch.autograd.grad(scaled, self._params,
                                        allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(self._params, grads)]
            loss = loss.detach()
            if accum == 1:
                loss, grads = self._dp_reduce(loss, grads)
                return loss, grads, micro_rows[0] if micro_rows else None
            loss_sum = loss / accum if loss_sum is None \
                else loss_sum + loss / accum
            if acc is None:
                acc = [torch.zeros_like(p) for p in self._params]
            acc = [a + (g / accum).to(a.dtype) for a, g in zip(acc, grads)]
        rows = None
        if micro_rows and all(r is not None for r in micro_rows):
            from ..debugging.sentinel import merge_stacked
            rows = merge_stacked(torch.stack(micro_rows))
        if landing is not None:
            # the accumulated gradients land at once, in the backward's
            # order
            landing.begin(len(self._params), self._comm_seed)
            for i in reversed(range(len(acc))):
                landing.land(i, acc[i])
            acc[:] = [None] * len(acc)
            return self._loss_mean(loss_sum), landing.end(self._params), rows
        loss_sum, acc = self._dp_reduce(loss_sum, acc)
        return loss_sum, acc, rows

    def _dp_rows(self, a):
        """This dp rank's rows of a batch leaf (dim 0 cut into dp equal
        parts); scalars and non-tensors pass as they are."""
        if not torch.is_tensor(a) or a.dim() == 0:
            return a
        n, r = self._rows.nranks, self._rows.rank
        if a.shape[0] % n:
            raise ValueError(f"batch size {a.shape[0]} does not split over "
                             f"the {n} dp ranks")
        k = a.shape[0] // n
        return a[r * k:(r + 1) * k]

    def _loss_mean(self, loss):
        """The loss averaged over the data group."""
        g = self._dp
        if g is None:
            return loss
        loss = loss.clone()
        all_reduce(loss, group=g)
        return loss / g.nranks

    def _dp_reduce(self, loss, grads):
        """The loss and the gradients averaged over dp, the gradients in
        flattened buckets of one dtype and at most BUCKET_BYTES. The
        entries of the list `grads` are released as their bucket forms,
        so the gradients are held about once."""
        g = self._dp
        if g is None:
            return loss, grads
        n = g.nranks
        loss = loss.clone()
        all_reduce(loss, group=g)
        out, i = [None] * len(grads), 0
        while i < len(grads):
            j, size = i, 0
            while j < len(grads) and grads[j].dtype == grads[i].dtype and (
                    j == i or size + grads[j].nbytes <= BUCKET_BYTES):
                size += grads[j].nbytes
                j += 1
            shapes = [t.shape for t in grads[i:j]]
            flat = torch.cat([t.reshape(-1) for t in grads[i:j]])
            grads[i:j] = [None] * (j - i)
            all_reduce(flat, group=g)
            flat.div_(n)
            out[i:j] = [part.view(sh) for part, sh in zip(
                flat.split([sh.numel() for sh in shapes]), shapes)]
            i = j
        return loss / n, out

    def _step(self, batch, lr: float, step_i: int):
        """One step; returns (loss, aux), aux holding the numerics tensors
        (`stats`, `grad_norm`, `found_inf`) on the device."""
        self._ensure_opt_state()
        scale = None
        if self._scaler is not None:
            scale = torch.tensor(self._scaler.state_arrays()[0],
                                 dtype=torch.float32, device=self.device)
        self._in_step = True
        self._comm_seed = step_i    # stochastic rounding: the step's key
        try:
            loss, grads, act_rows = self._grads(batch, scale)
        finally:
            self._in_step = False
        zero = self._zero
        # ZeRO stage >= 2: a rank holds its own parameters' gradients only
        kept = [i for i, g in enumerate(grads) if g is not None]
        self._grad_bytes = int(sum(grads[i].numel() * grads[i].element_size()
                                   for i in kept))
        numerics = self._numerics
        aux = {}
        with torch.no_grad():
            # unscale before the sentinels and the clip: the rows and the
            # update see true gradients
            if scale is not None:
                inv = torch.tensor(1.0, dtype=torch.float32,
                                   device=self.device) / scale
                grads = [None if g is None else g * inv.to(g.dtype)
                         for g in grads]
            found = None
            need_found = self._scaler is not None or (
                numerics is not None and numerics.skip_nonfinite_updates)
            if numerics is not None:
                from ..debugging import sentinel as _sentinel
                rows = [act_rows] if act_rows is not None else []
                grow_mat, found_t = None, None
                if self._grad_groups:
                    _, grows = _sentinel.grad_stat_rows(grads,
                                                        self._grad_groups)
                    grow_mat = torch.stack(grows)
                    rows.append(grow_mat)
                if rows:
                    aux["stats"] = torch.cat(rows)
                if grow_mat is not None:
                    # found-inf and the global grad norm derive from the
                    # grad rows: no second pass over the gradients
                    if need_found:
                        found_t = (grow_mat[:, 1] + grow_mat[:, 2]).sum() > 0
                    aux["grad_norm"] = torch.sqrt((grow_mat[:, 5] ** 2).sum())
                else:
                    if need_found:
                        found_t = _sentinel.found_inf(grads)
                    aux["grad_norm"] = torch.sqrt(sum(
                        g.float().square().sum() for g in grads))
                if found_t is not None:
                    aux["found_inf"] = found_t
                    found = bool(found_t)      # the one read a step
            elif need_found:
                found = found_inf([grads[i] for i in kept])
            if found is not None and self._world is not None:
                # every rank skips the same steps
                flag = torch.tensor(float(found), device=grads[0].device)
                all_reduce(flag, ReduceOp.MAX, group=self._world)
                found = bool(flag)
            clip = self.optimizer._grad_clip
            if clip is not None and zero is not None and zero.stage >= 2:
                # the owners' squares summed over the shard group
                sub = clip([grads[i] for i in kept],
                           sharded=[self._sharded[i] for i in kept],
                           group=self._mp, shard_group=zero.group,
                           device=self.device)
                for i, g in zip(kept, sub):
                    grads[i] = g
            elif clip is not None and self._ep is not None:
                grads = clip(grads, sharded=self._sharded, group=self._mp,
                             expert=self._expert, expert_group=self._ep)
            elif clip is not None:
                grads = clip(grads) if self._mp is None else \
                    clip(grads, sharded=self._sharded, group=self._mp)
            if not found:
                opt = self.optimizer
                for name, p, g, st in zip(self._param_names, self._params,
                                          grads, self._opt_state):
                    if st is None:
                        continue        # another rank's (ZeRO)
                    opt.update(p, g, st, lr, step_i, opt._wd_for(name),
                               name=name)
                if zero is not None and zero.stage <= 2:
                    zero.broadcast_params()
        if self._scaler is not None:
            self._scaler.set_state_arrays(
                GradScaler._update_rule(*self._scaler.state_arrays(), found,
                                        **self._scaler._hyper()),
                found_inf=found)
        return loss, aux

    # ------------------------------------------------------------------
    def _note_signature(self, kind: str, sig) -> bool:
        """True when `sig` is a batch signature the JAX step would compile
        anew: the compile bookkeeping (monitor.record_compile, or a logged
        shape delta on a recompile) runs then."""
        if sig in self._signatures:
            return False
        self._signatures.add(sig)
        prev = self._last_sig.get(kind)
        self._last_sig[kind] = sig
        if self.monitor is not None:
            self.monitor.record_compile(kind, sig, prev_sig=prev)
        elif prev is not None and prev != sig:
            from ..profiler.monitor import shape_delta
            _logger.warning("recompilation of %s: %s", kind,
                            shape_delta(prev, sig))
        return True

    def _register_memz(self):
        """Register params / opt state as memory-ledger owners, read from
        the tensors' sizes (host metadata, never device values)."""
        if self.memz is None or self._memz_registered:
            return
        self._memz_registered = True
        zero = self._zero
        # under ZeRO stage 3 a card's own share: the parameters it owns
        self.memz.register(
            "train_params",
            lambda: int(sum(p.numel() * p.element_size()
                            for i, p in enumerate(self._params)
                            if zero is None or zero.stage < 3
                            or zero.owned[i])),
            kind="params", replace=True)
        # the gradients the last step kept (ZeRO stage >= 2: its own)
        self.memz.register("train_grads", lambda: self._grad_bytes,
                           kind="grads", replace=True)
        self.memz.register(
            "train_opt_state",
            lambda: int(sum(v.numel() * v.element_size()
                            for st in (self._opt_state or ())
                            for v in (st or {}).values()
                            if torch.is_tensor(v))),
            kind="opt_state", replace=True)
        self.memz.sample("train_params", "train_opt_state", "train_grads")
        if self.monitor is not None and getattr(self.monitor, "memz",
                                                None) is None:
            self.monitor.memz = self.memz

    def _launch(self, batch, lr, step_i):
        """One step; a device out-of-memory error leaves the ledger's
        post-mortem (census, growth, the step) before it propagates."""
        try:
            return self._step(batch, lr, step_i)
        except BaseException as e:
            if self.memz is not None:
                from ..obs.memz import looks_like_oom
                if looks_like_oom(e):
                    self.memz.post_mortem(
                        error=e,
                        context={"site": "train_step.launch",
                                 "step": self._step_i})
            raise

    def _generator_state(self):
        """The model's dropout generator state (the dump's replay key)."""
        if self._numerics is None:
            return None
        gen = getattr(self.model, "dropout_generator", None)
        return gen.get_state() if isinstance(gen, torch.Generator) else None

    def __call__(self, *batch):
        """One step; returns the (unscaled) loss as a 0-d f32 tensor."""
        tl = self.timeline if self.timeline is not None else _tl_current()
        tl_t0 = tl.now() if tl is not None else None
        self._ensure_opt_state()
        sig = _signature(batch)
        was_compile = self._note_signature("train_step", sig)
        self._register_memz()
        self._step_i += 1
        lr = self.optimizer.get_lr()
        gen_state = self._generator_state()
        t0 = time.perf_counter() if self.monitor is not None else None
        loss, aux = self._launch(batch, lr, self._step_i)
        if self.monitor is not None:
            self.monitor.end_step(wall_s=time.perf_counter() - t0)
        if tl is not None:
            tl.record("compile" if was_compile else "step", tl_t0, tl.now(),
                      step=self._step_i)
        self._last_batch = batch
        self._last_gen_state = gen_state
        self._after_step(loss, aux)
        return loss

    def run_steps(self, n_steps: int, *stacked_batch):
        """n steps from batches stacked on dim 0 ([n, ...] per tensor), the
        learning rate read once; returns the per-step losses [n]. One
        monitor record and one timeline span cover the n steps."""
        n_steps = int(n_steps)
        tl = self.timeline if self.timeline is not None else _tl_current()
        tl_t0 = tl.now() if tl is not None else None
        self._ensure_opt_state()
        was_compile = self._note_signature(
            f"train_step.run_steps[n={n_steps}]",
            ("scan", n_steps, _signature(stacked_batch)))
        self._register_memz()
        lr = self.optimizer.get_lr()
        t0 = time.perf_counter() if self.monitor is not None else None
        losses, aux, gen_state = [], {}, None
        for i in range(n_steps):
            gen_state = self._generator_state()
            loss, aux = self._launch(tuple(a[i] for a in stacked_batch), lr,
                                     self._step_i + 1)
            losses.append(loss)
            self._step_i += 1
        if self.monitor is not None:
            self.monitor.end_step(steps=n_steps,
                                  wall_s=time.perf_counter() - t0)
        if tl is not None:
            tl.record("compile" if was_compile else "step", tl_t0, tl.now(),
                      step=self._step_i, steps=n_steps)
        losses = torch.stack(losses)
        # the fetched stats (and any dump) describe the LAST step
        self._last_batch = tuple(a[-1] for a in stacked_batch)
        self._last_gen_state = gen_state
        self._after_step(losses, aux, steps=n_steps)
        return losses

    # ------------------------------------------------------------------
    # numerics: fetch / detect / dump
    @property
    def numerics_paths(self):
        """Stats-tree row names: activation paths (forward order) then
        per-layer grad rows. Populated after the first numerics step."""
        return list(self._act_paths) + [k for k, _ in self._grad_groups]

    def numerics_stats(self, sync: bool = True):
        """The latest step's StatsTree (the device->host fetch happens
        HERE, not in the step). None before the first numerics step.
        `sync` is the JAX signature's; the tree is always fetched."""
        if self._last_aux is None or "stats" not in self._last_aux:
            return None
        from ..debugging import StatsTree
        return StatsTree(self.numerics_paths, self._last_aux["stats"],
                         step=self._step_i)

    def _after_step(self, loss, aux, *, steps=1):
        if self._numerics is None:
            return
        self._last_aux = aux
        self._last_loss = loss
        n = self._numerics.every_n_steps
        if n and (self._step_i % n == 0
                  or (steps > 1 and self._step_i % n < steps)):
            self._fetch_and_detect()

    def _fetch_and_detect(self):
        """One host fetch of the latest stats + loss/grad-norm scalars, run
        the detectors, route events (monitor / on_event / dump / raise)."""
        cfg = self._numerics
        tree = self.numerics_stats()
        loss = None
        if self._last_loss is not None:
            # run_steps: the last step's loss
            loss = float(self._last_loss.detach().reshape(-1)[-1])
        gn = self._last_aux.get("grad_norm") if self._last_aux else None
        gn = float(gn) if gn is not None else None
        events = cfg.detector.observe(self._step_i, tree=tree, loss=loss,
                                      grad_norm=gn)
        monitor = cfg.monitor or self.monitor
        if monitor is not None and hasattr(monitor, "record_numerics"):
            monitor.record_numerics(step=self._step_i, loss=loss,
                                    grad_norm=gn, events=events)
        for e in events:
            _logger.warning("numerics: %r", e)
            if cfg.on_event is not None:
                cfg.on_event(e)
        if events and cfg.dump_dir:
            self._write_dump(events, tree, loss)
        if cfg.raise_on_nonfinite and any(
                e.kind in ("nan", "inf") for e in events):
            bad = next(e for e in events if e.kind in ("nan", "inf"))
            raise FloatingPointError(
                f"non-finite values detected at step {self._step_i} in "
                f"{bad.path}: {bad.message} (numerics.raise_on_nonfinite)")
        return events

    def _write_dump(self, events, tree, loss):
        from ..debugging import dump as _dump
        path = _dump.write_dump(
            self._numerics.dump_dir, step=self._step_i, events=events,
            batch_leaves=_dump.tree_leaves(self._last_batch),
            batch_spec=_dump.tree_spec(self._last_batch),
            param_names=self._param_names, param_arrays=self._params,
            opt_state=self._opt_state,
            generator_state=self._last_gen_state, loss=loss, stats=tree,
            extra_meta={"model": type(self.model).__name__,
                        "skip_nonfinite_updates":
                            self._numerics.skip_nonfinite_updates})
        _logger.warning("numerics: dumped failing step %d to %s",
                        self._step_i, path)
        return path

    # ------------------------------------------------------------------
    def state_dict(self) -> Dict:
        """A host snapshot: step counter, parameters and optimizer state by
        parameter name, the optimizer's scalars and the scaler. Under ZeRO
        every tensor is whole (a collective: every rank calls it)."""
        out: Dict = {"step": int(self._step_i)}
        zero = self._zero
        if zero is None:
            out["params"] = {n: p.detach().cpu().clone()
                             for n, p in zip(self._param_names,
                                             self._params)}
        else:
            out["params"] = {n: zero.full_param(i).cpu()
                             for i, n in enumerate(self._param_names)}
        if self._opt_state is not None and zero is None:
            out["opt"] = {n: {k: v.detach().cpu().clone()
                              for k, v in (st or {}).items()}
                          for n, st in zip(self._param_names,
                                           self._opt_state)}
        elif self._opt_state is not None:
            opt = self.optimizer
            out["opt"] = {}
            for i, (n, p, st) in enumerate(zip(
                    self._param_names, self._params, self._opt_state)):
                full = zero.full_state(i, st, functools.partial(
                    opt.init_state, p, name=n))
                out["opt"][n] = {k: v.cpu() for k, v in full.items()}
        extra: Dict = {"master_step": int(self.optimizer._step_count)}
        if isinstance(self.optimizer._lr, LRScheduler):
            extra["lr_sched"] = {
                k: v for k, v in self.optimizer._lr.state_dict().items()
                if isinstance(v, (bool, int, float, str))}
        out["opt_extra"] = extra
        if self._scaler is not None:
            out["scaler"] = self._scaler.state_dict()
        return out

    @torch.no_grad()
    def set_state_dict(self, state: Dict):
        """Adopt a state_dict() snapshot (tensors or numpy arrays): values
        are copied into the live parameters and optimizer state, each in
        the dtype it was saved in. Under ZeRO a rank keeps its own share of
        the whole tensors."""
        params = state.get("params", {})
        missing = [n for n in self._param_names if n not in params]
        if missing:
            raise KeyError(f"checkpoint is missing parameters: "
                           f"{missing[:5]}{'...' if len(missing) > 5 else ''}")
        zero = self._zero
        for i, (n, p) in enumerate(zip(self._param_names, self._params)):
            src = _tensor(params[n], p.device)
            if tuple(src.shape) != tuple(p.shape):
                raise ValueError(f"{n}: checkpoint shape {tuple(src.shape)}"
                                 f" != parameter {tuple(p.shape)}")
            if zero is not None and not zero.live[i] and \
                    not zero.owned[i]:
                continue        # stage 3 holds another rank's data nowhere
            if src.dtype != p.dtype:
                if zero is not None and zero.stage >= 3:
                    raise ValueError(f"{n}: checkpoint dtype {src.dtype} != "
                                     f"{p.dtype} under ZeRO stage 3")
                p.data = src.clone()
            else:
                p.copy_(src)
        opt = state.get("opt")
        if opt is not None:
            if self._opt_state is None:
                self._opt_state = self._init_opt_state()
            self._opt_state = [
                None if st is None else
                ({k: _tensor(v, p.device) for k, v in opt.get(n, {}).items()}
                 or st)
                for n, p, st in zip(self._param_names, self._params,
                                    self._opt_state)]
        self._step_i = int(state.get("step", 0))
        extra = state.get("opt_extra", {})
        if "master_step" in extra:
            self.optimizer._step_count = int(extra["master_step"])
        if "lr_sched" in extra and isinstance(self.optimizer._lr,
                                              LRScheduler):
            self.optimizer._lr.set_state_dict(dict(extra["lr_sched"]))
        if self._scaler is not None and "scaler" in state:
            self._scaler.set_state_dict(dict(state["scaler"]))
        return self
