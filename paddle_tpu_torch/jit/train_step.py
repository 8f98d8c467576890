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

With ``mesh`` (a `distributed.Mesh` with axes ``dp`` and/or ``mp``, the
model built under it), each process is one rank of the run:
  * every call takes the GLOBAL batch, as the JAX step does, and each
    ``dp`` rank uses its rows (dim 0 cut into dp equal parts; with
    accumulation, each microbatch of the global batch is cut);
  * a `loss_mask` mean inside GPT's loss is the global masked mean: the
    mask's count is all-reduced over ``dp`` (`distributed.mesh.
    data_parallel_loss`), so the ranks' mean is neither a mean of
    per-rank means nor different from the single-process loss; every
    rank returns the global loss;
  * after the backward and the accumulation the gradients are averaged
    over ``dp`` in flattened buckets of at most `BUCKET_BYTES`;
  * the gradient clip sums the squares of ``mp``-sharded gradients over
    ``mp`` and counts replicated ones once; the GradScaler's found-inf
    flag is max-reduced over all ranks, so every rank skips the same
    steps;
  * the telemetry options see this rank's own view: the numerics rows
    and grad norm are of its shards, the monitor, timeline and memory
    ledger time and count its own process; `state_dict()` holds its
    shards (`convert.gather_state` joins them).
A mesh whose axes have one rank each changes nothing: the step is
bitwise the step without it. The JAX step's gradient-sync modes
(`grad_comm`, queue item A4), graph lint, preemption and chaos hooks are
later slices; asking for one raises. Options that only tune the JAX
compilation (donation, the gradient-sync chunking) are not accepted.
"""
from __future__ import annotations

import logging
import time
from typing import Callable, Dict

import numpy as np
import torch

from ..amp.grad_scaler import GradScaler, found_inf
from ..device import resolve_device
from ..distributed.collective import ReduceOp, all_reduce, get_group
from ..distributed.mesh import axis_group, data_parallel_loss
from ..optimizer.lr import LRScheduler
from ..profiler.timeline import current as _tl_current

_logger = logging.getLogger("paddle_tpu_torch.jit.train_step")

# option -> (what brings it, ROADMAP.md queue item)
_LATER = {"grad_comm": ("a later multi-GPU slice", "A4"),
          "preemption": ("the resilience slice", "A6"),
          "chaos": ("the resilience slice", "A6"),
          "lint": ("the tooling slice", "A8")}


# the largest flattened bucket of gradients one dp all-reduce carries
BUCKET_BYTES = 64 << 20


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _signature(batch):
    """The batch's abstract signature: (shape, dtype) per leaf, as the
    JAX step keys its executables."""
    from ..debugging.dump import tree_leaves
    return tuple((tuple(a.shape), _dtype_name(a.dtype))
                 if torch.is_tensor(a) else ((), type(a).__name__)
                 for a in tree_leaves(batch))


def _tensor(x, device):
    """A state-dict entry (tensor or numpy array) as a tensor on device."""
    if not torch.is_tensor(x):
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
                 grad_comm=None, device=None):
        asked = dict(lint=lint, preemption=preemption, chaos=chaos,
                     grad_comm=grad_comm)
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
        # the batch signatures the JAX step would have compiled for, and
        # the last one per kind (the recompilation detector's input)
        self._signatures = set()
        self._last_sig = {}
        self._numerics = None
        self._sentinel_handle = None
        self._act_paths = []      # activation row paths, filled at 1st step
        self._grad_groups = []    # [(path, [param indices])]
        self._last_aux = None     # latest step's aux (device tensors)
        self._last_loss = None
        self._last_batch = None
        self._last_gen_state = None
        if numerics is not None:
            self.set_numerics(numerics)

    def _set_mesh(self, mesh, data_axes):
        """The mesh's groups: dp (batch rows, gradient average, the loss
        count), mp (the clip) and the world (found-inf); None where an
        axis has one rank."""
        self.mesh = mesh
        self.data_axes = tuple(data_axes)
        self._dp = self._mp = self._world = None
        self._sharded = [getattr(p, "mp_split", None) is not None
                         for p in self._params]
        if mesh is None:
            if any(self._sharded):
                raise ValueError("the model holds tensor-parallel shards; "
                                 "pass its mesh: TrainStep(mesh=...)")
            return
        if self.data_axes != ("dp",):
            raise ValueError(f"TrainStep(data_axes={data_axes!r}): the port "
                             f"splits the batch over ('dp',) only")
        extra = set(mesh.axis_names) - {"dp", "mp"}
        if extra:
            raise NotImplementedError(
                f"TrainStep(mesh=...) with axes {sorted(extra)}: only dp and "
                f"mp are ported; the others come with a later multi-GPU "
                f"slice (ROADMAP.md, queue item A4)")
        self._dp = axis_group("dp", mesh)
        self._mp = axis_group("mp", mesh)
        if mesh.size > 1:
            self._world = get_group()
            if self.device.type == "cuda" and self._world.backend != "nccl":
                raise ValueError("a CUDA step needs an NCCL process group")

    def set_numerics(self, numerics):
        """(Re)configure the numerics mode after construction: installs the
        module sentinels + per-layer grad grouping; the next call counts as
        a new executable, as the JAX step recompiles with the stats tree
        among its outputs. Pass None/False to disable."""
        from ..debugging import (NumericsConfig, check_layer_numerics,
                                 grad_layer_groups)
        self._numerics = NumericsConfig.coerce(numerics)
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
        return [self.optimizer.init_state(p, name=n)
                for p, n in zip(self._params, self._param_names)]

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
        if self._dp is not None:
            micro = [tuple(self._dp_rows(a) for a in mb) for mb in micro]
        loss_sum, acc, micro_rows = None, None, []
        for mb in micro:
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
        loss_sum, acc = self._dp_reduce(loss_sum, acc)
        return loss_sum, acc, rows

    def _dp_rows(self, a):
        """This dp rank's rows of a batch leaf (dim 0 cut into dp equal
        parts); scalars and non-tensors pass as they are."""
        if not torch.is_tensor(a) or a.dim() == 0:
            return a
        n, r = self._dp.nranks, self._dp.rank
        if a.shape[0] % n:
            raise ValueError(f"batch size {a.shape[0]} does not split over "
                             f"the {n} dp ranks")
        k = a.shape[0] // n
        return a[r * k:(r + 1) * k]

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
        loss, grads, act_rows = self._grads(batch, scale)
        numerics = self._numerics
        aux = {}
        with torch.no_grad():
            # unscale before the sentinels and the clip: the rows and the
            # update see true gradients
            if scale is not None:
                inv = torch.tensor(1.0, dtype=torch.float32,
                                   device=self.device) / scale
                grads = [g * inv.to(g.dtype) for g in grads]
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
                found = found_inf(grads)
            if found is not None and self._world is not None:
                # every rank skips the same steps
                flag = torch.tensor(float(found), device=grads[0].device)
                all_reduce(flag, ReduceOp.MAX, group=self._world)
                found = bool(flag)
            clip = self.optimizer._grad_clip
            if clip is not None:
                grads = clip(grads) if self._mp is None else \
                    clip(grads, sharded=self._sharded, group=self._mp)
            if not found:
                opt = self.optimizer
                for name, p, g, st in zip(self._param_names, self._params,
                                          grads, self._opt_state):
                    opt.update(p, g, st, lr, step_i, opt._wd_for(name),
                               name=name)
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
        self.memz.register(
            "train_params",
            lambda: int(sum(p.numel() * p.element_size()
                            for p in self._params)),
            kind="params", replace=True)
        self.memz.register(
            "train_opt_state",
            lambda: int(sum(v.numel() * v.element_size()
                            for st in (self._opt_state or ())
                            for v in (st or {}).values()
                            if torch.is_tensor(v))),
            kind="opt_state", replace=True)
        self.memz.sample("train_params", "train_opt_state")
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
        parameter name, the optimizer's scalars and the scaler."""
        out: Dict = {"step": int(self._step_i)}
        out["params"] = {n: p.detach().cpu().clone()
                         for n, p in zip(self._param_names, self._params)}
        if self._opt_state is not None:
            out["opt"] = {n: {k: v.detach().cpu().clone()
                              for k, v in (st or {}).items()}
                          for n, st in zip(self._param_names,
                                           self._opt_state)}
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
        the dtype it was saved in."""
        params = state.get("params", {})
        missing = [n for n in self._param_names if n not in params]
        if missing:
            raise KeyError(f"checkpoint is missing parameters: "
                           f"{missing[:5]}{'...' if len(missing) > 5 else ''}")
        for n, p in zip(self._param_names, self._params):
            src = _tensor(params[n], p.device)
            if tuple(src.shape) != tuple(p.shape):
                raise ValueError(f"{n}: checkpoint shape {tuple(src.shape)}"
                                 f" != parameter {tuple(p.shape)}")
            if src.dtype != p.dtype:
                p.data = src.clone()
            else:
                p.copy_(src)
        opt = state.get("opt")
        if opt is not None:
            if self._opt_state is None:
                self._opt_state = self._init_opt_state()
            self._opt_state = [
                {k: _tensor(v, p.device) for k, v in opt.get(n, {}).items()}
                or st
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
