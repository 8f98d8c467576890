"""The training step (the port of paddle_tpu/jit/train_step.py's TrainStep
core).

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
`state_dict()` / `set_state_dict()` carry the step, parameters, optimizer
state, optimizer scalars and the scaler, in the JAX layout (`params` and
`opt` keyed by parameter name). The JAX step's compilation, meshes,
monitors, numerics, lint, preemption, chaos, timeline, HBM ledger and
gradient-sync options are later slices; asking for one raises. Options
that only tune those (data axes, donation, the gradient-sync chunking) are
not accepted at all.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from ..amp.grad_scaler import GradScaler, found_inf
from ..device import resolve_device
from ..optimizer.lr import LRScheduler

_LATER = {"mesh": "the multi-chip slice", "monitor": "the telemetry slice",
          "numerics": "the numerics slice", "lint": "the graph-lint slice",
          "preemption": "the resilience slice", "chaos": "the resilience "
          "slice", "timeline": "the telemetry slice", "memz": "the HBM "
          "ledger slice", "grad_comm": "the multi-chip slice"}


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
    model's trainable parameters. ``device`` defaults to CUDA (raising
    without a card); the model must live on it."""

    def __init__(self, model, optimizer, loss_fn: Callable, mesh=None,
                 grad_accum_steps: int = 1, monitor=None, numerics=None,
                 scaler: GradScaler = None, lint=None, preemption=None,
                 chaos=None, timeline=None, memz=None, grad_comm=None,
                 device=None):
        asked = dict(mesh=mesh, monitor=monitor, numerics=numerics,
                     lint=lint, preemption=preemption, chaos=chaos,
                     timeline=timeline, memz=memz, grad_comm=grad_comm)
        for opt_name, value in asked.items():
            if value is not None and value is not False:
                raise NotImplementedError(
                    f"TrainStep({opt_name}=...) is not ported yet; it comes "
                    f"with {_LATER[opt_name]}")
        self.device = resolve_device(device)
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.grad_accum_steps = max(1, int(grad_accum_steps))
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
        self._scaler = scaler if (scaler is not None
                                  and scaler.is_enable()) else None
        self._opt_state = None
        self._step_i = 0

    # ------------------------------------------------------------------
    def _init_opt_state(self):
        return [self.optimizer.init_state(p, name=n)
                for p, n in zip(self._params, self._param_names)]

    def _grads(self, batch, scale):
        """(mean loss f32, gradients in the parameter dtype) over the
        microbatches of `batch`, the backward run on the scaled loss."""
        accum = self.grad_accum_steps
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
        loss_sum, acc = None, None
        for mb in micro:
            loss = self.loss_fn(*mb).float()
            scaled = loss * scale if scale is not None else loss
            grads = torch.autograd.grad(scaled, self._params,
                                        allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(self._params, grads)]
            loss = loss.detach()
            if accum == 1:
                return loss, grads
            loss_sum = loss / accum if loss_sum is None \
                else loss_sum + loss / accum
            if acc is None:
                acc = [torch.zeros_like(p) for p in self._params]
            acc = [a + (g / accum).to(a.dtype) for a, g in zip(acc, grads)]
        return loss_sum, acc

    def _step(self, batch, lr: float, step_i: int):
        if self._opt_state is None:
            self._opt_state = self._init_opt_state()
        scale = None
        if self._scaler is not None:
            scale = torch.tensor(self._scaler.state_arrays()[0],
                                 dtype=torch.float32, device=self.device)
        loss, grads = self._grads(batch, scale)
        with torch.no_grad():
            if scale is not None:
                inv = torch.tensor(1.0, dtype=torch.float32,
                                   device=self.device) / scale
                grads = [g * inv.to(g.dtype) for g in grads]
            found = found_inf(grads) if self._scaler is not None else None
            clip = self.optimizer._grad_clip
            if clip is not None:
                grads = clip(grads)
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
        return loss

    def __call__(self, *batch):
        """One step; returns the (unscaled) loss as a 0-d f32 tensor."""
        self._step_i += 1
        return self._step(batch, self.optimizer.get_lr(), self._step_i)

    def run_steps(self, n_steps: int, *stacked_batch):
        """n steps from batches stacked on dim 0 ([n, ...] per tensor), the
        learning rate read once; returns the per-step losses [n]."""
        lr = self.optimizer.get_lr()
        losses = []
        for i in range(int(n_steps)):
            losses.append(self._step(tuple(a[i] for a in stacked_batch), lr,
                                     self._step_i + 1))
            self._step_i += 1
        return torch.stack(losses)

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
