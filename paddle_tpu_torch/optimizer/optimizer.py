"""Optimizers (the port of paddle_tpu/optimizer/optimizer.py's Optimizer
base, Adam and AdamW).

Each optimizer is an update rule `update(param, grad, state, lr, step, wd)`
applied in place: the update math runs in f32 whatever the parameter's
dtype, and the result is cast back into the parameter, as in the JAX
package (no f32 master weights). It is the JAX arithmetic, not
`torch.optim`'s, so trajectories match the JAX package and the moments can
be stored in bf16 (`moment_dtype="bfloat16"`). The rule has two callers:
`Optimizer.step()` from the parameters' `.grad`, and `jit.TrainStep`.

Parameters are named: pass `model.named_parameters()` (or bare tensors,
named ``param_{i}``); `apply_decay_param_fun(name)` and the state dict
use those names.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from ..device import resolve_device
from ..nn.clip import ClipGradByGlobalNorm
from .lr import LRScheduler


def _named(parameters):
    """(name, tensor) pairs from named_parameters() pairs or bare tensors."""
    out = []
    for i, p in enumerate(parameters):
        if isinstance(p, tuple):
            out.append((str(p[0]), p[1]))
        else:
            out.append((f"param_{i}", p))
    return out


class Optimizer:
    """Base optimizer: float or scheduler learning rate, weight decay per
    parameter name (`_wd_for`), optional `grad_clip`
    (ClipGradByGlobalNorm). Subclasses implement `init_state` and
    `update`. ``device`` defaults to CUDA (raising without a card); every
    parameter must live on it."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, device=None):
        self._lr = learning_rate
        self._device = resolve_device(device)
        self._parameters = _named(parameters) if parameters is not None \
            else None
        for n, p in self._parameters or ():
            if p.device.type != self._device.type:
                raise ValueError(f"parameter {n} lives on {p.device}, the "
                                 f"optimizer on {self._device}; pass "
                                 f"device={p.device.type!r}")
        self._weight_decay = 0.0 if weight_decay is None else weight_decay
        if grad_clip is not None and not isinstance(grad_clip,
                                                    ClipGradByGlobalNorm):
            raise NotImplementedError(
                f"grad_clip={type(grad_clip).__name__}: the port clips by "
                f"global norm only (ClipGradByGlobalNorm); the other clips "
                f"are a later item")
        self._grad_clip = grad_clip
        self._step_count = 0
        self._states: Dict[str, dict] = {}

    # ------------------------------------------------------------- rule
    def init_state(self, param, name=None) -> dict:
        return {}

    def update(self, param, grad, state, lr, step, wd=0.0):
        raise NotImplementedError

    # -------------------------------------------------------- eager API
    def get_lr(self) -> float:
        if isinstance(self._lr, LRScheduler):
            return float(self._lr())
        return float(self._lr)

    def set_lr(self, value: float):
        if isinstance(self._lr, LRScheduler):
            raise RuntimeError("optimizer's lr is an LRScheduler; call "
                               "scheduler.step()")
        self._lr = value

    @property
    def _param_list(self):
        if self._parameters is None:
            raise ValueError("Optimizer created without parameters; pass "
                             "parameters=")
        return self._parameters

    def _wd_for(self, name) -> float:
        return float(self._weight_decay) if self._weight_decay else 0.0

    @torch.no_grad()
    def step(self):
        """One update from the parameters' `.grad` (parameters without a
        gradient are left alone)."""
        lr = self.get_lr()
        self._step_count += 1
        live = [(n, p) for n, p in self._param_list
                if p.grad is not None and p.requires_grad]
        grads = [p.grad for _, p in live]
        if self._grad_clip is not None:
            grads = self._grad_clip(grads)
        for (n, p), g in zip(live, grads):
            st = self._states.get(n)
            if st is None:
                st = self._states[n] = self.init_state(p, name=n)
            self.update(p, g, st, lr, self._step_count, self._wd_for(n))

    def clear_grad(self, set_to_zero: bool = False):
        for _, p in self._param_list:
            if p.grad is not None and set_to_zero:
                p.grad.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad

    # -------------------------------------------------------- state_dict
    def state_dict(self) -> dict:
        out = {"master_step": self._step_count}
        if isinstance(self._lr, LRScheduler):
            out["LR_Scheduler"] = self._lr.state_dict()
        for n, _ in self._param_list:
            for k, v in (self._states.get(n) or {}).items():
                out[f"{n}__{k}"] = v.detach().clone()
        return out

    def set_state_dict(self, state_dict: dict):
        self._step_count = int(state_dict.get("master_step", 0))
        if isinstance(self._lr, LRScheduler) and "LR_Scheduler" in \
                state_dict:
            self._lr.set_state_dict(dict(state_dict["LR_Scheduler"]))
        for n, p in self._param_list:
            prefix = f"{n}__"
            st = {k[len(prefix):]: torch.as_tensor(v).to(p.device)
                  for k, v in state_dict.items()
                  if isinstance(k, str) and k.startswith(prefix)}
            if st:
                self._states[n] = st


_MOMENT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class Adam(Optimizer):
    """Bias-corrected Adam with coupled L2 weight decay (the decay is added
    to the gradient). `moment_dtype` "float32" or "bfloat16" is the dtype
    the moments are stored in; the update always computes in f32."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, moment_dtype="float32", q8_param_fun=None,
                 device=None):
        if str(moment_dtype) in ("int8", "uint8") or q8_param_fun is not None:
            raise NotImplementedError(
                "blockwise int8 Adam moments (moment_dtype='int8', "
                "q8_param_fun) are a later item of the port")
        if str(moment_dtype) not in _MOMENT_DTYPES:
            raise ValueError(f"moment_dtype must be 'float32' or "
                             f"'bfloat16'; got {moment_dtype!r}")
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         device)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._moment_dtype = _MOMENT_DTYPES[str(moment_dtype)]

    def init_state(self, param, name=None) -> dict:
        return {"moment1": torch.zeros_like(param, dtype=self._moment_dtype),
                "moment2": torch.zeros_like(param, dtype=self._moment_dtype)}

    def _moments(self, state, g):
        b1, b2 = self._beta1, self._beta2
        m = b1 * state["moment1"].float() + (1 - b1) * g
        v = b2 * state["moment2"].float() + (1 - b2) * g * g
        return m, v

    def _corrected(self, m, v, step, dev):
        t = torch.tensor(float(step), dtype=torch.float32, device=dev)
        b1 = torch.tensor(self._beta1, dtype=torch.float32, device=dev)
        b2 = torch.tensor(self._beta2, dtype=torch.float32, device=dev)
        return m / (1 - torch.pow(b1, t)), v / (1 - torch.pow(b2, t))

    def _store(self, param, state, new_p, m, v):
        param.copy_(new_p.to(param.dtype))
        state["moment1"].copy_(m.to(state["moment1"].dtype))
        state["moment2"].copy_(v.to(state["moment2"].dtype))

    @torch.no_grad()
    def update(self, param, grad, state, lr, step, wd=0.0):
        g = grad.float()
        p32 = param.float()
        if wd:
            g = g + wd * p32     # coupled L2
        m, v = self._moments(state, g)
        m_hat, v_hat = self._corrected(m, v, step, param.device)
        lr_t = torch.tensor(lr, dtype=torch.float32, device=param.device)
        new_p = p32 - lr_t * m_hat / (torch.sqrt(v_hat) + self._eps)
        self._store(param, state, new_p, m, v)


class AdamW(Adam):
    """Adam with decoupled weight decay: p *= 1 - lr * wd before the Adam
    step. `apply_decay_param_fun(name)` returning False exempts a parameter
    (bias and LayerNorm, by the usual rule)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 moment_dtype="float32", q8_param_fun=None, device=None):
        if lr_ratio is not None:
            raise NotImplementedError("AdamW(lr_ratio=...) is a later item "
                                      "of the port")
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, moment_dtype=moment_dtype,
                         q8_param_fun=q8_param_fun, device=device)
        self._wd_coeff = weight_decay
        self._apply_decay_param_fun = apply_decay_param_fun

    def _wd_for(self, name) -> float:
        if self._apply_decay_param_fun is not None and \
                not self._apply_decay_param_fun(name):
            return 0.0
        return float(self._wd_coeff)

    @torch.no_grad()
    def update(self, param, grad, state, lr, step, wd=0.0):
        g = grad.float()
        p32 = param.float()
        m, v = self._moments(state, g)
        m_hat, v_hat = self._corrected(m, v, step, param.device)
        lr_t = torch.tensor(lr, dtype=torch.float32, device=param.device)
        p32 = p32 * (1 - lr_t * wd)      # decoupled decay
        new_p = p32 - lr_t * m_hat / (torch.sqrt(v_hat) + self._eps)
        self._store(param, state, new_p, m, v)


__all__: List[str] = ["Optimizer", "Adam", "AdamW"]
