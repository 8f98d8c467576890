"""Optimizers (the port of paddle_tpu/optimizer/optimizer.py: the Optimizer
base and all eleven optimizers, SGD, Momentum, Adam, AdamW, Adamax,
Adagrad, Adadelta, RMSProp, Lamb, LarsMomentum and DGCMomentum).

Each optimizer is an update rule `update(param, grad, state, lr, step, wd)`
applied in place: the update math runs in f32 whatever the parameter's
dtype, and the result is cast back into the parameter, as in the JAX
package (no f32 master weights). It is the JAX arithmetic, not
`torch.optim`'s, so trajectories match the JAX package and the moments can
be stored in bf16 (`moment_dtype="bfloat16"`) or as blockwise int8 codes
(`moment_dtype="int8"`, or `q8_param_fun(name)` for selected parameters).
The rule has two callers: `Optimizer.step()` from the parameters' `.grad`,
and `jit.TrainStep`.

Parameters are named: pass `model.named_parameters()` (or bare tensors,
named ``param_{i}``); `apply_decay_param_fun(name)`, Lamb's
`exclude_from_weight_decay_fn(name)` and the state dict use those names.
Every state tensor but Adam's is f32 and shaped like its parameter
(velocity, moments, accumulators). Weight decay is coupled L2 (added to
the gradient) except in AdamW (decoupled), Lamb (inside the trust-ratio
step) and LarsMomentum (inside the local rate).
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from ..convert import _Q_BLOCK, _is_linear_weight
from ..device import resolve_device
from ..nn.clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
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


_CLIPS = (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue)


class Optimizer:
    """Base optimizer: float or scheduler learning rate, weight decay per
    parameter name (`_wd_for`), optional `grad_clip` (ClipGradByGlobalNorm,
    ClipGradByNorm or ClipGradByValue; both callers apply it). Subclasses
    implement `init_state` and `update`. `name` is accepted and unused, as
    in the JAX package. ``device`` defaults to CUDA (raising without a
    card); every parameter must live on it."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None, device=None):
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
        if grad_clip is not None and not isinstance(grad_clip, _CLIPS):
            raise TypeError(
                f"grad_clip={type(grad_clip).__name__}: expected "
                f"ClipGradByGlobalNorm, ClipGradByNorm or ClipGradByValue")
        self._grad_clip = grad_clip
        self._step_count = 0
        self._states: Dict[str, dict] = {}

    # ------------------------------------------------------------- rule
    def init_state(self, param, name=None) -> dict:
        return {}

    def update(self, param, grad, state, lr, step, wd=0.0, name=None):
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
            self.update(p, g, st, lr, self._step_count, self._wd_for(n),
                        name=n)

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


def _blocks(x32):
    """x32 flattened, zero-padded to whole blocks: [nb, _Q_BLOCK]."""
    flat = x32.reshape(-1)
    pad = -flat.numel() % _Q_BLOCK
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.view(-1, _Q_BLOCK)


def _sqrt(x32):
    """The correctly rounded f32 square root (jnp.sqrt's): PyTorch's
    vectorised CPU sqrt is off by one unit in the last place for some
    inputs, so it is taken in f64 (exact to f32 after rounding, since 53 >=
    2 * 24 + 2 bits) and rounded back."""
    return torch.sqrt(x32.double()).float()


def _q8_encode(x32):
    """Blockwise signed-sqrt int8 codes of the first moment: r = sign(x) *
    sqrt(|x|) coded linearly per block of 2048 (the JAX package's
    `_q8_encode`). Returns (int8 codes [nb, 2048], f32 scales [nb] in the
    r domain, absmax / 127)."""
    blocks = _blocks(torch.sign(x32) * _sqrt(torch.abs(x32)))
    scale = blocks.abs().amax(dim=1) / 127.0
    q = torch.round(blocks / scale.clamp_min(1e-30)[:, None])
    return q.to(torch.int8), scale


def _q8_decode(q, scale, shape):
    r = (q.float() * scale[:, None]).reshape(-1)[:math.prod(shape)]
    r = r.reshape(shape)
    return torch.sign(r) * torch.square(r)


def _q8v_encode(v32):
    """Second moment: sqrt(v) as uint8 codes per block with max / 255
    scales (the JAX package's `_q8v_encode`)."""
    blocks = _blocks(_sqrt(v32.clamp_min(0.0)))
    scale = blocks.amax(dim=1) / 255.0
    q = torch.round(blocks / scale.clamp_min(1e-30)[:, None])
    return q.to(torch.uint8), scale


def _q8v_decode(q, scale, shape):
    """The +0.5 code bias acts as a per-block adaptive epsilon."""
    r = ((q.float() + 0.5) * scale[:, None]).reshape(-1)
    return torch.square(r[:math.prod(shape)].reshape(shape))


def _f32(x, dev):
    """A Python number as a f32 0-d tensor on dev (the JAX rules take the
    learning rate and the step as f32 arrays)."""
    return torch.tensor(float(x), dtype=torch.float32, device=dev)


def _one_minus_pow(beta, step, dev):
    """1 - beta ** step in f32 (jnp.power of a weak float and a f32)."""
    return 1 - torch.pow(_f32(beta, dev), _f32(step, dev))


def _coupled(grad, param, wd):
    """The f32 gradient with coupled L2 decay added (g + wd * p)."""
    g = grad.float()
    if wd:
        g = g + wd * param.float()
    return g


def _norm(x32):
    """The f32 Euclidean norm of a whole tensor (layout-independent)."""
    return torch.sqrt(torch.sum(torch.square(x32)))


def _jax_order(name, param) -> bool:
    """Whether the JAX package stores this parameter transposed (an
    ``nn.Linear`` weight, [in, out] there): its int8 moments are blocked
    in the JAX element order, so codes and scales carry over as they
    are."""
    return (name is not None and _is_linear_weight(name, param.dim())
            and not getattr(param, "keeps_paddle_layout", False))


class Adam(Optimizer):
    """Bias-corrected Adam with coupled L2 weight decay (the decay is added
    to the gradient). `moment_dtype` "float32" or "bfloat16" is the dtype
    the moments are stored in; "int8" stores both as blockwise 8-bit codes
    with a f32 scale per block of 2048 (state ``moment1_q``/``moment1_s``,
    signed-sqrt int8 codes of m, and ``moment2_q``/``moment2_s``, uint8
    codes of sqrt(v)), as does `q8_param_fun(name)` returning True for a
    selected parameter while the rest keep `moment_dtype`. The blocks run
    over the JAX package's element order (an ``nn.Linear`` weight's
    transpose), so a JAX int8 state carries over code for code. The
    update always computes in f32; rounding is half to even, as jnp.round
    rounds."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, moment_dtype="float32", q8_param_fun=None,
                 device=None):
        self._q8 = str(moment_dtype) in ("int8", "uint8")
        if not self._q8 and str(moment_dtype) not in _MOMENT_DTYPES:
            raise ValueError(f"moment_dtype must be 'float32', 'bfloat16' "
                             f"or 'int8'; got {moment_dtype!r}")
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         device=device)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._q8_param_fun = q8_param_fun
        self._moment_dtype = None if self._q8 else \
            _MOMENT_DTYPES[str(moment_dtype)]

    def init_state(self, param, name=None) -> dict:
        if self._q8 or (self._q8_param_fun is not None and name
                        and self._q8_param_fun(name)):
            zeros = torch.zeros(param.shape, dtype=torch.float32,
                                device=param.device)
            return self._pack(zeros, zeros)
        return {"moment1": torch.zeros_like(param, dtype=self._moment_dtype),
                "moment2": torch.zeros_like(param, dtype=self._moment_dtype)}

    @staticmethod
    def _pack(m, v):
        (mq, ms), (vq, vs) = _q8_encode(m), _q8v_encode(v)
        return {"moment1_q": mq, "moment1_s": ms,
                "moment2_q": vq, "moment2_s": vs}

    def _moments(self, state, g, flip=False):
        """(m, v) in f32 from the stored moments and g; int8 moments are
        decoded in the JAX order (transposed when `flip`)."""
        b1, b2 = self._beta1, self._beta2
        if "moment1_q" in state:
            shape = tuple(reversed(g.shape)) if flip else tuple(g.shape)
            m0 = _q8_decode(state["moment1_q"], state["moment1_s"], shape)
            v0 = _q8v_decode(state["moment2_q"], state["moment2_s"], shape)
            if flip:
                m0, v0 = m0.t(), v0.t()
        else:
            m0, v0 = state["moment1"].float(), state["moment2"].float()
        m = b1 * m0 + (1 - b1) * g
        v = b2 * v0 + (1 - b2) * g * g
        return m, v

    def _corrected(self, m, v, step, dev):
        return (m / _one_minus_pow(self._beta1, step, dev),
                v / _one_minus_pow(self._beta2, step, dev))

    def _store(self, param, state, new_p, m, v, flip=False):
        param.copy_(new_p.to(param.dtype))
        if "moment1_q" in state:
            if flip:
                m, v = m.t(), v.t()
            for k, t in self._pack(m, v).items():
                state[k].copy_(t)
            return
        state["moment1"].copy_(m.to(state["moment1"].dtype))
        state["moment2"].copy_(v.to(state["moment2"].dtype))

    @torch.no_grad()
    def update(self, param, grad, state, lr, step, wd=0.0, name=None):
        flip = _jax_order(name, param)
        g = grad.float()
        p32 = param.float()
        if wd:
            g = g + wd * p32     # coupled L2
        m, v = self._moments(state, g, flip)
        m_hat, v_hat = self._corrected(m, v, step, param.device)
        lr_t = _f32(lr, param.device)
        new_p = p32 - lr_t * m_hat / (torch.sqrt(v_hat) + self._eps)
        self._store(param, state, new_p, m, v, flip)


class AdamW(Adam):
    """Adam with decoupled weight decay: p *= 1 - lr * wd before the Adam
    step. `apply_decay_param_fun(name)` returning False exempts a parameter
    (bias and LayerNorm, by the usual rule). `lr_ratio` is accepted and
    never read, as in the JAX package (Paddle scales each parameter's rate
    by it)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 moment_dtype="float32", q8_param_fun=None, device=None):
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
    def update(self, param, grad, state, lr, step, wd=0.0, name=None):
        flip = _jax_order(name, param)
        g = grad.float()
        p32 = param.float()
        m, v = self._moments(state, g, flip)
        m_hat, v_hat = self._corrected(m, v, step, param.device)
        lr_t = _f32(lr, param.device)
        p32 = p32 * (1 - lr_t * wd)      # decoupled decay
        new_p = p32 - lr_t * m_hat / (torch.sqrt(v_hat) + self._eps)
        self._store(param, state, new_p, m, v, flip)


class SGD(Optimizer):
    """p - lr * g with coupled L2 decay; the gradient is rounded to the
    parameter's dtype before the step, as in the JAX rule."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None, device=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, device)

    @torch.no_grad()
    def update(self, param, grad, state, lr, step, wd=0.0, name=None):
        g = _coupled(grad, param, wd).to(param.dtype).float()
        param.copy_(param.float() - lr * g)


class Momentum(Optimizer):
    """Heavy-ball momentum (v = momentum * v + g, p -= lr * v; Nesterov:
    p -= lr * (g + momentum * v)) with coupled L2 decay and a f32 velocity
    whatever the parameter's dtype."""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 name=None, device=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, device)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def init_state(self, param, name=None) -> dict:
        return {"velocity": torch.zeros_like(param, dtype=torch.float32)}

    @torch.no_grad()
    def update(self, param, grad, state, lr, step, wd=0.0, name=None):
        g = _coupled(grad, param, wd)
        v = self._momentum * state["velocity"] + g
        upd = g + self._momentum * v if self._nesterov else v
        param.copy_(param.float() - lr * upd)
        state["velocity"] = v


class Adamax(Optimizer):
    """Adam with the infinity norm: u = max(beta2 * u, |g|), p -= lr / (1
    - beta1^t) * m / (u + epsilon); coupled L2 decay."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None, device=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, device)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def init_state(self, param, name=None) -> dict:
        return {"moment": torch.zeros_like(param, dtype=torch.float32),
                "inf_norm": torch.zeros_like(param, dtype=torch.float32)}

    @torch.no_grad()
    def update(self, param, grad, state, lr, step, wd=0.0, name=None):
        b1, b2 = self._beta1, self._beta2
        g = _coupled(grad, param, wd)
        m = b1 * state["moment"] + (1 - b1) * g
        u = torch.maximum(b2 * state["inf_norm"], torch.abs(g))
        rate = _f32(lr, param.device) / _one_minus_pow(b1, step,
                                                      param.device)
        param.copy_(param.float() - rate * m / (u + self._eps))
        state["moment"], state["inf_norm"] = m, u


class Adagrad(Optimizer):
    """acc += g^2, p -= lr * g / (sqrt(acc) + epsilon); the accumulator
    starts at `initial_accumulator_value`; coupled L2 decay."""

    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None, device=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, device)
        self._eps = epsilon
        self._init_acc = initial_accumulator_value

    def init_state(self, param, name=None) -> dict:
        return {"moment": torch.full_like(param, self._init_acc,
                                          dtype=torch.float32)}

    @torch.no_grad()
    def update(self, param, grad, state, lr, step, wd=0.0, name=None):
        g = _coupled(grad, param, wd)
        acc = state["moment"] + g * g
        param.copy_(param.float() - lr * g / (torch.sqrt(acc) + self._eps))
        state["moment"] = acc


class Adadelta(Optimizer):
    """Running averages of g^2 and of the squared update (rho); the step
    is g * sqrt(E[du^2] + eps) / sqrt(E[g^2] + eps), times lr; coupled L2
    decay."""

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None, device=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, device)
        self._eps, self._rho = epsilon, rho

    def init_state(self, param, name=None) -> dict:
        return {"avg_squared_grad": torch.zeros_like(param,
                                                     dtype=torch.float32),
                "avg_squared_update": torch.zeros_like(param,
                                                       dtype=torch.float32)}

    @torch.no_grad()
    def update(self, param, grad, state, lr, step, wd=0.0, name=None):
        rho, eps = self._rho, self._eps
        g = _coupled(grad, param, wd)
        e_g = rho * state["avg_squared_grad"] + (1 - rho) * g * g
        upd = g * torch.sqrt(state["avg_squared_update"] + eps) \
            / torch.sqrt(e_g + eps)
        e_u = rho * state["avg_squared_update"] + (1 - rho) * upd * upd
        param.copy_(param.float() - lr * upd)
        state["avg_squared_grad"], state["avg_squared_update"] = e_g, e_u


class RMSProp(Optimizer):
    """ms = rho * ms + (1 - rho) g^2 (centered: minus the running mean
    gradient squared), mom = momentum * mom + lr * g / sqrt(ms + eps),
    p -= mom; coupled L2 decay."""

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None, device=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, device)
        self._rho, self._eps = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def init_state(self, param, name=None) -> dict:
        st = {"mean_square": torch.zeros_like(param, dtype=torch.float32),
              "momentum": torch.zeros_like(param, dtype=torch.float32)}
        if self._centered:
            st["mean_grad"] = torch.zeros_like(param, dtype=torch.float32)
        return st

    @torch.no_grad()
    def update(self, param, grad, state, lr, step, wd=0.0, name=None):
        rho, eps = self._rho, self._eps
        g = _coupled(grad, param, wd)
        ms = rho * state["mean_square"] + (1 - rho) * g * g
        if self._centered:
            mg = rho * state["mean_grad"] + (1 - rho) * g
            denom = torch.sqrt(ms - mg * mg + eps)
            state["mean_grad"] = mg
        else:
            denom = torch.sqrt(ms + eps)
        mom = self._momentum * state["momentum"] + lr * g / denom
        param.copy_(param.float() - mom)
        state["mean_square"], state["momentum"] = ms, mom


class Lamb(Optimizer):
    """Layerwise adaptive large-batch Adam: r = m_hat / (sqrt(v_hat) + eps)
    + wd * p, p -= lr * (||p|| / ||r||) * r, the norms in f32 over the
    whole tensor (1 where either is 0).
    `exclude_from_weight_decay_fn(name)` returning True exempts a
    parameter; the JAX package passes its Parameter object, the port the
    parameter's name."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None, device=None):
        super().__init__(learning_rate, parameters, lamb_weight_decay,
                         grad_clip, name, device)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._exclude_fn = exclude_from_weight_decay_fn

    def _wd_for(self, name) -> float:
        if self._exclude_fn is not None and self._exclude_fn(name):
            return 0.0
        return float(self._weight_decay)

    def init_state(self, param, name=None) -> dict:
        return {"moment1": torch.zeros_like(param, dtype=torch.float32),
                "moment2": torch.zeros_like(param, dtype=torch.float32)}

    @torch.no_grad()
    def update(self, param, grad, state, lr, step, wd=0.0, name=None):
        b1, b2, dev = self._beta1, self._beta2, param.device
        g = grad.float()
        p32 = param.float()
        m = b1 * state["moment1"] + (1 - b1) * g
        v = b2 * state["moment2"] + (1 - b2) * g * g
        m_hat = m / _one_minus_pow(b1, step, dev)
        v_hat = v / _one_minus_pow(b2, step, dev)
        r = m_hat / (torch.sqrt(v_hat) + self._eps) + wd * p32
        w_norm, r_norm = _norm(p32), _norm(r)
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            1.0)
        param.copy_(p32 - _f32(lr, dev) * trust * r)
        state["moment1"], state["moment2"] = m, v


class LarsMomentum(Momentum):
    """Layer-wise adaptive rate scaling: the rate of each parameter is
    scaled by lars_coeff * ||w|| / (||g|| + wd * ||w|| + epsilon) (1 where
    either norm is 0), v = momentum * v + lr * local * (g + wd * w), w -=
    v."""

    def __init__(self, learning_rate=0.001, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, parameters=None, grad_clip=None,
                 epsilon=1e-9, name=None, device=None):
        super().__init__(learning_rate, momentum, parameters,
                         weight_decay=lars_weight_decay, grad_clip=grad_clip,
                         name=name, device=device)
        self._lars_coeff = lars_coeff
        self._eps = epsilon

    @torch.no_grad()
    def update(self, param, grad, state, lr, step, wd=0.0, name=None):
        g = grad.float()
        w = param.float()
        w_norm, g_norm = _norm(w), _norm(g)
        local_lr = torch.where(
            (w_norm > 0) & (g_norm > 0),
            self._lars_coeff * w_norm / (g_norm + wd * w_norm + self._eps),
            1.0)
        v = self._momentum * state["velocity"] \
            + _f32(lr, param.device) * local_lr * (g + wd * w)
        param.copy_(w - v)
        state["velocity"] = v


def quantile_linear(x, q: float):
    """`jnp.quantile(x, q)` of a flat f32 tensor (linear interpolation):
    the position q * (n - 1), its floor, ceiling and weights in f32 as JAX
    computes them, the two order statistics read from one sort (no
    `torch.quantile`, which refuses more than 2^24 elements). A NaN
    anywhere gives NaN, as in JAX."""
    n = x.numel()
    one, n32 = np.float32(1), np.float32(n)
    pos = np.float32(np.float32(q) * (n32 - one))
    low, high = np.floor(pos), np.ceil(pos)
    w_high = np.float32(pos - low)
    w_low = np.float32(one - w_high)
    low = int(np.clip(low, 0, n32 - one))
    high = int(np.clip(high, 0, n32 - one))
    xs = torch.sort(x).values
    out = xs[low] * float(w_low) + xs[high] * float(w_high)
    return torch.where(torch.isnan(x).any(), float("nan"), out)


class DGCMomentum(Momentum):
    """Deep gradient compression momentum, dense: u = momentum * u + g,
    acc = error + u; the entries with |acc| at or above the `sparsity`
    quantile of |acc| step (p -= lr * acc there) and the rest stay in
    `error`; coupled L2 decay."""

    def __init__(self, learning_rate=0.001, momentum=0.9, sparsity=0.999,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None, device=None):
        super().__init__(learning_rate, momentum, parameters,
                         weight_decay=weight_decay, grad_clip=grad_clip,
                         name=name, device=device)
        self._sparsity = float(sparsity)

    def init_state(self, param, name=None) -> dict:
        return {"velocity": torch.zeros_like(param, dtype=torch.float32),
                "error": torch.zeros_like(param, dtype=torch.float32)}

    @torch.no_grad()
    def update(self, param, grad, state, lr, step, wd=0.0, name=None):
        g = _coupled(grad, param, wd)
        u = self._momentum * state["velocity"] + g
        acc = state["error"] + u
        if acc.numel() > 1:
            thresh = quantile_linear(torch.abs(acc).reshape(-1),
                                     self._sparsity)
            mask = (torch.abs(acc) >= thresh).float()
        else:
            mask = torch.ones_like(acc)
        param.copy_(param.float() - lr * (acc * mask))
        state["velocity"], state["error"] = u, acc * (1.0 - mask)


__all__: List[str] = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW",
                      "Adamax", "Adagrad", "Adadelta", "RMSProp", "Lamb",
                      "LarsMomentum", "DGCMomentum"]
