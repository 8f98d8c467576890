"""Optimizers (the port of paddle_tpu/optimizer/optimizer.py's Optimizer
base, Adam and AdamW).

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
named ``param_{i}``); `apply_decay_param_fun(name)` and the state dict
use those names.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch

from ..convert import _Q_BLOCK, _is_linear_weight
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


def _jax_order(name, param) -> bool:
    """Whether the JAX package stores this parameter transposed (an
    ``nn.Linear`` weight, [in, out] there): its int8 moments are blocked
    in the JAX element order, so codes and scales carry over as they
    are."""
    return name is not None and _is_linear_weight(name, param.dim())


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
                         device)
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
        t = torch.tensor(float(step), dtype=torch.float32, device=dev)
        b1 = torch.tensor(self._beta1, dtype=torch.float32, device=dev)
        b2 = torch.tensor(self._beta2, dtype=torch.float32, device=dev)
        return m / (1 - torch.pow(b1, t)), v / (1 - torch.pow(b2, t))

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
        lr_t = torch.tensor(lr, dtype=torch.float32, device=param.device)
        new_p = p32 - lr_t * m_hat / (torch.sqrt(v_hat) + self._eps)
        self._store(param, state, new_p, m, v, flip)


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
    def update(self, param, grad, state, lr, step, wd=0.0, name=None):
        flip = _jax_order(name, param)
        g = grad.float()
        p32 = param.float()
        m, v = self._moments(state, g, flip)
        m_hat, v_hat = self._corrected(m, v, step, param.device)
        lr_t = torch.tensor(lr, dtype=torch.float32, device=param.device)
        p32 = p32 * (1 - lr_t * wd)      # decoupled decay
        new_p = p32 - lr_t * m_hat / (torch.sqrt(v_hat) + self._eps)
        self._store(param, state, new_p, m, v, flip)


__all__: List[str] = ["Optimizer", "Adam", "AdamW"]
