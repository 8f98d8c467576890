"""Dynamic loss scaling (the port of paddle_tpu/amp/grad_scaler.py).

The scale/good/bad bookkeeping is one pure rule (`_update_rule`) shared by
the eager `update()` and by `jit.TrainStep(scaler=...)`, which scales the
loss, unscales the gradients before clipping, skips the whole update
(parameters and optimizer state) when a gradient is not finite, and then
applies the rule. The state lives on the host: scale as an f32 value,
good and bad step counts as ints.
"""
from __future__ import annotations

import numpy as np
import torch


def _f32(x) -> float:
    return float(np.float32(x))


def found_inf(grads) -> bool:
    """True iff any gradient holds a non-finite value (one reduction on
    the device, one host read)."""
    if not grads:
        return False
    flags = torch.stack([torch.isfinite(g).all() for g in grads])
    return not bool(flags.all())


class GradScaler:
    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = _f32(init_loss_scaling) if enable else 1.0
        self._incr_ratio, self._decr_ratio = incr_ratio, decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._unscaled_opts = set()

    def is_enable(self):
        return self._enable

    def scale(self, loss):
        if not self._enable:
            return loss
        return loss * torch.tensor(self._scale, dtype=loss.dtype,
                                   device=loss.device)

    def unscale_(self, optimizer):
        """Divide every `.grad` of the optimizer's parameters by the scale
        (once per step) and record whether any is non-finite."""
        if not self._enable or id(optimizer) in self._unscaled_opts:
            return
        self._unscaled_opts.add(id(optimizer))
        grads = []
        with torch.no_grad():
            for _, p in optimizer._param_list:
                if p.grad is None:
                    continue
                inv = torch.tensor(1.0, dtype=torch.float32,
                                   device=p.device) / self._scale
                p.grad.mul_(inv.to(p.grad.dtype))
                grads.append(p.grad)
        self._found_inf = found_inf(grads)

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)
        self.update()
        optimizer.clear_grad()

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()

    @staticmethod
    def _update_rule(scale, good, bad, found, *, incr_ratio, decr_ratio,
                     incr_every, decr_every):
        """(scale, good, bad, found) -> (scale', good', bad'): after a
        non-finite step the bad count grows and, at decr_every, the scale
        shrinks by decr_ratio (floored at 1); after incr_every finite steps
        it grows by incr_ratio."""
        found = bool(found)
        bad2 = bad + 1 if found else 0
        good2 = 0 if found else good + 1
        dec = bad2 >= decr_every
        inc = (not found) and good2 >= incr_every
        if dec:
            scale2 = max(_f32(scale * decr_ratio), 1.0)
        elif inc:
            scale2 = _f32(scale * incr_ratio)
        else:
            scale2 = _f32(scale)
        return scale2, (0 if inc else good2), (0 if dec else bad2)

    def _hyper(self) -> dict:
        return dict(incr_ratio=self._incr_ratio, decr_ratio=self._decr_ratio,
                    incr_every=self._incr_every, decr_every=self._decr_every)

    def state_arrays(self):
        """(scale, good, bad) for TrainStep."""
        return self._scale, self._good_steps, self._bad_steps

    def set_state_arrays(self, state, found_inf=None):
        self._scale, self._good_steps, self._bad_steps = state
        if found_inf is not None:
            self._found_inf = bool(found_inf)

    def update(self):
        if not (self._enable and self._dynamic):
            return
        self._scale, self._good_steps, self._bad_steps = self._update_rule(
            self._scale, self._good_steps, self._bad_steps,
            self._found_inf, **self._hyper())
        self._found_inf = False
        self._unscaled_opts.clear()

    def get_loss_scaling(self):
        return float(self._scale)

    def state_dict(self):
        return {"scale": float(self._scale), "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "good_steps": int(self._good_steps),
                "bad_steps": int(self._bad_steps)}

    def set_state_dict(self, state):
        self._scale = _f32(state.get("scale", self._scale))
        self._good_steps = int(state.get("good_steps", 0))
        self._bad_steps = int(state.get("bad_steps", 0))


AmpScaler = GradScaler
