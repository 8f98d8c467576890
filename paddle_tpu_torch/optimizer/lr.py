"""Learning-rate schedulers (the port of paddle_tpu/optimizer/lr.py: the
base class and all fifteen schedulers). Host-side Python with the
reference's stateful `.step()` contract, and `as_functional()` for a
pure `lr(step)`; no tensor is involved, so the arithmetic is the JAX
package's to the last bit. `ReduceOnPlateau.step(metrics)` takes a float
or anything with `.item()` (a 0-d tensor)."""
from __future__ import annotations

import copy
import math
from bisect import bisect_right


class LRScheduler:
    def __init__(self, learning_rate=0.1, last_epoch=-1, verbose=False):
        self.base_lr = float(learning_rate)
        self.last_epoch = last_epoch
        self.last_lr = self.base_lr
        self.verbose = verbose
        self.step()

    def get_lr(self) -> float:
        raise NotImplementedError

    def step(self, epoch=None):
        if epoch is None:
            self.last_epoch += 1
        else:
            self.last_epoch = epoch
        self.last_lr = self.get_lr()

    def __call__(self):
        return self.last_lr

    def state_dict(self):
        return {k: v for k, v in self.__dict__.items()
                if isinstance(v, (int, float, bool, str, list))}

    def set_state_dict(self, state):
        self.__dict__.update(state)

    def as_functional(self):
        """A pure function step -> lr over a copy of this scheduler."""
        proto = copy.deepcopy(self)

        def lr_fn(step: int) -> float:
            proto.last_epoch = step - 1
            proto.step()
            return proto.last_lr
        return lr_fn


class NoamDecay(LRScheduler):
    def __init__(self, d_model, warmup_steps, learning_rate=1.0,
                 last_epoch=-1, verbose=False):
        self.d_model, self.warmup_steps = d_model, warmup_steps
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = max(self.last_epoch, 1)
        return (self.base_lr * self.d_model ** -0.5 *
                min(step ** -0.5, step * self.warmup_steps ** -1.5))


class PiecewiseDecay(LRScheduler):
    def __init__(self, boundaries, values, last_epoch=-1, verbose=False):
        self.boundaries, self.values = list(boundaries), list(values)
        super().__init__(values[0], last_epoch, verbose)

    def get_lr(self):
        return self.values[bisect_right(self.boundaries, self.last_epoch)]


class NaturalExpDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * math.exp(-self.gamma * self.last_epoch)


class InverseTimeDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr / (1 + self.gamma * self.last_epoch)


class PolynomialDecay(LRScheduler):
    def __init__(self, learning_rate, decay_steps, end_lr=0.0001, power=1.0,
                 cycle=False, last_epoch=-1, verbose=False):
        self.decay_steps, self.end_lr = decay_steps, end_lr
        self.power, self.cycle = power, cycle
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = self.last_epoch
        decay_steps = self.decay_steps
        if self.cycle:
            div = math.ceil(step / decay_steps) if step > 0 else 1
            decay_steps = decay_steps * div
        else:
            step = min(step, decay_steps)
        return ((self.base_lr - self.end_lr) *
                (1 - step / decay_steps) ** self.power + self.end_lr)


class LinearWarmup(LRScheduler):
    """Linear ramp from start_lr to end_lr over warmup_steps, then
    `learning_rate` (a float, or a scheduler continued from step 0)."""

    def __init__(self, learning_rate, warmup_steps, start_lr, end_lr,
                 last_epoch=-1, verbose=False):
        self.lr_sched = learning_rate if isinstance(
            learning_rate, LRScheduler) else None
        self.final_lr = learning_rate if not isinstance(
            learning_rate, LRScheduler) else None
        self.warmup_steps, self.start_lr, self.end_lr = \
            warmup_steps, start_lr, end_lr
        super().__init__(start_lr, last_epoch, verbose)

    def get_lr(self):
        if self.last_epoch < self.warmup_steps:
            return ((self.end_lr - self.start_lr) * self.last_epoch
                    / self.warmup_steps + self.start_lr)
        if self.lr_sched is not None:
            self.lr_sched.last_epoch = self.last_epoch - self.warmup_steps
            return self.lr_sched.get_lr()
        return self.final_lr

    def state_dict(self):
        d = super().state_dict()
        if self.lr_sched is not None:
            d["lr_sched"] = self.lr_sched.state_dict()
        return d

    def set_state_dict(self, state):
        sub = state.pop("lr_sched", None)
        super().set_state_dict(state)
        if sub and self.lr_sched is not None:
            self.lr_sched.set_state_dict(sub)


class ExponentialDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.gamma ** self.last_epoch


class MultiStepDecay(LRScheduler):
    def __init__(self, learning_rate, milestones, gamma=0.1, last_epoch=-1,
                 verbose=False):
        self.milestones, self.gamma = list(milestones), gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.gamma ** bisect_right(self.milestones,
                                                         self.last_epoch)


class StepDecay(LRScheduler):
    def __init__(self, learning_rate, step_size, gamma=0.1, last_epoch=-1,
                 verbose=False):
        self.step_size, self.gamma = step_size, gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.gamma ** (self.last_epoch
                                             // self.step_size)


class LambdaDecay(LRScheduler):
    def __init__(self, learning_rate, lr_lambda, last_epoch=-1,
                 verbose=False):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.lr_lambda(self.last_epoch)

    def state_dict(self):
        return {k: v for k, v in super().state_dict().items()
                if k != "lr_lambda"}


class MultiplicativeDecay(LRScheduler):
    def __init__(self, learning_rate, lr_lambda, last_epoch=-1,
                 verbose=False):
        self.lr_lambda = lr_lambda
        self._cur = float(learning_rate)
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        if self.last_epoch > 0:
            self._cur = self._cur * self.lr_lambda(self.last_epoch)
        return self._cur


class CosineAnnealingDecay(LRScheduler):
    def __init__(self, learning_rate, T_max, eta_min=0, last_epoch=-1,
                 verbose=False):
        self.T_max, self.eta_min = T_max, eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return (self.eta_min + (self.base_lr - self.eta_min)
                * (1 + math.cos(math.pi * self.last_epoch / self.T_max)) / 2)


class ReduceOnPlateau(LRScheduler):
    """Lowers the rate by `factor` after `patience` steps without
    improvement; its `step(metrics)` reads the metric, never `get_lr`."""

    def __init__(self, learning_rate, mode="min", factor=0.1, patience=10,
                 threshold=1e-4, threshold_mode="rel", cooldown=0, min_lr=0,
                 epsilon=1e-8, verbose=False):
        self.mode, self.factor, self.patience = mode, factor, patience
        self.threshold, self.threshold_mode = threshold, threshold_mode
        self.cooldown, self.min_lr, self.epsilon = cooldown, min_lr, epsilon
        self.best = None
        self.cooldown_counter = 0
        self.num_bad_epochs = 0
        self.base_lr = float(learning_rate)
        self.last_lr = self.base_lr
        self.last_epoch = 0
        self.verbose = verbose

    def get_lr(self):
        return self.last_lr

    def step(self, metrics=None, epoch=None):
        if metrics is None:
            return
        current = float(metrics.item() if hasattr(metrics, "item")
                        else metrics)
        self.last_epoch += 1
        if self.best is None:
            self.best = current
            return
        if self.mode == "max":
            better = (current > self.best + abs(self.best) * self.threshold
                      if self.threshold_mode == "rel"
                      else current > self.best + self.threshold)
        else:
            better = (current < self.best - abs(self.best) * self.threshold
                      if self.threshold_mode == "rel"
                      else current < self.best - self.threshold)
        if better:
            self.best = current
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        if self.num_bad_epochs > self.patience:
            new_lr = max(self.last_lr * self.factor, self.min_lr)
            if self.last_lr - new_lr > self.epsilon:
                self.last_lr = new_lr
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0


class OneCycleLR(LRScheduler):
    """Warm up to `max_learning_rate` over `phase_pct` of `total_steps`,
    then anneal to `end_learning_rate`. `three_phase` is accepted and
    ignored, as in the JAX package."""

    def __init__(self, max_learning_rate, total_steps, divide_factor=25.0,
                 end_learning_rate=0.0001, phase_pct=0.3,
                 anneal_strategy="cos", three_phase=False, last_epoch=-1,
                 verbose=False):
        self.max_lr = max_learning_rate
        self.total_steps = total_steps
        self.initial_lr = max_learning_rate / divide_factor
        self.end_lr = end_learning_rate
        self.phase_pct = phase_pct
        self.anneal = anneal_strategy
        super().__init__(self.initial_lr, last_epoch, verbose)

    def _interp(self, start, end, pct):
        if self.anneal == "cos":
            return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1)
        return (end - start) * pct + start

    def get_lr(self):
        step = self.last_epoch
        up_steps = int(self.phase_pct * self.total_steps)
        if step <= up_steps:
            return self._interp(self.initial_lr, self.max_lr,
                                step / max(up_steps, 1))
        down = (step - up_steps) / max(self.total_steps - up_steps, 1)
        return self._interp(self.max_lr, self.end_lr, min(down, 1.0))


class CyclicLR(LRScheduler):
    """Triangular cycles between the two rates ("triangular",
    "triangular2", "exp_range"). `scale_fn` and `scale_mode` are accepted
    and ignored, as in the JAX package."""

    def __init__(self, base_learning_rate, max_learning_rate, step_size_up,
                 step_size_down=None, mode="triangular", exp_gamma=1.0,
                 scale_fn=None, scale_mode="cycle", last_epoch=-1,
                 verbose=False):
        self.max_lr = max_learning_rate
        self.step_up = step_size_up
        self.step_down = step_size_down or step_size_up
        self.mode, self.exp_gamma = mode, exp_gamma
        super().__init__(base_learning_rate, last_epoch, verbose)

    def get_lr(self):
        cycle_len = self.step_up + self.step_down
        cycle = math.floor(1 + self.last_epoch / cycle_len)
        x = self.last_epoch - (cycle - 1) * cycle_len
        if x < self.step_up:
            pct = x / self.step_up
        else:
            pct = 1 - (x - self.step_up) / self.step_down
        amp = self.max_lr - self.base_lr
        if self.mode == "triangular2":
            amp = amp / (2 ** (cycle - 1))
        elif self.mode == "exp_range":
            amp = amp * (self.exp_gamma ** self.last_epoch)
        return self.base_lr + amp * pct


__all__ = ["LRScheduler", "NoamDecay", "PiecewiseDecay", "NaturalExpDecay",
           "InverseTimeDecay", "PolynomialDecay", "LinearWarmup",
           "ExponentialDecay", "MultiStepDecay", "StepDecay", "LambdaDecay",
           "MultiplicativeDecay", "CosineAnnealingDecay", "ReduceOnPlateau",
           "OneCycleLR", "CyclicLR"]
