"""Learning-rate schedulers (the port of paddle_tpu/optimizer/lr.py's
LRScheduler, LinearWarmup and CosineAnnealingDecay: a pretraining run's
schedule). Host-side Python with the reference's stateful `.step()`
contract; the other schedulers are a later item."""
from __future__ import annotations

import math


class LRScheduler:
    def __init__(self, learning_rate=0.1, last_epoch=-1):
        self.base_lr = float(learning_rate)
        self.last_epoch = last_epoch
        self.last_lr = self.base_lr
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


class LinearWarmup(LRScheduler):
    """Linear ramp from start_lr to end_lr over warmup_steps, then
    `learning_rate` (a float, or a scheduler continued from step 0)."""

    def __init__(self, learning_rate, warmup_steps, start_lr, end_lr,
                 last_epoch=-1):
        self.lr_sched = learning_rate if isinstance(
            learning_rate, LRScheduler) else None
        self.final_lr = learning_rate if not isinstance(
            learning_rate, LRScheduler) else None
        self.warmup_steps, self.start_lr, self.end_lr = \
            warmup_steps, start_lr, end_lr
        super().__init__(start_lr, last_epoch)

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


class CosineAnnealingDecay(LRScheduler):
    def __init__(self, learning_rate, T_max, eta_min=0, last_epoch=-1):
        self.T_max, self.eta_min = T_max, eta_min
        super().__init__(learning_rate, last_epoch)

    def get_lr(self):
        return (self.eta_min + (self.base_lr - self.eta_min)
                * (1 + math.cos(math.pi * self.last_epoch / self.T_max)) / 2)
