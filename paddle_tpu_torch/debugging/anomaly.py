"""Anomaly detection over the numerics stats stream (the port of
paddle_tpu/debugging/anomaly.py; host-only).

Consumes StatsTree fetches (plus the loss / global grad-norm scalars the
step already produces) and turns them into structured NumericsEvents:

  nan / inf        — a stats row counted non-finite values; the event names
                     the offending layer's qualified path
  grad_explosion   — global grad norm is a rolling-z-score outlier
  loss_spike       — loss is a rolling-z-score outlier (or non-finite)
  dead_layer       — an activation row's absmax collapsed to ~0

The detectors are host-side and only run when stats are actually fetched
(every N steps / on demand), so the step never pays for them.
Reference analog: the TensorCheckerConfig debug modes (CHECK_NAN_INF_AND_ABORT
etc.) of paddle.amp.debugging — here abort is one policy (raise_on_event)
rather than the only one.
"""
from __future__ import annotations

import collections
import json
import math
import time
from typing import Callable, Dict, List, Optional

from .sentinel import StatsTree


class NumericsEvent:
    """One detected numerics anomaly (structured; JSONL-friendly)."""

    __slots__ = ("kind", "step", "path", "value", "message", "details", "ts")

    def __init__(self, kind: str, step: int, path: Optional[str] = None,
                 value: Optional[float] = None, message: str = "",
                 details: Optional[dict] = None):
        self.kind = kind
        self.step = step
        self.path = path
        self.value = value
        self.message = message
        self.details = details or {}
        self.ts = time.time()

    def to_dict(self) -> dict:
        return {"kind": self.kind, "step": self.step, "path": self.path,
                "value": self.value, "message": self.message,
                "details": self.details, "ts": self.ts}

    def __repr__(self):
        loc = f" at {self.path}" if self.path else ""
        return f"NumericsEvent({self.kind}{loc}, step={self.step}: {self.message})"


class _Rolling:
    """Rolling mean/std window for z-score outlier tests."""

    def __init__(self, window: int):
        self.buf = collections.deque(maxlen=window)

    def zscore(self, x: float) -> Optional[float]:
        n = len(self.buf)
        if n < 2:
            return None
        mean = sum(self.buf) / n
        var = sum((v - mean) ** 2 for v in self.buf) / n
        std = math.sqrt(var)
        # floor the std so a perfectly flat history doesn't turn numerical
        # dust into an infinite z-score
        std = max(std, 1e-3 * abs(mean), 1e-12)
        return (x - mean) / std

    def push(self, x: float):
        self.buf.append(x)


class AnomalyDetector:
    """Stateful detector; call observe() with each fetched sample.

    min_history: z-score detectors stay silent until this many finite
    samples are in the window (a cold-start loss drop is not a spike).
    Non-finite rows fire every observation; dead_layer fires once per path
    until the layer comes back to life.
    """

    def __init__(self, window: int = 50, grad_z: float = 6.0,
                 loss_z: float = 6.0, dead_absmax: float = 1e-8,
                 min_history: int = 5):
        self.window = window
        self.grad_z = grad_z
        self.loss_z = loss_z
        self.dead_absmax = dead_absmax
        self.min_history = min_history
        self._grad = _Rolling(window)
        self._loss = _Rolling(window)
        self._dead_fired = set()
        self.events: List[NumericsEvent] = []

    # -- individual detectors -------------------------------------------
    def _nonfinite_events(self, step, tree: StatsTree) -> List[NumericsEvent]:
        out = []
        for path, r in tree.nonfinite_rows():
            kind = "nan" if r["nan"] else "inf"
            out.append(NumericsEvent(
                kind, step, path=path, value=r["nan"] or r["inf"],
                message=(f"{path}: {int(r['nan'])} NaN / {int(r['inf'])} Inf "
                         f"of {int(r['finite'] + r['nan'] + r['inf'])} elements"),
                details=r))
        return out

    def _dead_events(self, step, tree: StatsTree) -> List[NumericsEvent]:
        out = []
        for path, r in tree.rows():
            # activation rows only: zero grads and zero-init params
            # (biases!) are normal, a zero activation map is not
            if path.startswith(("grad:", "param:")):
                continue
            total = r["finite"] + r["nan"] + r["inf"]
            dead = total > 0 and not r["nan"] and not r["inf"] \
                and r["absmax"] <= self.dead_absmax
            if dead and path not in self._dead_fired:
                self._dead_fired.add(path)
                out.append(NumericsEvent(
                    "dead_layer", step, path=path, value=r["absmax"],
                    message=f"{path}: activation absmax {r['absmax']:.3g} ~ 0",
                    details=r))
            elif not dead:
                self._dead_fired.discard(path)
        return out

    def _scalar_event(self, step, kind, roll: _Rolling, x: Optional[float],
                      thresh: float) -> List[NumericsEvent]:
        if x is None:
            return []
        if not math.isfinite(x):
            return [NumericsEvent(kind, step, value=x,
                                  message=f"{kind.split('_')[0]} is {x}")]
        z = roll.zscore(x)
        fired = []
        if z is not None and len(roll.buf) >= self.min_history \
                and z > thresh:
            fired.append(NumericsEvent(
                kind, step, value=x,
                message=f"z-score {z:.1f} (window mean "
                        f"{sum(roll.buf) / len(roll.buf):.4g})",
                details={"zscore": z}))
        roll.push(x)
        return fired

    # -- entry point ----------------------------------------------------
    def observe(self, step: int, tree: Optional[StatsTree] = None,
                loss: Optional[float] = None,
                grad_norm: Optional[float] = None) -> List[NumericsEvent]:
        events: List[NumericsEvent] = []
        if tree is not None:
            events += self._nonfinite_events(step, tree)
            events += self._dead_events(step, tree)
        events += self._scalar_event(step, "loss_spike", self._loss, loss,
                                     self.loss_z)
        events += self._scalar_event(step, "grad_explosion", self._grad,
                                     grad_norm, self.grad_z)
        self.events.extend(events)
        return events


def write_events_jsonl(events, path: str):
    with open(path, "a") as f:
        for e in events:
            f.write(json.dumps(e.to_dict()) + "\n")
