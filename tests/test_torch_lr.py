"""PyTorch port vs JAX package: the fifteen learning-rate schedulers.

Host-side Python on both sides, so each scheduler's rate over 60 steps
must agree to 1e-12 (absolute and relative); the state dicts round-trip
into a fresh scheduler that continues on the same rates. Arguments the
JAX package accepts and ignores (`OneCycleLR(three_phase=)`,
`CyclicLR(scale_fn=, scale_mode=)`) are ignored by the port too.
"""
import math

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (keeps JAX on the CPU before paddle_tpu loads)

import paddle_tpu as paddle
from paddle_tpu.optimizer import lr as JL
from paddle_tpu_torch.optimizer import lr as TL
import paddle_tpu_torch as pt

STEPS = 60


def _lam(e):
    return 0.95 ** e


def _mul(e):
    return 0.97


CASES = {
    "NoamDecay": lambda M: M.NoamDecay(d_model=512, warmup_steps=10,
                                       learning_rate=2.0),
    "PiecewiseDecay": lambda M: M.PiecewiseDecay([10, 25, 40],
                                                 [0.1, 0.05, 0.01, 0.001]),
    "NaturalExpDecay": lambda M: M.NaturalExpDecay(0.1, gamma=0.05),
    "InverseTimeDecay": lambda M: M.InverseTimeDecay(0.1, gamma=0.3),
    "PolynomialDecay": lambda M: M.PolynomialDecay(0.1, decay_steps=20,
                                                   end_lr=0.001, power=2.0),
    "PolynomialDecay_cycle": lambda M: M.PolynomialDecay(
        0.1, decay_steps=15, end_lr=0.001, power=1.5, cycle=True),
    "LinearWarmup": lambda M: M.LinearWarmup(0.1, warmup_steps=12,
                                             start_lr=0.0, end_lr=0.1),
    "LinearWarmup_cosine": lambda M: M.LinearWarmup(
        M.CosineAnnealingDecay(0.1, T_max=40), warmup_steps=8,
        start_lr=0.001, end_lr=0.1),
    "ExponentialDecay": lambda M: M.ExponentialDecay(0.1, gamma=0.93),
    "MultiStepDecay": lambda M: M.MultiStepDecay(0.1, milestones=[7, 19, 33],
                                                 gamma=0.3),
    "StepDecay": lambda M: M.StepDecay(0.1, step_size=9, gamma=0.5),
    "LambdaDecay": lambda M: M.LambdaDecay(0.1, lr_lambda=_lam),
    "MultiplicativeDecay": lambda M: M.MultiplicativeDecay(0.1,
                                                           lr_lambda=_mul),
    "CosineAnnealingDecay": lambda M: M.CosineAnnealingDecay(
        0.1, T_max=25, eta_min=0.002),
    "OneCycleLR_cos": lambda M: M.OneCycleLR(0.2, total_steps=50),
    "OneCycleLR_linear": lambda M: M.OneCycleLR(
        0.2, total_steps=45, divide_factor=10.0, end_learning_rate=1e-5,
        phase_pct=0.4, anneal_strategy="linear"),
    "CyclicLR_triangular": lambda M: M.CyclicLR(0.01, 0.1, step_size_up=7,
                                                step_size_down=5),
    "CyclicLR_triangular2": lambda M: M.CyclicLR(
        0.01, 0.1, step_size_up=6, mode="triangular2"),
    "CyclicLR_exp_range": lambda M: M.CyclicLR(
        0.01, 0.1, step_size_up=6, mode="exp_range", exp_gamma=0.98),
}
# ReduceOnPlateau reads a metric: a loss that falls, stalls, rises and
# falls again, for both modes and both threshold modes
METRICS = ([1.0 - 0.02 * i for i in range(10)] + [0.8] * 12
           + [0.8 + 0.01 * i for i in range(10)]
           + [0.7 - 0.01 * i for i in range(28)])
PLATEAU = {
    "min_rel": dict(mode="min", patience=3, factor=0.5, cooldown=2),
    "min_abs": dict(mode="min", patience=2, factor=0.3,
                    threshold_mode="abs", threshold=0.005, min_lr=0.004),
    "max_rel": dict(mode="max", patience=4, factor=0.5),
}


def _close(a, b):
    assert a == pytest.approx(b, rel=1e-12, abs=1e-12)


def _rates(sched, n=STEPS):
    out = []
    for _ in range(n):
        out.append(sched())
        sched.step()
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_scheduler_matches_jax_over_60_steps(case):
    j, t = CASES[case](JL), CASES[case](TL)
    for a, b in zip(_rates(t), _rates(j)):
        _close(a, b)
    assert type(t).__name__ == type(j).__name__


@pytest.mark.parametrize("case", sorted(CASES))
def test_state_dict_round_trips_and_continues(case):
    """A port scheduler stepped 23 times, its state dict loaded into a
    fresh one (and the JAX one's into another): all three continue on the
    same rates."""
    t, j = CASES[case](TL), CASES[case](JL)
    _rates(t, 23), _rates(j, 23)
    t2, t3 = CASES[case](TL), CASES[case](TL)
    t2.set_state_dict(t.state_dict())
    t3.set_state_dict(j.state_dict())
    for a, b, c in zip(_rates(t2, 37), _rates(t3, 37), _rates(j, 37)):
        _close(a, c)
        _close(b, c)


@pytest.mark.parametrize("case", sorted(PLATEAU))
def test_reduce_on_plateau_matches_jax(case):
    kw = PLATEAU[case]
    j = JL.ReduceOnPlateau(0.1, **kw)
    t = TL.ReduceOnPlateau(0.1, **kw)
    metrics = METRICS if kw["mode"] == "min" else [-m for m in METRICS]
    seen = set()
    for i, m in enumerate(metrics):
        # a 0-d tensor and a float are both read through .item() / float
        t.step(torch.tensor(m, dtype=torch.float64) if i % 2 else m)
        j.step(m)
        _close(t(), j())
        seen.add(t())
    assert len(seen) > 1          # the rate did drop
    t.step(None)                  # no metric: no step, as in JAX
    assert t.last_epoch == j.last_epoch == len(metrics)
    t2 = TL.ReduceOnPlateau(0.1, **kw)
    t2.set_state_dict(t.state_dict())
    for m in metrics[:10]:
        t2.step(m)
        j.step(m)
        _close(t2(), j())


def test_ignored_arguments_are_ignored_as_in_jax():
    """`three_phase`, `scale_fn` and `scale_mode` change nothing on
    either side; `verbose` is stored."""
    for M in (TL, JL):
        a = _rates(M.OneCycleLR(0.2, total_steps=30))
        b = _rates(M.OneCycleLR(0.2, total_steps=30, three_phase=True))
        assert a == b
        c = _rates(M.CyclicLR(0.01, 0.1, step_size_up=4))
        d = _rates(M.CyclicLR(0.01, 0.1, step_size_up=4,
                              scale_fn=lambda x: 0.0, scale_mode="iterations"))
        assert c == d
        assert M.StepDecay(0.1, 3, verbose=True).verbose is True


def test_as_functional_is_pure_and_matches_jax():
    for case in ("LinearWarmup_cosine", "MultiStepDecay", "OneCycleLR_cos"):
        t, j = CASES[case](TL), CASES[case](JL)
        ft, fj = t.as_functional(), j.as_functional()
        for s in (1, 5, 30, 2, 44):
            _close(ft(s), fj(s))
        assert t.last_epoch == 0          # the scheduler itself is untouched


def test_all_fifteen_are_exported_under_the_jax_names():
    names = ["NoamDecay", "PiecewiseDecay", "NaturalExpDecay",
             "InverseTimeDecay", "PolynomialDecay", "LinearWarmup",
             "ExponentialDecay", "MultiStepDecay", "StepDecay", "LambdaDecay",
             "MultiplicativeDecay", "CosineAnnealingDecay", "ReduceOnPlateau",
             "OneCycleLR", "CyclicLR"]
    for n in names:
        assert getattr(pt.optimizer.lr, n) is getattr(pt.optimizer, n)
        assert hasattr(paddle.optimizer.lr, n)


def test_optimizer_reads_the_scheduler_rate_once_per_step():
    """The port's optimizer reads the scheduler's current rate
    (`scheduler()`), so `get_lr()` is the same however often it is called.
    The JAX optimizer calls `get_lr()` on the scheduler, which for
    MultiplicativeDecay multiplies again on every call: a divergence
    (ROADMAP C1) in which the port keeps the scheduler's own rate."""
    p = torch.nn.Parameter(torch.ones(3))
    ts = TL.MultiplicativeDecay(0.1, lr_lambda=_mul)
    opt = pt.SGD(ts, parameters=[p], device="cpu")
    js = JL.MultiplicativeDecay(0.1, lr_lambda=_mul)
    jopt = paddle.optimizer.SGD(js, parameters=[paddle.create_parameter(
        [3], "float32")])
    for _ in range(4):
        ts.step()
        js.step()
    assert opt.get_lr() == opt.get_lr() == ts() == pytest.approx(
        0.1 * 0.97 ** 4, rel=1e-12)
    first, second = jopt.get_lr(), jopt.get_lr()
    assert first == pytest.approx(0.1 * 0.97 ** 5, rel=1e-12)
    assert second == pytest.approx(0.1 * 0.97 ** 6, rel=1e-12)
    # every other scheduler's get_lr is idempotent: both read the same
    for case in sorted(set(CASES) - {"MultiplicativeDecay"}):
        t, j = CASES[case](TL), CASES[case](JL)
        for _ in range(17):
            t.step()
            j.step()
        o = pt.SGD(t, parameters=[p], device="cpu")
        jo = paddle.optimizer.SGD(j, parameters=[paddle.create_parameter(
            [3], "float32")])
        _close(o.get_lr(), jo.get_lr())
        assert not math.isnan(o.get_lr())
    np.testing.assert_equal(p.detach().numpy(), np.ones(3, np.float32))
