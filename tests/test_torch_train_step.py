"""PyTorch port vs JAX package: the AdamW TrainStep (5-step trajectories
with weight decay, global-norm clipping and gradient accumulation, resume
from a JAX state dict, run_steps, and a loss-scaled overflow step).

Small f32 GPTs are built in the JAX package; their state dicts go through
`state_dict_from_paddle` into the port, and both sides see the same numpy
token ids. Tolerances: 1e-5 relative on losses, 1e-5 absolute on
parameters after 5 AdamW steps at lr 1e-3 (each step moves a parameter by
at most ~lr, so this is 1% of one step), 1e-6 absolute on moments.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as pt
from test_torch_train import (CFG_T, _assert_params_match, _ids, _jax_step,
                              _pair, _port_layout, _port_step)


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_trajectory_and_resume_match_jax(accum):
    """5 AdamW steps (decay with bias/LN exempt, global-norm clip at 1.0):
    the same losses and parameters; then a port TrainStep resumed from
    the JAX step's state dict after 3 steps follows the JAX run."""
    jm, tm = _pair(CFG_T)
    js, ts = _jax_step(jm, accum), _port_step(tm, accum)
    batches = [(_ids(4, 16, 128, 10 + i), _ids(4, 16, 128, 20 + i))
               for i in range(5)]
    saved = None
    for i, (a, b) in enumerate(batches):
        jl = float(js(paddle.to_tensor(a), paddle.to_tensor(b)))
        tl = float(ts(torch.from_numpy(a), torch.from_numpy(b)))
        assert tl == pytest.approx(jl, rel=1e-5), f"step {i + 1}"
        if i == 2:
            saved = js.state_dict()
    _assert_params_match(jm, tm)
    # resume: a fresh port model and step, fed the JAX state after step 3
    _, tm2 = _pair(CFG_T, seed=5)
    ts2 = _port_step(tm2, accum)
    ts2.set_state_dict(pt.train_state_from_paddle(saved, tm2))
    assert ts2._step_i == 3
    for a, b in batches[3:]:
        ts2(torch.from_numpy(a), torch.from_numpy(b))
    _assert_params_match(jm, tm2)
    moments = dict(zip(ts2._param_names, ts2._opt_state))
    for n, st in js.state_dict()["opt"].items():
        np.testing.assert_allclose(moments[n]["moment1"].numpy(),
                                   _port_layout(n, np.asarray(
                                       st["moment1"])), atol=1e-6, rtol=0)


def test_run_steps_equals_calls():
    _, tm = _pair(CFG_T)
    _, tm2 = _pair(CFG_T)
    a = np.stack([_ids(2, 16, 128, 30 + i) for i in range(3)])
    ts, ts2 = _port_step(tm, 1), _port_step(tm2, 1)
    losses = ts.run_steps(3, torch.from_numpy(a), torch.from_numpy(a))
    each = [float(ts2(torch.from_numpy(x), torch.from_numpy(x))) for x in a]
    np.testing.assert_allclose(losses.numpy(), each, rtol=1e-6)
    assert ts._step_i == ts2._step_i == 3
    for (n, p), (_, p2) in zip(tm.named_parameters(),
                               tm2.named_parameters()):
        assert torch.equal(p, p2), n


def test_grad_scaler_overflow_skips_the_update_like_jax():
    """An overflowing step leaves parameters and moments untouched and
    halves the scale; the next finite step updates as in JAX (step 2 of
    the bias correction)."""
    jm, tm = _pair(CFG_T)
    jsc = paddle.amp.GradScaler(init_loss_scaling=2.0 ** 10)
    tsc = pt.GradScaler(init_loss_scaling=2.0 ** 10)
    js = _jax_step(jm, 1, jsc,
                   loss=lambda a, b, k: jm.loss(a, b, chunk_size=8) * k)
    ts = _port_step(tm, 1, tsc,
                    loss=lambda a, b, k: tm.loss(a, b, chunk_size=8) * k)
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    a = _ids(4, 16, 128, 40)
    jl = float(js(paddle.to_tensor(a), paddle.to_tensor(a),
                  paddle.to_tensor(np.float32(1e38))))
    tl = float(ts(torch.from_numpy(a), torch.from_numpy(a),
                  torch.tensor(1e38)))
    assert not np.isfinite(jl) and not np.isfinite(tl)
    assert tsc._found_inf is True
    for n, p in tm.named_parameters():
        assert torch.equal(p, before[n]), n
    assert tsc.get_loss_scaling() == jsc.get_loss_scaling() == 2.0 ** 9
    assert tsc.state_dict() == jsc.state_dict()
    jl = float(js(paddle.to_tensor(a), paddle.to_tensor(a),
                  paddle.to_tensor(np.float32(1.0))))
    tl = float(ts(torch.from_numpy(a), torch.from_numpy(a),
                  torch.tensor(1.0)))
    assert tl == pytest.approx(jl, rel=1e-5)
    assert tsc.state_dict() == jsc.state_dict()
    _assert_params_match(jm, tm)
