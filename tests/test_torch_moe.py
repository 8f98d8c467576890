"""PyTorch port vs JAX package: the MoE layer
(paddle_tpu_torch.incubate.distributed.models.moe).

The JAX MoELayer's state dict carries over by name (no transposes); both
sides see the same numpy tokens, in f32. Integer routing (expert ids,
capacity slots, keep flags, the dispatch mask) must be exact; gate values
agree to 1e-6, layer outputs and the aux loss to 1e-5, every gradient to
1e-4 of the gradient's largest entry (f32, summation order only).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu.incubate.distributed.models.moe import MoELayer as JMoE
from paddle_tpu.incubate.distributed.models.moe import moe_layer as JML
from paddle_tpu_torch.incubate.distributed.models import moe as TM
from paddle_tpu_torch.incubate.distributed.models.moe import moe_layer as TML

M, HID, E = 16, 32, 4
B, S = 2, 24


def _pair(gate, cf, e=E, seed=0):
    paddle.seed(seed)
    jm = JMoE(M, HID, e, gate=gate, capacity_factor=cf)
    tm = TM.MoELayer(M, HID, e, gate=gate, capacity_factor=cf, device="cpu")
    tm.load_state_dict({k: torch.from_numpy(np.array(v))
                        for k, v in jm.state_dict().items()})
    return jm, tm


def _x(seed=0, shape=(B, S, M)):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _probs(n, e, seed):
    lg = np.random.RandomState(seed).randn(n, e).astype(np.float32) * 2
    p = np.exp(lg - lg.max(-1, keepdims=True))
    return (p / p.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("n, e, k, cf", [
    (1, 8, 2, 1.0), (7, 8, 2, 1.0), (48, 4, 2, 1.25), (48, 4, 1, 1.25),
    (2048, 8, 2, 1.0), (8192, 8, 2, 1.0), (8192, 8, 2, 1.25),
    (100, 3, 3, 0.5), (16384, 8, 2, 4.0), (5, 64, 1, 1.0)])
def test_capacity_matches_jax(n, e, k, cf):
    """The multiple of 4 and the floor of 4."""
    c = TML._capacity(n, e, k, cf)
    assert c == JML._capacity(n, e, k, cf)
    assert c % 4 == 0 and c >= 4


@pytest.mark.parametrize("k, cap", [(1, 4), (2, 8), (2, 12), (3, 8)])
def test_topk_routing_matches_jax(k, cap):
    """Expert ids, slots and keep flags exact (slot-major ranking: every
    slot-0 assignment before every slot-1 one), gate values to 1e-6."""
    probs = _probs(40, 6, seed=k * 10 + cap)
    jg, ji, jl, jk, jf = (np.asarray(a) for a in JML._topk_routing(
        jnp.asarray(probs), k, cap))
    tg, ti, tl, tk, tf = TML._topk_routing(torch.from_numpy(probs), k, cap)
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_array_equal(tl.numpy(), jl)
    np.testing.assert_array_equal(tk.numpy(), jk)
    np.testing.assert_allclose(tg.numpy(), jg, atol=1e-6, rtol=0)
    np.testing.assert_allclose(tf.numpy(), jf, atol=1e-6, rtol=0)
    assert not tk.all() and tk.any()        # the capacity binds


@pytest.mark.parametrize("k, cap", [(1, 4), (2, 8), (3, 8)])
def test_topk_dispatch_matches_jax(k, cap):
    """The one-hot form: the dispatch mask exact, combine weights to
    1e-6."""
    probs = _probs(40, 6, seed=k + cap)
    jc, jd, jf = (np.asarray(a) for a in JML._topk_dispatch(
        jnp.asarray(probs), k, cap))
    tc, td, tf = TML._topk_dispatch(torch.from_numpy(probs), k, cap)
    np.testing.assert_array_equal(td.numpy(), jd)
    np.testing.assert_allclose(tc.numpy(), jc, atol=1e-6, rtol=0)
    np.testing.assert_allclose(tf.numpy(), jf, atol=1e-6, rtol=0)


def test_topk_ties_go_to_the_lower_expert_as_in_jax():
    """Equal probabilities pick the lower expert id first, as lax.top_k
    does; a row of all-equal values picks experts 0 and 1."""
    probs = np.array([[0.25, 0.25, 0.25, 0.25],
                      [0.1, 0.4, 0.1, 0.4],
                      [0.3, 0.2, 0.3, 0.2],
                      [0.0, 0.5, 0.0, 0.5]], np.float32)
    for k in (1, 2, 3):
        ji = np.asarray(JML._topk_routing(jnp.asarray(probs), k, 8)[1])
        ti = TML._topk_routing(torch.from_numpy(probs), k, 8)[1].numpy()
        np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(
        TML._topk_routing(torch.from_numpy(probs), 2, 8)[1].numpy(),
        [[0, 1], [1, 3], [0, 2], [1, 3]])


def _run_jax(jm, x, gl):
    jm.clear_gradients()
    xt = paddle.to_tensor(x, stop_gradient=False)
    glt = None if gl is None else paddle.to_tensor(gl, stop_gradient=False)
    y = jm(xt, gate_logits=glt)
    w = paddle.to_tensor(np.linspace(-1, 1, y.size, dtype=np.float32)
                         .reshape(y.shape))
    loss = paddle.sum(y * w) + 0.1 * jm.aux_loss
    loss.backward()
    grads = {n: p.grad.numpy() for n, p in jm.named_parameters()
             if p.grad is not None}
    grads["x"] = xt.grad.numpy()
    if glt is not None:
        grads["gate_logits"] = glt.grad.numpy()
    return y.numpy(), float(jm.aux_loss), grads


def _run_port(tm, x, gl):
    tm.zero_grad(set_to_none=True)
    xt = torch.from_numpy(x).requires_grad_()
    glt = None if gl is None else torch.from_numpy(gl).requires_grad_()
    y = tm(xt, gate_logits=glt)
    w = torch.linspace(-1, 1, y.numel()).reshape(y.shape)
    loss = (y * w).sum() + 0.1 * tm.aux_loss
    loss.backward()
    grads = {n: p.grad.numpy() for n, p in tm.named_parameters()
             if p.grad is not None}
    grads["x"] = xt.grad.numpy()
    if glt is not None:
        grads["gate_logits"] = glt.grad.numpy()
    return y.detach().numpy(), float(tm.aux_loss.detach()), grads


def _gate_logits(seed):
    return np.random.RandomState(seed).randn(B, S, E).astype(np.float32)


@pytest.mark.parametrize("ext", [False, True])
@pytest.mark.parametrize("cf", [1.0, 1.25, 4.0])
@pytest.mark.parametrize("gate", ["naive", "gshard", "switch"])
def test_moe_layer_forward_aux_and_every_grad_match_jax(gate, cf, ext):
    """Forward to 1e-5, the aux loss to 1e-5, and the gradients of the
    inputs, the external gate logits and every parameter to 1e-4 of each
    gradient's largest entry."""
    jm, tm = _pair(gate, cf)
    x = _x(1)
    gl = _gate_logits(2) if ext else None
    jy, jaux, jg = _run_jax(jm, x, gl)
    ty, taux, tg = _run_port(tm, x, gl)
    np.testing.assert_allclose(ty, jy, atol=1e-5, rtol=0)
    assert taux == pytest.approx(jaux, abs=1e-5)
    if gate == "naive":
        assert taux == 0.0
    if ext:
        # routed by the given logits, the router weight is not used: JAX
        # gives it a zero gradient, the port none
        assert "gate_weight" not in tg
        assert not jg.pop("gate_weight").any()
    assert set(tg) == set(jg)
    for n, g in jg.items():
        scale = max(float(np.abs(g).max()), 1e-6)
        np.testing.assert_allclose(tg[n], g, atol=1e-4 * scale, rtol=0,
                                   err_msg=n)


@pytest.mark.parametrize("gate", ["naive", "gshard", "switch"])
def test_index_route_equals_one_hot_route(gate, monkeypatch):
    """PADDLE_TPU_MOE_GATHER=0 takes the one-hot einsum route; it computes
    the same outputs, aux loss and gradients as the default index route
    at a capacity that drops tokens."""
    _, tm = _pair(gate, 1.0)
    x = _x(3)
    iy, iaux, ig = _run_port(tm, x, None)
    monkeypatch.setenv("PADDLE_TPU_MOE_GATHER", "0")
    oy, oaux, og = _run_port(tm, x, None)
    np.testing.assert_allclose(oy, iy, atol=1e-6, rtol=0)
    assert oaux == pytest.approx(iaux, abs=1e-7)
    for n in ig:
        np.testing.assert_allclose(og[n], ig[n], atol=1e-6, rtol=0,
                                   err_msg=n)


@pytest.mark.parametrize("gather", ["1", "0"])
def test_drop_rate_telemetry_matches_jax(gather, monkeypatch):
    """record_drop_rate / measured_drop_rate on both routes: the same
    fraction of dropped (token, slot) pairs as the JAX package over two
    forwards, None before any forward, and nothing counted once off."""
    monkeypatch.setenv("PADDLE_TPU_MOE_GATHER", gather)
    jm, tm = _pair("gshard", 1.0)
    TML.record_drop_rate(True)
    JML.record_drop_rate(True)
    try:
        assert TML.measured_drop_rate() is None
        for seed in (4, 5):
            x = _x(seed)
            jm(paddle.to_tensor(x))
            with torch.no_grad():
                tm(torch.from_numpy(x))
        jr, tr = JML.measured_drop_rate(), TML.measured_drop_rate()
    finally:
        TML.record_drop_rate(False)
        JML.record_drop_rate(False)
    assert 0.0 < tr < 1.0
    assert tr == jr
    with torch.no_grad():
        tm(torch.from_numpy(_x(6)))
    assert TML.measured_drop_rate() is None


def test_switch_router_learns_from_the_task_loss_alone():
    """Top-1 keeps the raw router probability as the combine weight, so a
    loss without the aux term still reaches gate_weight, with JAX's
    gradient."""
    jm, tm = _pair("switch", 4.0)
    x = _x(7)
    jm.clear_gradients()
    jy = jm(paddle.to_tensor(x))
    paddle.mean(jy * jy).backward()
    ty = tm(torch.from_numpy(x))
    (ty * ty).mean().backward()
    g = tm.gate_weight.grad
    assert float(g.abs().sum()) > 0.0
    jg = jm.gate_weight.grad.numpy()
    np.testing.assert_allclose(g.numpy(), jg,
                               atol=1e-4 * float(np.abs(jg).max()), rtol=0)


def test_gate_objects_and_refusals():
    """A BaseGate sets the gate type and top-k; an unknown gate, a
    top-2 switch and an expert-parallel group that is not a Group are
    refused."""
    for g in (TM.NaiveGate(), TM.GShardGate(), TM.SwitchGate(),
              TM.GShardGate(top_k=3)):
        layer = TM.MoELayer(8, 16, 2, gate=g, device="cpu")
        assert (layer.gate_type, layer.top_k) == (g.gate_type, g.top_k)
    with pytest.raises(ValueError, match="unknown gate"):
        TM.MoELayer(8, 16, 2, gate="hash", device="cpu")
    with pytest.raises(ValueError, match="top-1"):
        TM.MoELayer(8, 16, 2, gate="switch", top_k=2, device="cpu")
    with pytest.raises(TypeError, match="moe_group"):
        TM.MoELayer(8, 16, 2, moe_group=object(), device="cpu")


def test_default_activation_is_the_tanh_gelu():
    """jax.nn.gelu's default is the tanh approximation; the port's layer
    uses the same (the erf GELU differs by ~9e-5 here, 9 times the
    tolerance)."""
    jm, tm = _pair("gshard", 4.0)
    x = _x(8) * 3
    jy = jm(paddle.to_tensor(x)).numpy()
    with torch.no_grad():
        ty = tm(torch.from_numpy(x)).numpy()
        tm._activation = torch.nn.functional.gelu
        erf = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ty, jy, atol=1e-5, rtol=0)
    assert np.abs(erf - jy).max() > 5e-5
