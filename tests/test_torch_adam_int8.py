"""PyTorch port vs JAX package: blockwise int8 Adam moments (codes and
scales, AdamW trajectories with moment_dtype="int8" and q8_param_fun, and
the TrainStep state carried across by the converter).

The encoders are compared bit for bit (the same f32 operations, rounding
half to even on both sides). Trajectories: small f32 GPTs built in the
JAX package and carried into the port, 5 AdamW steps at lr 1e-3 on the
same numpy batches; losses 1e-5 relative, parameters 1e-5 absolute (1% of
one step), as the f32-moment trajectories in test_torch_train_step, except
where f32 summation order put a moment on the other side of a rounding
boundary of its 8-bit (or bf16) code: a code one step apart moves that
element's update by up to one step (lr), so up to 0.1% of a parameter's
elements may differ by up to 1e-3. The encoders run in the port with a
correctly rounded square root (see optimizer._sqrt).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.optimizer import optimizer as JO
import paddle_tpu_torch as pt
from paddle_tpu_torch.optimizer import optimizer as TO
from test_torch_train import CFG_T, _decay, _ids, _pair, _port_layout


def _assert_params_match(jm, tm):
    tparams = dict(tm.named_parameters())
    for n, p in jm.named_parameters():
        d = np.abs(tparams[n].detach().numpy() - _port_layout(n, p.numpy()))
        assert d.max() <= 1e-3, (n, d.max())
        assert (d > 1e-5).mean() <= 1e-3, (n, (d > 1e-5).sum())


@pytest.mark.parametrize("shape", [(5000,), (3, 2048), (64, 48), (7,),
                                   (2048,)])
def test_codes_and_scales_equal_jax(shape):
    rng = np.random.RandomState(0)
    m = (rng.randn(*shape) * 1e-3).astype(np.float32)
    m.reshape(-1)[::97] = 0.0
    v = (rng.rand(*shape) * 1e-6).astype(np.float32)
    jq, js = JO._q8_encode(m)
    tq, ts = TO._q8_encode(torch.from_numpy(m))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        TO._q8_decode(tq, ts, shape).numpy(),
        np.asarray(JO._q8_decode(jq, js, shape)))
    jq, js = JO._q8v_encode(v)
    tq, ts = TO._q8v_encode(torch.from_numpy(v))
    assert tq.dtype == torch.uint8 and np.asarray(jq).dtype == np.uint8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        TO._q8v_decode(tq, ts, shape).numpy(),
        np.asarray(JO._q8v_decode(jq, js, shape)))


def test_rounding_is_half_to_even_like_jnp_round():
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5, 126.5])
    assert torch.round(x).tolist() == [0.0, 2.0, 2.0, -0.0, -2.0, 126.0]


def _steps(moments, q8_fun):
    jm, tm = _pair(CFG_T)
    for n, p in jm.named_parameters():
        p.name = n
    jopt = paddle.optimizer.AdamW(
        learning_rate=1e-3, parameters=jm.parameters(), weight_decay=0.01,
        apply_decay_param_fun=_decay, moment_dtype=moments,
        q8_param_fun=q8_fun, grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
    js = paddle.jit.TrainStep(jm, jopt,
                              lambda a, b: jm.loss(a, b, chunk_size=8))
    topt = pt.AdamW(1e-3, parameters=tm.named_parameters(),
                    weight_decay=0.01, apply_decay_param_fun=_decay,
                    moment_dtype=moments, q8_param_fun=q8_fun,
                    grad_clip=pt.ClipGradByGlobalNorm(1.0), device="cpu")
    ts = pt.TrainStep(tm, topt, lambda a, b: tm.loss(a, b, chunk_size=8),
                      device="cpu")
    return jm, tm, js, ts


def _embeddings(name):
    return "wte" in name or "wpe" in name


@pytest.mark.parametrize("moments, q8_fun", [("int8", None),
                                             ("bfloat16", _embeddings)])
def test_int8_trajectory_matches_jax(moments, q8_fun):
    jm, tm, js, ts = _steps(moments, q8_fun)
    for i in range(5):
        a, b = _ids(4, 16, 128, 70 + i), _ids(4, 16, 128, 80 + i)
        jl = float(js(paddle.to_tensor(a), paddle.to_tensor(b)))
        tl = float(ts(torch.from_numpy(a), torch.from_numpy(b)))
        assert tl == pytest.approx(jl, rel=1e-5), f"step {i + 1}"
    _assert_params_match(jm, tm)
    kinds = {n: "q8" if "moment1_q" in st else str(st["moment1"].dtype)
             for n, st in zip(ts._param_names, ts._opt_state)}
    for n, kind in kinds.items():
        q8 = q8_fun is None or q8_fun(n)
        assert kind == ("q8" if q8 else "torch.bfloat16"), (n, kind)
    # the codes of every parameter, in the JAX element order: equal but
    # for codes one step apart where f32 summation order put a value on
    # the other side of a rounding boundary
    jstate = js.state_dict()["opt"]
    for n, st in zip(ts._param_names, ts._opt_state):
        if "moment1_q" not in st:
            continue
        for k in ("moment1_q", "moment2_q"):
            got = st[k].numpy().astype(np.int32)
            want = np.asarray(jstate[n][k]).astype(np.int32)
            assert got.shape == want.shape, (n, k)
            assert np.abs(got - want).max() <= 1, (n, k)
            assert (got != want).mean() < 0.01, (n, k)


def test_converter_round_trip_is_exact_and_resumes_the_jax_run():
    """A JAX int8 TrainStep state after 3 steps, carried by
    train_state_from_paddle into a fresh port step, comes back out of the
    port's state_dict code for code and scale for scale; the resumed port
    run then follows the JAX run."""
    jm, _, js, _ = _steps("int8", None)
    batches = [(_ids(4, 16, 128, 90 + i), _ids(4, 16, 128, 95 + i))
               for i in range(5)]
    for a, b in batches[:3]:
        js(paddle.to_tensor(a), paddle.to_tensor(b))
    saved = js.state_dict()
    _, tm2 = _pair(CFG_T, seed=5)
    opt = pt.AdamW(1e-3, parameters=tm2.named_parameters(),
                   weight_decay=0.01, apply_decay_param_fun=_decay,
                   moment_dtype="int8",
                   grad_clip=pt.ClipGradByGlobalNorm(1.0), device="cpu")
    ts2 = pt.TrainStep(tm2, opt, lambda a, b: tm2.loss(a, b, chunk_size=8),
                       device="cpu")
    ts2.set_state_dict(pt.train_state_from_paddle(saved, tm2))
    back = ts2.state_dict()["opt"]
    assert set(back) == set(saved["opt"])
    for n, st in saved["opt"].items():
        assert set(back[n]) == {"moment1_q", "moment1_s", "moment2_q",
                                "moment2_s"}
        for k, v in st.items():
            want = np.asarray(v)
            assert back[n][k].numpy().dtype == want.dtype, (n, k)
            np.testing.assert_array_equal(back[n][k].numpy(), want,
                                          err_msg=f"{n}.{k}")
    for a, b in batches[3:]:
        js(paddle.to_tensor(a), paddle.to_tensor(b))
        ts2(torch.from_numpy(a), torch.from_numpy(b))
    _assert_params_match(jm, tm2)


def test_converter_checks_the_int8_state_shape():
    jm, tm, js, _ = _steps("int8", None)
    a = _ids(4, 16, 128, 99)
    js(paddle.to_tensor(a), paddle.to_tensor(a))
    saved = js.state_dict()
    name = "gpt.wte.weight"
    saved["opt"][name]["moment1_s"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="moment1_s"):
        pt.train_state_from_paddle(saved, tm)
