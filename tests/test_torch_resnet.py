"""PyTorch port vs JAX package: the ResNet family (conv-BN-ReLU triples
through `fused_conv_bn_act`, the projection shortcut, the max pool, the
average pool and the head), its training gradients, its running
statistics, channels-last, and Momentum training through both TrainSteps.

Small models are built in the JAX package (structure only, then filled
from numpy, cheaper on the CPU than its own initialisers, with the
buffers moved off 0 / 1 so that eval reads them); their state dicts,
buffers included, go through `model_state_from_paddle` into the port.
64^2 images, B = 2, 10 classes. Limits: logits 1e-4 of their largest
magnitude, the loss 1e-5 relative, every gradient 1e-3 of its largest
magnitude, running statistics 1e-5, TrainStep parameters 1e-4 of each
tensor's largest magnitude.

Which dtype: resnet18 is compared in f32. At resnet50's depth, with
batch statistics over 8 values a channel in layer4, f32 itself strays
further than those limits from the exact answer: an f64 evaluation of
the same weights puts both frameworks' f32 logits 7.5e-5 of their
largest magnitude away (1.1e-4 from each other), the JAX package's f32
gradients up to 21% and the port's up to 0.2% away; and three Momentum
steps at lr 0.1 grow the f32 differences past 20% of a parameter. So
resnet50, the trajectories and the channels-last equality run in f64 on
both sides (JAX under `jax.enable_x64`), where rounding is out of the way
and the limits test the arithmetic; both optimizers still update in f32,
as they always do.

Pinned divergence (ROADMAP C1): the JAX TrainStep's traced forward never
updates the running statistics (a ResNet trained through it evaluates
with its initial statistics); the port's eager step updates them at every
training forward, once per microbatch, as Paddle and the JAX package's
own eager forward do.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.nn import initializer as JI
from paddle_tpu.vision.models import resnet as JR
import paddle_tpu_torch as pt
from paddle_tpu_torch.convert import _is_linear_weight

HW, B, CLASSES = 64, 2, 10
TORCH = {"float32": torch.float32, "float64": torch.float64}


def _x64(dtype):
    """The JAX side's context: x64 mode for f64 runs."""
    return jax.enable_x64(dtype == "float64")


def _jax_model(ctor, seed=0, dtype="float32"):
    with JI.fast_init():
        jm = getattr(JR, ctor)(num_classes=CLASSES)
    rng = np.random.RandomState(seed)
    for n, p in jm.named_parameters():
        shape = tuple(p.shape)
        if n == "fc.weight":
            b = np.sqrt(6.0 / sum(shape))
            a = rng.uniform(-b, b, shape)
        elif len(shape) == 4:
            b = 1.0 / np.sqrt(np.prod(shape[1:]))
            a = rng.uniform(-b, b, shape)
        elif n.endswith(".weight"):
            a = 1.0 + 0.1 * rng.randn(*shape)
        else:
            a = 0.1 * rng.randn(*shape)
        p._data = jnp.asarray(a.astype(np.float32)).astype(dtype)
    for n, b in jm.named_buffers():
        c = b.shape[0]
        a = 0.1 * rng.randn(c) if n.endswith("_mean") else 0.5 + rng.rand(c)
        b._data = jnp.asarray(a.astype(np.float32)).astype(dtype)
    return jm


def _port_from(jm, ctor, dtype="float32"):
    tm = getattr(pt, ctor)(num_classes=CLASSES, device="cpu", seed=7,
                           dtype=TORCH[dtype])
    np_state = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    tm.load_state_dict(pt.model_state_from_paddle(np_state, tm))
    return tm


def _data(seed=1, b=B, dtype="float32"):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, 3, HW, HW).astype(dtype),
            rng.randint(0, CLASSES, (b,)).astype(np.int64))


def _jt(a):
    """A numpy array as a JAX-package tensor of its own dtype."""
    return Tensor(jnp.asarray(a))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _buffers(m):
    return {n: np.asarray(b.numpy() if hasattr(b, "numpy") else b)
            for n, b in m.named_buffers()}


def _assert_buffers(tm, want, what):
    got = {n: b.numpy() for n, b in tm.named_buffers()}
    assert set(got) == set(want), what
    for n in want:
        err = float(np.abs(got[n] - want[n]).max())
        assert err <= 1e-5, f"{what}: {n} {err}"


@pytest.mark.parametrize("ctor,dtype", [("resnet18", "float32"),
                                        ("resnet50", "float64")])
def test_train_forward_grads_stats_and_eval_match_jax(ctor, dtype):
    with _x64(dtype):
        jm = _jax_model(ctor, dtype=dtype)
        tm = _port_from(jm, ctor, dtype)
        img, lab = _data(dtype=dtype)
        jm.train()
        tm.train()
        jlogits = jm(_jt(img))
        jloss = paddle.nn.CrossEntropyLoss()(jlogits, _jt(lab))
        jloss.backward()
        tlogits = tm(torch.from_numpy(img))
        tloss = F.cross_entropy(tlogits, torch.from_numpy(lab))
        tloss.backward()
        assert _rel(tlogits.detach().numpy(), jlogits.numpy()) <= 1e-4
        assert float(tloss.detach()) == pytest.approx(float(jloss),
                                                      rel=1e-5)
        tgrads = dict(tm.named_parameters())
        for n, p in jm.named_parameters():
            g = p.grad.numpy()
            if _is_linear_weight(n, g.ndim):
                g = g.T
            assert _rel(tgrads[n].grad.numpy(), g) <= 1e-3, n
        # the running statistics after one training forward (Paddle's rule)
        _assert_buffers(tm, _buffers(jm), f"{ctor} stats")
        jm.eval()
        tm.eval()
        with torch.no_grad():
            te = tm(torch.from_numpy(img)).numpy()
        with paddle.no_grad():
            je = jm(_jt(img)).numpy()
        assert _rel(te, je) <= 1e-4


def _momentum_pair(jm, tm):
    jopt = paddle.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                     parameters=jm.parameters())
    ce = paddle.nn.CrossEntropyLoss()
    js = paddle.jit.TrainStep(jm, jopt, lambda x, y: ce(jm(x), y))
    ts = _port_step(tm)
    return js, ts


def _port_step(tm, accum=1):
    topt = pt.Momentum(learning_rate=0.1, momentum=0.9,
                       parameters=tm.named_parameters(), device="cpu")
    return pt.TrainStep(tm, topt, lambda x, y: F.cross_entropy(tm(x), y),
                        grad_accum_steps=accum, device="cpu")


@pytest.fixture(scope="module")
def momentum_run():
    """resnet18 in f64: 3 JAX TrainStep steps of Momentum(lr 0.1, momentum
    0.9) against 3 port TrainStep steps, the JAX state saved after step 2,
    and the JAX eager training forward of batch 0 from the same initial
    weights (the statistics the port's first step must leave)."""
    with _x64("float64"):
        jm = _jax_model("resnet18", seed=3, dtype="float64")
        tm = _port_from(jm, "resnet18", "float64")
        init_buffers = _buffers(jm)
        jeager = _jax_model("resnet18", seed=3, dtype="float64")
        jeager.train()
        batches = [_data(seed=20 + i, dtype="float64") for i in range(3)]
        with paddle.no_grad():
            jeager(_jt(batches[0][0]))
        jm.train()
        tm.train()
        js, ts = _momentum_pair(jm, tm)
        out = {"jl": [], "tl": [], "init_buffers": init_buffers,
               "eager_buffers": _buffers(jeager), "batches": batches}
        for i, (img, lab) in enumerate(batches):
            if i == 2:
                out["saved"] = js.state_dict()
            out["jl"].append(float(js(_jt(img), _jt(lab))))
            out["tl"].append(float(ts(torch.from_numpy(img),
                                      torch.from_numpy(lab))))
            if i == 0:
                out["port_buffers_1"] = {n: b.numpy().copy()
                                         for n, b in tm.named_buffers()}
    out.update(jm=jm, tm=tm, js=js, ts=ts)
    return out


def _assert_params(tm, jm, what):
    tparams = dict(tm.named_parameters())
    for n, p in jm.named_parameters():
        want = p.numpy()
        if _is_linear_weight(n, want.ndim):
            want = want.T
        assert _rel(tparams[n].detach().numpy(), want) <= 1e-4, (what, n)


def test_momentum_trajectory_matches_the_jax_train_step(momentum_run):
    r = momentum_run
    for a, b in zip(r["tl"], r["jl"]):
        assert a == pytest.approx(b, rel=1e-5)
    assert r["tl"][0] != r["tl"][2]
    _assert_params(r["tm"], r["jm"], "after 3 steps")
    # the velocity is f32, shaped like its parameter, transposed for fc
    tvel = {n: st["velocity"] for n, st in zip(r["ts"]._param_names,
                                               r["ts"]._opt_state)}
    jvel = {n: st["velocity"] for n, st in zip(r["js"]._param_names,
                                               r["js"]._opt_state)}
    for n, v in jvel.items():
        v = np.asarray(v)
        if _is_linear_weight(n, v.ndim):
            v = v.T
        assert tvel[n].dtype == torch.float32
        assert _rel(tvel[n].numpy(), v) <= 1e-4, n


def test_train_step_updates_running_stats_where_jax_keeps_them(
        momentum_run):
    """The pinned divergence: after the JAX TrainStep's steps its buffers
    still hold their initial values, while the port's first step left the
    statistics the JAX eager training forward leaves."""
    r = momentum_run
    jnow = _buffers(r["jm"])
    for n, want in r["init_buffers"].items():
        np.testing.assert_array_equal(jnow[n], want, err_msg=n)
    got = r["port_buffers_1"]
    for n, want in r["eager_buffers"].items():
        assert float(np.abs(got[n] - want).max()) <= 1e-5, n
        assert not np.allclose(got[n], r["init_buffers"][n]), n


def test_port_resumes_a_jax_momentum_run(momentum_run):
    """`train_state_from_paddle` of the JAX state after step 2 (trainable
    parameters and velocities; the buffers stay the model's) into a fresh
    port model: its step 3 lands on the JAX step 3."""
    r = momentum_run
    tm2 = pt.resnet18(num_classes=CLASSES, device="cpu", seed=11,
                      dtype=torch.float64)
    tm2.train()
    ts2 = _port_step(tm2)
    state = pt.train_state_from_paddle(r["saved"], tm2)
    assert set(state["params"]) == {n for n, _ in tm2.named_parameters()}
    assert all(set(st) == {"velocity"} for st in state["opt"].values())
    ts2.set_state_dict(state)
    assert ts2._step_i == 2
    img, lab = r["batches"][2]
    loss = float(ts2(torch.from_numpy(img), torch.from_numpy(lab)))
    assert loss == pytest.approx(r["jl"][2], rel=1e-5)
    _assert_params(tm2, r["jm"], "resumed")


def test_grad_accum_updates_the_stats_once_per_microbatch():
    """TrainStep(grad_accum_steps=2) on a batch of 4 leaves the statistics
    of two training forwards over its halves, in order."""
    img, lab = _data(seed=5, b=4)
    a = pt.resnet18(num_classes=CLASSES, device="cpu", seed=2)
    b = pt.resnet18(num_classes=CLASSES, device="cpu", seed=2)
    _port_step(a, accum=2)(torch.from_numpy(img), torch.from_numpy(lab))
    with torch.no_grad():
        for half in torch.from_numpy(img).chunk(2):
            b(half)
    for (n, x), (_, y) in zip(a.named_buffers(), b.named_buffers()):
        torch.testing.assert_close(x, y, rtol=0, atol=1e-6, msg=n)


@pytest.mark.parametrize("ctor", ["resnet18", "resnet50"])
def test_channels_last_equals_nchw(ctor):
    """FLAGS_conv_channels_last: the trunk runs in channels-last memory
    (the stem's output and every block's are channels-last) and the
    logits, the loss, every gradient and the statistics equal the NCHW
    run's (f64: in f32 a pre-activation within rounding of 0 can take the
    other side of a ReLU in one layout, a 2-3% change of an early
    gradient at B = 2)."""
    img, lab = _data(seed=8, dtype="float64")
    runs = {}
    for flag in (False, True):
        pt.set_flags({"FLAGS_conv_channels_last": flag})
        try:
            tm = getattr(pt, ctor)(num_classes=CLASSES, device="cpu", seed=4,
                                   dtype=torch.float64)
            tm.train()
            seen = []
            hooks = [m.register_forward_hook(
                lambda mod, i, o: seen.append(o.is_contiguous(
                    memory_format=torch.channels_last)))
                for m in (tm.maxpool, tm.layer1, tm.layer4)]
            logits = tm(torch.from_numpy(img))
            loss = F.cross_entropy(logits, torch.from_numpy(lab))
            loss.backward()
            for h in hooks:
                h.remove()
        finally:
            pt.set_flags({"FLAGS_conv_channels_last": False})
        assert all(seen) == flag and any(seen) == flag
        runs[flag] = (logits.detach().numpy(), float(loss.detach()),
                      {n: p.grad.numpy() for n, p in tm.named_parameters()},
                      {n: b.numpy() for n, b in tm.named_buffers()})
    (l0, s0, g0, b0), (l1, s1, g1, b1) = runs[False], runs[True]
    assert _rel(l1, l0) <= 1e-4
    assert s1 == pytest.approx(s0, rel=1e-5)
    for n in g0:
        assert _rel(g1[n], g0[n]) <= 1e-3, n
    for n in b0:
        assert float(np.abs(b1[n] - b0[n]).max()) <= 1e-5, n


@pytest.mark.parametrize("ctor", ["resnext50_32x4d", "wide_resnet50_2"])
def test_variant_state_dicts_match_jax(ctor):
    """The ResNeXt and wide variants: the same state-dict names (buffers
    included) and shapes (fc.weight transposed), so the converter carries
    them."""
    with JI.fast_init():
        jm = getattr(JR, ctor)(num_classes=7)
    tm = getattr(pt, ctor)(num_classes=7, device="cpu")
    jstate = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    tstate = tm.state_dict()
    assert set(jstate) == set(tstate)
    for k, v in jstate.items():
        want = v.T if _is_linear_weight(k, v.ndim) else v
        assert tuple(tstate[k].shape) == want.shape, k
    tm.load_state_dict(pt.model_state_from_paddle(jstate, tm))
    assert sum(p.numel() for p in tm.parameters()) == \
        sum(int(np.prod(p.shape)) for p in jm.parameters())


def test_constructors_refuse_pretrained_and_default_to_cuda(monkeypatch):
    names = ["resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
             "resnext50_32x4d", "resnext50_64x4d", "resnext101_32x4d",
             "resnext101_64x4d", "resnext152_32x4d", "resnext152_64x4d",
             "wide_resnet50_2", "wide_resnet101_2"]
    for n in names:
        assert getattr(pt, n) is getattr(pt.vision.models, n)
        assert hasattr(JR, n)
        with pytest.raises(NotImplementedError, match="pretrained"):
            getattr(pt, n)(pretrained=True, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.resnet18()
    m = pt.resnet18(num_classes=0, with_pool=False, device="cpu")
    assert not hasattr(m, "fc") and not hasattr(m, "avgpool")
    assert m(torch.zeros(2, 3, 32, 32)).shape == (2, 512, 1, 1)
    assert m.training
