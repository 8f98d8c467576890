"""PyTorch port vs JAX package: the vision trunk's functional layers and
their layers, on the same numpy inputs on the CPU in f32.

`conv2d` (strides, Paddle's padding forms, dilation, groups, NCHW and
NHWC, FLAGS_conv_channels_last), `batch_norm` (training with Paddle's
running-statistics rule, eval, `use_global_stats`, channels-last data,
2-D input, no affine terms), `max_pool2d` (-inf padding, `ceil_mode`
ignored), `adaptive_avg_pool2d` (divisible and not) and
`fused_conv_bn_act` for every epilogue activation with and without a
residual, in training and in eval (where the JAX function folds the BN
scale into the conv weight and the port runs conv then BN). Values, the
gradients of every input and the updated running statistics must agree
within 1e-5 of each tensor's largest magnitude (f32, summation order
only).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.nn import functional as JF
import paddle_tpu_torch as pt
from paddle_tpu_torch.nn import functional as TF

TOL = 1e-5


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = TOL * max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{what}: {err} > {tol}"


def _rand(rng, *shape, scale=1.0, shift=0.0):
    return (rng.randn(*shape) * scale + shift).astype(np.float32)


def _jax_run(fn, arrays, cot_seed=7):
    """(out, [d(sum(out * C))/d(array)]) through the JAX eager autograd;
    None entries are passed as they are."""
    ts = [None if a is None else Tensor(jnp.asarray(a), stop_gradient=False)
          for a in arrays]
    out = fn(*ts)
    cot = _rand(np.random.RandomState(cot_seed), *out.shape)
    (out * Tensor(jnp.asarray(cot))).sum().backward()
    return (np.asarray(out._data),
            [None if t is None else np.asarray(t.grad._data) for t in ts])


def _port_run(fn, arrays, cot_seed=7):
    ts = [None if a is None else torch.tensor(a, requires_grad=True)
          for a in arrays]
    out = fn(*ts)
    cot = _rand(np.random.RandomState(cot_seed), *out.shape)
    (out * torch.from_numpy(cot)).sum().backward()
    return (out.detach().numpy(),
            [None if t is None else t.grad.numpy() for t in ts])


def _assert_runs(port, jax_side, what):
    _close(port[0], jax_side[0], f"{what}: out")
    for i, (a, b) in enumerate(zip(port[1], jax_side[1])):
        if b is not None:
            _close(a, b, f"{what}: grad {i}")


@pytest.fixture
def channels_last():
    """FLAGS_conv_channels_last on in both packages, off afterwards."""
    paddle.set_flags({"FLAGS_conv_channels_last": True})
    pt.set_flags({"FLAGS_conv_channels_last": True})
    yield
    paddle.set_flags({"FLAGS_conv_channels_last": False})
    pt.set_flags({"FLAGS_conv_channels_last": False})


# --------------------------------------------------------------- conv
# (x shape NCHW, out channels, kernel, stride, padding, dilation, groups,
#  bias, data_format)
CONV = {
    "3x3_pad1_bias": ((2, 4, 9, 9), 6, 3, 1, 1, 1, 1, True, "NCHW"),
    "stem_7x7_s2_p3": ((2, 3, 16, 16), 8, 7, 2, 3, 1, 1, False, "NCHW"),
    "1x1_s2": ((2, 8, 8, 8), 16, 1, 2, 0, 1, 1, False, "NCHW"),
    "dilated_s2": ((2, 4, 11, 11), 6, 3, 2, 0, 2, 1, True, "NCHW"),
    "groups_same_s2": ((2, 4, 9, 10), 6, 3, 2, "SAME", 1, 2, True, "NCHW"),
    "asym_2n": ((2, 4, 7, 8), 5, 3, 1, [1, 2, 0, 1], 1, 1, False, "NCHW"),
    "pairs": ((2, 4, 7, 8), 5, (3, 2), (2, 1), [(0, 1), (2, 0)], 1, 1, True,
              "NCHW"),
    "valid_nhwc": ((2, 4, 9, 9), 6, 3, 1, "VALID", 1, 1, True, "NHWC"),
    "nhwc_groups_s2": ((2, 8, 9, 9), 8, 3, 2, 1, 1, 4, False, "NHWC"),
}


def _conv_inputs(case, seed=0):
    shape, co, k, s, p, d, g, bias, fmt = CONV[case]
    rng = np.random.RandomState(seed)
    kk = k if isinstance(k, tuple) else (k, k)
    x = _rand(rng, *shape)
    if fmt == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    w = _rand(rng, co, shape[1] // g, *kk, scale=0.3)
    b = _rand(rng, co, scale=0.1) if bias else None
    kw = dict(stride=s, padding=p, dilation=d, groups=g, data_format=fmt)
    return x, w, b, kw


@pytest.mark.parametrize("case", sorted(CONV))
def test_conv2d_matches_jax(case):
    x, w, b, kw = _conv_inputs(case)
    _assert_runs(_port_run(lambda *a: TF.conv2d(*a, **kw), [x, w, b]),
                 _jax_run(lambda *a: JF.conv2d(*a, **kw), [x, w, b]), case)


@pytest.mark.parametrize("case", ["3x3_pad1_bias", "groups_same_s2",
                                  "asym_2n", "nhwc_groups_s2"])
def test_conv2d_under_channels_last_matches_jax(case, channels_last):
    x, w, b, kw = _conv_inputs(case, seed=1)
    port = _port_run(lambda *a: TF.conv2d(*a, **kw), [x, w, b])
    _assert_runs(port, _jax_run(lambda *a: JF.conv2d(*a, **kw), [x, w, b]),
                 case)
    if kw["data_format"] == "NCHW":
        xt = torch.from_numpy(x)
        assert TF.conv2d(xt, torch.from_numpy(w), None, **{
            k: v for k, v in kw.items()}).is_contiguous(
            memory_format=torch.channels_last)


def test_conv2d_layer_matches_jax_and_initialises_like_it():
    """The Conv2D layer: same forward and gradients on the same weights;
    its initial weights and bias lie in the JAX bound 1/sqrt(fan_in); no
    bias with bias_attr=False; ParamAttr objects are refused."""
    rng = np.random.RandomState(3)
    jl = paddle.nn.Conv2D(4, 6, 3, stride=2, padding=1)
    tl = pt.nn.Conv2D(4, 6, 3, stride=2, padding=1, device="cpu")
    assert [n for n, _ in tl.named_parameters()] == \
        [n for n, _ in jl.named_parameters()]
    bound = 1 / np.sqrt(4 * 9)
    for p in tl.parameters():
        p = p.detach()
        assert float(p.abs().max()) <= bound and float(p.std()) > bound / 4
    with torch.no_grad():
        for (n, p), (_, q) in zip(tl.named_parameters(),
                                  jl.named_parameters()):
            p.copy_(torch.from_numpy(np.array(q._data)))
    x = _rand(rng, 2, 4, 8, 8)
    jx = Tensor(jnp.asarray(x), stop_gradient=False)
    jy = jl(jx)
    jy.sum().backward()
    tx = torch.tensor(x, requires_grad=True)
    ty = tl(tx)
    ty.sum().backward()
    _close(ty.detach().numpy(), np.asarray(jy._data), "layer out")
    _close(tx.grad.numpy(), np.asarray(jx.grad._data), "layer dx")
    _close(tl.weight.grad.numpy(), np.asarray(jl.weight.grad._data),
           "layer dw")
    assert pt.nn.Conv2D(4, 6, 1, bias_attr=False,
                        device="cpu").bias is None
    with pytest.raises(NotImplementedError):
        pt.nn.Conv2D(4, 6, 1, weight_attr=object(), device="cpu")


# ---------------------------------------------------------- batch norm
def _bn_inputs(shape, seed, affine=True):
    rng = np.random.RandomState(seed)
    c = shape[1]
    x = _rand(rng, *shape, scale=1.5, shift=0.3)
    w = _rand(rng, c, scale=0.2, shift=1.0) if affine else None
    b = _rand(rng, c, scale=0.2) if affine else None
    rm = _rand(rng, c, scale=0.1)
    rv = (0.5 + rng.rand(c)).astype(np.float32)
    return x, w, b, rm, rv


# (input shape, training, use_global_stats, data_format, affine, momentum)
BN = {
    "train": ((4, 6, 5, 5), True, None, "NCHW", True, 0.9),
    "train_momentum": ((4, 6, 5, 5), True, None, "NCHW", True, 0.5),
    "eval": ((4, 6, 5, 5), False, None, "NCHW", True, 0.9),
    "global_stats_in_train": ((4, 6, 5, 5), True, True, "NCHW", True, 0.9),
    "train_nhwc": ((4, 5, 5, 6), True, None, "NHWC", True, 0.9),
    "train_2d": ((16, 6), True, None, "NCHW", True, 0.9),
    "train_no_affine": ((4, 6, 5, 5), True, None, "NCHW", False, 0.9),
}


@pytest.mark.parametrize("case", sorted(BN))
def test_batch_norm_matches_jax_with_the_running_stat_rule(case):
    """Paddle's rule: new = m * old + (1 - m) * batch with the biased batch
    variance (not torch.nn.functional.batch_norm's unbiased one and
    opposite momentum); eval and use_global_stats normalise with the
    buffers and leave them alone."""
    shape, training, ugs, fmt, affine, mom = BN[case]
    c = shape[-1] if fmt == "NHWC" else shape[1]
    x, w, b, rm, rv = _bn_inputs((shape[0], c) + shape[1:-1] if fmt ==
                                 "NHWC" else shape, seed=5, affine=affine)
    if fmt == "NHWC":
        x = np.ascontiguousarray(np.moveaxis(x, 1, -1))
    kw = dict(training=training, momentum=mom, epsilon=1e-5,
              data_format=fmt, use_global_stats=ugs)
    jrm, jrv = Tensor(jnp.asarray(rm)), Tensor(jnp.asarray(rv))
    trm, trv = torch.from_numpy(rm.copy()), torch.from_numpy(rv.copy())
    jax_side = _jax_run(lambda a, g, h: JF.batch_norm(a, jrm, jrv, g, h, **kw),
                        [x, w, b])
    port = _port_run(lambda a, g, h: TF.batch_norm(a, trm, trv, g, h, **kw),
                     [x, w, b])
    _assert_runs(port, jax_side, case)
    _close(trm.numpy(), np.asarray(jrm._data), f"{case}: running mean")
    _close(trv.numpy(), np.asarray(jrv._data), f"{case}: running var")
    moved = training and not ugs
    assert (not np.allclose(trm.numpy(), rm)) == moved
    if moved:       # the rule itself, from numpy
        axes = tuple(i for i in range(x.ndim)
                     if i != (x.ndim - 1 if fmt == "NHWC" else 1))
        _close(trv.numpy(), mom * rv + (1 - mom) * x.var(axis=axes),
               "biased variance")


def test_batch_norm_layers_match_jax():
    """BatchNorm2D / BatchNorm1D / the legacy BatchNorm(act="relu"):
    buffers `_mean` / `_variance` under the JAX names, updated in train()
    mode, read in eval() mode."""
    rng = np.random.RandomState(11)
    for jcls, tcls, shape, kw in (
            ("BatchNorm2D", "BatchNorm2D", (4, 6, 3, 3), {}),
            ("BatchNorm1D", "BatchNorm1D", (8, 6), {}),
            ("BatchNorm", "BatchNorm", (4, 6, 3, 3), dict(act="relu"))):
        jl, tl = getattr(paddle.nn, jcls)(6, **kw), \
            getattr(pt.nn, tcls)(6, device="cpu", **kw)
        assert sorted(tl.state_dict()) == sorted(jl.state_dict())
        for step in range(3):
            x = _rand(rng, *shape, shift=0.5)
            for mode in ("train", "eval"):
                getattr(jl, mode)()
                getattr(tl, mode)()
                jy = jl(paddle.to_tensor(x))
                ty = tl(torch.from_numpy(x))
                _close(ty.detach().numpy(), jy.numpy(), f"{jcls} {mode}")
        for k, v in jl.state_dict().items():
            _close(tl.state_dict()[k].numpy(), np.asarray(v._data),
                   f"{jcls} {k}")


# ------------------------------------------------------------ pooling
# (shape, kernel, stride, padding, ceil_mode, data_format)
POOL = {
    "resnet_3x3_s2_p1": ((2, 4, 9, 9), 3, 2, 1, False, "NCHW"),
    "2x2_s2": ((2, 4, 8, 8), 2, 2, 0, False, "NCHW"),
    "same_s1": ((2, 3, 7, 6), 3, 1, "SAME", False, "NCHW"),
    "asym": ((2, 3, 7, 6), 3, 2, [0, 1, 0, 1], False, "NCHW"),
    "ceil_mode_ignored": ((2, 3, 8, 8), 3, 2, 0, True, "NCHW"),
    "nhwc": ((2, 7, 7, 5), 3, 2, 1, False, "NHWC"),
}


@pytest.mark.parametrize("case", sorted(POOL))
def test_max_pool2d_matches_jax(case):
    shape, k, s, p, ceil, fmt = POOL[case]
    x = _rand(np.random.RandomState(13), *shape)
    kw = dict(kernel_size=k, stride=s, padding=p, ceil_mode=ceil,
              data_format=fmt)
    _assert_runs(_port_run(lambda a: TF.max_pool2d(a, **kw), [x]),
                 _jax_run(lambda a: JF.max_pool2d(a, **kw), [x]), case)


def test_max_pool_gradient_after_relu_ties():
    """A tied window routes the gradient to one element, and the two
    frameworks may pick different ones. In ResNet the pool follows a
    ReLU, so its only ties are at 0 among inputs the ReLU zeroed, whose
    ReLU gradient is 0 whichever element the pool picked: the gradient
    with respect to the pre-ReLU input agrees."""
    x = _rand(np.random.RandomState(17), 2, 4, 9, 9, shift=-0.8)
    kw = dict(kernel_size=3, stride=2, padding=1)
    jax_side = _jax_run(lambda a: JF.max_pool2d(JF.relu(a), **kw), [x])
    port = _port_run(lambda a: TF.max_pool2d(torch.relu(a), **kw), [x])
    assert (jax_side[0] == 0).sum() > 4          # windows tied at 0
    _assert_runs(port, jax_side, "relu + max pool")


@pytest.mark.parametrize("case", [((2, 4, 7, 7), (1, 1), "NCHW"),
                                  ((2, 4, 7, 7), (3, 3), "NCHW"),
                                  ((2, 8, 8, 4), (2, 2), "NHWC"),
                                  ((2, 4, 5, 9), (2, 4), "NCHW")])
def test_adaptive_avg_pool2d_matches_jax(case):
    shape, out, fmt = case
    x = _rand(np.random.RandomState(19), *shape)
    _assert_runs(
        _port_run(lambda a: TF.adaptive_avg_pool2d(a, out, fmt), [x]),
        _jax_run(lambda a: JF.adaptive_avg_pool2d(a, out, fmt), [x]),
        str(case))


def test_pool_layers_and_refusals():
    x = _rand(np.random.RandomState(23), 2, 3, 8, 8)
    _close(pt.nn.MaxPool2D(3, 2, 1)(torch.from_numpy(x)).numpy(),
           paddle.nn.MaxPool2D(3, 2, 1)(paddle.to_tensor(x)).numpy(), "max")
    _close(pt.nn.AdaptiveAvgPool2D(1)(torch.from_numpy(x)).numpy(),
           paddle.nn.AdaptiveAvgPool2D(1)(paddle.to_tensor(x)).numpy(), "avg")
    with pytest.raises(NotImplementedError, match="MaxUnPool2D"):
        pt.nn.MaxPool2D(2, return_mask=True)(torch.from_numpy(x))


# ------------------------------------------------- fused conv + BN + act
ACTS = [None, "identity", "relu", "relu6", "gelu", "silu", "hardswish",
        "leaky_relu"]


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("residual", [False, True], ids=["plain", "res"])
@pytest.mark.parametrize("act", ACTS, ids=[str(a) for a in ACTS])
def test_fused_conv_bn_act_matches_jax(act, residual, training):
    """Training: batch statistics, the running ones updated by Paddle's
    rule. Eval: the JAX function folds w * gamma / sqrt(var + eps) into
    the conv; the port runs conv then BN. The BN scale is large enough
    that relu6 reaches both of its clamps."""
    rng = np.random.RandomState(29)
    x = _rand(rng, 2, 4, 7, 7)
    w = _rand(rng, 8, 4, 3, 3, scale=0.3)
    cb = _rand(rng, 8, scale=0.1)
    g = _rand(rng, 8, scale=0.5, shift=3.0)
    b = _rand(rng, 8, scale=1.0)
    res = _rand(rng, 2, 8, 4, 4) if residual else None
    rm = _rand(rng, 8, scale=0.3)
    rv = (0.5 + rng.rand(8)).astype(np.float32)
    jrm, jrv = Tensor(jnp.asarray(rm)), Tensor(jnp.asarray(rv))
    trm, trv = torch.from_numpy(rm.copy()), torch.from_numpy(rv.copy())
    kw = dict(stride=2, padding=1, training=training, act=act)
    jax_side = _jax_run(lambda a, ww, c, gg, bb, r: JF.fused_conv_bn_act(
        a, ww, c, jrm, jrv, gg, bb, residual=r, **kw), [x, w, cb, g, b, res])
    port = _port_run(lambda a, ww, c, gg, bb, r: TF.fused_conv_bn_act(
        a, ww, c, trm, trv, gg, bb, residual=r, **kw), [x, w, cb, g, b, res])
    _assert_runs(port, jax_side, f"{act} residual={residual}")
    _close(trm.numpy(), np.asarray(jrm._data), "running mean")
    _close(trv.numpy(), np.asarray(jrv._data), "running var")
    assert np.array_equal(trm.numpy(), rm) != training
    if act == "relu6":
        assert (port[0] == 6).any() and (port[0] == 0).any()


def test_fused_conv_bn_act_refusals():
    x = torch.zeros(1, 2, 4, 4)
    w = torch.zeros(2, 2, 1, 1)
    with pytest.raises(ValueError, match="inference mode"):
        TF.fused_conv_bn_act(x, w, training=False)
    with pytest.raises(ValueError, match="act="):
        TF.fused_conv_bn_act(x, w, training=True, act="tanh")


@pytest.mark.parametrize("cls", ["Conv2D", "BatchNorm1D", "BatchNorm2D",
                                 "BatchNorm3D", "BatchNorm"])
def test_layers_default_to_cuda(cls, monkeypatch):
    """Like every entry point of the port, the layers build their
    parameters and buffers on CUDA unless asked for another device, and
    raise without a card rather than carry on on the CPU."""
    args = (4, 6, 3) if cls == "Conv2D" else (6,)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(pt.nn, cls)(*args)
    layer = getattr(pt.nn, cls)(*args, device="cpu")
    assert {t.device.type for t in layer.state_dict().values()} == {"cpu"}
