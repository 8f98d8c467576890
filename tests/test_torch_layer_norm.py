"""PyTorch port vs JAX package: the fused LayerNorm (kernel #8's plain
versions against `fused_layer_norm` in interpret mode), its routing
predicate, the default route and the one-pass variance.

The same numpy inputs go through both. Tolerances (f32, both sides sum in
f32 in another order): forward 1e-5 absolute and relative; gradients of
sum(out^2) 1e-4 absolute and 1e-5 relative (they reach ~350 here); the
backward kernel's plain version against the JAX backward kernel on the
same saved statistics 1e-5.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from paddle_tpu.ops.pallas import layer_norm as JL
import paddle_tpu_torch as pt
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops import layer_norm as LN


def _affine(rng, h, affine):
    g = rng.randn(h).astype(np.float32) if "g" in affine else None
    b = rng.randn(h).astype(np.float32) if "b" in affine else None
    return g, b


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("affine", ["gb", "g", "b", "none"])
def test_forward_matches_the_jax_kernel(affine):
    rng = np.random.RandomState(0)
    x = rng.randn(3, 16, 256).astype(np.float32)
    g, b = _affine(rng, 256, affine)
    want = JL.fused_layer_norm(_j(x), _j(g), _j(b), interpret=True)
    got = LN.fused_layer_norm(_t(x), _t(g), _t(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # the saved statistics: one-pass f32 mu and rsig per row
    _, mu, rs = JL._ln_fwd(_j(x.reshape(48, 256)), _j(g), _j(b), 1e-5, True)
    _, tmu, trs = LN.fused_layer_norm_reference(_t(x.reshape(48, 256)),
                                                _t(g), _t(b))
    np.testing.assert_allclose(tmu.numpy(), np.asarray(mu)[0], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(trs.numpy(), np.asarray(rs)[0], rtol=1e-5)


@pytest.mark.parametrize("affine", ["gb", "none"])
def test_gradients_match_the_jax_kernel(affine):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 32, 128).astype(np.float32)
    g, b = _affine(rng, 128, affine)
    args = [a for a in (x, g, b) if a is not None]

    def jloss(*a):
        it = iter(a)
        xx = next(it)
        gg = next(it) if g is not None else None
        bb = next(it) if b is not None else None
        return jnp.sum(JL.fused_layer_norm(xx, gg, bb, interpret=True) ** 2)
    want = jax.grad(jloss, argnums=tuple(range(len(args))))(
        *[jnp.asarray(a) for a in args])
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    it = iter(ts)
    tx = next(it)
    tg = next(it) if g is not None else None
    tb = next(it) if b is not None else None
    (LN.fused_layer_norm(tx, tg, tb) ** 2).sum().backward()
    for w, t, name in zip(want, ts, ("dx", "dgamma", "dbeta")):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("affine", ["gb", "none"])
def test_backward_plain_version_matches_the_jax_backward_kernel(affine):
    """fused_layer_norm_bwd_reference (what the CUDA backward is held
    against on the card) on the JAX kernel's own saved statistics."""
    rng = np.random.RandomState(2)
    x = rng.randn(64, 256).astype(np.float32)
    dy = rng.randn(64, 256).astype(np.float32)
    g, b = _affine(rng, 256, affine)
    _, mu, rs = JL._ln_fwd(_j(x), _j(g), _j(b), 1e-5, True)
    dx, dg, db = JL._ln_bwd(_j(dy), _j(x), mu, rs, _j(g), True)
    tdx, tdg, tdb = LN.fused_layer_norm_bwd_reference(
        _t(dy), _t(x), _t(np.asarray(mu)[0]), _t(np.asarray(rs)[0]), _t(g))
    for got, want in ((tdx, dx), (tdg, dg), (tdb, db)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(8, 128), (3, 16, 256), (2, 4, 384),
                                   (4, 96), (7, 128), (4, 128), (1, 128),
                                   (16, 1, 256), (6, 2560), (2, 3, 200)])
@pytest.mark.parametrize("env", [None, "1", "0"])
def test_predicate_is_the_jax_predicate_minus_its_platform_test(
        shape, env, monkeypatch):
    from types import SimpleNamespace
    if env is None:
        monkeypatch.delenv("PADDLE_TPU_FUSED_LN", raising=False)
    else:
        monkeypatch.setenv("PADDLE_TPU_FUSED_LN", env)
    monkeypatch.setattr(JL.jax, "devices",
                        lambda: [SimpleNamespace(platform="tpu")])
    assert LN.fused_layer_norm_supported(shape) == \
        JL.fused_layer_norm_supported(shape)


@pytest.mark.parametrize("env", [None, "1"])
@pytest.mark.parametrize("shape", [(4, 16, 128), (4, 96), (3, 128)])
def test_default_route_is_torch_layer_norm_bitwise(shape, env,
                                                   monkeypatch):
    """Without the opt-in (and with it, on a shape the kernel does not
    take) the port's LayerNorm is torch.nn.LayerNorm, bit for bit, with the
    same parameters and state dict."""
    if env is None:
        monkeypatch.delenv("PADDLE_TPU_FUSED_LN", raising=False)
    else:
        monkeypatch.setenv("PADDLE_TPU_FUSED_LN", env)
    h = shape[-1]
    torch.manual_seed(0)
    ref = torch.nn.LayerNorm(h)
    with torch.no_grad():
        ref.weight.normal_()
        ref.bias.normal_()
    mod = pt.nn.LayerNorm(h, device="cpu")
    mod.load_state_dict(ref.state_dict())
    assert isinstance(mod, torch.nn.LayerNorm)
    assert list(mod.state_dict()) == list(ref.state_dict())
    x = torch.randn(shape)
    if env == "1" and LN.fused_layer_norm_supported(shape):
        # routed: the one-pass statistics, equal to f32 rounding here
        torch.testing.assert_close(mod(x), ref(x), rtol=1e-5, atol=1e-5)
        return
    assert torch.equal(mod(x), ref(x))
    assert torch.equal(TF.layer_norm(x, h, ref.weight, ref.bias),
                       torch.nn.functional.layer_norm(x, (h,), ref.weight,
                                                      ref.bias))


def test_opt_in_routes_the_module_through_the_fused_layer_norm(
        monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FUSED_LN", "1")
    calls = []
    orig = LN.fused_layer_norm_reference

    def spy(*a, **k):
        calls.append(tuple(a[0].shape))
        return orig(*a, **k)
    monkeypatch.setattr(LN, "fused_layer_norm_reference", spy)
    mod = pt.nn.LayerNorm(128, device="cpu")
    x = torch.randn(2, 4, 128, requires_grad=True)
    mod(x).square().sum().backward()
    assert calls == [(8, 128)]
    assert x.grad is not None and mod.weight.grad is not None
    # over two axes the router keeps torch's LayerNorm
    two = pt.nn.LayerNorm((4, 128), device="cpu")
    calls.clear()
    two(x)
    assert calls == []


def test_one_pass_variance_diverges_from_torch_like_the_kernel():
    """x = 1000 + N(0, 1): E[x^2] - E[x]^2 in f32 cancels, so the fused
    LayerNorm (the port and the JAX kernel alike) is off by a large
    fraction of a unit, where the two-pass F.layer_norm is exact to f32
    rounding. The port follows the kernel; the default route is
    F.layer_norm."""
    rng = np.random.RandomState(3)
    x = (1000.0 + rng.randn(16, 256)).astype(np.float32)
    x64 = x.astype(np.float64)
    exact = (x64 - x64.mean(-1, keepdims=True)) / np.sqrt(
        x64.var(-1, keepdims=True) + 1e-5)
    port = LN.fused_layer_norm(_t(x)).numpy()
    jaxk = np.asarray(JL.fused_layer_norm(_j(x), interpret=True))
    torch_ln = torch.nn.functional.layer_norm(_t(x), (256,)).numpy()
    assert np.abs(torch_ln - exact).max() < 1e-3
    assert np.abs(port - exact).max() > 0.05
    assert np.abs(jaxk - exact).max() > 0.05
