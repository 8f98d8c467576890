"""PyTorch port vs JAX package: flash attention (kernel #6's plain twin)
and the attention routing of the training path.

Inputs come from numpy seeds and go through the JAX Pallas kernel in
interpret mode (`flash_attention(..., interpret=True)`) and through the
port's `flash_attention`, which on CPU tensors runs its plain version.
Both sides are f32. Tolerances: 2e-4 on outputs and 2e-3 on gradients,
the JAX package's own for its kernel against its reference (summation
order differs between the blockwise and the one-shot softmax).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops.attention import attention_reference as jax_reference
from paddle_tpu.ops.pallas.flash_attention import \
    flash_attention as jax_flash
from paddle_tpu.ops.pallas.flash_attention import \
    _flash_vjp_bwd as jax_flash_bwd, _flash_vjp_fwd as jax_flash_fwd
from paddle_tpu_torch.ops import attention as A
from paddle_tpu_torch.ops import flash_attention as FA
from paddle_tpu_torch.ops.cuda import flash_attention as KF

OUT_TOL, GRAD_TOL = 2e-4, 2e-3


def _rand(b, s, h, d, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, s, h, d).astype(np.float32) * 0.3)


def _grads_jax(fn, q, k, v, coef):
    def f(q, k, v):
        return jnp.sum(fn(q, k, v) * coef)
    out = fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    g = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v))
    return np.asarray(out), [np.asarray(x) for x in g]


def _grads_port(fn, q, k, v, coef):
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = fn(tq, tk, tv)
    (out * torch.from_numpy(coef)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in (tq, tk, tv)]


def _compare(jfn, tfn, q, k, v, rows=None):
    coef = np.random.RandomState(9).randn(q.shape[0], q.shape[1], q.shape[2],
                                          v.shape[3]).astype(np.float32)
    jo, jg = _grads_jax(jfn, q, k, v, coef)
    to, tg = _grads_port(tfn, q, k, v, coef)
    np.testing.assert_allclose(to, jo, atol=OUT_TOL, rtol=OUT_TOL)
    for name, a, b in zip("qkv", tg, jg):
        np.testing.assert_allclose(a, b, atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=f"d{name}")
    return tg


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [64, 80])      # 80 pads in both wrappers
def test_flash_matches_jax_kernel(causal, d):
    # two 128-row blocks for the plain head dim, one for the padded one
    s_len = 256 if d == 64 else 128
    q, k, v = (_rand(1, s_len, 1, d, s) for s in (0, 1, 2))
    _compare(lambda a, b, c: jax_flash(a, b, c, causal=causal, block_q=128,
                                       block_k=128, interpret=True),
             lambda a, b, c: FA.flash_attention(a, b, c, causal=causal),
             q, k, v)


def test_flash_kv_len_matches_jax_kernel_and_zeroes_padded_keys():
    q, k, v = (_rand(1, 256, 1, 64, s) for s in (3, 4, 5))
    tg = _compare(lambda a, b, c: jax_flash(a, b, c, block_q=128,
                                            block_k=128, interpret=True,
                                            kv_len=197),
                  lambda a, b, c: FA.flash_attention(a, b, c, kv_len=197),
                  q, k, v)
    assert np.abs(tg[1][:, 197:]).max() == 0.0
    assert np.abs(tg[2][:, 197:]).max() == 0.0


def test_flash_cross_lengths_match_jax_kernel():
    q = _rand(1, 128, 1, 64, 6)
    k, v = _rand(1, 256, 1, 64, 7), _rand(1, 256, 1, 64, 8)
    _compare(lambda a, b, c: jax_flash(a, b, c, block_q=128, block_k=128,
                                       interpret=True),
             lambda a, b, c: FA.flash_attention(a, b, c), q, k, v)


def _np32(x):
    return np.asarray(x).astype(np.float32)


# the plain FA-2 backward against the JAX backward kernels on the same
# inputs (q, k, v, the JAX forward's out and lse, dout): f32 to the
# module's tolerances; bf16 to 2e-2 relative plus 2e-2 of the largest
# |value|, for the f32 sums of two orders landing on either side of a
# bf16 rounding boundary (the formulas are the same)
@pytest.mark.parametrize("dtype, causal, kv_len, s_q", [
    ("float32", True, None, 256), ("bfloat16", True, None, 256),
    ("bfloat16", False, 197, 256), ("float32", False, None, 128)])
def test_flash_bwd_reference_matches_jax_backward_kernels(dtype, causal,
                                                          kv_len, s_q):
    q = _rand(1, s_q, 1, 64, 20)
    k, v = _rand(1, 256, 1, 64, 21), _rand(1, 256, 1, 64, 22)
    g = np.random.RandomState(23).randn(*q.shape).astype(np.float32)
    jdt = jnp.dtype(dtype)
    jq, jk, jv, jg = (jnp.asarray(a).astype(jdt) for a in (q, k, v, g))
    scale = 64 ** -0.5
    jo, res = jax_flash_fwd(jq, jk, jv, scale, causal, 128, 128, True,
                            kv_len)
    jgrads = jax_flash_bwd(scale, causal, 128, 128, True, kv_len, False,
                           res, jg)
    lse = _np32(res[4])[:, 0, :].reshape(1, 1, s_q)        # [B, H, Sq]
    tdt = getattr(torch, dtype)
    tq, tk, tv, tg, to = (torch.from_numpy(_np32(a)).to(tdt)
                          for a in (jq, jk, jv, jg, jo))
    grads = FA.flash_bwd_reference(tq, tk, tv, to, torch.from_numpy(lse),
                                   tg, causal=causal, kv_len=kv_len)
    tout, tlse = FA.flash_forward_reference(tq, tk, tv, causal=causal,
                                            kv_len=kv_len)
    np.testing.assert_allclose(tlse.numpy(), lse, atol=1e-5, rtol=1e-5)
    for name, a, b in zip("qkv", grads, jgrads):
        a, b = a.float().numpy(), _np32(b)
        if dtype == "float32":
            np.testing.assert_allclose(a, b, atol=GRAD_TOL, rtol=GRAD_TOL,
                                       err_msg=f"d{name}")
        else:
            np.testing.assert_allclose(a, b, rtol=2e-2,
                                       atol=2e-2 * np.abs(b).max(),
                                       err_msg=f"d{name}")
    if kv_len is not None:
        assert float(grads[1][:, kv_len:].abs().max()) == 0.0


@pytest.mark.parametrize("causal", [False, True])
def test_flash_bwd_reference_is_autograd_in_f32(causal):
    """In f32 the FA-2 backward is the gradient of the plain forward: the
    delta identity holds up to summation order."""
    q, k, v = (torch.from_numpy(_rand(2, 256, 2, 64, s)) for s in (30, 31,
                                                                   32))
    dout = torch.from_numpy(np.random.RandomState(33).randn(
        2, 256, 2, 64).astype(np.float32))
    ls = [t.clone().requires_grad_() for t in (q, k, v)]
    auto = torch.autograd.grad(FA.flash_attention_reference(
        *ls, causal=causal), ls, dout)
    out, lse = FA.flash_forward_reference(q, k, v, causal=causal)
    fa2 = FA.flash_bwd_reference(q, k, v, out, lse, dout, causal=causal)
    for name, a, b in zip("qkv", fa2, auto):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5,
                                   rtol=1e-4, err_msg=f"d{name}")


def test_causal_mask_is_top_left_like_the_kernel():
    """s_q != s_k under causal: the kernel (and the port's twin) aligns the
    mask top-left; the reference attention aligns it bottom-right."""
    q = _rand(1, 128, 1, 64, 10)
    k, v = _rand(1, 256, 1, 64, 11), _rand(1, 256, 1, 64, 12)
    _compare(lambda a, b, c: jax_flash(a, b, c, causal=True, block_q=128,
                                       block_k=128, interpret=True),
             lambda a, b, c: FA.flash_attention(a, b, c, causal=True),
             q, k, v)
    with torch.no_grad():
        top_left = FA.flash_attention(*(torch.from_numpy(a)
                                        for a in (q, k, v)), causal=True)
        bottom_right = A.attention_reference(
            *(torch.from_numpy(a) for a in (q, k, v)), is_causal=True)
    assert float((top_left - bottom_right).abs().max()) > 1e-2


def test_kv_len_rules():
    q = torch.from_numpy(_rand(1, 128, 1, 16, 13))
    with pytest.raises(ValueError, match="kv_len must be positive"):
        FA.flash_attention(q, q, q, kv_len=0)
    full = FA.flash_attention(q, q, q)
    assert torch.equal(FA.flash_attention(q, q, q, kv_len=128), full)
    assert torch.equal(FA.flash_attention(q, q, q, kv_len=500), full)


class _Spy:
    def __init__(self, monkeypatch):
        self.calls = []
        real = FA.flash_attention

        def spy(*a, **kw):
            self.calls.append(kw)
            return real(*a, **kw)
        monkeypatch.setattr(FA, "flash_attention", spy)


@pytest.mark.parametrize("s, d, causal, mask, route", [
    (256, 64, True, False, "flash"),
    (128, 80, False, False, "flash"),
    (256, 60, True, False, "reference"),       # head dim not in 8s
    (100, 64, True, False, "reference"),       # S not in 128-row blocks
    (256, 64, True, True, "reference"),        # an explicit mask
    (600, 32, False, False, "padded"),         # S >= 512, S % 128 != 0
    (600, 32, True, False, "reference"),       # padded route is non-causal
    (300, 32, False, False, "reference"),      # S < 512
])
def test_functional_attention_routing(monkeypatch, s, d, causal, mask,
                                      route):
    spy = _Spy(monkeypatch)
    q, k, v = (_rand(1, s, 2, d, i) for i in (14, 15, 16))
    m = None
    if mask:
        m = torch.ones(s, s, dtype=torch.bool).tril()[None, None]
    with torch.no_grad():
        got = A.functional_attention(*(torch.from_numpy(a)
                                       for a in (q, k, v)),
                                     is_causal=causal, mask=m)
    assert got.shape == (1, s, 2, d)
    if route == "reference":
        assert spy.calls == []
    elif route == "flash":
        assert spy.calls == [dict(causal=causal, scale=None)]
    else:
        assert spy.calls == [dict(causal=False, scale=None, kv_len=s)]
    # every route computes the JAX reference attention (s_q == s_k)
    want = jax_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         is_causal=causal,
                         mask=None if m is None else jnp.asarray(m.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=OUT_TOL, rtol=OUT_TOL)


def test_sdpa_takes_the_reference_for_live_dropout(monkeypatch):
    spy = _Spy(monkeypatch)
    q = torch.from_numpy(_rand(1, 128, 2, 64, 17))
    A.scaled_dot_product_attention(q, q, q, is_causal=True)
    assert len(spy.calls) == 1
    g = torch.Generator().manual_seed(0)
    out = A.scaled_dot_product_attention(q, q, q, dropout_p=0.5,
                                         is_causal=True, generator=g)
    assert len(spy.calls) == 1 and out.shape == q.shape
    evald = A.scaled_dot_product_attention(q, q, q, dropout_p=0.5,
                                           is_causal=True, training=False)
    assert len(spy.calls) == 2 and torch.isfinite(evald).all()


@pytest.mark.parametrize("change, match", [
    (dict(d=72), "multiple of 16"),
    (dict(dtype=torch.float16), "float32 or bfloat16"),
    (dict(k_len=100, v_len=99), r"k and v must be"),
    ({}, "need CUDA tensors"),
])
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(change, match):
    d = change.get("d", 64)
    dt = change.get("dtype", torch.float32)
    q = torch.zeros(1, 128, 2, d, dtype=dt)
    k = torch.zeros(1, change.get("k_len", 128), 2, d, dtype=dt)
    v = torch.zeros(1, change.get("v_len", 128), 2, d, dtype=dt)
    before = dict(KF.LAUNCHES)
    with pytest.raises(ValueError, match=match):
        KF.flash_fwd_cuda(q, k, v, causal=True, scale=0.1)
    assert dict(KF.LAUNCHES) == before
