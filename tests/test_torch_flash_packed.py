"""PyTorch port vs JAX package: packed flash attention (kernel #7's plain
versions against `flash_attention_packed` in interpret mode), its
reshape onto [B, S, H, D] flash attention at other head dims, and the
one-d(qkv) autograd Function GPT's packed route uses.

Inputs are numpy N(0, 1) at B=1, S=256, nh=2, hd=128, f32. Tolerances:
2e-5 absolute and relative on outputs and gradients (f32 scores and
softmax on both sides; the JAX kernel sums in 256-wide blocks with an
online softmax, the plain version in one pass).
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from paddle_tpu.ops.pallas.flash_attention import \
    flash_attention_packed as jpacked
from paddle_tpu_torch.ops import flash_attention as FA

TOL = dict(rtol=2e-5, atol=2e-5)


def _inputs(b=1, s=256, nh=2, hd=128, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, s, nh * hd).astype(np.float32) for _ in range(4)]


def _jax(q, k, v, dout, nh, causal, kv_len):
    def f(q_, k_, v_):
        return jpacked(q_, k_, v_, nh, causal=causal, kv_len=kv_len,
                       interpret=True)
    out, vjp = jax.vjp(f, *(jnp.asarray(t) for t in (q, k, v)))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(dout))]


def _port(q, k, v, dout, nh, causal, kv_len, fn=FA.flash_attention_packed):
    ts = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    out = fn(*ts, nh, causal=causal, kv_len=kv_len)
    out.backward(torch.from_numpy(dout))
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("causal, kv_len", [(True, None), (False, None),
                                            (False, 200), (True, 130)])
def test_output_and_gradients_match_the_jax_kernel(causal, kv_len):
    q, k, v, dout = _inputs()
    jo, jg = _jax(q, k, v, dout, 2, causal, kv_len)
    to, tg = _port(q, k, v, dout, 2, causal, kv_len)
    np.testing.assert_allclose(to, jo, **TOL)
    for got, want, name in zip(tg, jg, ("dq", "dk", "dv")):
        np.testing.assert_allclose(got, want, err_msg=name, **TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_other_head_dims_reshape_onto_flash_attention(causal):
    """head_dim 64: the JAX wrapper reshapes onto its [B, S, H, D] kernel,
    the port onto `flash_attention`; the same function either way."""
    q, k, v, dout = _inputs(nh=4, hd=64, seed=1)
    jo, jg = _jax(q, k, v, dout, 4, causal, None)
    to, tg = _port(q, k, v, dout, 4, causal, None)
    np.testing.assert_allclose(to, jo, **TOL)
    for got, want in zip(tg, jg):
        np.testing.assert_allclose(got, want, **TOL)


def test_kv_len_must_be_positive_like_jax():
    q, k, v, _ = (torch.from_numpy(t) for t in _inputs())
    with pytest.raises(ValueError, match="kv_len"):
        FA.flash_attention_packed(q, k, v, 2, kv_len=0)


def _plain_kernels(monkeypatch):
    """The CUDA wrappers of #7 replaced by their plain versions (written
    into the gradient views they are given), so the autograd Functions run
    on CPU tensors."""
    def fwd(q, k, v, nh, *, causal, scale, kv_len=None):
        return FA.flash_packed_forward_reference(q, k, v, nh, causal, scale,
                                                 kv_len)

    def bwd(q, k, v, out, lse, dout, nh, *, causal, scale, kv_len=None,
            dq=None, dk=None, dv=None):
        grads = FA.flash_packed_bwd_reference(q, k, v, out, lse, dout, nh,
                                              causal, scale, kv_len)
        outs = []
        for dst, g in zip((dq, dk, dv), grads):
            if dst is not None:
                dst.copy_(g)
            outs.append(g if dst is None else dst)
        return tuple(outs)
    monkeypatch.setattr(FA, "flash_packed_fwd_cuda", fwd)
    monkeypatch.setattr(FA, "flash_packed_bwd_cuda", bwd)


@pytest.mark.parametrize("causal", [True, False])
def test_one_dqkv_function_equals_autograd_through_the_slices(
        causal, monkeypatch):
    """GPT's packed route: one Function on the projection qkv [B, S, 3H]
    whose backward writes dq, dk and dv into the column slices of one
    d(qkv). It equals autograd through `flash_attention_packed` on the
    three slices (which sums three zero-filled full-width gradients), and
    the three-input Function gives the same."""
    _plain_kernels(monkeypatch)
    rng = np.random.RandomState(4)
    qkv = rng.randn(2, 256, 3 * 256).astype(np.float32)
    dout = torch.from_numpy(rng.randn(2, 256, 256).astype(np.float32))
    scale = 128 ** -0.5

    def grad_of(fn):
        x = torch.from_numpy(qkv).requires_grad_()
        out = fn(x)
        out.backward(dout)
        return out.detach(), x.grad

    one = grad_of(lambda x: FA._FlashAttentionPackedQKV.apply(
        x, 2, causal, scale))
    three = grad_of(lambda x: FA._FlashAttentionPacked.apply(
        *x.chunk(3, -1), 2, causal, scale, None))
    plain = grad_of(lambda x: FA.flash_attention_packed(
        *x.chunk(3, -1), 2, causal=causal))
    for a, b in zip(one, three):
        assert torch.equal(a, b)
    # the Functions' backward is the FA-2 plain version (delta from the
    # output), autograd's the softmax's: equal to f32 rounding
    for a, b in zip(one, plain):
        torch.testing.assert_close(a, b, **TOL)
    # the CPU entry point takes the plain version under autograd
    cpu = grad_of(lambda x: FA.flash_attention_packed_qkv(x, 2,
                                                          causal=causal))
    for a, b in zip(cpu, plain):
        assert torch.equal(a, b)
