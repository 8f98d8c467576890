"""PyTorch port vs JAX package: the window-batched fused MHA with a periodic
additive bias (kernel #10): its gate, its argument checks, its plain
forward and backward twins (the function the CUDA kernels compute, which
the CPU path runs) against the JAX Pallas kernel in interpret mode, and
the block-diagonal grouping invariant Swin relies on.

The same numpy qkv, bias and dO go to both sides. The JAX kernel runs in
interpret mode under jax.jit (forward, and the custom VJP's backward
kernel with d(bias)). Shapes are the JAX tests' ((nh, hd, R) = (4, 32, 2),
(3, 32, 1), (2, 64, 4) at S = 96 and 64, B = 4) plus head dim 8 (the
width of bench_swin's CPU stand-in). Tolerances: f32, 2e-6 absolute
(summation order only; values are O(1), readings ≤ 1.5e-7); bf16, 4e-3
absolute on the bf16-rounded outputs and gradients (one bf16 ulp at
their largest magnitude, 0.6: a probability or dS rounded on the other
side of a bf16 step moves a result by an ulp; readings ≤ 9.8e-4) and
1e-6 on d(bias), which is summed in f32 from f32 dS (readings ≤ 6.7e-8).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops.pallas import fused_mha_bias as JFMB
from paddle_tpu.ops.pallas.fused_mha import mha_reference_packed
from paddle_tpu_torch.ops import fused_mha_bias as FMB
from paddle_tpu_torch.ops import fused_mha as FM

B = 4
F32_CASES = [(4, 32, 2, 96), (3, 32, 1, 96), (2, 64, 4, 96),
             (4, 32, 2, 64), (3, 32, 1, 64), (2, 64, 4, 64), (2, 8, 2, 64)]
BF16_CASES = [(4, 32, 2, 64), (3, 32, 1, 96)]


def _rand(s, nh, hd, r_n, seed=0):
    rng = np.random.RandomState(seed)
    qkv = rng.randn(B, s, 3 * nh * hd).astype(np.float32) * 0.3
    bias = rng.randn(r_n, nh, s, s).astype(np.float32) * 0.5
    dout = rng.randn(B, s, nh * hd).astype(np.float32)
    return qkv, bias, dout


def _jax_kernel(qkv, bias, dout, nh, dtype):
    """(out, dqkv, dbias) of the JAX kernel in interpret mode."""
    hd = qkv.shape[-1] // 3 // nh
    g = nh if (nh * hd) % 128 else None

    def fb(a, b, d):
        o, vjp = jax.vjp(lambda x, y: JFMB.fused_mha_bias(
            x, nh, y, heads_per_program=g, interpret=True), a, b)
        return (o,) + vjp(d)

    out = jax.jit(fb)(jnp.asarray(qkv, dtype), jnp.asarray(bias),
                      jnp.asarray(dout, dtype))
    return [np.asarray(x.astype(jnp.float32)) for x in out]


def _port_twins(qkv, bias, dout, nh, dtype):
    q = torch.from_numpy(qkv).to(dtype)
    b = torch.from_numpy(bias)
    out = FMB.fused_mha_bias_reference(q, b, nh)
    dqkv, dbias = FMB.fused_mha_bias_bwd_reference(
        q, b, torch.from_numpy(dout).to(dtype), nh)
    assert dbias.dtype == torch.float32
    return [x.float().numpy() for x in (out, dqkv, dbias)]


@pytest.mark.parametrize("nh,hd,r_n,s", F32_CASES)
def test_plain_twins_match_the_jax_kernel_f32(nh, hd, r_n, s):
    qkv, bias, dout = _rand(s, nh, hd, r_n)
    got = _port_twins(qkv, bias, dout, nh, torch.float32)
    want = _jax_kernel(qkv, bias, dout, nh, jnp.float32)
    for name, g, w in zip(("out", "dqkv", "dbias"), got, want):
        np.testing.assert_allclose(g, w, atol=2e-6, rtol=0, err_msg=name)


@pytest.mark.parametrize("nh,hd,r_n,s", BF16_CASES)
def test_plain_twins_match_the_jax_kernel_bf16(nh, hd, r_n, s):
    qkv, bias, dout = _rand(s, nh, hd, r_n, seed=1)
    got = _port_twins(qkv, bias, dout, nh, torch.bfloat16)
    want = _jax_kernel(qkv, bias, dout, nh, jnp.bfloat16)
    for name, g, w, tol in zip(("out", "dqkv", "dbias"), got, want,
                               (4e-3, 4e-3, 1e-6)):
        np.testing.assert_allclose(g, w, atol=tol, rtol=0, err_msg=name)


@pytest.mark.parametrize("nh,hd,r_n,s", [(3, 32, 2, 64), (2, 8, 4, 48)])
def test_plain_backward_is_autograd_of_the_plain_forward(nh, hd, r_n, s):
    """In f32 the backward twin (exact in-row term, d(bias) summed over the
    batch rows of each period index) is the gradient of the forward
    twin."""
    qkv, bias, dout = (torch.from_numpy(a).double().float()
                       for a in _rand(s, nh, hd, r_n, seed=2))
    x, b = qkv.clone().requires_grad_(), bias.clone().requires_grad_()
    gx, gb = torch.autograd.grad(FMB.fused_mha_bias_reference(x, b, nh),
                                 (x, b), dout)
    dqkv, dbias = FMB.fused_mha_bias_bwd_reference(qkv, bias, dout, nh)
    torch.testing.assert_close(dqkv, gx, atol=2e-5, rtol=0)
    torch.testing.assert_close(dbias, gb, atol=2e-5, rtol=0)


def test_router_on_cpu_runs_the_twins_and_returns_dbias_in_its_dtype():
    qkv, bias, dout = (torch.from_numpy(a) for a in _rand(64, 3, 32, 2, 3))
    x = qkv.clone().requires_grad_()
    b = bias.to(torch.bfloat16).requires_grad_()
    out = FMB.fused_mha_bias(x, 3, b)
    gx, gb = torch.autograd.grad(out, (x, b), dout)
    want = FMB.fused_mha_bias_reference(qkv, b.detach().float(), 3)
    wx, wb = FMB.fused_mha_bias_bwd_reference(qkv, b.detach().float(),
                                              dout, 3)
    assert torch.equal(out, want) and torch.equal(gx, wx)
    assert gb.dtype == torch.bfloat16 and torch.equal(gb, wb.bfloat16())
    # a strided qkv (a slice, as a caller may pass) gives the same result
    wide = torch.cat([torch.zeros(B, 1, qkv.shape[-1]), qkv], dim=1)
    assert torch.equal(FMB.fused_mha_bias(wide[:, 1:], 3, bias),
                       FMB.fused_mha_bias(qkv, 3, bias))


def test_heads_per_program_is_checked_and_changes_nothing():
    qkv, bias, _ = (torch.from_numpy(a) for a in _rand(64, 8, 32, 2, 4))
    base = FMB.fused_mha_bias(qkv, 8, bias)
    for g in (4, 8, None, 0):
        assert torch.equal(FMB.fused_mha_bias(qkv, 8, bias,
                                              heads_per_program=g), base)
    # G = 2 gives G * hd = 64, not 128-aligned and not nh; 8 % 3 != 0:
    # refused by both
    for fn, arr in ((FMB.fused_mha_bias, (qkv, bias)),
                    (JFMB.fused_mha_bias, (jnp.asarray(qkv.numpy()),
                                           jnp.asarray(bias.numpy())))):
        with pytest.raises(ValueError, match="heads_per_program=2 invalid"):
            fn(arr[0], 8, arr[1], heads_per_program=2)
        with pytest.raises(ValueError, match="heads_per_program=3 invalid"):
            fn(arr[0], 8, arr[1], heads_per_program=3)


@pytest.mark.parametrize("what", ["heads", "length", "period"])
def test_argument_errors_match_jax(what):
    qkv = np.zeros((6, 32, 3 * 2 * 16), np.float32)
    bias = {"heads": np.zeros((2, 3, 32, 32), np.float32),
            "length": np.zeros((2, 2, 32, 31), np.float32),
            "period": np.zeros((4, 2, 32, 32), np.float32)}[what]
    match = "not a multiple of bias period" if what == "period" else \
        "does not match"
    with pytest.raises(ValueError, match=match):
        FMB.fused_mha_bias(torch.from_numpy(qkv), 2, torch.from_numpy(bias))
    with pytest.raises(ValueError, match=match):
        JFMB.fused_mha_bias(jnp.asarray(qkv), 2, jnp.asarray(bias),
                            interpret=True)


def test_gate_is_the_jax_gate_minus_its_platform_test(monkeypatch):
    """On a grid of (S, nh, hd) the port's gate equals the JAX gate with its
    platform test skipped (the JAX override "1"), VMEM formula included,
    except for head dims above 256, the widest head the kernel takes: the
    port refuses them (no model of the repo has one). "0" refuses all."""
    grid = [(s, nh, hd) for s in (49, 98, 196, 392, 512, 513, 784)
            for nh in (1, 3, 4, 6, 12, 24, 32, 48) for hd in (8, 12, 32,
                                                              64, 256, 264)]
    monkeypatch.setenv("PADDLE_TPU_FUSED_MHA_BIAS", "1")
    for s, nh, hd in grid:
        want = JFMB.use_fused_mha_bias(s, nh, hd) and hd <= 256
        assert FMB.use_fused_mha_bias(s, nh, hd) == want, (s, nh, hd)
    assert JFMB.use_fused_mha_bias(64, 2, 264)
    assert not FMB.use_fused_mha_bias(64, 2, 264)
    monkeypatch.setenv("PADDLE_TPU_FUSED_MHA_BIAS", "0")
    assert not any(FMB.use_fused_mha_bias(*c) for c in grid)
    monkeypatch.delenv("PADDLE_TPU_FUSED_MHA_BIAS")
    # swin-t's stages at 224^2: W_g = 8 at S = 392 for nh 3 and 6; nh 24
    # refuses S = 392 (the VMEM formula) and takes S = 196
    assert FMB.use_fused_mha_bias(392, 3, 32)
    assert FMB.use_fused_mha_bias(392, 6, 32)
    assert not FMB.use_fused_mha_bias(392, 24, 32)
    assert FMB.use_fused_mha_bias(196, 24, 32)


def test_block_diag_equals_per_window():
    """Grouping W_g windows with a block-diagonal -1e9 bias equals running
    each window on its own (the Swin routing invariant), in the port's
    twins and in the JAX package's per-window reference."""
    nh, hd, n, wg = 2, 64, 49, 4
    rng = np.random.RandomState(3)
    qkv_w = rng.randn(8, n, 3 * nh * hd).astype(np.float32) * 0.3
    dout_w = rng.randn(8, n, nh * hd).astype(np.float32)
    s = wg * n
    static = np.full((1, 1, s, s), -1e9, np.float32)
    for w in range(wg):
        static[0, 0, w * n:(w + 1) * n, w * n:(w + 1) * n] = 0.0
    bias = torch.from_numpy(np.broadcast_to(static, (1, nh, s, s)).copy())
    x = torch.from_numpy(qkv_w).requires_grad_()
    out = FMB.fused_mha_bias(x.reshape(2, s, -1), nh, bias)
    gx, = torch.autograd.grad(out, x, torch.from_numpy(dout_w).reshape(
        2, s, -1))
    xw = torch.from_numpy(qkv_w).requires_grad_()
    want = FM.mha_reference_packed(xw, nh)
    gw, = torch.autograd.grad(want, xw, torch.from_numpy(dout_w))
    torch.testing.assert_close(out.reshape(8, n, -1), want, atol=2e-5,
                               rtol=0)
    torch.testing.assert_close(gx, gw, atol=2e-5, rtol=0)
    np.testing.assert_allclose(
        out.detach().reshape(8, n, -1).numpy(),
        np.asarray(mha_reference_packed(jnp.asarray(qkv_w), nh)),
        atol=2e-5, rtol=0)
