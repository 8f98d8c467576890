"""PyTorch port vs JAX package: fused short-sequence MHA (kernel #9's
plain twin), its dropout generator and its router.

Inputs come from numpy seeds and go through the JAX Pallas kernel in
interpret mode (`fused_mha(..., interpret=True)`, as
tests/test_fused_mha.py runs it) and through the port's `fused_mha`,
which on CPU tensors runs its plain version inside the same
torch.autograd.Function the CUDA kernels use. Tolerances: f32 1e-5 on
outputs and gradients (summation order only); bf16 2e-2 of the largest
value (both sides round the probabilities, dS and the outputs to bf16,
and a value near a rounding boundary can land one bf16 step apart).

The JAX kernel's dropout draws from the TPU's own PRNG, which interpret
mode stubs to zeros, so dropout is checked here without JAX: the
generator's definition, its determinism, its keep rate and scale, and
that the backward regenerates the forward's mask.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops.pallas import fused_mha as jax_fmha
from paddle_tpu_torch.ops import fused_mha as FM

F32_TOL, BF16_TOL = 1e-5, 2e-2


def _qkv(b, s, nh, hd, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, s, 3 * nh * hd) * 0.3).astype(np.float32)


def _run_jax(qkv, nh, coef, dtype=jnp.float32, **kw):
    a = jnp.asarray(qkv).astype(dtype)

    def f(x):
        o = jax_fmha.fused_mha(x, nh, interpret=True, **kw)
        return jnp.sum(o.astype(jnp.float32) * coef)
    out = jax_fmha.fused_mha(a, nh, interpret=True, **kw)
    g = jax.grad(f)(a)
    return (np.asarray(out.astype(jnp.float32)),
            np.asarray(g.astype(jnp.float32)))


def _run_port(qkv, nh, coef, dtype=torch.float32, **kw):
    t = torch.from_numpy(qkv).to(dtype).requires_grad_()
    out = FM.fused_mha(t, nh, **kw)
    (out.float() * torch.from_numpy(coef)).sum().backward()
    return out.detach().float().numpy(), t.grad.float().numpy()


def _coef(b, s, f, seed=9):
    return np.random.RandomState(seed).randn(b, s, f).astype(np.float32)


def _close(a, b, tol, what, rel=False):
    scale = float(np.abs(b).max()) if rel else 1.0
    err = float(np.abs(a - b).max())
    assert err <= tol * max(scale, 1e-30), f"{what}: max err {err}"


@pytest.mark.parametrize("s, kw", [
    (128, {}),
    (197, {}),
    (128, dict(causal=True)),
    (197, dict(causal=True)),
    (197, dict(kv_len=150)),
    (128, dict(kv_len=128)),          # kv_len >= S: no mask
])
def test_twin_matches_jax_kernel_f32(s, kw):
    b, nh, hd = 2, 2, 64
    qkv = _qkv(b, s, nh, hd, seed=s)
    coef = _coef(b, s, nh * hd)
    jo, jg = _run_jax(qkv, nh, coef, **kw)
    to, tg = _run_port(qkv, nh, coef, **kw)
    _close(to, jo, F32_TOL, "out")
    _close(tg, jg, F32_TOL, "dqkv")


@pytest.mark.parametrize("s", [128, 197])
def test_twin_matches_jax_kernel_per_row_lens(s):
    """Per-row lens [B]: live query rows compared (the padded query rows
    attend the valid keys too and agree as well, but JAX documents them as
    garbage the loss masks out); the gradient through live rows only."""
    b, nh, hd = 3, 2, 64
    lens = [s, 100, 17]
    qkv = _qkv(b, s, nh, hd, seed=3)
    live = (np.arange(s)[None, :, None] < np.asarray(lens)[:, None, None])
    coef = _coef(b, s, nh * hd) * live
    jo, jg = _run_jax(qkv, nh, coef, kv_len=jnp.asarray(lens, jnp.int32))
    to, tg = _run_port(qkv, nh, coef, kv_len=torch.tensor(lens))
    for i, n in enumerate(lens):
        _close(to[i, :n], jo[i, :n], F32_TOL, f"out row {i}")
    _close(tg, jg, F32_TOL, "dqkv")


@pytest.mark.parametrize("kw", [{}, dict(causal=True)])
def test_twin_matches_jax_kernel_bf16(kw):
    b, s, nh, hd = 2, 197, 2, 64
    qkv = _qkv(b, s, nh, hd, seed=5)
    coef = _coef(b, s, nh * hd)
    jo, jg = _run_jax(qkv, nh, coef, dtype=jnp.bfloat16, **kw)
    to, tg = _run_port(qkv, nh, coef, dtype=torch.bfloat16, **kw)
    _close(to, jo, BF16_TOL, "out", rel=True)
    _close(tg, jg, BF16_TOL, "dqkv", rel=True)


@pytest.mark.parametrize("kw", [{}, dict(causal=True), dict(kv_len=90),
                                dict(kv_len=torch.tensor([128, 1, 33])),
                                dict(dropout_p=0.3, dropout_seed=7)])
def test_twin_backward_is_autograd_of_twin_forward(kw):
    """fused_mha_bwd_reference (the kernel's plain version, through the
    Function) equals autograd of fused_mha_reference in f32, with every
    mask and dropout. (Not with a fully masked batch row: there the JAX
    kernel's backward, which the port follows, passes dS through the
    masked scores; see the next test.)"""
    b, s, nh, hd = 3, 128, 2, 32 * 2
    qkv = _qkv(b, s, nh, hd, seed=8)
    coef = torch.from_numpy(_coef(b, s, nh * hd))
    t = torch.from_numpy(qkv).requires_grad_()
    (FM.fused_mha(t, nh, **kw) * coef).sum().backward()
    ref_kw = {k: v for k, v in kw.items() if k not in ("kv_len",
                                                       "dropout_seed")}
    kv = kw.get("kv_len")
    if torch.is_tensor(kv):
        ref_kw["lens"] = kv
    elif kv is not None:
        ref_kw["kv_len"] = kv
    if "dropout_seed" in kw:
        ref_kw["seed"] = torch.tensor([kw["dropout_seed"]], dtype=torch.int32)
    u = torch.from_numpy(qkv).requires_grad_()
    (FM.fused_mha_reference(u, nh, **ref_kw) * coef).sum().backward()
    assert torch.allclose(t.grad, u.grad, atol=F32_TOL, rtol=F32_TOL)


def test_fully_masked_row_averages_every_key_like_jax():
    """lens 0: every score is -1e30 and the row averages all S values. The
    JAX kernel's backward applies no mask to dS, so such a row's dq and dk
    are sigma * (dsigma - r) through the masked scores (autograd of the
    reference gives 0 there); the port computes what the kernel does."""
    b, s, nh, hd = 2, 64, 2, 64
    qkv = _qkv(b, s, nh, hd, seed=12)
    coef = _coef(b, s, nh * hd)
    lens = [64, 0]
    jo, jg = _run_jax(qkv, nh, coef, kv_len=jnp.asarray(lens, jnp.int32))
    to, tg = _run_port(qkv, nh, coef, kv_len=torch.tensor(lens))
    _close(to, jo, F32_TOL, "out")
    _close(tg, jg, F32_TOL, "dqkv")
    v = qkv.reshape(b, s, 3, nh, hd)[1, :, 2].mean(0).reshape(-1)
    np.testing.assert_allclose(to[1, 0], v, atol=1e-6)


def test_mha_reference_packed_matches_jax():
    qkv = _qkv(2, 96, 4, 32, seed=2)
    for kw in ({}, dict(kv_len=50), dict(causal=True)):
        want = np.asarray(jax_fmha.mha_reference_packed(jnp.asarray(qkv), 4,
                                                        **kw))
        got = FM.mha_reference_packed(torch.from_numpy(qkv), 4, **kw)
        _close(got.numpy(), want, F32_TOL, str(kw))


@pytest.mark.parametrize("s, nh, hd", [
    (s, nh, hd) for s in (64, 197, 512, 768, 769, 1024)
    for nh in (1, 2, 3, 12, 16) for hd in (8, 12, 16, 64, 80, 128, 256)])
def test_gate_is_the_jax_gate_without_its_platform_test(s, nh, hd,
                                                        monkeypatch):
    """PADDLE_TPU_FUSED_MHA=1 skips the JAX gate's platform test; the
    shape rules then agree (head dims up to 256, the widest the kernel
    takes; the gate refuses wider ones, see the next test)."""
    monkeypatch.setenv("PADDLE_TPU_FUSED_MHA", "1")
    assert FM.use_fused_mha(s, nh, hd) == jax_fmha.use_fused_mha(s, nh, hd)
    monkeypatch.setenv("PADDLE_TPU_FUSED_MHA", "0")
    assert not FM.use_fused_mha(s, nh, hd)


def test_gate_refuses_heads_wider_than_the_kernel(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_FUSED_MHA", raising=False)
    assert FM.use_fused_mha(512, 1, 256)
    assert not FM.use_fused_mha(512, 1, 512)


# --------------------------------------------------------------- dropout
def _fmix32_py(h):
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    return h ^ (h >> 16)


def test_dropout_bits_are_the_uint32_definition():
    """The int64 tensor version equals the uint32 definition the CUDA
    kernel computes, seeds near 2^31 and negative ones included."""
    for seed in (0, 7, 2 ** 31 - 1, -5):
        bits = FM.dropout_bits(torch.tensor([seed], dtype=torch.int32), 2,
                               3, 5, 7)
        for bi, h, row, col in [(0, 0, 0, 0), (1, 2, 4, 6), (1, 0, 3, 1)]:
            k1 = _fmix32_py((seed + bi * 3 + h) & 0xFFFFFFFF)
            r = _fmix32_py((k1 + row) & 0xFFFFFFFF)
            want = _fmix32_py((r + col) & 0xFFFFFFFF)
            assert int(bits[bi, h, row, col]) == want
    assert int(bits.min()) >= 0 and int(bits.max()) < 2 ** 32


def test_dropout_mask_is_deterministic_per_seed():
    a = FM.keep_scale(11, 0.3, 2, 4, 64)
    b = FM.keep_scale(11, 0.3, 2, 4, 64)
    c = FM.keep_scale(12, 0.3, 2, 4, 64)
    assert torch.equal(a, b)
    assert (a != c).float().mean() > 0.3
    # heads and batch rows draw different masks
    assert (a[0, 0] != a[0, 1]).float().mean() > 0.3
    assert (a[0, 0] != a[1, 0]).float().mean() > 0.3


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_dropout_keep_rate_and_mean(p):
    """Keep rate within 4 sigma of 1 - p; kept entries scaled by
    1 / (1 - p), so the mask's mean is 1 within 4 sigma."""
    m = FM.keep_scale(3, p, 4, 8, 128)
    n = m.numel()
    kept = (m > 0).double().mean().item()
    assert abs(kept - (1 - p)) <= 4 * math.sqrt(p * (1 - p) / n)
    assert torch.allclose(m[m > 0], torch.tensor(1.0 / (1.0 - p)))
    sd = math.sqrt(p / (1 - p) / n)    # std of the mean of the keep-scale
    assert abs(m.double().mean().item() - 1.0) <= 4 * sd


def test_dropout_preserves_the_output_mean():
    """Averaged over seeds, the dropped output approaches the output
    without dropout (inverted dropout)."""
    qkv = torch.from_numpy(_qkv(1, 64, 2, 64, seed=4))
    base = FM.fused_mha(qkv, 2)
    outs = torch.stack([FM.fused_mha(qkv, 2, dropout_p=0.5, dropout_seed=s)
                        for s in range(64)])
    err = (outs.mean(0) - base).abs().mean() / base.abs().mean()
    assert err < 0.15
    assert not torch.equal(outs[0], outs[1])


def test_dropout_backward_is_autograd_of_the_masked_plain_forward():
    qkv = _qkv(2, 96, 2, 64, seed=6)
    coef = torch.from_numpy(_coef(2, 96, 128))
    t = torch.from_numpy(qkv).requires_grad_()
    (FM.fused_mha(t, 2, dropout_p=0.2, dropout_seed=123) * coef).sum() \
        .backward()
    u = torch.from_numpy(qkv).requires_grad_()
    out = FM.fused_mha_reference(u, 2, dropout_p=0.2,
                                 seed=torch.tensor([123], dtype=torch.int32))
    (out * coef).sum().backward()
    assert torch.allclose(t.grad, u.grad, atol=F32_TOL, rtol=F32_TOL)
    # the backward regenerated the forward's mask: with another mask the
    # gradient would differ
    w = torch.from_numpy(qkv).requires_grad_()
    (FM.fused_mha(w, 2, dropout_p=0.2, dropout_seed=124) * coef).sum() \
        .backward()
    assert not torch.allclose(t.grad, w.grad, atol=1e-3)


def test_zero_p_is_an_exact_noop():
    qkv = torch.from_numpy(_qkv(1, 128, 2, 64, seed=5))
    base = FM.fused_mha(qkv, 2)
    zero = FM.fused_mha(qkv, 2, dropout_p=0.0, dropout_seed=3)
    assert torch.equal(base, zero)
    assert torch.equal(base, FM.fused_mha_reference(qkv, 2))


def test_argument_checks_follow_jax():
    qkv = torch.from_numpy(_qkv(2, 64, 2, 64))
    with pytest.raises(ValueError, match="requires dropout_seed"):
        FM.fused_mha(qkv, 2, dropout_p=0.1)
    with pytest.raises(ValueError, match="must be positive"):
        FM.fused_mha(qkv, 2, kv_len=0)
    with pytest.raises(ValueError, match="B=2 entries"):
        FM.fused_mha(qkv, 2, kv_len=torch.tensor([3, 4, 5]))
    # kv_len >= S is no mask
    assert torch.equal(FM.fused_mha(qkv, 2, kv_len=64),
                       FM.fused_mha(qkv, 2))
    assert torch.equal(FM.fused_mha(qkv, 2, kv_len=1000),
                       FM.fused_mha(qkv, 2))


def _view(qkv, kind):
    """qkv as a tensor the kernels cannot read in place, same values."""
    b, s, f3 = qkv.shape
    if kind == "transposed":
        return qkv.transpose(0, 1).contiguous().transpose(0, 1)
    if kind == "sliced":
        wide = torch.zeros(b, s + 1, f3)
        wide[:, 1:] = qkv
        return wide[:, 1:]
    flat = torch.zeros(qkv.numel() + 1)       # contiguous, 4 bytes off
    flat[1:] = qkv.reshape(-1)
    return flat[1:].view(b, s, f3)


@pytest.mark.parametrize("kind", ["transposed", "sliced", "misaligned"])
def test_router_hands_the_kernels_packed_aligned_tensors(kind,
                                                         monkeypatch):
    """A strided or misaligned qkv (and dout) that the gate admits reaches
    the kernels' wrappers as a contiguous 16-byte aligned copy, with the
    same result as the packed tensor: the CUDA route takes the CPU
    route's inputs."""
    qkv = torch.from_numpy(_qkv(2, 40, 2, 64, seed=7))
    coef = torch.from_numpy(_coef(2, 40, 128))
    t = qkv.clone().requires_grad_()
    (FM.fused_mha(t, 2, kv_len=30, dropout_p=0.1, dropout_seed=5)
     * coef).sum().backward()
    seen = []

    def packed(*ts):
        seen.extend(x.is_contiguous() and x.data_ptr() % 16 == 0
                    for x in ts)

    def fwd(x, nh, **kw):
        packed(x)
        out = FM.fused_mha_reference(x, nh, **kw)
        return out, torch.zeros(x.shape[0], nh, x.shape[1])

    def bwd(x, dout, lse, nh, **kw):
        packed(x, dout)
        assert tuple(lse.shape) == (x.shape[0], nh, x.shape[1])
        return FM.fused_mha_bwd_reference(x, dout, nh, **kw)
    monkeypatch.setattr(FM, "_on_cuda", lambda x: True)
    monkeypatch.setattr(FM, "fused_mha_fwd_cuda", fwd)
    monkeypatch.setattr(FM, "fused_mha_bwd_cuda", bwd)
    v = _view(qkv, kind).requires_grad_()
    assert not (v.is_contiguous() and v.data_ptr() % 16 == 0)
    out = FM.fused_mha(v, 2, kv_len=30, dropout_p=0.1, dropout_seed=5)
    (out * _view(coef, kind)).sum().backward()
    assert seen == [True] * 3
    assert torch.equal(v.grad, t.grad)
