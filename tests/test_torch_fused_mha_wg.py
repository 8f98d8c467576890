"""Kernel #9 (bf16 fused short-sequence MHA) as #6's warpgroup kernels
compute it, sized on the CPU before it runs on the card.

The bf16 route of `fused_mha` launches #6's `fwd_wg`, `dq_wg` and `dkv_wg`
with #9's features (`ops/cuda/csrc/flash_wg.cuh`): the forward walks key
tiles of 128 with an online softmax in f32, multiplies each probability
by its 0/1 keep bit and rounds it to bf16 once before its product with V,
and writes out (times 1 / (1 - p), the kept entries' common scale) in
bf16 and lse = m + log(l) in f32. The backward starts from lse: P =
exp(s - lse); a first pass forms the row term r = rowsum(P * dP * keep)
in f32, as the JAX kernel forms rowsum(dsigma * sigma) (over 1 / (1 -
p)); then FlashAttention-2's dQ and dK/dV passes, dS = P (dP keep - r)
rounded to bf16 once, dV = (P keep)^T dO with P keep rounded once, each
times 1 / (1 - p) at the end. Here
that arithmetic is emulated in PyTorch on `chip_smoke.py`'s FMHA_CASES at
a small batch (and fewer heads where the JAX kernel in interpret mode
would take minutes) and held to the card's per-row limit (`row_err` <=
0.1) against the f32 plain version and, without dropout (the JAX
interpret mode stubs the TPU's random bits), against the JAX Pallas
kernel in interpret mode on the same numpy inputs. A run that drops the
last 64 keys must fail that limit. FA-2's own row term, rowsum(dO * out)
from the bf16 output, would spare that first pass (two of the nine
[S, S] x D products) but fails the limit: the last test shows where.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import fused_mha as jax_fmha
from paddle_tpu_torch.ops import fused_mha as FM

TOL = 0.1          # chip_smoke.py's FMHA_TOL["bfloat16"]
TILE = 128         # key tile of the forward (head dims up to 128)
SEED = 1234        # chip_smoke.py's dropout seed

# (name, B, S, nh, hd, causal, lens, dropout_p): FMHA_CASES' bf16 shapes
# at B <= 2 (the lens case keeps its eight rows at two heads)
CASES = [("bert-base", 1, 512, 12, 64, False, None, 0.0),
         ("bert-base_drop", 1, 512, 12, 64, False, None, 0.1),
         ("vit-l16", 2, 197, 16, 64, False, None, 0.0),
         ("lens", 8, 512, 2, 64, False,
          (512, 400, 257, 128, 77, 1, 511, 0), 0.1),
         ("lens_nodrop", 8, 512, 2, 64, False,
          (512, 400, 257, 128, 77, 1, 511, 0), 0.0),
         ("causal", 1, 512, 4, 64, True, None, 0.0),
         ("d80", 2, 257, 16, 80, False, None, 0.0)]


def _inputs(case):
    """qkv and dout ~ N(0, 1) as chip_smoke.py draws them, in bf16."""
    name, b, s, nh, hd = case[:5]
    rng = np.random.RandomState(sum(map(ord, name)))
    qkv = torch.from_numpy(rng.randn(b, s, 3 * nh * hd).astype(np.float32))
    dout = torch.from_numpy(rng.randn(b, s, nh * hd).astype(np.float32))
    return qkv.to(torch.bfloat16), dout.to(torch.bfloat16)


def _masked_scores(q, k, scale, lens, kv_len, causal):
    """f32 scores [B, nh, S, S] as the kernels see them: -1e30 where
    masked; a batch row whose every key is masked scores 0 everywhere (its
    softmax is uniform, as the JAX kernel's all -1e30 row is), without the
    causal mask."""
    b, s = q.shape[:2]
    sc = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    lim = torch.full((b,), s if kv_len is None else min(kv_len, s))
    if lens is not None:
        lim = torch.as_tensor(lens).clamp(0, s)
    zero = lim <= 0
    lim = torch.where(zero, torch.full_like(lim, s), lim)
    col = torch.arange(s)
    out = col[None, None, None, :] >= lim[:, None, None, None]
    if causal:
        tri = col[None, :] > col[:, None]                    # row < col
        out = out | (tri[None, None] & ~zero[:, None, None, None])
    sc = torch.where(zero[:, None, None, None], torch.zeros(()), sc)
    return torch.where(out, torch.tensor(-1e30), sc)


def _keep(b, nh, s, p):
    if p == 0.0:
        return torch.ones(())
    return FM.keep_scale(torch.tensor([SEED], dtype=torch.int32), p, b, nh,
                         s)


def _kernel(qkv, dout, nh, *, lens=None, kv_len=None, causal=False, p=0.0,
            r_from_out=False):
    """The redesigned kernels' arithmetic: (out, dqkv) in bf16.
    r_from_out forms r as FA-2 does, from the rounded output."""
    b, s, f3 = qkv.shape
    hd = f3 // (3 * nh)
    q, k, v = qkv.reshape(b, s, 3, nh, hd).unbind(2)
    do = dout.reshape(b, s, nh, hd)
    scale = 1.0 / math.sqrt(hd)
    sc = _masked_scores(q, k, scale, lens, kv_len, causal)
    # the kernels apply the 0/1 mask in the products and its common scale
    # 1 / (1 - p) once to out, dq, dk and dv
    keep = (_keep(b, nh, s, p) > 0).float()
    inv = 1.0 / (1.0 - p)
    vh = v.float().permute(0, 2, 1, 3)                       # [B, nh, S, D]
    m = torch.full((b, nh, s, 1), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros(b, nh, s, hd)
    for c0 in range(0, s, TILE):
        t = sc[..., c0:c0 + TILE]
        m_new = torch.maximum(m, t.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        pt = torch.exp(t - m_new)
        l = corr * l + pt.sum(-1, keepdim=True)
        kt = keep if keep.dim() == 0 else keep[..., c0:c0 + TILE]
        acc = corr * acc + (pt * kt).to(torch.bfloat16).float() \
            @ vh[:, :, c0:c0 + TILE]
        m = m_new
    out = (acc * (inv / l)).to(torch.bfloat16)               # [B, nh, S, D]
    lse = m + torch.log(l)
    # backward: the r pass, then the dQ and dK/dV passes
    doh = do.float().permute(0, 2, 1, 3)
    prob = torch.exp(sc - lse)
    dp = doh @ vh.transpose(-1, -2)
    if r_from_out:
        r = (doh * out.float()).sum(-1, keepdim=True) / inv
    else:
        r = (prob * dp * keep).sum(-1, keepdim=True)
    ds = (prob * (dp * keep - r)).to(torch.bfloat16).float()
    qh, kh = (x.float().permute(0, 2, 1, 3) for x in (q, k))
    dq = ds @ kh * (scale * inv)
    dk = ds.transpose(-1, -2) @ qh * (scale * inv)
    dv = (prob * keep).to(torch.bfloat16).float().transpose(-1, -2) @ doh \
        * inv
    pack = [x.permute(0, 2, 1, 3).reshape(b, s, nh * hd)
            for x in (dq, dk, dv)]
    return (out.permute(0, 2, 1, 3).reshape(b, s, nh * hd),
            torch.cat(pack, -1).to(torch.bfloat16))


def _plain(qkv, dout, nh, *, lens=None, p=0.0, causal=False):
    """The f32 plain versions on the bf16 inputs' values."""
    kw = dict(lens=None if lens is None else torch.tensor(lens,
                                                          dtype=torch.int32),
              causal=causal, dropout_p=p,
              seed=torch.tensor([SEED], dtype=torch.int32) if p else None)
    x, d = qkv.float(), dout.float()
    return (FM.fused_mha_reference(x, nh, **kw),
            FM.fused_mha_bwd_reference(x, d, nh, **kw))


def _jax(qkv, dout, nh, *, lens=None, causal=False):
    """The JAX Pallas kernel in interpret mode, f32, on the same values:
    out and the gradient of sum(out * dout)."""
    x = jnp.asarray(qkv.float().numpy())
    d = jnp.asarray(dout.float().numpy())
    kw = dict(causal=causal, interpret=True)
    if lens is not None:
        kw["kv_len"] = jnp.asarray(lens, jnp.int32)
    out, vjp = jax.vjp(lambda a: jax_fmha.fused_mha(a, nh, **kw), x)
    g, = vjp(d)
    return torch.from_numpy(np.array(out)), torch.from_numpy(np.array(g))


def row_err(a, b):
    """chip_smoke.py's `row_err`: the worst row's max |a - b| over the rms
    of b's row, the rms floored at 10% of b's rms over the whole tensor."""
    a, b = a.float(), b.float()
    rms = b.square().mean(-1).sqrt()
    floor = 0.1 * float(b.square().mean().sqrt())
    return float(((a - b).abs().amax(-1) / rms.clamp_min(
        max(floor, 1e-30))).max())


def _errs(got, want, nh):
    """{out, dq, dk, dv: row_err}, rows per (batch, position, head)."""
    (ko, kg), (po, pg) = got, want
    b, s, f = ko.shape
    hd = f // nh
    ks = [ko] + list(kg.split(f, -1))
    ps = [po] + list(pg.split(f, -1))
    return {n: row_err(x.reshape(b, s, nh, hd), y.reshape(b, s, nh, hd))
            for n, x, y in zip(("out", "dq", "dk", "dv"), ks, ps)}


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_bf16_kernel_arithmetic_within_the_card_limit(case):
    name, b, s, nh, hd, causal, lens, p = case
    qkv, dout = _inputs(case)
    got = _kernel(qkv, dout, nh, lens=lens, causal=causal, p=p)
    assert all(bool(torch.isfinite(t.float()).all()) for t in got)
    errs = _errs(got, _plain(qkv, dout, nh, lens=lens, p=p, causal=causal),
                 nh)
    assert max(errs.values()) <= TOL, errs
    if p == 0.0:
        jerrs = _errs(got, _jax(qkv, dout, nh, lens=lens, causal=causal),
                      nh)
        assert max(jerrs.values()) <= TOL, jerrs


@pytest.mark.parametrize("case", [CASES[0], CASES[2]],
                         ids=[CASES[0][0], CASES[2][0]])
def test_dropping_the_last_64_keys_fails_the_limit(case):
    """chip_smoke.py's control: the kernel run with kv_len = S - 64
    against the plain version of the whole function must fail the limit
    on out, dq, dk and dv each."""
    name, b, s, nh, hd, causal, lens, p = case
    qkv, dout = _inputs(case)
    want = _plain(qkv, dout, nh, causal=causal)
    cut = _errs(_kernel(qkv, dout, nh, kv_len=s - 64, causal=causal), want,
                nh)
    assert min(cut.values()) > TOL, cut
    assert max(_errs(_kernel(qkv, dout, nh, causal=causal), want,
                     nh).values()) <= TOL


@pytest.mark.parametrize("case", [CASES[3], CASES[5]],
                         ids=[CASES[3][0], CASES[5][0]])
def test_r_from_the_rounded_output_fails_the_limit(case):
    """Why the backward forms r in a pass of its own: FA-2's r =
    rowsum(dO * out) from the bf16 output, the rest of the arithmetic the
    same, fails the limit where a row's softmax sits on few keys (the
    lens-1 row under dropout, whose output 1 / (1 - p) v is rounded to
    bf16; causal's first rows): there the exact dS is near 0 and r's
    rounding error is all that is left (measured on these inputs: dq
    1.48, dk 8.56 with lens; dq 0.28 causal). With the exact r every case
    here stays within 0.022."""
    name, b, s, nh, hd, causal, lens, p = case
    qkv, dout = _inputs(case)
    want = _plain(qkv, dout, nh, lens=lens, p=p, causal=causal)
    fa2 = _errs(_kernel(qkv, dout, nh, lens=lens, causal=causal, p=p,
                        r_from_out=True), want, nh)
    assert fa2["dq"] > TOL, fa2
    exact = _errs(_kernel(qkv, dout, nh, lens=lens, causal=causal, p=p),
                  want, nh)
    assert max(exact.values()) <= TOL, exact
