"""Kernel #4 (int8 paged prefix attention) as its tensor-core tile kernel
computes it, sized on the CPU before it runs on the card.

The bf16 route of `paged_prefix_attention_q8` launches `prefix_tc<DP,
true>` (`ops/cuda/csrc/paged_prefix_attention.cu`): pool columns in tiles
of 64, f32 scores times k_scale * scale, an online softmax in f32, and P *
v_scale rounded to bf16 once as the A operand of its product with the
codes. That rounding is the one arithmetic change against the kernel it
replaced. Here the same schedule is emulated in PyTorch on phase 2's
inputs of `chip_smoke.py` (B=8, H=16, D=128 and 80, windows of 9, 32 and
128 rows, the same starts) and held to the card's limit (allclose at 2e-2)
against the f32 plain version and the JAX reference on the same numpy
inputs; a run that drops each row's last pool block must fail that limit.
The wrappers' view checks of the flash kernels' TMA tensor maps run here
too.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import attention as jattn
from paddle_tpu_torch.ops import attention as tattn
from paddle_tpu_torch.ops.cuda import flash_attention as KF

B, H, BS, MB, NB = 8, 16, 16, 16, 129   # chip_smoke.py's decode shapes
TOL = 2e-2                               # chip_smoke.py's bf16 limit
TILE = 64                                # pool columns per staged tile


def _starts(s):
    """chip_smoke.py's `window_starts`: a dummy slot, block boundary and
    crossing, the system-prompt length, mid-table offsets, and a row whose
    frontier passes the table's extent."""
    return [0, 16, 15, 96, 40, 130, 7, MB * BS - s + 3]


def _inputs(s, d, seed=0):
    """Full tables of distinct blocks, trash past the block of start +
    s // 2 (row 0 all trash, the last row full), random pools quantized
    by the port's `quantize_kv`; q in bf16. numpy-seeded."""
    rng = np.random.RandomState(seed + s + d)
    tables = (rng.permutation(NB - 1) + 1).reshape(B, MB).astype(np.int32)
    start = np.asarray(_starts(s), np.int32)
    used = -(-(start.astype(np.int64) + max(1, s // 2)) // BS)
    keep = np.arange(MB)[None] < used[:, None]
    keep[0] = False
    keep[-1] = True
    tables = np.where(keep, tables, 0).astype(np.int32)
    q = torch.from_numpy(rng.randn(B, s, H, d).astype(np.float32))
    k = torch.from_numpy(rng.randn(NB, BS, H, d).astype(np.float32))
    v = torch.from_numpy(rng.randn(NB, BS, H, d).astype(np.float32))
    kc, ks = tattn.quantize_kv(k)
    vc, vs = tattn.quantize_kv(v)
    return (q.to(torch.bfloat16), (kc, ks, vc, vs),
            torch.from_numpy(tables), torch.from_numpy(start))


def _tile_kernel(q, pools, tables, start):
    """The tile kernel's arithmetic in PyTorch: scores q . codes in f32
    times k_scale * scale, masked past each row's frontier; per 64-column
    tile the online softmax update in f32; P * v_scale rounded to bf16
    before its product with the codes; out = acc / max(l, 1e-30) in
    bf16. (A warp skipping a tile past its frontier leaves its state as an
    all-masked update would: max unchanged, no mass.)"""
    kc, ks, vc, vs = (tattn._paged_gather(p, tables) for p in pools)
    s_len, d = q.shape[1], q.shape[-1]
    width = kc.shape[1]
    scale = 1.0 / math.sqrt(d)
    qf = q.float().permute(0, 2, 1, 3)                    # [B, H, S, D]
    row = torch.arange(s_len)[None, None, :, None]
    front = (start.long()[:, None, None, None] + row).clamp(max=width - 1)
    m = torch.full(qf.shape[:3] + (1,), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    for c0 in range(0, width, TILE):
        cols = torch.arange(c0, min(c0 + TILE, width))
        kt = kc[:, cols].float().permute(0, 2, 3, 1)       # [B, H, D, T]
        vt = vc[:, cols].float().permute(0, 2, 1, 3)       # [B, H, T, D]
        kst = ks[:, cols].permute(0, 2, 1)[:, :, None, :]  # [B, H, 1, T]
        vst = vs[:, cols].permute(0, 2, 1)[:, :, None, :]
        masked = cols[None, None, None, :] > front
        sc = torch.where(masked, torch.tensor(-1e30),
                         (qf @ kt) * (kst * scale))
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.where(masked, torch.tensor(0.0), torch.exp(sc - m_new))
        l = corr * l + p.sum(-1, keepdim=True)
        pv = (p * vst).to(torch.bfloat16).float()
        acc = corr * acc + pv @ vt
        m = m_new
    out = acc / l.clamp_min(1e-30)
    return out.permute(0, 2, 1, 3).to(torch.bfloat16)


def _jax_reference(q, pools, tables, start):
    args = [jnp.asarray(t.float().numpy() if t.dtype == torch.bfloat16
                        else t.numpy()) for t in (q, *pools, tables, start)]
    return torch.from_numpy(np.array(
        jattn.paged_prefix_attention_reference_q8(*args)))


def _close(a, b):
    return torch.allclose(a.float(), b.float(), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("s", [9, 32, 128])
@pytest.mark.parametrize("d", [128, 80])
def test_one_bf16_rounding_of_p_vscale_stays_within_the_card_limit(s, d):
    q, pools, tables, start = _inputs(s, d)
    got = _tile_kernel(q, pools, tables, start)
    plain_f32 = tattn.paged_prefix_attention_reference_q8(
        q.float(), *pools, tables, start)
    plain_bf16 = tattn.paged_prefix_attention_reference_q8(
        q, *pools, tables, start)
    jax_f32 = _jax_reference(q, pools, tables, start)
    assert torch.isfinite(got.float()).all()
    for want in (plain_f32, plain_bf16, jax_f32):
        err = float((got.float() - want.float()).abs().max())
        assert _close(got, want), err
        assert err < TOL, err


@pytest.mark.parametrize("s", [9, 128])
def test_dropping_each_rows_last_pool_block_fails_the_limit(s):
    """The chip's control for #4: start lowered by 16 on every row whose
    start is at least 16 (so it loses its last 16 columns) against the
    plain version of the true inputs."""
    q, pools, tables, start = _inputs(s, 128)
    cut = torch.where(start >= 16, start - 16, start)
    got = _tile_kernel(q, pools, tables, cut)
    want = tattn.paged_prefix_attention_reference_q8(q, *pools, tables,
                                                     start)
    assert not _close(got, want)
    assert _close(_tile_kernel(q, pools, tables, start), want)


@pytest.mark.parametrize("shape", [(16, 128), (32, 80), (12, 64)])
def test_packed_qkv_views_pass_the_tma_checks(shape):
    """The q, k and v column slices of one [B, S, 3 nh hd] projection
    (gpt3-1.3b's 16 x 128, gpt3-2.7b's 32 x 80, gpt3-125m's 12 x 64) are
    views a TMA tensor map takes as they are."""
    nh, hd = shape
    qkv = torch.zeros(2, 8, 3 * nh * hd, dtype=torch.bfloat16)
    for name, t in zip("qkv", qkv.chunk(3, -1)):
        KF.check_view(t.unflatten(-1, (nh, hd)), name)
    fused = torch.zeros(2, 8, 3, nh, hd, dtype=torch.bfloat16)
    for i, name in enumerate("qkv"):
        KF.check_view(fused[:, :, i], name)


@pytest.mark.parametrize("bad, match", [
    ("base", "16-byte aligned"),
    ("stride", "16-byte aligned"),
    ("last_dim", "contiguous last dim"),
])
def test_views_a_tma_map_cannot_take_are_refused(bad, match):
    if bad == "base":        # the base one element past 16-byte alignment
        t = torch.zeros(1, 8, 2 * 64 + 8, dtype=torch.bfloat16)[..., 1:129]
    elif bad == "stride":    # rows of 132 elements: 264 bytes
        t = torch.zeros(1, 8, 132, dtype=torch.bfloat16)[..., :128]
    else:
        t = torch.zeros(1, 128, 8, dtype=torch.bfloat16).transpose(1, 2)
    with pytest.raises(ValueError, match=match):
        KF.check_view(t.unflatten(-1, (2, 64)), "q")
