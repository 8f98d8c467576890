"""Kernel #3 (bf16 paged prefix attention) as its tensor-core tile kernel
computes it, sized on the CPU before it runs on the card.

The bf16 route of `paged_prefix_attention` launches `prefix_tc` over bf16
pools (`ops/cuda/csrc/paged_prefix_attention.cu`): pool columns in tiles of
64, f32 scores times scale, an online softmax in f32, and P rounded to bf16
once as the A operand of its product with V. That rounding is the one
arithmetic change against the kernel it replaced (the JAX kernel keeps p in
f32; the plain version rounds the normalised probabilities instead). Here
the same schedule is emulated in PyTorch on phase 2's inputs of
`chip_smoke.py` (B=8, H=16, D=128 and 80, windows of 1, 9, 32 and 128 rows,
the same starts, a row whose frontier passes the table's extent) and held
to the card's limit (allclose at 2e-2) against the f32 plain version, the
bf16 plain version, and the JAX Pallas kernel in interpret mode and its
XLA reference on the same numpy inputs; a run that drops each row's last
pool block must fail that limit.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import attention as jattn
from paddle_tpu.ops.pallas.paged_attention import \
    paged_prefix_attention_kernel
from paddle_tpu_torch.ops import attention as tattn

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
    s // 2 (row 0 all trash, the last row full), random pools, trash block
    included; q and pools in bf16. numpy-seeded."""
    rng = np.random.RandomState(seed + s + d)
    tables = (rng.permutation(NB - 1) + 1).reshape(B, MB).astype(np.int32)
    start = np.asarray(_starts(s), np.int32)
    used = -(-(start.astype(np.int64) + max(1, s // 2)) // BS)
    keep = np.arange(MB)[None] < used[:, None]
    keep[0] = False
    keep[-1] = True
    tables = np.where(keep, tables, 0).astype(np.int32)
    q, k, v = (torch.from_numpy(rng.randn(*shape).astype(np.float32))
               .to(torch.bfloat16)
               for shape in ((B, s, H, d), (NB, BS, H, d), (NB, BS, H, d)))
    return q, (k, v), torch.from_numpy(tables), torch.from_numpy(start)


def _tile_kernel(q, pools, tables, start):
    """The tile kernel's arithmetic in PyTorch: scores q . k in f32 times
    scale, masked past each row's frontier; per 64-column tile the online
    softmax update in f32; P rounded to bf16 before its product with V;
    out = acc / max(l, 1e-30) in bf16. (A warp skipping a tile past its
    frontier leaves its state as an all-masked update would: max
    unchanged, no mass.)"""
    k, v = (tattn._paged_gather(p, tables) for p in pools)
    s_len, d = q.shape[1], q.shape[-1]
    width = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    qf = q.float().permute(0, 2, 1, 3)                    # [B, H, S, D]
    row = torch.arange(s_len)[None, None, :, None]
    front = (start.long()[:, None, None, None] + row).clamp(max=width - 1)
    m = torch.full(qf.shape[:3] + (1,), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    for c0 in range(0, width, TILE):
        cols = torch.arange(c0, min(c0 + TILE, width))
        kt = k[:, cols].float().permute(0, 2, 3, 1)        # [B, H, D, T]
        vt = v[:, cols].float().permute(0, 2, 1, 3)        # [B, H, T, D]
        masked = cols[None, None, None, :] > front
        sc = torch.where(masked, torch.tensor(-1e30), (qf @ kt) * scale)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.where(masked, torch.tensor(0.0), torch.exp(sc - m_new))
        l = corr * l + p.sum(-1, keepdim=True)
        acc = corr * acc + p.to(torch.bfloat16).float() @ vt
        m = m_new
    out = acc / l.clamp_min(1e-30)
    return out.permute(0, 2, 1, 3).to(torch.bfloat16)


def _jax(fn, q, pools, tables, start, **kw):
    args = [jnp.asarray(t.float().numpy() if t.dtype == torch.bfloat16
                        else t.numpy()) for t in (q, *pools, tables, start)]
    return torch.from_numpy(np.array(fn(*args, **kw)))


def _close(a, b):
    return torch.allclose(a.float(), b.float(), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("s", [1, 9, 32, 128])
@pytest.mark.parametrize("d", [128, 80])
def test_one_bf16_rounding_of_p_stays_within_the_card_limit(s, d):
    q, pools, tables, start = _inputs(s, d)
    got = _tile_kernel(q, pools, tables, start)
    plain_f32 = tattn.paged_prefix_attention_reference(
        q.float(), *(p.float() for p in pools), tables, start)
    plain_bf16 = tattn.paged_prefix_attention_reference(q, *pools, tables,
                                                        start)
    jax_kernel = _jax(paged_prefix_attention_kernel, q, pools, tables,
                      start, interpret=True)
    jax_ref = _jax(jattn.paged_prefix_attention_reference, q, pools, tables,
                   start)
    assert torch.isfinite(got.float()).all()
    for want in (plain_f32, plain_bf16, jax_kernel, jax_ref):
        err = float((got.float() - want.float()).abs().max())
        assert _close(got, want), err
        assert err < TOL, err


@pytest.mark.parametrize("s", [9, 128])
@pytest.mark.parametrize("d", [128, 80])
def test_dropping_each_rows_last_pool_block_fails_the_limit(s, d):
    """The chip's control for #3: start lowered by 16 on every row whose
    start is at least 16 (so it loses its last 16 columns) against the
    plain version of the true inputs."""
    q, pools, tables, start = _inputs(s, d)
    cut = torch.where(start >= 16, start - 16, start)
    want = tattn.paged_prefix_attention_reference(q, *pools, tables, start)
    assert not _close(_tile_kernel(q, pools, tables, cut), want)
    assert _close(_tile_kernel(q, pools, tables, start), want)
