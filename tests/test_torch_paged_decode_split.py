"""Kernels #1 and #2 (paged decode attention) as the split-sequence kernel
computes them, sized on the CPU against the JAX kernels.

The CUDA route of `paged_attention` / `paged_attention_q8` launches
`decode_part` and `decode_merge` (`ops/cuda/csrc/paged_attention.cu`): a
row's positions are split into partitions of 64, one CTA each; inside a
CTA a group of G lanes owns positions part * 64 + grp + NG * u and keeps
its own (max, sum, acc) in f32, updated 8 positions at a time; the groups'
states are merged in group order, then the partitions' in partition order
(a row of one partition skips the second launch: its CTA divides by
max(sum, 1e-30), so an empty row gives zeros). That is the TPU kernel's
f32 arithmetic summed in another order: the one rounding change of the
redesign. Here that schedule is emulated in PyTorch on phase 2's inputs of
`chip_smoke.py` (B=8, H=16, D=128 and 80, bs=16, MB=16, its lens) and held
against `paged_attention_kernel` / `paged_attention_q8_kernel` in
interpret mode on the same numpy inputs, at the card's limits (allclose
2e-2 bf16, 1e-5 f32); a run that drops each row's last pool block must
fail the bf16 limit.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.paged_attention import (paged_attention_kernel,
                                                   paged_attention_q8_kernel)
from paddle_tpu_torch.ops import attention as tattn

B, H, BS, MB, NB = 8, 16, 16, 16, 129       # chip_smoke.py's decode shapes
LENS = [0, 1, 7, 16, 100, 200, 255, 256]    # chip_smoke.py's LENS
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}
PART, THREADS, UB = 64, 128, 8              # kPart, kThr, kUB of the kernel


def _layout(d, pool_dtype):
    """(NG, U) of the kernel's `Layout<KT, NV>`: 16-byte chunks of fp
    elements (8 bytes of int8 codes), G lanes a position (the next power of
    two over the chunks of the widest row 32 NV, at most 32), NG groups a
    CTA, U positions a group in a partition."""
    e = 4 if pool_dtype == torch.float32 else 8
    nc = 32 * (-(-d // 32)) // e
    g = next(x for x in (2, 4, 8, 16, 32) if x >= nc or x == 32)
    ng = THREADS // g
    return ng, PART // ng


def _inputs(d, dtype, q8, seed=11):
    """chip_smoke.py's `kernel_inputs`, numpy-seeded: each row's lens[b]
    positions in blocks scattered through the pool, trash block 0 past
    them; int8 pools quantized from the f32 draws with `quantize_kv`."""
    rng = np.random.RandomState(seed + d + 2 * q8)
    tables = (rng.permutation(NB - 1) + 1).reshape(B, MB).astype(np.int32)
    lens = np.asarray(LENS, np.int32)
    used = np.arange(MB)[None] * BS < lens[:, None]
    tables = np.where(used, tables, 0).astype(np.int32)
    q = torch.from_numpy(rng.randn(B, 1, H, d).astype(np.float32)).to(dtype)
    k, v = (torch.from_numpy(rng.randn(NB, BS, H, d).astype(np.float32))
            for _ in range(2))
    if q8:
        pools = (*tattn.quantize_kv(k), *tattn.quantize_kv(v))
    else:
        pools = (k.to(dtype), v.to(dtype))
    return q, pools, torch.from_numpy(tables), torch.from_numpy(lens)


def _split_kernel(q, pools, tables, lens):
    """`decode_part` + `decode_merge` in PyTorch, f32 throughout, out in
    q's dtype."""
    q8 = len(pools) == 4
    k, v = (tattn._paged_gather(p, tables).float()
            for p in (pools[0::2] if q8 else pools))
    if q8:
        ks, vs = (tattn._paged_gather(p, tables).permute(0, 2, 1)
                  for p in pools[1::2])                       # [B, H, W]
    b, width, h, d = k.shape
    ng, u_n = _layout(d, pools[0].dtype)
    n_part = width // PART
    scale = 1.0 / math.sqrt(d)
    n = lens.long().clamp(0, width)
    s = torch.einsum("bhd,bwhd->bhw", q.float()[:, 0], k)
    s = s * (ks * scale) if q8 else s * scale
    live = torch.arange(width)[None, None] < n[:, None, None]
    s = torch.where(live, s, torch.tensor(-1e30))
    # position part * 64 + grp + NG * u at [part, u, grp]
    shape = (b, h, n_part, u_n, ng)
    s, live = s.view(shape), live.expand(b, h, width).reshape(shape)
    vv = v.permute(0, 2, 1, 3).reshape(shape + (d,))
    vsc = vs.reshape(shape) if q8 else None
    m = torch.full((b, h, n_part, ng), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros(b, h, n_part, ng, d)
    for u0 in range(0, u_n, UB):
        sb, lb = s[:, :, :, u0:u0 + UB], live[:, :, :, u0:u0 + UB]
        mx = torch.maximum(m, sb.amax(3))
        corr = torch.exp(m - mx)
        p = torch.where(lb, torch.exp(sb - mx[:, :, :, None]),
                        torch.tensor(0.0))
        l = l * corr + p.sum(3)
        pu = p * vsc[:, :, :, u0:u0 + UB] if q8 else p
        acc = acc * corr[..., None] + torch.einsum(
            "bhpug,bhpugd->bhpgd", pu, vv[:, :, :, u0:u0 + UB])
        m = mx
    # the groups' states in a CTA
    big_m = m.amax(-1)
    w = torch.exp(m - big_m[..., None])
    big_l = (l * w).sum(-1)
    a = (acc * w[..., None]).sum(-2)                          # [B, H, P, D]
    # rows of one partition: the CTA's own output; else the merge over the
    # row's partitions
    np_row = ((n + PART - 1) // PART).clamp_min(1)
    one = a[:, :, 0] / big_l[:, :, 0, None].clamp_min(1e-30)
    mine = (torch.arange(n_part)[None] < np_row[:, None])[:, None]
    mm = torch.where(mine, big_m, torch.tensor(-1e30)).amax(-1)
    e = torch.where(mine, torch.exp(big_m - mm[..., None]),
                    torch.tensor(0.0))
    many = (a * e[..., None]).sum(-2) / (big_l * e).sum(-1)[..., None]
    out = torch.where((np_row == 1)[:, None, None], one, many)
    return out[:, None].to(q.dtype)


def _jax_kernel(q, pools, tables, lens):
    fn = paged_attention_q8_kernel if len(pools) == 4 else \
        paged_attention_kernel
    args = [jnp.asarray(t.float().numpy() if t.dtype == torch.bfloat16
                        else t.numpy()) for t in (q, *pools, tables, lens)]
    return torch.from_numpy(np.array(fn(*args, interpret=True)))


def _close(a, b, tol):
    return torch.allclose(a.float(), b.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("d", [128, 80])
@pytest.mark.parametrize("q8", [False, True], ids=["fp", "q8"])
def test_partition_split_and_merge_stay_within_the_card_limit(q8, d, dtype):
    q, pools, tables, lens = _inputs(d, dtype, q8)
    got = _split_kernel(q, pools, tables, lens)
    want = _jax_kernel(q, pools, tables, lens)
    tol = TOL[dtype]
    err = float((got.float() - want.float()).abs().max())
    assert torch.isfinite(got.float()).all()
    assert _close(got, want, tol), err
    assert (got[lens == 0] == 0).all()
    # rows of 1-4 partitions all take part (LENS spans them)
    assert sorted({-(-n // PART) for n in LENS}) == [0, 1, 2, 4]


@pytest.mark.parametrize("d", [128, 80])
@pytest.mark.parametrize("q8", [False, True], ids=["fp", "q8"])
def test_dropping_each_rows_last_pool_block_fails_the_limit(q8, d):
    """chip_smoke.py's control for #1/#2: lens cut to the start of each
    live row's last pool block, against the JAX kernel on the true lens."""
    q, pools, tables, lens = _inputs(d, torch.bfloat16, q8)
    cut = torch.where(lens > 0, lens - ((lens - 1) % BS + 1), lens)
    want = _jax_kernel(q, pools, tables, lens)
    assert not _close(_split_kernel(q, pools, tables, cut), want, 2e-2)
    assert _close(_split_kernel(q, pools, tables, lens), want, 2e-2)
