"""Kernel #10's live-block plan, sized on the CPU before it reaches the
card.

The bf16 kernels of `ops/cuda/csrc/fused_mha_bias.cu` visit only the
(64-row, 64-key) blocks of each bias[r, h] that hold an entry above -5e8,
read from the bias values (no window length or W_g reaches them); a query
tile holding a row with no live entry keeps every key tile. The plain
`fused_mha_bias_plan` is that plan. Here it is taken on the port's own
Swin biases (`WindowAttention._bias_plan` plus the tiled relative-position
table, swin-t's four stage shapes, shifted and unshifted, the batch cut)
with its live share asserted; then attention and its gradients are
computed on the live blocks only (the kernels' schedule, in f32) and held
against the full plain version within 1e-6 (the skipped weights are exact
zeros: only the summation order differs) and against the JAX kernel in
interpret mode within 1e-4, on the same numpy inputs; both limits are
relative to each tensor's largest magnitude (at least 1), since f32 sums
in another order differ by a few ulps of the largest term. Two controls: a
bias whose few live entries a row are scattered over non-neighbouring key
tiles, which a plan assuming contiguous windows gets wrong and the real
plan does not; and a row with no live entry, which the full pass gives a
near-uniform softmax over every key, so its query tile keeps every key
tile.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import fused_mha_bias as JFMB
from paddle_tpu_torch.ops import fused_mha_bias as FMB
from paddle_tpu_torch.vision.models import swin as TS

T = FMB.PLAN_TILE
# swin-t at 224^2: (stage map side, heads) of stages 1-4, window 7
STAGES = [(56, 3), (28, 6), (14, 12), (7, 24)]


def _swin_bias(hw, nh, shifted, images=4, seed=0):
    """The port's own bias of one block of a stage: the static plan of
    `WindowAttention._bias_plan` (block-diagonal -1e9, the shift mask)
    plus a random relative-position table tiled W_g x W_g."""
    attn = TS.WindowAttention(nh * 32, nh, 7, device="cpu")
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        attn.rel_bias_table.normal_(0.0, 0.5, generator=g)
    nw = (hw // 7) ** 2
    mask = TS._shift_mask(hw, hw, 7, 3) if shifted else None
    wg, static = attn._bias_plan(images * nw, nw, mask, "cpu")
    with torch.no_grad():
        bias = static[:, None] + attn._rel_bias().repeat(1, wg, wg)
    return wg, bias.contiguous()


def _plan_numpy(bias):
    """The plan by brute force from the definition."""
    b = bias.numpy()
    r_n, nh, s, _ = b.shape
    nt = -(-s // T)
    plan = np.zeros((r_n, nh, nt, nt), np.uint8)
    for qt in range(nt):
        rows = b[:, :, qt * T:(qt + 1) * T] > FMB.PLAN_LIVE
        dead_row = ~rows.any(-1).all(-1)                      # [R, nh]
        for kt in range(nt):
            plan[:, :, qt, kt] = rows[..., kt * T:(kt + 1) * T].any((-1, -2))
        plan[:, :, qt][dead_row] = 1
    return torch.from_numpy(plan)


# stage 4's window covers its map, so it has no shifted block
@pytest.mark.parametrize("hw, nh, shifted",
                         [(hw, nh, sh) for hw, nh in STAGES
                          for sh in (False, True) if hw > 7 or not sh])
def test_plan_of_the_swin_stage_biases(hw, nh, shifted):
    wg, bias = _swin_bias(hw, nh, shifted)
    plan = FMB.fused_mha_bias_plan(bias)
    assert torch.equal(plan, _plan_numpy(bias))
    s = bias.shape[-1]
    nt = -(-s // T)
    assert plan.shape == (bias.shape[0], nh, nt, nt)
    live = float(plan.float().mean())
    # the windows' diagonal blocks are live: every row sees its window
    for w in range(wg):
        lo, hi = w * 49, (w + 1) * 49 - 1
        assert plan[:, :, lo // T, hi // T].all()
        assert plan[:, :, hi // T, lo // T].all()
    if wg == 8:        # stages 1-2: S = 392, 19 of the 49 blocks
        assert s == 392 and live <= 0.40
        assert int(plan[0, 0].sum()) == 19
    else:              # stages 3-4: S = 196, 10 of the 16
        assert s == 196 and int(plan[0, 0].sum()) == 10


def _unpack(qkv, nh):
    b, s, f3 = qkv.shape
    hd = f3 // 3 // nh
    return qkv.reshape(b, s, 3, nh, hd).unbind(2)


def _sparse(qkv, bias, dout, nh, plan):
    """Forward and backward visiting each query tile's live key tiles only,
    in f64 or f32 as given: (out, d(qkv), d(bias)); d(bias) of a dead
    block stays zero."""
    q, k, v = _unpack(qkv, nh)
    b, s, _, hd = q.shape
    r_n = bias.shape[0]
    scale = 1.0 / math.sqrt(hd)
    do = dout.reshape(b, s, nh, hd)
    out, dq, dk, dv = (torch.zeros_like(q) for _ in range(4))
    dbias = torch.zeros_like(bias)
    nt = plan.shape[-1]
    for r in range(r_n):
        bs = torch.arange(r, b, r_n)
        for h in range(nh):
            for qt in range(nt):
                rows = torch.arange(qt * T, min(s, (qt + 1) * T))
                cols = torch.cat([torch.arange(kt * T, min(s, (kt + 1) * T))
                                  for kt in range(nt) if plan[r, h, qt, kt]])
                qq = q[bs][:, rows, h]                      # [b', rq, hd]
                kk, vv = k[bs][:, cols, h], v[bs][:, cols, h]
                sc = qq @ kk.transpose(1, 2) * scale + \
                    bias[r, h][rows][:, cols]
                p = torch.softmax(sc, dim=-1)
                oo = do[bs][:, rows, h]
                out[bs[:, None], rows[None], h] = p @ vv
                dsig = oo @ vv.transpose(1, 2)
                rr = (p * dsig).sum(-1, keepdim=True)
                ds = p * (dsig - rr)
                dbias[r, h, rows[:, None], cols[None]] = ds.sum(0)
                dq[bs[:, None], rows[None], h] = ds @ kk * scale
                dk[bs[:, None], cols[None], h] += \
                    ds.transpose(1, 2) @ qq * scale
                dv[bs[:, None], cols[None], h] += p.transpose(1, 2) @ oo
    f = nh * hd
    dqkv = torch.cat([t.reshape(b, s, f) for t in (dq, dk, dv)], dim=-1)
    return out.reshape(b, s, f), dqkv, dbias


def _close(got, want, tol, what):
    """max |got - want| within tol of the tensor's scale (its largest
    magnitude, at least 1): f32 sums in another order differ by a few ulps
    of the largest term."""
    for name, g, w in zip(("out", "dqkv", "dbias"), got, want):
        g, w = (x if torch.is_tensor(x) else torch.from_numpy(np.array(x))
                for x in (g, w))
        g, w = g.float(), w.float()
        err = float((g - w).abs().max())
        scale = max(1.0, float(w.abs().max()))
        assert err <= tol * scale, (what, name, err, scale)


def _full(qkv, bias, dout, nh):
    return (FMB.fused_mha_bias_reference(qkv, bias, nh),
            *FMB.fused_mha_bias_bwd_reference(qkv, bias, dout, nh))


def _inputs(b, s, nh, hd, seed):
    rng = np.random.RandomState(seed)
    qkv = rng.randn(b, s, 3 * nh * hd).astype(np.float32) * 0.5
    dout = rng.randn(b, s, nh * hd).astype(np.float32)
    return qkv, dout


def _jax(qkv, bias, dout, nh):
    """(out, d(qkv), d(bias)) of the JAX kernel in interpret mode, f32."""
    def fb(a, bb, d):
        o, vjp = jax.vjp(lambda x, y: JFMB.fused_mha_bias(
            x, nh, y, heads_per_program=nh, interpret=True), a, bb)
        return (o,) + vjp(d)
    got = jax.jit(fb)(jnp.asarray(qkv), jnp.asarray(bias),
                      jnp.asarray(dout))
    return [np.asarray(x) for x in got]


# (stage map side, heads cut, images): stage 3 shifted (S = 196, R = 1)
# and stage 1 shifted (S = 392, R = 8), head dim 32 and 8
SPARSE_CASES = [(14, 2, 2, 32), (56, 1, 1, 8)]


@pytest.mark.parametrize("hw, nh, images, hd", SPARSE_CASES)
def test_live_blocks_only_equal_the_full_pass(hw, nh, images, hd):
    wg, bias = _swin_bias(hw, nh, shifted=True, images=images, seed=hw)
    r_n, _, s, _ = bias.shape
    b = images * (hw // 7) ** 2 // wg
    qkv, dout = _inputs(b, s, nh, hd, seed=hw + nh)
    qt, dt = torch.from_numpy(qkv), torch.from_numpy(dout)
    plan = FMB.fused_mha_bias_plan(bias)
    assert float(plan.float().mean()) < 0.7
    got = _sparse(qt, bias, dt, nh, plan)
    _close(got, _full(qt, bias, dt, nh), 1e-6, "full plain pass")
    if hw == 14:    # the JAX kernel in interpret mode at S = 196
        _close(got, _jax(qkv, bias.numpy(), dout, nh), 1e-4, "JAX kernel")


def _window_plan(s, nt, wg, n=49):
    """A plan that assumes Swin's layout: a query tile's live key tiles
    are those its rows' windows cover. What the kernels must not do."""
    plan = torch.zeros(nt, nt, dtype=torch.uint8)
    for qt in range(nt):
        rows = range(qt * T, min(s, (qt + 1) * T))
        for w in {r // n for r in rows}:
            for kt in range(w * n // T, ((w + 1) * n - 1) // T + 1):
                plan[qt, kt] = 1
    return plan


def test_scattered_live_entries_need_the_bias_plan():
    """-1e9 everywhere but three entries a row, two in the row's own key
    tile and one three tiles on: the plan from the bias keeps the far tile
    and matches the full pass; a window plan drops it and fails."""
    s, nh, hd, b = 392, 2, 8, 2
    nt = -(-s // T)
    rng = np.random.RandomState(7)
    bias = np.full((1, nh, s, s), -1e9, np.float32)
    i = np.arange(s)
    qt = i // T
    cols = [np.minimum(qt * T + (13 * i + 29 * j) % T, s - 1)
            for j in (0, 1)]
    cols.append(np.minimum(((qt + 3) % nt) * T + (7 * i) % T, s - 1))
    for c in cols:
        bias[:, :, i, c] = rng.randn(1, nh, s).astype(np.float32) * 0.5
    bias = torch.from_numpy(bias)
    qkv, dout = (torch.from_numpy(a) for a in _inputs(b, s, nh, hd, 3))
    want = _full(qkv, bias, dout, nh)
    plan = FMB.fused_mha_bias_plan(bias)
    assert torch.equal(plan, _plan_numpy(bias))
    _close(_sparse(qkv, bias, dout, nh, plan), want, 1e-6, "scattered")
    wrong = _window_plan(s, nt, 8)[None, None].expand(1, nh, nt, nt)
    assert not torch.equal(wrong, plan)
    bad = _sparse(qkv, bias, dout, nh, wrong)
    assert float((bad[0] - want[0]).abs().max()) > 0.1


def test_a_row_with_no_live_entry_keeps_every_key():
    """A row whose bias is -1e9 throughout gets, in the full pass, a
    softmax over every key; its query tile keeps every key tile, and the
    live-block pass then matches the full one. Dropping the fix-up (the
    tile's own live blocks only) changes that row."""
    s, nh, hd, b = 196, 1, 8, 2
    nt = -(-s // T)
    rng = np.random.RandomState(9)
    bias = np.full((1, nh, s, s), -1e9, np.float32)
    for w in range(4):                     # block-diagonal windows of 49
        sl = slice(w * 49, (w + 1) * 49)
        bias[:, :, sl, sl] = rng.randn(1, nh, 49, 49) * 0.5
    bias[:, :, 70, :] = -1e9               # a row with no live key
    bias = torch.from_numpy(bias.astype(np.float32))
    plan = FMB.fused_mha_bias_plan(bias)
    assert plan[0, 0, 70 // T].all()       # its query tile keeps every key
    assert not plan[0, 0, 0].all()         # another tile does not
    qkv, dout = (torch.from_numpy(a) for a in _inputs(b, s, nh, hd, 4))
    want = _full(qkv, bias, dout, nh)
    _close(_sparse(qkv, bias, dout, nh, plan), want, 1e-6, "dead row")
    naive = plan.clone()
    naive[0, 0, 70 // T] = 0
    naive[0, 0, 70 // T, 0:2] = 1          # the windows of rows 64..127
    bad = _sparse(qkv, bias, dout, nh, naive)
    assert float((bad[0][:, 70] - want[0][:, 70]).abs().max()) > 1e-2
