"""Kernel #8's launch plan and summation order, checked on the CPU.

`ln_plan` (ops/cuda/layer_norm.py) chooses the CUDA kernels' launches;
here it is pinned at the LayerNorm widths the repo's models route under
PADDLE_TPU_FUSED_LN=1. Then the kernels' order of every f32 sum is
emulated in torch f32 from a plan (the per-lane sums of each row's 16-byte
vectors, the warps' butterflies, the warps in order; each backward CTA's
per-thread column sums over its contiguous range of rows, its row slots
in order, then the partials summed by ordered warp chunks) and held
against the JAX kernels in interpret mode within 1e-5 (absolute and
relative: f32 sums of the same terms in another order), on the same numpy
inputs, with several CTAs and ragged ranges. A control drops one CTA's
range from the partials and must fail that limit.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import layer_norm as JL
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.ops.cuda import layer_norm as KL

SUM_WARPS = 16     # the partials' sum: ordered chunks of the partials
# every LayerNorm width a model of the repo routes to #8 (a multiple of
# 128): GPT 768-2560 (presets 125m-2.7b), bert-base 768, vit-l16 1024, and
# swin-t's 4C patch-merge LayerNorms 384 and 1536 and its 768 stage
MODEL_WIDTHS = sorted({c["hidden_size"] for c in TG.PRESETS.values()
                       if c["hidden_size"] <= 2560} | {768, 1024, 384, 1536})
DTYPES = (torch.float32, torch.bfloat16)


def _n(dtype):
    return 16 // dtype.itemsize


def _check_launch(plan, r, h, dtype, sms):
    """What the entry points check, and the instantiations they have."""
    n = _n(dtype)
    assert plan.fwd_threads <= KL.MAX_THREADS
    assert plan.bwd_threads <= KL.MAX_THREADS
    assert 1 <= plan.fwd_grid <= 2 * sms
    assert 1 <= plan.bwd_grid <= min(2 * sms, r)
    if plan.variant == "loop":
        return
    assert plan.fwd_threads % (32 * plan.fwd_warps) == 0
    assert 1 <= plan.fwd_vecs <= 4
    assert 32 * plan.fwd_warps * plan.fwd_vecs * n >= h
    assert plan.bwd_tpr % 32 == 0 and plan.bwd_threads % plan.bwd_tpr == 0
    assert plan.bwd_tpr * plan.bwd_vecs * n >= h
    assert (plan.bwd_vecs, plan.bwd_rows) in {(1, 4), (1, 2), (2, 2)}
    # the rings fit RING_BYTES
    assert KL.FWD_STAGES * plan.fwd_vecs * plan.fwd_threads * 16 <= \
        KL.RING_BYTES
    assert KL.BWD_STAGES * plan.bwd_rows * 2 * plan.bwd_vecs * \
        plan.bwd_threads * 16 <= KL.RING_BYTES


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("h", MODEL_WIDTHS)
def test_plan_reads_each_row_once_at_the_model_widths(h, dtype):
    for r in (8, 6144, 25088):
        plan = KL.ln_plan(r, h, dtype, 132)
        assert plan.variant == "rows"
        _check_launch(plan, r, h, dtype, 132)
    assert MODEL_WIDTHS == [384, 768, 1024, 1536, 2048, 2560]


@pytest.mark.parametrize("r, h", [(64, 32768), (8, 65536), (1000, 8200),
                                  (3, 16392)])
def test_wider_rows_take_the_loop(r, h):
    for dtype in DTYPES:
        plan = KL.ln_plan(r, h, dtype, 132)
        assert plan.variant == "loop"
        _check_launch(plan, r, h, dtype, 132)
    # the "rows" limit: 1024 vectors a row
    assert KL.ln_plan(8, 8192, torch.bfloat16, 132).variant == "rows"
    assert KL.ln_plan(8, 4104, torch.float32, 132).variant == "loop"


def test_plan_depends_only_on_its_arguments():
    args = [(6144, 2048, torch.bfloat16, 132), (6144, 2560, torch.float32,
                                                 114), (5, 384, torch.float32,
                                                        132)]
    first = [KL.ln_plan(*a) for a in args]
    KL.ln_plan.cache_clear()
    assert [KL.ln_plan(*a) for a in reversed(args)][::-1] == first
    # the SM count moves the CTA counts and nothing else
    a, b = KL.ln_plan(6144, 2048, torch.bfloat16, 132), \
        KL.ln_plan(6144, 2048, torch.bfloat16, 66)
    assert (a.fwd_grid, a.bwd_grid) == (264, 264)
    assert (b.fwd_grid, b.bwd_grid) == (132, 132)
    assert a._replace(fwd_grid=0, bwd_grid=0) == \
        b._replace(fwd_grid=0, bwd_grid=0)


# ------------------------------------------------------------ emulation
def _lanes(plan, direction, h, n):
    """(lanes a row, vectors a lane) of the plan's `direction`."""
    v = h // n
    if plan.variant == "loop":
        t = getattr(plan, direction + "_threads")
        return t, math.ceil(v / t)
    if direction == "fwd":
        return 32 * plan.fwd_warps, plan.fwd_vecs
    return plan.bwd_tpr, plan.bwd_vecs


def _row_sums(terms, lanes, vecs, n):
    """Each row's sum of `terms` [R, H] f32 in the kernels' order: lane c
    adds its vectors c, c + lanes, ... (each vector's n elements in order;
    lanes past the row's end add nothing), each warp's lanes meet in a
    butterfly, then the warps in order."""
    rows, h = terms.shape
    v = h // n
    t = torch.zeros(rows, lanes * vecs, n)
    t[:, :v] = terms.reshape(rows, v, n)
    s = torch.zeros(rows, lanes)
    for i in range(vecs):
        for e in range(n):
            s = s + t[:, i * lanes:(i + 1) * lanes, e]
    w = s.reshape(rows, lanes // 32, 32)
    for o in (16, 8, 4, 2, 1):
        w = w + w[..., torch.arange(32) ^ o]
    tot = torch.zeros(rows)
    for k in range(lanes // 32):
        tot = tot + w[:, k, 0]
    return tot


def _fwd_emulated(x, g, b, eps, plan, n):
    h = x.shape[1]
    lanes, vecs = _lanes(plan, "fwd", h, n)
    s1 = _row_sums(x, lanes, vecs, n)
    s2 = _row_sums(x * x, lanes, vecs, n)
    mu = s1 / h
    rs = 1.0 / torch.sqrt((s2 / h - mu * mu).clamp_min(0.0) + eps)
    out = (x - mu[:, None]) * rs[:, None]
    if g is not None:
        out = out * g
    if b is not None:
        out = out + b
    return out, mu, rs


def _cta_partial(tg, tb, r0, r1, plan):
    """A backward CTA's [2, H] partial over rows [r0, r1): each row slot's
    threads add their rows in order (slot s of a group of slots * K rows
    takes rows s * K .. s * K + K - 1), then the slots meet in order."""
    h = tg.shape[1]
    if plan.variant == "loop":
        slots, k = 1, 1
    else:
        slots, k = plan.bwd_threads // plan.bwd_tpr, plan.bwd_rows
    acc = [torch.zeros(2, h) for _ in range(slots)]
    for base in range(r0, r1, slots * k):
        for s in range(slots):
            for i in range(k):
                r = base + s * k + i
                if r < r1:
                    acc[s] = acc[s] + torch.stack([tg[r], tb[r]])
    if slots == 1:
        return acc[0]
    part = torch.zeros(2, h)
    for s in range(slots):
        part = part + acc[s]
    return part


def _bwd_emulated(dy, x, mu, rs, g, plan, n, drop=None):
    rows, h = x.shape
    xh = (x - mu[:, None]) * rs[:, None]
    dyg = dy * g if g is not None else dy
    lanes, vecs = _lanes(plan, "bwd", h, n)
    a = _row_sums(dyg * xh, lanes, vecs, n) / h
    b = _row_sums(dyg, lanes, vecs, n) / h
    dx = rs[:, None] * (dyg - xh * a[:, None] - b[:, None])
    tg, tb = dy * xh, dy
    grid = plan.bwd_grid
    parts = [_cta_partial(tg, tb, c * rows // grid, (c + 1) * rows // grid,
                          plan) for c in range(grid)]
    if drop is not None:
        parts[drop] = torch.zeros(2, h)
    tot = torch.zeros(2, h)
    for w in range(SUM_WARPS):
        chunk = torch.zeros(2, h)
        for i in range(w * grid // SUM_WARPS, (w + 1) * grid // SUM_WARPS):
            chunk = chunk + parts[i]
        tot = tot + chunk
    return dx, tot[0], tot[1]


# (R, H, sms): several CTAs with ragged ranges and ragged last groups;
# 256 and 384 put several row slots in a backward CTA, 640 several warps
# on a forward row, 2560 two vectors a backward thread (f32), 4104 the
# loop (f32; as "rows" in bf16's order)
ORDER_CASES = [(200, 256, 3), (136, 384, 2), (75, 640, 5), (43, 2560, 4),
               (26, 4104, 4)]


def _inputs(r, h, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(r, h) + 0.3).astype(np.float32)
    g = (1 + 0.1 * rng.randn(h)).astype(np.float32)
    b = (0.1 * rng.randn(h)).astype(np.float32)
    dy = rng.randn(r, h).astype(np.float32)
    return x, g, b, dy


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("order", DTYPES, ids=["f32_plan", "bf16_plan"])
@pytest.mark.parametrize("r, h, sms", ORDER_CASES)
def test_emulated_order_matches_the_jax_kernels(r, h, sms, order):
    x, g, b, dy = _inputs(r, h, 7)
    plan = KL.ln_plan(r, h, order, sms)
    g_ = plan.bwd_grid
    sizes = {(c + 1) * r // g_ - c * r // g_ for c in range(g_)}
    group = 1 if plan.variant == "loop" else \
        plan.bwd_rows * plan.bwd_threads // plan.bwd_tpr
    assert g_ > 1 and (len(sizes) > 1 or sizes.pop() % group)
    n = _n(order)
    jout, jmu, jrs = JL._ln_fwd(jnp.asarray(x), jnp.asarray(g),
                                jnp.asarray(b), 1e-5, True)
    out, mu, rs = _fwd_emulated(torch.from_numpy(x), torch.from_numpy(g),
                                torch.from_numpy(b), 1e-5, plan, n)
    _close(out, jout)
    _close(mu, np.asarray(jmu)[0])
    _close(rs, np.asarray(jrs)[0])
    jmu0 = torch.from_numpy(np.array(jmu)[0])
    jrs0 = torch.from_numpy(np.array(jrs)[0])
    jdx, jdg, jdb = JL._ln_bwd(jnp.asarray(dy), jnp.asarray(x), jmu, jrs,
                               jnp.asarray(g), True)
    dx, dg, db = _bwd_emulated(torch.from_numpy(dy), torch.from_numpy(x),
                               jmu0, jrs0, torch.from_numpy(g), plan, n)
    _close(dx, jdx)
    _close(dg, jdg)
    _close(db, jdb)


@pytest.mark.parametrize("r, h, sms", ORDER_CASES[:2] + ORDER_CASES[-1:])
def test_control_dropping_one_ctas_range_fails(r, h, sms):
    x, g, _, dy = _inputs(r, h, 8)
    plan = KL.ln_plan(r, h, torch.float32, sms)
    jout, jmu, jrs = JL._ln_fwd(jnp.asarray(x), jnp.asarray(g), None, 1e-5,
                                True)
    _, jdg, jdb = JL._ln_bwd(jnp.asarray(dy), jnp.asarray(x), jmu, jrs,
                             jnp.asarray(g), True)
    args = (torch.from_numpy(dy), torch.from_numpy(x),
            torch.from_numpy(np.array(jmu)[0]),
            torch.from_numpy(np.array(jrs)[0]), torch.from_numpy(g), plan,
            4)
    _, dg, db = _bwd_emulated(*args)
    _close(dg, jdg)
    _, cg, cb = _bwd_emulated(*args, drop=plan.bwd_grid // 2)
    for got, want in ((cg, jdg), (cb, jdb)):
        with pytest.raises(AssertionError):
            _close(got, want)


# ------------------------------------------------- the build phase's tags
def _chip_smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_NS = "_ZN46_GLOBAL__N__69a8d49e_13_layer_norm_cu_a425d398"
# mangled names as nvcc 12 writes them, and the tags chip_smoke.py's build
# phase files them under (None: the first design's kernels, no part of
# the checks)
MANGLED = {
    _NS + "11ln_fwd_rowsILi4E13__nv_bfloat16EEvNS_9FwdParamsE":
        "ln_fwd_rows<4,bf16>",
    _NS + "11ln_fwd_rowsILi3EfEEvNS_9FwdParamsE": "ln_fwd_rows<3,f32>",
    _NS + "11ln_bwd_rowsILi1ELi4E13__nv_bfloat16EEvNS_9BwdParamsE":
        "ln_bwd_rows<1,4,bf16>",
    _NS + "11ln_bwd_rowsILi2ELi2EfEEvNS_9BwdParamsE": "ln_bwd_rows<2,2,f32>",
    _NS + "11ln_fwd_loopIfEEvNS_9FwdParamsE": "ln_fwd_loop<f32>",
    _NS + "11ln_bwd_loopI13__nv_bfloat16EEvNS_9BwdParamsE":
        "ln_bwd_loop<bf16>",
    _NS + "10ln_bwd_sumEPKfiiPfS2_": "ln_bwd_sum",
    "_ZN12_GLOBAL__N_16ln_fwdI13__nv_bfloat16EEvNS_9FwdParamsE": None,
}


@pytest.mark.parametrize("name", sorted(MANGLED))
def test_build_phase_files_the_layer_norm_kernels(name):
    """chip_smoke.py's SASS and spill checks find #8's kernels by these
    tags, and every instantiation must spill nothing."""
    cs = _chip_smoke()
    tag = MANGLED[name]
    assert cs.redesigned(name) == tag
    if tag is not None:
        assert cs.spill_free(tag) is True
        assert tag.partition("<")[0] in cs.SASS_CHECKS["layer_norm"][0]
