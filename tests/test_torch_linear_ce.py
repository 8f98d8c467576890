"""PyTorch port vs JAX package: fused linear cross-entropy (kernel #11's
plain twin, the closed-form backward) and the fused-loss dispatch.

Inputs come from numpy seeds and go through the JAX Pallas kernel in
interpret mode (`linear_cross_entropy(..., interpret=True)`) and through
the port's `linear_cross_entropy`, whose forward on CPU tensors is the
plain version and whose backward is the JAX package's chunked "onehot"
rule. Both sides are f32. Tolerances: 1e-5 on losses (the JAX package's
own for its kernel), 1e-4 on gradients (matmul summation order).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.incubate.nn.functional import \
    fused_linear_cross_entropy_array as jax_fused
from paddle_tpu.ops.pallas.linear_ce import \
    linear_cross_entropy as jax_linear_ce
from paddle_tpu_torch.incubate.nn.functional import \
    fused_linear_cross_entropy_array
from paddle_tpu_torch.ops import linear_ce as LC
from paddle_tpu_torch.ops.cuda import linear_ce as KL

LOSS_TOL, GRAD_TOL = 1e-5, 1e-4


def _rand(t, h, v, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(t, h).astype(np.float32) * 0.5
    w = rng.randn(v, h).astype(np.float32) * 0.2
    labels = rng.randint(0, v, t).astype(np.int32)
    return x, w, labels


def _jax(x, w, labels, layout, coef, **kw):
    def f(xx, ww):
        return jnp.sum(coef * jax_linear_ce(xx, ww, labels, w_layout=layout,
                                            interpret=True, **kw))
    loss = jax_linear_ce(jnp.asarray(x), jnp.asarray(w), jnp.asarray(labels),
                         w_layout=layout, interpret=True, **kw)
    gx, gw = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    return np.asarray(loss), np.asarray(gx), np.asarray(gw)


def _port(x, w, labels, layout, coef, **kw):
    tx, tw = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    loss = LC.linear_cross_entropy(tx, tw, torch.from_numpy(labels),
                                   w_layout=layout, **kw)
    (loss * torch.from_numpy(coef)).sum().backward()
    return loss.detach().numpy(), tx.grad.numpy(), tw.grad.numpy()


@pytest.mark.parametrize("v", [1024, 1000])    # aligned + ragged tail
def test_forward_matches_jax_kernel(v):
    x, w, labels = _rand(64, 128, v, 0)
    want = jax_linear_ce(jnp.asarray(x), jnp.asarray(w), jnp.asarray(labels),
                         block_t=32, block_v=256, interpret=True)
    got = LC.linear_cross_entropy(torch.from_numpy(x), torch.from_numpy(w),
                                  torch.from_numpy(labels))
    assert got.dtype == torch.float32 and got.shape == (64,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOSS_TOL, rtol=LOSS_TOL)


@pytest.mark.parametrize("layout, bwd_chunks", [("vh", 2), ("hv", 3)])
def test_grads_match_jax_kernel(layout, bwd_chunks):
    x, w, labels = _rand(48, 128, 520, 1)
    wa = w if layout == "vh" else np.ascontiguousarray(w.T)
    coef = np.random.RandomState(7).rand(48).astype(np.float32)
    kw = dict(bwd_chunks=bwd_chunks)
    jl, jgx, jgw = _jax(x, wa, labels, layout, coef, block_t=16,
                        block_v=256, **kw)
    tl, tgx, tgw = _port(x, wa, labels, layout, coef, **kw)
    np.testing.assert_allclose(tl, jl, atol=LOSS_TOL, rtol=LOSS_TOL)
    np.testing.assert_allclose(tgx, jgx, atol=GRAD_TOL, rtol=GRAD_TOL)
    np.testing.assert_allclose(tgw, jgw, atol=GRAD_TOL, rtol=GRAD_TOL)


def test_closed_form_backward_equals_autograd_of_the_plain_version():
    x, w, labels = _rand(40, 64, 300, 2)
    coef = np.random.RandomState(8).rand(40).astype(np.float32)
    _, gx, gw = _port(x, w, labels, "vh", coef, bwd_chunks=3)
    tx, tw = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    ref = LC.linear_cross_entropy_reference(tx, tw, torch.from_numpy(labels))
    (ref * torch.from_numpy(coef)).sum().backward()
    np.testing.assert_allclose(gx, tx.grad.numpy(), atol=GRAD_TOL,
                               rtol=GRAD_TOL)
    np.testing.assert_allclose(gw, tw.grad.numpy(), atol=GRAD_TOL,
                               rtol=GRAD_TOL)


def test_out_of_range_label_adds_no_gold_logit():
    x, w, labels = _rand(8, 32, 50, 3)
    labels[2] = -100
    got = LC.linear_cross_entropy(torch.from_numpy(x), torch.from_numpy(w),
                                  torch.from_numpy(labels))
    lse = torch.logsumexp(torch.from_numpy(x) @ torch.from_numpy(w).t(), -1)
    assert float(got[2]) == pytest.approx(float(lse[2]), rel=1e-6)


@pytest.mark.parametrize("t, h, v, want", [
    (256, 128, 1024, True), (256, 64, 1024, False), (250, 128, 1024, False),
    (256, 128, 1000, False), (8, 256, 50304, True)])
def test_use_linear_ce_shape_rule(t, h, v, want):
    assert LC.use_linear_ce(t, h, v) is want


@pytest.mark.parametrize("h, transpose", [(128, False), (128, True),
                                          (64, False)])
def test_fused_array_matches_jax(h, transpose):
    """h = 128 takes the kernel route in the port (the JAX package, off a
    TPU, always takes its chunked path); h = 64 the chunked path in both."""
    b, s, v = 2, 16, 1024
    rng = np.random.RandomState(4)
    x = rng.randn(b, s, h).astype(np.float32) * 0.5
    w = rng.randn(v, h).astype(np.float32) * 0.2
    wa = np.ascontiguousarray(w.T) if transpose else w
    labels = rng.randint(0, v, (b, s)).astype(np.int32)
    coef = rng.rand(b, s).astype(np.float32)

    def f(xx, ww):
        return jnp.sum(coef * jax_fused(xx, ww, jnp.asarray(labels),
                                        chunk_size=8,
                                        transpose_weight=transpose))
    jl = jax_fused(jnp.asarray(x), jnp.asarray(wa), jnp.asarray(labels),
                   chunk_size=8, transpose_weight=transpose)
    jgx, jgw = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(wa))
    tx, tw = (torch.from_numpy(a).requires_grad_() for a in (x, wa))
    tl = fused_linear_cross_entropy_array(tx, tw, torch.from_numpy(labels),
                                          chunk_size=8,
                                          transpose_weight=transpose)
    (tl * torch.from_numpy(coef)).sum().backward()
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                               atol=LOSS_TOL, rtol=LOSS_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx),
                               atol=GRAD_TOL, rtol=GRAD_TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jgw),
                               atol=GRAD_TOL, rtol=GRAD_TOL)


def test_fused_array_routes_by_the_shape_rule(monkeypatch):
    calls = []
    real = LC.linear_cross_entropy

    def spy(*a, **kw):
        calls.append(kw)
        return real(*a, **kw)
    import paddle_tpu_torch.incubate.nn.functional as FF
    monkeypatch.setattr(FF, "linear_cross_entropy", spy)
    lab = torch.zeros(1, 8, dtype=torch.int64)
    FF.fused_linear_cross_entropy(torch.zeros(1, 8, 128),
                                  torch.zeros(128, 1024), lab,
                                  transpose_weight=True)
    assert calls == [dict(w_layout="hv")]
    FF.fused_linear_cross_entropy(torch.zeros(1, 8, 64),
                                  torch.zeros(1024, 64), lab)
    assert len(calls) == 1


@pytest.mark.parametrize("change, match", [
    (dict(layout="kn"), "w_layout"),
    (dict(dtype=torch.float16), "float32 or bfloat16"),
    (dict(labels=5), "does not match"),
    ({}, "needs CUDA"),
])
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(change, match):
    dt = change.get("dtype", torch.float32)
    x = torch.zeros(8, 128, dtype=dt)
    w = torch.zeros(1024, 128, dtype=dt)
    labels = torch.zeros(change.get("labels", 8), dtype=torch.int64)
    before = dict(KL.LAUNCHES)
    with pytest.raises(ValueError, match=match):
        KL.linear_ce_fwd_cuda(x, w, labels,
                              w_layout=change.get("layout", "vh"))
    assert dict(KL.LAUNCHES) == before


# the shapes of #11's main path (gpt3-1.3b and gpt3-2.7b share T and V),
# bert-base's MLM head (V = 30522: a ragged last vocabulary tile), and
# ragged token and vocabulary counts
SHAPES = [(6144, 50304), (16384, 30522), (512, 1000), (40, 300),
          (1000, 257)]


def _wg_walk(t, v, sms, cta):
    """[(token tile, vocabulary tile)] that CTA `cta` of the persistent
    kernel computes, in order: `lce_wg`'s loop, tile = cta + k * grid,
    token tile tile % n_tt, vocabulary tile tile // n_tt."""
    n_tt, n_vt, grid = KL.wg_schedule(t, v, sms)
    return [(i % n_tt, i // n_tt) for i in range(cta, n_tt * n_vt, grid)]


@pytest.mark.parametrize("t, v", SHAPES)
@pytest.mark.parametrize("sms", [132, 114, 7])
def test_wg_schedule_covers_every_tile_exactly_once(t, v, sms):
    """The persistent bf16 "vh" kernel: every (token tile, vocabulary
    tile) of 128 x 256 is computed by exactly one CTA, the CTAs' shares
    differ by at most one tile, and the tiles the CTAs start on span at
    most ceil(grid / n_tt) + 1 vocabulary tiles (the w tiles they share in
    L2)."""
    n_tt, n_vt, grid = KL.wg_schedule(t, v, sms)
    assert (n_tt, n_vt) == (-(-t // 128), -(-v // 256))
    assert grid == min(sms, n_tt * n_vt)
    walks = [_wg_walk(t, v, sms, c) for c in range(grid)]
    done = sorted(tile for walk in walks for tile in walk)
    assert done == sorted((i, j) for i in range(n_tt) for j in range(n_vt))
    assert max(map(len, walks)) - min(map(len, walks)) <= 1
    first = {walk[0][1] for walk in walks}
    assert len(first) <= -(-grid // n_tt) + 1
    nsplit, tps = KL.splits(t, v, torch.bfloat16, "vh", sms)
    assert (nsplit, tps) == (n_vt, 1)


@pytest.mark.parametrize("t, v", SHAPES)
@pytest.mark.parametrize("dtype, layout", [(torch.bfloat16, "hv"),
                                           (torch.float32, "vh"),
                                           (torch.float32, "hv")])
def test_other_forms_split_every_vocabulary_tile_exactly_once(t, v, dtype,
                                                              layout):
    """bf16 "hv" (128-wide tiles) and f32 (64-wide): split s takes tiles
    [s * tps, min((s + 1) * tps, n_vt)); none is empty, none overlaps."""
    nsplit, tps = KL.splits(t, v, dtype, layout, 132)
    n_vt = -(-v // (128 if dtype == torch.bfloat16 else 64))
    shares = [range(s * tps, min((s + 1) * tps, n_vt))
              for s in range(nsplit)]
    assert all(len(r) > 0 for r in shares)
    assert [i for r in shares for i in r] == list(range(n_vt))
    assert 1 <= nsplit <= 65535


def _tile_partials(x, w, labels):
    """The bf16 "vh" kernel's arithmetic in f32: per 256-wide vocabulary
    tile the (max, sum-exp, gold) triple of every token, columns past V
    masked to -1e30, a label outside [0, V) matching no column; then
    `lce_merge`'s merge in tile order. Returns (loss, lse)."""
    logits = x @ w.t()
    t, v = logits.shape
    labels = labels.long()
    parts = []
    for v0 in range(0, v, 256):
        z = torch.full((t, 256), -1e30)
        z[:, :min(256, v - v0)] = logits[:, v0:v0 + 256]
        m = z.amax(-1)
        s = torch.exp(z - m[:, None]).sum(-1)
        rel = labels - v0
        hit = (rel >= 0) & (rel < 256) & (labels < v)
        g = torch.where(hit, z.gather(1, rel.clamp(0, 255)[:, None])[:, 0],
                        torch.zeros(t))
        parts.append((m, s, g))
    mx = torch.stack([p[0] for p in parts]).amax(0)
    s = sum(p[1] * torch.exp(p[0] - mx) for p in parts)
    lse = mx + torch.log(s)
    return lse - sum(p[2] for p in parts), lse


@pytest.mark.parametrize("t, h, v", [(40, 64, 300), (130, 32, 1000),
                                     (16, 128, 256)])
def test_tile_partials_merge_to_the_plain_version(t, h, v):
    """Per-tile triples merged in a fixed order give the plain loss and
    lse, ragged V included, with labels at -100, at V - 1 and past V in
    the last tile's padding columns."""
    x, w, labels = _rand(t, h, v, 5)
    labels[0], labels[1], labels[2] = -100, v - 1, v + 3
    x, w, labels = map(torch.from_numpy, (x, w, labels))
    loss, lse = _tile_partials(x, w, labels)
    want, want_lse = LC.linear_cross_entropy_reference(x, w, labels,
                                                       return_lse=True)
    torch.testing.assert_close(lse, want_lse, atol=LOSS_TOL, rtol=LOSS_TOL)
    torch.testing.assert_close(loss, want, atol=LOSS_TOL, rtol=LOSS_TOL)


@pytest.mark.parametrize("bad, match", [
    ("base", "16-byte aligned"),
    ("stride", "16-byte aligned"),
    ("last_dim", "contiguous last dim"),
])
def test_matrices_a_tma_map_cannot_take_are_refused(bad, match):
    """#11's bf16 "vh" kernel reads x [T, H] and w [V, H] through 2-D TMA
    maps: `check_view`'s rules, the ones of the flash kernels' views."""
    if bad == "base":        # the base one element past 16-byte alignment
        t = torch.zeros(8, 2 * 64 + 8, dtype=torch.bfloat16)[:, 1:129]
    elif bad == "stride":    # rows of 132 elements: 264 bytes
        t = torch.zeros(8, 132, dtype=torch.bfloat16)[:, :128]
    else:
        t = torch.zeros(128, 8, dtype=torch.bfloat16).t()
    with pytest.raises(ValueError, match=match):
        KL.check_view(t, "x")


@pytest.mark.parametrize("shape", [(6144, 2048), (30522, 768),
                                   (50304, 2560)])
def test_the_main_paths_matrices_pass_the_tma_checks(shape):
    """gpt3-1.3b's and gpt3-2.7b's x and tied heads, bert's MLM head, and a
    column slice of a wider matrix whose rows stay 16-byte aligned."""
    KL.check_view(torch.zeros(shape, dtype=torch.bfloat16), "w")
    wide = torch.zeros(8, shape[1] + 8, dtype=torch.bfloat16)
    KL.check_view(wide[:, :shape[1]], "x")
