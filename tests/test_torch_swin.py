"""PyTorch port vs JAX package: the Swin Transformer (window partition with
the cyclic shift, window attention through the window-batched fused MHA
with bias, patch merging, mean pooling, the head), its training gradients
and a TrainStep carried across.

Small f32 models are built in the JAX package (structure only, then filled
from numpy with the JAX package's distributions, which is much cheaper on
the CPU than its own initialisers); their state dicts go through
`model_state_from_paddle` into the port, and both sides see the same numpy
images. On the CPU the JAX model takes its reference attention (the fused
kernel's gate holds only on a TPU) and the port the fused route's plain
twin; the JAX fused route, forced and run in interpret mode, is compared
too. Two shapes:
  * bench_swin's CPU stand-in (image 32, patch 2, embed 16, depths (2, 2),
    heads (2, 4), window 4): shifted masks, R = 2 at S = 128, S = 64;
  * swin-t itself (image 224, patch 4, embed 96, heads 3/6/12/24, window
    7) cut to depths (2, 2, 2, 2), B = 2: S = 392 with R = 8 and R = 2,
    S = 196, and the 7x7 last stage (one window per image) grouping the
    two images at W_g = 2, S = 98.
Tolerances (f32, summation order only): 1e-5 relative on the loss, 1e-5
absolute on logits and on every gradient (the largest readings are
1.0e-6 and 4.8e-7 at the swin-t shape).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.core import autograd
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.jit.api import _swap_params, _trace_guard
from paddle_tpu.nn import initializer as JI
from paddle_tpu.ops.pallas import fused_mha_bias as JFMB
from paddle_tpu.vision.models import swin as JS
import paddle_tpu_torch as pt
from paddle_tpu_torch.convert import _is_linear_weight
from paddle_tpu_torch.ops import fused_mha_bias as FMB
from paddle_tpu_torch.vision.models import swin as TS

CASES = {
    "bench_cpu": dict(image_size=32, patch_size=2, embed_dim=16,
                      depths=(2, 2), num_heads=(2, 4), window_size=4,
                      num_classes=10),
    "swin_t_d2": dict(image_size=224, patch_size=4, embed_dim=96,
                      depths=(2, 2, 2, 2), num_heads=(3, 6, 12, 24),
                      window_size=7, num_classes=10),
}
ATOL = 1e-5


def _jax_model(cfg, seed=0):
    """A JAX Swin filled from numpy: Xavier-uniform weights, the conv's
    uniform bound, tables N(0, 0.2) clipped at 2 sigma (larger than the
    0.02 init, so the bias moves the softmax), LayerNorm gains near 1 and
    small nonzero biases (so every gradient path carries signal)."""
    with JI.fast_init():
        jm = JS.SwinTransformer(**cfg)
    rng = np.random.RandomState(seed)
    for n, p in jm.named_parameters():
        shape = tuple(p.shape)
        if n.endswith("rel_bias_table"):
            a = np.clip(rng.randn(*shape), -2, 2) * 0.2
        elif n.startswith("patch_embed."):
            b = 1.0 / np.sqrt(cfg.get("num_channels", 3)
                              * cfg["patch_size"] ** 2)
            a = rng.uniform(-b, b, shape)
        elif len(shape) == 1:
            base = 1.0 if "norm" in n and n.endswith(".weight") else 0.0
            a = base + 0.05 * rng.randn(*shape)
        else:
            b = np.sqrt(6.0 / (shape[0] + shape[1]))
            a = rng.uniform(-b, b, shape)
        p.set_value(jnp.asarray(a.astype(np.float32)))
    return jm


def _pair(cfg, seed=0):
    jm = _jax_model(cfg, seed)
    np_state = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    tm = pt.SwinTransformer(**cfg, device="cpu")
    tm.load_state_dict(pt.model_state_from_paddle(np_state, tm))
    return jm, tm


def _jax_loss_grads(jm, img, lab):
    """(loss, logits, {name: grad}) of the JAX model's cross-entropy, as
    one jitted value_and_grad (the TrainStep's own tracing path)."""
    named = list(jm.named_parameters())
    params = [p for _, p in named]
    ce = paddle.nn.CrossEntropyLoss()

    def f(pa, x, y):
        def loss_of(pa):
            with _trace_guard(), _swap_params(params, list(pa)), \
                    autograd.no_grad():
                logits = jm(Tensor(x))
                loss = ce(logits, Tensor(y))
            return loss._data.astype(jnp.float32), logits._data
        (loss, logits), g = jax.value_and_grad(loss_of, has_aux=True)(pa)
        return loss, logits, g

    loss, logits, g = jax.jit(f)([p._data for p in params],
                                 jnp.asarray(img), jnp.asarray(lab))
    return (float(loss), np.asarray(logits),
            {n: np.asarray(x) for (n, _), x in zip(named, g)})


def _port_loss_grads(tm, img, lab):
    tm.zero_grad(set_to_none=True)
    logits = tm(torch.from_numpy(img))
    loss = torch.nn.functional.cross_entropy(logits, torch.from_numpy(lab))
    loss.backward()
    return (float(loss.detach()), logits.detach().numpy(),
            {n: p.grad.numpy() for n, p in tm.named_parameters()})


def _data(cfg, b=2, seed=1):
    rng = np.random.RandomState(seed)
    hw = cfg["image_size"]
    img = rng.randn(b, 3, hw, hw).astype(np.float32)
    lab = rng.randint(0, cfg["num_classes"], (b,)).astype(np.int64)
    return img, lab


def _assert_close(port, jax_side, what):
    tl, tlog, tg = port
    jl, jlog, jg = jax_side
    assert tl == pytest.approx(jl, rel=1e-5), what
    np.testing.assert_allclose(tlog, jlog, atol=ATOL, rtol=0, err_msg=what)
    assert set(tg) == set(jg)
    for n, g in jg.items():
        if _is_linear_weight(n, g.ndim):
            g = g.T
        np.testing.assert_allclose(tg[n], g, atol=ATOL, rtol=0,
                                   err_msg=f"{what}: {n}")


@pytest.fixture
def forced_jax_fused(monkeypatch):
    """The JAX fused route on the CPU: the gate's own override skips its
    platform test, and the Pallas kernel runs in interpret mode."""
    monkeypatch.setenv("PADDLE_TPU_FUSED_MHA_BIAS", "1")
    orig = JFMB.fused_mha_bias
    monkeypatch.setattr(JFMB, "fused_mha_bias",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_loss_and_every_grad_match_jax(case):
    cfg = CASES[case]
    jm, tm = _pair(cfg)
    img, lab = _data(cfg)
    port = _port_loss_grads(tm, img, lab)
    _assert_close(port, _jax_loss_grads(jm, img, lab), case)
    # the fused route ran: every block's table got its gradient through
    # d(bias), and no block took the reference route
    for i, blocks in enumerate(tm.stages):
        for j, blk in enumerate(blocks):
            assert blk.attn._bias_static_cache is not None, (i, j)
            assert np.abs(port[2][f"stages.{i}.{j}.attn.rel_bias_table"]
                          ).max() > 0


def test_port_matches_the_jax_fused_route_in_interpret_mode(
        forced_jax_fused):
    cfg = CASES["bench_cpu"]
    jm, tm = _pair(cfg, seed=3)
    img, lab = _data(cfg, seed=4)
    _assert_close(_port_loss_grads(tm, img, lab),
                  _jax_loss_grads(jm, img, lab), "jax fused route")
    assert all(blk.attn._bias_static_cache is not None
               for blocks in jm.stages for blk in blocks)


# AdamW's epsilon is 1e-6 in the TrainStep test: the k projection's bias
# has a zero gradient in exact arithmetic (the softmax ignores a shift
# shared by a row's scores), so both frameworks' f32 gradients there are
# roundoff, which the default 1e-8 would scale up to a whole step of
# different sign on each side
EPS = 1e-6


def _jax_step(jm):
    opt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                 parameters=jm.parameters(),
                                 weight_decay=0.01, epsilon=EPS)
    ce = paddle.nn.CrossEntropyLoss()
    return paddle.jit.TrainStep(jm, opt, lambda x, y: ce(jm(x), y))


def _port_step(tm):
    opt = pt.AdamW(1e-3, parameters=tm.named_parameters(),
                   weight_decay=0.01, epsilon=EPS, device="cpu")
    return pt.TrainStep(
        tm, opt,
        lambda x, y: torch.nn.functional.cross_entropy(tm(x).float(), y),
        device="cpu")


def test_train_step_state_carries_across_and_steps_like_jax():
    """One JAX AdamW step, its TrainStep state carried into a fresh port
    model by `train_state_from_paddle`, then one more step on each side:
    the same loss and the same parameters (1e-5 absolute: at lr 1e-3 that
    is 1% of one step)."""
    cfg = CASES["bench_cpu"]
    jm = _jax_model(cfg, seed=5)
    js = _jax_step(jm)
    batches = [_data(cfg, b=4, seed=10 + i) for i in range(2)]
    js(paddle.to_tensor(batches[0][0]), paddle.to_tensor(batches[0][1]))
    saved = js.state_dict()
    tm = pt.SwinTransformer(**cfg, device="cpu", seed=9)
    ts = _port_step(tm)
    ts.set_state_dict(pt.train_state_from_paddle(saved, tm))
    assert ts._step_i == 1
    img, lab = batches[1]
    jl = float(js(paddle.to_tensor(img), paddle.to_tensor(lab)))
    tl = float(ts(torch.from_numpy(img), torch.from_numpy(lab)))
    assert tl == pytest.approx(jl, rel=1e-5)
    tparams = dict(tm.named_parameters())
    for n, p in jm.named_parameters():
        want = p.numpy()
        if _is_linear_weight(n, want.ndim):
            want = want.T
        np.testing.assert_allclose(tparams[n].detach().numpy(), want,
                                   atol=1e-5, rtol=0, err_msg=n)


def test_static_tables_equal_jax():
    for ws in (2, 4, 7):
        np.testing.assert_array_equal(TS._rel_pos_index(ws),
                                      JS._rel_pos_index(ws))
    for hw, ws, shift in ((8, 4, 2), (56, 7, 3), (28, 7, 3), (14, 7, 3)):
        np.testing.assert_array_equal(TS._shift_mask(hw, hw, ws, shift),
                                      JS._shift_mask(hw, hw, ws, shift))


def test_bias_plan_groups_windows_like_jax(monkeypatch):
    """At swin-t's 224^2 with B = 32, every block groups its windows as the
    JAX plan does (the JAX gate forced past its platform test): W_g 8, 8,
    4, 4 and S 392, 392, 196, 196 with periods R 8, 2, 1, 1, and the same
    static block-diagonal bias; the parameter names and shapes match."""
    monkeypatch.setenv("PADDLE_TPU_FUSED_MHA_BIAS", "1")
    with JI.fast_init():
        jm = JS.swin_t(num_classes=1000)
    tm = pt.swin_t(num_classes=1000, device="cpu")
    np_state = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    assert set(pt.model_state_from_paddle(np_state, tm)) == \
        set(tm.state_dict())
    assert sum(p.numel() for p in tm.parameters()) == 28288354
    want = [(8, 392, 8), (8, 392, 2), (4, 196, 1), (4, 196, 1)]
    for i, (jblocks, tblocks) in enumerate(zip(jm.stages, tm.stages)):
        for jb, tb in zip(jblocks, tblocks):
            nw = (tb.H // tb.ws) * (tb.W // tb.ws)
            jwg, jstatic = jb.attn._bias_plan(32 * nw, nw, jb._mask)
            twg, tstatic = tb.attn._bias_plan(32 * nw, nw, tb._mask,
                                              torch.device("cpu"))
            assert (twg, tstatic.shape[-1], tstatic.shape[0]) == want[i]
            assert twg == jwg
            np.testing.assert_array_equal(tstatic.numpy(), jstatic)


def test_an_odd_map_before_a_merge_is_refused_at_construction():
    """Image 112 with patch 4 gives a 7x7 third-stage map that cannot be
    merged 2x2. The JAX model passes its window check and fails in the
    first forward (a reshape TypeError); the port refuses it when built."""
    cfg = dict(CASES["swin_t_d2"], image_size=112)
    with pytest.raises(ValueError, match="cannot be merged"):
        pt.SwinTransformer(**cfg, device="cpu")
    with pytest.raises(ValueError, match="not divisible by window_size"):
        pt.SwinTransformer(**dict(cfg, image_size=96), device="cpu")


def test_reference_route_matches_the_fused_route(monkeypatch):
    """PADDLE_TPU_FUSED_MHA_BIAS=0 sends every block to the per-window
    reference route: the same logits and table gradients in f32."""
    cfg = CASES["bench_cpu"]
    _, tm = _pair(cfg)
    img, lab = _data(cfg, seed=6)
    fused = _port_loss_grads(tm, img, lab)
    monkeypatch.setenv("PADDLE_TPU_FUSED_MHA_BIAS", "0")
    plain = _port_loss_grads(tm, img, lab)
    assert plain[0] == pytest.approx(fused[0], rel=1e-6)
    np.testing.assert_allclose(plain[1], fused[1], atol=ATOL, rtol=0)
    for n in fused[2]:
        np.testing.assert_allclose(plain[2][n], fused[2][n], atol=ATOL,
                                   rtol=0, err_msg=n)


def test_attention_dropout_takes_the_reference_route(monkeypatch):
    """As in the JAX package, attention dropout > 0 in train() mode sends a
    block to the reference route; eval() takes the fused route."""
    attn = TS.WindowAttention(16, 2, 4, attn_drop=0.5)
    with torch.no_grad():
        attn.rel_bias_table.normal_()
    xw = torch.randn(8, 16, 16)
    calls = []
    orig = FMB.fused_mha_bias
    monkeypatch.setattr(FMB, "fused_mha_bias",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    attn.eval()
    attn(xw, None, n_windows=8)
    assert calls == [1]
    attn.train()
    g = torch.Generator().manual_seed(0)
    a = attn(xw, None, n_windows=8, generator=g)
    b = attn(xw, None, n_windows=8, generator=g)
    assert calls == [1] and not torch.equal(a, b)


def test_init_follows_the_jax_distributions_and_dropout_stream():
    tm = pt.SwinTransformer(**dict(CASES["bench_cpu"], dropout=0.2),
                            device="cpu", seed=2)
    for n, p in tm.named_parameters():
        p = p.detach()
        if n.endswith("rel_bias_table"):
            assert p.abs().max() <= 0.04 and 0.01 < p.std() < 0.03, n
        elif n.startswith("patch_embed."):
            assert p.abs().max() <= 1 / np.sqrt(12) and p.std() > 0, n
        elif p.dim() == 1:
            gain = n.endswith(".weight") and "norm" in n
            assert torch.all(p == (1.0 if gain else 0.0)), n
        else:
            bound = np.sqrt(6.0 / sum(p.shape))
            assert p.abs().max() <= bound and p.std() > bound / 3, n
    img = torch.from_numpy(_data(CASES["bench_cpu"])[0])
    with torch.no_grad():
        ev = tm(img)
        tm.train()
        tm.dropout_generator.manual_seed(3)
        a = tm(img)
        tm.dropout_generator.manual_seed(3)
        b = tm(img)
        c = tm(img)
        tm.eval()
        assert torch.equal(tm(img), ev)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a, ev)
