"""PyTorch port vs JAX package: the incubate fused layers and functional
ops (paddle_tpu_torch.incubate.nn): FusedLinear,
FusedBiasDropoutResidualLayerNorm, FusedMultiHeadAttention,
FusedFeedForward, FusedTransformerEncoderLayer, FusedMultiTransformer and
FusedEcMoe.

Each JAX layer's state dict carries over through
`model_state_from_paddle` (raw parameters keep their JAX shapes; a
FusedLinear weight is not transposed). Both sides see the same numpy
inputs in eval() mode or at dropout 0, in f32. On the CPU the JAX
attention takes its reference route and the port's fused route takes the
fused MHA's plain twin (the same function). Tolerances: 2e-5 absolute on
outputs, 1e-4 of each gradient's largest entry on gradients (summation
order only); int8 static caches to 1e-4 (the codes round from
projections that differ in the last bit). Dropout agrees with the JAX
package by its statistics only: the masks come from torch generators.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.incubate.nn as jnn
import paddle_tpu.incubate.nn.functional as JF
from paddle_tpu.nn.layer import Layer as JLayer
import paddle_tpu_torch as pt
import paddle_tpu_torch.incubate.nn as tnn
import paddle_tpu_torch.incubate.nn.functional as TF
from paddle_tpu_torch.optimizer.optimizer import _jax_order

H, NH, FF = 128, 2, 256          # head dim 64: the fused MHA route holds
B, S = 2, 16
ATOL = 2e-5


def _np(seed, shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _carry(jm, tm):
    jm.eval()
    tm.eval()
    state = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    tm.load_state_dict(pt.model_state_from_paddle(state, tm))
    return jm, tm


def _jax_call(jm, x, **kw):
    xt = paddle.to_tensor(x, stop_gradient=False)
    out = jm(xt, **kw)
    return xt, out


def _grads_match(jm, tm, jx, tx, jy, ty):
    """Backward of sum(y * w) on both sides; the input's and every
    parameter's gradient to 1e-4 of its largest entry."""
    w = np.linspace(-1, 1, int(np.prod(jy.shape)), dtype=np.float32)
    w = w.reshape(jy.shape)
    paddle.sum(jy * paddle.to_tensor(w)).backward()
    (ty * torch.from_numpy(w)).sum().backward()
    pairs = [("x", jx.grad.numpy(), tx.grad.numpy())]
    tp = dict(tm.named_parameters())
    for n, p in jm.named_parameters():
        # a parameter the route does not use (the other LN's scale and
        # bias): JAX gives it a zero gradient, the port none
        if tp[n].grad is None:
            assert p.grad is None or not p.grad.numpy().any(), n
            continue
        pairs.append((n, p.grad.numpy(), tp[n].grad.numpy()))
    for n, jg, tg in pairs:
        scale = max(float(np.abs(jg).max()), 1e-6)
        np.testing.assert_allclose(tg, jg, atol=1e-4 * scale, rtol=0,
                                   err_msg=n)


# ------------------------------------------------------------ functional
@pytest.mark.parametrize("tx, ty", [(False, False), (True, False),
                                    (False, True), (True, True)])
def test_fused_matmul_bias_matches_jax(tx, ty):
    a = _np(1, (3, 8, 5) if tx else (3, 5, 8))
    b = _np(2, (6, 8) if ty else (8, 6))
    bias = _np(3, (6,))
    for bb in (bias, None):
        j = JF.fused_matmul_bias(paddle.to_tensor(a), paddle.to_tensor(b),
                                 None if bb is None else paddle.to_tensor(bb),
                                 transpose_x=tx, transpose_y=ty)
        t = TF.fused_matmul_bias(torch.from_numpy(a), torch.from_numpy(b),
                                 None if bb is None else torch.from_numpy(bb),
                                 transpose_x=tx, transpose_y=ty)
        np.testing.assert_allclose(t.numpy(), j.numpy(), atol=ATOL, rtol=0)


@pytest.mark.parametrize("parts", ["all", "no_bias", "no_ln"])
def test_fused_bias_dropout_residual_layer_norm_matches_jax(parts):
    """At dropout 0 (training=False): LayerNorm(residual + x + bias) with
    the two-pass variance."""
    x, res = _np(4, (B, S, H), 3), _np(5, (B, S, H))
    bias = None if parts == "no_bias" else _np(6, (H,))
    g = None if parts == "no_ln" else _np(7, (H,))
    lb = None if parts == "no_ln" else _np(8, (H,))

    def jt(a):
        return None if a is None else paddle.to_tensor(a)

    def tt(a):
        return None if a is None else torch.from_numpy(a)
    j = JF.fused_bias_dropout_residual_layer_norm(
        jt(x), jt(res), jt(bias), jt(g), jt(lb), dropout_rate=0.5,
        training=False)
    t = TF.fused_bias_dropout_residual_layer_norm(
        tt(x), tt(res), tt(bias), tt(g), tt(lb), dropout_rate=0.5,
        training=False)
    np.testing.assert_allclose(t.numpy(), j.numpy(), atol=ATOL, rtol=0)


def test_bias_dropout_residual_layer_norm_layer_matches_jax():
    jm = jnn.FusedBiasDropoutResidualLayerNorm(H, dropout_rate=0.3)
    tm = tnn.FusedBiasDropoutResidualLayerNorm(H, dropout_rate=0.3,
                                               device="cpu")
    jm.ln_scale.set_value(_np(9, (H,)))
    jm.ln_bias.set_value(_np(10, (H,)))
    _carry(jm, tm)
    x, res, bias = _np(11, (B, S, H)), _np(12, (B, S, H)), _np(13, (H,))
    j = jm(paddle.to_tensor(x), paddle.to_tensor(res), paddle.to_tensor(bias))
    t = tm(torch.from_numpy(x), torch.from_numpy(res), torch.from_numpy(bias))
    np.testing.assert_allclose(t.detach().numpy(), j.numpy(), atol=ATOL,
                               rtol=0)


# --------------------------------------------------------------- FusedLinear
class _JHolder(JLayer):
    def __init__(self, transpose):
        super().__init__()
        self.proj = jnn.FusedLinear(H, 96, transpose_weight=transpose)


class _THolder(torch.nn.Module):
    def __init__(self, transpose):
        super().__init__()
        self.proj = tnn.FusedLinear(H, 96, transpose_weight=transpose,
                                    device="cpu")


@pytest.mark.parametrize("transpose", [False, True])
def test_fused_linear_keeps_the_jax_layout_through_the_converter(transpose):
    """``proj.weight`` would be transposed by the converter's ``.weight``
    rule; FusedLinear keeps the JAX layout ([in, out], or [out, in] under
    transpose_weight), so it carries over as it is, in the model state, the
    TrainStep state and the int8 moments' blocking."""
    paddle.seed(0)
    jm, tm = _carry(_JHolder(transpose), _THolder(transpose))
    want = (96, H) if transpose else (H, 96)
    assert tuple(tm.proj.weight.shape) == want
    np.testing.assert_array_equal(tm.proj.weight.detach().numpy(),
                                  jm.proj.weight.numpy())
    x = _np(14, (B, S, H))
    j = jm.proj(paddle.to_tensor(x))
    t = tm.proj(torch.from_numpy(x))
    np.testing.assert_allclose(t.detach().numpy(), j.numpy(), atol=ATOL,
                               rtol=0)
    moments = {"moment1": np.asarray(jm.proj.weight.numpy()) * 0 + 1}
    state = {"step": 1, "params": {k: np.asarray(v) for k, v in
                                   jm.state_dict().items()},
             "opt": {"proj.weight": moments}}
    mapped = pt.train_state_from_paddle(state, tm)
    assert tuple(mapped["params"]["proj.weight"].shape) == want
    assert tuple(mapped["opt"]["proj.weight"]["moment1"].shape) == want
    assert not _jax_order("proj.weight", tm.proj.weight)


# ----------------------------------------------------- FusedMultiHeadAttention
def _mha_pair(pre, seed=0):
    paddle.seed(seed)
    jm = jnn.FusedMultiHeadAttention(H, NH, dropout_rate=0.1,
                                     attn_dropout_rate=0.1,
                                     normalize_before=pre)
    for p in (jm.qkv_bias, jm.linear_bias, jm.pre_ln_scale, jm.pre_ln_bias,
              jm.ln_scale, jm.ln_bias):
        p.set_value(_np(seed + 20 + p.size, tuple(p.shape), 0.5))
    tm = tnn.FusedMultiHeadAttention(H, NH, dropout_rate=0.1,
                                     attn_dropout_rate=0.1,
                                     normalize_before=pre, device="cpu")
    return _carry(jm, tm)


def _keep_mask(seed):
    m = np.random.RandomState(seed).rand(B, 1, S, S) > 0.3
    m |= np.eye(S, dtype=bool)[None, None]
    return m


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("pre", [False, True])
def test_multi_head_attention_matches_jax(pre, masked):
    """Pre-LN and post-LN, the fused route (no mask) and the reference
    route (a bool keep-mask): the output and every gradient."""
    jm, tm = _mha_pair(pre)
    x = _np(30, (B, S, H))
    mask = _keep_mask(31) if masked else None
    jx, jy = _jax_call(jm, x, attn_mask=None if mask is None
                       else paddle.to_tensor(mask))
    tx = torch.from_numpy(x).requires_grad_()
    ty = tm(tx, attn_mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(ty.detach().numpy(), jy.numpy(), atol=ATOL,
                               rtol=0)
    _grads_match(jm, tm, jx, tx, jy, ty)


def test_multi_head_attention_takes_the_fused_route(monkeypatch):
    """Without a mask or a cache the layer calls the fused MHA on the
    packed projection (kernel #9 on CUDA) exactly once."""
    import paddle_tpu_torch.incubate.nn.fused_transformer as FT
    calls = []
    real = FT.fused_mha

    def spy(qkv, nh, **kw):
        calls.append((tuple(qkv.shape), nh))
        return real(qkv, nh, **kw)
    monkeypatch.setattr(FT, "fused_mha", spy)
    _, tm = _mha_pair(False)
    tm(torch.from_numpy(_np(32, (B, S, H))))
    assert calls == [((B, S, 3 * H), NH)]
    tm(torch.from_numpy(_np(32, (B, S, H))),
       attn_mask=torch.from_numpy(_keep_mask(33)))
    assert len(calls) == 1


@pytest.mark.parametrize("pre", [False, True])
def test_growing_cache_matches_jax(pre):
    """A prompt into an empty (k, v) cache, then one token attending the
    grown cache: outputs and caches."""
    jm, tm = _mha_pair(pre)
    x, tok = _np(34, (B, S, H)), _np(35, (B, 1, H))
    empty = np.zeros((B, 0, NH, H // NH), np.float32)
    jc = (paddle.to_tensor(empty), paddle.to_tensor(empty))
    tc = (torch.from_numpy(empty), torch.from_numpy(empty))
    for inp in (x, tok):
        jo, jc = jm(paddle.to_tensor(inp), cache=jc)
        with torch.no_grad():
            to, tc = tm(torch.from_numpy(inp), cache=tc)
        np.testing.assert_allclose(to.numpy(), jo.numpy(), atol=ATOL, rtol=0)
        for a, b in zip(tc, jc):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL,
                                       rtol=0)
    assert tc[0].shape == (B, S + 1, NH, H // NH)


def _static_caches(q8, L):
    shape = (B, L, NH, H // NH)
    if q8:
        return [np.zeros(shape, np.int8), np.zeros(shape[:3], np.float32),
                np.zeros(shape, np.int8), np.zeros(shape[:3], np.float32)]
    return [np.zeros(shape, np.float32), np.zeros(shape, np.float32)]


@pytest.mark.parametrize("q8", [False, True])
def test_static_caches_match_jax(q8):
    """The 3-tuple (k, v, pos) and the int8 5-tuple: a prompt, then two
    single tokens, each written at the cursor in place; outputs and the
    advanced cursor."""
    jm, tm = _mha_pair(True)
    L = S + 4
    bufs = _static_caches(q8, L)
    jc = tuple(paddle.to_tensor(b) for b in bufs) + (0,)
    tc = tuple(torch.from_numpy(b.copy()) for b in bufs) + (0,)
    tol = 1e-4 if q8 else ATOL
    for i, inp in enumerate((_np(36, (B, S, H)), _np(37, (B, 1, H)),
                             _np(38, (B, 1, H)))):
        jo, jc = jm(paddle.to_tensor(inp), cache=jc)
        with torch.no_grad():
            to, tc = tm(torch.from_numpy(inp), cache=tc)
        np.testing.assert_allclose(to.numpy(), jo.numpy(), atol=tol,
                                   rtol=0, err_msg=str(i))
        assert int(tc[-1]) == int(np.asarray(jc[-1]))
        assert len(tc) == len(bufs) + 1
    assert int(tc[-1]) == S + 2
    if q8:
        same = (tc[0].numpy() == np.asarray(jc[0].numpy())).mean()
        assert same > 0.999


def test_static_and_cross_attention_refusals():
    _, tm = _mha_pair(True)
    x = torch.from_numpy(_np(39, (B, 1, H)))
    bufs = tuple(torch.from_numpy(b) for b in _static_caches(False, 8))
    with pytest.raises(NotImplementedError, match="cross-attention"):
        tm(x, key=x.clone())
    with pytest.raises(NotImplementedError, match="custom masks"):
        tm(x, attn_mask=torch.ones(B, 1, 1, 8, dtype=torch.bool),
           cache=bufs + (0,))
    tm.train()
    with pytest.raises(NotImplementedError, match="inference-only"):
        tm(x, cache=bufs + (0,))
    tm.eval()
    bad = (bufs[0], bufs[0][..., 0], bufs[1], bufs[1][..., 0], 0)
    with pytest.raises(ValueError, match="int8 codes"):
        tm(x, cache=bad)


# ----------------------------------------------------------- FusedFeedForward
@pytest.mark.parametrize("act", ["relu", "gelu"])
@pytest.mark.parametrize("pre", [False, True])
def test_feed_forward_matches_jax(pre, act):
    """Pre-LN and post-LN, relu and the tanh gelu (jax.nn.gelu's
    default): the output and every gradient."""
    paddle.seed(1)
    jm = jnn.FusedFeedForward(H, FF, dropout_rate=0.2, activation=act,
                              normalize_before=pre)
    for p in (jm.linear1_bias, jm.linear2_bias, jm.ln1_scale, jm.ln1_bias,
              jm.ln2_scale, jm.ln2_bias):
        p.set_value(_np(40 + p.size, tuple(p.shape), 0.5))
    tm = tnn.FusedFeedForward(H, FF, dropout_rate=0.2, activation=act,
                              normalize_before=pre, device="cpu")
    _carry(jm, tm)
    x = _np(41, (B, S, H), 2.0)
    jx, jy = _jax_call(jm, x)
    tx = torch.from_numpy(x).requires_grad_()
    ty = tm(tx)
    np.testing.assert_allclose(ty.detach().numpy(), jy.numpy(), atol=ATOL,
                               rtol=0)
    _grads_match(jm, tm, jx, tx, jy, ty)


# ------------------------------------------- encoder layer and the stack
@pytest.mark.parametrize("act, pre", [("relu", False), ("gelu", True)])
def test_encoder_layer_matches_jax(act, pre):
    paddle.seed(2)
    jm = jnn.FusedTransformerEncoderLayer(H, NH, FF, dropout_rate=0.1,
                                          activation=act,
                                          normalize_before=pre)
    tm = tnn.FusedTransformerEncoderLayer(H, NH, FF, dropout_rate=0.1,
                                          activation=act,
                                          normalize_before=pre,
                                          device="cpu")
    _carry(jm, tm)
    x = _np(42, (B, S, H))
    for mask in (None, _keep_mask(43)):
        kw = {} if mask is None else {"src_mask": mask}
        jx, jy = _jax_call(jm, x, **{k: paddle.to_tensor(v)
                                     for k, v in kw.items()})
        tx = torch.from_numpy(x).requires_grad_()
        ty = tm(tx, **{k: torch.from_numpy(v) for k, v in kw.items()})
        np.testing.assert_allclose(ty.detach().numpy(), jy.numpy(),
                                   atol=ATOL, rtol=0)
        jm.clear_gradients()
        tm.zero_grad(set_to_none=True)
        _grads_match(jm, tm, jx, tx, jy, ty)


@pytest.fixture(scope="module")
def stack_pair():
    paddle.seed(3)
    jm = jnn.FusedMultiTransformer(H, NH, FF, num_layers=2)
    tm = tnn.FusedMultiTransformer(H, NH, FF, num_layers=2, device="cpu")
    assert [n for n, _ in tm.named_parameters()] == \
        [n for n, _ in jm.named_parameters()]
    return _carry(jm, tm)


def test_multi_transformer_matches_jax(stack_pair):
    jm, tm = stack_pair
    x = _np(44, (B, S, H))
    jx, jy = _jax_call(jm, x)
    tx = torch.from_numpy(x).requires_grad_()
    ty = tm(tx)
    np.testing.assert_allclose(ty.detach().numpy(), jy.numpy(), atol=ATOL,
                               rtol=0)
    _grads_match(jm, tm, jx, tx, jy, ty)


@pytest.mark.parametrize("q8", [False, True])
def test_multi_transformer_static_decode_matches_growing_and_jax(stack_pair,
                                                                  q8):
    """Per-layer static caches (fp or int8): a prompt and three decode
    tokens against the JAX stack on the same caches; and eight tokens fed
    one at a time against the growing (k, v) caches (a growing cache's
    prompt attends both ways, a static cache's causally, so they agree
    token by token)."""
    jm, tm = stack_pair
    tol = 1e-4 if q8 else ATOL

    def static(L, jax=False):
        mk = paddle.to_tensor if jax else torch.from_numpy
        return [tuple(mk(b) for b in _static_caches(q8, L)) + (0,)
                for _ in range(2)]
    stat, jstat = static(S + 3), static(S + 3, jax=True)
    steps = [_np(45, (B, S, H))] + [_np(46 + i, (B, 1, H)) for i in range(3)]
    with torch.no_grad():
        for inp in steps:
            s, stat = tm(torch.from_numpy(inp), caches=stat)
            j, jstat = jm(paddle.to_tensor(inp), caches=jstat)
            np.testing.assert_allclose(s.numpy(), j.numpy(), atol=tol,
                                       rtol=0)
    assert all(int(c[-1]) == S + 3 for c in stat)
    empty = torch.zeros(B, 0, NH, H // NH)
    grow, stat = [(empty, empty)] * 2, static(8)
    with torch.no_grad():
        for i in range(8):
            inp = torch.from_numpy(_np(60 + i, (B, 1, H)))
            g, grow = tm(inp, caches=grow)
            s, stat = tm(inp, caches=stat)
            # int8 K/V: the codes round to 1/254 of each row's max (2.8e-3
            # here)
            np.testing.assert_allclose(s.numpy(), g.numpy(),
                                       atol=1e-2 if q8 else ATOL, rtol=0)


# ------------------------------------------------------------- FusedEcMoe
@pytest.mark.parametrize("act", ["gelu", "relu"])
def test_ec_moe_with_gate_logits_matches_jax(act):
    """A gshard MoELayer routed by external gate logits: the output, the
    aux loss and the gradients of the input, the logits and the
    experts."""
    paddle.seed(4)
    jm = jnn.FusedEcMoe(H, FF, 4, act_type=act)
    tm = tnn.FusedEcMoe(H, FF, 4, act_type=act, device="cpu")
    _carry(jm, tm)
    x, gl = _np(50, (B, S, H)), _np(51, (B, S, 4))
    jx = paddle.to_tensor(x, stop_gradient=False)
    jg = paddle.to_tensor(gl, stop_gradient=False)
    jy = jm(jx, gate_logits=jg)
    tx = torch.from_numpy(x).requires_grad_()
    tg = torch.from_numpy(gl).requires_grad_()
    ty = tm(tx, gate_logits=tg)
    np.testing.assert_allclose(ty.detach().numpy(), jy.numpy(), atol=ATOL,
                               rtol=0)
    assert float(tm.moe.aux_loss.detach()) == pytest.approx(
        float(jm.moe.aux_loss), abs=1e-6)
    w = _np(52, (B, S, H))
    (paddle.sum(jy * paddle.to_tensor(w)) + jm.moe.aux_loss).backward()
    ((ty * torch.from_numpy(w)).sum() + tm.moe.aux_loss).backward()
    tp = dict(tm.named_parameters())
    pairs = [("x", jx.grad.numpy(), tx.grad.numpy()),
             ("gate_logits", jg.grad.numpy(), tg.grad.numpy())] + [
        (n, p.grad.numpy(), tp[n].grad.numpy())
        for n, p in jm.named_parameters() if n != "moe.gate_weight"]
    for n, a, b in pairs:
        np.testing.assert_allclose(b, a, atol=1e-4 * float(np.abs(a).max()),
                                   rtol=0, err_msg=n)


# ---------------------------------------------------------------- dropout
def test_dropout_by_its_statistics():
    """The port's masks come from torch generators, so dropout agrees with
    the JAX package by its statistics: the kept share is 1 - p and kept
    entries scale by 1 / (1 - p); the fused layers' train()-mode dropout
    is unbiased (the mean over 300 draws of the attention block's pre-LN
    output approaches its eval() output) and repeats under a reseeded
    generator."""
    g = torch.Generator().manual_seed(0)
    y = TF._drop(torch.ones(200_000), 0.3, g)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.7) < 0.005
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.7))
    # the fused bias-dropout-residual-LN: a constant x on a zero residual
    # LayerNorms to + where kept and - where dropped
    ln = tnn.FusedBiasDropoutResidualLayerNorm(H, dropout_rate=0.5,
                                               device="cpu")
    out = ln(torch.full((64, S, H), 3.0), torch.zeros(64, S, H))
    assert abs(float((out > 0).float().mean()) - 0.5) < 0.01
    _, tm = _mha_pair(True)
    tm.attn_dropout_rate, tm.dropout_rate = 0.3, 0.2
    x = torch.from_numpy(_np(53, (B, S, H)))
    with torch.no_grad():
        ref = tm.eval()(x)
        tm.train()
        draws = torch.stack([tm(x) for _ in range(300)])
        tm.dropout_generator.manual_seed(9)
        a = tm(x)
        tm.dropout_generator.manual_seed(9)
        b = tm(x)
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    one = float((draws[0] - ref).abs().mean())
    avg = float((draws.mean(0) - ref).abs().mean())
    assert avg < 0.15 * one


def test_layers_start_in_train_mode_and_name_their_sublayers():
    layer = tnn.FusedMultiTransformer(H, NH, FF, num_layers=3, device="cpu")
    assert layer.training
    assert [n for n, _ in layer.named_children()] == \
        ["layer_0", "layer_1", "layer_2"]
    assert len(layer.layers) == 3
