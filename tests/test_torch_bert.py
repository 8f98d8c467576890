"""PyTorch port vs JAX package: BERT (MLM, sequence classification,
pretraining heads), its attention routes and its AdamW TrainStep.

A small f32 BertForMaskedLM (2 layers, H=128, 2 heads of 64, a 1030-word
vocabulary: not a multiple of 128, like bert-base's 30522, and large
enough for the fused linear cross-entropy route) is built in the JAX
package; its state dict goes through `model_state_from_paddle` into the
port. Both sides see the same numpy token ids, in eval() mode. On the CPU
the JAX model takes its reference attention (the fused kernel's gate
holds only on a TPU) and the port takes the fused MHA's plain twin: the
same function. Tolerances: 1e-5 relative on losses, 2e-5 absolute on
logits and gradients (f32, summation order only), 1e-5 absolute on
parameters after AdamW steps at lr 1e-3 (1% of one step).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import BertConfig as JBertConfig
from paddle_tpu.models import BertForMaskedLM as JBertMLM
from paddle_tpu.models import BertForPretraining as JBertPre
from paddle_tpu.models import BertForSequenceClassification as JBertCls
import paddle_tpu_torch as pt
from paddle_tpu_torch.convert import _is_linear_weight

CFG = dict(vocab_size=1030, hidden_size=128, num_layers=2, num_heads=2,
           intermediate_size=256, max_position_embeddings=128)
B, S = 2, 64
ATOL = 2e-5


def _build(jcls, tcls, cfg=CFG, seed=0):
    paddle.seed(seed)
    jm = jcls(JBertConfig(**cfg))
    jm.eval()
    np_state = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    tm = tcls(pt.BertConfig(**cfg), device="cpu")
    tm.load_state_dict(pt.model_state_from_paddle(np_state, tm))
    return jm, tm


@pytest.fixture(scope="module")
def mlm_pair():
    return _build(JBertMLM, pt.BertForMaskedLM)


def _ids(seed, v=CFG["vocab_size"], shape=(B, S)):
    return np.random.RandomState(seed).randint(0, v, shape).astype(np.int64)


def _labels(seed):
    lab = _ids(seed)
    lab[np.random.RandomState(seed + 1).rand(B, S) < 0.3] = -100
    return lab


def _port_layout(name, arr):
    return arr.T if _is_linear_weight(name, arr.ndim) else arr


def _grads(jm, tm):
    """Every parameter's gradient; one the loss does not reach (the MLM
    loss skips the pooler) has none on either side."""
    jg = {n: p.grad for n, p in jm.named_parameters()}
    tg = dict(tm.named_parameters())
    assert set(jg) == set(tg)
    for n, g in jg.items():
        if g is None:
            assert tg[n].grad is None, n
            continue
        np.testing.assert_allclose(tg[n].grad.numpy(),
                                   _port_layout(n, g.numpy()), atol=ATOL,
                                   rtol=0, err_msg=n)


def _jt(a):
    return None if a is None else paddle.to_tensor(a)


def _tt(a):
    return None if a is None else torch.from_numpy(a)


def test_logits_match_jax(mlm_pair):
    jm, tm = mlm_pair
    ids = _ids(1)
    jl = jm(paddle.to_tensor(ids)).numpy()
    with torch.no_grad():
        tl = tm(torch.from_numpy(ids)).numpy()
    assert tl.shape == (B, S, CFG["vocab_size"])
    np.testing.assert_allclose(tl, jl, atol=ATOL, rtol=0)


@pytest.mark.parametrize("masked", [False, True])
def test_mlm_loss_and_every_grad_match_jax(mlm_pair, masked):
    """The fused MLM loss with ignore_index -100 (and a loss_mask)."""
    jm, tm = mlm_pair
    ids, lab = _ids(2), _labels(3)
    mask = ((np.random.RandomState(4).rand(B, S) > 0.2).astype(np.float32)
            if masked else None)
    jm.clear_gradients()
    jl = jm.loss(paddle.to_tensor(ids), paddle.to_tensor(lab),
                 loss_mask=_jt(mask), chunk_size=32)
    jl.backward()
    tm.zero_grad(set_to_none=True)
    tl = tm.loss(torch.from_numpy(ids), torch.from_numpy(lab),
                 loss_mask=_tt(mask), chunk_size=32)
    tl.backward()
    assert float(tl.detach()) == pytest.approx(float(jl), rel=1e-5)
    _grads(jm, tm)


def test_seq_lens_route_matches_jax_mask_route(mlm_pair):
    """seq_lens: the port's fused per-row key mask; JAX on the CPU turns
    the lengths into a keep-mask. Live rows' logits, and the loss with the
    padded positions labelled -100, with every gradient."""
    jm, tm = mlm_pair
    lens = np.array([S, 37])
    ids, lab = _ids(5), _labels(6)
    lab[1, 37:] = -100
    jlog = jm(paddle.to_tensor(ids), seq_lens=paddle.to_tensor(lens)).numpy()
    with torch.no_grad():
        tlog = tm(torch.from_numpy(ids), seq_lens=torch.from_numpy(lens))
    for i, n in enumerate(lens):
        np.testing.assert_allclose(tlog[i, :n].numpy(), jlog[i, :n],
                                   atol=ATOL, rtol=0)
    jm.clear_gradients()
    jl = jm.loss(paddle.to_tensor(ids), paddle.to_tensor(lab),
                 seq_lens=paddle.to_tensor(lens), chunk_size=32)
    jl.backward()
    tm.zero_grad(set_to_none=True)
    tl = tm.loss(torch.from_numpy(ids), torch.from_numpy(lab),
                 seq_lens=torch.from_numpy(lens), chunk_size=32)
    tl.backward()
    assert float(tl.detach()) == pytest.approx(float(jl), rel=1e-5)
    _grads(jm, tm)


@pytest.mark.parametrize("kind", ["keep01", "additive", "and_seq_lens"])
def test_attention_mask_routes_match_jax(mlm_pair, kind):
    jm, tm = mlm_pair
    keep = np.ones((B, S), np.int64)
    keep[0, 50:] = 0
    keep[1, 20:] = 0
    mask = ((1 - keep) * -1e4).astype(np.float32) if kind == "additive" \
        else keep
    # with both given, the lengths' keep-mask replaces the mask (JAX)
    lens = np.array([40, 60]) if kind == "and_seq_lens" else None
    ids, lab = _ids(7), _labels(8)
    jm.clear_gradients()
    jl = jm.loss(paddle.to_tensor(ids), paddle.to_tensor(lab),
                 attention_mask=paddle.to_tensor(mask), seq_lens=_jt(lens),
                 chunk_size=32)
    jl.backward()
    tm.zero_grad(set_to_none=True)
    tl = tm.loss(torch.from_numpy(ids), torch.from_numpy(lab),
                 attention_mask=torch.from_numpy(mask), seq_lens=_tt(lens),
                 chunk_size=32)
    tl.backward()
    assert float(tl.detach()) == pytest.approx(float(jl), rel=1e-5)
    _grads(jm, tm)


def test_sequence_classification_matches_jax():
    jm, tm = _build(JBertCls, pt.BertForSequenceClassification)
    ids = _ids(9)
    labels = np.array([0, 1])
    jl = paddle.nn.functional.cross_entropy(jm(paddle.to_tensor(ids)),
                                            paddle.to_tensor(labels))
    jl.backward()
    tlog = tm(torch.from_numpy(ids))
    tl = torch.nn.functional.cross_entropy(tlog, torch.from_numpy(labels))
    tl.backward()
    np.testing.assert_allclose(tlog.detach().numpy(),
                               jm(paddle.to_tensor(ids)).numpy(), atol=ATOL)
    assert float(tl.detach()) == pytest.approx(float(jl), rel=1e-5)
    _grads(jm, tm)


def test_pretraining_heads_match_jax():
    jm, tm = _build(JBertPre, pt.BertForPretraining)
    ids = _ids(10)
    jmlm, jnsp = jm(paddle.to_tensor(ids))
    with torch.no_grad():
        tmlm, tnsp = tm(torch.from_numpy(ids))
    np.testing.assert_allclose(tmlm.numpy(), jmlm.numpy(), atol=ATOL)
    np.testing.assert_allclose(tnsp.numpy(), jnsp.numpy(), atol=ATOL)


def _decay(name):
    return not (name.endswith(".bias") or "ln" in name.split(".")[-2]
                or "layer_norm" in name)


def test_train_step_trajectory_and_resume_match_jax():
    """3 AdamW steps (decay with bias and LayerNorm exempt, global-norm
    clip at 1.0) give the same losses and parameters as the JAX
    TrainStep; a port step resumed from the JAX state after step 2 follows
    the JAX run (dropout off: the two frameworks draw different masks)."""
    cfg = dict(CFG, hidden_dropout=0.0, attention_dropout=0.0)
    jm, tm = _build(JBertMLM, pt.BertForMaskedLM, cfg)
    for n, p in jm.named_parameters():
        p.name = n                      # apply_decay_param_fun reads it
    jopt = paddle.optimizer.AdamW(
        learning_rate=1e-3, parameters=jm.parameters(), weight_decay=0.01,
        apply_decay_param_fun=_decay,
        grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
    js = paddle.jit.TrainStep(jm, jopt,
                              lambda a, b: jm.loss(a, b, chunk_size=32))

    def port_step(model):
        opt = pt.AdamW(1e-3, parameters=model.named_parameters(),
                       weight_decay=0.01, apply_decay_param_fun=_decay,
                       grad_clip=pt.ClipGradByGlobalNorm(1.0), device="cpu")
        return pt.TrainStep(model, opt,
                            lambda a, b: model.loss(a, b, chunk_size=32),
                            device="cpu")
    ts = port_step(tm)
    batches = [(_ids(20 + i), _labels(30 + i)) for i in range(3)]
    saved = None
    for i, (a, b) in enumerate(batches):
        jl = float(js(paddle.to_tensor(a), paddle.to_tensor(b)))
        tl = float(ts(torch.from_numpy(a), torch.from_numpy(b)))
        assert tl == pytest.approx(jl, rel=1e-5), f"step {i + 1}"
        if i == 1:
            saved = js.state_dict()
    tparams = dict(tm.named_parameters())
    for n, p in jm.named_parameters():
        np.testing.assert_allclose(tparams[n].detach().numpy(),
                                   _port_layout(n, p.numpy()), atol=1e-5,
                                   rtol=0, err_msg=n)
    # resume a fresh port model from the JAX state after step 2
    tm2 = pt.BertForMaskedLM(pt.BertConfig(**cfg), device="cpu", seed=5)
    ts2 = port_step(tm2)
    ts2.set_state_dict(pt.train_state_from_paddle(saved, tm2))
    assert ts2._step_i == 2
    a, b = batches[2]
    ts2(torch.from_numpy(a), torch.from_numpy(b))
    t2 = dict(tm2.named_parameters())
    for n, p in jm.named_parameters():
        np.testing.assert_allclose(t2[n].detach().numpy(),
                                   _port_layout(n, p.numpy()), atol=1e-5,
                                   rtol=0, err_msg=n)


def test_train_mode_drops_with_the_models_generator():
    """train() runs hidden and attention dropout (the fused route draws
    one seed per call from the model's generator): two forwards differ,
    re-seeding repeats one, eval() is deterministic and dropout-free."""
    tm = pt.BertForMaskedLM(pt.BertConfig(**CFG), device="cpu", seed=1)
    ids = torch.from_numpy(_ids(11))
    lab = torch.from_numpy(_labels(12))
    with torch.no_grad():
        ev = tm.loss(ids, lab)
        tm.train()
        tm.dropout_generator.manual_seed(3)
        l1 = tm.loss(ids, lab)
        l2 = tm.loss(ids, lab)
        tm.dropout_generator.manual_seed(3)
        assert torch.equal(tm.loss(ids, lab), l1)
        assert not torch.equal(l1, l2) and torch.isfinite(l1)
        tm.eval()
        assert torch.equal(tm.loss(ids, lab), ev)


def test_config_presets_and_state_map_checks():
    cfg = pt.bert_config("bert-base")
    assert (cfg.hidden_size, cfg.num_layers, cfg.num_heads,
            cfg.vocab_size) == (768, 12, 12, 30522)
    assert cfg.head_dim == 64 and cfg.intermediate_size == 3072
    tm = pt.BertForMaskedLM(pt.BertConfig(**CFG), device="cpu")
    state = {k: v.numpy() for k, v in tm.state_dict().items()}
    state.pop("ln.bias")
    with pytest.raises(KeyError, match="missing"):
        pt.model_state_from_paddle(state, tm)
