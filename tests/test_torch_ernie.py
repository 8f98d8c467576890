"""PyTorch port vs JAX package: ERNIE (the trunk, the sequence
classification and MLM heads, the fused MLM loss).

A small f32 ERNIE (2 layers, H=128, 2 heads of 64, a 1030-word vocabulary,
enough for the fused linear cross-entropy route) is built in the JAX
package; its state dict goes through `model_state_from_paddle` into the
port. Both sides see the same numpy ids, in eval() mode. On the CPU the
JAX model takes its reference attention and the port the fused MHA's plain
twin (the same function). Tolerances as in test_torch_bert: 1e-5 relative
on losses, 2e-5 absolute on outputs and gradients (f32, summation order
only).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import ErnieConfig as JErnieConfig
from paddle_tpu.models import ErnieForMaskedLM as JErnieMLM
from paddle_tpu.models import ErnieForSequenceClassification as JErnieCls
from paddle_tpu.models import ErnieModel as JErnieModel
from paddle_tpu.models import ernie_config as jernie_config
from paddle_tpu.models.ernie import _PRESETS as JPRESETS
import paddle_tpu_torch as pt
from paddle_tpu_torch.convert import _is_linear_weight
from paddle_tpu_torch.models import ernie as TE

CFG = dict(vocab_size=1030, hidden_size=128, num_layers=2, num_heads=2,
           intermediate_size=256, max_position_embeddings=128)
B, S = 2, 64
ATOL = 2e-5


def _build(jcls, tcls, cfg=CFG, seed=0, **kw):
    paddle.seed(seed)
    jm = jcls(JErnieConfig(**cfg), **kw)
    jm.eval()
    np_state = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    tm = tcls(pt.ErnieConfig(**cfg), device="cpu", **kw)
    tm.load_state_dict(pt.model_state_from_paddle(np_state, tm))
    return jm, tm


def _ids(seed, v=CFG["vocab_size"], shape=(B, S)):
    return np.random.RandomState(seed).randint(0, v, shape).astype(np.int64)


def _task(seed):
    return np.random.RandomState(seed).randint(0, 3, (B, S)).astype(np.int64)


def _jt(a):
    return None if a is None else paddle.to_tensor(a)


def _tt(a):
    return None if a is None else torch.from_numpy(a)


@pytest.fixture(scope="module")
def mlm_pair():
    return _build(JErnieMLM, pt.ErnieForMaskedLM)


def test_presets_match_jax():
    assert set(TE.PRESETS) == set(JPRESETS)
    for name in JPRESETS:
        j, t = jernie_config(name), pt.ernie_config(name)
        assert vars(t) == vars(j), name


@pytest.mark.parametrize("task", [False, True])
@pytest.mark.parametrize("use_task_id", [True, False])
def test_trunk_outputs_match_jax(task, use_task_id):
    """The sequence and pooled outputs, with task ids given or not (None
    means task 0), and without the task table."""
    cfg = dict(CFG, use_task_id=use_task_id)
    jm, tm = _build(JErnieModel, pt.ErnieModel, cfg=cfg)
    assert hasattr(tm, "task_type_embeddings") == use_task_id
    ids, tt = _ids(1), _task(2) if task else None
    tok = np.random.RandomState(3).randint(0, 2, (B, S)).astype(np.int64)
    js, jp = jm(paddle.to_tensor(ids), _jt(tok), task_type_ids=_jt(tt))
    with torch.no_grad():
        ts, tp = tm(torch.from_numpy(ids), _tt(tok), task_type_ids=_tt(tt))
    np.testing.assert_allclose(ts.numpy(), js.numpy(), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tp.numpy(), jp.numpy(), atol=ATOL, rtol=0)


def test_task_embedding_is_added_after_the_layer_norm():
    """The JAX model adds the task-type embedding to the embeddings'
    LayerNorm output (published ERNIE adds it before the LayerNorm); the
    port follows the reference. With no layers the sequence output is
    LayerNorm(word + position + token type) + task, not LayerNorm(... +
    task)."""
    cfg = dict(CFG, num_layers=0)
    jm, tm = _build(JErnieModel, pt.ErnieModel, cfg=cfg)
    ids, tt = _ids(4), _task(5)
    with torch.no_grad():
        seq, _ = tm(torch.from_numpy(ids), task_type_ids=torch.from_numpy(tt))
        emb = tm.embeddings(torch.from_numpy(ids))
        task = tm.task_type_embeddings(torch.from_numpy(tt))
        ln = tm.embeddings.layer_norm
        e = tm.embeddings
        before = ln(e.word_embeddings(torch.from_numpy(ids))
                    + e.position_embeddings.weight[:S]
                    + e.token_type_embeddings.weight[0] + task)
    torch.testing.assert_close(seq, emb + task, atol=0, rtol=0)
    assert float((seq - before).abs().max()) > 0.1
    js, _ = jm(paddle.to_tensor(ids), task_type_ids=paddle.to_tensor(tt))
    np.testing.assert_allclose(seq.numpy(), js.numpy(), atol=ATOL, rtol=0)


def test_mlm_logits_match_jax(mlm_pair):
    jm, tm = mlm_pair
    ids, tt = _ids(6), _task(7)
    jl = jm(paddle.to_tensor(ids), task_type_ids=paddle.to_tensor(tt))
    with torch.no_grad():
        tl = tm(torch.from_numpy(ids), task_type_ids=torch.from_numpy(tt))
    assert tl.shape == (B, S, CFG["vocab_size"])
    np.testing.assert_allclose(tl.numpy(), jl.numpy(), atol=ATOL, rtol=0)


def _port_layout(name, arr):
    return arr.T if _is_linear_weight(name, arr.ndim) else arr


@pytest.mark.parametrize("masked", [False, True])
def test_mlm_loss_and_every_grad_match_jax(mlm_pair, masked):
    """The fused MLM loss (ignore_index -100, and a loss_mask) with task
    ids: the loss and the gradient of every parameter (the pooler, which
    the MLM loss does not reach, has none on either side)."""
    jm, tm = mlm_pair
    ids, tt = _ids(8), _task(9)
    lab = _ids(10)
    lab[np.random.RandomState(11).rand(B, S) < 0.3] = -100
    mask = ((np.random.RandomState(12).rand(B, S) > 0.2).astype(np.float32)
            if masked else None)
    jm.clear_gradients()
    jl = jm.loss(paddle.to_tensor(ids), paddle.to_tensor(lab),
                 task_type_ids=paddle.to_tensor(tt), loss_mask=_jt(mask),
                 chunk_size=32)
    jl.backward()
    tm.zero_grad(set_to_none=True)
    tl = tm.loss(torch.from_numpy(ids), torch.from_numpy(lab),
                 task_type_ids=torch.from_numpy(tt), loss_mask=_tt(mask),
                 chunk_size=32)
    tl.backward()
    assert float(tl.detach()) == pytest.approx(float(jl), rel=1e-5)
    tg = dict(tm.named_parameters())
    jg = {n: p.grad for n, p in jm.named_parameters()}
    assert set(jg) == set(tg)
    for n, g in jg.items():
        if g is None:
            assert tg[n].grad is None, n
            continue
        np.testing.assert_allclose(tg[n].grad.numpy(),
                                   _port_layout(n, g.numpy()), atol=ATOL,
                                   rtol=0, err_msg=n)
    assert tg["ernie.task_type_embeddings.weight"].grad.abs().sum() > 0


def test_mlm_loss_with_an_attention_mask_matches_jax(mlm_pair):
    """A 0/1 padding mask takes the reference-attention route on both
    sides."""
    jm, tm = mlm_pair
    ids = _ids(13)
    am = np.ones((B, S), np.int64)
    am[1, 40:] = 0
    jl = jm.loss(paddle.to_tensor(ids), paddle.to_tensor(ids),
                 attention_mask=paddle.to_tensor(am))
    with torch.no_grad():
        tl = tm.loss(torch.from_numpy(ids), torch.from_numpy(ids),
                     attention_mask=torch.from_numpy(am))
    assert float(tl) == pytest.approx(float(jl), rel=1e-5)


@pytest.mark.parametrize("task", [False, True])
def test_sequence_classification_matches_jax(task):
    """Logits and the gradients of a cross-entropy over them."""
    jm, tm = _build(JErnieCls, pt.ErnieForSequenceClassification,
                    num_classes=3)
    ids, tt = _ids(14), _task(15) if task else None
    y = np.array([0, 2])
    jm.clear_gradients()
    jlog = jm(paddle.to_tensor(ids), task_type_ids=_jt(tt))
    jloss = paddle.nn.functional.cross_entropy(jlog, paddle.to_tensor(y))
    jloss.backward()
    tlog = tm(torch.from_numpy(ids), task_type_ids=_tt(tt))
    tloss = torch.nn.functional.cross_entropy(tlog, torch.from_numpy(y))
    tloss.backward()
    np.testing.assert_allclose(tlog.detach().numpy(), jlog.numpy(),
                               atol=ATOL, rtol=0)
    assert float(tloss.detach()) == pytest.approx(float(jloss), rel=1e-5)
    tg = dict(tm.named_parameters())
    for n, p in jm.named_parameters():
        np.testing.assert_allclose(tg[n].grad.numpy(),
                                   _port_layout(n, p.grad.numpy()),
                                   atol=ATOL, rtol=0, err_msg=n)


def test_train_mode_dropout_draws_from_the_model_generator():
    """In train() mode hidden and attention dropout draw from the
    model's dropout_generator: reseeding it repeats the loss, another
    seed changes it, and eval() drops nothing."""
    m = pt.ErnieForMaskedLM(pt.ErnieConfig(**CFG, hidden_dropout=0.1,
                                           attention_dropout=0.1),
                            device="cpu", seed=3)
    ids = torch.from_numpy(_ids(16))
    m.train()
    losses = []
    for seed in (1, 1, 2):
        m.dropout_generator.manual_seed(seed)
        with torch.no_grad():
            losses.append(float(m.loss(ids, ids)))
    assert losses[0] == losses[1] != losses[2]
    m.eval()
    with torch.no_grad():
        a, b = float(m.loss(ids, ids)), float(m.loss(ids, ids))
    assert a == b and a not in losses


def test_heads_share_the_trunk_init_of_their_seed():
    """A head built with a seed holds the trunk ErnieModel builds with
    that seed."""
    cfg = pt.ErnieConfig(**CFG)
    trunk = pt.ErnieModel(cfg, device="cpu", seed=4)
    head = pt.ErnieForMaskedLM(cfg, device="cpu", seed=4)
    for (n, p), (m, q) in zip(trunk.named_parameters(),
                              head.ernie.named_parameters()):
        assert n == m
        torch.testing.assert_close(p, q, atol=0, rtol=0)
