"""PyTorch port vs JAX package: GPT training loss and gradients, the
loss-scale rule, LR schedules, the optimizer's options, and dropout. The
TrainStep trajectories are in test_torch_train_step.py, which shares the
helpers here.

Small f32 GPTs are built in the JAX package; their state dicts go through
`state_dict_from_paddle` into the port, and both sides see the same numpy
token ids. Tolerances: 1e-5 relative on losses; 2e-5 absolute on
gradients (f32, the flash and fused-CE routes of the port against the JAX
reference attention and chunked CE: summation order only); 1e-5 absolute
on parameters after AdamW steps at lr 1e-3 (each step moves a parameter
by at most ~lr, so this is 1% of one step).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import GPTConfig as JGPTConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu.models import GPTPretrainingCriterion as JCrit
import paddle_tpu_torch as pt
from paddle_tpu_torch.optimizer import lr as tlr

# the kernel routes' shapes: S % 128 == 0, H % 128 == 0, V >= 1024
CFG_G = dict(vocab_size=1024, hidden_size=128, num_layers=2, num_heads=2,
             max_position_embeddings=128, intermediate_size=256)
# a step-sized model for the trajectories (one layer keeps the JAX step's
# compile short)
CFG_T = dict(vocab_size=128, hidden_size=64, num_layers=1, num_heads=4,
             max_position_embeddings=32, intermediate_size=128)
_FLIP = ("attn.qkv.weight", "attn.out.weight", "mlp.up.weight",
         "mlp.down.weight")


def _pair(cfg, seed=0):
    paddle.seed(seed)
    jm = JGPT(JGPTConfig(**cfg))
    np_state = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    tcfg = pt.GPTConfig(**cfg)
    tm = pt.GPTForCausalLM(tcfg, device="cpu")
    tm.load_state_dict(pt.state_dict_from_paddle(np_state, tcfg))
    return jm, tm


def _port_layout(name, arr):
    return arr.T if name.endswith(_FLIP) else arr


@pytest.fixture(scope="module")
def grad_pair():
    return _pair(CFG_G)


def _ids(b, s, v, seed):
    return np.random.RandomState(seed).randint(0, v, (b, s)).astype(np.int64)


@pytest.mark.parametrize("path", ["loss", "criterion", "masked"])
def test_loss_and_every_grad_match_jax(grad_pair, path):
    jm, tm = grad_pair
    ids = _ids(2, 128, CFG_G["vocab_size"], 1)
    labels = _ids(2, 128, CFG_G["vocab_size"], 2)
    mask = None
    if path == "masked":
        mask = (np.random.RandomState(3).rand(2, 128) > 0.3).astype(
            np.float32)
    jm.clear_gradients()
    jid, jlab = paddle.to_tensor(ids), paddle.to_tensor(labels)
    jmask = None if mask is None else paddle.to_tensor(mask)
    if path == "criterion":
        jl = JCrit()(jm(jid), jlab)
    else:
        jl = jm.loss(jid, jlab, loss_mask=jmask)
    jl.backward()
    tm.zero_grad(set_to_none=True)
    tid, tlab = torch.from_numpy(ids), torch.from_numpy(labels)
    tmask = None if mask is None else torch.from_numpy(mask)
    if path == "criterion":
        tl = pt.GPTPretrainingCriterion()(tm(tid), tlab)
    else:
        tl = tm.loss(tid, tlab, loss_mask=tmask)
    tl.backward()
    assert float(tl.detach()) == pytest.approx(float(jl), rel=1e-5)
    jgrads = {n: p.grad.numpy() for n, p in jm.named_parameters()}
    tgrads = dict(tm.named_parameters())
    assert set(jgrads) == set(tgrads)
    for n, g in jgrads.items():
        np.testing.assert_allclose(tgrads[n].grad.numpy(),
                                   _port_layout(n, g), atol=2e-5, rtol=0,
                                   err_msg=n)


def _decay(name):
    return not (name.endswith(".bias") or ".ln_" in name)


def _jax_step(jm, accum, scaler=None, lr=1e-3, loss=None):
    for n, p in jm.named_parameters():
        p.name = n                      # apply_decay_param_fun reads it
    opt = paddle.optimizer.AdamW(
        learning_rate=lr, parameters=jm.parameters(), weight_decay=0.01,
        apply_decay_param_fun=_decay,
        grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
    fn = loss or (lambda a, b: jm.loss(a, b, chunk_size=8))
    return paddle.jit.TrainStep(jm, opt, fn, grad_accum_steps=accum,
                                scaler=scaler)


def _port_step(tm, accum, scaler=None, lr=1e-3, loss=None):
    opt = pt.AdamW(lr, parameters=tm.named_parameters(), weight_decay=0.01,
                   apply_decay_param_fun=_decay,
                   grad_clip=pt.ClipGradByGlobalNorm(1.0), device="cpu")
    fn = loss or (lambda a, b: tm.loss(a, b, chunk_size=8))
    return pt.TrainStep(tm, opt, fn, grad_accum_steps=accum,
                        scaler=scaler, device="cpu")


def _assert_params_match(jm, tm, atol=1e-5):
    tparams = dict(tm.named_parameters())
    for n, p in jm.named_parameters():
        np.testing.assert_allclose(tparams[n].detach().numpy(),
                                   _port_layout(n, p.numpy()), atol=atol,
                                   rtol=0, err_msg=n)


def test_scaler_rule_matches_jax_over_a_sequence():
    from paddle_tpu.amp.grad_scaler import GradScaler as JScaler
    hyper = dict(incr_ratio=2.0, decr_ratio=0.5, incr_every=3,
                 decr_every=2)
    js, ts = (2.0 ** 4, 0, 0), (2.0 ** 4, 0, 0)
    for found in [False, False, False, True, False, True, True, True,
                  False, False, False, False, True, True]:
        js = tuple(float(np.asarray(x)) for x in JScaler._update_rule(
            *js, found, **hyper))
        ts = pt.GradScaler._update_rule(*ts, found, **hyper)
        assert tuple(float(x) for x in ts) == js


def test_lr_schedules_match_jax():
    from paddle_tpu.optimizer import lr as jlr
    jw = jlr.LinearWarmup(jlr.CosineAnnealingDecay(1e-3, T_max=10),
                          warmup_steps=4, start_lr=0.0, end_lr=1e-3)
    tw = tlr.LinearWarmup(tlr.CosineAnnealingDecay(1e-3, T_max=10),
                          warmup_steps=4, start_lr=0.0, end_lr=1e-3)
    jc = jlr.CosineAnnealingDecay(0.5, T_max=7, eta_min=0.01)
    tc = tlr.CosineAnnealingDecay(0.5, T_max=7, eta_min=0.01)
    for _ in range(16):
        assert tw() == pytest.approx(jw(), abs=0, rel=1e-12)
        assert tc() == pytest.approx(jc(), abs=0, rel=1e-12)
        jw.step(), tw.step(), jc.step(), tc.step()
    fresh = tlr.LinearWarmup(tlr.CosineAnnealingDecay(1e-3, T_max=10),
                             warmup_steps=4, start_lr=0.0, end_lr=1e-3)
    fresh.set_state_dict(tw.state_dict())
    assert fresh() == tw() and fresh.last_epoch == tw.last_epoch


def test_train_step_reads_the_lr_every_step():
    _, tm = _pair(CFG_T)
    sched = tlr.LinearWarmup(1e-3, warmup_steps=2, start_lr=0.0,
                             end_lr=1e-3)
    opt = pt.AdamW(sched, parameters=tm.named_parameters(), device="cpu")
    ts = pt.TrainStep(tm, opt, lambda a, b: tm.loss(a, b), device="cpu")
    a = torch.from_numpy(_ids(2, 16, 128, 50))
    before = [p.detach().clone() for p in tm.parameters()]
    ts(a, a)                        # lr 0: no change, weight decay included
    assert all(torch.equal(p, b) for p, b in zip(tm.parameters(), before))
    sched.step()
    ts(a, a)
    assert not all(torch.equal(p, b)
                   for p, b in zip(tm.parameters(), before))


def test_bf16_moments_and_later_items():
    _, tm = _pair(CFG_T)
    opt = pt.AdamW(1e-3, parameters=tm.named_parameters(),
                   moment_dtype="bfloat16", device="cpu")
    ts = pt.TrainStep(tm, opt, lambda a, b: tm.loss(a, b), device="cpu")
    a = torch.from_numpy(_ids(2, 16, 128, 51))
    ts(a, a)
    assert ts._opt_state[0]["moment1"].dtype == torch.bfloat16
    # int8 moments are ported (test_torch_adam_int8 holds them against
    # JAX)
    opt8 = pt.AdamW(1e-3, parameters=tm.named_parameters(),
                    moment_dtype="int8", device="cpu")
    assert opt8.init_state(tm.gpt.wte.weight, name="gpt.wte.weight")[
        "moment1_q"].dtype == torch.int8
    sel = pt.AdamW(1e-3, parameters=tm.named_parameters(), device="cpu",
                   q8_param_fun=lambda n: "wte" in n)
    assert "moment2_q" in sel.init_state(tm.gpt.wte.weight,
                                         name="gpt.wte.weight")
    assert "moment1" in sel.init_state(tm.gpt.wpe.weight,
                                       name="gpt.wpe.weight")
    # AdamW(lr_ratio=) is accepted and never read, as in the JAX package:
    # the update equals the one without it (test_torch_optimizers holds it
    # against the JAX update)
    pa, pb = (torch.nn.Parameter(torch.linspace(-1, 1, 6)) for _ in "ab")
    for p, kw in ((pa, dict(lr_ratio=lambda p: 0.5)), (pb, {})):
        p.grad = torch.linspace(0.3, -0.2, 6)
        pt.AdamW(1e-3, parameters=[p], device="cpu", **kw).step()
    assert torch.equal(pa, pb) and not torch.equal(
        pa, torch.linspace(-1, 1, 6))
    # the options later slices bring stay refused, naming their queue item
    for kw, item in ((dict(mesh=object()), "A4"),
                     (dict(grad_comm="int8"), "A4"),
                     (dict(lint=True), "A8"),
                     (dict(preemption=object()), "A6"),
                     (dict(chaos=object()), "A6")):
        with pytest.raises(NotImplementedError,
                           match=f"slice .*queue item {item}"):
            pt.TrainStep(tm, opt, lambda a, b: tm.loss(a, b), device="cpu",
                         **kw)


def test_dropout_identity_at_zero_and_binomial_keep_at_p():
    cfg = dict(CFG_T, hidden_dropout=0.0)
    tm = pt.GPTForCausalLM(pt.GPTConfig(**cfg), device="cpu")
    a = torch.from_numpy(_ids(2, 16, 128, 52))
    with torch.no_grad():
        tm.train()
        train_loss = tm.loss(a, a)
        tm.eval()
        assert torch.equal(tm.loss(a, a), train_loss)
    p = 0.3
    tm = pt.GPTForCausalLM(pt.GPTConfig(**dict(CFG_T, hidden_dropout=p)),
                           device="cpu", seed=3)
    x = torch.ones(64, 1024)
    y = tm.gpt._drop(x)
    kept = y != 0
    n = x.numel()
    # within 5 standard deviations of the binomial mean
    assert abs(int(kept.sum()) - (1 - p) * n) < 5 * np.sqrt(n * p * (1 - p))
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / (1 - p)))
    # train() mode drops, with masks from the model's generator: two
    # forwards differ, re-seeding repeats one; eval() and serving don't
    with torch.no_grad():
        tm.train()
        tm.dropout_generator.manual_seed(11)
        l1 = tm.loss(a, a)
        l2 = tm.loss(a, a)
        tm.dropout_generator.manual_seed(11)
        assert torch.equal(tm.loss(a, a), l1) and not torch.equal(l1, l2)
        greedy_train = tm.generate_static(a[:, :4], max_new_tokens=4)
        tm.eval()
        assert not torch.equal(tm.loss(a, a), l1)
        assert torch.equal(tm.generate_static(a[:, :4], max_new_tokens=4),
                           greedy_train)


def test_eager_optimizer_and_scaler_equal_the_train_step():
    """The eager entry points (GradScaler.scale / step / update around
    AdamW.step from .grad) apply the TrainStep's arithmetic; the
    optimizer's state dict round-trips."""
    _, tm = _pair(CFG_T)
    _, tm2 = _pair(CFG_T)
    ts = _port_step(tm, 1, pt.GradScaler(init_loss_scaling=2.0 ** 8))
    opt = pt.AdamW(1e-3, parameters=tm2.named_parameters(),
                   weight_decay=0.01, apply_decay_param_fun=_decay,
                   grad_clip=pt.ClipGradByGlobalNorm(1.0), device="cpu")
    scaler = pt.GradScaler(init_loss_scaling=2.0 ** 8)
    for i in range(3):
        a = torch.from_numpy(_ids(4, 16, 128, 60 + i))
        ts(a, a)
        scaler.scale(tm2.loss(a, a, chunk_size=8)).backward()
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
    for (n, p), (_, p2) in zip(tm.named_parameters(),
                               tm2.named_parameters()):
        np.testing.assert_allclose(p2.detach().numpy(),
                                   p.detach().numpy(), atol=1e-6, rtol=0,
                                   err_msg=n)
    fresh = pt.AdamW(1e-3, parameters=tm2.named_parameters(), device="cpu")
    fresh.set_state_dict(opt.state_dict())
    assert fresh._step_count == 3
    for n, st in opt._states.items():
        assert torch.equal(fresh._states[n]["moment2"], st["moment2"]), n
