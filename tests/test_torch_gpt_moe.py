"""PyTorch port vs JAX package: GPT with MoE blocks
(`GPTConfig(moe_num_experts=...)`): the loss with the router aux loss and
every gradient, the criterion's `aux_loss`, AdamW TrainStep trajectories,
recompute, greedy decode through static caches and the paged engine, and
the int8 weight payload.

Small f32 MoE GPTs are built in the JAX package; their state dicts go
through `state_dict_from_paddle` into the port (the experts and the
router keep their JAX shapes), and both sides see the same numpy token
ids. Tolerances as in test_torch_train: 1e-5 relative on losses, 2e-5
absolute on gradients, 1e-5 absolute on parameters after AdamW steps at
lr 1e-3 (f32, summation order only); greedy token chains exactly equal.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import ServingConfig as JServingConfig
from paddle_tpu.inference import ServingEngine as JServingEngine
from paddle_tpu.models import GPTConfig as JGPTConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu.models import GPTPretrainingCriterion as JCrit
import paddle_tpu_torch as pt
from test_torch_train import _assert_params_match, _ids, _jax_step, \
    _port_layout, _port_step

MOE = dict(moe_num_experts=4, moe_every_n_layers=2, moe_gate="gshard")
# the kernel routes' shapes (S % 128 == 0, H % 128 == 0, V >= 1024);
# block 1 of 2 is an MoE block
CFG_G = dict(vocab_size=1024, hidden_size=128, num_layers=2, num_heads=2,
             max_position_embeddings=128, intermediate_size=256, **MOE)
# a step-sized model with every block MoE, switch-routed
CFG_T = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
             max_position_embeddings=32, intermediate_size=128,
             moe_num_experts=4, moe_every_n_layers=1, moe_gate="switch",
             moe_capacity_factor=1.0)
# a serving-sized model
CFG_S = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
             max_position_embeddings=64, intermediate_size=128, **MOE)


def _pair(cfg, seed=0):
    paddle.seed(seed)
    jm = JGPT(JGPTConfig(**cfg))
    np_state = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    tcfg = pt.GPTConfig(**cfg)
    tm = pt.GPTForCausalLM(tcfg, device="cpu")
    tm.load_state_dict(pt.state_dict_from_paddle(np_state, tcfg))
    return jm, tm


@pytest.fixture(scope="module")
def grad_pair():
    return _pair(CFG_G)


def test_moe_blocks_and_parameters_mirror_jax(grad_pair):
    """Block i is MoE when i % n == n - 1; the expert and router
    parameters carry the JAX names and shapes, untransposed."""
    jm, tm = grad_pair
    assert [b.is_moe for b in tm.gpt.h] == [b.is_moe for b in jm.gpt.h] \
        == [False, True]
    shapes = {n: tuple(p.shape) for n, p in tm.named_parameters()}
    h, m, e = 128, 256, 4
    assert shapes["gpt.h.1.mlp.gate_weight"] == (h, e)
    assert shapes["gpt.h.1.mlp.w1"] == (e, h, m)
    assert shapes["gpt.h.1.mlp.w2"] == (e, m, h)
    assert "gpt.h.1.mlp.up.weight" not in shapes
    js = dict(jm.named_parameters())
    np.testing.assert_array_equal(
        tm.gpt.h[1].mlp.w2.detach().numpy(), js["gpt.h.1.mlp.w2"].numpy())


@pytest.mark.parametrize("path", ["loss", "criterion", "masked"])
def test_loss_with_aux_and_every_grad_match_jax(grad_pair, path):
    """`loss` adds moe_aux_weight * aux; the criterion adds the aux loss
    it is given (here the model's, unweighted, as the JAX docstring
    passes it)."""
    jm, tm = grad_pair
    ids = _ids(2, 128, CFG_G["vocab_size"], 1)
    labels = _ids(2, 128, CFG_G["vocab_size"], 2)
    mask = None
    if path == "masked":
        mask = (np.random.RandomState(3).rand(2, 128) > 0.3).astype(
            np.float32)
    jm.clear_gradients()
    jid, jlab = paddle.to_tensor(ids), paddle.to_tensor(labels)
    if path == "criterion":
        jlog = jm(jid)
        jl = JCrit()(jlog, jlab, aux_loss=jm.gpt.last_aux_loss)
    else:
        jl = jm.loss(jid, jlab, loss_mask=None if mask is None
                     else paddle.to_tensor(mask))
    jl.backward()
    tm.zero_grad(set_to_none=True)
    tid, tlab = torch.from_numpy(ids), torch.from_numpy(labels)
    if path == "criterion":
        tl = pt.GPTPretrainingCriterion()(tm(tid), tlab,
                                          aux_loss=tm.gpt.last_aux_loss)
    else:
        tl = tm.loss(tid, tlab, loss_mask=None if mask is None
                     else torch.from_numpy(mask))
    tl.backward()
    aux = float(tm.gpt.last_aux_loss.detach())
    assert aux == pytest.approx(float(jm.gpt.last_aux_loss), rel=1e-5)
    assert aux > 0.5                     # ~1 for a balanced router
    assert float(tl.detach()) == pytest.approx(float(jl), rel=1e-5)
    jgrads = {n: p.grad.numpy() for n, p in jm.named_parameters()}
    tgrads = dict(tm.named_parameters())
    assert set(jgrads) == set(tgrads)
    for n, g in jgrads.items():
        np.testing.assert_allclose(tgrads[n].grad.numpy(),
                                   _port_layout(n, g), atol=2e-5, rtol=0,
                                   err_msg=n)
    assert float(tgrads["gpt.h.1.mlp.gate_weight"].grad.abs().sum()) > 0


def test_loss_is_the_dense_loss_plus_the_weighted_aux(grad_pair):
    _, tm = grad_pair
    ids = torch.from_numpy(_ids(2, 128, CFG_G["vocab_size"], 4))
    with torch.no_grad():
        total = float(tm.loss(ids, ids))
        aux = float(tm.gpt.last_aux_loss)
        ce = float(pt.GPTPretrainingCriterion()(tm(ids), ids))
    assert total == pytest.approx(ce + 0.01 * aux, rel=1e-6)


@pytest.mark.parametrize("accum", [1, 2])
def test_train_steps_match_jax(accum):
    """4 AdamW TrainStep steps (weight decay, global-norm clip) of a
    switch-routed model whose every block is MoE, with tight capacity."""
    jm, tm = _pair(CFG_T, seed=2)
    jstep, tstep = _jax_step(jm, accum), _port_step(tm, accum)
    for i in range(4):
        ids = _ids(4, 16, CFG_T["vocab_size"], 20 + i)
        jl = float(jstep(paddle.to_tensor(ids), paddle.to_tensor(ids)))
        tl = float(tstep(torch.from_numpy(ids), torch.from_numpy(ids)))
        assert tl == pytest.approx(jl, rel=1e-5), i
    _assert_params_match(jm, tm)


def _port_grads(cfg, ids, policy, use, dropout):
    m = pt.GPTForCausalLM(pt.GPTConfig(**cfg, use_recompute=use,
                                       recompute_policy=policy,
                                       hidden_dropout=dropout),
                          device="cpu", seed=5)
    m.train()
    loss = m.loss(ids, ids)
    loss.backward()
    return (float(loss.detach()), float(m.gpt.last_aux_loss.detach()),
            {n: p.grad.clone() for n, p in m.named_parameters()})


@pytest.mark.parametrize("policy", [None, "save_qkv", "save_attn",
                                    "save_big", "dots"])
def test_recompute_equals_no_recompute(policy):
    """The MoE block's checkpoint regions (its own cut after the attention
    tags; the aux loss an output of the last region) give the loss, the
    aux loss and every gradient of the plain forward, with hidden dropout
    on (the recomputed regions redraw the forward's masks)."""
    ids = torch.from_numpy(_ids(2, 128, CFG_G["vocab_size"], 6))
    l0, a0, g0 = _port_grads(CFG_G, ids, policy, False, 0.1)
    l1, a1, g1 = _port_grads(CFG_G, ids, policy, True, 0.1)
    assert l1 == pytest.approx(l0, rel=1e-6)
    assert a1 == pytest.approx(a0, rel=1e-6)
    for n in g0:
        torch.testing.assert_close(g1[n], g0[n], atol=1e-6, rtol=0,
                                   msg=n)


def test_recompute_matches_jax_recompute(grad_pair):
    """save_qkv recompute in train() mode (no dropout) against the JAX
    GPT with the same policy, whose remat returns the aux loss as an
    output of the region."""
    jm0, _ = grad_pair
    np_state = {k: np.asarray(v) for k, v in jm0.state_dict().items()}
    ids = _ids(2, 128, CFG_G["vocab_size"], 7)
    jm = JGPT(JGPTConfig(**CFG_G, use_recompute=True,
                         recompute_policy="save_qkv"))
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in np_state.items()})
    jm.train()
    jl = jm.loss(paddle.to_tensor(ids), paddle.to_tensor(ids))
    jl.backward()
    tcfg = pt.GPTConfig(**CFG_G, use_recompute=True,
                        recompute_policy="save_qkv")
    tm = pt.GPTForCausalLM(tcfg, device="cpu")
    tm.load_state_dict(pt.state_dict_from_paddle(np_state, tcfg))
    tm.train()
    tl = tm.loss(torch.from_numpy(ids), torch.from_numpy(ids))
    tl.backward()
    assert float(tl.detach()) == pytest.approx(float(jl), rel=1e-5)
    tgrads = dict(tm.named_parameters())
    for n, p in jm.named_parameters():
        np.testing.assert_allclose(tgrads[n].grad.numpy(),
                                   _port_layout(n, p.grad.numpy()),
                                   atol=2e-5, rtol=0, err_msg=n)


def test_drop_rate_telemetry_skips_recomputed_forwards():
    """A training step under recompute counts each MoE forward once: the
    assignments counted equal one forward's b * s * k per MoE block."""
    from paddle_tpu_torch.incubate.distributed.models.moe import moe_layer
    cfg = pt.GPTConfig(**CFG_G, use_recompute=True)
    m = pt.GPTForCausalLM(cfg, device="cpu")
    m.train()
    ids = torch.from_numpy(_ids(2, 128, CFG_G["vocab_size"], 8))
    moe_layer.record_drop_rate(True)
    try:
        m.loss(ids, ids).backward()
        assigned = moe_layer._DROP_REC["assigned"]
    finally:
        moe_layer.record_drop_rate(False)
    assert assigned == 2 * 128 * 2


@pytest.fixture(scope="module")
def serve_pair():
    jm, tm = _pair(CFG_S, seed=1)
    jm.eval()
    return jm, tm


def _prompts(lens, cap, seed=1):
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, CFG_S["vocab_size"], (len(lens), cap)).astype(
        np.int64)
    for r, ln in enumerate(lens):
        ids[r, ln:] = 0
    return ids


@pytest.mark.parametrize("cache_dtype", [None, "int8"])
def test_generate_static_chain_matches_jax(serve_pair, cache_dtype):
    """Greedy static-cache decode through the MoE blocks (prefill's
    capacity counts the whole prompt batch, decode's the b tokens of a
    step), bf16-free f32, exactly JAX's chain."""
    jm, tm = serve_pair
    ids = _prompts([8, 8, 8], 8, seed=2)
    ref = np.asarray(jm.generate_static(paddle.to_tensor(ids),
                                        max_new_tokens=10,
                                        cache_dtype=cache_dtype).numpy())
    got = tm.generate_static(torch.from_numpy(ids), max_new_tokens=10,
                             cache_dtype=cache_dtype).numpy()
    np.testing.assert_array_equal(got, ref)


def test_paged_engine_chain_matches_jax_engine(serve_pair):
    """Ragged prompts through the paged engine's two slots (decode
    batches padded rows into the MoE capacity, as the JAX engine does):
    every chain equals the JAX engine's."""
    jm, tm = serve_pair
    lens = [8, 5, 3, 7]
    ids = _prompts(lens, 8)
    cfg = dict(max_batch=2, prompt_cap=8, max_new_tokens=6, decode_chunk=2,
               paged=True, kv_block=4)

    def serve(engine):
        for i, ln in enumerate(lens):
            engine.submit(ids[i, :ln])
        done = engine.drain()
        assert [r.status for r in done] == ["done"] * len(lens)
        return {tuple(np.asarray(r.prompt).tolist()): np.asarray(r.tokens)
                for r in done}

    got = serve(pt.ServingEngine(tm, pt.ServingConfig(**cfg)))
    jgot = serve(JServingEngine(jm, JServingConfig(**cfg)))
    assert set(got) == set(jgot)
    for k, toks in got.items():
        np.testing.assert_array_equal(toks, jgot[k])


def test_int8_payload_skips_the_experts_like_jax(serve_pair, monkeypatch):
    """The weight-only int8 payload holds the same parameters as the JAX
    `_decode_quantized_params` (2-D and large enough: the experts are 3-D,
    the router [H, E] small), the MoE block's layer tree asks for no
    mlp.up / mlp.down, and int8-weight decode gives JAX's chain."""
    monkeypatch.setenv("PADDLE_TPU_Q8_DECODE_MIN", "4096")
    jm, tm = _pair(CFG_S, seed=1)
    jm.eval()
    names = [n for n, _ in jm.named_parameters()]
    jq = {names[i] for i in jm._decode_quantized_params()}
    tq = set(tm.quantized_params())
    assert tq == jq
    assert "gpt.h.0.mlp.up.weight" in tq
    assert not any(".h.1.mlp." in n for n in tq)
    tree = tm._q8("int8")["h"]
    assert set(tree[0]) == {"attn.qkv", "attn.out", "mlp.up", "mlp.down"}
    assert set(tree[1]) == {"attn.qkv", "attn.out"}
    ids = _prompts([8, 8], 8, seed=3)
    ref = np.asarray(jm.generate_static(paddle.to_tensor(ids),
                                        max_new_tokens=6,
                                        weight_dtype="int8").numpy())
    got = tm.generate_static(torch.from_numpy(ids), max_new_tokens=6,
                             weight_dtype="int8").numpy()
    np.testing.assert_array_equal(got, ref)


def test_config_refusals():
    """An unknown sequence-parallel schedule, an unknown gate and a top-2
    switch gate are refused; "ulysses" is accepted."""
    assert pt.GPTConfig(sequence_parallel="ulysses").sequence_parallel \
        == "ulysses"
    with pytest.raises(ValueError, match="sequence-parallel schedule"):
        pt.GPTConfig(sequence_parallel="zigzag")
    with pytest.raises(ValueError, match="moe_gate"):
        pt.GPTConfig(moe_num_experts=4, moe_gate="hash")
    with pytest.raises(ValueError, match="top-1"):
        pt.GPTConfig(moe_num_experts=4, moe_gate="switch", moe_top_k=2)
    cfg = pt.GPTConfig(moe_num_experts=8, moe_capacity_factor=1.0,
                       moe_top_k=2, moe_aux_weight=0.1, moe_every_n_layers=3)
    assert cfg.moe_num_experts == 8


def test_train_state_carries_moe_optimizer_state_untransposed():
    """A JAX TrainStep state of an MoE GPT maps onto the port's layout:
    expert and router moments keep their shapes, Linear ones flip, and a
    resumed port step continues the JAX trajectory."""
    jm, tm = _pair(CFG_T, seed=4)
    jstep = _jax_step(jm, 1)
    ids = _ids(4, 16, CFG_T["vocab_size"], 30)
    for _ in range(2):
        jstep(paddle.to_tensor(ids), paddle.to_tensor(ids))
    mapped = pt.train_state_from_paddle(jstep.state_dict(), tm)
    assert tuple(mapped["opt"]["gpt.h.0.mlp.w1"]["moment1"].shape) == \
        (4, 64, 128)
    tstep = _port_step(tm, 1)
    tstep.set_state_dict(mapped)
    ids2 = _ids(4, 16, CFG_T["vocab_size"], 31)
    jl = float(jstep(paddle.to_tensor(ids2), paddle.to_tensor(ids2)))
    tl = float(tstep(torch.from_numpy(ids2), torch.from_numpy(ids2)))
    assert tl == pytest.approx(jl, rel=1e-5)
    _assert_params_match(jm, tm)
