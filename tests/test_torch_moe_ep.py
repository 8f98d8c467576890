"""PyTorch port vs JAX package: the MoE layer and the MoE GPT across 2
and 4 CPU ranks (gloo): global routing over the token group, expert
parallelism over an ``ep`` axis, and the converter's expert shards.

The JAX MoE layer routes the GLOBAL batch (`moe_layer.py:131`: capacity
of b * s global tokens, one slot-major cumsum over them, the aux loss's
means over them). The port's ranks hold their rows only, so under dp
they route together (`_global_slots`, one all-gather of counts a layer,
and an all-reduce of the router's probabilities whose backward sums
too). The layer is MoELayer(16, 32, 4, gshard) at capacity factor 0.5,
where tokens drop, on x [4, 8, 16] from a seed; the loss is sum(y * dy)
+ aux, whose gradient the ranks' average equals. Legs: dp2 routed as
one batch, on the index route and on the one-hot route; dp2 routed per
rank (the control: per-rank capacity and ranks, which must fail the
limit); ep2 (2 experts a rank, the same rows on both ranks); dp2 x
ep2. Limits (f32): outputs and aux 1e-5, every gradient 1e-4 of its
largest entry, the global drop rate exact. Then the MoE GPT
(tests/test_models_gpt.py::test_gpt_moe_dryrun_on_ep_mesh's config: the
tiny GPT with 4 experts every 2nd layer) trains 3 AdamW steps at dp2 x
ep2 against the JAX TrainStep on the same mesh (losses 1e-5 relative)
and the port's one-process step (losses 1e-5 relative, gathered
parameters 1e-4 of each tensor's max), its replicated parameters bitwise
equal across ep, and `shard_state_from_paddle` -> `gather_state` is
bitwise the full state. The ranks run in tests/torch_dist_workers.py,
which imports no JAX.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
from paddle_tpu.incubate.distributed.models.moe import MoELayer as JMoE
from paddle_tpu.incubate.distributed.models.moe import moe_layer as JML
from paddle_tpu.models import GPTConfig as JGPTConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
import paddle_tpu_torch as pt
import torch_dist_workers as W

D_, H_, E_, CF = 16, 32, 4, 0.5
CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
           max_position_embeddings=64, intermediate_size=128)
MOE = dict(moe_num_experts=4, moe_every_n_layers=2)
CLIP = 0.05
# leg: world
LEGS = {"dp2": 2, "dp2_onehot": 2, "ep2": 2, "dp2_ep2": 4}


def _jax_layer(state, x, dy):
    """The JAX layer's function (`_moe_forward`, jitted) on the global
    batch: y, aux, the drop rate (of its `_topk_routing`'s keep flags)
    and the gradients of sum(y * dy) + aux."""
    jm = JMoE(D_, H_, E_, gate="gshard", capacity_factor=CF)
    names = ("gate_weight", "w1", "b1", "w2", "b2")

    def loss(x, *params):
        y, aux = JML._moe_forward(
            x, *params, top_k=jm.top_k, capacity_factor=CF,
            gate_type=jm.gate_type, activation=jm._activation)
        return jnp.sum(y * dy) + aux, (y, aux)
    (_, (y, aux)), g = jax.jit(jax.value_and_grad(
        loss, argnums=tuple(range(6)), has_aux=True))(
            x, *[state[n] for n in names])
    probs = jax.nn.softmax(jnp.asarray(x).reshape(-1, D_)
                           @ state["gate_weight"], axis=-1)
    cap = JML._capacity(probs.shape[0], E_, jm.top_k, CF)
    keeps = np.asarray(JML._topk_routing(probs, jm.top_k, cap)[3])
    grads = {n: np.asarray(t) for n, t in zip(names, g[1:])}
    grads["x"] = np.asarray(g[0])
    return np.asarray(y), float(aux), 1.0 - keeps.mean(), grads


def _jax_gpt_losses(np_state, ids, mask):
    paddle.seed(7)
    jm = JGPT(JGPTConfig(**CFG, **MOE))
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in np_state.items()})
    mesh = jdist.build_mesh({"dp": 2, "ep": 2}, devices=jax.devices()[:4])
    jdist.set_mesh(mesh)
    try:
        opt = paddle.optimizer.AdamW(
            learning_rate=1e-3, parameters=jm.parameters(), weight_decay=0.01,
            grad_clip=paddle.nn.ClipGradByGlobalNorm(CLIP))
        step = paddle.jit.TrainStep(
            jm, opt, lambda a, b, m: jm.loss(a, b, loss_mask=m, chunk_size=8),
            mesh=mesh, data_axes=("dp",))
        a, m = paddle.to_tensor(ids), paddle.to_tensor(mask)
        return [float(step(a, a, m)) for _ in range(3)]
    finally:
        jdist.set_mesh(None)


def _port_single(np_state, ids, mask):
    cfg = pt.GPTConfig(**CFG, **MOE)
    tm = pt.GPTForCausalLM(cfg, device="cpu")
    tm.load_state_dict(pt.state_dict_from_paddle(np_state, cfg))
    a, m = torch.from_numpy(ids), torch.from_numpy(mask)
    step = W._adamw_step(tm, CLIP, None)
    losses = [float(step(a, a, m)) for _ in range(3)]
    return losses, {n: p.detach().clone()
                    for n, p in tm.named_parameters()}


@pytest.fixture(scope="module")
def ep(tmp_path_factory):
    paddle.seed(3)
    layer = JMoE(D_, H_, E_, gate="gshard", capacity_factor=CF)
    lstate = {k: np.asarray(v) for k, v in layer.state_dict().items()}
    rs = np.random.RandomState(5)
    x = rs.randn(4, 8, D_).astype(np.float32)
    dy = rs.randn(4, 8, D_).astype(np.float32)
    paddle.seed(7)
    jm = JGPT(JGPTConfig(**CFG, **MOE))
    np_state = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    ids = rs.randint(0, CFG["vocab_size"], (4, 16)).astype(np.int64)
    mask = np.ones((4, 16), np.float32)
    mask[2:, 3:] = 0.0              # the second dp half: 6 tokens
    runs = {}
    for n in (2, 4):
        d = tmp_path_factory.mktemp(f"moe_ep{n}")
        np.savez(d / "inputs.npz", ids=ids, mask=mask, clip=CLIP, moe_x=x,
                 moe_dy=dy, moe_d=D_, moe_h=H_, moe_e=E_, moe_cf=CF,
                 **{f"moe:{k}": v for k, v in lstate.items()},
                 **{f"cfg_{k}": v for k, v in CFG.items()},
                 **{f"state:{k}": v for k, v in np_state.items()})
        runs[n] = (d, W.start(W.moe_ep, d, nprocs=n))
    try:
        losses, params = _port_single(np_state, ids, mask)
        layer = _jax_layer(lstate, x, dy)
        jax_losses = _jax_gpt_losses(np_state, ids, mask)
    finally:
        for _, ctx in runs.values():
            W.wait(ctx)
    ranks = {n: [dict(np.load(d / f"rank{r}.npz")) for r in range(n)]
             for n, (d, _) in runs.items()}
    return dict(ranks=ranks, layer=layer, jax=jax_losses, single=losses,
                params=params)


def _rows(ranks, tag, key, dp_of):
    """The dp ranks' rows of `key` joined in row order (one rank of each
    dp coordinate)."""
    seen = {}
    for i, r in enumerate(ranks):
        seen.setdefault(dp_of(i), r[f"{tag}:{key}"])
    return np.concatenate([seen[k] for k in sorted(seen)])


_DP_OF = {"dp2": lambda i: i, "dp2_per_rank": lambda i: i,
          "dp2_onehot": lambda i: i,
          "ep2": lambda i: 0,
          "dp2_ep2": lambda i: i // 2}


def _errs(ranks, tag, want):
    """Worst output error, aux error and worst gradient error (relative
    to each gradient's max) of a leg against the JAX layer."""
    y, aux, _, grads = want
    got_y = _rows(ranks, tag, "y", _DP_OF[tag])
    ey = float(np.abs(got_y - y).max())
    ea = max(abs(float(r[tag + ":aux"]) - aux) for r in ranks)
    eg = 0.0
    for r in ranks:
        for n, g in grads.items():
            got = _rows(ranks, tag, "dx", _DP_OF[tag]) if n == "x" \
                else r[f"{tag}:grad:{n}"]
            eg = max(eg, float(np.abs(got - g).max() / np.abs(g).max()))
    return ey, ea, eg


@pytest.mark.parametrize("tag", list(LEGS))
def test_layer_matches_jax_on_the_global_batch(ep, tag):
    ey, ea, eg = _errs(ep["ranks"][LEGS[tag]], tag, ep["layer"])
    assert ey <= 1e-5 and ea <= 1e-5 and eg <= 1e-4, (ey, ea, eg)


@pytest.mark.parametrize("tag", list(LEGS))
def test_drop_rate_is_the_global_one(ep, tag):
    ranks = ep["ranks"][LEGS[tag]]
    drop = ep["layer"][2]
    assert drop > 0.05                     # the capacity binds
    got = np.mean([float(r[tag + ":drop"]) for r in ranks])
    assert abs(got - drop) < 1e-9


def test_per_rank_capacity_fails_the_limit(ep):
    """The control: routing each dp rank's rows alone (the parent tree's
    layer) misses the JAX function by far more than the limit."""
    ey, ea, eg = _errs(ep["ranks"][2], "dp2_per_rank", ep["layer"])
    assert ey > 100 * 1e-5 or ea > 100 * 1e-5


@pytest.mark.parametrize("n", (2, 4))
def test_expert_tensors_are_split_over_ep(ep, n):
    tag = "ep2" if n == 2 else "dp2_ep2"
    for r in ep["ranks"][n]:
        assert r[f"{tag}:grad:w1"].shape[0] == E_
    if n == 4:
        r0 = ep["ranks"][4][0]
        assert int(r0["expert_shard_rows"]) == MOE["moe_num_experts"] // 2
        assert bool(r0["splits_match"])


def test_gpt_losses_match_jax_mesh_step(ep):
    np.testing.assert_allclose(ep["ranks"][4][0]["gpt:losses"], ep["jax"],
                               rtol=1e-5)


def test_gpt_losses_match_port_single_process_on_every_rank(ep):
    for r in ep["ranks"][4]:
        np.testing.assert_allclose(r["gpt:losses"], ep["single"], rtol=1e-5)


def test_gpt_gathered_params_match_port_single_process(ep):
    for r in ep["ranks"][4]:
        for n, want in ep["params"].items():
            want = want.numpy()
            err = np.abs(r["gpt:param:" + n] - want).max()
            assert err <= 1e-4 * np.abs(want).max(), (n, err)


def test_gpt_replicated_params_bitwise_equal_across_ep(ep):
    rk = ep["ranks"][4]
    names = [k for k in rk[0] if k.startswith("gpt:local:")]
    assert "gpt:local:gpt.h.1.mlp.gate_weight" in names
    for a, b in ((0, 1), (2, 3)):
        assert tuple(rk[a]["coords"])[0] == tuple(rk[b]["coords"])[0]
        for k in names:
            np.testing.assert_array_equal(rk[a][k], rk[b][k], err_msg=k)


def test_converter_ep_round_trip_is_bitwise(ep):
    for r in ep["ranks"][4]:
        assert bool(r["roundtrip_bitwise"])


def test_ranks_import_no_jax(ep):
    for n in (2, 4):
        for r in ep["ranks"][n]:
            assert r["foreign_modules"].size == 0
