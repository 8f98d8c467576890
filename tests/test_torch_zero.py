"""PyTorch port vs JAX package: ZeRO stages 1-3 (distributed/sharding.py,
group_sharded_parallel) on the port's TrainStep, on 4 CPU ranks over
gloo.

The tiny GPT (the JAX package's weights), 3 AdamW steps with the clip
active on a global batch of 4 rows, trained in the ranks
(tests/torch_dist_workers.py, which imports no JAX) on: plain dp4; dp4 at
"os", "os_g" and "p_g_os" (and "p_g_os" with recompute save_qkv);
{"sdp": 2, "mp": 2} at ZeRO-1 through fleet.init(strategy.sharding); and
{"dp": 2, "sdp": 2} at "p_g_os". Tolerances:
  * "os" bitwise equal to plain dp4 (the same averaged gradients and the
    one-card update on each owner);
  * every level within 1e-6 absolute of plain dp4 and within 1e-5
    absolute of the port's one-process step (the order of the f32 sums:
    a reduce to the owner sums in another order than the all-reduce);
  * losses within 3e-4 relative of the JAX TrainStep under
    group_sharded_parallel on a dp4 mesh (the JAX package's own
    mesh-vs-single bound, as in test_torch_gpt_tp);
  * every rank's whole parameters bitwise equal after every step;
  * state_dict round trips: a dp4 "os_g" state loads into a one-process
    step, whose next step follows the dp4 run's within 1e-5; a
    one-process state set into a dp4 "os_g" or "p_g_os" step comes back
    bitwise, and its next step follows the one-process run's within
    1e-5.
"""
import json

import numpy as np
import pytest

import jax
import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
from paddle_tpu.models import GPTConfig as JGPTConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
import torch_dist_workers as W

CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
           max_position_embeddings=64, intermediate_size=128)
CLIP = 0.05
LEGS = ("os", "os_g", "p_g_os", "p_g_os_remat", "sdp_mp", "dp_sdp")


def _jax_losses(np_state, ids, level):
    """The JAX TrainStep under group_sharded_parallel on a dp4 mesh."""
    paddle.seed(7)
    jm = JGPT(JGPTConfig(**CFG))
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in np_state.items()})
    jm.train()
    mesh = jdist.build_mesh({"dp": 4}, devices=jax.devices()[:4])
    jdist.set_mesh(mesh)
    try:
        opt = paddle.optimizer.AdamW(
            learning_rate=1e-3, parameters=jm.parameters(), weight_decay=0.01,
            grad_clip=paddle.nn.ClipGradByGlobalNorm(CLIP))
        jm, opt, _ = jdist.group_sharded_parallel(jm, opt, level=level)
        step = paddle.jit.TrainStep(
            jm, opt, lambda a, b: jm.loss(a, b, chunk_size=8), mesh=mesh)
        return [float(step(paddle.to_tensor(ids[i]),
                           paddle.to_tensor(ids[i]))) for i in range(3)]
    finally:
        jdist.set_mesh(None)


@pytest.fixture(scope="module")
def zero(tmp_path_factory):
    d = tmp_path_factory.mktemp("zero")
    paddle.seed(7)
    jm = JGPT(JGPTConfig(**CFG))
    np_state = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    ids = np.random.RandomState(0).randint(
        0, CFG["vocab_size"], (3, 4, 16)).astype(np.int64)
    np.savez(d / "inputs.npz", ids=ids, clip=CLIP,
             **{f"cfg_{k}": v for k, v in CFG.items()},
             **{f"state:{k}": v for k, v in np_state.items()})
    W.run(W.zero_levels, d)
    ranks = [dict(np.load(d / f"rank{r}.npz")) for r in range(W.WORLD)]
    inp = dict(np.load(d / "inputs.npz"))
    single = W.dp_train(inp, None)
    return dict(ranks=ranks, single=single,
                jax={lv: _jax_losses(np_state, ids, lv)
                     for lv in ("os_g", "p_g_os")})


def _params(r, tag):
    return {k[len(tag) + 7:]: v for k, v in r.items()
            if k.startswith(f"{tag}:param:")}


def test_os_bitwise_equal_to_plain_dp(zero):
    for r in zero["ranks"]:
        np.testing.assert_array_equal(r["os:losses"], r["plain:losses"])
        a, b = _params(r, "os"), _params(r, "plain")
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("leg", LEGS)
def test_level_follows_plain_dp_and_one_process(zero, leg):
    want = {k: v.numpy() for k, v in zero["single"][1].items()}
    r0 = zero["ranks"][0]
    got, plain = _params(r0, leg), _params(r0, "plain")
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=0,
                                   err_msg=k)
        if not leg.startswith(("sdp", "dp_")):
            np.testing.assert_allclose(got[k], plain[k], atol=1e-6, rtol=0,
                                       err_msg=k)
    np.testing.assert_allclose(r0[f"{leg}:losses"], zero["single"][0],
                               rtol=1e-5)


@pytest.mark.parametrize("level", ["os_g", "p_g_os"])
def test_losses_follow_jax_group_sharded_step(zero, level):
    np.testing.assert_allclose(zero["ranks"][0][f"{level}:losses"],
                               zero["jax"][level], rtol=3e-4)


@pytest.mark.parametrize("leg", ("plain",) + LEGS)
def test_every_rank_bitwise_after_every_step(zero, leg):
    rk = zero["ranks"]
    for r in rk[1:]:
        np.testing.assert_array_equal(r[f"{leg}:digests"],
                                      rk[0][f"{leg}:digests"])


def test_ownership_partitions_the_parameters(zero):
    rk = zero["ranks"]
    for tag in ("os", "os_g", "p_g_os"):
        owned = np.stack([r[f"{tag}:owned"] for r in rk]).astype(int)
        assert (owned.sum(0) == 1).all()        # each parameter one owner
        assert (owned.sum(1) > 0).all()         # every rank owns some
        assert [int(r[f"{tag}:stage"]) for r in rk] == \
            [{"os": 1, "os_g": 2, "p_g_os": 3}[tag]] * 4


def test_memory_ledger_counts_a_cards_share(zero):
    """train_opt_state is a rank's own share under every level; stage 2
    keeps its own gradients only, stage 3 its own parameters only."""
    rk = zero["ranks"]
    plain = json.loads(str(rk[0]["plain:memz"]))
    total_p, total_o = plain["train_params"], plain["train_opt_state"]
    assert plain["train_grads"] == total_p
    for tag in ("os", "os_g", "p_g_os"):
        rows = [json.loads(str(r[f"{tag}:memz"])) for r in rk]
        assert sum(x["train_opt_state"] for x in rows) == total_o
        grads = [x["train_grads"] for x in rows]
        params = [x["train_params"] for x in rows]
        if tag == "os":
            assert grads == [total_p] * 4 and params == [total_p] * 4
        else:
            assert sum(grads) == total_p and max(grads) < total_p
        if tag == "p_g_os":
            assert sum(params) == total_p and max(params) < total_p
        elif tag == "os_g":
            assert params == [total_p] * 4


def test_wire_bytes_by_level(zero):
    """Plain dp and "os" all-reduce the gradients; "os_g" reduces each to
    its owner and broadcasts the parameters back; "p_g_os" gathers
    parameters (a second communicator) and broadcasts none after the
    update. Every payload is f32, as the model."""
    w = {t: json.loads(str(zero["ranks"][0][f"{t}:wire"]))
         for t in ("plain", "os", "os_g", "p_g_os")}
    grad_ar = w["plain"]["dp:all_reduce/float32"]
    params = grad_ar - 3 * 4           # less the loss's 4 bytes a step
    assert w["os"]["dp:all_reduce/float32"] == grad_ar
    assert "dp:reduce/float32" not in w["os"]
    assert w["os"]["dp:broadcast/float32"] == params
    assert w["os_g"]["dp:reduce/float32"] == params
    # the loss and the clip's two sums of squares over the shard group
    assert w["os_g"]["dp:all_reduce/float32"] == 3 * (4 + 8)
    assert w["os_g"]["dp:broadcast/float32"] == params
    assert w["p_g_os"]["dp:reduce/float32"] == params
    assert "dp:broadcast/float32" not in w["p_g_os"]
    # stage 3 gathers the 3 other ranks' parameters twice a step (forward
    # and backward), the embeddings once: at most 2 x 3/4 of the bytes
    assert 0 < w["p_g_os"]["gather:broadcast/float32"] <= 2 * params


def test_state_dict_round_trips(zero):
    for r in zero["ranks"]:
        assert bool(r["one_to_os_g:bitwise"])
        # one process from the dp4 os_g state after step 2: its step 3
        np.testing.assert_allclose(r["os_g_to_one:loss"][0],
                                   r["os_g:losses"][2], rtol=1e-5)
        got, want = _params(r, "os_g_to_one"), _params(r, "os_g")
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=0,
                                       err_msg=k)


@pytest.mark.parametrize("level", ["os_g", "p_g_os"])
def test_one_process_state_loads_into_every_level(zero, level):
    """The one-process state after 2 steps set into a dp4 step at
    `level`: read back whole and bitwise (stage 3 loads a rank's own
    parameters, which it holds between steps while not gathered), and
    its next step follows the one-process run's step 3."""
    want = {k: v.numpy() for k, v in zero["single"][1].items()}
    for r in zero["ranks"]:
        assert bool(r[f"one_to_{level}:read_back_bitwise"])
        np.testing.assert_allclose(r[f"one_to_{level}:losses"][0],
                                   zero["single"][0][2], rtol=1e-5)
        got = _params(r, f"one_to_{level}")
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=0,
                                       err_msg=k)


def test_stage3_frees_other_ranks_and_gather_state_makes_them_whole(zero):
    for r in zero["ranks"]:
        # between steps a rank holds its own parameters' data only
        assert int(r["p_g_os:freed"]) == len(r["p_g_os:owned"]) - \
            int(r["p_g_os:owned"].sum())
        assert bool(r["p_g_os:gather_state_bitwise"])


def test_fleet_sharding_builds_the_sdp_axis(zero):
    for r in zero["ranks"]:
        assert json.loads(str(r["sdp_mp:axes"])) == {"sdp": 2, "mp": 2}
        assert int(r["sdp_mp:stage"]) == 1
        assert list(r["sdp_mp:hcg"][[0, 2]]) == [2, 2]
        assert str(r["dp_sdp:axis"]) == "sdp"


def test_zero_refusals():
    """numerics= needs every gradient, which ZeRO stage >= 2 keeps on its
    owner only: refused, stage 1 accepted."""
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.distributed as D
    m = pt.GPTForCausalLM(pt.GPTConfig(**CFG), device="cpu")
    for stage, ok in ((1, True), (2, False), (3, False)):
        opt = D.shard_optimizer_state(pt.AdamW(
            1e-3, parameters=m.named_parameters(), device="cpu"), stage)
        make = (lambda: pt.TrainStep(m, opt, lambda a, b: m.loss(a, b),
                                     numerics=True, device="cpu"))
        if ok:
            make()
        else:
            with pytest.raises(ValueError, match="ZeRO stage >= 2"):
                make()
    with pytest.raises(ValueError, match="level must be one of"):
        D.group_sharded_parallel(m, opt, level="p_os")


def test_no_rank_imported_jax(zero):
    for r in zero["ranks"]:
        assert r["foreign_modules"].size == 0, r["foreign_modules"]
