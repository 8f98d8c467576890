"""PyTorch port vs JAX package: GPT training across 4 CPU ranks (gloo) at
dp2 x mp2 — the process-group mesh, fleet.init, the mpu GPT and
TrainStep(mesh=...).

The model is tests/test_models_gpt.py's `_tiny()` GPT, built in the JAX
package; its weights go to the ranks through `shard_state_from_paddle`.
3 AdamW steps (weight decay 0.01, ClipGradByGlobalNorm active) on a
global batch of 4 rows whose loss mask is uneven across the two dp
halves, so a mean of per-rank means would differ from the global masked
mean. Tolerances: 3e-4 relative on losses against the JAX TrainStep on a
dp2 x mp2 mesh (the JAX package's own mesh-vs-single bound,
test_models_gpt.py::test_hybrid_tp_parity_with_single_device); 1e-5
relative on losses and 1e-5 absolute on parameters against the port's
one-process step (f32, summation order only); bitwise for replicated
parameters across mp ranks and for the shard -> gather round trip. The
ranks run in tests/torch_dist_workers.py, which imports no JAX.
"""
import numpy as np
import pytest
import torch

import jax
import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
from paddle_tpu.models import GPTConfig as JGPTConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
import paddle_tpu_torch as pt
import torch_dist_workers as W

CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
           max_position_embeddings=64, intermediate_size=128)
CLIP = 0.05


def _jax_losses(np_state, ids, mask):
    """The JAX TrainStep on a dp2 x mp2 mesh of 4 CPU devices."""
    paddle.seed(7)
    jm = JGPT(JGPTConfig(**CFG))
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in np_state.items()})
    mesh = jdist.build_mesh({"dp": 2, "mp": 2}, devices=jax.devices()[:4])
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
    cfg = pt.GPTConfig(**CFG)
    tm = pt.GPTForCausalLM(cfg, device="cpu")
    tm.load_state_dict(pt.state_dict_from_paddle(np_state, cfg))
    a, m = torch.from_numpy(ids), torch.from_numpy(mask)
    with torch.no_grad():
        logits = tm(a[:2]).numpy()
    # the clip is active: the first gradient's norm exceeds it
    tm.zero_grad(set_to_none=True)
    tm.loss(a, a, loss_mask=m, chunk_size=8).backward()
    norm = float(torch.sqrt(sum(p.grad.square().sum()
                                for p in tm.parameters())))
    with torch.no_grad():
        halves = [float(tm.loss(a[i:i + 2], a[i:i + 2],
                                loss_mask=m[i:i + 2], chunk_size=8))
                  for i in (0, 2)]
    step = W._adamw_step(tm, CLIP, None)
    losses = [float(step(a, a, m)) for _ in range(3)]
    return losses, {n: p.detach().clone()
                    for n, p in tm.named_parameters()}, norm, halves, logits


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    d = tmp_path_factory.mktemp("gpt_tp")
    paddle.seed(7)
    jm = JGPT(JGPTConfig(**CFG))
    np_state = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    rs = np.random.RandomState(0)
    ids = rs.randint(0, CFG["vocab_size"], (4, 16)).astype(np.int64)
    mask = np.zeros((4, 16), np.float32)
    mask[:2, :14] = 1.0           # the first dp half: 28 tokens
    mask[2, :3] = mask[3, 5:7] = 1.0   # the second: 5
    np.savez(d / "inputs.npz", ids=ids, mask=mask, clip=CLIP,
             **{f"cfg_{k}": v for k, v in CFG.items()},
             **{f"state:{k}": v for k, v in np_state.items()})
    W.run(W.gpt_tp, d)
    ranks = [dict(np.load(d / f"rank{r}.npz")) for r in range(W.WORLD)]
    losses, params, norm, halves, logits = _port_single(np_state, ids, mask)
    return dict(ranks=ranks, jax=_jax_losses(np_state, ids, mask),
                single=losses, params=params, norm=norm, halves=halves,
                logits=logits)


def test_mesh_layout_is_mp_fastest(tp):
    coords = [tuple(r["coords"]) for r in tp["ranks"]]
    assert coords == [(0, 0), (0, 1), (1, 0), (1, 1)]


def test_gathered_logits_match_port_single_process(tp):
    for r in tp["ranks"]:
        np.testing.assert_allclose(r["logits"], tp["logits"], rtol=1e-5,
                                   atol=1e-5)


def test_losses_match_jax_mesh_step(tp):
    np.testing.assert_allclose(tp["ranks"][0]["losses"], tp["jax"],
                               rtol=3e-4)


def test_losses_match_port_single_process_and_every_rank(tp):
    for r in tp["ranks"]:
        np.testing.assert_array_equal(r["losses"], tp["ranks"][0]["losses"])
    np.testing.assert_allclose(tp["ranks"][0]["losses"], tp["single"],
                               rtol=1e-5)


def test_the_loss_is_the_global_masked_mean(tp):
    """The uneven mask makes the mean of the halves' means differ from
    the global masked mean by far more than the limit."""
    first = tp["single"][0]
    assert abs(np.mean(tp["halves"]) - first) > 100 * 1e-5 * abs(first)
    assert tp["norm"] > CLIP      # and the clip was active


def test_params_match_port_single_process(tp):
    for r in tp["ranks"]:
        for n, want in tp["params"].items():
            np.testing.assert_allclose(r["param:" + n], want.numpy(),
                                       atol=1e-5, rtol=0, err_msg=n)


def test_replicated_params_bitwise_equal_across_mp(tp):
    rk = tp["ranks"]
    names = [k for k in rk[0] if k.startswith("local:")]
    assert "local:gpt.ln_f.weight" in names and \
        "local:gpt.h.0.attn.out.bias" in names
    for a, b in ((0, 1), (2, 3)):
        for k in names:
            np.testing.assert_array_equal(rk[a][k], rk[b][k], err_msg=k)


def test_dropout_masks_equal_across_mp_differ_across_dp(tp):
    rk = tp["ranks"]
    np.testing.assert_array_equal(rk[0]["drop"], rk[1]["drop"])
    np.testing.assert_array_equal(rk[2]["drop"], rk[3]["drop"])
    assert (rk[0]["drop"] != rk[2]["drop"]).any()
    assert (rk[0]["drop"][0] != rk[0]["drop"][1]).any()


def test_shard_gather_round_trip_bitwise(tp):
    for r in tp["ranks"]:
        assert bool(r["roundtrip_bitwise"])
        assert bool(r["splits_match"])


def test_contiguous_qkv_split_control_fails_parity(tp):
    """qkv cut as a contiguous third of 3H (the JAX PartitionSpec's tiling
    of the global array) gives another model: its loss misses the
    one-process loss by far more than the parity limit."""
    first = tp["single"][0]
    good = abs(tp["ranks"][0]["losses"][0] - first) / abs(first)
    bad = abs(float(tp["ranks"][0]["control_loss"]) - first) / abs(first)
    assert good <= 1e-5 < bad
    assert bad > 100 * max(good, 1e-8)


def test_no_rank_imported_jax(tp):
    for r in tp["ranks"]:
        assert r["foreign_modules"].size == 0, r["foreign_modules"]


def test_recompute_with_dropout_replays_under_tp(tp):
    """A recomputed block reruns its row-parallel all-reduces in the
    backward and replays its dropout masks: loss and every gradient equal
    the run without recompute (a mask drawn anew would move them by
    O(1))."""
    for r in tp["ranks"]:
        assert float(r["recompute_max_diff"]) <= 1e-6


def test_rng_tracker_streams(tp):
    """GLOBAL_RNG draws the same on every mp rank and differs across dp;
    MODEL_PARALLEL_RNG differs on every rank; the default stream is left
    as it was."""
    rk = tp["ranks"]
    np.testing.assert_array_equal(rk[0]["rng_global"], rk[1]["rng_global"])
    assert (rk[0]["rng_global"] != rk[2]["rng_global"]).any()
    local = [tuple(r["rng_local"]) for r in rk]
    assert len(set(local)) == len(rk)
    assert all(bool(r["rng_default_kept"]) for r in rk)


def test_grad_scaler_skips_on_every_rank_when_one_overflows(tp):
    """Only rank 0's gradients overflow; the found-inf flag is max-reduced
    over the world, so every rank skips the update and halves its scale."""
    for r in tp["ranks"]:
        assert bool(r["scaler_skipped"])
        assert float(r["scaler_scale"]) == 512.0
