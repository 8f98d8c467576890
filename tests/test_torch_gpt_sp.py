"""PyTorch port vs JAX package: sequence-parallel GPT training across 2
and 4 CPU ranks (gloo): `GPTConfig(sequence_parallel=)`, the sp rank's
positions cut in `GPTModel.forward` and `loss`, the token group's loss
count and gradient average in `TrainStep(mesh=)`.

The model is tests/test_sequence_parallel.py::test_gpt_step_with_sp_axis's
config (vocab 128, hidden 32, 2 layers, 4 heads, 32 positions,
intermediate 64), built in the JAX package; its weights go to the ranks
through `shard_state_from_paddle`. 3 AdamW steps (weight decay 0.01,
ClipGradByGlobalNorm active) on a global batch of 4 rows x 16 positions
whose loss mask is uneven across the two sp halves, so a mean of the
halves' means would differ from the global masked mean. Legs: {"sp": 2}
with the ring and with Ulysses, {"dp": 2, "sp": 2} and {"sp": 2, "mp":
2} with the ring. Limits: losses 1e-5 relative against the JAX
TrainStep on the same mesh and against the port's one-process step;
gathered parameters within 1e-4 of each tensor's largest entry of the
one-process step's; replicated parameters bitwise equal across the sp
ranks. The ranks run in tests/torch_dist_workers.py, which imports no
JAX.
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

CFG = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
           max_position_embeddings=32, intermediate_size=64)
CLIP = 0.05
# tag: (mesh axes, schedule, world)
LEGS = {"sp2_ring": ({"sp": 2}, "ring", 2),
        "sp2_ulysses": ({"sp": 2}, "ulysses", 2),
        "dp2_sp2": ({"dp": 2, "sp": 2}, "ring", 4),
        "sp2_mp2": ({"sp": 2, "mp": 2}, "ring", 4)}


def _jax_losses(np_state, ids, mask, axes, schedule):
    """The JAX TrainStep on the mesh `axes` of CPU devices."""
    paddle.seed(7)
    jm = JGPT(JGPTConfig(**CFG, sequence_parallel=schedule))
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in np_state.items()})
    n = int(np.prod(list(axes.values())))
    mesh = jdist.build_mesh(axes, devices=jax.devices()[:n])
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
        halves = [float(tm.loss(a[:, i:i + 8], a[:, i:i + 8],
                                loss_mask=m[:, i:i + 8], chunk_size=8))
                  for i in (0, 8)]
    step = W._adamw_step(tm, CLIP, None)
    losses = [float(step(a, a, m)) for _ in range(3)]
    return losses, {n: p.detach().clone()
                    for n, p in tm.named_parameters()}, halves


@pytest.fixture(scope="module")
def sp(tmp_path_factory):
    paddle.seed(7)
    jm = JGPT(JGPTConfig(**CFG))
    np_state = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    rs = np.random.RandomState(0)
    ids = rs.randint(0, CFG["vocab_size"], (4, 16)).astype(np.int64)
    mask = np.zeros((4, 16), np.float32)
    mask[:, :7] = 1.0                 # the first sp half: 28 tokens
    mask[0, 9] = mask[3, 12:14] = 1.0  # the second: 3
    runs = {}
    for n in (2, 4):
        d = tmp_path_factory.mktemp(f"gpt_sp{n}")
        np.savez(d / "inputs.npz", ids=ids, mask=mask, clip=CLIP,
                 **{f"cfg_{k}": v for k, v in CFG.items()},
                 **{f"state:{k}": v for k, v in np_state.items()})
        runs[n] = (d, W.start(W.gpt_sp, d, nprocs=n))
    try:
        losses, params, halves = _port_single(np_state, ids, mask)
        jax_losses = {tag: _jax_losses(np_state, ids, mask, axes, sch)
                      for tag, (axes, sch, _) in LEGS.items()
                      if tag != "sp2_ulysses"}
    finally:
        for _, ctx in runs.values():
            W.wait(ctx)
    ranks = {n: [dict(np.load(d / f"rank{r}.npz")) for r in range(n)]
             for n, (d, _) in runs.items()}
    return dict(ranks=ranks, jax=jax_losses, single=losses, params=params,
                halves=halves)


def _legs(sp, tag):
    return sp["ranks"][LEGS[tag][2]]


@pytest.mark.parametrize("tag", [t for t in LEGS if t != "sp2_ulysses"])
def test_losses_match_jax_mesh_step(sp, tag):
    np.testing.assert_allclose(_legs(sp, tag)[0][tag + ":losses"],
                               sp["jax"][tag], rtol=1e-5)


@pytest.mark.parametrize("tag", list(LEGS))
def test_losses_match_port_single_process_on_every_rank(sp, tag):
    for r in _legs(sp, tag):
        np.testing.assert_allclose(r[tag + ":losses"], sp["single"],
                                   rtol=1e-5)


def test_the_loss_is_the_global_masked_mean(sp):
    """The uneven mask makes the mean of the sp halves' means differ from
    the global masked mean by far more than the limit."""
    first = sp["single"][0]
    assert abs(np.mean(sp["halves"]) - first) > 100 * 1e-5 * abs(first)


@pytest.mark.parametrize("tag", list(LEGS))
def test_gathered_params_match_port_single_process(sp, tag):
    for r in _legs(sp, tag):
        for n, want in sp["params"].items():
            want = want.numpy()
            err = np.abs(r[f"{tag}:param:{n}"] - want).max()
            assert err <= 1e-4 * np.abs(want).max(), (n, err)


@pytest.mark.parametrize("tag", list(LEGS))
def test_replicated_params_bitwise_equal_across_sp(sp, tag):
    rk = _legs(sp, tag)
    axes = list(LEGS[tag][0])
    spi = axes.index("sp")
    names = [k for k in rk[0] if k.startswith(tag + ":local:")]
    assert any(k.endswith("gpt.ln_f.weight") for k in names)
    for a in range(len(rk)):
        for b in range(a + 1, len(rk)):
            ca, cb = rk[a][tag + ":coords"], rk[b][tag + ":coords"]
            if all(ca[i] == cb[i] for i in range(len(axes)) if i != spi):
                for k in names:
                    np.testing.assert_array_equal(rk[a][k], rk[b][k],
                                                  err_msg=k)


def test_ranks_import_no_jax(sp):
    for n in (2, 4):
        for r in sp["ranks"][n]:
            assert r["foreign_modules"].size == 0


class _Group:
    """A stand-in for a process group of two ranks (no collective runs
    before the refusals)."""
    nranks, rank, ranks = 2, 0, [0, 1]


def test_refusals_under_an_sp_axis():
    """sequence_parallel=None under an sp axis (the JAX package's dense
    attention over gathered K/V) and grad_comm / ZeRO on a mesh with sp
    are refused, naming their queue item; an unknown schedule raises."""
    from paddle_tpu_torch.distributed.mesh import Mesh, mesh_scope
    mesh = Mesh({"sp": 2}, 0, {"sp": _Group()})
    with mesh_scope(mesh):
        with pytest.raises(NotImplementedError, match="A4"):
            pt.GPTForCausalLM(pt.GPTConfig(**CFG, sequence_parallel=None),
                              device="cpu")
    with pytest.raises(ValueError, match="schedule"):
        pt.GPTConfig(**CFG, sequence_parallel="zigzag")
    one = Mesh({"dp": 1, "sp": 1}, 0, {})
    m = pt.GPTForCausalLM(pt.GPTConfig(**CFG), device="cpu")
    opt = pt.AdamW(1e-3, parameters=m.named_parameters(), device="cpu")
    with pytest.raises(NotImplementedError, match="A4"):
        pt.TrainStep(m, opt, lambda a, b: m.loss(a, b), mesh=one,
                     grad_comm="f32", device="cpu")
    opt._sharding_stage = 1
    with pytest.raises(NotImplementedError, match="A4"):
        pt.TrainStep(m, opt, lambda a, b: m.loss(a, b), mesh=one,
                     device="cpu")
