"""PyTorch port vs JAX package: the tensor-parallel mpu layers and the
vocab-parallel route of the fused linear cross-entropy (#11).

The JAX layers (ColumnParallelLinear -> relu -> RowParallelLinear,
VocabParallelEmbedding, ParallelCrossEntropy, fused_linear_cross_entropy)
run without a mesh, dense, as tests/test_distributed.py's TestTensorParallel
runs them: they are the reference. The port's layers run sharded on 4 CPU
ranks (gloo) at mp 2 (a dp2 x mp2 mesh) and mp 4, each rank loading its
shards of the JAX weights; their outputs and their gathered gradients are
held to the JAX ones within 1e-5 (f32). The merge of the vocab-parallel
route runs here on in-process shards too: labels in every shard, an
ignored label, and a control that drops one shard.
"""
import json

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
from paddle_tpu.incubate.nn.functional import fused_linear_cross_entropy
import paddle_tpu_torch as pt
from paddle_tpu_torch.distributed import mpu
from paddle_tpu_torch.ops import linear_ce as LC
import torch_dist_workers as W

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs():
    rs = np.random.RandomState(11)
    f = lambda *s: rs.randn(*s).astype(np.float32)   # noqa: E731
    v, h, t = 64, 16, 16
    return dict(
        w1=f(8, 16) * 0.3, b1=f(16) * 0.1, w2=f(16, 8) * 0.3, b2=f(8) * 0.1,
        x=f(4, 8), dy=f(4, 8),
        emb=f(32, 8), ids=np.array([[0, 9, 17, 31, 8], [24, 16, 7, 15, 23]]),
        de=f(2, 5, 8),
        logits=f(4, 12), labels=np.array([1, 5, -100, 11]),
        head=f(v, h) * 0.2, hx=f(t, h),
        # a label in each quarter of the vocabulary, every shard of mp 4
        hlabels=(np.arange(t) * 7 + 3) % v, hg=f(t))


def _jax(inp):
    """The dense JAX layers' outputs and gradients."""
    t = lambda a: paddle.to_tensor(a, stop_gradient=False)   # noqa: E731
    out = {}
    fc1 = jdist.ColumnParallelLinear(8, 16, gather_output=False)
    fc2 = jdist.RowParallelLinear(16, 8, input_is_parallel=True)
    fc1.weight.set_value(inp["w1"])
    fc1.bias.set_value(inp["b1"])
    fc2.weight.set_value(inp["w2"])
    fc2.bias.set_value(inp["b2"])
    x = t(inp["x"])
    y = fc2(paddle.nn.functional.relu(fc1(x)))
    (y * paddle.to_tensor(inp["dy"])).sum().backward()
    out.update(mlp_y=y.numpy(), mlp_dx=x.grad.numpy(),
               mlp_dw1=fc1.weight.grad.numpy(), mlp_db1=fc1.bias.grad.numpy(),
               mlp_dw2=fc2.weight.grad.numpy(), mlp_db2=fc2.bias.grad.numpy())
    emb = jdist.VocabParallelEmbedding(32, 8)
    emb.weight.set_value(inp["emb"])
    e = emb(paddle.to_tensor(inp["ids"]))
    (e * paddle.to_tensor(inp["de"])).sum().backward()
    out.update(emb=e.numpy(), emb_dw=emb.weight.grad.numpy())
    lg = t(inp["logits"])
    ce = jdist.ParallelCrossEntropy()(lg, paddle.to_tensor(inp["labels"]))
    ce.sum().backward()
    out.update(pce=ce.numpy(), pce_dlogits=lg.grad.numpy())
    for layout in ("vh", "hv"):
        w = t(inp["head"] if layout == "vh" else inp["head"].T.copy())
        hx = t(inp["hx"][None])
        loss = fused_linear_cross_entropy(
            hx, w, paddle.to_tensor(inp["hlabels"][None]), chunk_size=8,
            transpose_weight=layout == "hv")
        (loss * paddle.to_tensor(inp["hg"][None])).sum().backward()
        out.update({f"lce_{layout}": loss.numpy()[0],
                    f"lce_{layout}_dx": hx.grad.numpy()[0],
                    f"lce_{layout}_dw": w.grad.numpy()})
    return out


@pytest.fixture(scope="module")
def mpu_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("mpu")
    inp = _inputs()
    np.savez(d / "inputs.npz", **inp)
    W.run(W.mpu_layers, d)
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(W.WORLD)], \
        _jax(inp)


_KEYS = {"mlp": ("mlp_y", "mlp_dx", "mlp_dw1", "mlp_db1", "mlp_dw2",
                 "mlp_db2"),
         "embedding": ("emb", "emb_dw"),
         "parallel_ce": ("pce", "pce_dlogits"),
         "linear_ce_vh": ("lce_vh", "lce_vh_dx", "lce_vh_dw"),
         "linear_ce_hv": ("lce_hv", "lce_hv_dx", "lce_hv_dw")}


@pytest.mark.parametrize("mp", [2, 4])
@pytest.mark.parametrize("what", sorted(_KEYS))
def test_layers_match_jax(mpu_run, what, mp):
    ranks, ref = mpu_run
    for r in ranks:
        for k in _KEYS[what]:
            np.testing.assert_allclose(r[f"mp{mp}_{k}"], ref[k], **TOL,
                                       err_msg=f"mp{mp} {k}")


@pytest.mark.parametrize("mp", [2, 4])
def test_split_builds_the_parallel_layers(mpu_run, mp):
    """paddle.distributed.split: column (gathered or this rank's slice),
    row and embedding layers, output shapes on every rank."""
    for r in mpu_run[0]:
        assert json.loads(str(r[f"mp{mp}_split_shapes"])) == [
            [4, 16], [4, 16 // mp], [4, 6], [2, 5, 8]]


def test_without_a_mesh_the_layers_are_torch_layers():
    col = mpu.ColumnParallelLinear(8, 12, groups=3, device="cpu")
    row = mpu.RowParallelLinear(12, 8, device="cpu")
    emb = mpu.VocabParallelEmbedding(32, 8, device="cpu")
    assert type(col).__mro__[1] is torch.nn.Linear
    assert col.weight.shape == (12, 8) and row.weight.shape == (8, 12)
    assert emb.weight.shape == (32, 8)
    assert not hasattr(col.weight, "mp_split")
    x = torch.randn(3, 8)
    torch.testing.assert_close(col(x), torch.nn.functional.linear(
        x, col.weight, col.bias), rtol=0, atol=0)


def test_shard_rules_round_trip():
    full = torch.arange(2 * 24 * 3.0).reshape(2, 24, 3)
    for groups in (1, 3):
        for n in (2, 4):
            shards = [mpu.shard_of(full, 1, groups, r, n) for r in range(n)]
            assert torch.equal(mpu.gather_shards(shards, 1, groups), full)
    # qkv: rank r takes heads of each of q, k and v
    qkv = torch.arange(12.0)                  # [3, nh=2, hd=2]
    assert mpu.shard_of(qkv, 0, 3, 1, 2).tolist() == [2, 3, 6, 7, 10, 11]


def _case(t=48, h=32, v=96, seed=5):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(t, h, generator=g)
    w = torch.randn(v, h, generator=g) * 0.3
    labels = torch.arange(t) * 37 % v
    labels[5] = -100                        # an ignored label
    return x, w, labels


@pytest.mark.parametrize("mp", [2, 3, 4])
@pytest.mark.parametrize("layout", ["vh", "hv"])
def test_merge_over_in_process_shards(mp, layout):
    """The merge of the shards' (lse, loss) equals the whole-vocabulary
    route, labels in every shard and one ignored (whose loss is the lse,
    the kernel's rule: it matches no column)."""
    x, w, labels = _case()
    wl = w if layout == "vh" else w.t().contiguous()
    shards = [mpu.shard_of(wl, 0 if layout == "vh" else 1, 1, r, mp)
              for r in range(mp)]
    owner = labels.clamp(min=0) // (w.shape[0] // mp)
    assert set(owner.tolist()) == set(range(mp))
    loss, lse = LC.linear_cross_entropy_shards(x, shards, labels,
                                               w_layout=layout)
    want, want_lse = LC.linear_cross_entropy_reference(
        x, wl, labels, layout, return_lse=True)
    torch.testing.assert_close(loss, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)
    assert float(loss[5]) == pytest.approx(float(lse[5]), abs=1e-6)


def test_merge_control_drops_a_shard():
    x, w, labels = _case()
    shards = [mpu.shard_of(w, 0, 1, r, 4) for r in range(4)]
    lse = torch.stack([LC.linear_cross_entropy_reference(
        x, s, labels - 24 * r, return_lse=True)[1]
        for r, s in enumerate(shards)])
    loss = torch.stack([LC.linear_cross_entropy_reference(
        x, s, labels - 24 * r) for r, s in enumerate(shards)])
    want = LC.linear_cross_entropy_reference(x, w, labels)
    got, _ = LC.vocab_parallel_merge(lse, loss)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    bad, _ = LC.vocab_parallel_merge(lse[1:], loss[1:])
    assert float((bad - want).abs().max()) > 1e-2


def test_merge_matches_jax_fused_linear_ce():
    x, w, labels = _case(seed=6)
    labels[5] = 17                           # the JAX gather wraps -100
    jl = fused_linear_cross_entropy(
        paddle.to_tensor(x.numpy()[None]), paddle.to_tensor(w.numpy()),
        paddle.to_tensor(labels.numpy()[None]), chunk_size=8).numpy()[0]
    shards = [mpu.shard_of(w, 0, 1, r, 4) for r in range(4)]
    loss, _ = LC.linear_cross_entropy_shards(x, shards, labels)
    np.testing.assert_allclose(loss.numpy(), jl, **TOL)


def test_fleet_refuses_later_modes(monkeypatch):
    """Pipeline parallelism stays refused; the sp and ep degrees build
    mesh axes, so fleet.init goes on to join the process group (which
    fails here for want of a rendezvous)."""
    st = pt.fleet.DistributedStrategy()
    st.hybrid_configs = {"pp_degree": 2}
    with pytest.raises(NotImplementedError, match="A4"):
        pt.fleet.init(strategy=st, device="cpu")
    for k in ("MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    for ax in ("sp", "ep"):
        st = pt.fleet.DistributedStrategy()
        st.hybrid_configs = {f"{ax}_degree": 2}
        assert st.mesh_axes() == {ax: 2}
        with pytest.raises(RuntimeError, match="MASTER_ADDR"):
            pt.fleet.init(strategy=st, device="cpu")


def test_init_parallel_env_raises_without_a_card_or_a_rendezvous(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.distributed.init_parallel_env()
    for k in ("MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        pt.distributed.init_parallel_env(device="cpu")
    with pytest.raises(ValueError, match="nccl"):
        pt.distributed.init_parallel_env(device="cpu", backend="nccl")
