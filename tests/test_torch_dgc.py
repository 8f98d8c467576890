"""PyTorch port vs JAX package: DGC's top-k sparsified exchange
(distributed/dgc.py) on 2 CPU ranks over gloo, and recompute_sequential /
recompute_hybrid (distributed/recompute.py).

The ranks (tests/torch_dist_workers.py, which imports no JAX) run
`sparse_allreduce` on their own tensors and residuals, the dense
all-reduce of the same top-k entries (the control), and 3 DGC steps of a
linear model (`dgc_value_and_grad`, the error feedback carried); the
parent runs the JAX functions on a 2-device mesh from the same numbers.
Tolerances: the sparse sum and the kept residuals bitwise equal to the
JAX function's (distinct top-k entries, a sum of at most 2 values a
position); the dense control bitwise equal to the sparse sum; DGC's
gradients, residuals and losses within 1e-6 of the JAX step (f32
reductions in another order). recompute_sequential's loss and gradients
bitwise equal to the plain forward's (the same operations rerun).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import paddle_tpu.distributed as jdist
import paddle_tpu_torch.distributed as D
import torch_dist_workers as W

SPARSITY = 0.75
DGC_SPARSITY = 0.5


def _jax_sparse(x, res):
    from jax import shard_map
    mesh = jdist.build_mesh({"dp": 2}, devices=jax.devices()[:2])

    def f(a, r):
        s, kept = jdist.sparse_allreduce(a[0], "dp", SPARSITY, residual=r[0])
        return s[None], kept[None]

    s, kept = shard_map(f, mesh=mesh, axis_names={"dp"},
                        in_specs=(P("dp"), P("dp")),
                        out_specs=(P("dp"), P("dp")),
                        check_vma=False)(jnp.asarray(x), jnp.asarray(res))
    return np.asarray(s), np.asarray(kept)


def _jax_dgc(bx, by):
    mesh = jdist.build_mesh({"dp": 2}, devices=jax.devices()[:2])

    def loss_fn(params, batch):
        xb, yb = batch
        return jnp.mean((xb @ params[0] - yb) ** 2)

    w, resid, out = [jnp.zeros((4, 1), jnp.float32)], None, []
    with jdist.mesh_scope(mesh):
        for _ in range(3):
            loss, grads, resid = jdist.dgc_value_and_grad(
                loss_fn, w, (jnp.asarray(bx), jnp.asarray(by)),
                sparsity=DGC_SPARSITY, residuals=resid, mesh=mesh)
            out.append((float(loss), np.asarray(grads[0]),
                        np.asarray(resid[0])))
            w = [p - 0.1 * g for p, g in zip(w, grads)]
    return out


@pytest.fixture(scope="module")
def dgc(tmp_path_factory):
    d = tmp_path_factory.mktemp("dgc")
    rs = np.random.RandomState(0)
    x = rs.randn(2, 6, 5).astype(np.float32)
    res = (0.3 * rs.randn(2, 6, 5)).astype(np.float32)
    bx = rs.randn(8, 4).astype(np.float32)
    by = (bx @ rs.randn(4, 1)).astype(np.float32)
    np.savez(d / "inputs.npz", x=x, res=res, bx=bx, by=by,
             sparsity=SPARSITY, dgc_sparsity=DGC_SPARSITY)
    W.run(W.dgc_exchange, d, nprocs=2)
    ranks = [dict(np.load(d / f"rank{r}.npz")) for r in range(2)]
    return dict(ranks=ranks, jax_sparse=_jax_sparse(x, res),
                jax_dgc=_jax_dgc(bx, by))


def test_sparse_allreduce_bitwise_vs_jax(dgc):
    s, kept = dgc["jax_sparse"]
    for r, rec in enumerate(dgc["ranks"]):
        np.testing.assert_array_equal(rec["sparse"], s[r])
        np.testing.assert_array_equal(rec["kept"], kept[r])


def test_sparse_sum_equals_dense_all_reduce_of_the_top_k(dgc):
    for rec in dgc["ranks"]:
        np.testing.assert_array_equal(rec["sparse"], rec["dense_control"])
        # error feedback: sent + kept is what the rank contributed
        assert np.count_nonzero(rec["kept"]) == \
            30 - int(30 * (1 - SPARSITY))


def test_dgc_value_and_grad_follows_jax(dgc):
    for i, (loss, grad, _) in enumerate(dgc["jax_dgc"]):
        for rec in dgc["ranks"]:
            np.testing.assert_allclose(rec["dgc:losses"][i], loss,
                                       rtol=1e-6)
            np.testing.assert_allclose(rec[f"dgc{i}:grad"], grad,
                                       atol=1e-6, rtol=1e-6)


def test_dgc_residuals_are_each_ranks_own_row(dgc):
    """The JAX package stacks the residuals [D, ...]; rank r's is row r."""
    for i, (_, _, resid) in enumerate(dgc["jax_dgc"]):
        for r, rec in enumerate(dgc["ranks"]):
            np.testing.assert_allclose(rec[f"dgc{i}:residual"], resid[r],
                                       atol=1e-6, rtol=1e-6)


def test_no_rank_imported_jax(dgc):
    for rec in dgc["ranks"]:
        assert rec["foreign_modules"].size == 0, rec["foreign_modules"]


def _seq(seed=0):
    torch.manual_seed(seed)
    return torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.Tanh(),
                               torch.nn.Linear(16, 16), torch.nn.GELU(),
                               torch.nn.Linear(16, 4))


@pytest.mark.parametrize("segments", [1, 2, 3, 5])
def test_recompute_sequential_grads_equal_plain(segments):
    x = torch.from_numpy(np.random.RandomState(1).randn(3, 8).astype(
        np.float32)).requires_grad_(True)
    m = _seq()
    plain = m(x).square().sum()
    want = torch.autograd.grad(plain, [x, *m.parameters()])
    got_loss = D.recompute_sequential({"segments": segments}, m,
                                      x).square().sum()
    got = torch.autograd.grad(got_loss, [x, *m.parameters()])
    assert torch.equal(got_loss, plain)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_recompute_hybrid_is_recompute():
    x = torch.from_numpy(np.random.RandomState(2).randn(3, 8).astype(
        np.float32)).requires_grad_(True)
    m = _seq(1)
    want = torch.autograd.grad(m(x).sum(), [x, *m.parameters()])
    got = torch.autograd.grad(D.recompute_hybrid({"mp_group": None}, m,
                                                 x).sum(),
                              [x, *m.parameters()])
    for a, b in zip(got, want):
        assert torch.equal(a, b)
