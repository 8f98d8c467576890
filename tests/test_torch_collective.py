"""PyTorch port vs JAX package: the collectives, per process, against the
JAX package's stacked-rank view.

The JAX collectives run here on a stacked [4, ...] array over
`dist.build_mesh({"world": 4}, devices=jax.devices()[:4])` (row r is rank
r's tensor); the port's run on 4 CPU ranks (gloo), rank r holding row r.
Rank r's result must equal row r of the JAX result (bitwise for the data
movers; 1e-6 relative for the reductions, whose summation order may
differ). The mp-axis collectives of a dp2 x mp2 mesh are held against the
JAX ones over each mp pair.
"""
import numpy as np
import pytest

import jax
from paddle_tpu.core.tensor import Tensor
import paddle_tpu.distributed as jdist
from paddle_tpu.distributed.collective import Group
import torch_dist_workers as W

G = W.WORLD


def _x():
    return np.random.RandomState(3).uniform(0.5, 1.5, (G, G, 6)).astype(
        np.float32)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("collective")
    np.savez(d / "inputs.npz", x=_x())
    W.run(W.collectives, d)
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(G)]


def _group(n=G):
    return Group(jdist.build_mesh({"world": n}, devices=jax.devices()[:n]),
                 "world")


def _inplace(fn, x, **kw):
    t = Tensor(x)
    fn(t, **kw)
    return np.asarray(t._data)


def _jax(x):
    g = _group()
    out = {f"all_reduce_{op}": _inplace(jdist.all_reduce, x, op=op, group=g)
           for op in ("sum", "max", "min", "prod", "avg")}
    gathered = np.asarray(jdist.all_gather(Tensor(x), group=g)._data)
    out["all_gather"] = np.stack([gathered] * G)
    out["all_gather_list"] = out["all_gather"]
    out["broadcast"] = _inplace(jdist.broadcast, x, src=2, group=g)
    for op in ("sum", "max"):
        out[f"reduce_{op}"] = _inplace(jdist.reduce, x, dst=1, op=op, group=g)
    flat = x.reshape(G, G * 6)
    rs = _inplace(jdist.reduce_scatter, flat, group=g).reshape(G, 1, 6)
    out["reduce_scatter"] = rs
    out["reduce_scatter_list"] = rs[:, 0]
    out["alltoall"] = np.asarray(jdist.alltoall(Tensor(x), group=g)._data)
    out["alltoall_list"] = out["alltoall"]
    out["scatter"] = np.stack([_inplace(jdist.scatter, x, src=3,
                                        group=g)[r] for r in range(G)])
    sc0 = _inplace(jdist.scatter, x, src=0, group=g)
    out["scatter_list"] = sc0[:, 0]
    # the ring of point-to-point messages through the JAX mailbox
    for r in range(G):
        jdist.send(Tensor(x[r, 0]), dst=(r + 1) % G, src_rank=r)
    p2p = []
    for r in range(G):
        t = Tensor(np.zeros(6, np.float32))
        jdist.recv(t, src=(r - 1) % G, rank=r)
        p2p.append(np.asarray(t._data))
    out["p2p"] = np.stack(p2p)
    # the mp axis of dp2 x mp2: pairs (0, 1) and (2, 3)
    g2 = _group(2)
    mp = {"mp_all_reduce": [], "mp_all_gather": [], "mp_reduce_scatter": [],
          "mp_broadcast": []}
    for pair in ((0, 1), (2, 3)):
        xs = x[list(pair)]
        mp["mp_all_reduce"] += list(_inplace(jdist.all_reduce, xs, group=g2))
        ag = np.asarray(jdist.all_gather(Tensor(xs), group=g2)._data)
        mp["mp_all_gather"] += [ag, ag]
        mp["mp_reduce_scatter"] += list(_inplace(
            jdist.reduce_scatter, xs.reshape(2, G * 6), group=g2).reshape(
                2, 2, 6))
        mp["mp_broadcast"] += list(_inplace(jdist.broadcast, xs, src=1,
                                            group=g2))
    out.update({k: np.stack(v) for k, v in mp.items()})
    return out


@pytest.fixture(scope="module")
def want():
    return _jax(_x())


_MOVERS = ("all_gather", "all_gather_list", "broadcast", "alltoall",
           "alltoall_list", "scatter", "scatter_list", "p2p",
           "mp_all_gather", "mp_broadcast")
_REDUCERS = ("all_reduce_sum", "all_reduce_max", "all_reduce_min",
             "all_reduce_prod", "all_reduce_avg", "reduce_sum", "reduce_max",
             "reduce_scatter", "reduce_scatter_list", "mp_all_reduce",
             "mp_reduce_scatter")


@pytest.mark.parametrize("name", _MOVERS)
def test_data_movers_match_jax_rows(ranks, want, name):
    for r in range(G):
        np.testing.assert_array_equal(ranks[r][name], want[name][r],
                                      err_msg=f"rank {r}")


@pytest.mark.parametrize("name", _REDUCERS)
def test_reductions_match_jax_rows(ranks, want, name):
    for r in range(G):
        np.testing.assert_allclose(ranks[r][name], want[name][r], rtol=1e-6,
                                   err_msg=f"rank {r}")


def test_reduce_leaves_other_ranks_unchanged(ranks):
    x = _x()
    for r in (0, 2, 3):
        np.testing.assert_array_equal(ranks[r]["reduce_sum"], x[r])


def test_mesh_groups_run_mp_fastest(ranks):
    for r in range(G):
        assert tuple(ranks[r]["coords"]) == (r // 2, r % 2)
        assert list(ranks[r]["mp_ranks"]) == [r - r % 2, r - r % 2 + 1]
        assert list(ranks[r]["dp_ranks"]) == [r % 2, r % 2 + 2]
