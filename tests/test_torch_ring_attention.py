"""PyTorch port vs JAX package: sequence-parallel attention
(`ops.ring_attention`) across 2 and 4 CPU ranks (gloo).

The ranks (tests/torch_dist_workers.py `ring_attention`, no JAX) run ring
and Ulysses attention, causal and not, on their [B, S/sp, H, D] shards of
one set of numpy inputs over an {"sp": n} mesh, and the gradients of
sum(out * dout). The parent runs the JAX `sequence_parallel_attention` on
its 8-device CPU mesh {"dp": 2, "sp": 4}, as tests/test_sequence_parallel
.py builds it, forward and gradients. Tolerance: 1e-5 absolute in f32
(the ring's blocks, merged by log-sum-exp, sum in another order than the
JAX ring's online softmax). Also: Ulysses at 3 heads, which do not divide
by sp, takes the ring (its wire carries point-to-point sends, no
all-to-all); the dense fallback on a mesh without sp; and a control, a
ring whose last forward rotation is dropped, which must fail the limit.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import paddle_tpu.distributed as jdist
from paddle_tpu.ops.ring_attention import (ring_attention,
                                           sequence_parallel_attention)
import torch_dist_workers as W

TOL = 1e-5
WORLDS = (2, 4)
LEGS = [(s, c) for s in ("ring", "ulysses") for c in (False, True)]


def _arrays(b, s, h, d, seed):
    rs = np.random.RandomState(seed)
    return [rs.randn(b, s, h, d).astype(np.float32) for _ in range(4)]


def _jax(q, k, v, do, schedule, causal):
    """The JAX function's output and gradients on the {dp2, sp4} mesh."""
    mesh = jdist.build_mesh({"dp": 2, "sp": 4})
    jdist.set_mesh(mesh)
    try:
        def loss(q, k, v):
            o = sequence_parallel_attention(q, k, v, is_causal=causal,
                                            schedule=schedule)
            return jnp.sum(o * do), o
        (_, o), g = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    finally:
        jdist.set_mesh(None)
    return [np.asarray(t) for t in (o,) + tuple(g)]


@pytest.fixture(scope="module")
def ring(tmp_path_factory):
    q, k, v, do = _arrays(2, 16, 4, 8, 0)
    q3, k3, v3, do3 = _arrays(2, 16, 3, 4, 1)
    runs = {}
    for n in WORLDS:
        d = tmp_path_factory.mktemp(f"ring{n}")
        np.savez(d / "inputs.npz", q=q, k=k, v=v, do=do, q3=q3, k3=k3,
                 v3=v3, do3=do3)
        runs[n] = (d, W.start(W.ring_attention, d, nprocs=n))
    try:
        want = {f"{s}:{int(c)}": _jax(q, k, v, do, s, c) for s, c in LEGS}
        want["ulysses_h3"] = _jax(q3, k3, v3, do3, "ulysses", True)
        want["dense"] = np.asarray(ring_attention(q, k, v, is_causal=True))
    finally:
        for _, ctx in runs.values():
            W.wait(ctx)
    ranks = {n: [dict(np.load(d / f"rank{r}.npz")) for r in range(n)]
             for n, (d, _) in runs.items()}
    return {"ranks": ranks, "want": want}


def _gathered(ranks, key):
    """The ranks' sequence shards joined on dim 1."""
    return np.concatenate([r[key] for r in ranks], axis=1)


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("schedule,causal", LEGS)
def test_output_matches_jax(ring, n, schedule, causal):
    tag = f"{schedule}:{int(causal)}"
    got = _gathered(ring["ranks"][n], tag + ":out")
    np.testing.assert_allclose(got, ring["want"][tag][0], rtol=0, atol=TOL)


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("schedule,causal", LEGS)
def test_gradients_match_jax(ring, n, schedule, causal):
    tag = f"{schedule}:{int(causal)}"
    for i, name in enumerate("qkv"):
        got = _gathered(ring["ranks"][n], f"{tag}:d{name}")
        np.testing.assert_allclose(got, ring["want"][tag][1 + i], rtol=0,
                                   atol=TOL, err_msg=name)


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("schedule,causal", LEGS)
def test_each_schedule_uses_its_collective(ring, n, schedule, causal):
    wire = set(ring["ranks"][n][0][f"{schedule}:{int(causal)}:wire"])
    if schedule == "ring":
        assert wire == {"send/float32"}
    else:
        assert wire == {"all_to_all/float32"}


@pytest.mark.parametrize("n", WORLDS)
def test_ulysses_indivisible_heads_take_the_ring(ring, n):
    rk = ring["ranks"][n]
    assert set(rk[0]["ulysses_h3:wire"]) == {"send/float32"}
    want = ring["want"]["ulysses_h3"]
    np.testing.assert_allclose(_gathered(rk, "ulysses_h3:out"), want[0],
                               rtol=0, atol=TOL)
    for i, name in enumerate("qkv"):
        np.testing.assert_allclose(_gathered(rk, f"ulysses_h3:d{name}"),
                                   want[1 + i], rtol=0, atol=TOL,
                                   err_msg=name)


@pytest.mark.parametrize("n", WORLDS)
def test_no_sp_axis_falls_back_to_dense(ring, n):
    for r in ring["ranks"][n]:
        np.testing.assert_allclose(r["dense:out"], ring["want"]["dense"],
                                   rtol=0, atol=TOL)


@pytest.mark.parametrize("n", WORLDS)
def test_a_ring_missing_one_rotation_fails_the_limit(ring, n):
    got = _gathered(ring["ranks"][n], "control:out")
    err = np.abs(got - ring["want"]["ring:0"][0]).max()
    assert err > 100 * TOL


def test_ranks_import_no_jax(ring):
    for n in WORLDS:
        for r in ring["ranks"][n]:
            assert r["foreign_modules"].size == 0
