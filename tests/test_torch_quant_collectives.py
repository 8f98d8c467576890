"""PyTorch port vs JAX package: the quantized gradient sync
(distributed/quant_collectives.py) and TrainStep(grad_comm=...) on 4 CPU
ranks over gloo.

The functions run in the ranks (tests/torch_dist_workers.py, which
imports no JAX) and in the parent against the JAX package's on its
8-device host mesh. Tolerances:
  * quantize_chunked / dequantize_chunked, the deterministic int8_psum and
    sync_grad_groups' int8 lane: bitwise (the same f32 operations in the
    same order, rounding half to even; the codes' sums are integers);
    sync_grad_groups' f32 lane within 3e-7 relative (a sum of 4 in
    gloo's order, not XLA's);
  * stochastic rounding: the mean of 64 draws within 6 standard errors of
    the deterministic mean, every draw within one code step, and every
    rank's draws bitwise equal (the port draws from its own generator,
    not JAX's keys, so no draw is compared with JAX);
  * build_comm_groups / comm_group_stats: equal;
  * the training step (the tiny GPT, 3 AdamW steps with the clip active,
    one global batch of 4 rows): losses within 3e-4 relative of the JAX
    step on a dp4 mesh in the same mode (the JAX package's own
    mesh-vs-single bound, as in test_torch_gpt_tp), parameters within
    1e-5 absolute of the port's one-process step for "f32" (the order of
    the f32 sums only); "f32" within 1e-6 absolute of grad_comm=None
    (gloo's sum order depends on the buffer's size); "int8" within 1e-2
    absolute of the one-process step, as the JAX int8 test bounds it;
    every rank's parameters bitwise equal after every step;
  * the wire bytes of the int8 sync at least 3.5x under the f32 twin's
    and within 1% of comm_group_stats' figure.
"""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
from paddle_tpu.distributed import quant_collectives as JQ
from paddle_tpu.models import GPTConfig as JGPTConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
import paddle_tpu_torch as pt
from paddle_tpu_torch.distributed import quant_collectives as TQ
import torch_dist_workers as W

CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
           max_position_embeddings=64, intermediate_size=128)
CLIP = 0.05
DRAWS = 64


def _jax_mesh_fn(fn, *stacked, n=4):
    """fn(row...) under shard_map over a dp mesh of n devices; row r of
    each stacked input is device r's; returns row 0 of the output (every
    device holds the same)."""
    from jax import shard_map
    mesh = jdist.build_mesh({"dp": n}, devices=jax.devices()[:n])

    def f(*xs):
        return jax.tree.map(lambda y: y[None], fn(*[x[0] for x in xs]))

    out = shard_map(f, mesh=mesh, axis_names={"dp"},
                    in_specs=tuple(P("dp") for _ in stacked),
                    out_specs=P("dp"), check_vma=False)(*stacked)
    return jax.tree.map(lambda y: np.asarray(y), out)


def _jax_steps(np_state, ids, mode):
    """The JAX TrainStep on a dp4 mesh from the same weights."""
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
        step = paddle.jit.TrainStep(
            jm, opt, lambda a, b: jm.loss(a, b, chunk_size=8), mesh=mesh,
            grad_comm=mode)
        return [float(step(paddle.to_tensor(ids[i]),
                           paddle.to_tensor(ids[i]))) for i in range(3)]
    finally:
        jdist.set_mesh(None)


@pytest.fixture(scope="module")
def qc(tmp_path_factory):
    d = tmp_path_factory.mktemp("quant_collectives")
    paddle.seed(7)
    jm = JGPT(JGPTConfig(**CFG))
    np_state = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    rs = np.random.RandomState(0)
    x = (rs.randn(4, 200) * rs.uniform(0.01, 3.0, (4, 200))).astype(
        np.float32)
    g0 = rs.randn(4, 8, 6).astype(np.float32)
    g1 = rs.randn(4, 6).astype(np.float32)
    g2 = rs.randn(4, 40).astype(np.float32)
    ids = rs.randint(0, CFG["vocab_size"], (3, 4, 16)).astype(np.int64)
    np.savez(d / "inputs.npz", x=x, g0=g0, g1=g1, g2=g2, ids=ids, clip=CLIP,
             draws=DRAWS, **{f"cfg_{k}": v for k, v in CFG.items()},
             **{f"state:{k}": v for k, v in np_state.items()})
    W.run(W.quant_collectives, d)
    ranks = [dict(np.load(d / f"rank{r}.npz")) for r in range(W.WORLD)]
    inp = dict(np.load(d / "inputs.npz"))
    single = W.dp_train(inp, None)
    return dict(ranks=ranks, x=x, g=(g0, g1, g2), ids=ids,
                np_state=np_state, single=single,
                jax={m: _jax_steps(np_state, ids, m) for m in ("f32",
                                                                "int8")})


def test_quantize_chunked_bitwise_vs_jax():
    rs = np.random.RandomState(3)
    x = (rs.randn(3, 333) * rs.uniform(1e-3, 50.0, (3, 333))).astype(
        np.float32)
    for levels, chunk in ((127, 256), (31, 64), (1, 7)):
        jc, js = JQ.quantize_chunked(jnp.asarray(x), chunk=chunk,
                                     levels=levels)
        tc, ts = TQ.quantize_chunked(torch.from_numpy(x), chunk=chunk,
                                     levels=levels)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        jd = JQ.dequantize_chunked(jc, js, x.size, shape=x.shape)
        td = TQ.dequantize_chunked(tc, ts, x.size, shape=x.shape)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    # zeros quantize exactly; the padding never leaks
    zc, zs = TQ.quantize_chunked(torch.zeros(37), chunk=16)
    assert torch.equal(TQ.dequantize_chunked(zc, zs, 37), torch.zeros(37))


def test_stochastic_quantize_unbiased():
    rs = np.random.RandomState(1)
    x = torch.from_numpy(rs.uniform(-1.0, 1.0, 64).astype(np.float32))
    ys = []
    for s in range(512):
        g = torch.Generator().manual_seed(s)
        c, sc = TQ.quantize_chunked(x, chunk=64, stochastic=True,
                                    generator=g)
        ys.append(TQ.dequantize_chunked(c, sc, 64))
    ys = torch.stack(ys)
    scale = float(x.abs().max()) / 127
    assert float((ys - x).abs().max()) <= scale + 1e-7
    assert float((ys.mean(0) - x).abs().max()) <= 6 * scale / 78
    with pytest.raises(ValueError, match="Generator"):
        TQ.quantize_chunked(x, stochastic=True)


def test_int8_psum_bitwise_vs_jax(qc):
    want = _jax_mesh_fn(lambda a: JQ.int8_psum(a, "dp", 4, chunk=16),
                        jnp.asarray(qc["x"]))
    want_sum = _jax_mesh_fn(lambda a: JQ.int8_psum(a, "dp", 4, chunk=16,
                                                   mean=False),
                            jnp.asarray(qc["x"]))
    for r in qc["ranks"]:
        np.testing.assert_array_equal(r["int8_psum"], want[0])
        np.testing.assert_array_equal(r["int8_psum_sum"], want_sum[0])
    # and within half a (shared) scale of the exact mean
    scale = np.abs(qc["x"]).max() / (127 // 4)
    assert np.abs(want[0] - qc["x"].mean(0)).max() <= scale / 2 + 1e-6


def test_stochastic_int8_psum_unbiased_and_equal_on_every_rank(qc):
    rk = qc["ranks"]
    for r in rk[1:]:
        np.testing.assert_array_equal(r["stochastic"], rk[0]["stochastic"])
    draws = rk[0]["stochastic"]                     # [DRAWS, 200]
    x = qc["x"]
    # per-chunk shared scales over 4 ranks; each draw within one code
    # step (of every rank's term) of the mean, and the average unbiased
    pad = np.pad(np.abs(x), ((0, 0), (0, -x.shape[1] % 16)))
    xc = pad.reshape(4, -1, 16).max(axis=(0, 2)) / (127 // 4)
    step = np.repeat(xc, 16)[:x.shape[1]]
    assert np.all(np.abs(draws - x.mean(0)) <= step + 1e-6)
    # a rank's rounding error has variance at most 1/4 of a step squared,
    # so a draw's (the mean of 4) at most step^2 / 16
    sem = step / 4 / np.sqrt(DRAWS)
    assert np.all(np.abs(draws.mean(0) - x.mean(0)) <= 6 * sem + 1e-7)
    # and the draws differ from the deterministic path
    assert not np.array_equal(draws[0], rk[0]["int8_psum"])


def test_sync_grad_groups_bitwise_vs_jax(qc):
    plan = [("a", (0,), (1,)), ("b", (2,), ())]
    g0, g1, g2 = (jnp.asarray(a) for a in qc["g"])
    want = _jax_mesh_fn(lambda a, b, c: JQ.sync_grad_groups(
        [a, b, c], plan, "dp", 4, chunk=16), g0, g1, g2)
    for r in qc["ranks"]:
        # the int8 lane's sums are integers: bitwise
        for k in (0, 2):
            np.testing.assert_array_equal(r[f"sync{k}"], want[k][0])
        # the f32 lane's sum of 4 runs in gloo's order, not XLA's
        np.testing.assert_allclose(r["sync1"], want[1][0], rtol=3e-7,
                                   atol=0)


def test_build_comm_groups_and_stats_equal_jax():
    names = ["gpt.wte.weight", "gpt.h.0.ln_1.weight", "gpt.h.0.ln_1.bias",
             "gpt.h.0.attn.qkv.weight", "gpt.h.0.attn.qkv.bias"]
    shapes = [(128, 64), (64,), (64,), (192, 64), (192,)]
    groups = [("grad:Root/gpt/wte", [0]), ("grad:Root/gpt/h/0/ln_1", [1, 2]),
              ("grad:Root/gpt/h/0/attn/qkv", [3, 4])]
    for fb in (None, lambda n, s: "wte" in n or len(s) <= 1):
        jp = JQ.build_comm_groups(names, shapes, groups, fb)
        tp = TQ.build_comm_groups(names, shapes, groups, fb)
        assert tp == jp
        assert TQ.comm_group_stats(tp, shapes) == \
            JQ.comm_group_stats(jp, shapes)
    for s in ((64,), (), (3, 4)):
        assert TQ.default_f32_fallback("x", s) == \
            JQ.default_f32_fallback("x", s)


def test_grad_comm_losses_follow_jax_step(qc):
    for mode in ("f32", "int8"):
        np.testing.assert_allclose(qc["ranks"][0][f"{mode}:losses"],
                                   qc["jax"][mode], rtol=3e-4)


def test_grad_comm_params_follow_one_process_step(qc):
    _, want, _, _, _ = qc["single"]
    r0 = qc["ranks"][0]
    for n, w in want.items():
        np.testing.assert_allclose(r0[f"f32:param:{n}"], w.numpy(),
                                   atol=1e-5, rtol=0, err_msg=n)
        np.testing.assert_allclose(r0[f"None:param:{n}"], w.numpy(),
                                   atol=1e-5, rtol=0, err_msg=n)
        np.testing.assert_allclose(r0[f"f32:param:{n}"],
                                   r0[f"None:param:{n}"], atol=1e-6,
                                   rtol=0, err_msg=n)
        for mode in ("int8", "int8_sr"):
            np.testing.assert_allclose(r0[f"{mode}:param:{n}"], w.numpy(),
                                       atol=1e-2, rtol=0, err_msg=n)


def test_every_rank_bitwise_after_every_step(qc):
    rk = qc["ranks"]
    for mode in ("None", "f32", "int8", "int8_sr"):
        for r in rk[1:]:
            np.testing.assert_array_equal(r[f"{mode}:digests"],
                                          rk[0][f"{mode}:digests"])


def test_int8_wire_bytes_ratio_and_stats(qc):
    """The f32 twin's gradient all-reduces against the int8 plan's codes
    (int8 on the wire) plus its scales and f32 lane; the loss all-reduce
    (4 bytes a step) is left out of both."""
    r0 = qc["ranks"][0]
    f32 = {k.split("/")[1]: v for k, v in json.loads(
        str(r0["f32:wire"])).items()}
    raw = json.loads(str(r0["int8:wire"]))
    i8 = {"int8": raw["dp:all_reduce/int8"],
          "float32": raw["dp:all_reduce/float32"]}
    loss_bytes = 4 * 3
    f32_bytes = f32["float32"] - loss_bytes
    int8_bytes = i8["int8"] + i8["float32"] - loss_bytes + \
        raw["scale:all_reduce/float32"]
    assert "int8" not in f32 and i8["int8"] > 0
    assert f32_bytes / int8_bytes >= 3.5
    stats = json.loads(str(r0["int8:stats"]))
    # the static figure counts ring terms (2x the payload) for 3 steps
    assert abs(3 * stats["int8_bytes"] / 2 - int8_bytes) <= \
        0.01 * int8_bytes
    assert abs(3 * stats["f32_twin_bytes"] / 2 - f32_bytes) <= \
        0.01 * f32_bytes
    # no quantizable leaf on the f32 lane: the f32 payload is the 1-d
    # leaves' alone
    assert (i8["float32"] - loss_bytes) == 3 * 4 * stats["f32_elems"]


def test_groups_start_in_the_fixed_order(qc):
    """The exchanges start in the units' order, and the ranks compare
    their units when the step is built: equal units pass, units that
    differ on one rank raise on every rank."""
    for r in qc["ranks"]:
        for mode in ("f32", "int8"):
            assert int(r[f"{mode}:groups"]) > 1
        agree = json.loads(str(r["agree"]))
        assert agree["same"] is None
        assert agree["differs"][0] == "RuntimeError" and \
            "different gradient exchange units" in agree["differs"][1]


def test_grad_comm_precondition_errors(qc):
    errs = json.loads(str(qc["ranks"][0]["errors"]))
    assert errs["no_mesh"][0] == "ValueError" and "mesh" in errs["no_mesh"][1]
    assert errs["mode"][0] == "ValueError" and "grad_comm" in errs["mode"][1]
    assert "grad_accum_steps" in errs["accum"][1]
    assert errs["pure"][0] == "ValueError" and "pure" in errs["pure"][1]
    assert errs["data_axes"][0] == "ValueError" and \
        "ONE mesh axis" in errs["data_axes"][1]
    assert errs["zero"][0] == "ValueError" and \
        "ZeRO stage 2" in errs["zero"][1]


def test_no_rank_imported_jax(qc):
    for r in qc["ranks"]:
        assert r["foreign_modules"].size == 0, r["foreign_modules"]
