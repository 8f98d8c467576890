"""PyTorch port vs JAX package: tensor-parallel paged serving,
`ServingConfig(paged=True, shards=N)`, on 2 and 4 CPU ranks (gloo).

The model is tests/test_sharded_serving.py's (V 96, H 32, 2 layers, 4
heads; cap 8, 6 new tokens, kv_block 4), built in the JAX package; its
weights reach every rank through `convert.shard_state_from_paddle`. Each
world size is one spawn of `tests/torch_dist_workers.py`'s
`sharded_serving` (no JAX there): every rank builds the engine, the
leader serves and the followers `follow()`. Tolerances: greedy chains
EXACTLY equal to the JAX engine's at the same shard count and to the
port's one-card engine, for plain, prefix (cold and warm), chunked
prefill, spec decode, int8 KV and int8 weights; every rank's sampled
tokens bitwise equal; exactly 2 * num_layers mp all-reduces a forward
and none in a COW copy; full-width spill payloads that round-trip
bitwise, rehydrate bitwise into a one-card pool and match the one-card
engine's payload within 1e-4 relative (f32; int8 codes: under 1% of
them one unit off), as the JAX suite bounds its shard counts; int8
codes and scales exactly the one-card ones, and a local-absmax control
that is not; compile counters equal to the JAX engine's. A leader that
fails inside an op makes its follower exit non-zero well inside the
group's 30 s timeout.
"""
import json
import multiprocessing
import os
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import ServingConfig as JServingConfig
from paddle_tpu.inference import ServingEngine as JServingEngine
from paddle_tpu.models import GPTConfig as JGPTConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
import paddle_tpu_torch as pt
import paddle_tpu_torch.distributed as D
from paddle_tpu_torch.analysis import ConfigValidationError
import torch_dist_workers as W

CFG = dict(vocab_size=96, hidden_size=32, num_layers=2, num_heads=4,
           max_position_embeddings=64, intermediate_size=64)
WORLDS = (2, 4)
EXACT = [leg[0] for leg in W.SERVE_LEGS if leg[0] != "sampled"]


def _inputs(d, np_state):
    np.savez(d / "inputs.npz", **{f"cfg_{k}": v for k, v in CFG.items()},
             **{f"state:{k}": v for k, v in np_state.items()})


def _jax_legs(jm, n):
    """The JAX engine at `n` shards over the legs' traffic."""
    out = {}
    for name, kw, seed, lens, passes in W.SERVE_LEGS:
        if name == "sampled":
            continue
        old = os.environ.get("PADDLE_TPU_Q8_DECODE_MIN")
        if kw.get("weight_dtype"):
            os.environ["PADDLE_TPU_Q8_DECODE_MIN"] = "1"
        try:
            eng = JServingEngine(jm, JServingConfig(
                **dict(W.SERVE_BASE, shards=n, **kw)))
            prompts = W.serve_prompts(CFG["vocab_size"], lens, seed)
            out[name] = [W.serve_pass(eng, prompts) for _ in range(passes)]
        finally:
            if old is None:
                os.environ.pop("PADDLE_TPU_Q8_DECODE_MIN", None)
    return out


def _port_single(np_state):
    """The port's one-card engine: the legs, the spill payloads and
    engines, the int8 payload, and its pools for cross-count writes."""
    cfg = pt.GPTConfig(**CFG)
    tm = pt.GPTForCausalLM(cfg, device="cpu")
    tm.load_state_dict(pt.state_dict_from_paddle(np_state, cfg))
    out = {"legs": {}}
    bf16 = pt.GPTForCausalLM(cfg, device="cpu")
    bf16.load_state_dict(pt.state_dict_from_paddle(np_state, cfg))
    bf16.to(torch.bfloat16)
    for name, kw, seed, lens, passes in W.SERVE_LEGS + W.BF16_LEGS:
        old = os.environ.get("PADDLE_TPU_Q8_DECODE_MIN")
        if kw.get("weight_dtype"):
            os.environ["PADDLE_TPU_Q8_DECODE_MIN"] = "1"
        try:
            eng = pt.ServingEngine(bf16 if name.startswith("bf16") else tm,
                                   pt.ServingConfig(**W.SERVE_BASE, **kw))
            prompts = W.serve_prompts(CFG["vocab_size"], lens, seed)
            out["legs"][name] = [W.serve_pass(eng, prompts)
                                 for _ in range(passes)]
        finally:
            if old is None:
                os.environ.pop("PADDLE_TPU_Q8_DECODE_MIN", None)
    prompt = W.serve_prompts(CFG["vocab_size"], (8,), 29)[0]
    for cd in (None, "int8"):
        eng = pt.ServingEngine(tm, pt.ServingConfig(
            **W.SERVE_BASE, prefix_cache=True, kv_blocks=48, cache_dtype=cd))
        W.serve_pass(eng, [prompt])
        blk = int(eng._prefix.match(prompt)[0][0])
        out[f"payload_{cd}"] = eng.read_block(blk)
        out[f"engine_{cd}"] = eng
    ids = W.serve_prompts(CFG["vocab_size"], (8, 8, 8), 3)
    for cd in (None, "int8"):
        bpb = pt.BlockPool.for_model(tm, num_blocks=2, block_size=4,
                                     cache_dtype=cd).bytes_per_block
        eng = pt.ServingEngine(tm, pt.ServingConfig(
            **W.SERVE_BASE, prefix_cache=True, kv_blocks=40, cache_dtype=cd,
            prefix_cache_bytes=2 * bpb, spill_host_bytes=(1 << 10) * bpb))
        chains = [W.serve_pass(eng, [p])[0] for p in ids]
        chains.append(W.serve_pass(eng, [ids[0]])[0])
        out[f"evict_{cd}"] = chains
    os.environ["PADDLE_TPU_Q8_DECODE_MIN"] = "1"
    try:
        out["q8"] = tm.quantized_params()
    finally:
        os.environ.pop("PADDLE_TPU_Q8_DECODE_MIN")
    return out


def _jax_compiles(n):
    """The JAX engine's compile counters at `n` shards on a fresh model:
    after a warming pass, then after a second pass."""
    paddle.seed(0)
    jm = JGPT(JGPTConfig(**CFG))
    jm.eval()
    eng = JServingEngine(jm, JServingConfig(
        **dict(W.SERVE_BASE, shards=n, prefix_cache=True, kv_blocks=48)))
    W.serve_pass(eng, W.serve_prompts(CFG["vocab_size"], (8, 7, 3), 19))
    warm = [eng.monitor.compiles, eng.monitor.recompiles]
    W.serve_pass(eng, W.serve_prompts(CFG["vocab_size"], (8, 7, 3), 23))
    return {"warm": warm, "after": [eng.monitor.compiles,
                                    eng.monitor.recompiles]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    paddle.seed(0)
    jm = JGPT(JGPTConfig(**CFG))
    jm.eval()
    np_state = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    ctxs = {}
    for n in WORLDS:            # the ranks run while the parent computes
        d = tmp_path_factory.mktemp(f"sharded{n}")
        _inputs(d, np_state)
        ctxs[n] = (d, D.spawn(W.sharded_serving, args=(str(d),), nprocs=n,
                              join=False))
    out = {"jax": {n: _jax_legs(jm, n) for n in WORLDS},
           "compiles": {n: _jax_compiles(n) for n in WORLDS},
           "single": _port_single(np_state)}
    deadline = time.monotonic() + 240
    for n, (d, ctx) in ctxs.items():
        while not ctx.join(timeout=1):
            assert time.monotonic() < deadline, "the ranks timed out"
        out[n] = [json.loads((d / f"rank{r}.json").read_text())
                  for r in range(n)]
    return out


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("leg", EXACT)
def test_chains_equal_jax_engine_and_one_card(runs, n, leg):
    got = runs[n][0]["legs"][leg]["chains"]
    assert got == runs["jax"][n][leg]
    assert got == runs["single"]["legs"][leg]


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("leg", [leg[0] for leg in W.BF16_LEGS])
def test_bf16_chains_equal_one_card(runs, n, leg):
    """bf16, fp and int8 weights: the row-parallel partial products are
    all-reduced in f32 and rounded once, and the chains equal the port's
    one-card engine's exactly."""
    assert runs[n][0]["legs"][leg]["chains"] == runs["single"]["legs"][leg]


def test_bf16_row_parallel_partial_is_reduced_in_f32():
    """The wide form of the plain int8 GEMM: the f32 accumulator times the
    scale, unrounded; rounding it gives the bf16 result bit for bit."""
    from paddle_tpu_torch.ops.int8_matmul import int8_matmul_reference
    g = torch.Generator().manual_seed(0)
    x = torch.randn(8, 64, generator=g).to(torch.bfloat16)
    q = torch.randint(-127, 128, (32, 64), generator=g, dtype=torch.int8)
    s = torch.rand(32, generator=g) * 0.01
    wide = int8_matmul_reference(x, q, s, "nk", torch.float32)
    assert wide.dtype == torch.float32
    torch.testing.assert_close(wide, (x.float() @ q.float().t()) * s,
                               rtol=0, atol=0)
    assert torch.equal(wide.to(torch.bfloat16),
                       int8_matmul_reference(x, q, s, "nk"))


@pytest.mark.parametrize("n", WORLDS)
def test_reference_generator_runs_on_every_rank(runs, n):
    """`generate_reference` (the probes' goldens: static caches of the
    rank's heads, the gathered table) gives the one-card engine's
    chains."""
    rec = runs[n][0]["legs"]["plain"]
    assert rec["reference"] == runs["single"]["legs"]["plain"][0]
    for r in runs[n]:
        assert any(o[0] == "reference" for o in r["legs"]["plain"]["ops"])


@pytest.mark.parametrize("n", WORLDS)
def test_traffic_reached_its_paths(runs, n):
    legs = runs[n][0]["legs"]
    assert legs["spec"]["counters"]["spec_windows"] > 0
    assert legs["prefix"]["counters"]["prefix_hit"] > 0
    assert legs["prefix"]["chains"][0] == legs["prefix"]["chains"][1]
    assert legs["prefix"]["cow_ops"] >= 1


@pytest.mark.parametrize("n", WORLDS)
def test_every_rank_samples_the_same_tokens(runs, n):
    """Each op's tokens on every rank (greedy and sampled at temperature
    0.9, top-k 20): the logits are replicated and each rank draws from
    the same seeded generator."""
    for leg in W.SERVE_LEGS:
        want = runs[n][0]["legs"][leg[0]]["tokens"]
        assert want
        for r in runs[n][1:]:
            assert r["legs"][leg[0]]["tokens"] == want, leg[0]


@pytest.mark.parametrize("n", WORLDS)
def test_two_all_reduces_a_layer_a_forward_none_in_cow(runs, n):
    L = runs[n][0]["L"]
    for rank in runs[n]:
        for name, rec in rank["legs"].items():
            for op, forwards, made in rec["ops"]:
                if op in ("prefill", "decode", "verify", "reference"):
                    assert made == 2 * L * forwards, (name, op)
                else:
                    assert made == 0, (name, op)
        assert any(o[0] == "cow" for o in rank["legs"]["prefix"]["ops"])


@pytest.mark.parametrize("n", WORLDS)
def test_pools_hold_the_rank_heads_scales_co_sharded(runs, n):
    h, hd = CFG["num_heads"] // n, CFG["hidden_size"] // CFG["num_heads"]
    for rank in runs[n]:
        legs = rank["legs"]
        assert legs["plain"]["pool_shapes"] == [[9, 4, h, hd]] * 2
        assert legs["int8_kv"]["pool_shapes"] == [
            [9, 4, h, hd], [9, 4, h], [9, 4, h, hd], [9, 4, h]]


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("cd", [None, "int8"])
def test_spill_payload_full_width_and_bitwise(runs, n, cd):
    """The leader's payload is the full-width [2L, bs, nh, hd] stack (and
    [2L, bs, nh] scales); written into a fresh block of the sharded pool
    it reads back bitwise, and written into the one-card pool it reads
    back bitwise; its values are the one-card engine's within the shard
    counts' tolerance."""
    rec = runs[n][0][f"spill_{cd}"]
    full = [2 * CFG["num_layers"], 4, CFG["num_heads"],
            CFG["hidden_size"] // CFG["num_heads"]]
    assert rec["shapes"] == ([full, full[:3]] if cd else [full])
    assert rec["round_trip_bitwise"]
    single = runs["single"][f"payload_{cd}"]
    eng = runs["single"][f"engine_{cd}"]
    payload = tuple(torch.tensor(p, dtype=s.dtype)
                    for p, s in zip(rec["payload"], single))
    for a, b in zip(payload, single):
        assert a.shape == b.shape and a.dtype == b.dtype
        if a.dtype == torch.int8:
            assert (a != b).float().mean() < 0.01
        else:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                       atol=1e-5)
    dst = eng._pool.take(1)[0]
    eng._spill_write(dst, payload)
    back = eng.read_block(dst)
    eng._pool.release([dst])
    for a, b in zip(payload, back):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("cd", [None, "int8"])
def test_evict_spill_rehydrate_chains(runs, n, cd):
    rank0 = runs[n][0]
    spill = rank0[f"evict_spill_{cd}"]
    assert spill["chains"] == rank0[f"evict_never_{cd}"]["chains"]
    assert spill["chains"] == runs["single"][f"evict_{cd}"]
    st = spill["stats"]
    assert st["spilled_total"] >= 1 and st["rehydrated_total"] >= 1
    assert st["h2d_copies"] == st["rehydrated_total"] * (2 if cd else 1)


@pytest.mark.parametrize("n", WORLDS)
def test_int8_codes_and_scales_are_the_one_card_ones(runs, n):
    """Row-parallel weights (attn.out, mlp.down) take each row's absmax as
    a max over the mp group: codes and scales equal the one-card payload
    exactly; the rank-local absmax gives other codes."""
    q8, single = runs[n][0]["q8"], runs["single"]["q8"]
    for name, want in single.items():
        if name not in q8:
            continue
        np.testing.assert_array_equal(np.array(q8[name]["codes"]),
                                      want[0].numpy(), err_msg=name)
        np.testing.assert_array_equal(np.array(q8[name]["scale"],
                                               np.float32),
                                      want[1].reshape(-1).numpy(),
                                      err_msg=name)
    ctl = np.array(q8["control_local_absmax_codes"])
    assert (ctl != single["gpt.h.0.attn.out.weight"][0].numpy()).any()


@pytest.mark.parametrize("n", WORLDS)
def test_compile_counters_match_jax_zero_recompiles(runs, n):
    got, want = runs[n][0]["compile"], runs["compiles"][n]
    assert got["warm"] == want["warm"]
    assert got["after"] == want["after"]
    assert got["after"][0] == got["warm"][0] and got["after"][1] == 0
    assert got["statusz"] == got["after"][0]


@pytest.mark.parametrize("n", WORLDS)
def test_memz_owners_and_shards(runs, n):
    m = runs[n][0]["memz"]
    assert "serving_tables" in m["owners"] and "kv_pool" in m["owners"]
    assert m["kv_meta"]["shards"] == n
    assert m["tables"] == CFG["vocab_size"] * CFG["hidden_size"] * 4


def test_two_engines_on_a_dp2_mp2_mesh(runs):
    r0, r2 = runs[4][0], runs[4][2]
    want = runs["single"]["legs"]["plain"][0]
    assert r0["dp2_chains"] == want and r2["dp2_chains"] == want


@pytest.mark.parametrize("n", WORLDS)
def test_validation_words_and_kinds(runs, n):
    errs = runs[n][0]["errors"]
    assert errs["model_degree"][0] == "ValueError" and \
        "mp degree" in errs["model_degree"][1]
    assert errs["more_than_ranks"][0] == "ValueError" and \
        f"needs {2 * n} ranks" in errs["more_than_ranks"][1]
    if n == 4:
        assert errs["heads"][0] == "ValueError" and \
            "num_heads" in errs["heads"][1]
        assert "mesh's mp axis" in errs["mesh_mp"][1]
    for r in runs[n]:
        assert r["errors"] == errs


def test_config_validation_in_one_process():
    with pytest.raises(ValueError, match="shards must be >= 1"):
        pt.ServingConfig(paged=True, shards=0)
    with pytest.raises(ConfigValidationError) as ei:
        pt.ServingConfig(shards=2)
    assert ei.value.finding.code == "sharded_requires_paged"
    m = pt.GPTForCausalLM(pt.GPTConfig(**CFG), device="cpu")
    with pytest.raises(ValueError, match="process group"):
        pt.ServingEngine(m, pt.ServingConfig(**W.SERVE_BASE, shards=2))
    eng = pt.ServingEngine(m, pt.ServingConfig(**W.SERVE_BASE, shards=1))
    assert eng._runner is None and eng.is_leader
    with pytest.raises(RuntimeError, match="follow"):
        eng.follow()


@pytest.mark.parametrize("n", WORLDS)
def test_follower_refuses_to_drive(runs, n):
    for r in runs[n][1:]:
        for key in ("follower_submit", "follower_step"):
            kind, words = r[key]
            assert kind == "RuntimeError" and "follow()" in words


@pytest.mark.parametrize("n", WORLDS)
def test_idle_leader_sends_keepalives(runs, n):
    """While the leader sits idle its keepalive thread sends NOOP headers
    (here every 0.1 s instead of 10 s), so a follower's header wait never
    reaches the group's timeout; every rank counts the same ones."""
    noops = [r["noops"] for r in runs[n]]
    assert noops[0] >= 1 and len(set(noops)) == 1


@pytest.mark.parametrize("n", WORLDS)
def test_no_rank_imported_jax(runs, n):
    for r in runs[n]:
        assert r["foreign_modules"] == []


@pytest.fixture(scope="module")
def failures(tmp_path_factory):
    """Both failure runs at once: two ranks each, started as plain
    processes so each exit code is seen."""
    from paddle_tpu_torch.distributed.spawn import _worker, free_port
    ctx = multiprocessing.get_context("spawn")
    paddle.seed(0)
    jm = JGPT(JGPTConfig(**CFG))
    np_state = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    procs = {}
    t0 = time.monotonic()
    for where in ("after", "before"):
        d = tmp_path_factory.mktemp(f"fail_{where}")
        _inputs(d, np_state)
        procs[where] = (d, [ctx.Process(target=_worker, args=(
            r, W.sharded_leader_fails, 2, free_port(), {},
            (str(d), where))) for r in range(2)])
        for p in procs[where][1]:
            p.start()
    out = {}
    for where, (d, ps) in procs.items():
        for p in ps:
            p.join(90)
            if p.is_alive():
                p.kill()
        out[where] = {"codes": [p.exitcode for p in ps],
                      "seen": [json.loads((d / f"rank{r}.json").read_text())
                               ["seen"] if (d / f"rank{r}.json").exists()
                               else None for r in range(2)]}
    out["seconds"] = time.monotonic() - t0
    return out


def test_leader_failure_after_the_collectives_aborts_the_follower(failures):
    rec = failures["after"]
    assert rec["codes"] == [3, 3]
    assert rec["seen"][0][1] == "injected leader failure"
    assert rec["seen"][1][0] == "LeaderAborted"


def test_leader_failure_before_the_collectives_fails_the_follower(failures):
    """The follower sits in an all-reduce its leader never joins; it
    fails when the leader's process is gone, far inside the group's 30 s
    timeout, and exits non-zero."""
    rec = failures["before"]
    assert rec["codes"] == [3, 3]
    assert rec["seen"][0][1] == "injected leader failure"
    assert rec["seen"][1] is not None
    assert failures["seconds"] < 30


@pytest.mark.parametrize("name, tag", [
    ("_ZN47_GLOBAL__N__9aafbb6f_14_int8_matmul_cu_671d4bdd5i8_wgILi8ELi1ELi2"
     "ELi8EfEEv14CUtensorMap_stS1_PKfPT3_iiiii", "i8_wg<8,f32>"),
    ("_ZN47_GLOBAL__N__9aafbb6f_14_int8_matmul_cu_671d4bdd5i8_wgILi128ELi2EL"
     "i1ELi4E13__nv_bfloat16EEv14CUtensorMap_stS1_PKfPT3_iiiii",
     "i8_wg<128,bf16>")])
def test_smoke_tags_both_y_forms_of_the_int8_kernel(name, tag):
    """chip_smoke.py's SASS and spill checks name #5's instantiations by
    their y type too, so an f32-y form that spilled could not hide behind
    its bf16 twin's tag; every one must spill nothing."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_tags", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    assert cs.redesigned(name) == tag
    assert cs.spill_free(tag) is True
