"""PyTorch port vs JAX package: the paged continuous-batching engine.

The same small f32 GPT (2 layers, H=64, 4 heads, vocab 128) serves the
same numpy prompts through the port's ServingEngine (CPU route), the JAX
package's ServingEngine and JAX `generate_static_ragged`; greedy token
chains must be equal per request.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import ServingConfig as JServingConfig
from paddle_tpu.inference import ServingEngine as JServingEngine
from paddle_tpu.models import GPTConfig as JGPTConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
import paddle_tpu_torch as pt

CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
           max_position_embeddings=64, intermediate_size=128)
CAP, NEW = 8, 6
LENS = [CAP, 5, 3, 7, 2]


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JGPT(JGPTConfig(**CFG))
    jm.eval()
    np_state = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    cfg = pt.GPTConfig(**CFG)
    tm = pt.GPTForCausalLM(cfg, device="cpu")
    tm.load_state_dict(pt.state_dict_from_paddle(np_state, cfg))
    return jm, tm


def _prompts(lens, seed=1):
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, CFG["vocab_size"], (len(lens), CAP)).astype(
        np.int64)
    for r, ln in enumerate(lens):
        ids[r, ln:] = 0
    return ids


def _config(**kw):
    base = dict(max_batch=2, prompt_cap=CAP, max_new_tokens=NEW,
                decode_chunk=2, paged=True, kv_block=4)
    base.update(kw)
    return base


def _serve(engine, ids, lens, budgets=None):
    """Submit every prompt (budgets[i] new tokens), drain, and return the
    finished requests keyed by prompt row."""
    for i, ln in enumerate(lens):
        engine.submit(ids[i, :ln], max_new_tokens=None if budgets is None
                      else budgets[i])
    done = engine.drain()
    assert [r.status for r in done] == ["done"] * len(lens)
    return {_row_of(ids, lens, r.prompt): r for r in done}


def _row_of(ids, lens, prompt):
    prompt = np.asarray(prompt.tolist() if hasattr(prompt, "tolist")
                        else prompt)
    return next(i for i in range(len(lens))
                if np.array_equal(ids[i, :lens[i]], prompt))


@pytest.mark.parametrize("cache_dtype", [None, "int8"])
def test_engine_splice_matches_jax_engine_and_static_ragged(models,
                                                            cache_dtype):
    """5 ragged prompts through 2 slots; request 1 has a 2-token budget,
    so its slot frees mid-flight and a queued request is spliced in while
    the co-batched row keeps decoding. Every chain equals JAX
    generate_static_ragged's and the JAX engine's, exactly."""
    jm, tm = models
    ids = _prompts(LENS)
    budgets = [NEW if i != 1 else 2 for i in range(len(LENS))]
    ref = np.asarray(jm.generate_static_ragged(
        paddle.to_tensor(ids), LENS, max_new_tokens=NEW,
        cache_dtype=cache_dtype).numpy())[:, CAP:]
    eng = pt.ServingEngine(tm, pt.ServingConfig(
        **_config(cache_dtype=cache_dtype)))
    got = _serve(eng, ids, LENS, budgets)
    jgot = _serve(JServingEngine(jm, JServingConfig(
        **_config(cache_dtype=cache_dtype))), ids, LENS, budgets)
    for i, r in got.items():
        assert r.max_new_tokens == budgets[i]
        np.testing.assert_array_equal(r.tokens, ref[i, :budgets[i]])
        np.testing.assert_array_equal(r.tokens, jgot[i].tokens)
    s = eng.summary()
    assert s["completed_total"] == len(LENS)
    assert s["tokens_out_total"] == sum(budgets)
    assert s["ttft_seconds"]["count"] == len(LENS)
    # every block went back to the free list
    assert eng._pool.free_blocks == eng._pool.capacity_blocks


def test_engine_oversubscribed_pool_waits_not_rejects(models):
    """9 usable blocks (36 rows) where one request needs up to 4 blocks:
    admission waits for freed blocks instead of rejecting."""
    jm, tm = models
    lens = [CAP, 5, 7, 3]
    ids = _prompts(lens)
    ref = np.asarray(jm.generate_static_ragged(
        paddle.to_tensor(ids), lens, max_new_tokens=NEW).numpy())[:, CAP:]
    eng = pt.ServingEngine(tm, pt.ServingConfig(**_config(kv_blocks=10)))
    got = _serve(eng, ids, lens)
    for i, r in got.items():
        np.testing.assert_array_equal(r.tokens, ref[i])
    # a request that could never fit is rejected, not queued
    small = pt.ServingEngine(tm, pt.ServingConfig(**_config(kv_blocks=3)))
    r = small.submit(ids[0, :CAP])
    assert r.status == "rejected" and r.reason == "kv_oom"


def test_engine_eos_early_exit(models):
    jm, tm = models
    lens = [CAP, 5, 3]
    ids = _prompts(lens)
    ref = np.asarray(jm.generate_static_ragged(
        paddle.to_tensor(ids), lens, max_new_tokens=NEW).numpy())
    eos = int(ref[0, CAP])              # row 0 emits EOS as token 1
    refe = np.asarray(jm.generate_static_ragged(
        paddle.to_tensor(ids), lens, max_new_tokens=NEW,
        eos_token_id=eos).numpy())[:, CAP:]
    eng = pt.ServingEngine(tm, pt.ServingConfig(**_config(eos_token_id=eos)))
    got = _serve(eng, ids, lens)
    assert got[0].n_out == 1 and got[0].tokens[0] == eos
    for i, r in got.items():
        np.testing.assert_array_equal(r.tokens[:r.n_out], refe[i][:r.n_out])
    assert eng.summary()["tokens_out_total"] == sum(
        r.n_out for r in got.values())


@pytest.mark.parametrize("field, value", [
    ("prefix_cache", True), ("spec_decode", True), ("prefill_chunk", 4),
    ("shards", 2), ("weight_dtype", "int8")])
def test_later_slice_options_raise(field, value):
    with pytest.raises(NotImplementedError, match=field):
        pt.ServingConfig(**_config(**{field: value}))


def test_padded_engine_is_not_ported(models):
    _, tm = models
    with pytest.raises(NotImplementedError, match="paged=True"):
        pt.ServingEngine(tm, pt.ServingConfig(max_batch=2, prompt_cap=CAP))


def test_synthetic_traffic_matches_jax():
    from paddle_tpu.inference import synthetic_traffic as jtraffic
    for dist in ("uniform", "longtail"):
        a = pt.synthetic_traffic(16, prompt_cap=32, vocab_size=100, seed=3,
                                 length_dist=dist)
        b = jtraffic(16, prompt_cap=32, vocab_size=100, seed=3,
                     length_dist=dist)
        assert [x["at"] for x in a] == [x["at"] for x in b]
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x["prompt"], y["prompt"])


def test_block_pool_matches_jax_allocator():
    """The same alloc/free sequence gives the same table rows, free
    counts and occupancy as the JAX package's BlockPool: LIFO reuse,
    trash block 0 never issued, None (not an error) when blocks run out."""
    from paddle_tpu.inference import BlockPool as JBlockPool
    geo = dict(num_blocks=9, block_size=4, num_layers=1, num_heads=2,
               head_dim=8)
    tp, jp = pt.BlockPool(**geo), JBlockPool(**geo)
    ops = [("alloc", 0, 5), ("alloc", 1, 9), ("free", 0, 0),
           ("alloc", 2, 16), ("alloc", 3, 20), ("free", 1, 0),
           ("alloc", 4, 3), ("alloc", 5, 1)]
    for op, owner, tokens in ops:
        if op == "alloc":
            a, b = tp.alloc(owner, tokens), jp.alloc(owner, tokens)
            assert (a is None) == (b is None)
            if a is not None:
                assert 0 not in a
                np.testing.assert_array_equal(tp.table_row(owner, 6),
                                              jp.table_row(owner, 6))
        else:
            assert tp.free(owner) == jp.free(owner)
        assert tp.free_blocks == jp.free_blocks
        assert tp.occupancy(10) == jp.occupancy(10)
        assert tp.slots_occupancy() == jp.slots_occupancy()
    assert tp.blocks_needed(9) == jp.blocks_needed(9) == 3
    assert tp.fits_ever(32) and not tp.fits_ever(33)
    with pytest.raises(ValueError, match="already holds"):
        tp.alloc(2, 1)
    pools = tp.make_pools()
    assert [tuple(p.shape) for p in pools[0]] == [(9, 4, 2, 8)] * 2
    q8 = pt.BlockPool(**geo, cache_dtype="int8").make_pools()[0]
    assert [tuple(p.shape) for p in q8] == [(9, 4, 2, 8), (9, 4, 2)] * 2
    assert [p.dtype for p in q8] == [torch.int8, torch.float32] * 2


def test_engine_exception_recovers(models, monkeypatch):
    """A decode call dying mid-flight records the in-flight request as an
    error, rebuilds the pools and frees every block; the engine keeps
    serving."""
    _, tm = models
    eng = pt.ServingEngine(tm, pt.ServingConfig(**_config()))
    ids = _prompts([5])
    eng.submit(ids[0, :5])

    def boom(*a, **kw):
        raise RuntimeError("injected device failure")

    with monkeypatch.context() as m:
        m.setattr(tm, "decode_paged", boom)
        with pytest.raises(RuntimeError, match="injected"):
            eng.step()
    s = eng.summary()
    assert s["errors_total"] == 1 and s["inflight"] == 0
    assert eng._pool.free_blocks == eng._pool.capacity_blocks
    eng.submit(ids[0, :5])
    assert [r.status for r in eng.drain()] == ["done"]
