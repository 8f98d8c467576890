"""PyTorch port vs JAX package: the paged engine's host spill tier.

The same small f32 GPT (2 layers, H=64, 4 heads, vocab 128) serves the
same numpy prompts through the port's and the JAX package's paged prefix
engines with `spill_host_bytes` set. Counterparts of the JAX package's
spill-tier tests (tests/test_prefix_cache.py, TestSpillTier): the pool
block round trip is bitwise, evict -> spill -> rehydrate gives the chains
of a never-evicted engine and of the JAX spill engine (fp and int8
pools), a COW after a rehydrate leaves the shared blocks unchanged, the
refcounts are conserved, and the tier drops its LRU spilled blocks under
its own budget; `HostSpillTier.stats()` equals the JAX tier's throughout.
"""
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.inference import ServingConfig as JServingConfig
from paddle_tpu.inference import ServingEngine as JServingEngine
from paddle_tpu.models import GPTConfig as JGPTConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
import paddle_tpu_torch as pt

CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
           max_position_embeddings=64, intermediate_size=128)
CAP, NEW = 8, 6


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


def _bpb(cache_dtype=None):
    return pt.BlockPool(num_blocks=2, block_size=4, num_layers=2,
                        num_heads=4, head_dim=16, cache_dtype=cache_dtype,
                        device="cpu").bytes_per_block


def _pair(models, spill_blocks=None, budget_blocks=None, **kw):
    """The JAX and the port engine on one config: a device prefix budget
    of `budget_blocks` blocks and a host tier of `spill_blocks`."""
    cd = kw.get("cache_dtype")
    base = dict(max_batch=2, prompt_cap=CAP, max_new_tokens=NEW,
                decode_chunk=2, paged=True, kv_block=4, prefix_cache=True,
                kv_blocks=40)
    if budget_blocks is not None:
        base["prefix_cache_bytes"] = budget_blocks * _bpb(cd)
    if spill_blocks is not None:
        base["spill_host_bytes"] = spill_blocks * _bpb(cd)
    base.update(kw)
    jm, tm = models
    return (JServingEngine(jm, JServingConfig(**base)),
            pt.ServingEngine(tm, pt.ServingConfig(**base)))


def _serve(eng, prompt):
    r = eng.submit(prompt)
    eng.drain()
    assert r.status == "done"
    return r.tokens


def _tplanes(pools, blocks):
    return [tuple(p[blocks].clone().numpy() for p in layer)
            for layer in pools]


@pytest.mark.parametrize("cache_dtype", [None, "int8"])
def test_pool_block_round_trip_bitwise(models, cache_dtype):
    """read_block -> write_block into another block moves bytes: every
    layer's K and V planes (codes and scales) equal the source's, and
    the payload holds the JAX payload's bytes."""
    jeng, teng = _pair(models, spill_blocks=1 << 10,
                       cache_dtype=cache_dtype)
    ids = _prompts([CAP])
    for eng in (jeng, teng):
        _serve(eng, ids[0])
    blk = int(teng._prefix.match(ids[0])[0][0])
    assert blk == int(jeng._prefix.match(ids[0])[0][0])
    payload = teng._pool.read_block(teng._pools, blk)
    jpay = jeng._pool.read_block(jeng._pools, blk)
    assert len(payload) == len(jpay) == (2 if cache_dtype else 1)
    for a, b in zip(payload, jpay):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5 if a.dtype.is_floating_point
                                   else 1)
    src = _tplanes(teng._pools, [blk])
    dst = teng._pool.take(1)[0]
    teng._pool.write_block(teng._pools, dst, payload)
    got = _tplanes(teng._pools, [dst])
    for ls, lg in zip(src, got):
        for s, g in zip(ls, lg):
            assert np.array_equal(s, g)
    teng._pool.release([dst])


@pytest.mark.parametrize("cache_dtype", [None, "int8"])
def test_evict_spill_rehydrate_chains(models, cache_dtype):
    """A 2-block device budget spills; resubmitting the LRU-spilled
    prompt rehydrates it (one host->device copy per payload tensor), and
    every chain equals a never-evicted engine's and the JAX spill
    engine's; the tiers' stats agree."""
    ids = _prompts([CAP, CAP, CAP], seed=3)
    jeng, teng = _pair(models, spill_blocks=1 << 10, budget_blocks=2,
                       cache_dtype=cache_dtype)
    _, never = _pair(models, cache_dtype=cache_dtype)
    first = {}
    for i in range(3):
        first[i] = _serve(teng, ids[i])
        np.testing.assert_array_equal(first[i], _serve(jeng, ids[i]))
        np.testing.assert_array_equal(first[i], _serve(never, ids[i]))
    t = teng._spill
    assert t.spilled_total >= 1
    assert t.stats() == jeng._spill.stats()
    r0 = t.rehydrated_total
    again = _serve(teng, ids[0])
    np.testing.assert_array_equal(again, _serve(jeng, ids[0]))
    np.testing.assert_array_equal(again, first[0])
    np.testing.assert_array_equal(again, _serve(never, ids[0]))
    assert t.rehydrated_total > r0
    assert t.h2d_copies == t.rehydrated_total * (2 if cache_dtype else 1)
    assert t.stats() == jeng._spill.stats()
    assert teng._prefix.spilled_blocks == t.spilled_blocks
    assert teng.statusz()["spill"] == jeng.statusz()["spill"]


def test_cow_after_rehydrate_leaves_shared_blocks(models):
    """A full-hit repeat on a rehydrated prefix still copies on write:
    the rehydrated shared blocks' bytes never change."""
    ids = _prompts([CAP], seed=5)
    jeng, teng = _pair(models, spill_blocks=1 << 10, budget_blocks=2,
                       max_batch=1)
    for eng in (jeng, teng):
        _serve(eng, ids[0])
        eng._prefix.evict(eng._prefix.cached_blocks)       # all -> host
        assert eng._prefix.cached_blocks == 0
        _serve(eng, ids[0])                                # rehydrate+COW
        assert eng._spill.rehydrated_total >= 2
    cached, t = teng._prefix.match(ids[0])
    assert t == CAP
    before = _tplanes(teng._pools, cached)
    np.testing.assert_array_equal(_serve(teng, ids[0]),
                                  _serve(jeng, ids[0]))
    after = _tplanes(teng._pools, cached)
    for lb, la in zip(before, after):
        for b, a in zip(lb, la):
            assert np.array_equal(b, a)
    assert teng._spill.stats() == jeng._spill.stats()


def test_refcount_conservation_mixed_spill_traffic(models):
    """After mixed spill / rehydrate / upgrade traffic, drain + clear
    returns every block to the free list (spilled entries hold no pool
    reference), as in the JAX engine."""
    jeng, teng = _pair(models, spill_blocks=1 << 10, budget_blocks=2)
    lens = [CAP, 5, CAP, 3, CAP, 7, CAP]
    ids = _prompts(lens, seed=9)
    for eng in (jeng, teng):
        for i, ln in enumerate(lens):
            _serve(eng, ids[i, :ln])
        _serve(eng, ids[0, :CAP])
    assert teng._spill.spilled_total >= 1
    assert teng._spill.stats() == jeng._spill.stats()
    assert teng._pool._refs == jeng._pool._refs
    assert teng._pool.free_blocks == \
        teng._pool.capacity_blocks - teng._prefix.cached_blocks
    teng._prefix.clear()
    assert teng._pool.free_blocks == teng._pool.capacity_blocks
    assert teng._pool._refs == {}
    assert teng._spill.spilled_blocks == teng._prefix.spilled_blocks == 0


def test_tier_budget_drops_lru_spilled(models):
    """A tier of 2 blocks drops its LRU spilled leaves for good: equal
    drop counts, host residency within capacity."""
    jeng, teng = _pair(models, spill_blocks=2, budget_blocks=2)
    ids = _prompts([CAP] * 4, seed=11)
    for i in range(4):
        np.testing.assert_array_equal(_serve(teng, ids[i]),
                                      _serve(jeng, ids[i]))
    t = teng._spill
    assert t.dropped_total >= 1
    assert t.spilled_blocks <= t.capacity_blocks
    assert t.stats() == jeng._spill.stats()
    assert teng._prefix.spilled_blocks == t.spilled_blocks


def test_spill_metrics_and_warmup(models):
    """The tier's exposition is byte-equal to the JAX tier's, and the
    warmup's spill leg sends every cached block through the tier."""
    jeng, teng = _pair(models, spill_blocks=1 << 10, budget_blocks=4)
    for eng in (jeng, teng):
        eng.warmup_prefix_cache(CFG["vocab_size"])
    assert teng._spill.stats() == jeng._spill.stats()
    assert teng._spill.rehydrated_total >= 1
    assert teng._spill.metrics_text() == jeng._spill.metrics_text()
    assert teng.metrics_registry().render().count("spill_") > 0
    with pytest.raises(ValueError, match="holds zero blocks"):
        pt.HostSpillTier(bytes_per_block=100, byte_budget=99)
