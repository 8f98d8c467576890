"""PyTorch port vs JAX package: suffix prefill, speculative verify, and the
engine with the prefix cache, chunked prefill and speculative decoding.

The same small f32 GPT (2 layers, H=64, 4 heads, vocab 128) runs in both
packages from one state dict; the port takes its CPU route (the plain
versions of the paged kernels). Token chains must be equal.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import ServingConfig as JServingConfig
from paddle_tpu.inference import ServingEngine as JServingEngine
from paddle_tpu.inference import repeated_traffic as jrepeated
from paddle_tpu.inference import shared_prefix_traffic as jshared
from paddle_tpu.inference.kv_cache import BlockPool as JBlockPool
from paddle_tpu.models import GPTConfig as JGPTConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
import paddle_tpu_torch as pt

CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
           max_position_embeddings=64, intermediate_size=128)
CAP, NEW, BS = 8, 6, 4


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


def _prompt(seed, n=CAP):
    return np.random.RandomState(seed).randint(
        1, CFG["vocab_size"], (n,)).astype(np.int64)


# ---------------------------------------------------- model primitives

def _prefilled(m, pool_cls, cache_dtype, prompt, budget=8):
    """One prompt prefilled into a fresh pool: (pools, table, first)."""
    pool = pool_cls.for_model(m, num_blocks=16, block_size=BS,
                              cache_dtype=cache_dtype)
    pools = pool.make_pools()
    pool.alloc(0, len(prompt) + budget)
    tbl = pool.table_row(0, 4)[None]
    pools, first = m.prefill_paged(prompt[None], [len(prompt)], pools, tbl,
                                   cache_dtype=cache_dtype)
    return pools, tbl, int(np.asarray(first.numpy())[0])


@pytest.mark.parametrize("cache_dtype", [None, "int8"])
def test_verify_paged_matches_jax(models, cache_dtype):
    """Full accept, full reject and a mid-window mismatch, without and
    with EOS (including a row done on entry): emitted tokens, accepted
    counts and done flags equal the JAX package's, and the emitted prefix
    equals the plain decode chain."""
    jm, tm = models
    prompt = _prompt(1)
    pools, tbl, t0 = _prefilled(tm, pt.BlockPool, cache_dtype, prompt)
    lens = np.asarray([CAP], np.int32)
    pend = np.asarray([t0], np.int32)
    toks, *_ = tm.decode_paged(pools, tbl, lens, pend, np.zeros(1, bool), 4,
                               cache_dtype=cache_dtype)
    ref = toks.numpy()[0]
    cases = [(ref[:3], None, False), (np.asarray([95, 94, 93]), None, False),
             (np.asarray([ref[0], 93, ref[2]]), None, False),
             (ref[:3], int(ref[1]), False), (ref[:3], int(ref[1]), True)]
    for draft, eos, done0 in cases:
        draft = draft.astype(np.int32)[None]
        done = np.full((1,), done0)
        tp_, ttbl, tt0 = _prefilled(tm, pt.BlockPool, cache_dtype, prompt)
        jp_, jtbl, jt0 = _prefilled(jm, JBlockPool, cache_dtype, prompt)
        assert tt0 == jt0 == t0
        e, n, _, d = tm.verify_paged(tp_, ttbl, lens, pend, draft, done,
                                     eos_token_id=eos,
                                     cache_dtype=cache_dtype)
        je, jn, _, jd = jm.verify_paged(jp_, jtbl, lens, pend, draft, done,
                                        eos_token_id=eos,
                                        cache_dtype=cache_dtype)
        assert e.dtype == torch.int64 and n.dtype == torch.int32
        np.testing.assert_array_equal(e.numpy(), np.asarray(je.numpy()))
        np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
        if eos is None:
            k = int(n[0])
            np.testing.assert_array_equal(e.numpy()[0, :k + 1],
                                          ref[:k + 1])


@pytest.mark.parametrize("cache_dtype", [None, "int8"])
def test_suffix_prefill_first_token_matches_jax(models, cache_dtype):
    """A prompt prefilled as a 4-token prefix then a start=4 suffix window
    (padded to the cap, as the engine does) samples the same first token
    as the JAX package, and as a one-shot prefill of the whole prompt."""
    jm, tm = models
    prompt = _prompt(2, 7)
    firsts = []
    for m, pool_cls in ((tm, pt.BlockPool), (jm, JBlockPool)):
        pool = pool_cls.for_model(m, num_blocks=16, block_size=BS,
                                  cache_dtype=cache_dtype)
        pools = pool.make_pools()
        pool.alloc(0, 16)
        tbl = pool.table_row(0, 4)[None]
        pools, _ = m.prefill_paged(prompt[None, :4], [4], pools, tbl,
                                   cache_dtype=cache_dtype)
        ids = np.zeros((1, CAP), np.int64)
        ids[0, :3] = prompt[4:]
        pools, first = m.prefill_paged(ids, [3], pools, tbl,
                                       cache_dtype=cache_dtype,
                                       start=np.asarray([4], np.int32))
        firsts.append(int(np.asarray(first.numpy())[0]))
    whole = _prefilled(tm, pt.BlockPool, cache_dtype, prompt)[2]
    assert firsts[0] == firsts[1] == whole


# -------------------------------------------------------- the engine

def _serve(engine, prompts, reps=1):
    """Submit every prompt, drain, `reps` times; returns each rep's chains
    in submission order."""
    out = []
    for _ in range(reps):
        reqs = [engine.submit(p) for p in prompts]
        engine.drain()
        assert [r.status for r in reqs] == ["done"] * len(prompts)
        out.append([r.tokens for r in reqs])
    return out


def _both(models, prompts, warm=False, reps=1, **kw):
    jm, tm = models
    base = dict(max_batch=2, prompt_cap=CAP, max_new_tokens=NEW,
                decode_chunk=2, paged=True, kv_block=BS)
    base.update(kw)
    engines = (pt.ServingEngine(tm, pt.ServingConfig(**base)),
               JServingEngine(jm, JServingConfig(**base)))
    if warm:
        for e in engines:
            e.warmup_prefix_cache(CFG["vocab_size"], clear=False)
    got, want = (_serve(e, prompts, reps) for e in engines)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    return engines[0], got


def _ref(models, prompts, cache_dtype):
    jm, _ = models
    ids = np.zeros((len(prompts), CAP), np.int64)
    for i, p in enumerate(prompts):
        ids[i, :len(p)] = p
    return np.asarray(jm.generate_static_ragged(
        paddle.to_tensor(ids), [len(p) for p in prompts],
        max_new_tokens=NEW, cache_dtype=cache_dtype).numpy())[:, CAP:]


def _prefix_prompts():
    """A miss, its aligned repeat (full hit: copy-on-write of the last
    block), a partial hit (suffix prefill) and a one-block prefix plus one
    token (full hit without a copy: the last token is re-decoded)."""
    a = _prompt(3)
    partial = a.copy()
    partial[4:] = _prompt(4, 4)
    return [a, a.copy(), partial, a[:5].copy()]


@pytest.mark.parametrize("cache_dtype", [None, "int8"])
def test_engine_prefix_cache_matches_jax(models, cache_dtype):
    prompts = _prefix_prompts()
    eng, got = _both(models, prompts, cache_dtype=cache_dtype,
                     prefix_cache=True)
    c = eng.metrics.counters
    assert (c["prefix_hit"], c["prefix_miss"]) == (3, 1)
    assert c["prefill_tokens_saved"] == 7 + 4 + 4
    ref = _ref(models, prompts, cache_dtype)
    off = _serve(pt.ServingEngine(models[1], pt.ServingConfig(
        max_batch=2, prompt_cap=CAP, max_new_tokens=NEW, decode_chunk=2,
        paged=True, kv_block=BS, cache_dtype=cache_dtype)), prompts)
    for i in range(len(prompts)):
        np.testing.assert_array_equal(got[0][i], ref[i])
        np.testing.assert_array_equal(off[0][i], ref[i])
    # every reference is accounted for once the cache lets go
    eng._prefix.clear()
    assert eng._pool.free_blocks == eng._pool.capacity_blocks


@pytest.mark.parametrize("cache_dtype", [None, "int8"])
@pytest.mark.parametrize("chunk", [1, 3])
def test_engine_chunked_prefill_matches_jax(models, chunk, cache_dtype):
    lens = [CAP, 5, 1, 7, 2]
    prompts = [_prompt(10 + i, n) for i, n in enumerate(lens)]
    _, got = _both(models, prompts, cache_dtype=cache_dtype,
                   prefill_chunk=chunk)
    ref = _ref(models, prompts, cache_dtype)
    for i in range(len(prompts)):
        np.testing.assert_array_equal(got[0][i], ref[i])


@pytest.mark.parametrize("cache_dtype", [None, "int8"])
def test_engine_spec_decode_trie_matches_jax(models, cache_dtype):
    traffic = pt.repeated_traffic(6, n_prompts=2, prompt_len=CAP,
                                  vocab_size=CFG["vocab_size"], rate=1e9,
                                  seed=7)
    prompts = [t["prompt"] for t in traffic]
    eng, got = _both(models, prompts, warm=True, cache_dtype=cache_dtype,
                     kv_blocks=96, prefix_cache=True, spec_decode=True,
                     spec_k=3)
    c = eng.metrics.counters
    assert c["spec_windows"] > 0 and c["spec_drafts_trie"] > 0
    assert c["spec_accepted"] <= c["spec_proposed"]
    assert eng.metrics.hists["spec_accept_len"].count == c["spec_windows"]
    ref = _ref(models, prompts, cache_dtype)
    for i in range(len(prompts)):
        np.testing.assert_array_equal(got[0][i], ref[i])


@pytest.mark.parametrize("cache_dtype", [None, "int8"])
def test_engine_all_three_composed_matches_jax(models, cache_dtype):
    """Chunked prefill + prefix cache + speculative decode together."""
    prompts = [_prompt(12), _prompt(13), _prompt(14, 5)]
    eng, got = _both(models, prompts, warm=True, reps=2,
                     cache_dtype=cache_dtype, kv_blocks=96,
                     prefix_cache=True, spec_decode=True, spec_k=3,
                     prefill_chunk=4)
    assert eng.metrics.counters["spec_windows"] > 0
    ref = _ref(models, prompts, cache_dtype)
    for rep in got:
        for i in range(len(prompts)):
            np.testing.assert_array_equal(rep[i], ref[i])


def test_cow_never_mutates_a_shared_block(models):
    """An aligned full hit re-decodes its last prompt token into a private
    copy of the last cached block: the cached blocks' bytes, in every
    layer and plane, are the same before and after."""
    _, tm = models
    eng = pt.ServingEngine(tm, pt.ServingConfig(
        max_batch=2, prompt_cap=CAP, max_new_tokens=NEW, decode_chunk=2,
        paged=True, kv_block=BS, prefix_cache=True))
    a = _prompt(5)
    eng.submit(a)
    eng.drain()
    cached, t = eng._prefix.match(a)
    assert t == CAP and len(cached) == 2

    def sums():
        return [[float(plane[b].double().sum()) for b in cached]
                for layer in eng._pools for plane in layer]

    before = sums()
    eng.submit(a)
    (r,) = eng.drain()
    assert r.status == "done"
    assert sums() == before
    assert eng.metrics.counters["prefill_tokens_saved"] == CAP - 1


def test_traffic_generators_match_jax():
    a = pt.shared_prefix_traffic(12, n_prefixes=3, prefix_len=5,
                                 prompt_cap=16, vocab_size=100, seed=3)
    b = jshared(12, n_prefixes=3, prefix_len=5, prompt_cap=16,
                vocab_size=100, seed=3)
    c = pt.repeated_traffic(12, n_prompts=3, prompt_len=6, vocab_size=100,
                            seed=4)
    d = jrepeated(12, n_prompts=3, prompt_len=6, vocab_size=100, seed=4)
    for x, y, key in [(a, b, "prefix_id"), (c, d, "prompt_id")]:
        assert [t["at"] for t in x] == [t["at"] for t in y]
        assert [t[key] for t in x] == [t[key] for t in y]
        for s, u in zip(x, y):
            np.testing.assert_array_equal(s["prompt"], u["prompt"])
    with pytest.raises(ValueError):
        pt.shared_prefix_traffic(1, n_prefixes=1, prefix_len=16,
                                 prompt_cap=16, vocab_size=10)
    with pytest.raises(ValueError):
        pt.repeated_traffic(1, n_prompts=0, prompt_len=4, vocab_size=10)


@pytest.mark.parametrize("kw, match", [
    (dict(prefix_cache=True, paged=False), "requires paged"),
    (dict(spec_decode=True), "prefix_cache=True"),
    (dict(spec_decode=True, prefix_cache=True, spec_k=32), "spec_k"),
    (dict(spec_decode=True, prefix_cache=True, temperature=0.5), "greedy"),
    (dict(spec_decode=True, spec_draft="model"), "callable"),
    (dict(prefill_chunk=CAP + 1), "prefill_chunk"),
])
def test_config_validation_matches_jax(kw, match):
    base = dict(max_batch=2, prompt_cap=CAP, max_new_tokens=NEW, paged=True)
    base.update(kw)
    with pytest.raises(ValueError, match=match) as a:
        pt.ServingConfig(**base)
    with pytest.raises(ValueError) as b:
        JServingConfig(**base)
    assert str(a.value) == str(b.value)
