"""PyTorch port vs JAX package: the padded engine, weight-only int8
serving on both engines, and model drafting.

The same small f32 GPT (2 layers, H=64, 4 heads, vocab 128) serves the
same numpy prompts through the port's ServingEngine (CPU route) and the
JAX package's, under one ServingConfig; greedy token chains must be equal
per request, and equal to `generate_static_ragged`'s.
``PADDLE_TPU_Q8_DECODE_MIN=4096`` quantizes the toy widths under
weight_dtype="int8", as the JAX tests do.
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
LENS = [CAP, 5, 3, 7, 2]


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JGPT(JGPTConfig(**CFG))
    jm.eval()
    state = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    cfg = pt.GPTConfig(**CFG)
    tm = pt.GPTForCausalLM(cfg, device="cpu")
    tm.load_state_dict(pt.state_dict_from_paddle(state, cfg))
    return jm, tm


@pytest.fixture(autouse=True)
def _toy_q8_gate(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_Q8_DECODE_MIN", "4096")


def _prompts(lens=LENS, seed=1):
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, CFG["vocab_size"], (len(lens), CAP)).astype(
        np.int64)
    for r, ln in enumerate(lens):
        ids[r, ln:] = 0
    return ids


def _serve(engine, ids, lens, budgets=None):
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


def _both(jm, tm, ids, lens, budgets=None, **cfg):
    """Serve through the port's and the JAX engine under one config."""
    got = _serve(pt.ServingEngine(tm, pt.ServingConfig(**cfg)), ids, lens,
                 budgets)
    jgot = _serve(JServingEngine(jm, JServingConfig(**cfg)), ids, lens,
                  budgets)
    return got, jgot


@pytest.mark.parametrize("weight_dtype, cache_dtype", [
    (None, None), ("int8", None), ("int8", "int8")])
def test_padded_engine_matches_jax_engine_and_static_ragged(
        models, weight_dtype, cache_dtype):
    """5 ragged prompts through max_batch=2 micro-batches, one row with a
    2-token budget; the default ServingConfig is the padded engine."""
    jm, tm = models
    ids = _prompts()
    budgets = [NEW if i != 1 else 2 for i in range(len(LENS))]
    cfg = dict(max_batch=2, prompt_cap=CAP, max_new_tokens=NEW,
               decode_chunk=2, weight_dtype=weight_dtype,
               cache_dtype=cache_dtype)
    assert pt.ServingConfig(**cfg).paged is False
    got, jgot = _both(jm, tm, ids, LENS, budgets, **cfg)
    ref = tm.generate_static_ragged(
        ids, LENS, max_new_tokens=NEW, weight_dtype=weight_dtype,
        cache_dtype=cache_dtype).numpy()[:, CAP:]
    if weight_dtype is None and cache_dtype is None:
        np.testing.assert_array_equal(ref, np.asarray(
            jm.generate_static_ragged(paddle.to_tensor(ids), LENS,
                                      max_new_tokens=NEW).numpy())[:, CAP:])
    for i, r in got.items():
        np.testing.assert_array_equal(r.tokens, ref[i, :budgets[i]])
        np.testing.assert_array_equal(r.tokens, jgot[i].tokens)
        assert r.n_out == jgot[i].n_out
        assert [e[0] for e in r.trace.events] == \
            [e[0] for e in jgot[i].trace.events]


def test_padded_engine_eos_and_gauges_match_jax(models):
    """EOS early exit at chunk granularity, the token counters and the kv
    gauges (kv_slots = rows * max_len) equal the JAX engine's."""
    jm, tm = models
    ids = _prompts()
    ref = tm.generate_static_ragged(ids, LENS, max_new_tokens=NEW).numpy()
    eos = int(ref[0, CAP])
    cfg = dict(max_batch=3, prompt_cap=CAP, max_new_tokens=NEW,
               decode_chunk=2, eos_token_id=eos)
    eng = pt.ServingEngine(tm, pt.ServingConfig(**cfg))
    jeng = JServingEngine(jm, JServingConfig(**cfg))
    got = _serve(eng, ids, LENS)
    jgot = _serve(jeng, ids, LENS)
    assert got[0].n_out == 1 and got[0].tokens[0] == eos
    for i, r in got.items():
        np.testing.assert_array_equal(r.tokens, jgot[i].tokens)
    a, b = eng.summary(), jeng.summary()
    for key in ("completed_total", "tokens_out_total", "tokens_in_total",
                "batches_total", "kv_occupancy", "kv_slots_occupancy",
                "batch_fill_ratio", "queue_depth", "inflight"):
        assert a[key] == b[key], key


@pytest.mark.parametrize("kw", [
    dict(max_new_tokens=1), dict(max_new_tokens=6, decode_chunk=2),
    dict(max_new_tokens=7, decode_chunk=3), dict(max_new_tokens=32),
    dict(max_new_tokens=5, decode_chunk=8)])
def test_chunk_schedule_and_max_len_match_jax(kw):
    a = pt.ServingConfig(prompt_cap=CAP, **kw)
    b = JServingConfig(prompt_cap=CAP, **kw)
    assert a.chunk_schedule == b.chunk_schedule
    assert a.max_len == b.max_len


def test_queue_deadline_expiry(models):
    """Requests whose queue wait passed their deadline expire at
    admission as "timeout"; the rest of the micro-batch is served."""
    _, tm = models
    t = [0.0]
    eng = pt.ServingEngine(tm, pt.ServingConfig(
        max_batch=2, prompt_cap=CAP, max_new_tokens=2),
        clock=lambda: t[0])
    ids = _prompts()
    late = eng.submit(ids[0, :CAP], deadline_s=0.5)
    keep = eng.submit(ids[1, :5])
    t[0] = 1.0
    out = eng.step()
    assert late.status == "timeout" and late.reason == "queue_deadline"
    assert keep.status == "done" and keep.tokens.shape == (2,)
    assert out == [late, keep]
    s = eng.summary()
    assert s["timeout_total"] == 1 and s["completed_total"] == 1
    assert not eng.busy


def test_padded_engine_error_accounting(models, monkeypatch):
    """A prefill dying mid-batch records the batch's requests as errors
    and the exception propagates; the engine keeps serving."""
    _, tm = models
    eng = pt.ServingEngine(tm, pt.ServingConfig(max_batch=2, prompt_cap=CAP,
                                                max_new_tokens=2))
    ids = _prompts()
    reqs = [eng.submit(ids[i, :LENS[i]]) for i in range(2)]

    def boom(*a, **kw):
        raise RuntimeError("injected device failure")

    with monkeypatch.context() as m:
        m.setattr(tm, "prefill_static", boom)
        with pytest.raises(RuntimeError, match="injected"):
            eng.step()
    assert [r.status for r in reqs] == ["error", "error"]
    assert eng.summary()["errors_total"] == 2
    assert eng.summary()["inflight"] == 0
    eng.submit(ids[0, :CAP])
    assert [r.status for r in eng.drain()] == ["done"]


@pytest.mark.parametrize("cache_dtype", [None, "int8"])
def test_paged_engine_int8_weights_match_jax(models, cache_dtype):
    """weight_dtype="int8" on the paged engine, fp and int8 KV, a slot
    spliced mid-flight."""
    jm, tm = models
    ids = _prompts()
    budgets = [NEW if i != 1 else 2 for i in range(len(LENS))]
    got, jgot = _both(jm, tm, ids, LENS, budgets, max_batch=2,
                      prompt_cap=CAP, max_new_tokens=NEW, decode_chunk=2,
                      paged=True, kv_block=4, weight_dtype="int8",
                      cache_dtype=cache_dtype)
    ref = tm.generate_static_ragged(ids, LENS, max_new_tokens=NEW,
                                    weight_dtype="int8",
                                    cache_dtype=cache_dtype).numpy()
    for i, r in got.items():
        np.testing.assert_array_equal(r.tokens, jgot[i].tokens)
        np.testing.assert_array_equal(r.tokens, ref[i, CAP:CAP + budgets[i]])


def test_model_draft_fn_with_the_target_as_drafter(models):
    """A draft-model hook whose drafter is the target itself (the oracle
    drafter): every draft is accepted, chains equal
    generate_static_ragged's, and the windows count as model drafts."""
    jm, tm = models
    from paddle_tpu.inference import model_draft_fn as j_draft
    new = 5
    lens = [CAP, 5, 3]
    ids = _prompts(lens, seed=2)
    ref = tm.generate_static_ragged(ids, lens,
                                    max_new_tokens=new).numpy()[:, CAP:]
    eng = pt.ServingEngine(tm, pt.ServingConfig(
        max_batch=2, prompt_cap=CAP, max_new_tokens=new, decode_chunk=2,
        paged=True, kv_block=4, spec_decode=True, spec_k=3,
        spec_draft=pt.model_draft_fn(tm, window=16)))
    got = _serve(eng, ids, lens)
    for i, r in got.items():
        np.testing.assert_array_equal(r.tokens, ref[i])
    c = eng.metrics.counters
    assert c["spec_drafts_model"] > 0 and c["spec_drafts_trie"] == 0
    assert c["spec_accepted"] == c["spec_proposed"] > 0
    ctx = list(ids[1, :5])
    np.testing.assert_array_equal(pt.model_draft_fn(tm, window=16)(ctx, 3),
                                  j_draft(jm, window=16)(ctx, 3))


def test_config_validation():
    with pytest.raises(ValueError, match="weight_dtype"):
        pt.ServingConfig(weight_dtype="int4")
    with pytest.raises(ValueError, match="paged cache_dtype"):
        pt.ServingConfig(paged=True, cache_dtype="float16")
    # the padded engine takes the model dtype by name, as the JAX one does
    assert pt.ServingConfig(cache_dtype="float32").cache_dtype == "float32"
    for bad in (dict(prefix_cache=True), dict(prefill_chunk=2),
                dict(spec_decode=True, spec_draft=lambda c, k: [])):
        with pytest.raises(ValueError, match="paged=True"):
            pt.ServingConfig(**bad)
