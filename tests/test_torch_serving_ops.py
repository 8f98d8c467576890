"""PyTorch port vs JAX package: the paged engine's ops surface.

The same small f32 GPT (2 layers, H=64, 4 heads, vocab 128) serves the
same numpy traffic through the port's and the JAX package's engines. The
chains, the counters, `health()`, the `statusz()` keys and its kv /
prefix_cache / spill blocks, and the compile counts must be equal; so
must the preflight codes and retriable flags of refused requests, the
`enqueue_at` backdating (a future time clamps to now) and the graceful
drain. The first test runs first on the module's models: the compile
counts follow the JAX model's executable cache, which the later tests
fill.
"""
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.inference import ServingConfig as JServingConfig
from paddle_tpu.inference import ServingEngine as JServingEngine
from paddle_tpu.models import GPTConfig as JGPTConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu.obs import lint_exposition as j_lint
import paddle_tpu_torch as pt
from paddle_tpu_torch.obs import lint_exposition as t_lint

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


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _pair(models, clock=None, **kw):
    base = dict(max_batch=2, prompt_cap=CAP, max_new_tokens=NEW,
                decode_chunk=2, paged=True, kv_block=4)
    base.update(kw)
    jm, tm = models
    extra = {} if clock is None else {"clock": clock}
    return (JServingEngine(jm, JServingConfig(**base), **extra),
            pt.ServingEngine(tm, pt.ServingConfig(**base), **extra))


def _traffic(n=10, seed=3):
    return [t["prompt"] for t in pt.shared_prefix_traffic(
        n, n_prefixes=2, prefix_len=4, prompt_cap=CAP,
        vocab_size=CFG["vocab_size"], seed=seed)]


def _bpb():
    return pt.BlockPool(num_blocks=2, block_size=4, num_layers=2,
                        num_heads=4, head_dim=16,
                        device="cpu").bytes_per_block


CONFIGS = {
    "prefix_spill": dict(prefix_cache=True, kv_blocks=24,
                         prefix_cache_bytes=3 * 4096,
                         spill_host_bytes=64 * 4096),
    "spec_chunked": dict(prefix_cache=True, spec_decode=True, spec_k=3,
                         prefill_chunk=4, kv_blocks=40),
    # admission waits on the free list: mem_pressure episodes
    "oversubscribed": dict(prefix_cache=True, kv_blocks=6),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_engine_counters_health_statusz_and_compiles_match(models, name):
    assert _bpb() == 4096
    jeng, teng = _pair(models, **CONFIGS[name])
    for eng in (jeng, teng):
        eng.warmup_prefix_cache(CFG["vocab_size"], clear=False)
    prompts = _traffic()
    # twice: the second pass hits the trie (and drafts from it)
    for p in prompts + prompts:
        for eng in (jeng, teng):
            eng.submit(p)
    jd, td = jeng.drain(), teng.drain()
    assert [r.status for r in td] == ["done"] * len(td)
    assert len(td) == len(jd) == 2 * len(prompts)
    for a, b in zip(sorted(td, key=lambda r: r.id),
                    sorted(jd, key=lambda r: r.id)):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    assert teng.metrics.counters == jeng.metrics.counters
    assert teng.metrics.gauges == jeng.metrics.gauges
    assert teng.health() == jeng.health()
    ts, js = teng.statusz(), jeng.statusz()
    assert set(ts) == set(js)
    for block in ("kv", "prefix_cache", "spill", "counters", "gauges"):
        assert ts.get(block) == js.get(block), block
    assert ts["config"] == js["config"]
    for key in ("requests_submitted", "batches", "paged", "draining"):
        assert ts["engine"][key] == js["engine"][key]
    assert (ts["compile"]["compiles"], ts["compile"]["recompiles"]) == \
        (js["compile"]["compiles"], js["compile"]["recompiles"])
    assert ts["compile"]["compiles"] >= 1
    assert ts["compile"]["kernel_libraries"] == []    # CPU: none loaded
    if name == "prefix_spill":
        assert ts["spill"]["spilled_total"] >= 1
        assert ts["spill"]["rehydrated_total"] >= 1
    if name == "oversubscribed":
        assert ts["counters"]["mem_pressure_episodes"] >= 1
    # the /metrics pages: the same families (the JAX batch monitor's jit
    # cache gauge aside) and equal counters
    jp = j_lint(jeng.metrics_registry().render())
    tp = t_lint(teng.metrics_registry().render())
    assert set(tp) == set(jp) - {
        "paddle_tpu_serving_batch_jit_cache_misses_total"}
    counters = [f for f in tp if tp[f]["type"] == "counter"]
    assert counters
    for fam in counters:
        assert tp[fam]["samples"] == jp[fam]["samples"], fam


def test_padded_engine_compile_counts_match(models):
    jeng, teng = _pair(models, paged=False, max_batch=3)
    prompts = _traffic(6, seed=5)
    for budget in (1, NEW, 3, NEW):
        for eng in (jeng, teng):
            for p in prompts[:3]:
                eng.submit(p, max_new_tokens=budget)
            eng.drain()
    assert (teng.monitor.compiles, teng.monitor.recompiles) == \
        (jeng.monitor.compiles, jeng.monitor.recompiles)
    assert teng.metrics.counters == jeng.metrics.counters


def test_preflight_codes_and_retriable_flags_match(models):
    jeng, teng = _pair(models, kv_blocks=4, queue_high_watermark=2,
                       queue_capacity=3)
    cases = [(np.arange(1, CAP + 2), None), (np.zeros(0, np.int64), None),
             (np.arange(1, 4), 0), (np.arange(1, CAP + 1), NEW)]
    for prompt, want in cases:
        assert [f.code for f in teng.preflight(prompt, want)] == \
            [f.code for f in jeng.preflight(prompt, want)]
    got = {"jax": [], "torch": []}
    for key, eng in (("jax", jeng), ("torch", teng)):
        for prompt, want in cases + [(np.arange(1, 3), 2)] * 3:
            r = eng.submit(prompt, max_new_tokens=want)
            got[key].append((r.status, r.reason, r.retriable))
        eng.begin_drain()
        r = eng.submit(np.arange(1, 3))
        got[key].append((r.status, r.reason, r.retriable))
    assert got["torch"] == got["jax"]
    assert [g[1] for g in got["torch"]] == [
        "prompt_shape", "prompt_shape", "max_new_tokens", "kv_oom", None,
        None, "overloaded", "draining"]
    assert got["torch"][-1][2] is True and got["torch"][3][2] is False
    assert teng.metrics.counters == jeng.metrics.counters
    assert teng.monitor.recompile_events == jeng.monitor.recompile_events


def test_enqueue_at_backdates_and_clamps(models):
    clock = Clock()
    jeng, teng = _pair(models, clock=clock, prefix_cache=True)
    reqs = {"jax": [], "torch": []}
    for key, eng in (("jax", jeng), ("torch", teng)):
        reqs[key].append(eng.submit(np.arange(1, 6), enqueue_at=95.0))
        reqs[key].append(eng.submit(np.arange(2, 7), enqueue_at=105.0))
        reqs[key].append(eng.submit(np.arange(3, 8)))
    clock.t = 101.0
    for eng in (jeng, teng):
        eng.drain()
    for a, b in zip(reqs["torch"], reqs["jax"]):
        assert a.trace.t_enqueue == b.trace.t_enqueue
        assert a.trace.queue_s == b.trace.queue_s
        assert a.record() == {**b.record(), "trace_id": a.trace.trace_id}
    assert [r.trace.t_enqueue for r in reqs["torch"]] == [95.0, 100.0,
                                                          100.0]
    assert reqs["torch"][0].trace.queue_s == 6.0


def test_graceful_drain_seal_refuses_then_resumes(models):
    rows = []
    jeng, teng = _pair(models, prefix_cache=True)
    teng.metrics.on_record = rows.append
    for eng in (jeng, teng):
        eng.submit(np.arange(1, 6))
        out = eng.drain(seal=True)
        assert [r.status for r in out] == ["done"] and eng.draining
        r = eng.submit(np.arange(1, 6))
        assert (r.status, r.reason, r.retriable) == ("rejected",
                                                      "draining", True)
        assert eng.health()["status"] == "draining"
        eng.resume_admission()
        assert eng.submit(np.arange(1, 6)).status == "queued"
        eng.drain()
    drain_rows = [r for r in rows if "drain" in r]
    assert len(drain_rows) == 1
    assert drain_rows[0]["drain"]["inflight"] == 0
    assert teng.health() == jeng.health()
    assert teng.metrics.counters == jeng.metrics.counters
