"""PyTorch port vs JAX package: the memory ledger, the golden-canary
prober, the invariant auditor and the telemetry server.

memz: the same register / set / sample calls give equal censuses, deltas,
exposition text and `render_report` output; `looks_like_oom` knows
torch.cuda.OutOfMemoryError; a CPU ledger has no allocator view by
construction. probez: `config_fingerprint` components equal the JAX ones
except `versions`; the Prober's variants and goldens equal the JAX
prober's, it passes on a healthy engine and fails `prefix_hit` (one
probe_fail row) once bytes of that variant's cached blocks are flipped;
the auditor
catches a planted refcount leak. The server: a scrape of every route of
the port's engine makes no device->host copy (`Tensor.cpu`, `.item`,
`.tolist` and `.numpy` raise during it), and an out-of-memory in a step
dumps the ledger's post-mortem before the pool is reset.
"""
import importlib.util
import json
from pathlib import Path
from urllib.request import urlopen

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import ServingConfig as JServingConfig
from paddle_tpu.inference import ServingEngine as JServingEngine
from paddle_tpu.models import GPTConfig as JGPTConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu.obs import memz as j_memz
from paddle_tpu.obs import probez as j_probez
import paddle_tpu_torch as pt
from paddle_tpu_torch.obs import memz as t_memz
from paddle_tpu_torch.obs import probez as t_probez
from paddle_tpu_torch.obs import lint_exposition

_SMOKE = Path(__file__).resolve().parents[1] / "chip_smoke.py"
_spec = importlib.util.spec_from_file_location("chip_smoke", _SMOKE)
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

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


def _config(**kw):
    base = dict(max_batch=2, prompt_cap=CAP, max_new_tokens=NEW,
                decode_chunk=2, paged=True, kv_block=4, prefix_cache=True,
                kv_blocks=40)
    base.update(kw)
    return base


# ------------------------------------------------------------------ memz

def _ledger_calls(led):
    state = {"bytes": 300, "used": 5}
    led.set("params", 600, kind="params")
    led.register("pool", lambda: state, kind="kv", meta={"blocks": 8})
    led.set("cache", 250, kind="kv", overlay=True)
    led.set("spill", 9000, kind="spill", device=False)
    for v in (320, 400, 380):
        state["bytes"] = v
        led.sample("pool")
    led.set("params", 640)
    return led


def _strip(obj):
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items()
                if k not in ("ts", "source")}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


def test_ledger_census_deltas_and_text_match(tmp_path):
    kw = dict(allocated_fn=lambda: 2000, capacity_bytes=2100)
    jl = _ledger_calls(j_memz.MemoryLedger(**kw))
    tl = _ledger_calls(t_memz.MemoryLedger(device="cpu", **kw))
    assert _strip(tl.census()) == _strip(jl.census())
    assert _strip(tl.deltas()) == _strip(jl.deltas())
    assert tl.metrics_text() == jl.metrics_text()
    assert tl.statusz_block() == jl.statusz_block()
    assert tl.top_owners(2) == jl.top_owners(2)
    assert tl.quick_stats() == jl.quick_stats()
    jrow, trow = [], []
    jl.on_row, tl.on_row = jrow.append, trow.append
    assert _strip(tl.check_headroom()) == _strip(jl.check_headroom())
    assert _strip(trow) == _strip(jrow) and "headroom_low" in trow[0]
    err = RuntimeError("CUDA out of memory. Tried to allocate 2.00 GiB")
    paths = [led.post_mortem(error=err, context={"step": 7},
                             dir=str(tmp_path / name))
             for name, led in (("j", jl), ("t", tl))]
    assert t_memz.render_report(paths[1]) == j_memz.render_report(paths[0])
    pm = t_memz.load_postmortem(paths[1])
    assert pm["oom"]["largest_owner"] == "params"
    assert pm["oom"]["is_alloc_failure"] is True


def test_looks_like_oom_and_cpu_ledger(monkeypatch):
    assert t_memz.looks_like_oom(torch.cuda.OutOfMemoryError("boom"))
    assert t_memz.looks_like_oom(RuntimeError(
        "CUDA error: out of memory"))
    assert t_memz.looks_like_oom(MemoryError())
    assert not t_memz.looks_like_oom(KeyError("kv_pool"))
    led = t_memz.MemoryLedger(device="cpu").set("a", 10)
    c = led.census()
    assert c["allocated_bytes"] is None and c["capacity_bytes"] is None
    assert c["source"] is None and c["attributed_bytes"] == 10
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_memz.MemoryLedger()


# ---------------------------------------------------------------- probez

def test_config_fingerprint_components_match_but_versions():
    env = {"PADDLE_TPU_X": "1"}
    for kw in (_config(), _config(spec_decode=True, spec_k=3,
                                  cache_dtype="int8")):
        j = j_probez.config_fingerprint(JGPTConfig(**CFG),
                                        JServingConfig(**kw), env=env)
        t = t_probez.config_fingerprint(pt.GPTConfig(**CFG),
                                        pt.ServingConfig(**kw), env=env)
        jc, tc = j["components"], t["components"]
        assert tc["serving"] == jc["serving"] and tc["env"] == jc["env"]
        shared = set(tc["model"]) & set(jc["model"])
        assert {k: tc["model"][k] for k in shared} == \
            {k: jc["model"][k] for k in shared}
        assert set(jc["model"]) <= set(tc["model"])
        assert set(tc["versions"]) == {"torch", "cuda", "card"}
        assert tc["versions"]["torch"] == torch.__version__
    again = t_probez.config_fingerprint(pt.GPTConfig(**CFG),
                                        pt.ServingConfig(**_config()),
                                        env=env)
    assert again["sha"] == t_probez.config_fingerprint(
        pt.GPTConfig(**CFG), pt.ServingConfig(**_config()), env=env)["sha"]


def test_prober_goldens_pass_then_corruption_fails_prefix_hit(models):
    jm, tm = models
    jeng = JServingEngine(jm, JServingConfig(**_config()))
    teng = pt.ServingEngine(tm, pt.ServingConfig(**_config()))
    jpr, tpr = j_probez.Prober(jeng), t_probez.Prober(teng)
    assert set(tpr.variants) == set(jpr.variants) == {
        "decode", "prefix_miss", "prefix_hit"}
    for name in tpr.variants:
        np.testing.assert_array_equal(tpr.variants[name],
                                      jpr.variants[name])
        np.testing.assert_array_equal(tpr.golden(name), jpr.golden(name))
    rows = []
    teng.metrics.on_record = rows.append
    for pr in (jpr, tpr):
        pr.warm()
        assert not pr.failing and pr.probez()["state"] == "passing"
    assert teng.metrics.counters == jeng.metrics.counters
    assert teng.metrics.counters["requests"] == 0       # probes only
    assert tpr.metrics_text() == jpr.metrics_text().replace(
        _latency_lines(jpr), _latency_lines(tpr))
    blocks = tpr.probe_blocks("prefix_hit")
    assert blocks
    for blk in blocks:            # zeros leave the tiny model's chains
        cs.flip_bytes(torch, teng, blk)
    res = tpr.probe_once()
    assert res["results"]["prefix_hit"]["status"] == "fail"
    assert res["results"]["decode"]["status"] == "pass"
    assert res["results"]["prefix_miss"]["status"] == "pass"
    fails = [r for r in rows if "probe_fail" in r]
    assert len(fails) == 1 and fails[0]["probe_fail"]["variant"] == \
        "prefix_hit"
    assert fails[0]["probe_fail"]["first_divergence"] is not None
    tpr.probe_once()                       # still failing: no second row
    assert len([r for r in rows if "probe_fail" in r]) == 1
    assert tpr.probez()["state"] == "failing"


def _latency_lines(pr):
    return "\n".join(line for line in pr.metrics_text().splitlines()
                     if "last_latency_seconds{" in line)


def test_invariant_auditor_catches_a_planted_refcount_leak(models):
    _, tm = models
    eng = pt.ServingEngine(tm, pt.ServingConfig(**_config(
        cache_dtype="int8")))
    rows = []
    eng.metrics.on_record = rows.append
    for p in (np.arange(1, 9), np.arange(1, 6)):
        eng.submit(p)
    eng.drain()
    aud = t_probez.InvariantAuditor(eng)
    assert not aud.audit()["violating"]
    blk = eng._prefix.match(np.arange(1, 9))[0][0]
    eng._pool._refs[blk] += 1                    # the planted leak
    s = aud.audit()
    assert s["violating"] and not s["ok"]["owner_refcounts"]
    assert [r["invariant_violation"]["check"] for r in rows
            if "invariant_violation" in r] == ["owner_refcounts"]
    eng._pool._refs[blk] -= 1
    assert not aud.audit()["violating"]
    assert any("invariant_clear" in r for r in rows)
    assert "paddle_tpu_invariant_ok{check=\"owner_refcounts\"} 1" in \
        aud.metrics_text()


# ---------------------------------------------------------------- server

ROUTES = ["/metrics", "/healthz", "/statusz", "/tracez",
          "/tracez?order=slowest&fmt=chrome", "/memz?deltas=4", "/probez"]


def _no_device_reads(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("a scrape read a tensor's values")
    for name in ("cpu", "item", "tolist", "numpy"):
        monkeypatch.setattr(torch.Tensor, name, boom)
    monkeypatch.setattr(torch.cuda, "synchronize", boom)


def test_scrapes_make_no_device_reads(models, monkeypatch):
    _, tm = models
    eng = pt.ServingEngine(tm, pt.ServingConfig(**_config(
        spill_host_bytes=1 << 20)))
    srv = eng.serve_telemetry(prober=True, invariant_interval=0.05,
                              slo="ttft_p99=1s,goodput=0.5",
                              poll_interval=0.05)
    try:
        srv.prober.warm()
        with srv.prober.lock:
            for i in range(4):
                eng.submit(np.arange(1 + i, 8 + i))
            eng.drain()
        pages = {}
        with monkeypatch.context() as mp:
            _no_device_reads(mp)
            with srv.prober.lock:
                for route in ROUTES:
                    with urlopen(srv.url(route), timeout=30) as resp:
                        assert resp.status == 200, route
                        pages[route] = resp.read().decode()
        fams = lint_exposition(pages["/metrics"])
        for fam in ("paddle_tpu_serving_requests_total",
                    "paddle_tpu_serving_spill_spilled_total",
                    "paddle_tpu_hbm_bytes", "paddle_tpu_probe_pass_total",
                    "paddle_tpu_invariant_ok", "paddle_tpu_slo_burn_rate",
                    "paddle_tpu_serving_batch_compiles_total"):
            assert fam in fams, fam
        status = json.loads(pages["/statusz"])
        assert {"kv", "prefix_cache", "spill", "memory", "fingerprint",
                "compile"} <= set(status)
        memz = json.loads(pages["/memz?deltas=4"])
        owners = {d["owner"]: d["bytes"] for d in memz["owners"]}
        assert owners["kv_pool"] == sum(t.numel() * t.element_size()
                                        for layer in eng._pools
                                        for t in layer)
        assert owners["model_params"] == sum(
            p.numel() * p.element_size() for p in tm.parameters())
        assert memz["allocated_bytes"] is None       # a CPU ledger
        assert json.loads(pages["/probez"])["state"] == "passing"
        assert json.loads(pages["/healthz"])["status"] == "ok"
        traces = json.loads(pages["/tracez"])["traces"]
        assert len(traces) == 4 and all("trace_id" in t for t in traces)
        assert eng.metrics.counters["requests"] == 4
    finally:
        srv.close()
    assert all(p["errors"] == 0 for p in srv.pollers)


def test_step_oom_dumps_post_mortem_before_the_reset(models, tmp_path,
                                                     monkeypatch):
    _, tm = models
    eng = pt.ServingEngine(tm, pt.ServingConfig(**_config()))
    led = eng.attach_memory_ledger()
    led.postmortem_dir = str(tmp_path)
    eng.submit(np.arange(1, 8))
    eng.step()                                   # admitted, decoding

    def oom(*a, **k):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")
    monkeypatch.setattr(tm, "decode_paged", oom)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        eng.step()
    assert led.postmortems_total == 1
    pm = t_memz.load_postmortem(next(tmp_path.glob("oom_*.jsonl")))
    assert pm["oom"]["context"]["site"] == "serving.step"
    assert pm["oom"]["context"]["inflight"][0]["prompt_len"] == 7
    pool = next(d for d in pm["census"]["owners"] if d["owner"] == "kv_pool")
    assert pool["detail"]["used_blocks"] > 0         # before the reset
    assert eng._pool.used_blocks == 0
    assert eng.metrics.counters["errors"] == 1
