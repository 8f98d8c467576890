"""PyTorch port vs JAX package: the flight recorder (`obs.flightrec`),
its /profilez route on a serving engine, and TrainStep's memory ledger.

Ring parity: the same step brackets and structured rows (alerts,
recompiles, numerics events, clear rows, storms inside a capture and
inside the cooldown) drive a JAX and a port FlightRecorder, both with
`FixtureBackend` and the same injected cooldown clock — the JAX one over
its `mini_step` trace, the port's over the same device work in
`torch.profiler`'s CUDA format (`test_torch_profiler._cuda_events`);
their rings (kinds, pins, steps, trigger kinds), counters, exposition
and /profilez totals must be equal. `TorchProfilerBackend`
runs a real `torch.profiler` capture, which on the CPU holds no GPU lane
and is read through the host-lane fallback.
"""
import gzip
import json
from pathlib import Path
from urllib.request import urlopen

import numpy as np
import pytest
import torch

from paddle_tpu.obs import FixtureBackend as JFixture
from paddle_tpu.obs import FlightRecorder as JRecorder
import paddle_tpu_torch as pt
from paddle_tpu_torch.obs import (FixtureBackend, FlightRecorder,
                                  MemoryLedger, TorchProfilerBackend,
                                  lint_exposition, load_postmortem)
from paddle_tpu_torch.profiler import trace_analysis as TTA
from test_torch_profiler import _cuda_events

FIXTURE = str(Path(__file__).parent / "fixtures" / "mini_step.trace.json.gz")


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


# (action, argument): "step" runs one begin/end bracket, "tap" feeds a row
# to the trigger bus, "tick" moves the cooldown clock
SCRIPT = [
    ("step", None), ("step", None),
    ("tap", {"slo_alert": {"objective": "ttft_p99"}}),
    ("tap", {"recompile": {"kind": "train_step"}}),     # coalesces
    ("step", None),
    ("tap", {"straggler_clear": {}}),                   # inert
    ("tap", {"numerics": {"step": 3, "events": []}}),   # inert
    ("step", None), ("step", None),
    ("tap", {"numerics": {"step": 5, "events": [{"kind": "nan"}]}}),
    ("tick", 5.0),
    ("tap", {"probe_fail": {"variant": "decode"}}),     # cooldown
    ("step", None), ("step", None), ("step", None),
    ("tick", 60.0),
    ("tap", {"mem_pressure": {"free_blocks": 0}}),
    ("step", None), ("step", None), ("step", None), ("step", None),
    ("tap", {"invariant_violation": {"check": "pool"}}),
    ("step", None), ("step", None), ("step", None), ("step", None),
    ("step", None), ("step", None), ("step", None),
]


def _run(Recorder, Backend, tmp_path, name, src):
    clock = Clock()
    rec = Recorder(str(tmp_path / name), ring=3, every=4, capture_steps=1,
                   trigger_steps=2, cooldown_s=30.0,
                   backend=Backend(src), clock=clock)
    for action, arg in SCRIPT:
        if action == "step":
            rec.begin_step()
            rec.end_step()
        elif action == "tap":
            rec.tap(arg)
        else:
            clock.t += arg
    return rec


def _ring(rec):
    return [(c["kind"], c["pinned"], c["step_first"], c["step_last"],
             [t["kind"] for t in c["triggers"]],
             [t["step"] for t in c["triggers"]]) for c in rec.captures]


def test_the_same_row_stream_gives_the_jax_ring(tmp_path):
    cuda = str(tmp_path / "cuda.trace.json.gz")
    with gzip.open(cuda, "wt") as f:
        json.dump({"traceEvents": _cuda_events()}, f)
    j = _run(JRecorder, JFixture, tmp_path, "jax", FIXTURE)
    t = _run(FlightRecorder, FixtureBackend, tmp_path, "port", cuda)
    assert _ring(t) == _ring(j)
    js, ts = j.summary(), t.summary()
    js.pop("dir"), ts.pop("dir")
    assert ts == js
    assert ts["triggers_coalesced"] >= 1 and ts["triggers_suppressed"] >= 1
    assert ts["evicted_periodic"] + ts["evicted_pinned"] >= 1
    assert t.metrics_text() == j.metrics_text()
    lint_exposition(t.metrics_text())
    # the views over a retained capture equal the JAX recorder's
    cid = t.captures[-1]["id"]
    for view in ("kernel", "device", "distributed"):
        tp = t.profilez({"id": cid, "view": view})
        jp = j.profilez({"id": cid, "view": view})
        assert tp["total_device_us"] == jp["total_device_us"]
        assert tp["overlap"] == jp["overlap"]


def test_a_failing_backend_counts_and_rearms(tmp_path):
    class Broken:
        def start(self):
            raise RuntimeError("tracer busy")

        def stop(self, dest):
            return None

    rec = FlightRecorder(str(tmp_path / "r"), backend=Broken(),
                         cooldown_s=0)
    rec.trigger("slo_alert")
    rec.begin_step()
    rec.end_step()
    assert rec.capture_errors == 1 and rec.summary()["active"] is None
    rec.backend = FixtureBackend(FIXTURE)
    rec.trigger("slo_alert")
    rec.begin_step()
    rec.end_step()
    rec.begin_step()
    rec.end_step()
    assert rec.captures[-1]["trace_path"] and rec.capture_errors == 1


def test_torch_profiler_backend_writes_a_trace_trace_analysis_parses(
        tmp_path):
    be = TorchProfilerBackend()
    be.start()
    x = torch.randn(64, 64)
    for _ in range(3):
        x = torch.tanh(x @ x)
    dest = str(tmp_path / "c0001.trace.json.gz")
    assert be.stop(dest) == dest
    an = TTA.analyze(dest)
    assert an.host_lanes
    names = {r["name"] for r in an.op_totals()}
    assert {"aten::tanh"} <= names and an.total_device_us() > 0
    assert be.stop(dest) is None       # nothing running


CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
           max_position_embeddings=64, intermediate_size=128)


def test_serve_telemetry_with_a_flight_recorder_serves_profilez(tmp_path):
    m = pt.GPTForCausalLM(pt.GPTConfig(**CFG), device="cpu")
    eng = pt.ServingEngine(m, pt.ServingConfig(
        max_batch=2, prompt_cap=8, max_new_tokens=6, decode_chunk=2,
        paged=True, kv_block=4, kv_blocks=24))
    rec = FlightRecorder(str(tmp_path / "fr"), trigger_steps=2,
                         backend=TorchProfilerBackend())
    srv = eng.serve_telemetry(flightrec=rec)
    try:
        assert srv.flightrec is rec and eng.monitor.flightrec is rec
        # a structured row on the engine's metrics pulls the trigger
        eng.metrics._emit({"probe_fail": {"variant": "decode"}})
        assert rec.summary()["pending"] == "c0001"
        for i in range(3):
            eng.submit(np.arange(1 + i, 7 + i))
        eng.drain()
        assert rec.captures_total == 1 and rec.capture_errors == 0
        listing = json.loads(urlopen(srv.url("/profilez"),
                                     timeout=30).read())
        cap = listing["captures"][0]
        assert cap["pinned"] and cap["triggers"][0]["kind"] == "probe_fail"
        page = json.loads(urlopen(
            srv.url(f"/profilez?id={cap['id']}&view=kernel"),
            timeout=30).read())
        assert "KernelView" in page["table"]
        assert any(r["name"].startswith("aten::") for r in page["rows"])
        metrics = urlopen(srv.url("/metrics"), timeout=30).read().decode()
        fams = lint_exposition(metrics)
        assert "paddle_tpu_flightrec_captures_pinned_total" in fams
    finally:
        srv.close()
        rec.detach()
    assert eng.monitor.flightrec is None


def _tiny_train(memz):
    cfg = pt.GPTConfig(vocab_size=64, hidden_size=32, num_layers=1,
                       num_heads=2, max_position_embeddings=16)
    m = pt.GPTForCausalLM(cfg, device="cpu")
    opt = pt.AdamW(1e-3, parameters=m.named_parameters(), device="cpu")
    mon = pt.profiler.StepMonitor()
    calls = {"n": 0, "oom_at": None}

    def loss_fn(a, b):
        calls["n"] += 1
        if calls["n"] == calls["oom_at"]:
            raise torch.cuda.OutOfMemoryError(
                "CUDA out of memory. Tried to allocate 2.00 GiB")
        return m.loss(a, b)
    step = pt.TrainStep(m, opt, loss_fn, memz=memz, monitor=mon,
                        device="cpu")
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, 64, (2, 16)).astype(np.int64))
    return m, step, mon, calls, ids


def test_train_step_memz_owners_and_oom_post_mortem(tmp_path):
    ledger = MemoryLedger(device="cpu", postmortem_dir=str(tmp_path))
    m, step, mon, calls, ids = _tiny_train(ledger)
    step(ids, ids)
    owners = {o["owner"]: o for o in ledger.census()["owners"]}
    want_params = sum(p.numel() * p.element_size() for p in m.parameters())
    want_opt = sum(v.numel() * v.element_size()
                   for st in step._opt_state for v in st.values())
    assert owners["train_params"]["bytes"] == want_params
    assert owners["train_opt_state"]["bytes"] == want_opt
    assert owners["train_params"]["kind"] == "params"
    assert owners["train_opt_state"]["kind"] == "opt_state"
    assert mon.memz is ledger
    calls["oom_at"] = calls["n"] + 1
    with pytest.raises(torch.cuda.OutOfMemoryError):
        step(ids, ids)
    files = sorted(tmp_path.glob("oom_*.jsonl"))
    assert len(files) == 1 and ledger.postmortems_total == 1
    pm = load_postmortem(str(files[0]))
    assert pm["oom"]["is_alloc_failure"] is True
    assert pm["oom"]["context"] == {"site": "train_step.launch", "step": 2}
    assert pm["oom"]["largest_owner"] == "train_opt_state"
    # an ordinary error leaves no post-mortem
    calls["oom_at"] = None
    with pytest.raises(TypeError):
        step(ids)
    assert ledger.postmortems_total == 1


def test_a_numerics_event_pins_a_capture_of_the_next_steps(tmp_path):
    """TrainStep(numerics=, monitor=) with a recorder on the monitor: a
    fetched inf event reaches the trigger bus through the monitor's
    numerics row, and the recorder captures the next steps."""
    m, _, _, _, ids = _tiny_train(None)
    mon = pt.profiler.StepMonitor()
    rec = FlightRecorder(str(tmp_path / "fr"), trigger_steps=2,
                         backend=TorchProfilerBackend()).attach(monitor=mon)
    opt = pt.AdamW(1e-3, parameters=m.named_parameters(), device="cpu")
    step = pt.TrainStep(m, opt, lambda a, b: m.loss(a, b), monitor=mon,
                        numerics=pt.debugging.NumericsConfig(
                            every_n_steps=1), device="cpu")
    step(ids, ids)
    assert rec.triggers_total == 0
    w = m.gpt.h[0].mlp.up.weight
    kept = w[0, 0].item()
    with torch.no_grad():
        w[0, 0] = float("inf")
    step(ids, ids)
    assert rec.triggers_total == 1 and rec.summary()["pending"] == "c0001"
    # the update was skipped; repaired, the next steps are clean (an
    # event on every step would keep extending the capture)
    with torch.no_grad():
        w[0, 0] = kept
    for _ in range(3):
        step(ids, ids)
    cap = rec.captures[0]
    assert cap["triggers"][0]["kind"] == "numerics" and cap["pinned"]
    assert cap["step_last"] - cap["step_first"] + 1 == 2
    assert TTA.analyze(cap["trace_path"]).total_device_us() > 0
    rec.detach()
