"""PyTorch port vs JAX package: ServingMetrics and the batch StepMonitor.

The same requests, with their traces set by hand, go through the port's
ServingMetrics and the JAX package's: the Prometheus text must be
byte-equal, the JSONL rows equal except their `ts`, and probe requests
must stay out of every user-facing family. The same compile records and
externally timed steps through both StepMonitors give equal counters and
byte-equal text.
"""
import json

import numpy as np
import pytest

from paddle_tpu.inference import Request as JRequest
from paddle_tpu.inference import ServingMetrics as JServingMetrics
from paddle_tpu.profiler.monitor import StepMonitor as JStepMonitor
from paddle_tpu_torch.inference import Request as TRequest
from paddle_tpu_torch.inference import ServingMetrics as TServingMetrics
from paddle_tpu_torch.profiler import StepMonitor as TStepMonitor


def _requests(mod, seed=0, probe_every=0):
    """A seeded stream of terminal requests of every status, with spans,
    engine windows, spec counts, reasons and retriable flags."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(60):
        u = rng.rand()
        status = ("done" if u < 0.75 else "rejected" if u < 0.85
                  else "timeout" if u < 0.95 else "error")
        plen = int(rng.randint(1, 30))
        r = mod(id=i, prompt=np.arange(1, plen + 1), max_new_tokens=16,
                status=status,
                probe=bool(probe_every and i % probe_every == 0))
        t = r.trace
        t.trace_id = f"run-{i}"
        t.t_enqueue = float(i)
        if status == "rejected":
            r.reason = ["overloaded", "queue_full", "kv_oom",
                        "draining"][i % 4]
            r.retriable = r.reason != "kv_oom"
        elif status == "timeout":
            r.reason = "queue_deadline"
            t.t_finish = t.t_enqueue + float(rng.uniform(0.5, 3))
        elif status == "error":
            r.reason = "engine_exception"
            t.t_admit = t.t_enqueue + 0.01
            t.t_finish = t.t_enqueue + 0.2
        else:
            q, pf, dec = (float(x) for x in rng.lognormal(-4, 1, 3))
            t.t_admit = t.t_enqueue + q
            t.t_prefill_done = t.t_admit + pf
            t.t_first_token = t.t_prefill_done
            t.t_finish = t.t_first_token + dec
            t.batch_id = i // 3
            t.events = [("prefill", t.t_admit, t.t_prefill_done),
                        ("decode", t.t_prefill_done, t.t_finish)]
            r.n_out = int(rng.randint(1, 17))
            if i % 5 == 0:
                r.spec_proposed, r.spec_accepted = 12, int(rng.randint(13))
        out.append(r)
    return out


def _feed(mod, met, **kw):
    for r in _requests(mod, **kw):
        met.record_request(r)
    met.record_batch(n_real=3, capacity=4, kv_tokens=100, kv_slots=128,
                     kv_capacity=512, queue_depth=2, kv_shared_tokens=32)
    for n in (1, 3, 4, 4):
        met.hists["spec_accept_len"].observe(n)
    met.observe_call(0.25, items=3)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_text_and_jsonl_rows_match(seed, tmp_path):
    rows = {"jax": [], "torch": []}
    jm = JServingMetrics(jsonl_path=str(tmp_path / "j.jsonl"),
                         on_record=rows["jax"].append)
    tm = TServingMetrics(jsonl_path=str(tmp_path / "t.jsonl"),
                         on_record=rows["torch"].append)
    _feed(JRequest, jm, seed=seed)
    _feed(TRequest, tm, seed=seed)
    assert tm.metrics_text() == jm.metrics_text()
    assert tm.metrics_text(prefix="x") == jm.metrics_text(prefix="x")
    assert tm.summary() == jm.summary()
    jf, tf = jm.flush(), tm.flush()
    assert {k: v for k, v in tf.items() if k != "ts"} == \
        {k: v for k, v in jf.items() if k != "ts"}

    def strip(lines):
        return [{k: v for k, v in json.loads(x).items() if k != "ts"}
                for x in lines]
    jl = (tmp_path / "j.jsonl").read_text().splitlines()
    tl = (tmp_path / "t.jsonl").read_text().splitlines()
    assert strip(tl) == strip(jl) and len(tl) == 61
    assert [{k: v for k, v in r.items() if k != "ts"}
            for r in rows["torch"]] == \
        [{k: v for k, v in r.items() if k != "ts"} for r in rows["jax"]]


def test_request_record_and_span_tree_match():
    for jr, tr in zip(_requests(JRequest), _requests(TRequest)):
        assert tr.record() == jr.record()
        assert tr.trace.span_tree() == jr.trace.span_tree()
        assert tr.trace.to_dict() == jr.trace.to_dict()


@pytest.mark.parametrize("mod, met_cls", [(JRequest, JServingMetrics),
                                          (TRequest, TServingMetrics)],
                         ids=["jax", "torch"])
def test_probe_requests_stay_out_of_user_families(mod, met_cls):
    """Probe requests change neither the user-facing page nor the trace
    ring; they reach only the probe families."""
    from paddle_tpu_torch.obs import TraceBuffer
    plain, probed = met_cls(), met_cls()
    plain.trace_buffer, probed.trace_buffer = TraceBuffer(), TraceBuffer()
    users = [r for r in _requests(mod, probe_every=4) if not r.probe]
    for r in users:
        plain.record_request(r)
    for r in _requests(mod, probe_every=4):
        probed.record_request(r)
    assert probed.metrics_text() == plain.metrics_text()
    assert probed.trace_buffer.summary()["seen"] == len(users)
    assert probed.probe_counters["requests"] == 15
    assert "probe_serving_requests_total 15" in probed.probe_metrics_text()


def test_probe_metrics_text_matches():
    jm, tm = JServingMetrics(), TServingMetrics()
    for r in _requests(JRequest, probe_every=3):
        jm.record_request(r)
    for r in _requests(TRequest, probe_every=3):
        tm.record_request(r)
    assert tm.probe_metrics_text() == jm.probe_metrics_text()
    assert tm.probe_reject_reasons == jm.probe_reject_reasons
    assert tm.metrics_text() == jm.metrics_text()


def _monitor_run(cls):
    mon = cls(unit="tokens/s", track_memory=False, log_recompiles=False)
    sig = (((4, 8), "int64"), ((4,), "int32"))
    mon.record_compile("serving_batch", sig)
    mon.end_step(items=12, wall_s=0.5)
    for i in range(6):
        if i == 3:
            mon.record_compile("serving_batch", sig, prev_sig=(
                ((4, 9), "int64"), ((4,), "int32")))
        mon.end_step(items=10 + i, wall_s=0.1 + 0.01 * i)
    mon.record_compile("serving_reject", sig, prev_sig=sig, count=False)
    return mon


def test_step_monitor_counters_and_text_match():
    jmon, tmon = _monitor_run(JStepMonitor), _monitor_run(TStepMonitor)
    assert (tmon.compiles, tmon.recompiles) == (jmon.compiles,
                                                jmon.recompiles) == (2, 1)
    assert tmon.recompile_events == jmon.recompile_events
    assert tmon.metrics_text(prefix="s") == jmon.metrics_text(prefix="s")
    jr, tr = jmon.report(), tmon.report()
    assert {k: jr[k] for k in tr} == tr
    assert tmon.state_dict() == {k: v for k, v in jmon.state_dict().items()
                                 if k != "stragglers"}
    strip = [{k: v for k, v in r.items() if k != "ts"}
             for r in tmon.records]
    assert strip == [{k: v for k, v in r.items() if k != "ts"}
                     for r in jmon.records]


@pytest.mark.parametrize("what", ["record_overlap", "record_collectives",
                                  "record_shard_steps"])
def test_step_monitor_later_readers_raise(what):
    with pytest.raises(NotImplementedError, match="queue A"):
        getattr(TStepMonitor(), what)({})
