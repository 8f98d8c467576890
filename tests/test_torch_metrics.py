"""PyTorch port vs JAX package: the exposition primitives, the metrics
registry, the tail-sampling trace ring and the SLO burn rates.

The same samples, histograms, records and request streams go through the
port's `profiler._metrics`, `obs.registry`, `obs.tracez` and `obs.slo`
and through the JAX package's; the exposition text must be byte-equal,
the lint verdicts equal, the kept trace ids equal, and the SLO rows and
the monitor's burn rates (under an injected clock) equal.
"""
import numpy as np
import pytest

from paddle_tpu.obs import registry as j_reg
from paddle_tpu.obs import slo as j_slo
from paddle_tpu.obs import tracez as j_tz
from paddle_tpu.profiler import _metrics as j_m
from paddle_tpu.inference import Request as JRequest
from paddle_tpu.inference import ServingMetrics as JServingMetrics
from paddle_tpu_torch.obs import registry as t_reg
from paddle_tpu_torch.obs import slo as t_slo
from paddle_tpu_torch.obs import tracez as t_tz
from paddle_tpu_torch.profiler import _metrics as t_m
from paddle_tpu_torch.inference import Request as TRequest
from paddle_tpu_torch.inference import ServingMetrics as TServingMetrics

VALUES = [0, 1, -3, 7.0, 0.1, 1e-7, 2.5e16, float("inf"), float("-inf"),
          float("nan"), True, False, 123456789012, 1.0 / 3.0]


@pytest.mark.parametrize("v", VALUES, ids=[repr(v) for v in VALUES])
def test_format_value_matches(v):
    assert t_m.format_value(v) == j_m.format_value(v)


def _hist(mod, samples, **kw):
    h = mod.LogHistogram(**kw)
    for s in samples:
        h.observe(s)
    return h


HIST_KW = [dict(), dict(lo=1e-3, hi=10.0, per_decade=20),
           dict(bounds=[i + 0.5 for i in range(33)])]


@pytest.mark.parametrize("kw", HIST_KW, ids=["default", "lo_hi", "bounds"])
def test_log_histogram_and_lines_match(kw):
    rng = np.random.RandomState(0)
    samples = [float(x) for x in rng.lognormal(-3, 2, 200)] + [0.0, 1e4]
    jh, th = _hist(j_m, samples, **kw), _hist(t_m, samples, **kw)
    assert th.bounds == jh.bounds and th.counts == jh.counts
    assert th.summary() == jh.summary()
    for q in (0.0, 0.25, 0.5, 0.9, 0.99, 1.0):
        assert th.percentile(q) == jh.percentile(q)
    assert t_m.histogram_lines("p", "lat", th, "h") == \
        j_m.histogram_lines("p", "lat", jh, "h")


def test_gauge_counter_labeled_lines_match():
    for args in (("p", "g", 3.5, "help"), ("", "g", None, "help"),
                 ("p", "g", 2, "help", {"a": "x", "b": "y"})):
        assert t_m.gauge_lines(*args) == j_m.gauge_lines(*args)
    for args in (("p", "c_total", 4, "help"), ("p", "c_total", None, "h")):
        assert t_m.counter_lines(*args) == j_m.counter_lines(*args)
    samples = [("a", 1), ("b", None), ("c", 2.5)]
    assert t_m.labeled_gauge_lines("p", "g", "owner", samples, "h") == \
        j_m.labeled_gauge_lines("p", "g", "owner", samples, "h")


GOOD = """# HELP demo_requests_total requests
# TYPE demo_requests_total counter
demo_requests_total 5
# HELP demo_lat_seconds latency
# TYPE demo_lat_seconds histogram
demo_lat_seconds_bucket{le="0.1"} 2
demo_lat_seconds_bucket{le="1"} 4
demo_lat_seconds_bucket{le="+Inf"} 5
demo_lat_seconds_sum 3.5
demo_lat_seconds_count 5
"""
PAGES = {
    "clean": GOOD,
    "no_type": "# HELP x y\nx 1\n",
    "type_first": "# TYPE x gauge\n# HELP x y\nx 1\n",
    "interleaved": GOOD + "demo_requests_total{a=\"b\"} 1\n",
    "duplicate": GOOD.replace("demo_requests_total 5",
                              "demo_requests_total 5\ndemo_requests_total 5"),
    "malformed": GOOD.replace("demo_requests_total 5",
                              "demo_requests_total five"),
    "counter_name": GOOD.replace("demo_requests_total",
                                 "demo_requests"),
    "noncumulative": GOOD.replace('le="1"} 4', 'le="1"} 1'),
    "inf_count": GOOD.replace("demo_lat_seconds_count 5",
                              "demo_lat_seconds_count 6"),
    "descending": GOOD.replace('le="1"} 4', 'le="0.05"} 4'),
}


def _verdict(lint, text):
    try:
        return ("ok", sorted(lint(text)))
    except ValueError as e:
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("name", sorted(PAGES))
def test_lint_verdicts_match(name):
    assert _verdict(t_reg.lint_exposition, PAGES[name]) == \
        _verdict(j_reg.lint_exposition, PAGES[name])


def _registry(mod, producers):
    reg = mod.MetricsRegistry()
    for name, fn in producers:
        reg.register(name, fn)
    return reg


@pytest.mark.parametrize("case", ["merged", "colliding", "empty_block"])
def test_registry_render_matches(case):
    producers = {
        "merged": [("a", lambda: GOOD),
                   ("b", lambda: "# HELP z_total z\n# TYPE z_total "
                                 "counter\nz_total 1\n")],
        "colliding": [("a", lambda: GOOD), ("b", lambda: GOOD)],
        "empty_block": [("a", lambda: ""), ("b", lambda: GOOD)],
    }[case]
    got = _verdict(lambda t: _registry(t_reg, producers).render(), None)
    want = _verdict(lambda t: _registry(j_reg, producers).render(), None)
    assert got == want


def _trace_stream(n=300, seed=4):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        u = rng.rand()
        if u < 0.05:
            out.append({"status": "timeout", "trace_id": f"t{i}"})
        elif u < 0.08:
            out.append({"status": "rejected", "trace_id": f"r{i}"})
        else:
            out.append({"status": "done", "trace_id": f"d{i}",
                        "e2e_s": float(rng.lognormal(-2, 1)),
                        "spans": {"t_enqueue": float(i), "t_admit":
                                  float(i) + 0.01, "t_finish":
                                  float(i) + 0.1},
                        "events": [["decode", float(i) + 0.02,
                                    float(i) + 0.05]]})
    return out


@pytest.mark.parametrize("capacity", [8, 32, 128])
def test_trace_buffer_keeps_the_same_traces(capacity):
    recs = _trace_stream()
    jb, tb = j_tz.TraceBuffer(capacity), t_tz.TraceBuffer(capacity)
    for r in recs:
        jb.add(dict(r))
        tb.add(dict(r))
    assert tb.summary() == jb.summary()
    for order in ("recent", "slowest"):
        for status in (None, "done", "timeout"):
            assert tb.snapshot(order=order, status=status, limit=None) == \
                jb.snapshot(order=order, status=status, limit=None)
    snap = tb.snapshot(limit=20)
    assert t_tz.chrome_trace(snap) == j_tz.chrome_trace(snap)


SPECS = ["ttft_p99=500ms,e2e_p90=2s,goodput=0.9", "tpot_p50=0.01",
         "queue_p99.9=1s,goodput=0"]


def _request(mod, rid, e2e, status="done"):
    r = mod(id=rid, prompt=np.arange(1, 5), max_new_tokens=4,
            status=status, n_out=4 if status == "done" else 0)
    t = r.trace
    t.trace_id = f"t-{rid}"
    t.t_enqueue, t.t_admit = 0.0, 0.01
    if status == "done":
        t.t_prefill_done, t.t_first_token = 0.02, e2e * 0.5
    else:
        r.reason = "queue_full"
    t.t_finish = e2e
    return r


def _feed(pairs, stream):
    for i, (e2e, st) in enumerate(stream):
        for mod, met in pairs:
            met.record_request(_request(mod, i, e2e, st))


@pytest.mark.parametrize("spec", SPECS)
def test_parse_and_evaluate_slo_match(spec):
    jt, tt = j_slo.parse_slo(spec), t_slo.parse_slo(spec)
    assert [vars(t) for t in tt] == [vars(t) for t in jt]
    rng = np.random.RandomState(1)
    stream = [(float(rng.lognormal(-1, 1)),
               "rejected" if rng.rand() < 0.05 else "done")
              for _ in range(200)]
    jm, tm = JServingMetrics(), TServingMetrics()
    _feed([(JRequest, jm), (TRequest, tm)], stream)
    rows = t_slo.evaluate_slo(tt, tm)
    assert rows == j_slo.evaluate_slo(jt, jm)
    assert t_slo.format_slo_table(rows) == j_slo.format_slo_table(rows)


def test_slo_monitor_burn_rates_match_under_injected_clock():
    """The same latency stream (healthy, then 5 s requests, then healthy)
    polled at the same injected times: equal windows, alerts and page."""
    seen_j, seen_t = [], []
    jm = JServingMetrics(on_record=lambda r: seen_j.append(r))
    tm = TServingMetrics(on_record=lambda r: seen_t.append(r))
    kw = dict(long_s=60.0, short_s=10.0, burn_threshold=2.0)
    jmon = j_slo.SLOMonitor("e2e_p90=1s,goodput=0.5", jm, **kw)
    tmon = t_slo.SLOMonitor("e2e_p90=1s,goodput=0.5", tm, **kw)
    rid = 0
    for t in range(0, 150, 5):
        lat = 5.0 if 30 <= t < 90 else 0.01
        for _ in range(10):
            _feed([(JRequest, jm), (TRequest, tm)], [(lat, "done")])
            rid += 1
        assert tmon.poll(float(t)) == jmon.poll(float(t))
    assert tmon.alerts_total == jmon.alerts_total == 1
    strip = [[{k: v for k, v in r.items() if k != "ts"}
              for r in rows if "request" not in r]
             for rows in (seen_t, seen_j)]
    assert strip[0] == strip[1] and len(strip[0]) == 2
    assert tmon.metrics_text() == jmon.metrics_text()
    assert tmon.summary() == jmon.summary()
    assert tmon.table() == jmon.table()
