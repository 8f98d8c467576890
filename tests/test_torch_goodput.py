"""PyTorch port vs JAX package: the goodput timeline
(`profiler.timeline`, `profiler.goodput`) and TrainStep's compile / step
spans and compile accounting.

The port's TrainStep builds no executable; it keeps the JAX step's
bookkeeping over batch signatures, so the same call sequence gives the
same span categories, step numbers and compile counts on both sides (a
one-layer Linear model keeps the JAX compiles short). The report parity
tests feed both packages' `report_from` the same segment files, written
by either side's SpanRecorder or by hand with fixed clocks, and compare
`summary()`, `table()` and `metrics_text()` exactly.
"""
import json

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.profiler import goodput as jgp
from paddle_tpu.profiler import timeline as jtl
import paddle_tpu_torch as pt
from paddle_tpu_torch.profiler import goodput as tgp
from paddle_tpu_torch.profiler import timeline as ttl


def _batches():
    rng = np.random.RandomState(0)
    a = rng.randn(8, 4).astype(np.float32)
    b = rng.randn(6, 4).astype(np.float32)
    return a, b


def _jax_step(rec, mon):
    paddle.seed(0)
    lin = paddle.nn.Linear(4, 1)
    opt = paddle.optimizer.SGD(learning_rate=0.1,
                               parameters=lin.parameters())
    return paddle.jit.TrainStep(
        lin, opt, lambda x: (lin(x) ** 2).mean(), timeline=rec, monitor=mon)


def _port_step(rec, mon):
    torch.manual_seed(0)
    lin = torch.nn.Linear(4, 1)
    opt = pt.SGD(0.1, parameters=lin.named_parameters(), device="cpu")
    return pt.TrainStep(lin, opt, lambda x: (lin(x) ** 2).mean(),
                        timeline=rec, monitor=mon, device="cpu")


def _drive(step, wrap):
    a, b = _batches()
    step(wrap(a))
    step(wrap(a))
    step(wrap(b))                       # a new signature: a recompile
    step(wrap(a))                       # built before: a step
    stacked = np.stack([a, a])
    step.run_steps(2, wrap(stacked))    # its own kind: a compile
    step.run_steps(2, wrap(stacked))
    step.run_steps(2, wrap(stacked))


@pytest.fixture(scope="module")
def driven():
    out = {}
    for side, mk, wrap, tl in (
            ("jax", _jax_step, paddle.to_tensor, jtl),
            ("port", _port_step, torch.from_numpy, ttl)):
        rec = tl.SpanRecorder()
        mon = (paddle.profiler.StepMonitor() if side == "jax"
               else pt.profiler.StepMonitor())
        _drive(mk(rec, mon), wrap)
        out[side] = (rec, mon)
    return out


def test_train_step_spans_have_the_jax_categories_and_steps(driven):
    def shape(rec):
        return [(s.cat, s.step, s.steps) for s in rec.spans()]
    jspans, tspans = shape(driven["jax"][0]), shape(driven["port"][0])
    assert tspans == jspans
    assert tspans == [("compile", 1, 1), ("step", 2, 1), ("compile", 3, 1),
                      ("step", 4, 1), ("compile", 6, 2), ("step", 8, 2),
                      ("step", 10, 2)]


def test_compile_accounting_matches_jax(driven):
    jmon, tmon = driven["jax"][1], driven["port"][1]
    assert (tmon.compiles, tmon.recompiles) == \
        (jmon.compiles, jmon.recompiles) == (3, 1)
    assert [r["compiled"] for r in tmon.records] == \
        [r["compiled"] for r in jmon.records]
    assert [r["steps"] for r in tmon.records] == \
        [r["steps"] for r in jmon.records]
    assert [e["kind"] for e in tmon.recompile_events] == \
        [e["kind"] for e in jmon.recompile_events] == ["train_step"]
    assert "leaf[0]: ((8, 4), 'float32') -> ((6, 4), 'float32')" in \
        tmon.recompile_events[0]["delta"]


def test_installed_recorder_is_the_fallback():
    rec = ttl.SpanRecorder()
    with ttl.installed(rec):
        step = _port_step(None, None)
        x = torch.ones(2, 4)
        step(x)
        step(x)
    assert ttl.current() is None
    assert [s.cat for s in rec.spans()] == ["compile", "step"]


def _write(path, rows):
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")


def _restart_segments(tmp_path):
    """Two segments of one job: the first dies after step 4 (exit stamp
    at 2.9 s), the second starts 5 s later from the step-2 checkpoint, so
    steps 3-4 run again (replay) and the gap is restart downtime."""
    d = tmp_path / "segs"
    d.mkdir()
    _write(d / "a.timeline.jsonl", [
        {"segment": {"id": "a", "pid": 1, "wall0": 1000.0,
                     "start_step": None, "meta": {}}},
        {"cat": "compile", "t0": 0.0, "t1": 1.0, "step": 1},
        {"cat": "step", "t0": 1.0, "t1": 1.5, "step": 2},
        {"cat": "ckpt_blocking", "t0": 1.5, "t1": 1.7},
        {"cat": "input_wait", "t0": 1.7, "t1": 1.8},
        {"cat": "step", "t0": 1.8, "t1": 2.3, "step": 3},
        {"cat": "step", "t0": 2.4, "t1": 2.9, "step": 4},
        {"exit": {"t": 2.9, "reason": "preemption", "step": 4}}])
    _write(d / "b.timeline.jsonl", [
        {"segment": {"id": "b", "pid": 2, "wall0": 1007.9,
                     "start_step": 2, "meta": {}}},
        {"cat": "compile", "t0": 0.0, "t1": 0.8, "step": 3},
        {"cat": "step", "t0": 0.8, "t1": 1.3, "step": 4},
        {"cat": "step", "t0": 1.3, "t1": 1.8, "step": 5},
        {"cat": "eval", "t0": 1.9, "t1": 2.1},
        {"cat": "step", "t0": 2.1, "t1": 2.6, "step": 6}])
    return d


def test_reports_over_the_same_spans_are_equal(tmp_path):
    d = _restart_segments(tmp_path)
    jr, tr = jgp.report_from(str(d)), tgp.report_from(str(d))
    assert tr.summary() == jr.summary()
    assert tr.metrics_text() == jr.metrics_text()
    assert tr.table() == jr.table()


def test_segments_stitched_across_a_restart_conserve(tmp_path):
    d = _restart_segments(tmp_path)
    r = tgp.report_from(str(d))
    r.check_conservation()
    s = r.summary()
    assert s["segments"] == 2 and s["restarts"] == 1
    assert s["replayed_steps"] == 2           # steps 3 and 4 ran twice
    assert s["badput_s"]["restart_downtime"] == pytest.approx(5.0)
    assert s["badput_s"]["replay"] == pytest.approx(0.5)
    assert s["wall_s"] == pytest.approx(10.5)
    assert s["goodput_s"] == pytest.approx(2.5)
    assert s["goodput_ratio"] == pytest.approx(2.5 / 10.5, abs=1e-6)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_segment_files_keep_the_jax_format(tmp_path, writer):
    """A segment file written by either package's SpanRecorder reads the
    same in both."""
    tl = jtl if writer == "jax" else ttl
    path = tmp_path / ("w" + ttl.SEGMENT_SUFFIX)
    rec = tl.SpanRecorder(str(path), meta={"job": "t"})
    rec.record("compile", 0.0, 0.4, step=1)
    rec.record("step", 0.4, 0.6, step=2)
    rec.record("step", 0.6, 1.0, step=4, steps=2)
    rec.record("other", 1.0, 1.1, note="x")
    rec.mark_exit(reason="done", step=4)
    rec.close()
    js, ts = jtl.load_segments(str(path)), ttl.load_segments(str(path))
    assert [(s.segment_id, s.wall0, s.exit_row) for s in ts] == \
        [(s.segment_id, s.wall0, s.exit_row) for s in js]
    assert [sp.to_row() for sp in ts[0].spans] == \
        [sp.to_row() for sp in js[0].spans]
    jr, tr = jgp.report_from(str(path)), tgp.report_from(str(path))
    assert tr.summary() == jr.summary()
    tr.check_conservation()


def test_unknown_category_and_overlap_are_refused():
    rec = ttl.SpanRecorder()
    with pytest.raises(ValueError, match="unknown timeline category"):
        rec.record("nap", 0.0, 1.0)
    rec.record("step", 0.0, 1.0, step=1)
    rec.record("compile", 0.5, 1.5)
    with pytest.raises(tgp.ConservationError):
        tgp.GoodputReport([ttl.from_recorder(rec)], eps=0.01)\
            .check_conservation()
