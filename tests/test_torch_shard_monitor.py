"""PyTorch port vs JAX package: StepMonitor's multi-device readers,
`record_collectives` and `record_shard_steps`, fed the same collective
ledger rows and the same per-shard step walls. Exact equality: the
gauges, report(), the exposition text, the JSONL rows (less their
timestamps), one straggler row per transition into straggling and one
clear row out of it, and the straggler counter in state_dict()."""
import json

import pytest

from paddle_tpu.profiler.monitor import StepMonitor as JStepMonitor
from paddle_tpu_torch.profiler import StepMonitor as TStepMonitor

# two collective ledger rows in trace_analysis.collective_rows()' schema
ROWS = [{"name": "ncclDevKernel_AllReduce_Sum_bf16_RING_LL", "calls": 96,
         "dur_us": 1840.5, "busy_us": 1840.5, "exposed_us": 1210.25,
         "exposed_frac": 0.6576, "bytes": 25165824, "bus_gbps": 13.67,
         "dtype": "bf16"},
        {"name": "ncclDevKernel_AllGather_RING_LL", "calls": 2,
         "dur_us": 40.0, "busy_us": 40.0, "exposed_us": 40.0,
         "exposed_frac": 1.0, "bytes": None, "bus_gbps": None}]
# one step's walls per shard: balanced, a straggler (twice, sustained),
# balanced again, a two-shard step and a one-shard step
WALLS = [{0: 0.100, 1: 0.101, 2: 0.099, 3: 0.100},
         {0: 0.100, 1: 0.240, 2: 0.101, 3: 0.099},
         {0: 0.100, 1: 0.260, 2: 0.100, 3: 0.102},
         {0: 0.101, 1: 0.103, 2: 0.100, 3: 0.099},
         {"a": 0.1, "b": 0.2},
         {0: 0.3}]


def _run(cls, tmp_path, tag):
    path = tmp_path / f"{tag}.jsonl"
    rows = []
    mon = cls(unit="tokens/s", track_memory=False, jsonl_path=str(path),
              on_report=rows.append)
    mon.record_collectives(ROWS)
    figures = [mon.record_shard_steps(w, step=i) for i, w in
               enumerate(WALLS)]
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    return mon, figures, rows, lines


def _strip(rows):
    return [{k: v for k, v in r.items() if k != "ts"} for r in rows]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("shard_monitor")
    return _run(JStepMonitor, d, "jax"), _run(TStepMonitor, d, "port")


def test_record_shard_steps_figures_match(runs):
    (jm, jfig, _, _), (tm, tfig, _, _) = runs
    assert tfig == jfig
    assert tm.shard_skew == jm.shard_skew
    assert tfig[1]["slowest_shard"] == "1" and tfig[1]["skew_ratio"] > 2


def test_one_straggler_row_per_transition(runs):
    (jm, _, jrows, jlines), (tm, _, trows, tlines) = runs
    kinds = [next(iter(k for k in e if k != "ts"))
             for e in tm.straggler_events]
    # into straggling at step 1 (held at step 2: no row), clear at step 3,
    # into it again at the two-shard step, clear at the one-shard step
    assert kinds == ["straggler", "straggler_clear", "straggler",
                     "straggler_clear"]
    assert _strip(tm.straggler_events) == _strip(jm.straggler_events)
    assert tm.stragglers_total == jm.stragglers_total == 2
    assert not tm.straggling and not jm.straggling
    assert _strip(trows) == _strip(jrows)
    assert _strip(tlines) == _strip(jlines)


def test_collective_and_skew_gauges_match(runs):
    (jm, _, _, _), (tm, _, _, _) = runs
    assert tm.collectives == jm.collectives
    jr, tr = jm.report(), tm.report()
    assert {k: jr[k] for k in tr} == tr
    for key in ("collectives", "shard_skew_ratio", "slowest_shard",
                "stragglers_total", "straggling"):
        assert key in tr
    text = tm.metrics_text(prefix="s")
    assert text == jm.metrics_text(prefix="s")
    assert 's_collective_bytes_by_dtype{dtype="bf16"} 25165824' in text
    assert 's_shard_step_seconds{shard="0"} 0.3' in text


def test_state_dict_carries_stragglers(runs):
    (jm, _, _, _), (tm, _, _, _) = runs
    assert tm.state_dict() == jm.state_dict()
    back = TStepMonitor(track_memory=False).set_state_dict(tm.state_dict())
    assert back.stragglers_total == 2
    assert TStepMonitor(track_memory=False).record_shard_steps({}) is None
