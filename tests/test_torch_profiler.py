"""PyTorch port vs JAX package: the Paddle profiler API
(`paddle_tpu_torch.profiler`), trace analysis over `torch.profiler`'s
chrome trace, and `StepMonitor.record_overlap`.

The trace-analysis parity test builds, in this file, a capture in
`torch.profiler`'s CUDA chrome-trace format (`kernel` / `gpu_memcpy`
events on a GPU pid, one lane per stream, beside the host's `cpu_op`,
`cuda_runtime`, `user_annotation`, `gpu_user_annotation`, flow and
envelope events that are not device ops) holding the same device work
as the JAX package's `tests/fixtures/mini_step.trace.json.gz` in the XLA
format; both analyses must give equal totals, categories, lane busy
times and overlap (exact: the same microsecond sums). Without a card,
the real capture here is a CPU `torch.profiler` run, which trace
analysis reads through the host-lane fallback.
"""
import gzip
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import GPTConfig as JGPTConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu.profiler import trace_analysis as JTA
import paddle_tpu_torch as pt
from paddle_tpu_torch import profiler as tprof
from paddle_tpu_torch.profiler import trace_analysis as TTA

FIXTURE = Path(__file__).parent / "fixtures" / "mini_step.trace.json.gz"

# the fixture's XLA op -> a kernel of the same category in a CUDA capture
# (fusion: one of the port's own kernels)
KERNEL_OF = {
    "fusion.1": "void (anonymous namespace)::wg::fwd_wg<128, false, 2>"
                "((anonymous namespace)::wg::Params)",
    "convolution.2": "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_"
                     "tilesize128x128x64_warpgroupsize1x1x1",
    "all-reduce.3": "ncclDevKernel_AllReduce_Sum_bf16_RING_LL("
                    "ncclDevKernelArgsStorage<4096ul>)",
    "copy.4": "Memcpy DtoD (Device -> Device)",
}
STREAM_OF = {0: 7, 1: 13}          # XLA tid -> CUDA stream


def _jax_events():
    with gzip.open(FIXTURE, "rt") as f:
        return json.load(f)["traceEvents"]


def _cuda_events():
    """The fixture's device work as a torch.profiler CUDA capture."""
    host_pid, host_tid = 4242, 4242
    ev = [
        {"ph": "M", "pid": host_pid, "name": "process_name",
         "args": {"name": "python3 4242"}},
        {"ph": "M", "pid": 0, "name": "process_name",
         "args": {"name": "GPU 0"}},
        {"ph": "M", "pid": 0, "tid": 7, "name": "thread_name",
         "args": {"name": "stream 7 "}},
        {"ph": "M", "pid": 0, "tid": 13, "name": "thread_name",
         "args": {"name": "stream 13 "}},
        {"ph": "X", "cat": "Trace", "name": "PyTorch Profiler (0)",
         "pid": "Spans", "tid": "PyTorch Profiler", "ts": 0, "dur": 1700},
    ]
    for e in _jax_events():
        if e.get("ph") != "X" or e.get("pid") != 1:
            continue
        name = KERNEL_OF[e["name"]]
        cat = "gpu_memcpy" if name.startswith("Memcpy") else "kernel"
        ts = 1_000_000.0 + e["ts"]
        ev.append({"ph": "X", "cat": cat, "name": name, "pid": 0,
                   "tid": STREAM_OF[e["tid"]], "ts": ts, "dur": e["dur"],
                   "args": {"device": 0, "stream": STREAM_OF[e["tid"]],
                            "correlation": len(ev)}})
        # what the host did for it: not device ops
        ev.append({"ph": "X", "cat": "cuda_runtime",
                   "name": "cudaLaunchKernel", "pid": host_pid,
                   "tid": host_tid, "ts": ts - 5, "dur": 4})
        ev.append({"ph": "s", "cat": "ac2g", "name": "ac2g", "id": len(ev),
                   "pid": host_pid, "tid": host_tid, "ts": ts - 5})
    for step in range(2):
        t0 = 1_000_000.0 + 1000 * step
        ev += [{"ph": "X", "cat": "user_annotation",
                "name": f"ProfilerStep#{step}", "pid": host_pid,
                "tid": host_tid, "ts": t0 - 10, "dur": 700},
               {"ph": "X", "cat": "gpu_user_annotation",
                "name": f"ProfilerStep#{step}", "pid": 0, "tid": 7,
                "ts": t0, "dur": 650},
               {"ph": "X", "cat": "cpu_op", "name": "aten::mm",
                "pid": host_pid, "tid": host_tid, "ts": t0 - 8, "dur": 30}]
    return ev


def _mapped(rows):
    return sorted((KERNEL_OF.get(r["name"], r["name"]), r["calls"],
                   r["dur_us"], round(r["pct"], 9), r["category"])
                  for r in rows)


def test_trace_analysis_of_a_cuda_capture_equals_jax_on_the_xla_fixture():
    ja = JTA.TraceAnalysis(_jax_events(), steps=2)
    ta = TTA.TraceAnalysis(_cuda_events(), steps=2)
    assert not ta.host_lanes
    assert len(ta.device_events) == len(ja.device_events) == 8
    assert _mapped(ja.op_totals()) == _mapped(ta.op_totals())
    assert ta.total_device_us() == ja.total_device_us() == 1300
    assert ta.category_totals() == ja.category_totals() == {
        "fusion": 600, "compute": 400, "collective": 200, "copy": 100}
    assert [(r["busy_us"], r["ops"]) for r in ta.lane_busy()] == \
        [(r["busy_us"], r["ops"]) for r in ja.lane_busy()] == \
        [(1100, 6), (200, 2)]
    assert [r["lane"] for r in ta.lane_busy()] == ["GPU 0/stream 7 ",
                                                   "GPU 0/stream 13 "]
    assert ta.overlap() == ja.overlap()
    assert ta.overlap()["ratio"] == 0.5
    jc, tc = ja.collective_rows(), ta.collective_rows()
    keys = ("calls", "dur_us", "busy_us", "overlapped_us", "exposed_us",
            "exposed_frac")
    assert [{k: r[k] for k in keys} for r in tc] == \
        [{k: r[k] for k in keys} for r in jc]


@pytest.mark.parametrize("window", [(0.0, 1.0), (0.0, 0.5), (0.5, 1.0)])
def test_window_trims_like_jax(window):
    ja = JTA.TraceAnalysis(_jax_events(), window=window)
    ta = TTA.TraceAnalysis(_cuda_events(), window=window)
    assert ta.total_device_us() == ja.total_device_us()
    assert ta.category_totals() == ja.category_totals()


def test_views_and_kernel_diff_render_like_jax(tmp_path):
    ja = JTA.TraceAnalysis(_jax_events(), steps=2)
    ta = TTA.TraceAnalysis(_cuda_events(), steps=2)

    def numbers(text):
        """The numeric columns of every table row (names hold digits)."""
        return [line.split()[:3] for line in text.splitlines()
                if line.split() and line.split()[0][0].isdigit()]
    assert numbers(ta.kernel_view()) == numbers(ja.kernel_view())
    assert numbers(ta.device_view().split("category split")[1]) == \
        numbers(ja.device_view().split("category split")[1])
    assert "overlap ratio 0.50" in ta.distributed_view()
    diff = TTA.kernel_diff(ta, ta)
    assert TTA.diff_regressions(diff, regress_pct=0.0, min_us=0.0) == []
    # the first step alone against the two-step capture
    jd = JTA.kernel_diff(JTA.TraceAnalysis(_jax_events(), steps=1,
                                           window=(0.0, 0.5)), ja)
    td = TTA.kernel_diff(TTA.TraceAnalysis(_cuda_events(), steps=1,
                                           window=(0.0, 0.5)), ta)
    assert td["total"] == jd["total"]
    assert sorted((KERNEL_OF.get(r["name"], r["name"]), r["delta_us"])
                  for r in td["kernels"]) == \
        sorted((r["name"] if r["name"] in KERNEL_OF.values()
                else KERNEL_OF[r["name"]], r["delta_us"])
               for r in jd["kernels"])
    assert "KernelDiff" in TTA.format_kernel_diff(td)
    path = tmp_path / "cap.pt.trace.json.gz"
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": _cuda_events()}, f)
    out = TTA.summarize(str(tmp_path), views=["kernel", "device",
                                              "distributed"], steps=2)
    assert "KernelView" in out and "DeviceView" in out \
        and "DistributedView" in out


@pytest.mark.parametrize("name, category", [
    ("void (anonymous namespace)::wg::dkv_wg<128, false, 2, false>(P)",
     "fusion"),
    ("_ZN12_GLOBAL__N_16lce_wgEv", "fusion"),
    ("lce_merge(float const*, int)", "fusion"),
    ("void mhb_db<32>(Params)", "fusion"),
    ("decode_part<2, false, __nv_bfloat16, __nv_bfloat16>", "fusion"),
    ("ncclKernel_AllGather_RING_LL_Sum_int8_t", "collective"),
    ("Memset (Device)", "copy"),
    ("void at::native::unrolled_elementwise_kernel<at::native::"
     "direct_copy_kernel_cuda(at::TensorIteratorBase&)", "copy"),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<>",
     "copy"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "AUnaryFunctor<float, float, float, at::native::binary_internal::"
     "MulFunctor<float> > >", "compute"),
    ("my_fwd_wg_kernel", "compute"),
])
def test_classify_op(name, category):
    assert TTA.classify_op(name) == category


def test_port_kernels_are_every_global_function_of_the_sources():
    """The fusion category reads its names from ops/cuda/csrc: one name for
    each `__global__` declaration there, each classified as fusion under
    its plain, templated and mangled names."""
    from paddle_tpu_torch.ops.cuda import build
    srcs = [src.read_text() for src in build.CSRC.glob("*.cu*")]
    read = [n for text in srcs for n in build._GLOBAL_RE.findall(text)]
    # every declaration is read (a kernel may be declared in two sources)
    assert len(read) == sum(text.count("__global__") for text in srcs)
    assert sorted(TTA.PORT_KERNELS) == sorted(set(read))
    assert {"fwd_wg", "dq_wg", "dkv_wg", "lce_wg", "decode_part",
            "prefix_tc", "i8_wg", "ln_fwd_rows", "mhb_fwd"} \
        <= set(TTA.PORT_KERNELS)
    for name in TTA.PORT_KERNELS:
        for shown in (name, f"void {name}<2, true>(Params)",
                      f"_ZN12_GLOBAL__N_1{len(name)}{name}Ev"):
            assert TTA.classify_op(shown) == "fusion", shown


def test_host_lane_fallback_keeps_the_innermost_operators():
    pid = 1
    ev = [{"ph": "X", "cat": "cpu_op", "name": n, "pid": pid, "tid": 1,
           "ts": ts, "dur": d}
          for n, ts, d in (("aten::linear", 0, 100), ("aten::t", 5, 10),
                           ("aten::addmm", 20, 70), ("aten::relu", 120, 30))]
    ta = TTA.TraceAnalysis(ev)
    assert ta.host_lanes
    assert [e["name"] for e in ta.device_events] == [
        "aten::t", "aten::addmm", "aten::relu"]
    assert ta.total_device_us() == 110


@pytest.mark.parametrize("kw", [
    dict(closed=1, ready=1, record=2),
    dict(closed=0, ready=0, record=1),
    dict(closed=2, ready=0, record=3, repeat=2),
    dict(closed=1, ready=2, record=1, repeat=1, skip_first=3),
    dict(closed=0, ready=1, record=2, skip_first=1),
])
def test_make_scheduler_gives_the_jax_states(kw):
    js = paddle.profiler.make_scheduler(**kw)
    ts = tprof.make_scheduler(**kw)
    assert [ts(i).name for i in range(24)] == [js(i).name for i in range(24)]


@pytest.mark.parametrize("sched", [
    dict(closed=1, ready=1, record=2, repeat=2),
    dict(closed=0, ready=0, record=3),
    (2, 5),
])
def test_profiler_calls_on_trace_ready_at_the_jax_steps(sched):
    calls = {}
    for name, mod in (("jax", paddle.profiler), ("port", tprof)):
        seen = []
        s = mod.make_scheduler(**sched) if isinstance(sched, dict) else sched
        p = mod.Profiler(scheduler=s, timer_only=True,
                         on_trace_ready=lambda pr, seen=seen:
                         seen.append(pr.step_num))
        p.start()
        for _ in range(11):
            p.step()
        p.stop()
        calls[name] = seen
    assert calls["port"] == calls["jax"] and calls["port"]


def _tiny_step():
    cfg = pt.GPTConfig(vocab_size=64, hidden_size=32, num_layers=1,
                       num_heads=2, max_position_embeddings=16)
    m = pt.GPTForCausalLM(cfg, device="cpu")
    opt = pt.AdamW(1e-3, parameters=m.named_parameters(), device="cpu")
    step = pt.TrainStep(m, opt, lambda a, b: m.loss(a, b), device="cpu")
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, 64, (2, 16)).astype(np.int64))
    return m, step, ids


def test_cpu_capture_of_a_train_step_renders_through_the_host_lanes(
        tmp_path):
    """A real torch.profiler capture on the CPU has no GPU lane: the
    summary's device tables read the host's innermost operators."""
    m, step, ids = _tiny_step()
    handle = tprof.annotate_layers(m)
    exported = tmp_path / "exported"
    prof = tprof.Profiler(
        scheduler=tprof.make_scheduler(closed=1, ready=0, record=2,
                                       repeat=1),
        trace_dir=str(tmp_path / "cap"),
        on_trace_ready=tprof.export_chrome_tracing(str(exported)))
    with prof:
        for _ in range(4):
            with tprof.RecordEvent("train_step"):
                step(ids, ids)
            prof.step()
    handle.remove()
    assert prof._recorded_steps == 2
    an = TTA.analyze(prof.last_capture, steps=2)
    assert an.host_lanes and an.total_device_us() > 0
    assert any(r["name"].startswith("aten::") for r in an.op_totals())
    text = prof.summary(views=[tprof.SummaryView.KernelView,
                               tprof.SummaryView.DeviceView,
                               tprof.SummaryView.OverView])
    assert "KernelView (device op time, 2 steps)" in text
    assert "DeviceView" in text and "train_step" in text
    names = {e.get("name") for e in TTA.load_events(prof.last_capture)
             if e.get("cat") == "user_annotation"}
    assert {"train_step", "GPTForCausalLM/gpt/h/0/attn"} <= names
    files = list(exported.iterdir())
    assert len(files) == 1
    assert tprof.load_profiler_result(str(files[0]))["traceEvents"]


def test_annotate_layers_names_the_jax_paths():
    cfg = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
               max_position_embeddings=16)
    jm = JGPT(JGPTConfig(**cfg))
    tm = pt.GPTForCausalLM(pt.GPTConfig(**cfg), device="cpu")
    jh, th = paddle.profiler.annotate_layers(jm), tprof.annotate_layers(tm)
    try:
        # the JAX GPT keeps its dropouts as layers; the port draws them
        # functionally from the model's dropout generator
        assert sorted(set(jh.paths) - set(th.paths)) == [
            "GPTForCausalLM/gpt/drop",
            *(f"GPTForCausalLM/gpt/h/{i}/{m}/dropout"
              for i in range(2) for m in ("attn", "mlp"))]
        assert set(th.paths) < set(jh.paths)
    finally:
        jh.remove()
        th.remove()
    assert "forward" not in tm.gpt.h[0].__dict__


def test_record_overlap_takes_trace_analysis_overlap(tmp_path):
    jmon = paddle.profiler.StepMonitor()
    rows = []
    tmon = tprof.StepMonitor(jsonl_path=str(tmp_path / "m.jsonl"),
                             on_report=rows.append)
    jov = JTA.TraceAnalysis(_jax_events()).overlap()
    tov = TTA.TraceAnalysis(_cuda_events()).overlap()
    assert jmon.record_overlap(jov) == tmon.record_overlap(tov)
    assert tmon.report()["overlap_ratio"] == \
        jmon.report()["overlap_ratio"] == 0.5
    assert tmon.metrics_text(prefix="t") == jmon.metrics_text(prefix="t")
    assert "t_overlap_ratio 0.5" in tmon.metrics_text(prefix="t")
    # one JSONL row, and none through on_report (as in the JAX monitor)
    lines = (tmp_path / "m.jsonl").read_text().splitlines()
    assert [list(json.loads(l)) for l in lines] == [["overlap", "ts"]]
    assert rows == []
    assert tmon.record_overlap(0.25)["ratio"] == 0.25
    assert tmon.record_overlap(None) is None
