"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, its entry points refuse to fall back to the CPU, and its CUDA
wrappers check their inputs before any launch."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch.ops.cuda import build as cuda_build
from paddle_tpu_torch.ops.cuda import fused_mha as cuda_fm
from paddle_tpu_torch.ops.cuda import flash_attention as cuda_fa
from paddle_tpu_torch.ops.cuda import fused_mha_bias as cuda_fmb
from paddle_tpu_torch.ops.cuda import layer_norm as cuda_ln
from paddle_tpu_torch.ops.cuda import paged_attention as cuda_pa

REPO = Path(__file__).resolve().parents[1]


def _foreign(name):
    return any(name == p or name.startswith(p + ".")
               for p in ("jax", "paddle_tpu"))


def test_package_imports_no_jax_and_no_paddle_tpu():
    code = ("import sys, json, paddle_tpu_torch\n"
            "import paddle_tpu_torch.ops.cuda.paged_attention\n"
            "import paddle_tpu_torch.ops.cuda.int8_matmul\n"
            "import paddle_tpu_torch.ops.cuda.flash_attention\n"
            "import paddle_tpu_torch.ops.cuda.linear_ce\n"
            "import paddle_tpu_torch.ops.cuda.fused_mha\n"
            "import paddle_tpu_torch.ops.fused_mha\n"
            "import paddle_tpu_torch.ops.cuda.fused_mha_bias\n"
            "import paddle_tpu_torch.ops.fused_mha_bias\n"
            "import paddle_tpu_torch.vision.models.swin\n"
            "import paddle_tpu_torch.models.bert\n"
            "import paddle_tpu_torch.models.vit\n"
            "import paddle_tpu_torch.ops.flash_attention\n"
            "import paddle_tpu_torch.ops.linear_ce\n"
            "import paddle_tpu_torch.incubate.nn.functional\n"
            "import paddle_tpu_torch.optimizer.optimizer\n"
            "import paddle_tpu_torch.optimizer.lr\n"
            "import paddle_tpu_torch.amp.grad_scaler\n"
            "import paddle_tpu_torch.jit.train_step\n"
            "import paddle_tpu_torch.nn.clip\n"
            "import paddle_tpu_torch.nn.layers.norm\n"
            "import paddle_tpu_torch.ops.layer_norm\n"
            "import paddle_tpu_torch.ops.cuda.layer_norm\n"
            "import paddle_tpu_torch.distributed.recompute\n"
            "import paddle_tpu_torch.vision.models.resnet\n"
            "import paddle_tpu_torch.nn.layers.conv\n"
            "import paddle_tpu_torch.nn.layers.pooling\n"
            "import paddle_tpu_torch.nn.layout\n"
            "import paddle_tpu_torch.core.flags\n"
            "import paddle_tpu_torch.models.ernie\n"
            "import paddle_tpu_torch.incubate.nn\n"
            "import paddle_tpu_torch.incubate.nn.fused_transformer\n"
            "import paddle_tpu_torch.incubate.distributed.models.moe\n"
            "import paddle_tpu_torch.nn.initializer\n"
            "import paddle_tpu_torch.profiler.monitor\n"
            "import paddle_tpu_torch.profiler._metrics\n"
            "import paddle_tpu_torch.obs.registry\n"
            "import paddle_tpu_torch.obs.tracez\n"
            "import paddle_tpu_torch.obs.server\n"
            "import paddle_tpu_torch.obs.slo\n"
            "import paddle_tpu_torch.obs.memz\n"
            "import paddle_tpu_torch.obs.probez\n"
            "import paddle_tpu_torch.analysis.findings\n"
            "import paddle_tpu_torch.inference.executables\n"
            "import paddle_tpu_torch.debugging\n"
            "import paddle_tpu_torch.debugging.sentinel\n"
            "import paddle_tpu_torch.debugging.anomaly\n"
            "import paddle_tpu_torch.debugging.dump\n"
            "import paddle_tpu_torch.amp.debugging\n"
            "import paddle_tpu_torch.profiler.trace_analysis\n"
            "import paddle_tpu_torch.profiler.timeline\n"
            "import paddle_tpu_torch.profiler.goodput\n"
            "import paddle_tpu_torch.obs.flightrec\n"
            "import paddle_tpu_torch.distributed\n"
            "import paddle_tpu_torch.distributed.fleet\n"
            "import paddle_tpu_torch.distributed.mpu\n"
            "import paddle_tpu_torch.distributed.spawn\n"
            "print(json.dumps(sorted(sys.modules)))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    import json
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    assert "paddle_tpu_torch" in mods
    assert not [m for m in mods if _foreign(m)]


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(Path(path).read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def test_sources_import_no_jax_and_no_paddle_tpu():
    files = [REPO / "chip_smoke.py"] + sorted(
        (REPO / "paddle_tpu_torch").rglob("*.py"))
    for f in files:
        bad = [n for n in _imports(f) if _foreign(n)]
        assert not bad, f"{f.relative_to(REPO)} imports {bad}"


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = pt.GPTConfig(vocab_size=32, hidden_size=32, num_layers=1,
                       num_heads=1, max_position_embeddings=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.GPTForCausalLM(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.GPTForCausalLM(cfg, device="cuda")
    m = pt.GPTForCausalLM(cfg, device="cpu")
    assert m.device.type == "cpu"
    # the training entry points default to CUDA too
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.AdamW(1e-3, parameters=m.named_parameters())
    opt = pt.AdamW(1e-3, parameters=m.named_parameters(), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.TrainStep(m, opt, lambda a, b: m.loss(a, b))
    assert pt.TrainStep(m, opt, lambda a, b: m.loss(a, b),
                        device="cpu").device.type == "cpu"


def test_training_modules_are_covered_by_the_source_check():
    """The training slice's modules are among the sources the no-JAX
    check above reads."""
    files = {f.relative_to(REPO / "paddle_tpu_torch").as_posix()
             for f in (REPO / "paddle_tpu_torch").rglob("*.py")}
    for f in ("ops/flash_attention.py", "ops/linear_ce.py",
              "ops/cuda/flash_attention.py", "ops/cuda/linear_ce.py",
              "incubate/nn/functional.py", "optimizer/optimizer.py",
              "optimizer/lr.py", "amp/grad_scaler.py", "jit/train_step.py",
              "nn/clip.py", "ops/fused_mha.py", "ops/cuda/fused_mha.py",
              "models/bert.py", "models/vit.py", "ops/fused_mha_bias.py",
              "ops/cuda/fused_mha_bias.py", "vision/models/swin.py",
              "ops/layer_norm.py", "ops/cuda/layer_norm.py",
              "nn/functional.py", "nn/layers/norm.py",
              "distributed/recompute.py", "vision/models/resnet.py",
              "nn/layers/conv.py", "nn/layers/pooling.py", "nn/layout.py",
              "core/flags.py", "core/__init__.py", "convert.py",
              "models/ernie.py", "incubate/nn/__init__.py",
              "incubate/nn/fused_transformer.py",
              "incubate/distributed/models/moe/__init__.py",
              "incubate/distributed/models/moe/gate.py",
              "incubate/distributed/models/moe/moe_layer.py",
              "nn/initializer.py", "profiler/__init__.py",
              "profiler/_metrics.py", "profiler/monitor.py",
              "obs/__init__.py", "obs/registry.py", "obs/tracez.py",
              "obs/server.py", "obs/slo.py", "obs/memz.py",
              "obs/probez.py", "analysis/__init__.py",
              "analysis/findings.py", "inference/executables.py",
              "debugging/__init__.py", "debugging/sentinel.py",
              "debugging/anomaly.py", "debugging/dump.py",
              "amp/debugging.py", "profiler/trace_analysis.py",
              "profiler/timeline.py", "profiler/goodput.py",
              "obs/flightrec.py", "distributed/__init__.py",
              "distributed/parallel.py", "distributed/mesh.py",
              "distributed/collective.py", "distributed/topology.py",
              "distributed/mpu.py", "distributed/spawn.py",
              "distributed/fleet/__init__.py",
              "distributed/fleet/strategy.py"):
        assert f in files, f


def test_observability_surface_is_exported():
    """The training half of observability is reachable the way the JAX
    package exposes it."""
    for name in ("Profiler", "RecordEvent", "make_scheduler",
                 "export_chrome_tracing", "annotate_layers",
                 "trace_analysis", "timeline", "goodput", "SpanRecorder",
                 "GoodputReport", "StepMonitor", "SummaryView"):
        assert hasattr(pt.profiler, name), name
    for name in ("NumericsConfig", "check_layer_numerics", "StatsTree",
                 "AnomalyDetector", "write_dump", "load_dump", "replay"):
        assert hasattr(pt.debugging, name), name
    for name in ("check_numerics", "TensorCheckerConfig", "DebugMode",
                 "enable_tensor_checker", "disable_tensor_checker"):
        assert hasattr(pt.amp.debugging, name), name
    assert pt.obs.FlightRecorder and pt.obs.TorchProfilerBackend


def _tiny_ernie():
    return pt.ErnieConfig(vocab_size=64, hidden_size=32, num_layers=1,
                          num_heads=2, max_position_embeddings=16)


_DEFAULT_CUDA = {
    "BertModel": lambda **kw: pt.BertModel(pt.BertConfig(
        vocab_size=64, hidden_size=32, num_layers=1, num_heads=2), **kw),
    "nn.LayerNorm": lambda **kw: pt.nn.LayerNorm(8, **kw),
    "ErnieModel": lambda **kw: pt.ErnieModel(_tiny_ernie(), **kw),
    "ErnieForMaskedLM": lambda **kw: pt.ErnieForMaskedLM(_tiny_ernie(),
                                                         **kw),
    "ErnieForSequenceClassification": lambda **kw:
        pt.ErnieForSequenceClassification(_tiny_ernie(), **kw),
    "MoELayer": lambda **kw: pt.incubate.moe.MoELayer(8, 16, 2, **kw),
    "FusedLinear": lambda **kw: pt.incubate.nn.FusedLinear(8, 4, **kw),
    "FusedBiasDropoutResidualLayerNorm": lambda **kw:
        pt.incubate.nn.FusedBiasDropoutResidualLayerNorm(8, **kw),
    "FusedMultiHeadAttention": lambda **kw:
        pt.incubate.nn.FusedMultiHeadAttention(8, 2, **kw),
    "FusedFeedForward": lambda **kw:
        pt.incubate.nn.FusedFeedForward(8, 16, **kw),
    "FusedTransformerEncoderLayer": lambda **kw:
        pt.incubate.nn.FusedTransformerEncoderLayer(8, 2, 16, **kw),
    "FusedMultiTransformer": lambda **kw:
        pt.incubate.nn.FusedMultiTransformer(8, 2, 16, num_layers=2, **kw),
    "FusedEcMoe": lambda **kw: pt.incubate.nn.FusedEcMoe(8, 16, 2, **kw),
}


@pytest.mark.parametrize("name", sorted(_DEFAULT_CUDA))
def test_new_entry_points_default_to_cuda(name, monkeypatch):
    """ERNIE and its heads, the MoE layer, every incubate.nn layer,
    BertModel and nn.LayerNorm build on CUDA unless asked for another
    device, and raise without a card rather than carry on on the CPU."""
    build = _DEFAULT_CUDA[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build()
    layer = build(device="cpu")
    assert {t.device.type for t in layer.state_dict().values()} == {"cpu"}


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Without a card the smoke script fails and prints no result, both
    in the checkout and alone in an empty directory."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text())
    for cwd, script in ((REPO, REPO / "chip_smoke.py"), (tmp_path, alone)):
        out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             env=env, capture_output=True, text=True,
                             timeout=120)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout


def _kernel_args(B=2, H=2, D=64, NB=5, bs=4, MB=2, dtype=torch.float32):
    q = torch.zeros(B, 1, H, D, dtype=dtype)
    pool = torch.zeros(NB, bs, H, D, dtype=dtype)
    tables = torch.zeros(B, MB, dtype=torch.int32)
    lens = torch.ones(B, dtype=torch.int32)
    return q, pool, pool.clone(), tables, lens


@pytest.mark.parametrize("change, match", [
    (dict(D=44), "multiple of 8"),
    (dict(D=288), "multiple of 8"),
    (dict(dtype=torch.float16), "float32 or bfloat16"),
    ({}, "needs CUDA tensors"),
])
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(change, match):
    q, kp, vp, tables, lens = _kernel_args(**change)
    with pytest.raises(ValueError, match=match):
        cuda_pa.paged_attention_cuda(q, kp, vp, tables, lens)
    assert cuda_pa.LAUNCHES["paged_attention"] == 0


@pytest.mark.parametrize("D", [80, 48, 8, 256])
def test_paged_wrappers_take_any_head_dim_multiple_of_8(D):
    """Head dims that are not a multiple of 32 (gpt3-2.7b's 80) pass the
    head-dim check of all four paged kernels; on a CPU tensor the wrapper
    then stops at the device check, before any launch."""
    q, kp, vp, tables, lens = _kernel_args(D=D)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        cuda_pa.paged_attention_cuda(q, kp, vp, tables, lens)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        cuda_pa.paged_attention_q8_cuda(q, kp.to(torch.int8), kp[..., 0],
                                        vp.to(torch.int8), vp[..., 0],
                                        tables, lens)
    qw = torch.zeros(2, 3, 2, D)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        cuda_pa.paged_prefix_attention_cuda(qw, kp, vp, tables, lens)
    assert cuda_pa.LAUNCHES["paged_attention"] == 0
    assert cuda_pa.LAUNCHES["paged_prefix_attention"] == 0


def _fmha_args(B=2, S=8, nh=2, D=64, dtype=torch.float32):
    return torch.zeros(B, S, 3 * nh * D, dtype=dtype)


@pytest.mark.parametrize("change, kw, match", [
    (dict(D=60), {}, "not 3 \\* num_heads"),
    (dict(D=68, nh=2), {}, "multiple of 8"),
    (dict(D=264, nh=16), {}, "multiple of 8 in \\[8, 256\\]"),
    (dict(D=64, nh=1), {}, "multiple of 128"),
    (dict(dtype=torch.float16), {}, "float32 or bfloat16"),
    ({}, dict(kv_len=0), "kv_len must be positive"),
    ({}, dict(kv_len=4, lens=torch.ones(2, dtype=torch.int32)),
     "not both"),
    ({}, dict(dropout_p=1.0), "dropout_p must be in"),
    ({}, {}, "need CUDA tensors"),
])
def test_fused_mha_wrapper_rejects_what_the_kernel_does_not_take(
        change, kw, match):
    """The #9 wrappers (forward and backward) raise ValueError before any
    launch on what the kernels cannot take."""
    nh = change.pop("nh", 2)
    qkv = _fmha_args(nh=nh, **change)
    if match.startswith("not 3"):
        qkv = qkv[..., :-3]
    with pytest.raises(ValueError, match=match):
        cuda_fm.fused_mha_fwd_cuda(qkv, nh, **kw)
    dout = torch.zeros(qkv.shape[0], qkv.shape[1], qkv.shape[2] // 3,
                       dtype=qkv.dtype)
    with pytest.raises(ValueError, match=match):
        cuda_fm.fused_mha_bwd_cuda(qkv, dout, None, nh, **kw)
    assert cuda_fm.LAUNCHES["fused_mha_fwd"] == 0
    assert cuda_fm.LAUNCHES["fused_mha_bwd"] == 0


def test_fused_mha_wrapper_checks_lens_and_seed():
    """lens and the seed are int32 device tensors of shape [B] and [1]; a
    dropout without a seed is refused (checked before the device)."""
    qkv = _fmha_args()
    with pytest.raises(ValueError, match="lens must be"):
        cuda_fm.fused_mha_fwd_cuda(qkv, 2, lens=torch.ones(3,
                                                           dtype=torch.int32))
    with pytest.raises(ValueError, match="seed must be"):
        cuda_fm.fused_mha_fwd_cuda(qkv, 2, dropout_p=0.1,
                                   seed=torch.ones(1, dtype=torch.int64))
    with pytest.raises(ValueError, match="requires a seed"):
        cuda_fm.fused_mha_fwd_cuda(qkv, 2, dropout_p=0.1)


def _fmb_args(B=4, S=8, nh=2, D=32, R=2, dtype=torch.float32):
    return (torch.zeros(B, S, 3 * nh * D, dtype=dtype),
            torch.zeros(R, nh, S, S))


@pytest.mark.parametrize("change, bias_fn, match", [
    (dict(D=36), None, "multiple of 8"),
    (dict(D=264, nh=1), None, "multiple of 8 in \\[8, 256\\]"),
    (dict(dtype=torch.float16), None, "float32 or bfloat16"),
    (dict(R=3), None, "not a multiple of the bias period"),
    ({}, lambda b: b[:, :1], "bias must be \\[R, 2, 8, 8\\]"),
    ({}, lambda b: b[..., :7], "bias must be \\[R, 2, 8, 8\\]"),
    ({}, lambda b: b.double(), "bias must be float32"),
    ({}, None, "need CUDA tensors"),
])
def test_fused_mha_bias_wrapper_rejects_what_the_kernel_does_not_take(
        change, bias_fn, match):
    """The #10 wrappers (forward and backward) raise ValueError before any
    launch on what the kernels cannot take: head dims, dtypes, a bias of
    the wrong shape or type, a batch that is not a multiple of the bias
    period, and CPU tensors."""
    nh = change.pop("nh", 2)
    qkv, bias = _fmb_args(nh=nh, **change)
    if bias_fn is not None:
        bias = bias_fn(bias)
    dout = torch.zeros(qkv.shape[0], qkv.shape[1], qkv.shape[2] // 3,
                       dtype=qkv.dtype)
    with pytest.raises(ValueError, match=match):
        cuda_fmb.fused_mha_bias_fwd_cuda(qkv, bias, nh)
    with pytest.raises(ValueError, match=match):
        cuda_fmb.fused_mha_bias_bwd_cuda(qkv, bias, dout, None, None, nh)
    assert cuda_fmb.LAUNCHES["fused_mha_bias_fwd"] == 0
    assert cuda_fmb.LAUNCHES["fused_mha_bias_bwd"] == 0


@pytest.mark.parametrize("D", [8, 32, 40, 256])
def test_fused_mha_bias_wrapper_takes_every_head_dim_the_gate_admits(D):
    """Head dims 8 to 256 in steps of 8 pass the checks (swin's nh * hd need
    not be a multiple of 128, unlike #9's); a CPU tensor then stops at the
    device check, before any launch."""
    qkv, bias = _fmb_args(nh=3, D=D)
    with pytest.raises(ValueError, match="need CUDA tensors"):
        cuda_fmb.fused_mha_bias_fwd_cuda(qkv, bias, 3)
    assert cuda_fmb.LAUNCHES["fused_mha_bias_fwd"] == 0


def test_cuda_wrapper_rejects_bad_tables_and_lens():
    q, kp, vp, tables, lens = _kernel_args()
    with pytest.raises(ValueError, match="int32"):
        cuda_pa.paged_attention_cuda(q, kp, vp, tables.long(), lens)
    with pytest.raises(ValueError, match="lens must be"):
        cuda_pa.paged_attention_cuda(q, kp, vp, tables, lens[:1])
    with pytest.raises(ValueError, match="one token"):
        cuda_pa.paged_attention_q8_cuda(q.expand(2, 3, 2, 64), kp, None, vp,
                                        None, tables, lens)


@pytest.mark.parametrize("change, match", [
    (dict(q_shape=(2, 2, 64)), r"\[B, S, H, D\]"),
    (dict(start_dtype=torch.int64), "tables and start must be int32"),
    (dict(start_len=1), "start must be"),
    (dict(D=96 + 4), "multiple of 8"),
    ({}, "needs CUDA tensors"),
])
def test_prefix_wrapper_rejects_what_the_kernel_does_not_take(change,
                                                              match):
    D = change.get("D", 64)
    q = torch.zeros(change.get("q_shape", (2, 3, 2, D)))
    pool = torch.zeros(5, 4, 2, D)
    tables = torch.zeros(2, 2, dtype=torch.int32)
    start = torch.zeros(change.get("start_len", 2),
                        dtype=change.get("start_dtype", torch.int32))
    with pytest.raises(ValueError, match=match):
        cuda_pa.paged_prefix_attention_cuda(q, pool, pool.clone(), tables,
                                            start)
    with pytest.raises(ValueError, match=match):
        cuda_pa.paged_prefix_attention_q8_cuda(
            q, pool.to(torch.int8), pool[..., 0], pool.to(torch.int8),
            pool[..., 0], tables, start)
    assert cuda_pa.LAUNCHES["paged_prefix_attention"] == 0
    assert cuda_pa.LAUNCHES["paged_prefix_attention_q8"] == 0


def test_every_kernel_source_is_built_and_hashed(tmp_path, monkeypatch):
    """Each csrc/*.cu gets its own library, named by a hash of that source,
    the headers and the flags: editing one source renames its library
    only."""
    for src in cuda_build.CSRC.glob("*.cu"):
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    before = cuda_build.library_paths()
    assert set(before) == {"paged_attention", "paged_prefix_attention",
                           "int8_matmul", "flash_attention", "linear_ce",
                           "fused_mha", "fused_mha_bias", "layer_norm"}
    assert set(before) == set(cuda_build._ENTRY_POINTS)
    src = tmp_path / "paged_prefix_attention.cu"
    src.write_text(src.read_text() + "\n// edit\n")
    after = cuda_build.library_paths()
    assert after["paged_prefix_attention"] != before["paged_prefix_attention"]
    assert after["paged_attention"] == before["paged_attention"]
    assert after["int8_matmul"] == before["int8_matmul"]
    (tmp_path / "common.cuh").write_text("// shared header\n")
    assert set(cuda_build.library_paths().values()).isdisjoint(
        after.values())


@pytest.mark.parametrize("change, match", [
    (dict(h=100), "multiple of 8"),
    (dict(h=4), "multiple of 8"),
    (dict(dtype=torch.float16), "float32 or bfloat16"),
    ({}, "need CUDA tensors"),
    (dict(h=32768), "need CUDA tensors"),
])
def test_layer_norm_wrapper_rejects_what_the_kernel_does_not_take(change,
                                                                  match):
    """Kernel #8's wrappers check before any launch and count nothing; any
    H that is a multiple of 8 passes the width check (32768 fails only for
    lying on the CPU)."""
    h = change.get("h", 256)
    dtype = change.get("dtype", torch.bfloat16)
    x = torch.zeros(16, h, dtype=dtype)
    gamma = torch.ones(h, dtype=dtype)
    before = dict(cuda_build.LAUNCHES)
    with pytest.raises(ValueError, match=match):
        cuda_ln.layer_norm_fwd_cuda(x, gamma, None, 1e-5)
    mu = torch.zeros(16)
    with pytest.raises(ValueError, match=match):
        cuda_ln.layer_norm_bwd_cuda(x, x, mu, mu, gamma)
    assert cuda_build.LAUNCHES == before


def test_packed_flash_wrappers_check_shapes_and_gradient_views():
    """Kernel #7's wrappers: q, k, v must split into num_heads heads with
    a contiguous last dim; given gradient views must match and keep
    16-byte rows; nothing launches when a check fails."""
    before = dict(cuda_build.LAUNCHES)
    qkv = torch.zeros(1, 128, 3 * 256, dtype=torch.bfloat16)
    q, k, v = qkv.chunk(3, -1)
    with pytest.raises(ValueError, match="num_heads"):
        cuda_fa.flash_packed_fwd_cuda(q[..., :200], k, v, 3, causal=True,
                                      scale=1.0)
    with pytest.raises(ValueError, match="need CUDA tensors"):
        cuda_fa.flash_packed_fwd_cuda(q, k, v, 2, causal=True, scale=1.0)
    with pytest.raises(ValueError, match="contiguous last dim"):
        cuda_fa.flash_packed_fwd_cuda(qkv.transpose(1, 2)[:, :256], k, v,
                                      2, causal=True, scale=1.0)
    out = torch.zeros(1, 128, 256, dtype=torch.bfloat16)
    lse = torch.zeros(1, 2, 128)
    bad = torch.zeros(1, 128, 3 * 256 + 1, dtype=torch.bfloat16)
    q4, k4, v4, o4 = (t.unflatten(-1, (2, 128)) for t in (q, k, v, out))
    delta = torch.zeros(1, 2, 128)
    # a gradient view whose rows are not 16-byte aligned is refused
    with pytest.raises(ValueError, match="16-byte aligned"):
        cuda_fa._out(bad[..., 1:257].unflatten(-1, (2, 128)),
                     (1, 128, 2, 128), q4, "dq")
    with pytest.raises(ValueError, match=r"\(1, 128, 2, 128\)"):
        cuda_fa._out(torch.zeros(1, 128, 2, 64, dtype=torch.bfloat16),
                     (1, 128, 2, 128), q4, "dq")
    with pytest.raises(ValueError, match="need CUDA tensors"):
        cuda_fa._bwd_dq(q4, k4, v4, o4, lse, delta, True, 1.0, None, None,
                        "flash_packed_bwd_dq")
    assert cuda_build.LAUNCHES == before
