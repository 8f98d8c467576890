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
from paddle_tpu_torch.ops.cuda import paged_attention as cuda_pa

REPO = Path(__file__).resolve().parents[1]


def _foreign(name):
    return any(name == p or name.startswith(p + ".")
               for p in ("jax", "paddle_tpu"))


def test_package_imports_no_jax_and_no_paddle_tpu():
    code = ("import sys, json, paddle_tpu_torch\n"
            "import paddle_tpu_torch.ops.cuda.paged_attention\n"
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
    (dict(D=48), "multiple of 32"),
    (dict(D=288), "multiple of 32"),
    (dict(dtype=torch.float16), "float32 or bfloat16"),
    ({}, "needs CUDA tensors"),
])
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(change, match):
    q, kp, vp, tables, lens = _kernel_args(**change)
    with pytest.raises(ValueError, match=match):
        cuda_pa.paged_attention_cuda(q, kp, vp, tables, lens)
    assert cuda_pa.LAUNCHES["paged_attention"] == 0


def test_cuda_wrapper_rejects_bad_tables_and_lens():
    q, kp, vp, tables, lens = _kernel_args()
    with pytest.raises(ValueError, match="int32"):
        cuda_pa.paged_attention_cuda(q, kp, vp, tables.long(), lens)
    with pytest.raises(ValueError, match="lens must be"):
        cuda_pa.paged_attention_cuda(q, kp, vp, tables, lens[:1])
    with pytest.raises(ValueError, match="one token"):
        cuda_pa.paged_attention_q8_cuda(q.expand(2, 3, 2, 64), kp, None, vp,
                                        None, tables, lens)
