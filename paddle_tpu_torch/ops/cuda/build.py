"""Build and load the hand-written CUDA kernels (CUDA C++ for sm_90a).

Each `csrc/*.cu` source is compiled at first use with `nvcc` into its own
shared library with a plain C interface under ``paddle_tpu_torch/_build/``
and loaded with ctypes; the sources build in parallel, one `nvcc` each. A
source that includes PyTorch's headers takes minutes to build; these take
seconds, so every run can build from the checkout.

``LAUNCHES`` counts the launches of every kernel since the last
`reset_launch_counts()`; each wrapper adds one where it launches its
kernel, and nowhere else.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"
# "-cudart shared": the libraries use the CUDA runtime PyTorch has already
# loaded (the same soname), so the kernels and PyTorch share one runtime,
# one module registry and one error state, as PyTorch's own extensions do
NVCC_FLAGS = ("-O3", "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v", "-cudart",
              "shared")

# launches per kernel since the last reset_launch_counts()
LAUNCHES = {"paged_attention": 0, "paged_attention_q8": 0,
            "paged_prefix_attention": 0, "paged_prefix_attention_q8": 0,
            "int8_matmul": 0, "flash_fwd": 0, "flash_bwd_dq": 0,
            "flash_bwd_dkv": 0, "linear_ce_fwd": 0, "fused_mha_fwd": 0,
            "fused_mha_bwd": 0, "fused_mha_bias_fwd": 0,
            "fused_mha_bias_bwd": 0, "layer_norm_fwd": 0,
            "layer_norm_bwd": 0, "flash_packed_fwd": 0,
            "flash_packed_bwd_dq": 0, "flash_packed_bwd_dkv": 0}

_p, _i, _f, _u = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
# C entry points per library (source stem) and their argument types
_ENTRY_POINTS = {
    "paged_attention": {
        "pt_paged_attention": [_p] * 7 + [_i] * 6 + [_f, _i, _p],
        "pt_paged_attention_q8": [_p] * 9 + [_i] * 6 + [_f, _i, _p],
        "pt_paged_attention_part": []},
    "paged_prefix_attention": {
        "pt_paged_prefix_attention": [_p] * 6 + [_i] * 7 + [_f, _i, _p],
        "pt_paged_prefix_attention_q8": [_p] * 8 + [_i] * 7 + [_f, _i, _p]},
    "int8_matmul": {
        "pt_int8_matmul": [_p] * 4 + [_i] * 8 + [_p]},
    "flash_attention": {
        "pt_flash_fwd": [_p] * 6 + [_i] * 7 + [_f, _i, _p],
        "pt_flash_bwd_dq": [_p] * 9 + [_i] * 7 + [_f, _i, _p],
        "pt_flash_bwd_dkv": [_p] * 10 + [_i] * 7 + [_f, _i, _p]},
    "linear_ce": {
        "pt_linear_ce_partial": [_p] * 4 + [_i] * 8 + [_p],
        "pt_linear_ce_merge": [_p] * 3 + [_i] * 2 + [_p]},
    "fused_mha": {
        "pt_fused_mha_fwd": [_p] * 5 + [_i] * 6 + [_f, _u, _f, _i, _p],
        "pt_fused_mha_bwd": [_p] * 7 + [_i] * 6 + [_f, _u, _f, _i, _p]},
    "fused_mha_bias": {
        "pt_fused_mha_bias_fwd": [_p] * 5 + [_i] * 5 + [_f, _i, _p],
        "pt_fused_mha_bias_bwd": [_p] * 8 + [_i] * 5 + [_f, _i, _p]},
    "layer_norm": {
        "pt_layer_norm_fwd": [_p] * 6 + [_i] * 2 + [_f] + [_i] * 6 + [_p],
        "pt_layer_norm_bwd": [_p] * 9 + [_i] * 9 + [_p]},
}

_libs: Dict[str, ctypes.CDLL] = {}
_lib_lock = threading.Lock()


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def raise_on_error(lib: ctypes.CDLL, rc: int, what: str, detail: str = ""):
    """Raise RuntimeError for a nonzero code from a C entry point: an error
    of its own launch, or one an earlier CUDA call left pending (each entry
    point reports that first rather than clear it unseen)."""
    if rc != 0:
        msg = lib.pt_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {msg} ({rc}) at the launch "
                           f"or left pending before it{detail}")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels are built from source")
    return found


# a kernel's declaration: `__global__ void [__launch_bounds__(...)] name(`
_GLOBAL_RE = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*"
                        r"\((?:[^()]|\([^()]*\))*\)\s*)?(\w+)\s*\(")


def kernel_names() -> List[str]:
    """The name of every `__global__` function of the sources and headers,
    in file order: the names a device trace shows for the port's own
    kernels."""
    names: List[str] = []
    for src in sorted(CSRC.glob("*.cu*")):
        for name in _GLOBAL_RE.findall(src.read_text()):
            if name not in names:
                names.append(name)
    return names


def library_paths() -> Dict[str, Path]:
    """Where each source's library lives: the file name carries a hash of
    that source, every header beside it and the flags, so an edit to any
    of them names a new library and a stale one is never loaded."""
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    out = {}
    for src in sorted(CSRC.glob("*.cu")):
        key = hashlib.sha256(src.read_bytes() + headers
                             + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
        out[src.stem] = BUILD_DIR / f"lib{src.stem}_{key}.so"
    return out


def build() -> Dict[str, Path]:
    """Compile every source whose library is missing, one `nvcc` per
    source, all started together; returns {source stem: library path}.
    Each library is renamed into place only once complete, so a
    half-written build is never loaded. The compilers' output goes to
    ``_build/nvcc.log``."""
    paths = library_paths()
    todo = [(CSRC / f"{stem}.cu", out) for stem, out in paths.items()
            if not out.exists()]
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    # where the toolkit's runtime is, should none be loaded yet
    rpath = f"-Xlinker=-rpath,{Path(nvcc).resolve().parents[1] / 'lib64'}"
    jobs = []
    for src, out in todo:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, rpath, "-o", str(tmp), str(src)]
        jobs.append((src, out, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)))
    log, failed = [], []
    for src, out, tmp, cmd, proc in jobs:
        stdout, stderr = proc.communicate()
        log.append(" ".join(cmd) + "\n" + stdout + stderr)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}) building "
                          f"{src.name}:\n{stderr[-4000:]}")
        else:
            os.replace(tmp, out)
    (BUILD_DIR / "nvcc.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load the library of source `name` once per
    process."""
    with _lib_lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(build()[name]))
            for fn, argtypes in _ENTRY_POINTS[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = _i
            lib.pt_error_string.argtypes = [_i]
            lib.pt_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return _libs[name]


def loaded_libraries() -> List[str]:
    """Names of the kernel libraries this process has loaded (the serving
    engine's /statusz compile block)."""
    with _lib_lock:
        return sorted(_libs)
