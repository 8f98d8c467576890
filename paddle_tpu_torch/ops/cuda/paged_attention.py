"""Build, bind and launch the hand-written paged decode-attention kernels
(`csrc/paged_attention.cu`, CUDA C++ for sm_90a).

The source is compiled at first use with `nvcc` into a shared library with
a plain C interface under ``paddle_tpu_torch/_build/`` and loaded with
ctypes. A source that includes PyTorch's headers takes minutes to build;
this one takes seconds, so every run can build from the checkout.

Each wrapper checks device, dtypes, shapes and contiguity, raises
ValueError on what the kernel does not take, allocates the output, launches
on PyTorch's current stream and raises RuntimeError when the launch
reports an error. It never falls back to another implementation. Each
launch adds one to ``LAUNCHES[name]``.
"""
from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "paged_attention.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"
NVCC_FLAGS = ("-O3", "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# launches per kernel since the last reset_launch_counts()
LAUNCHES = {"paged_attention": 0, "paged_attention_q8": 0}

_lib = None
_lib_lock = threading.Lock()
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the paged "
                           "attention kernels are built from source")
    return found


def build() -> Path:
    """Compile the kernels if this source has not been built yet; returns
    the library path. The file name carries a hash of the source and flags,
    and the library is renamed into place only once complete, so a stale
    or half-written build is never loaded."""
    key = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"libpaged_attention_{key}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    (BUILD_DIR / "nvcc.log").write_text(
        " ".join(cmd) + "\n" + res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}) building "
                           f"{SOURCE.name}:\n{res.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library once per process."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.pt_paged_attention.argtypes = [p, p, p, p, p, p, i, i, i, i,
                                               i, i, f, i, p]
            lib.pt_paged_attention.restype = i
            lib.pt_paged_attention_q8.argtypes = [p, p, p, p, p, p, p, p, i,
                                                  i, i, i, i, i, f, i, p]
            lib.pt_paged_attention_q8.restype = i
            lib.pt_error_string.argtypes = [i]
            lib.pt_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def _check_common(q, pools, tables, lens):
    """Shared argument checks; returns (B, H, D, NB, bs, MB) and the
    [B, 1, H, D] or [B, H, D] layout flag."""
    if q.dim() == 4:
        if q.shape[1] != 1:
            raise ValueError(f"paged decode kernel serves one token per row;"
                             f" got q seq len {q.shape[1]}")
    elif q.dim() != 3:
        raise ValueError(f"q must be [B, 1, H, D] or [B, H, D]; got "
                         f"{tuple(q.shape)}")
    B, H, D = q.shape[0], q.shape[-2], q.shape[-1]
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"q dtype must be float32 or bfloat16; got "
                         f"{q.dtype}")
    if D % 32 != 0 or not 32 <= D <= 256:
        raise ValueError(f"head_dim must be a multiple of 32 in [32, 256]; "
                         f"got {D}")
    if not 1 <= B <= 65535:
        raise ValueError(f"batch must be in [1, 65535]; got {B}")
    NB, bs = pools[0].shape[0], pools[0].shape[1]
    if tables.dim() != 2 or tables.shape[0] != B:
        raise ValueError(f"tables must be [B={B}, MB]; got "
                         f"{tuple(tables.shape)}")
    MB = tables.shape[1]
    if tables.dtype != torch.int32 or lens.dtype != torch.int32:
        raise ValueError(f"tables and lens must be int32; got "
                         f"{tables.dtype}, {lens.dtype}")
    if tuple(lens.shape) != (B,):
        raise ValueError(f"lens must be [B={B}]; got {tuple(lens.shape)}")
    # token positions are int32 in the kernel; pool offsets are int64
    if MB < 1 or MB * bs >= 2 ** 31:
        raise ValueError(f"table extent out of int32 range: MB={MB}, "
                         f"bs={bs}")
    if q.device.type != "cuda":
        raise ValueError(f"the CUDA paged attention kernel needs CUDA "
                         f"tensors; q is on {q.device}")
    for t in (q, tables, lens) + tuple(pools):
        if t.device != q.device:
            raise ValueError(f"all operands must be on {q.device}; found "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError("paged attention operands must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError("paged attention operands must be 16-byte "
                             "aligned")
    return B, H, D, NB, bs, MB


def _raise_on(rc: int, lib, name: str):
    if rc != 0:
        msg = lib.pt_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({rc})")


def paged_attention_cuda(q, k_pool, v_pool, tables, lens, *, scale=None):
    """Kernel route of `ops.attention.paged_attention`: q [B, 1, H, D]
    (or [B, H, D]) fp32/bf16; pools [NB, bs, H, D] in q's dtype; tables
    [B, MB] int32; lens [B] int32 attendable rows. Returns q's layout and
    dtype; rows with lens == 0 are zeros."""
    B, H, D, NB, bs, MB = _check_common(q, (k_pool, v_pool), tables, lens)
    for p in (k_pool, v_pool):
        if p.dtype != q.dtype or tuple(p.shape) != (NB, bs, H, D):
            raise ValueError(f"pools must be [NB, bs, H={H}, D={D}] in "
                             f"{q.dtype}; got {tuple(p.shape)} {p.dtype}")
    lib = load_library()
    out = torch.empty_like(q)
    scale = 1.0 / math.sqrt(D) if scale is None else float(scale)
    rc = lib.pt_paged_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        tables.data_ptr(), lens.data_ptr(), out.data_ptr(),
        B, H, D, NB, bs, MB, scale, _DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, lib, "paged_attention")
    LAUNCHES["paged_attention"] += 1
    return out


def paged_attention_q8_cuda(q, kc_pool, ks_pool, vc_pool, vs_pool, tables,
                            lens, *, scale=None):
    """Kernel route of `ops.attention.paged_attention_q8`: code pools int8
    [NB, bs, H, D], scale pools f32 [NB, bs, H]; otherwise as
    `paged_attention_cuda`."""
    pools = (kc_pool, ks_pool, vc_pool, vs_pool)
    B, H, D, NB, bs, MB = _check_common(q, pools, tables, lens)
    for p in (kc_pool, vc_pool):
        if p.dtype != torch.int8 or tuple(p.shape) != (NB, bs, H, D):
            raise ValueError(f"code pools must be int8 [NB, bs, H={H}, "
                             f"D={D}]; got {tuple(p.shape)} {p.dtype}")
    for p in (ks_pool, vs_pool):
        if p.dtype != torch.float32 or tuple(p.shape) != (NB, bs, H):
            raise ValueError(f"scale pools must be float32 [NB, bs, H={H}]"
                             f"; got {tuple(p.shape)} {p.dtype}")
    lib = load_library()
    out = torch.empty_like(q)
    scale = 1.0 / math.sqrt(D) if scale is None else float(scale)
    rc = lib.pt_paged_attention_q8(
        q.data_ptr(), kc_pool.data_ptr(), ks_pool.data_ptr(),
        vc_pool.data_ptr(), vs_pool.data_ptr(), tables.data_ptr(),
        lens.data_ptr(), out.data_ptr(), B, H, D, NB, bs, MB, scale,
        _DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, lib, "paged_attention_q8")
    LAUNCHES["paged_attention_q8"] += 1
    return out
