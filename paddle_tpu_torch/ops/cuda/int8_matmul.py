"""Bind and launch the hand-written weight-only int8 GEMM (kernel #5 of the
port, `csrc/int8_matmul.cu`, CUDA C++ for sm_90a). The library is built
and loaded by `build.py`.

The wrapper checks device, dtypes, shapes, contiguity and alignment,
raises ValueError on what the kernel does not take, allocates the output,
launches on PyTorch's current stream and raises RuntimeError when the
launch reports an error. It never falls back to another implementation.
Each launch adds one to ``LAUNCHES["int8_matmul"]``.
"""
from __future__ import annotations

import torch

from .build import LAUNCHES, load_library, raise_on_error

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LAYOUT_CODE = {"kn": 0, "nk": 1}


def _check(x, q, s, w_layout):
    """Returns (M, N, K) or raises ValueError."""
    if w_layout not in _LAYOUT_CODE:
        raise ValueError(f"w_layout must be 'kn' or 'nk'; got {w_layout!r}")
    if x.dim() != 2 or q.dim() != 2:
        raise ValueError(f"x and q must be 2-D; got {tuple(x.shape)}, "
                         f"{tuple(q.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"x dtype must be float32 or bfloat16; got "
                         f"{x.dtype}")
    if q.dtype != torch.int8 or s.dtype != torch.float32:
        raise ValueError(f"q must be int8 and s float32; got {q.dtype}, "
                         f"{s.dtype}")
    M, K = x.shape
    N, Kq = (q.shape[1], q.shape[0]) if w_layout == "kn" else q.shape
    if Kq != K:
        raise ValueError(f"x [M, K={K}] does not match q {tuple(q.shape)} "
                         f"in layout {w_layout!r}")
    if s.dim() != 1 or s.shape[0] != N:
        raise ValueError(f"s must be [N={N}]; got {tuple(s.shape)}")
    if M < 1 or N < 1 or M > 65535 * 16:
        raise ValueError(f"M must be in [1, {65535 * 16}] and N >= 1; got "
                         f"M={M}, N={N}")
    if K < 16 or K % 16 or K * max(M, N) >= 2 ** 31:
        raise ValueError(f"K must be a positive multiple of 16 with K*M and "
                         f"K*N below 2**31; got K={K}")
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA int8 GEMM needs CUDA tensors; x is on "
                         f"{x.device}")
    for t in (x, q, s):
        if t.device != x.device:
            raise ValueError(f"all operands must be on {x.device}; found "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError("int8_matmul operands must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError("int8_matmul operands must be 16-byte aligned")
    return M, N, K


def int8_matmul_cuda(x, q, s, *, w_layout="kn"):
    """Kernel route of `ops.int8_matmul.int8_matmul`: x [M, K] fp32/bf16;
    q int8 [K, N] ("kn") or [N, K] ("nk"); s [N] f32. Returns
    ``cast((x @ widen(q)) * s)`` as [M, N] in x's dtype."""
    M, N, K = _check(x, q, s, w_layout)
    lib = load_library("int8_matmul")
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    rc = lib.pt_int8_matmul(
        x.data_ptr(), q.data_ptr(), s.data_ptr(), y.data_ptr(), M, N, K,
        _LAYOUT_CODE[w_layout], _DTYPE_CODE[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    raise_on_error(lib, rc, "int8_matmul")
    LAUNCHES["int8_matmul"] += 1
    return y
