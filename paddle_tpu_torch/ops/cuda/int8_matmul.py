"""Bind and launch the hand-written weight-only int8 GEMM (kernel #5 of the
port, `csrc/int8_matmul.cu`, CUDA C++ for sm_90a). The library is built
and loaded by `build.py`.

The wrapper checks device, dtypes, shapes, contiguity and alignment,
raises ValueError on what the kernel does not take, allocates the output,
launches on PyTorch's current stream and raises RuntimeError when the
launch reports an error. It never falls back to another implementation.
Each launch adds one to ``LAUNCHES["int8_matmul"]``.

bf16 x with the "nk" layout runs the warpgroup kernel `i8_wg`, whose
tokens a CTA and K split over a cluster `wg_plan` chooses here; the other
forms run the first design's kernels.
"""
from __future__ import annotations

import functools

import torch

from .build import LAUNCHES, load_library, raise_on_error

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LAYOUT_CODE = {"kn": 0, "nk": 1}
WG_CHUNK = 128                 # codes a pipeline stage holds of each channel


@functools.lru_cache(maxsize=None)
def wg_plan(m, n, k, sms):
    """i8_wg's launch for x [m, k] and q [n, k] on a card of `sms` SMs:
    (tokens a CTA, consumer warpgroups, cluster size, CTAs). The tokens
    and cluster sizes it returns are the instantiations `launch_nk_bf16`
    in `csrc/int8_matmul.cu` switches over, which rejects any other.

    Tokens: the least power of two from 8 holding m up to 64 (one
    consumer warpgroup, 64 channels a CTA, two CTAs an SM). Above, tiles
    of 128 tokens on two warpgroups (128 channels a CTA, so x is read
    once per 128 channels) where n gives at least 32 such channel tiles,
    else tiles of 64 tokens. The K extent is split over a cluster, doubled
    from 1 while the doubled launch fits what the card holds at once (3/4
    of two CTAs an SM, or one an SM at two warpgroups), each rank keeps at
    least two 128-code chunks, and the cluster stays within 4. These
    limits are measured ones (an H100, phase 2's shapes): clusters of 8
    and launches past one wave ran slower."""
    if m <= 64:
        nt = max(8, 1 << (m - 1).bit_length())
    elif -(-n // 128) >= 32 or m > 128:
        nt = 128
    else:
        nt = 64
    nwg = 1 if nt <= 64 else 2
    tiles = -(-n // (64 * nwg)) * -(-m // nt)
    chunks = -(-k // WG_CHUNK)
    held = 3 * sms // 2 if nwg == 1 else sms
    cs = 1
    while cs < 4 and tiles * 2 * cs <= held and 4 * cs <= chunks:
        cs *= 2
    return nt, nwg, cs, tiles * cs


_SMS = {}


def _sms(device):
    """The SM count of a CUDA device, read once."""
    i = device.index if device.index is not None else \
        torch.cuda.current_device()
    if i not in _SMS:
        _SMS[i] = torch.cuda.get_device_properties(i).multi_processor_count
    return _SMS[i]


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
    nt, cs = 0, 0
    if x.dtype == torch.bfloat16 and w_layout == "nk":
        nt, _, cs, _ = wg_plan(M, N, K, _sms(x.device))
    rc = lib.pt_int8_matmul(
        x.data_ptr(), q.data_ptr(), s.data_ptr(), y.data_ptr(), M, N, K,
        _LAYOUT_CODE[w_layout], _DTYPE_CODE[x.dtype], nt, cs,
        torch.cuda.current_stream(x.device).cuda_stream)
    raise_on_error(lib, rc, "int8_matmul")
    LAUNCHES["int8_matmul"] += 1
    return y
