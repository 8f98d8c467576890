"""Bind and launch the hand-written paged-attention kernels (CUDA C++ for
sm_90a): single-token decode (`csrc/paged_attention.cu`, kernels #1 and #2
of the port: a split-sequence kernel and, where a row can span more than
one partition, the merge of its partitions) and the multi-token window
over a cached prefix (`csrc/paged_prefix_attention.cu`, kernels #3 and
#4). The libraries are built and loaded by `build.py`.

Each wrapper checks device, dtypes, shapes and contiguity, raises
ValueError on what the kernel does not take, allocates the output, launches
on PyTorch's current stream and raises RuntimeError when the launch
reports an error. It never falls back to another implementation. Each
launch adds one to ``LAUNCHES[name]``.
"""
from __future__ import annotations

import math

import torch

from .build import LAUNCHES, load_library, raise_on_error

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check_common(q, pools, tables, lens, *, window=False, what="lens"):
    """Shared argument checks; returns (B, S, H, D, NB, bs, MB). The decode
    kernels take q [B, 1, H, D] or [B, H, D] (S = 1); the window kernels
    (window=True) take q [B, S, H, D] and a [B] int32 `start` vector in
    place of `lens`."""
    if window:
        if q.dim() != 4:
            raise ValueError(f"q must be [B, S, H, D]; got {tuple(q.shape)}")
        S = q.shape[1]
        if not 1 <= S <= 8 * 65535:
            raise ValueError(f"window length must be in [1, {8 * 65535}]; "
                             f"got {S}")
    elif q.dim() == 4:
        if q.shape[1] != 1:
            raise ValueError(f"paged decode kernel serves one token per row;"
                             f" got q seq len {q.shape[1]}")
        S = 1
    elif q.dim() != 3:
        raise ValueError(f"q must be [B, 1, H, D] or [B, H, D]; got "
                         f"{tuple(q.shape)}")
    else:
        S = 1
    B, H, D = q.shape[0], q.shape[-2], q.shape[-1]
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"q dtype must be float32 or bfloat16; got "
                         f"{q.dtype}")
    if D % 8 != 0 or not 8 <= D <= 256:
        raise ValueError(f"head_dim must be a multiple of 8 in [8, 256]; "
                         f"got {D}")
    if not 1 <= B <= 65535 or H > 65535:
        raise ValueError(f"batch and heads must be in [1, 65535]; got B={B},"
                         f" H={H}")
    NB, bs = pools[0].shape[0], pools[0].shape[1]
    if tables.dim() != 2 or tables.shape[0] != B:
        raise ValueError(f"tables must be [B={B}, MB]; got "
                         f"{tuple(tables.shape)}")
    MB = tables.shape[1]
    if tables.dtype != torch.int32 or lens.dtype != torch.int32:
        raise ValueError(f"tables and {what} must be int32; got "
                         f"{tables.dtype}, {lens.dtype}")
    if tuple(lens.shape) != (B,):
        raise ValueError(f"{what} must be [B={B}]; got {tuple(lens.shape)}")
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
    return B, S, H, D, NB, bs, MB


def _check_pools(q, pools, NB, bs, H, D):
    """fp pools (k, v) in q's dtype, or int8 pools (k codes, k scales,
    v codes, v scales)."""
    if len(pools) == 2:
        for p in pools:
            if p.dtype != q.dtype or tuple(p.shape) != (NB, bs, H, D):
                raise ValueError(f"pools must be [NB, bs, H={H}, D={D}] in "
                                 f"{q.dtype}; got {tuple(p.shape)} "
                                 f"{p.dtype}")
        return
    for p in pools[0::2]:
        if p.dtype != torch.int8 or tuple(p.shape) != (NB, bs, H, D):
            raise ValueError(f"code pools must be int8 [NB, bs, H={H}, "
                             f"D={D}]; got {tuple(p.shape)} {p.dtype}")
    for p in pools[1::2]:
        if p.dtype != torch.float32 or tuple(p.shape) != (NB, bs, H):
            raise ValueError(f"scale pools must be float32 [NB, bs, H={H}]"
                             f"; got {tuple(p.shape)} {p.dtype}")


_PART = {}   # positions a decode partition (the kernel's kPart), per library


def _scratch(lib, B, H, D, bs, MB, device):
    """A new f32 scratch for the decode partitions' states [B, H, NP,
    D + 2], NP = ceil(MB * bs / part); None (no scratch, no merge launch)
    when every row fits in one partition."""
    part = _PART.get(lib)
    if part is None:
        part = _PART[lib] = lib.pt_paged_attention_part()
    n_part = -(-MB * bs // part)
    if n_part == 1:
        return None
    return torch.empty(B * H * n_part * (D + 2), dtype=torch.float32,
                       device=device)


def _launch(lib_name, fn, counter, q, pools, tables, vec, scale, window):
    """Check, launch `fn` of library `lib_name` over (q, *pools, tables,
    vec, out, shapes; the decode kernels also a scratch for their
    partitions' states after out), count the launch; returns out."""
    B, S, H, D, NB, bs, MB = _check_common(
        q, pools, tables, vec, window=window,
        what="start" if window else "lens")
    _check_pools(q, pools, NB, bs, H, D)
    lib = load_library(lib_name)
    out = torch.empty_like(q)
    scale = 1.0 / math.sqrt(D) if scale is None else float(scale)
    shapes = (B, S, H, D, NB, bs, MB) if window else (B, H, D, NB, bs, MB)
    scratch = () if window else (_scratch(lib, B, H, D, bs, MB, q.device),)
    rc = getattr(lib, fn)(
        q.data_ptr(), *(p.data_ptr() for p in pools), tables.data_ptr(),
        vec.data_ptr(), out.data_ptr(),
        *(None if t is None else t.data_ptr() for t in scratch),
        *shapes, scale,
        _DTYPE_CODE[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    raise_on_error(lib, rc, counter)
    LAUNCHES[counter] += 1
    return out


def paged_attention_cuda(q, k_pool, v_pool, tables, lens, *, scale=None):
    """Kernel route of `ops.attention.paged_attention`: q [B, 1, H, D]
    (or [B, H, D]) fp32/bf16; pools [NB, bs, H, D] in q's dtype; tables
    [B, MB] int32; lens [B] int32 attendable rows. Returns q's layout and
    dtype; rows with lens == 0 are zeros."""
    return _launch("paged_attention", "pt_paged_attention",
                   "paged_attention", q, (k_pool, v_pool), tables, lens,
                   scale, window=False)


def paged_attention_q8_cuda(q, kc_pool, ks_pool, vc_pool, vs_pool, tables,
                            lens, *, scale=None):
    """Kernel route of `ops.attention.paged_attention_q8`: code pools int8
    [NB, bs, H, D], scale pools f32 [NB, bs, H]; otherwise as
    `paged_attention_cuda`."""
    return _launch("paged_attention", "pt_paged_attention_q8",
                   "paged_attention_q8", q,
                   (kc_pool, ks_pool, vc_pool, vs_pool), tables, lens, scale,
                   window=False)


def paged_prefix_attention_cuda(q, k_pool, v_pool, tables, start, *,
                                scale=None):
    """Kernel route of `ops.attention.paged_prefix_attention`: q
    [B, S, H, D] fp32/bf16, query row i of batch row b at global position
    start[b] + i (start >= 0); pools [NB, bs, H, D] in q's dtype; tables
    [B, MB] int32; start [B] int32. Row i attends pool columns
    <= start[b] + i below MB * bs. Returns [B, S, H, D] in q's dtype."""
    return _launch("paged_prefix_attention", "pt_paged_prefix_attention",
                   "paged_prefix_attention", q, (k_pool, v_pool), tables,
                   start, scale, window=True)


def paged_prefix_attention_q8_cuda(q, kc_pool, ks_pool, vc_pool, vs_pool,
                                   tables, start, *, scale=None):
    """Kernel route of `ops.attention.paged_prefix_attention_q8`: code
    pools int8 [NB, bs, H, D], scale pools f32 [NB, bs, H]; otherwise as
    `paged_prefix_attention_cuda`."""
    return _launch("paged_prefix_attention", "pt_paged_prefix_attention_q8",
                   "paged_prefix_attention_q8", q,
                   (kc_pool, ks_pool, vc_pool, vs_pool), tables, start,
                   scale, window=True)
