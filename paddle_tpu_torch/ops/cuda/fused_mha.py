"""Bind and launch the hand-written fused short-sequence MHA (kernel #9 of
the port, `csrc/fused_mha.cu`, CUDA C++ for sm_90a; its bf16 kernels are
#6's warpgroup kernels of `csrc/flash_wg.cuh` with #9's features): the
forward and the backward on the packed projection output. The library is
built and loaded by `build.py`.

The wrappers check device, dtypes, shapes, contiguity and alignment,
raise ValueError on what the kernels do not take, allocate the outputs
and the backward's scratch, launch on PyTorch's current stream and raise
RuntimeError when a launch reports an error. They never fall back to
another implementation. Each call adds one to ``LAUNCHES["fused_mha_fwd"]``
or ``["fused_mha_bwd"]`` (the backward entry point runs its three passes
as one call).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .build import LAUNCHES, load_library, raise_on_error

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check(qkv, num_heads, kv_len, lens, dropout_p, seed):
    """Returns (B, S, nh, D, kv) or raises ValueError."""
    if qkv.dim() != 3:
        raise ValueError(f"qkv must be [B, S, 3 * nh * hd]; got "
                         f"{tuple(qkv.shape)}")
    B, S, F3 = qkv.shape
    nh = int(num_heads)
    if nh < 1 or F3 % (3 * nh):
        raise ValueError(f"qkv width {F3} is not 3 * num_heads({nh}) * "
                         f"head_dim")
    D = F3 // (3 * nh)
    if qkv.dtype not in _DTYPE_CODE:
        raise ValueError(f"qkv must be float32 or bfloat16; got "
                         f"{qkv.dtype}")
    if D % 8 or not 8 <= D <= 256:
        raise ValueError(f"head_dim must be a multiple of 8 in [8, 256]; "
                         f"got {D}")
    if (nh * D) % 128:
        raise ValueError(f"num_heads * head_dim must be a multiple of 128; "
                         f"got {nh * D}")
    if not (1 <= B <= 65535 and nh <= 65535 and 1 <= S < 2 ** 20):
        raise ValueError(f"bad sizes B={B}, S={S}, num_heads={nh}")
    if qkv.numel() >= 2 ** 62:
        raise ValueError("tensor too large")
    if not 0.0 <= dropout_p < 1.0:
        raise ValueError(f"dropout_p must be in [0, 1); got {dropout_p}")
    if kv_len is not None and lens is not None:
        raise ValueError("give kv_len or lens, not both")
    kv = S if kv_len is None else int(kv_len)
    if kv < 1:
        raise ValueError(f"kv_len must be positive; got {kv}")
    for name, t, want in (("lens", lens, (B,)), ("seed", seed, (1,))):
        if t is not None and (t.dtype != torch.int32
                              or tuple(t.shape) != want
                              or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous int32 tensor of "
                             f"shape {want}")
    if dropout_p > 0.0 and seed is None:
        raise ValueError("dropout_p > 0 requires a seed")
    if qkv.device.type != "cuda":
        raise ValueError(f"the CUDA fused MHA kernels need CUDA tensors; "
                         f"qkv is on {qkv.device}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("qkv must be contiguous and 16-byte aligned")
    for t in (lens, seed):
        if t is not None and t.device != qkv.device:
            raise ValueError(f"lens and seed must be on {qkv.device}; "
                             f"found {t.device}")
    return B, S, nh, D, min(kv, S)


def keep_threshold(p: float) -> int:
    """JAX's dropout threshold: keep iff bits >= floor(p * 2^32) (P(drop)
    = p to 2^-32)."""
    return min(int(p * 2.0 ** 32), 2 ** 32 - 1)


def _drop_args(dropout_p):
    """(threshold, keep scale) as the kernel takes them: keep iff bits >=
    the threshold, scale kept entries by the f32 1 / (1 - p)."""
    if dropout_p <= 0.0:
        return 0, 1.0
    return (keep_threshold(dropout_p),
            float(np.float32(1.0 / (1.0 - dropout_p))))


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def fused_mha_fwd_cuda(qkv, num_heads, *, scale=None, kv_len=None,
                       lens=None, causal=False, dropout_p=0.0, seed=None):
    """Forward: qkv [B, S, 3F] -> (out [B, S, F] in qkv's dtype, lse). lse
    is the softmax's log-sum-exp [B, nh, S] f32, the bf16 backward's
    residual; None in f32, whose backward recomputes its statistics.
    kv_len an int, or lens an int32 [B] device tensor; seed an int32 [1]
    device tensor when dropout_p > 0."""
    B, S, nh, D, kv = _check(qkv, num_heads, kv_len, lens, dropout_p, seed)
    scale = 1.0 / math.sqrt(D) if scale is None else float(scale)
    thresh, inv = _drop_args(dropout_p)
    lib = load_library("fused_mha")
    out = torch.empty((B, S, nh * D), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((B, nh, S), dtype=torch.float32, device=qkv.device) \
        if qkv.dtype == torch.bfloat16 else None
    rc = lib.pt_fused_mha_fwd(
        qkv.data_ptr(), out.data_ptr(), _ptr(lse), _ptr(lens), _ptr(seed),
        B, S, nh, D, kv, int(bool(causal)), scale, thresh, inv,
        _DTYPE_CODE[qkv.dtype],
        torch.cuda.current_stream(qkv.device).cuda_stream)
    raise_on_error(lib, rc, "fused_mha_fwd",
                   f"; B={B} S={S} nh={nh} D={D} dtype={qkv.dtype}")
    LAUNCHES["fused_mha_fwd"] += 1
    return out, lse


def fused_mha_bwd_cuda(qkv, dout, lse, num_heads, *, scale=None,
                       kv_len=None, lens=None, causal=False, dropout_p=0.0,
                       seed=None):
    """Backward: d(qkv) [B, S, 3F] in qkv's dtype from qkv, dout [B, S, F]
    (contiguous, qkv's dtype) and the forward's lse (bf16; None in f32).
    Runs three passes, each a launch: bf16, the in-row term r of every
    query row (from lse), the dQ pass and the dK/dV pass; f32, the row
    statistics (max, 1/sum and r), dQ and dK/dV. The dQ and dK/dV passes
    write their columns of the packed gradient."""
    B, S, nh, D, kv = _check(qkv, num_heads, kv_len, lens, dropout_p, seed)
    if tuple(dout.shape) != (B, S, nh * D) or dout.dtype != qkv.dtype or \
            dout.device != qkv.device or not dout.is_contiguous() or \
            dout.data_ptr() % 16:
        raise ValueError(f"dout must be contiguous [B, S, F] = "
                         f"{(B, S, nh * D)} in qkv's dtype and device")
    bf16 = qkv.dtype == torch.bfloat16
    if bf16 and (lse is None or lse.dtype != torch.float32
                 or tuple(lse.shape) != (B, nh, S)
                 or lse.device != qkv.device or not lse.is_contiguous()):
        raise ValueError(f"lse must be the forward's contiguous float32 "
                         f"[B, nh, S] = {(B, nh, S)} on {qkv.device}")
    scale = 1.0 / math.sqrt(D) if scale is None else float(scale)
    thresh, inv = _drop_args(dropout_p)
    lib = load_library("fused_mha")
    dqkv = torch.empty_like(qkv)
    scratch = torch.empty((B, nh, S) if bf16 else (3, B, nh, S),
                          dtype=torch.float32, device=qkv.device)
    rc = lib.pt_fused_mha_bwd(
        qkv.data_ptr(), dout.data_ptr(), _ptr(lse if bf16 else None),
        dqkv.data_ptr(), scratch.data_ptr(), _ptr(lens), _ptr(seed), B, S,
        nh, D, kv, int(bool(causal)), scale, thresh, inv,
        _DTYPE_CODE[qkv.dtype],
        torch.cuda.current_stream(qkv.device).cuda_stream)
    raise_on_error(lib, rc, "fused_mha_bwd",
                   f"; B={B} S={S} nh={nh} D={D} dtype={qkv.dtype}")
    LAUNCHES["fused_mha_bwd"] += 1
    return dqkv
