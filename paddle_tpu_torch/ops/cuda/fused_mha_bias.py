"""Bind and launch the hand-written window-batched fused MHA with a
periodic additive bias (kernel #10 of the port, `csrc/fused_mha_bias.cu`,
CUDA C++ for sm_90a): the forward, and the backward with d(bias). The
library is built and loaded by `build.py`.

The wrappers check device, dtypes, shapes, contiguity, alignment and that
the batch is a multiple of the bias period, raise ValueError on what the
kernels do not take, allocate the outputs, the residuals and the scratch,
launch on PyTorch's current stream and raise RuntimeError when a launch
reports an error. They never fall back to another implementation. Each
call adds one to ``LAUNCHES["fused_mha_bias_fwd"]`` or
``["fused_mha_bias_bwd"]``, whatever passes run inside (bf16: the plan and
the forward; r and dQ, d(bias), dK/dV).

In bf16 the forward also returns its residuals for the backward: the row
statistics ``ml`` (f32 [2, B, nh, S], the max and 1 / sum) and the
live-block ``plan`` (uint8 [R, nh, nt, nt], nt = ceil(S / 64), read from
the bias; `ops.fused_mha_bias.fused_mha_bias_plan` is its plain twin). In
f32 both are None and the backward recomputes the statistics.
"""
from __future__ import annotations

import math

import torch

from .build import LAUNCHES, load_library, raise_on_error

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check(qkv, bias, num_heads):
    """Returns (B, S, nh, D, R) or raises ValueError."""
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
    if bias.dim() != 4 or tuple(bias.shape[1:]) != (nh, S, S):
        raise ValueError(f"bias must be [R, {nh}, {S}, {S}]; got "
                         f"{tuple(bias.shape)}")
    R = bias.shape[0]
    if R < 1 or B % R:
        raise ValueError(f"batch {B} is not a multiple of the bias period "
                         f"{R}")
    if bias.dtype != torch.float32:
        raise ValueError(f"bias must be float32; got {bias.dtype}")
    if not (1 <= B <= 65535 and nh <= 65535 and 1 <= S < 2 ** 15):
        raise ValueError(f"bad sizes B={B}, S={S}, num_heads={nh}")
    if qkv.numel() >= 2 ** 62 or bias.numel() >= 2 ** 62:
        raise ValueError("tensor too large")
    if qkv.device.type != "cuda":
        raise ValueError(f"the CUDA fused MHA-with-bias kernels need CUDA "
                         f"tensors; qkv is on {qkv.device}")
    if bias.device != qkv.device:
        raise ValueError(f"bias must be on {qkv.device}; found "
                         f"{bias.device}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("qkv must be contiguous and 16-byte aligned")
    if not bias.is_contiguous() or bias.data_ptr() % 16:
        raise ValueError("bias must be contiguous and 16-byte aligned")
    return B, S, nh, D, R


def fused_mha_bias_fwd_cuda(qkv, bias, num_heads, *, scale=None):
    """Forward: qkv [B, S, 3F], bias [R, nh, S, S] f32 -> (out [B, S, F]
    in qkv's dtype, ml, plan); ml and plan are the bf16 residuals (see the
    module's docstring), None in f32."""
    B, S, nh, D, R = _check(qkv, bias, num_heads)
    scale = 1.0 / math.sqrt(D) if scale is None else float(scale)
    lib = load_library("fused_mha_bias")
    out = torch.empty((B, S, nh * D), dtype=qkv.dtype, device=qkv.device)
    ml = plan = None
    if qkv.dtype == torch.bfloat16:
        nt = -(-S // 64)
        ml = torch.empty((2, B, nh, S), dtype=torch.float32,
                         device=qkv.device)
        plan = torch.empty((R, nh, nt, nt), dtype=torch.uint8,
                           device=qkv.device)
    rc = lib.pt_fused_mha_bias_fwd(
        qkv.data_ptr(), bias.data_ptr(), out.data_ptr(),
        0 if ml is None else ml.data_ptr(),
        0 if plan is None else plan.data_ptr(), B, S, nh, D, R,
        scale, _DTYPE_CODE[qkv.dtype],
        torch.cuda.current_stream(qkv.device).cuda_stream)
    raise_on_error(lib, rc, "fused_mha_bias_fwd",
                   f"; B={B} S={S} nh={nh} D={D} R={R} dtype={qkv.dtype}")
    LAUNCHES["fused_mha_bias_fwd"] += 1
    return out, ml, plan


def fused_mha_bias_bwd_cuda(qkv, bias, dout, ml, plan, num_heads, *,
                            scale=None):
    """Backward: (d(qkv) [B, S, 3F] in qkv's dtype, d(bias) [R, nh, S, S]
    f32) from qkv, the bias, dout [B, S, F] (contiguous, qkv's dtype) and,
    in bf16, the forward's residuals ml and plan (None in f32). bf16 runs
    three passes over the plan's live blocks: r and dQ, d(bias) (each live
    block summed over the batch rows of its period index in order, by one
    CTA; dead blocks written as zeros) and dK/dV; f32 four full passes:
    the row statistics, dQ, d(bias), dK/dV."""
    B, S, nh, D, R = _check(qkv, bias, num_heads)
    if tuple(dout.shape) != (B, S, nh * D) or dout.dtype != qkv.dtype or \
            dout.device != qkv.device or not dout.is_contiguous() or \
            dout.data_ptr() % 16:
        raise ValueError(f"dout must be contiguous [B, S, F] = "
                         f"{(B, S, nh * D)} in qkv's dtype and device")
    nt = -(-S // 64)
    if qkv.dtype == torch.bfloat16:
        if ml is None or tuple(ml.shape) != (2, B, nh, S) or \
                ml.dtype != torch.float32 or plan is None or \
                tuple(plan.shape) != (R, nh, nt, nt) or \
                plan.dtype != torch.uint8 or ml.device != qkv.device or \
                plan.device != qkv.device or not ml.is_contiguous() or \
                not plan.is_contiguous():
            raise ValueError(f"the bf16 backward needs the forward's ml "
                             f"[2, {B}, {nh}, {S}] f32 and plan [{R}, {nh}, "
                             f"{nt}, {nt}] uint8, contiguous on "
                             f"{qkv.device}")
    else:
        ml = torch.empty((2, B, nh, S), dtype=torch.float32,
                         device=qkv.device)
        plan = None
    scale = 1.0 / math.sqrt(D) if scale is None else float(scale)
    lib = load_library("fused_mha_bias")
    dqkv = torch.empty_like(qkv)
    dbias = torch.empty_like(bias)
    r = torch.empty((B, nh, S), dtype=torch.float32, device=qkv.device)
    rc = lib.pt_fused_mha_bias_bwd(
        qkv.data_ptr(), bias.data_ptr(), dout.data_ptr(), dqkv.data_ptr(),
        dbias.data_ptr(), ml.data_ptr(), r.data_ptr(),
        0 if plan is None else plan.data_ptr(), B, S, nh, D, R, scale,
        _DTYPE_CODE[qkv.dtype],
        torch.cuda.current_stream(qkv.device).cuda_stream)
    raise_on_error(lib, rc, "fused_mha_bias_bwd",
                   f"; B={B} S={S} nh={nh} D={D} R={R} dtype={qkv.dtype}")
    LAUNCHES["fused_mha_bias_bwd"] += 1
    return dqkv, dbias
