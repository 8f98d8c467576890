"""Bind and launch the hand-written flash-attention kernels (kernel #6 of
the port, `csrc/flash_attention.cu`, CUDA C++ for sm_90a): the forward,
the dQ pass and the dK/dV pass of the FlashAttention-2 backward. The
library is built and loaded by `build.py`.

The wrappers check device, dtypes, shapes, strides and alignment, raise
ValueError on what the kernels do not take, allocate the outputs, launch
on PyTorch's current stream and raise RuntimeError when a launch reports
an error. They never fall back to another implementation. Each launch adds
one to ``LAUNCHES["flash_fwd"]``, ``["flash_bwd_dq"]`` or
``["flash_bwd_dkv"]``.
"""
from __future__ import annotations

import ctypes

import torch

from .build import LAUNCHES, load_library, raise_on_error

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check(q, k, v, kv_len):
    """Returns (B, H, Sq, Sk, D, kv_len) or raises ValueError. q [B, Sq, H,
    D], k and v [B, Sk, H, D]: any strides with the last dim contiguous,
    16-byte aligned rows."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k and v must be [B, S, H, D]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    if tuple(k.shape) != (B, Sk, H, D) or tuple(v.shape) != (B, Sk, H, D):
        raise ValueError(f"k and v must be [B={B}, Sk, H={H}, D={D}]; got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise ValueError(f"q, k and v must share float32 or bfloat16; got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if D % 16 or not 16 <= D <= 256:
        raise ValueError(f"head_dim must be a multiple of 16 in [16, 256] "
                         f"(flash_attention pads others); got {D}")
    if not (1 <= B <= 65535 and 1 <= H <= 65535 and Sq >= 1 and Sk >= 1):
        raise ValueError(f"bad sizes B={B}, H={H}, Sq={Sq}, Sk={Sk}")
    if max(q.numel(), k.numel()) >= 2 ** 62:
        raise ValueError("tensor too large")
    kv = Sk if kv_len is None else int(kv_len)
    if kv < 1:
        raise ValueError(f"kv_len must be positive; got {kv}")
    if q.device.type != "cuda":
        raise ValueError(f"the CUDA flash-attention kernels need CUDA "
                         f"tensors; q is on {q.device}")
    vec = 16 // q.element_size()
    for t in (q, k, v):
        if t.device != q.device:
            raise ValueError(f"all operands must be on {q.device}; found "
                             f"{t.device}")
        if t.stride(3) != 1:
            raise ValueError("q, k and v need a contiguous last dim")
        if t.data_ptr() % 16 or any(s % vec for s in t.stride()[:3]):
            raise ValueError("q, k and v rows must be 16-byte aligned")
    return B, H, Sq, Sk, D, min(kv, Sk)


def _strides(q, k, v):
    vals = [s for t in (q, k, v) for s in t.stride()[:3]]
    return (ctypes.c_longlong * 9)(*vals)


def flash_fwd_cuda(q, k, v, *, causal, scale, kv_len=None):
    """Forward: returns (out [B, Sq, H, D] in q's dtype, lse [B, H, Sq]
    f32)."""
    B, H, Sq, Sk, D, kv = _check(q, k, v, kv_len)
    lib = load_library("flash_attention")
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    st = _strides(q, k, v)
    rc = lib.pt_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), ctypes.addressof(st), B, H, Sq, Sk, D, kv,
        int(bool(causal)), float(scale), _DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    raise_on_error(lib, rc, "flash_fwd")
    LAUNCHES["flash_fwd"] += 1
    return out, lse


def flash_delta(out, dout):
    """delta = rowsum(dout * out) in f32 as [B, H, Sq]: the one elementwise
    pass before the backward kernels."""
    return (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def _check_bwd(q, k, v, dout, lse, delta, kv_len):
    dims = _check(q, k, v, kv_len)
    B, H, Sq = dims[0], dims[1], dims[2]
    if tuple(dout.shape) != (B, Sq, H, q.shape[3]) or \
            dout.dtype != q.dtype or not dout.is_contiguous():
        raise ValueError("dout must be contiguous [B, Sq, H, D] in q's "
                         "dtype")
    for name, t in (("lse", lse), ("delta", delta)):
        if tuple(t.shape) != (B, H, Sq) or t.dtype != torch.float32 or \
                not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 "
                             f"[B, H, Sq]")
    return dims


def flash_bwd_dq_cuda(q, k, v, dout, lse, delta, *, causal, scale,
                      kv_len=None):
    """The dQ pass: returns dq [B, Sq, H, D] in q's dtype."""
    B, H, Sq, Sk, D, kv = _check_bwd(q, k, v, dout, lse, delta, kv_len)
    lib = load_library("flash_attention")
    dq = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    st = _strides(q, k, v)
    rc = lib.pt_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), ctypes.addressof(st),
        B, H, Sq, Sk, D, kv, int(bool(causal)), float(scale),
        _DTYPE_CODE[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    raise_on_error(lib, rc, "flash_bwd_dq")
    LAUNCHES["flash_bwd_dq"] += 1
    return dq


def flash_bwd_dkv_cuda(q, k, v, dout, lse, delta, *, causal, scale,
                       kv_len=None):
    """The dK/dV pass: returns (dk, dv) [B, Sk, H, D] in q's dtype."""
    B, H, Sq, Sk, D, kv = _check_bwd(q, k, v, dout, lse, delta, kv_len)
    lib = load_library("flash_attention")
    dk = torch.empty((B, Sk, H, D), dtype=q.dtype, device=q.device)
    dv = torch.empty((B, Sk, H, D), dtype=q.dtype, device=q.device)
    st = _strides(q, k, v)
    rc = lib.pt_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        ctypes.addressof(st), B, H, Sq, Sk, D, kv, int(bool(causal)),
        float(scale), _DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    raise_on_error(lib, rc, "flash_bwd_dkv")
    LAUNCHES["flash_bwd_dkv"] += 1
    return dk, dv


def flash_bwd_cuda(q, k, v, out, lse, dout, *, causal, scale, kv_len=None):
    """FA-2 backward: delta, then the dQ pass and the dK/dV pass. Returns
    (dq, dk, dv), contiguous, in q's dtype."""
    dout = dout.to(q.dtype).contiguous()
    if tuple(out.shape) != tuple(dout.shape):
        raise ValueError("out and dout must have the same shape")
    delta = flash_delta(out, dout)
    kw = dict(causal=causal, scale=scale, kv_len=kv_len)
    dq = flash_bwd_dq_cuda(q, k, v, dout, lse, delta, **kw)
    dk, dv = flash_bwd_dkv_cuda(q, k, v, dout, lse, delta, **kw)
    return dq, dk, dv
