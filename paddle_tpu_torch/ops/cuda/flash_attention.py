"""Bind and launch the hand-written flash-attention kernels (kernel #6 of
the port, `csrc/flash_attention.cu`, CUDA C++ for sm_90a): the forward,
the dQ pass and the dK/dV pass of the FlashAttention-2 backward. The
library is built and loaded by `build.py`. The same kernels serve kernel
#7, flash attention on the packed [B, S, nh * 128] layout (the
`flash_packed_*` wrappers): they read q, k and v as [B, S, nh, 128] views
of the packed tensors and write dq, dk and dv at the strides they are
given, so the gradients land in the packed layout (for GPT, in the column
slices of one [B, S, 3H] gradient of the qkv projection).

The wrappers check device, dtypes, shapes, strides and alignment, raise
ValueError on what the kernels do not take (`check_view`: the bf16
kernels read q, k and v through TMA tensor maps built from their strides
on every call), allocate the outputs they are not given, launch on
PyTorch's current stream and raise RuntimeError when a launch reports an
error. They never fall back to another implementation. Each launch adds one to ``LAUNCHES["flash_fwd"]``,
``["flash_bwd_dq"]`` or ``["flash_bwd_dkv"]``, or on the packed route to
``["flash_packed_fwd"]``, ``["flash_packed_bwd_dq"]`` or
``["flash_packed_bwd_dkv"]``.
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
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"all operands must be on {q.device}; found "
                             f"{t.device}")
        check_view(t, name)
    return B, H, Sq, Sk, D, min(kv, Sk)


def check_view(t, name):
    """Raise ValueError unless the view `t` (any device) is one a TMA
    tensor map can take: its last dim contiguous, its base and every other
    stride 16-byte aligned and those strides below 2**40 bytes. The bf16
    kernels stage every tile through a TMA tensor map built from these
    strides, which needs all three: the flash kernels' [B, S, H, D] views
    here, #11's [rows, H] matrices in `linear_ce.py`."""
    if t.stride(-1) != 1:
        raise ValueError(f"{name} needs a contiguous last dim")
    es = t.element_size()
    outer = t.stride()[:-1]
    if t.data_ptr() % 16 or any(s * es % 16 for s in outer):
        raise ValueError(f"{name}: its base and its outer strides must be "
                         f"16-byte aligned; got strides "
                         f"{tuple(t.stride())} of {es}-byte elements")
    if any(s * es >= 2 ** 40 for s in outer):
        raise ValueError(f"{name}: strides must be below 2**40 bytes")


def _strides(q, k, v):
    vals = [s for t in (q, k, v) for s in t.stride()[:3]]
    return (ctypes.c_longlong * 9)(*vals)


def _out(t, shape, q, name):
    """A gradient output: the given view after checks, or a new
    contiguous tensor; returns (tensor, its (batch, seq, head) strides)."""
    if t is None:
        t = torch.empty(shape, dtype=q.dtype, device=q.device)
    elif tuple(t.shape) != shape or t.dtype != q.dtype or \
            t.device != q.device or t.stride(3) != 1 or \
            t.data_ptr() % 16 or \
            any(s % (16 // q.element_size()) for s in t.stride()[:3]):
        raise ValueError(f"{name} must be {shape} in q's dtype and device "
                         f"with a contiguous last dim and 16-byte aligned "
                         f"rows")
    return t, (ctypes.c_longlong * 3)(*t.stride()[:3])


def _fwd(q, k, v, causal, scale, kv_len, key):
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
    raise_on_error(lib, rc, key)
    LAUNCHES[key] += 1
    return out, lse


def flash_fwd_cuda(q, k, v, *, causal, scale, kv_len=None):
    """Forward: returns (out [B, Sq, H, D] in q's dtype, lse [B, H, Sq]
    f32)."""
    return _fwd(q, k, v, causal, scale, kv_len, "flash_fwd")


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


def _bwd_dq(q, k, v, dout, lse, delta, causal, scale, kv_len, dq, key):
    B, H, Sq, Sk, D, kv = _check_bwd(q, k, v, dout, lse, delta, kv_len)
    dq, ost = _out(dq, (B, Sq, H, D), q, "dq")
    lib = load_library("flash_attention")
    st = _strides(q, k, v)
    rc = lib.pt_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), ctypes.addressof(st),
        ctypes.addressof(ost), B, H, Sq, Sk, D, kv, int(bool(causal)),
        float(scale), _DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    raise_on_error(lib, rc, key)
    LAUNCHES[key] += 1
    return dq


def _bwd_dkv(q, k, v, dout, lse, delta, causal, scale, kv_len, dk, dv,
             key):
    B, H, Sq, Sk, D, kv = _check_bwd(q, k, v, dout, lse, delta, kv_len)
    dk, ost = _out(dk, (B, Sk, H, D), q, "dk")
    dv, vst = _out(dv, (B, Sk, H, D), q, "dv")
    if tuple(ost) != tuple(vst):
        raise ValueError("dk and dv must share their strides")
    lib = load_library("flash_attention")
    st = _strides(q, k, v)
    rc = lib.pt_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        ctypes.addressof(st), ctypes.addressof(ost), B, H, Sq, Sk, D, kv,
        int(bool(causal)), float(scale), _DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    raise_on_error(lib, rc, key)
    LAUNCHES[key] += 1
    return dk, dv


def flash_bwd_dq_cuda(q, k, v, dout, lse, delta, *, causal, scale,
                      kv_len=None):
    """The dQ pass: returns dq [B, Sq, H, D] in q's dtype."""
    return _bwd_dq(q, k, v, dout, lse, delta, causal, scale, kv_len, None,
                   "flash_bwd_dq")


def flash_bwd_dkv_cuda(q, k, v, dout, lse, delta, *, causal, scale,
                       kv_len=None):
    """The dK/dV pass: returns (dk, dv) [B, Sk, H, D] in q's dtype."""
    return _bwd_dkv(q, k, v, dout, lse, delta, causal, scale, kv_len, None,
                    None, "flash_bwd_dkv")


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


# --------------------------------------------- kernel #7: packed layout
def _heads(t, num_heads, name):
    """[B, S, nh * hd] (last dim contiguous) as its [B, S, nh, hd] view."""
    if t.dim() != 3 or t.shape[2] % num_heads:
        raise ValueError(f"{name} must be [B, S, num_heads * head_dim]; "
                         f"got {tuple(t.shape)} with num_heads={num_heads}")
    if t.stride(2) != 1:
        raise ValueError(f"{name} needs a contiguous last dim")
    return t.unflatten(2, (num_heads, t.shape[2] // num_heads))


def flash_packed_fwd_cuda(q, k, v, num_heads, *, causal, scale,
                          kv_len=None):
    """Forward on packed q [B, Sq, nh * hd], k and v [B, Sk, nh * hd]
    (column slices of one projection are taken as they are): returns
    (out [B, Sq, nh * hd] contiguous in q's dtype, lse [B, nh, Sq] f32)."""
    q4, k4, v4 = (_heads(t, num_heads, n) for t, n in
                  ((q, "q"), (k, "k"), (v, "v")))
    out, lse = _fwd(q4, k4, v4, causal, scale, kv_len, "flash_packed_fwd")
    return out.flatten(2), lse


def flash_packed_bwd_cuda(q, k, v, out, lse, dout, num_heads, *, causal,
                          scale, kv_len=None, dq=None, dk=None, dv=None):
    """FA-2 backward on the packed layout: delta, then the dQ pass and the
    dK/dV pass. dq, dk and dv [B, S, nh * hd] are written in place where
    given (for instance the column slices of one packed gradient), else
    allocated; returns (dq, dk, dv)."""
    q4, k4, v4 = (_heads(t, num_heads, n) for t, n in
                  ((q, "q"), (k, "k"), (v, "v")))
    dout4 = _heads(dout.to(q.dtype).contiguous(), num_heads, "dout")
    out4 = _heads(out, num_heads, "out")
    if tuple(out4.shape) != tuple(dout4.shape):
        raise ValueError("out and dout must have the same shape")
    delta = flash_delta(out4, dout4)
    dq4, dk4, dv4 = (None if t is None else _heads(t, num_heads, n)
                     for t, n in ((dq, "dq"), (dk, "dk"), (dv, "dv")))
    args = (q4, k4, v4, dout4, lse, delta, causal, scale, kv_len)
    dq4 = _bwd_dq(*args, dq4, "flash_packed_bwd_dq")
    dk4, dv4 = _bwd_dkv(*args, dk4, dv4, "flash_packed_bwd_dkv")
    return dq4.flatten(2), dk4.flatten(2), dv4.flatten(2)
