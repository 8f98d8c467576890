"""Bind and launch the hand-written LayerNorm kernels (kernel #8 of the
port, `csrc/layer_norm.cu`, CUDA C++ for sm_90a): the forward, and the
backward with d(gamma) and d(beta). The library is built and loaded by
`build.py`.

The wrappers check device, dtypes, shapes, contiguity and alignment,
raise ValueError on what the kernels do not take, allocate the outputs
(and the backward's per-block partial sums), launch on PyTorch's current
stream and raise RuntimeError when a launch reports an error. They never
fall back to another implementation. Each call adds one to
``LAUNCHES["layer_norm_fwd"]`` or ``["layer_norm_bwd"]`` (the backward
entry point runs the row pass and the partials' sum as one call).
"""
from __future__ import annotations

import torch

from .build import LAUNCHES, load_library, raise_on_error

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
BWD_ROWS = 16      # rows per backward CTA (kBwdRows in the source)
MAX_H = 16384      # the backward keeps 2 * H f32 sums in shared memory


def _check_rows(x, name="x"):
    """Returns (R, H) of a contiguous [R, H] tensor the kernels take."""
    if x.dim() != 2:
        raise ValueError(f"{name} must be [R, H]; got {tuple(x.shape)}")
    R, H = x.shape
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name} must be float32 or bfloat16; got "
                         f"{x.dtype}")
    if H % 8 or not 8 <= H <= MAX_H or not 1 <= R < 2 ** 31:
        raise ValueError(f"{name}: H must be a multiple of 8 in [8, "
                         f"{MAX_H}] and R positive; got R={R}, H={H}")
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA LayerNorm kernels need CUDA tensors; "
                         f"{name} is on {x.device}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    return R, H


def _check_affine(t, x, name):
    if t is None:
        return 0
    if tuple(t.shape) != (x.shape[1],) or t.dtype != x.dtype or \
            t.device != x.device or not t.is_contiguous() or \
            t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous [{x.shape[1]}] in x's "
                         f"dtype and device, 16-byte aligned")
    return t.data_ptr()


def layer_norm_fwd_cuda(x, gamma, beta, eps):
    """Forward on x [R, H]: returns (out [R, H] in x's dtype, mu [R] f32,
    rsig [R] f32). gamma and beta are [H] in x's dtype, or None."""
    R, H = _check_rows(x)
    g = _check_affine(gamma, x, "gamma")
    b = _check_affine(beta, x, "beta")
    lib = load_library("layer_norm")
    out = torch.empty_like(x)
    mu = torch.empty(R, dtype=torch.float32, device=x.device)
    rs = torch.empty(R, dtype=torch.float32, device=x.device)
    rc = lib.pt_layer_norm_fwd(
        x.data_ptr(), g, b, out.data_ptr(), mu.data_ptr(), rs.data_ptr(),
        R, H, float(eps), _DTYPE_CODE[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    raise_on_error(lib, rc, "layer_norm_fwd",
                   f"; R={R} H={H} dtype={x.dtype}")
    LAUNCHES["layer_norm_fwd"] += 1
    return out, mu, rs


def layer_norm_bwd_cuda(dy, x, mu, rs, gamma):
    """Backward from dy and x [R, H] and the forward's mu and rsig [R]:
    returns (dx [R, H] in x's dtype, dgamma [H] f32, dbeta [H] f32)."""
    R, H = _check_rows(x)
    _check_rows(dy, "dy")
    if tuple(dy.shape) != (R, H) or dy.dtype != x.dtype or \
            dy.device != x.device:
        raise ValueError("dy must match x's shape, dtype and device")
    for name, t in (("mu", mu), ("rsig", rs)):
        if tuple(t.shape) != (R,) or t.dtype != torch.float32 or \
                t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 [{R}]")
    g = _check_affine(gamma, x, "gamma")
    lib = load_library("layer_norm")
    dx = torch.empty_like(x)
    nb = -(-R // BWD_ROWS)
    part = torch.empty((nb, 2, H), dtype=torch.float32, device=x.device)
    dg = torch.empty(H, dtype=torch.float32, device=x.device)
    db = torch.empty(H, dtype=torch.float32, device=x.device)
    rc = lib.pt_layer_norm_bwd(
        dy.data_ptr(), x.data_ptr(), mu.data_ptr(), rs.data_ptr(), g,
        dx.data_ptr(), part.data_ptr(), dg.data_ptr(), db.data_ptr(), R, H,
        _DTYPE_CODE[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    raise_on_error(lib, rc, "layer_norm_bwd",
                   f"; R={R} H={H} dtype={x.dtype}")
    LAUNCHES["layer_norm_bwd"] += 1
    return dx, dg, db
