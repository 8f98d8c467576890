"""Bind and launch the hand-written LayerNorm kernels (kernel #8 of the
port, `csrc/layer_norm.cu`, CUDA C++ for sm_90a): the forward, and the
backward with d(gamma) and d(beta). The library is built and loaded by
`build.py`; `ln_plan` chooses each launch.

The wrappers check device, dtypes, shapes, contiguity and alignment,
raise ValueError on what the kernels do not take, allocate the outputs
(and the backward's per-CTA partial sums), launch on PyTorch's current
stream and raise RuntimeError when a launch reports an error. They never
fall back to another implementation. Each call adds one to
``LAUNCHES["layer_norm_fwd"]`` or ``["layer_norm_bwd"]`` (the backward
entry point runs the row pass and the partials' sum as one call).
"""
from __future__ import annotations

import collections
import functools

import torch

from .build import LAUNCHES, load_library, raise_on_error
from .int8_matmul import _sms

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_VARIANT_CODE = {"rows": 0, "loop": 1}
MAX_THREADS = 512      # every kernel's CTA limit (kMaxThreads)
ROWS_MAX_VECS = 1024   # "rows" while a row holds at most this many 16-byte
                       # vectors (bf16 H <= 8192, f32 H <= 4096)
RING_BYTES = 100 * 1024  # a "rows" CTA's ring at most: two CTAs fit an SM
FWD_STAGES, BWD_STAGES = 4, 2  # the rings' depths (kFwdStages, kBwdStages):
                               # rows a forward slot holds, groups a
                               # backward thread holds

LNPlan = collections.namedtuple("LNPlan", [
    "variant",      # "rows": each row read once (a cp.async ring); "loop"
    "fwd_threads", "fwd_warps", "fwd_vecs", "fwd_grid",
    "bwd_threads", "bwd_tpr", "bwd_vecs", "bwd_rows", "bwd_grid"])
# forward: warps a row, vectors a lane (rows); CTAs, persistent.
# backward: threads a row slot, vectors a thread, rows a group (rows);
# CTAs, each a contiguous range of rows and one [2, H] partial


@functools.lru_cache(maxsize=None)
def ln_plan(R, H, dtype, sms):
    """Kernel #8's launches for [R, H] rows of `dtype` on a card of `sms`
    SMs (an LNPlan); it depends on its arguments only. N = 16 // itemsize
    elements a 16-byte vector, V = H / N vectors a row.

    "rows" (V <= ROWS_MAX_VECS), every row read from device memory once,
    through a ring of cp.async copies in shared memory (RING_BYTES at
    most, so two CTAs fit an SM):
      forward: the warps a row (1-8) that leave the fewest lanes idle at
        4 vectors a lane or fewer, then the fewest; about 256 threads (a
        whole number of row slots); at most two CTAs an SM, each walking
        rows with gamma and beta in its registers;
      backward: 1 vector a thread up to V = 512, else 2; a row slot of V /
        vectors threads rounded up to a warp (lanes past the row's end
        idle); row slots up to 256 threads a CTA; rows in groups of 4 (2
        where a ring of groups of 4 would not fit); CTAs one a group up to
        two an SM at 256 threads or fewer, else one an SM (their registers
        keep a second off).
    "loop" (wider rows, read twice): 512 threads, a row at a time, CTAs
    up to two an SM forward and one an SM backward, none without rows.
    These choices are measured ones (an H100, phase 2's shapes): deeper
    rings, groups of 8 and one CTA an SM at 256 threads ran slower.
    """
    n = 16 // dtype.itemsize
    v = H // n
    if v > ROWS_MAX_VECS:
        return LNPlan("loop", MAX_THREADS, 0, 0, min(R, 2 * sms),
                      MAX_THREADS, MAX_THREADS, 0, 1, min(R, sms))
    warps = min((w for w in range(1, 9) if -(-v // (32 * w)) <= 4),
                key=lambda w: (32 * w * -(-v // (32 * w)) - v, w))
    fvecs = -(-v // (32 * warps))
    fthreads = 32 * warps * max(1, round(256 / (32 * warps)))
    bvecs = 1 if v <= 512 else 2
    tpr = -(-v // (32 * bvecs)) * 32
    slots = max(1, 256 // tpr)
    k = 4 if BWD_STAGES * 4 * 2 * slots * tpr * bvecs * 16 <= RING_BYTES \
        else 2
    return LNPlan("rows", fthreads, warps, fvecs,
                  min(-(-R // (fthreads // (32 * warps))), 2 * sms),
                  slots * tpr, tpr, bvecs, k,
                  min(-(-R // (slots * k)),
                      (2 if slots * tpr <= 256 else 1) * sms))


def _check_rows(x, name="x"):
    """Returns (R, H) of a contiguous [R, H] tensor the kernels take."""
    if x.dim() != 2:
        raise ValueError(f"{name} must be [R, H]; got {tuple(x.shape)}")
    R, H = x.shape
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name} must be float32 or bfloat16; got "
                         f"{x.dtype}")
    if H % 8 or not 8 <= H < 2 ** 31 or not 1 <= R < 2 ** 31:
        raise ValueError(f"{name}: H must be a multiple of 8, at least 8, "
                         f"and R positive; got R={R}, H={H}")
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
    plan = ln_plan(R, H, x.dtype, _sms(x.device))
    out = torch.empty_like(x)
    mu = torch.empty(R, dtype=torch.float32, device=x.device)
    rs = torch.empty(R, dtype=torch.float32, device=x.device)
    rc = lib.pt_layer_norm_fwd(
        x.data_ptr(), g, b, out.data_ptr(), mu.data_ptr(), rs.data_ptr(),
        R, H, float(eps), _DTYPE_CODE[x.dtype], _VARIANT_CODE[plan.variant],
        plan.fwd_threads, plan.fwd_warps, plan.fwd_vecs, plan.fwd_grid,
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
    plan = ln_plan(R, H, x.dtype, _sms(x.device))
    dx = torch.empty_like(x)
    part = torch.empty((plan.bwd_grid, 2, H), dtype=torch.float32,
                       device=x.device)
    dg = torch.empty(H, dtype=torch.float32, device=x.device)
    db = torch.empty(H, dtype=torch.float32, device=x.device)
    rc = lib.pt_layer_norm_bwd(
        dy.data_ptr(), x.data_ptr(), mu.data_ptr(), rs.data_ptr(), g,
        dx.data_ptr(), part.data_ptr(), dg.data_ptr(), db.data_ptr(), R, H,
        _DTYPE_CODE[x.dtype], _VARIANT_CODE[plan.variant], plan.bwd_threads,
        plan.bwd_tpr, plan.bwd_vecs, plan.bwd_rows, plan.bwd_grid,
        torch.cuda.current_stream(x.device).cuda_stream)
    raise_on_error(lib, rc, "layer_norm_bwd",
                   f"; R={R} H={H} dtype={x.dtype}")
    LAUNCHES["layer_norm_bwd"] += 1
    return dx, dg, db
