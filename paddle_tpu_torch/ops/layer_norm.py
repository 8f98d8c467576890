"""Fused LayerNorm (the port of paddle_tpu/ops/pallas/layer_norm.py): one
pass over the rows each way, the statistics in f32.

    forward   s1 = sum x, s2 = sum x^2 (f32), mu = s1 / H,
              var = max(s2 / H - mu^2, 0)  (the one-pass variance of the
              TPU kernel), rsig = 1 / sqrt(var + eps),
              out = (x - mu) * rsig * gamma + beta, rounded to x's dtype;
              mu and rsig [R] f32 are saved for the backward
    backward  xhat = (x - mu) * rsig, dyg = dy * gamma,
              dx = rsig * (dyg - xhat * sum(dyg * xhat) / H - sum(dyg) / H),
              d(gamma) = sum_rows dy * xhat and d(beta) = sum_rows dy in
              f32, cast to the parameters' dtype

The one-pass variance cancels where |mean| >> std (x = 1000 + N(0, 1) in
f32 loses most of its digits); the TPU kernel has the same flaw and the
port follows it. `torch.nn.functional.layer_norm`, the default route,
computes the variance in two passes.

`fused_layer_norm` routes by device and by nothing else: a CUDA tensor
runs the hand-written kernels (ops/cuda/layer_norm.py, kernel #8) inside a
torch.autograd.Function, which launch or raise; a CPU tensor runs
`fused_layer_norm_reference`, the plain version, under autograd. Whether a
LayerNorm takes this route at all is `fused_layer_norm_supported`: the
JAX predicate (the opt-in PADDLE_TPU_FUSED_LN=1 read at call time, H a
multiple of 128, a row count that is a positive multiple of 8) minus its
platform test.
"""
from __future__ import annotations

import os

import torch

from .attention import _on_cuda
from .cuda.layer_norm import layer_norm_bwd_cuda, layer_norm_fwd_cuda


def fused_layer_norm_supported(x_shape) -> bool:
    """The routing predicate `nn.functional.layer_norm` reads: the opt-in
    PADDLE_TPU_FUSED_LN=1, H % 128 == 0 and R = prod(leading dims) >= 8
    with R % 8 == 0."""
    if os.environ.get("PADDLE_TPU_FUSED_LN") != "1":
        return False
    if x_shape[-1] % 128 != 0:
        return False
    r = 1
    for d in x_shape[:-1]:
        r *= int(d)
    return r >= 8 and r % 8 == 0


def fused_layer_norm_reference(x2, gamma=None, beta=None, eps=1e-5):
    """The plain version of the forward kernel on x2 [R, H]: (out in x2's
    dtype, mu [R] f32, rsig [R] f32), with the kernel's one-pass f32
    statistics and rounding steps. Differentiable through autograd."""
    x = x2.float()
    n = x.shape[-1]
    mu = x.sum(-1) / n
    var = ((x * x).sum(-1) / n - mu * mu).clamp_min(0.0)
    rs = 1.0 / torch.sqrt(var + eps)
    out = (x - mu[:, None]) * rs[:, None]
    if gamma is not None:
        out = out * gamma.float()
    if beta is not None:
        out = out + beta.float()
    return out.to(x2.dtype), mu, rs


def fused_layer_norm_bwd_reference(dy2, x2, mu, rs, gamma=None):
    """The plain version of the backward kernel on its inputs: (dx in x2's
    dtype, d(gamma) [H] f32, d(beta) [H] f32) from dy2 and x2 [R, H] and
    the saved mu and rsig [R]."""
    dy, x = dy2.float(), x2.float()
    n = x.shape[-1]
    xhat = (x - mu[:, None]) * rs[:, None]
    dyg = dy * gamma.float() if gamma is not None else dy
    a = (dyg * xhat).sum(-1, keepdim=True) / n
    b = dyg.sum(-1, keepdim=True) / n
    dx = rs[:, None] * (dyg - xhat * a - b)
    return dx.to(x2.dtype), (dy * xhat).sum(0), dy.sum(0)


class _FusedLayerNorm(torch.autograd.Function):
    """Forward kernel saving x, mu and rsig; the backward kernel gives dx
    and the f32 d(gamma), d(beta), cast to the parameters' dtype."""

    @staticmethod
    def forward(ctx, x2, gamma, beta, eps):
        out, mu, rs = layer_norm_fwd_cuda(x2, gamma, beta, eps)
        ctx.save_for_backward(x2, mu, rs, gamma)
        ctx.beta_dtype = None if beta is None else beta.dtype
        return out

    @staticmethod
    def backward(ctx, dout):
        x2, mu, rs, gamma = ctx.saved_tensors
        dx, dg, db = layer_norm_bwd_cuda(dout.contiguous(), x2, mu, rs,
                                         gamma)
        return (dx, None if gamma is None else dg.to(gamma.dtype),
                None if ctx.beta_dtype is None else db.to(ctx.beta_dtype),
                None)


def fused_layer_norm(x, gamma=None, beta=None, eps: float = 1e-5):
    """LayerNorm over the last axis of x [..., H] with optional gamma and
    beta [H]; returns x's shape and dtype. On CUDA tensors kernel #8 runs
    (the caller checks `fused_layer_norm_supported`; the kernels take any
    H that is a multiple of 8 and raise on others); on CPU tensors its
    plain version, under autograd."""
    h = x.shape[-1]
    x2 = x.reshape(-1, h)
    if _on_cuda(x):
        out = _FusedLayerNorm.apply(x2.contiguous(), gamma, beta,
                                    float(eps))
    else:
        out = fused_layer_norm_reference(x2, gamma, beta, eps)[0]
    return out.reshape(x.shape)
