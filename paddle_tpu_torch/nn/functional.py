"""Functional layers of the port (the port of paddle_tpu/nn/functional.py's
`layer_norm` routing and the vision trunk's `conv2d`, `batch_norm`,
`max_pool2d`, `adaptive_avg_pool2d` and `fused_conv_bn_act`).

The vision functions are PyTorch's own (cuDNN on the card), as the JAX
package's are XLA's: the JAX package has no Pallas kernel for them. What
the port keeps of the JAX package is its semantics: Paddle's padding
forms, the max pool's -inf padding and ignored `ceil_mode`, and Paddle's
running-statistics rule (``new = momentum * old + (1 - momentum) *
batch`` with the biased batch variance, momentum 0.9), which is not
``torch.nn.functional.batch_norm``'s.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as TF

from ..ops.layer_norm import fused_layer_norm, fused_layer_norm_supported
from . import layout as _layout

_CHANNEL_LAST_FORMATS = ("NHWC", "NLC", "NDHWC", "NHC")


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    """LayerNorm over the trailing `normalized_shape` axes. Over one axis,
    where `fused_layer_norm_supported(x.shape)` holds (the opt-in
    PADDLE_TPU_FUSED_LN=1 and the kernel's shape rule), it runs the fused
    LayerNorm (kernel #8 on CUDA); otherwise
    `torch.nn.functional.layer_norm`, as `torch.nn.LayerNorm` does."""
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    normalized_shape = tuple(normalized_shape)
    if len(normalized_shape) == 1 and \
            fused_layer_norm_supported(tuple(x.shape)):
        return fused_layer_norm(x, weight, bias, eps=epsilon)
    return torch.nn.functional.layer_norm(x, normalized_shape, weight, bias,
                                          epsilon)


# ------------------------------------------------------------ helpers
def _norm_tuple(v, n):
    if isinstance(v, (list, tuple)):
        return tuple(int(i) for i in v)
    return (int(v),) * n


def _pads(padding, n, spatial, kernel, strides, dilation):
    """Paddle's padding forms ("SAME", "VALID", an int, n ints, 2n ints,
    or n (lo, hi) pairs) as n (lo, hi) pairs; "SAME" is XLA's (ceil(in /
    stride) outputs, the odd element of the total on the high side)."""
    if isinstance(padding, str):
        if padding.upper() == "VALID":
            return [(0, 0)] * n
        pairs = []
        for size, k, s, d in zip(spatial, kernel, strides, dilation):
            total = max((-(-size // s) - 1) * s + (k - 1) * d + 1 - size, 0)
            pairs.append((total // 2, total - total // 2))
        return pairs
    if isinstance(padding, int):
        return [(padding, padding)] * n
    padding = list(padding)
    if len(padding) == n and all(isinstance(p, int) for p in padding):
        return [(p, p) for p in padding]
    if len(padding) == 2 * n:
        return [(padding[2 * i], padding[2 * i + 1]) for i in range(n)]
    return [tuple(p) for p in padding]


def _pad_explicit(x, pairs, value=0.0):
    """x with (lo, hi) pairs of its trailing axes padded by `value`."""
    flat = []
    for lo, hi in reversed(pairs):       # F.pad counts from the last axis
        flat += [lo, hi]
    return TF.pad(x, flat, value=value)


def _to_nchw_view(x, data_format):
    """An NHWC input as an NCHW view (no copy; channels-last memory)."""
    return x.permute(0, 3, 1, 2) if data_format in _CHANNEL_LAST_FORMATS \
        else x


def _from_nchw_view(y, data_format):
    return y.permute(0, 2, 3, 1) if data_format in _CHANNEL_LAST_FORMATS \
        else y


# --------------------------------------------------------------- conv
def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    """2-D convolution, weight ``[out, in / groups, kh, kw]``, data
    "NCHW" or "NHWC". Under FLAGS_conv_channels_last an NCHW input runs in
    channels-last memory (the output keeps it)."""
    a = _to_nchw_view(x, data_format)
    if _layout.channels_last_enabled():
        a = _layout.to_nhwc(a)
    strides, dil = _norm_tuple(stride, 2), _norm_tuple(dilation, 2)
    pairs = _pads(padding, 2, a.shape[2:], weight.shape[2:], strides, dil)
    pad = tuple(lo for lo, _ in pairs)
    if any(lo != hi for lo, hi in pairs):
        a, pad = _pad_explicit(a, pairs), (0, 0)
    y = TF.conv2d(a, weight, bias, strides, pad, dil, groups)
    return _from_nchw_view(y, data_format)


# ---------------------------------------------------------- batch norm
def _batch_stats_norm(x, weight, bias, epsilon):
    """(normalised x, batch mean, biased batch variance) over every axis
    but 1, in one `torch.nn.functional.batch_norm` pass: zeroed scratch
    running buffers with momentum 1 receive the batch mean and the
    unbiased variance, which is scaled back to the biased one."""
    sd = weight.dtype if weight is not None else \
        torch.promote_types(x.dtype, torch.float32)
    c = x.shape[1]
    mean = torch.zeros(c, dtype=sd, device=x.device)
    var = torch.zeros(c, dtype=sd, device=x.device)
    y = TF.batch_norm(x, mean, var, weight, bias, True, 1.0, epsilon)
    n = x.numel() // c
    return y, mean, var * ((n - 1) / n)


@torch.no_grad()
def _update_running(running_mean, running_var, mean, var, momentum):
    """Paddle's rule, in the buffers' dtype: momentum * old + (1 -
    momentum) * batch."""
    running_mean.mul_(momentum).add_(
        (1 - momentum) * mean.to(running_mean.dtype))
    running_var.mul_(momentum).add_(
        (1 - momentum) * var.to(running_var.dtype))


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW", use_global_stats=None, name=None):
    """Batch normalisation over every axis but the channel (axis 1, or the
    last for a channels-last `data_format`). In training (and not
    `use_global_stats`) it normalises with the batch statistics and
    updates `running_mean` / `running_var` in place by Paddle's rule;
    otherwise it normalises with them."""
    cl = not data_format.startswith("NC")
    a = x.movedim(-1, 1) if cl else x
    if training and not use_global_stats:
        y, mean, var = _batch_stats_norm(a, weight, bias, epsilon)
        if running_mean is not None:
            _update_running(running_mean, running_var, mean, var, momentum)
    else:
        y = TF.batch_norm(a, running_mean, running_var, weight, bias, False,
                          0.0, epsilon)
    return y.movedim(1, -1) if cl else y


# ------------------------------------------------------------ pooling
def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCHW", name=None):
    """Max pooling with -inf padding. `ceil_mode` is accepted and ignored
    (the output size rounds down), as in the JAX package."""
    if return_mask:
        raise NotImplementedError(
            "max_pool2d(return_mask=True) pairs with MaxUnPool2D, which comes "
            "with the rest of the Paddle API surface (ROADMAP queue A)")
    a = _to_nchw_view(x, data_format)
    k = _norm_tuple(kernel_size, 2)
    s = _norm_tuple(stride if stride is not None else kernel_size, 2)
    pairs = _pads(padding, 2, a.shape[2:], k, s, (1, 1))
    pad = tuple(lo for lo, _ in pairs)
    # PyTorch pads implicitly only symmetrically and up to half a window
    if any(lo != hi or lo > kk // 2 for (lo, hi), kk in zip(pairs, k)):
        a, pad = _pad_explicit(a, pairs, -math.inf), (0, 0)
    return _from_nchw_view(TF.max_pool2d(a, k, s, pad), data_format)


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    """Adaptive average pooling; bins floor(i h / oh) .. ceil((i + 1) h /
    oh), the JAX package's and PyTorch's."""
    a = _to_nchw_view(x, data_format)
    y = TF.adaptive_avg_pool2d(a, _norm_tuple(output_size, 2))
    return _from_nchw_view(y, data_format)


# ------------------------------------------------- fused conv + BN + act
_EPILOGUE_ACTS = {
    None: lambda v: v,
    "identity": lambda v: v,
    "relu": TF.relu,
    "relu6": lambda v: torch.clamp(v, 0, 6),
    "gelu": TF.gelu,                         # exact erf form (the default)
    "silu": TF.silu,
    "hardswish": lambda v: v * torch.clamp(v + 3, 0, 6) / 6,
    "leaky_relu": lambda v: TF.leaky_relu(v, 0.01),
}


def fused_conv_bn_act(x, weight, bias=None, running_mean=None,
                      running_var=None, bn_weight=None, bn_bias=None,
                      stride=1, padding=0, dilation=1, groups=1,
                      data_format="NCHW", training=False, momentum=0.9,
                      epsilon=1e-5, use_global_stats=None, act=None,
                      residual=None, name=None):
    """act(batch_norm(conv2d(x)) [+ residual]) with the JAX function's
    signature: batch statistics in training (the running statistics
    updated by Paddle's rule), the running ones in eval or under
    `use_global_stats`. `act` is None or one of "identity", "relu",
    "relu6", "gelu" (exact erf), "silu", "hardswish", "leaky_relu". Here
    it is conv then batch norm through PyTorch (cuDNN on the card); the
    JAX eval path folds the BN scale into the conv weight instead, equal
    up to rounding."""
    if act not in _EPILOGUE_ACTS:
        raise ValueError(f"act={act!r}: expected one of "
                         f"{sorted(a for a in _EPILOGUE_ACTS if a)} or None")
    use_batch_stats = training and not use_global_stats
    if not use_batch_stats and (running_mean is None or running_var is None):
        raise ValueError("fused_conv_bn_act in inference mode needs "
                         "running_mean/running_var")
    y = conv2d(x, weight, bias, stride, padding, dilation, groups,
               data_format)
    y = batch_norm(y, running_mean, running_var, bn_weight, bn_bias,
                   training=use_batch_stats, momentum=momentum,
                   epsilon=epsilon, data_format=data_format)
    if residual is not None:
        y = y + residual
    return _EPILOGUE_ACTS[act](y)
