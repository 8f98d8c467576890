"""Channels-last layout for the vision conv trunk (the port of
paddle_tpu/nn/layout.py). The JAX package tags a transposed NHWC tensor
and propagates the tag; the port's counterpart is PyTorch's
``torch.channels_last`` memory format, which convolutions, batch norms
and pools keep on their own. Shapes stay NCHW at the API."""
from __future__ import annotations

import torch

from ..core import flags as _flags


def channels_last_enabled() -> bool:
    """True when FLAGS_conv_channels_last is set."""
    return bool(_flags.conv_channels_last)


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    """Trunk entry: the same NCHW tensor in channels-last memory."""
    return x.contiguous(memory_format=torch.channels_last)


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    """Trunk exit: the same tensor in contiguous (NCHW) memory."""
    return x.contiguous()
