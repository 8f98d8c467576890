"""The global flag registry, `set_flags` / `get_flags` (the port's own
copy of paddle_tpu/core/flags.py: the same names and defaults, unknown
names accepted, ``FLAGS_*`` environment variables read at import).

Only ``FLAGS_conv_channels_last`` changes anything in the port: under it
the ResNet trunk runs in PyTorch's channels-last memory format
(`nn.layout`), the layout in which cuDNN's bf16 convolutions reach the
tensor cores without transposes, and `nn.functional.conv2d` /
`fused_conv_bn_act` take their NCHW inputs in that format. The other
flags steer the JAX package's XLA and TPU machinery and are kept for
their names only.
"""
from __future__ import annotations

import os
from typing import Any, Dict

_REGISTRY: Dict[str, Any] = {
    "FLAGS_check_nan_inf": False,
    "FLAGS_benchmark": False,
    "FLAGS_cudnn_deterministic": True,
    "FLAGS_use_autotune": True,
    "FLAGS_flash_autotune": False,
    "FLAGS_conv_channels_last": False,
    "FLAGS_allocator_strategy": "xla",
    "FLAGS_fraction_of_gpu_memory_to_use": 0.0,
    "FLAGS_eager_delete_tensor_gb": 0.0,
    "FLAGS_max_inplace_grad_add": 0,
    "FLAGS_embedding_deterministic": 1,
    "FLAGS_sync_nccl_allreduce": False,
    "FLAGS_stop_check_timeout": 300,
}

# fast-path mirror read by nn.layout
conv_channels_last: bool = False


def _apply_side_effects(name: str, value):
    global conv_channels_last
    if name == "FLAGS_conv_channels_last":
        conv_channels_last = (bool(int(value))
                              if not isinstance(value, bool) else value)


def set_flags(flags: Dict[str, Any]):
    for name, value in flags.items():
        _REGISTRY[name] = value
        _apply_side_effects(name, value)


def get_flags(flags) -> Dict[str, Any]:
    if isinstance(flags, str):
        flags = [flags]
    return {name: _REGISTRY.get(name) for name in flags}


def _init_from_env():
    for key, val in os.environ.items():
        if key.startswith("FLAGS_"):
            cur = _REGISTRY.get(key)
            if isinstance(cur, bool):
                parsed = val.lower() in ("1", "true", "yes")
            elif isinstance(cur, int):
                parsed = int(val)
            elif isinstance(cur, float):
                parsed = float(val)
            else:
                parsed = val
            _REGISTRY[key] = parsed
            _apply_side_effects(key, parsed)


_init_from_env()
