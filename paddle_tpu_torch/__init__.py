"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu, first slice:
paged GPT serving on an NVIDIA H100.

The JAX package `paddle_tpu` is the reference; this package imports
neither it nor JAX. Entry points run on CUDA unless the caller passes
``device="cpu"``.
"""
from .device import resolve_device
from .models.gpt import GPTConfig, GPTForCausalLM, PRESETS, gpt_config
from .inference.kv_cache import BlockPool
from .inference.serving import (Request, RequestTrace, ServingConfig,
                                ServingEngine, ServingMetrics,
                                synthetic_traffic)
from .convert import state_dict_from_paddle

__all__ = ["resolve_device", "GPTConfig", "GPTForCausalLM", "PRESETS",
           "gpt_config", "BlockPool", "Request", "RequestTrace",
           "ServingConfig", "ServingEngine", "ServingMetrics",
           "synthetic_traffic", "state_dict_from_paddle"]
