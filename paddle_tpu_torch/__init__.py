"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu: GPT serving on
an NVIDIA H100, through the static decode stack and the padded engine or
the paged engine with the prefix cache, chunked prefill and speculative
decoding, with bf16 or weight-only int8 weights.

The JAX package `paddle_tpu` is the reference; this package imports
neither it nor JAX. Entry points run on CUDA unless the caller passes
``device="cpu"``.
"""
from .device import resolve_device
from .models.gpt import GPTConfig, GPTForCausalLM, PRESETS, gpt_config
from .inference.kv_cache import BlockPool
from .inference.prefix_cache import PrefixCache
from .inference.serving import (Request, RequestTrace, ServingConfig,
                                ServingEngine, ServingMetrics,
                                model_draft_fn, repeated_traffic,
                                shared_prefix_traffic, synthetic_traffic)
from .convert import state_dict_from_paddle

__all__ = ["resolve_device", "GPTConfig", "GPTForCausalLM", "PRESETS",
           "gpt_config", "BlockPool", "PrefixCache", "Request",
           "RequestTrace", "ServingConfig", "ServingEngine",
           "ServingMetrics", "model_draft_fn", "repeated_traffic",
           "shared_prefix_traffic", "synthetic_traffic",
           "state_dict_from_paddle"]
