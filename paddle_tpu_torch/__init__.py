"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu: GPT on an
NVIDIA H100. It trains (`GPTForCausalLM.loss` or
`GPTPretrainingCriterion`, `AdamW`, `GradScaler`, `ClipGradByGlobalNorm`,
`TrainStep`, through the flash-attention and fused linear cross-entropy
kernels), and it serves through the static decode stack and the padded
engine or the paged engine with the prefix cache, chunked prefill and
speculative decoding, with bf16 or weight-only int8 weights.

The JAX package `paddle_tpu` is the reference; this package imports
neither it nor JAX. Entry points run on CUDA unless the caller passes
``device="cpu"``.
"""
from .device import resolve_device
from .models.gpt import (GPTConfig, GPTForCausalLM,
                         GPTPretrainingCriterion, PRESETS, gpt_config)
from .inference.kv_cache import BlockPool
from .inference.prefix_cache import PrefixCache
from .inference.serving import (Request, RequestTrace, ServingConfig,
                                ServingEngine, ServingMetrics,
                                model_draft_fn, repeated_traffic,
                                shared_prefix_traffic, synthetic_traffic)
from .amp import GradScaler
from .convert import state_dict_from_paddle, train_state_from_paddle
from .jit import TrainStep
from .nn import ClipGradByGlobalNorm
from .optimizer import Adam, AdamW

__all__ = ["resolve_device", "GPTConfig", "GPTForCausalLM", "PRESETS",
           "gpt_config", "BlockPool", "PrefixCache", "Request",
           "RequestTrace", "ServingConfig", "ServingEngine",
           "ServingMetrics", "model_draft_fn", "repeated_traffic",
           "shared_prefix_traffic", "synthetic_traffic",
           "state_dict_from_paddle", "train_state_from_paddle",
           "GPTPretrainingCriterion", "TrainStep", "Adam", "AdamW",
           "GradScaler", "ClipGradByGlobalNorm"]
