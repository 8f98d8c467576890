"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu on an NVIDIA
H100. It trains GPT (`GPTForCausalLM.loss` or `GPTPretrainingCriterion`,
through the flash-attention and fused linear cross-entropy kernels; with
routed-expert MoE blocks under `GPTConfig(moe_num_experts=...)`), BERT
(`BertForMaskedLM.loss`, through the fused short-sequence MHA and the
fused linear cross-entropy), ERNIE (`ErnieForMaskedLM.loss`, the same
kernels), ViT (`VisionTransformer`, through the fused
MHA), Swin (`swin_t` and the other presets of `vision.models`, through
the window-batched fused MHA with bias) and the ResNet family (`resnet50`
and the other constructors, conv and batch norm through cuDNN, channels-last
under `set_flags({"FLAGS_conv_channels_last": True})`) with any of the
eleven optimizers of `optimizer` (`Momentum`, `AdamW`, ...), its fifteen
schedulers, the three gradient clips, `GradScaler` and `TrainStep`, and
it serves GPT through the
static decode stack and the padded engine or the paged engine with the
prefix cache and its host spill tier, chunked prefill and speculative
decoding, with bf16 or weight-only int8 weights, and the serving ops
surface of `obs` (Prometheus /metrics, /healthz, /statusz, /tracez, /memz,
/probez, /profilez, SLO burn rates, golden-canary probes, invariant
audits, the flight recorder). Training carries the JAX step's telemetry:
`TrainStep(numerics=, monitor=, memz=, timeline=)`, `debugging` (the
numerics sentinels, anomaly detectors and replayable dumps),
`amp.debugging`, and `profiler` (the Paddle Profiler over
`torch.profiler`, trace analysis, the goodput timeline).
`incubate` holds the fused transformer layers
(`incubate.nn`) and the MoE layer (`incubate.distributed.models.moe`).

The JAX package `paddle_tpu` is the reference; this package imports
neither it nor JAX. Entry points run on CUDA unless the caller passes
``device="cpu"``.
"""
from .device import resolve_device
from .models.gpt import (GPTConfig, GPTForCausalLM,
                         GPTPretrainingCriterion, PRESETS, gpt_config)
from .models.bert import (BertConfig, BertForMaskedLM, BertForPretraining,
                          BertForSequenceClassification, BertModel,
                          bert_config)
from .models.vit import ViTConfig, VisionTransformer, vit_config
from .models.ernie import (ErnieConfig, ErnieForMaskedLM,
                           ErnieForSequenceClassification, ErnieModel,
                           ernie_config)
from . import incubate
from . import vision
from .vision.models import SwinTransformer, swin_b, swin_l, swin_s, swin_t
from .inference.kv_cache import BlockPool, HostSpillTier
from .inference.prefix_cache import PrefixCache
from .inference.serving import (Request, RequestTrace, ServingConfig,
                                ServingEngine, ServingMetrics,
                                model_draft_fn, repeated_traffic,
                                shared_prefix_traffic, synthetic_traffic)
from .amp import GradScaler
from .convert import (model_state_from_paddle, state_dict_from_paddle,
                      train_state_from_paddle)
from .core import get_flags, set_flags
from .jit import TrainStep
from . import amp, debugging, nn, obs, optimizer, profiler
from .nn import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .optimizer import (SGD, Adadelta, Adagrad, Adam, Adamax, AdamW,
                        DGCMomentum, Lamb, LarsMomentum, Momentum, RMSProp)
from .vision.models import (ResNet, resnet18, resnet34, resnet50, resnet101,
                            resnet152, resnext50_32x4d, resnext50_64x4d,
                            resnext101_32x4d, resnext101_64x4d,
                            resnext152_32x4d, resnext152_64x4d,
                            wide_resnet50_2, wide_resnet101_2)

__all__ = ["resolve_device", "GPTConfig", "GPTForCausalLM", "PRESETS",
           "gpt_config", "BlockPool", "HostSpillTier", "PrefixCache",
           "Request", "obs", "profiler", "debugging", "amp",
           "RequestTrace", "ServingConfig", "ServingEngine",
           "ServingMetrics", "model_draft_fn", "repeated_traffic",
           "shared_prefix_traffic", "synthetic_traffic",
           "state_dict_from_paddle", "train_state_from_paddle",
           "model_state_from_paddle", "BertConfig", "BertModel",
           "BertForMaskedLM", "BertForSequenceClassification",
           "BertForPretraining", "bert_config", "ViTConfig",
           "VisionTransformer", "vit_config", "vision", "SwinTransformer",
           "swin_t", "swin_s", "swin_b", "swin_l",
           "GPTPretrainingCriterion", "TrainStep", "Adam", "AdamW",
           "GradScaler", "ClipGradByGlobalNorm", "ClipGradByNorm",
           "ClipGradByValue", "SGD", "Momentum", "Adamax", "Adagrad",
           "Adadelta", "RMSProp", "Lamb", "LarsMomentum", "DGCMomentum",
           "set_flags", "get_flags", "nn", "optimizer", "ResNet", "resnet18",
           "resnet34", "resnet50", "resnet101", "resnet152",
           "resnext50_32x4d", "resnext50_64x4d", "resnext101_32x4d",
           "resnext101_64x4d", "resnext152_32x4d", "resnext152_64x4d",
           "wide_resnet50_2", "wide_resnet101_2", "ErnieConfig",
           "ErnieModel", "ErnieForSequenceClassification",
           "ErnieForMaskedLM", "ernie_config", "incubate"]
