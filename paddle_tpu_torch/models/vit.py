"""Vision Transformer in PyTorch (the port of paddle_tpu/models/vit.py):
patch embedding, pre-LN encoder blocks, cls-token pooling and the
classification head.

Parameter names mirror the JAX package (``patch_embed.weight``
``[hidden, C, p, p]``, ``cls_token``, ``pos_embed``,
``blocks.{i}.qkv.weight``, ``head.weight``, ...), so
`paddle_tpu_torch.convert.model_state_from_paddle` maps a JAX state dict
across by name (the projections transposed to ``nn.Linear``'s ``[out,
in]``, the conv weight as it is). The patch embedding is the strided
conv's weight used as one matmul over space-to-depth patches, as the JAX
model computes it (`_patchify_matmul`). Attention goes through the fused
short-sequence MHA on the packed projection output (`ops.fused_mha`,
kernel #9 on CUDA) where its gate holds (ViT's S = 197 at 224^2 / 16),
else the reference attention with bf16-stored scores in a bf16 model.
Hidden dropout (after the embeddings and the MLP, train() mode only)
draws its masks from the model's ``dropout_generator``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..ops.attention import functional_attention
from ..nn.layers import LayerNorm
from ..ops.fused_mha import fused_mha, use_fused_mha
from .bert import _Dropout

__all__ = ["ViTConfig", "VisionTransformer", "vit_config", "PRESETS"]


@dataclass
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    num_channels: int = 3
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: Optional[int] = None
    hidden_dropout: float = 0.0
    layer_norm_epsilon: float = 1e-6
    initializer_range: float = 0.02
    num_classes: int = 1000
    param_dtype: str = "float32"

    def __post_init__(self):
        if self.intermediate_size is None:
            self.intermediate_size = 4 * self.hidden_size
        if self.image_size % self.patch_size:
            raise ValueError(f"image_size {self.image_size} is not a "
                             f"multiple of patch_size {self.patch_size}")

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads

    @property
    def num_patches(self):
        return (self.image_size // self.patch_size) ** 2


PRESETS = {
    "vit-b16": dict(hidden_size=768, num_layers=12, num_heads=12),
    "vit-l16": dict(hidden_size=1024, num_layers=24, num_heads=16),
    "vit-h14": dict(hidden_size=1280, num_layers=32, num_heads=16,
                    patch_size=14),
}


def vit_config(preset: str, **overrides) -> ViTConfig:
    cfg = dict(PRESETS[preset])
    cfg.update(overrides)
    return ViTConfig(**cfg)


class ViTBlock(nn.Module):
    """Pre-LN block."""

    def __init__(self, config: ViTConfig, device=None, dtype=None):
        super().__init__()
        h, m, eps = (config.hidden_size, config.intermediate_size,
                     config.layer_norm_epsilon)
        kw = dict(device=device, dtype=dtype)
        self.num_heads = config.num_heads
        self.head_dim = config.head_dim
        self.ln_1 = LayerNorm(h, eps=eps, **kw)
        self.qkv = nn.Linear(h, 3 * h, **kw)
        self.out = nn.Linear(h, h, **kw)
        self.ln_2 = LayerNorm(h, eps=eps, **kw)
        self.up = nn.Linear(h, m, **kw)
        self.down = nn.Linear(m, h, **kw)

    def forward(self, x, drop=None):
        nh, hd = self.num_heads, self.head_dim
        qkv = self.qkv(self.ln_1(x))
        b, s = qkv.shape[0], qkv.shape[1]
        if use_fused_mha(s, nh, hd):
            ctx = fused_mha(qkv, nh)
        else:
            a = qkv.reshape(b, s, 3, nh, hd)
            q, k, v = a[:, :, 0], a[:, :, 1], a[:, :, 2]
            ctx = functional_attention(q, k, v, is_causal=False,
                                       score_dtype=q.dtype)
            ctx = ctx.reshape(b, s, nh * hd)
        x = x + self.out(ctx)
        y = self.down(F.gelu(self.up(self.ln_2(x)), approximate="tanh"))
        if drop is not None:
            y = drop(y)
        return x + y


def _patchify_matmul(img, w, bias, p):
    """[B, C, H, W] -> [B, N, hidden]: space-to-depth, then one product
    with the conv weight [hidden, C, p, p] flattened; exactly the stride-p
    conv (partial trailing patches are floored away like it)."""
    B, C, H, W = img.shape
    gh, gw = H // p, W // p
    img = img[:, :, :gh * p, :gw * p]
    x = img.reshape(B, C, gh, p, gw, p).permute(0, 2, 4, 1, 3, 5)
    x = x.reshape(B, gh * gw, C * p * p)
    out = x @ w.reshape(w.shape[0], -1).t()
    return out if bias is None else out + bias


class VisionTransformer(nn.Module):
    """ViT backbone + classification head (cls-token pooling).
    ``device`` defaults to CUDA and raises when no card is present; pass
    ``device="cpu"`` for the plain PyTorch path. Weights and dropout draw
    from ``seed`` (the JAX package's init: uniform(+-1/sqrt(fan_in)) for
    the patch conv, truncated Normal(0.02) for the cls token and the
    position table, Normal(initializer_range) for qkv/up, the same over
    sqrt(2 * num_layers) for out/down, Xavier-uniform for the head, zero
    biases, unit LayerNorm gains). The model starts in eval() mode."""

    def __init__(self, config: ViTConfig, device=None, dtype=None,
                 seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        dtype = dtype or getattr(torch, config.param_dtype)
        kw = dict(device=dev, dtype=dtype)
        self.config = config
        h = config.hidden_size
        self.patch_embed = nn.Conv2d(config.num_channels, h,
                                     config.patch_size,
                                     stride=config.patch_size, **kw)
        self.cls_token = nn.Parameter(torch.empty(1, 1, h, **kw))
        self.pos_embed = nn.Parameter(
            torch.empty(1, config.num_patches + 1, h, **kw))
        self.blocks = nn.ModuleList([ViTBlock(config, **kw)
                                     for _ in range(config.num_layers)])
        self.ln = LayerNorm(h, eps=config.layer_norm_epsilon, **kw)
        if config.num_classes > 0:
            self.head = nn.Linear(h, config.num_classes, **kw)
        self.dropout_generator = torch.Generator(device=dev)
        self.reset_parameters(torch.Generator(device=dev).manual_seed(seed))
        self.dropout_generator.manual_seed(seed)
        self.eval()

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        cfg = self.config
        std = cfg.initializer_range
        deep = std / math.sqrt(2 * cfg.num_layers)
        fan_in = cfg.num_channels * cfg.patch_size ** 2
        for name, p in self.named_parameters():
            if name.startswith("patch_embed."):
                b = 1.0 / math.sqrt(fan_in)
                p.uniform_(-b, b, generator=generator)
            elif name in ("cls_token", "pos_embed"):
                nn.init.trunc_normal_(p, std=0.02, a=-0.04, b=0.04,
                                      generator=generator)
            elif name.endswith(".bias"):
                p.zero_()
            elif ".ln_" in name or name.startswith("ln."):
                p.fill_(1.0)
            elif name.endswith(("out.weight", "down.weight")):
                p.normal_(0.0, deep, generator=generator)
            elif name.endswith(("qkv.weight", "up.weight")):
                p.normal_(0.0, std, generator=generator)
            else:
                fan_out, fan_in_ = p.shape
                bound = math.sqrt(6.0 / (fan_in_ + fan_out))
                p.uniform_(-bound, bound, generator=generator)

    def forward(self, pixel_values):
        p = self.config.patch_size
        pe = self.patch_embed
        x = _patchify_matmul(pixel_values.to(pe.weight.dtype), pe.weight,
                             pe.bias, p)
        b, h = x.shape[0], x.shape[2]
        x = torch.cat([self.cls_token.expand(b, 1, h), x], dim=1) \
            + self.pos_embed
        drop = _Dropout(self.dropout_generator, self.config.hidden_dropout) \
            if self.training and self.config.hidden_dropout else None
        if drop is not None:
            x = drop(x)
        for blk in self.blocks:
            x = blk(x, drop)
        x = self.ln(x)
        if self.config.num_classes > 0:
            return self.head(x[:, 0])
        return x
