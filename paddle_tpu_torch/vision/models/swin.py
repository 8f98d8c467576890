"""Swin Transformer in PyTorch (the port of
paddle_tpu/vision/models/swin.py): patch embedding, four stages of window
attention blocks (every second one on shifted windows) with patch merging
between them, mean pooling and the classification head.

Parameter names mirror the JAX package (``patch_embed.weight`` ``[C, 3,
p, p]``, ``stages.{i}.{j}.attn.qkv.weight``,
``stages.{i}.{j}.attn.rel_bias_table`` ``[(2ws - 1)^2, nh]``,
``merges.{i}.reduction.weight``, ``patch_norm.*``, ``norm.*``,
``head.*``), so `paddle_tpu_torch.convert.model_state_from_paddle` maps a
JAX state dict across by name (the projections transposed to
``nn.Linear``'s ``[out, in]``; the table and the conv weight as they are).

Window attention goes through the fused MHA with a periodic bias
(`ops.fused_mha_bias`, kernel #10 on CUDA) wherever the JAX package takes
its fused route: W_g windows (8, 4 or 2, the largest the gate admits) are
grouped into one sequence of S = W_g * ws^2 tokens whose additive bias is
block-diagonal (-1e9 between windows) plus the tiled relative-position
table plus the static shifted-window masks, periodic over the batch with
period R = nW / W_g (a window covering the whole map groups images). The
static part of that bias is built once per (W_g, R) and kept on the
device. Without a group size the gate admits, or with attention dropout,
attention takes the reference route: per window, the table and the mask
folded into one additive mask, scores stored in the model's dtype.

The JAX package's ``FLAGS_conv_channels_last`` (an NHWC patch-embed conv,
a TPU layout choice) has no counterpart: the patch embedding is the conv
weight used as one product over space-to-depth patches, as the ViT port
computes it. Hidden dropout (after the attention projection and after the
MLP, train() mode only) draws from the model's ``dropout_generator``.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...device import resolve_device
from ...models.bert import _Dropout
from ...models.vit import _patchify_matmul
from ...nn.layers import LayerNorm
from ...ops import fused_mha_bias as FMB
from ...ops.attention import attention_reference

__all__ = ["SwinTransformer", "swin_t", "swin_s", "swin_b", "swin_l"]


def _rel_pos_index(ws: int) -> np.ndarray:
    """Static [ws*ws, ws*ws] index into the (2ws-1)^2 relative-bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij"))              # [2, ws, ws]
    flat = coords.reshape(2, -1)                               # [2, N]
    rel = flat[:, :, None] - flat[:, None, :]                  # [2, N, N]
    rel = rel.transpose(1, 2, 0) + (ws - 1)                    # [N, N, 2]
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).astype(np.int32)


def _shift_mask(H: int, W: int, ws: int, shift: int) -> np.ndarray:
    """Static additive mask [nW, N, N] forbidding attention across the
    wrap-around seam of a shifted window partition."""
    img = np.zeros((H, W), np.int32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wsl] = cnt
            cnt += 1
    win = img.reshape(H // ws, ws, W // ws, ws).transpose(0, 2, 1, 3)
    win = win.reshape(-1, ws * ws)                             # [nW, N]
    diff = win[:, :, None] != win[:, None, :]
    return np.where(diff, -1e9, 0.0).astype(np.float32)


class WindowAttention(nn.Module):
    """Multi-head attention inside ws x ws windows with a learned relative
    position bias (one table per block, indexed by the static table)."""

    def __init__(self, dim: int, num_heads: int, window_size: int,
                 attn_drop: float = 0.0, proj_drop: float = 0.0,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.dim, self.num_heads, self.ws = dim, num_heads, window_size
        self.head_dim = dim // num_heads
        self.scale = self.head_dim ** -0.5
        self.qkv = nn.Linear(dim, 3 * dim, **kw)
        self.proj = nn.Linear(dim, dim, **kw)
        self.attn_drop, self.proj_drop = attn_drop, proj_drop
        n_rel = (2 * window_size - 1) ** 2
        self.rel_bias_table = nn.Parameter(torch.empty(n_rel, num_heads,
                                                       **kw))
        self.register_buffer(
            "rel_index", torch.from_numpy(
                _rel_pos_index(window_size).reshape(-1).astype(np.int64)
            ).to(device), persistent=False)
        self._bias_static_cache = None

    def _bias_plan(self, bnw, n_windows, mask, device):
        """Static plan for window-batched fused attention: group W_g
        windows into one length W_g * N sequence with a block-diagonal
        additive bias (periodic over the batch with period R = nW / W_g).
        Returns (W_g, static bias [R, S, S] f32 on `device`) or None."""
        nW = n_windows if n_windows else (mask.shape[0]
                                          if mask is not None else 1)
        n = self.ws * self.ws
        divisor_of = nW if nW > 1 else bnw
        # group sizes largest first: a candidate the gate refuses can still
        # admit a smaller one (stage 4 of swin-t refuses 8 and takes 4)
        wg = next((w for w in (8, 4, 2)
                   if divisor_of % w == 0
                   and FMB.use_fused_mha_bias(w * n, self.num_heads,
                                              self.head_dim)), 1)
        if wg == 1:
            return None
        r_n = max(1, nW // wg)
        key = (wg, r_n, torch.device(device))
        cached = self._bias_static_cache
        if cached is not None and cached[0] == key:
            return wg, cached[1]
        s = wg * n
        static = np.full((r_n, s, s), -1e9, np.float32)
        for r in range(r_n):
            for w in range(wg):
                blk = (mask[r * wg + w] if (mask is not None and nW > 1)
                       else 0.0)
                static[r, w * n:(w + 1) * n, w * n:(w + 1) * n] = blk
        static = torch.from_numpy(static).to(device)
        self._bias_static_cache = (key, static)
        return wg, static

    def _rel_bias(self):
        """[nh, N, N] f32: the table gathered by the static index."""
        n, nh = self.ws * self.ws, self.num_heads
        rel = self.rel_bias_table[self.rel_index].reshape(n, n, nh)
        return rel.permute(2, 0, 1).float()

    def forward(self, xw, mask: np.ndarray | None, n_windows: int = 0,
                generator=None):
        """xw: [B*nW, N, C]; mask: static numpy [nW, N, N] or None;
        generator: the dropout stream (train() mode only)."""
        nh, hd, scale = self.num_heads, self.head_dim, self.scale
        n = self.ws * self.ws
        bnw = xw.shape[0]
        qkv = self.qkv(xw)                                     # [BnW, N, 3C]
        p_drop = self.attn_drop if self.training else 0.0
        plan = (self._bias_plan(bnw, n_windows, mask, xw.device)
                if p_drop == 0.0 else None)
        if plan is not None:
            wg, static = plan
            tiled = self._rel_bias().repeat(1, wg, wg)         # [nh, S, S]
            bias = static[:, None] + tiled[None]               # [R, nh, S, S]
            ag = qkv.reshape(bnw // wg, wg * n, qkv.shape[-1])
            ctx = FMB.fused_mha_bias(ag, nh, bias, scale=scale)
            ctx = ctx.reshape(bnw, n, nh * hd)
        else:
            a = qkv.reshape(bnw, n, 3, nh, hd)
            q, k, v = a[:, :, 0], a[:, :, 1], a[:, :, 2]
            # the relative-position bias (+ the shift mask) fold into one
            # additive mask; scores are stored in the model's dtype
            add = self._rel_bias()[None]                       # [1, nh, N, N]
            if mask is not None:
                nw = mask.shape[0]
                m = torch.from_numpy(mask).to(xw.device)[:, None]
                add = (add + m)[None].expand(bnw // nw, nw, nh, n, n)
                add = add.reshape(bnw, nh, n, n)
            ctx = attention_reference(q, k, v, mask=add, scale=scale,
                                      score_dtype=a.dtype, dropout_p=p_drop,
                                      generator=generator)
            ctx = ctx.reshape(bnw, n, nh * hd)
        out = self.proj(ctx)
        if self.training and self.proj_drop:
            out = _Dropout(generator, self.proj_drop)(out)
        return out


class SwinBlock(nn.Module):
    def __init__(self, dim, input_resolution, num_heads, window_size=7,
                 shift_size=0, mlp_ratio=4.0, dropout=0.0, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.dim = dim
        self.H, self.W = input_resolution
        self.ws = min(window_size, self.H, self.W)
        # a window covering the whole map needs no shifted pass
        self.shift = 0 if self.ws >= min(self.H, self.W) else shift_size
        self.norm1 = LayerNorm(dim, eps=1e-5, **kw)
        self.attn = WindowAttention(dim, num_heads, self.ws,
                                    proj_drop=dropout, **kw)
        self.norm2 = LayerNorm(dim, eps=1e-5, **kw)
        hidden = int(dim * mlp_ratio)
        self.fc1 = nn.Linear(dim, hidden, **kw)
        self.fc2 = nn.Linear(hidden, dim, **kw)
        self.dropout = dropout
        self._mask = (_shift_mask(self.H, self.W, self.ws, self.shift)
                      if self.shift > 0 else None)

    def _windows(self, x):
        """[B, H*W, C] -> [B*nW, ws*ws, C] (with the cyclic shift)."""
        H, W, ws, shift, dim = self.H, self.W, self.ws, self.shift, self.dim
        v = x.reshape(-1, H, W, dim)
        if shift:
            v = torch.roll(v, (-shift, -shift), dims=(1, 2))
        v = v.reshape(-1, H // ws, ws, W // ws, ws, dim)
        return v.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, dim)

    def _unwindows(self, xw):
        H, W, ws, shift, dim = self.H, self.W, self.ws, self.shift, self.dim
        v = xw.reshape(-1, H // ws, W // ws, ws, ws, dim)
        v = v.permute(0, 1, 3, 2, 4, 5).reshape(-1, H, W, dim)
        if shift:
            v = torch.roll(v, (shift, shift), dims=(1, 2))
        return v.reshape(-1, H * W, dim)

    def forward(self, x, generator=None):
        shortcut = x
        xw = self._windows(self.norm1(x))
        aw = self.attn(xw, self._mask,
                       n_windows=(self.H // self.ws) * (self.W // self.ws),
                       generator=generator)
        x = shortcut + self._unwindows(aw)
        y = self.fc2(F.gelu(self.fc1(self.norm2(x)), approximate="tanh"))
        if self.training and self.dropout:
            y = _Dropout(generator, self.dropout)(y)
        return x + y


class PatchMerging(nn.Module):
    """Downsample 2x: concat 2x2 neighbours -> LN -> Linear(4C, 2C)."""

    def __init__(self, input_resolution, dim, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.H, self.W = input_resolution
        self.dim = dim
        self.norm = LayerNorm(4 * dim, eps=1e-5, **kw)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False, **kw)

    def forward(self, x):
        H, W, dim = self.H, self.W, self.dim
        v = x.reshape(-1, H // 2, 2, W // 2, 2, dim)
        v = v.permute(0, 1, 3, 2, 4, 5).reshape(-1, (H // 2) * (W // 2),
                                                4 * dim)
        return self.reduction(self.norm(v))


class SwinTransformer(nn.Module):
    """Hierarchical windowed transformer; stages with patch merging between
    them. ``device`` defaults to CUDA and raises when no card is present;
    pass ``device="cpu"`` for the plain PyTorch path. Weights draw from
    ``seed`` with the JAX package's distributions (Xavier-uniform Linear
    weights, zero Linear biases, uniform(+-1/sqrt(fan_in)) for the patch
    conv's weight and bias, truncated Normal(0.02) for the relative-bias
    tables, unit LayerNorm gains); hidden dropout draws from
    ``dropout_generator``, seeded from ``seed`` too. The model starts in
    eval() mode."""

    def __init__(self, image_size=224, patch_size=4, num_channels=3,
                 embed_dim=96, depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window_size=7,
                 mlp_ratio=4.0, dropout=0.0, num_classes=1000, device=None,
                 dtype=None, seed: int = 0):
        super().__init__()
        if image_size % patch_size:
            raise ValueError(f"image_size {image_size} is not a multiple of "
                             f"patch_size {patch_size}")
        # every stage's feature map must tile into windows (no padding
        # path), and every map before a merge must halve evenly
        res_check = image_size // patch_size
        for i in range(len(depths)):
            ws_eff = min(window_size, res_check)
            if res_check % ws_eff:
                raise ValueError(
                    f"stage {i}: feature map {res_check}x{res_check} is not "
                    f"divisible by window_size {ws_eff} — choose image_size/"
                    f"patch_size/window_size so every stage tiles exactly "
                    f"(e.g. 224/4/7 or 256/4/8)")
            if i < len(depths) - 1 and res_check % 2:
                raise ValueError(
                    f"stage {i}: feature map {res_check}x{res_check} is odd "
                    f"and cannot be merged 2x2 into stage {i + 1}")
            res_check //= 2
        dev = resolve_device(device)
        dtype = dtype or torch.float32
        kw = dict(device=dev, dtype=dtype)
        self.embed_dim, self.patch_size = embed_dim, patch_size
        self.num_channels = num_channels
        self.num_classes = num_classes
        self.patch_embed = nn.Conv2d(num_channels, embed_dim, patch_size,
                                     stride=patch_size, **kw)
        self.patch_norm = LayerNorm(embed_dim, eps=1e-5, **kw)
        res = image_size // patch_size
        self.stages = nn.ModuleList()
        self.merges = nn.ModuleList()
        dim = embed_dim
        for i, (depth, heads) in enumerate(zip(depths, num_heads)):
            self.stages.append(nn.ModuleList([
                SwinBlock(dim, (res, res), heads, window_size,
                          shift_size=0 if j % 2 == 0 else window_size // 2,
                          mlp_ratio=mlp_ratio, dropout=dropout, **kw)
                for j in range(depth)]))
            if i < len(depths) - 1:
                self.merges.append(PatchMerging((res, res), dim, **kw))
                dim *= 2
                res //= 2
        self.norm = LayerNorm(dim, eps=1e-5, **kw)
        if num_classes > 0:
            self.head = nn.Linear(dim, num_classes, **kw)
        self.dropout_generator = torch.Generator(device=dev)
        self.reset_parameters(torch.Generator(device=dev).manual_seed(seed))
        self.dropout_generator.manual_seed(seed)
        self.eval()

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        fan_in = self.num_channels * self.patch_size ** 2
        gains = {f"{m}.weight" for m, mod in self.named_modules()
                 if isinstance(mod, nn.LayerNorm)}
        for name, p in self.named_parameters():
            if name.startswith("patch_embed."):
                b = 1.0 / math.sqrt(fan_in)
                p.uniform_(-b, b, generator=generator)
            elif name.endswith("rel_bias_table"):
                nn.init.trunc_normal_(p, std=0.02, a=-0.04, b=0.04,
                                      generator=generator)
            elif p.dim() == 1:
                p.fill_(1.0 if name in gains else 0.0)
            else:
                fan_out, fan_in_ = p.shape
                bound = math.sqrt(6.0 / (fan_in_ + fan_out))
                p.uniform_(-bound, bound, generator=generator)

    def forward(self, pixel_values):
        pe = self.patch_embed
        x = _patchify_matmul(pixel_values.to(pe.weight.dtype), pe.weight,
                             pe.bias, self.patch_size)         # [B, hw, C]
        x = self.patch_norm(x)
        gen = self.dropout_generator if self.training else None
        for i, blocks in enumerate(self.stages):
            for blk in blocks:
                x = blk(x, gen)
            if i < len(self.merges):
                x = self.merges[i](x)
        x = self.norm(x).mean(dim=1)                           # global pool
        if self.num_classes > 0:
            return self.head(x)
        return x


def _preset(embed_dim, depths, num_heads, pretrained, kw):
    if pretrained:
        raise ValueError("pretrained Swin weights are not shipped; build "
                         "with pretrained=False and load a state dict")
    return SwinTransformer(embed_dim=embed_dim, depths=depths,
                           num_heads=num_heads, **kw)


def swin_t(pretrained=False, **kw):
    return _preset(96, (2, 2, 6, 2), (3, 6, 12, 24), pretrained, kw)


def swin_s(pretrained=False, **kw):
    return _preset(96, (2, 2, 18, 2), (3, 6, 12, 24), pretrained, kw)


def swin_b(pretrained=False, **kw):
    return _preset(128, (2, 2, 18, 2), (4, 8, 16, 32), pretrained, kw)


def swin_l(pretrained=False, **kw):
    return _preset(192, (2, 2, 18, 2), (6, 12, 24, 48), pretrained, kw)
