"""Fused transformer layers (the port of
paddle_tpu/incubate/nn/fused_transformer.py): FusedMultiHeadAttention,
FusedFeedForward, FusedTransformerEncoderLayer, FusedMultiTransformer and
FusedEcMoe.

The layers keep the JAX package's raw parameters, names and shapes
(``qkv_weight [3, nh, hd, H]``, ``qkv_bias [3, nh, hd]``, ``linear_weight
[H, H]`` as ``[in, out]``, ``linear1_weight [d, ff]``, ...), so state dicts
line up and `convert.model_state_from_paddle` carries them across as they
are. Viewed as ``[3 * nh * hd, H]``, ``qkv_weight`` gives in one product
the packed ``[B, S, 3H]`` q|k|v rows that the fused short-sequence MHA
takes.

FusedMultiHeadAttention's attention takes one route of four, as in the
JAX layer:
  * no mask and no cache where `ops.fused_mha.use_fused_mha` holds: the
    fused MHA on the packed rows (kernel #9 on CUDA), attention dropout
    drawn inside the kernel from a seed the layer's generator draws;
  * a mask, or attention dropout off that route: the reference attention
    (`ops.attention.attention_reference`), its dropout mask drawn from the
    layer's generator;
  * otherwise `ops.attention.functional_attention` (flash attention, #6 on
    CUDA, where its gate holds); attention is bidirectional;
  * a cache: the growing ``(k, v)`` pair [B, S_past, nh, hd] (K/V
    appended, returns ``(out, (k, v))``), or a static cache, the 3-tuple
    ``(k_buf, v_buf, pos)`` or the int8 5-tuple ``(k_codes, k_scale,
    v_codes, v_scale, pos)``: fixed [B, L, nh, hd] buffers written in
    place at ``pos`` (`ops.attention.static_cache_update(_q8)`) and
    attended under `static_cache_mask`, returning ``(out, (..., pos +
    S))``. A static cache refuses dropout and a mask, and a 5-tuple
    whose codes are not int8.
Cross-attention (a `key` or `value` that is not the query) is refused.
LayerNorms are `functional._ln` and GELU the tanh form (``jax.nn.gelu``'s
default). In ``train()`` mode dropout masks come from each layer's
``dropout_generator``, so they agree with the JAX package's by statistics
only.

``device`` defaults to CUDA and raises without a card; the weights draw
from ``seed`` with the JAX package's initialisers (Xavier-uniform for the
projections, zero biases, unit LayerNorm scales). Layers start in
``train()`` mode, as Paddle layers do.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from ...device import resolve_device
from ...nn.initializer import xavier_uniform_
from ...ops.attention import (attention_q8_cache, attention_reference,
                              functional_attention, static_cache_mask,
                              static_cache_update, static_cache_update_q8)
from ...ops.fused_mha import fused_mha, use_fused_mha
from .functional import _drop, _ln

__all__ = ["FusedMultiHeadAttention", "FusedFeedForward",
           "FusedTransformerEncoderLayer", "FusedMultiTransformer",
           "FusedEcMoe"]

_ACTS = {"relu": F.relu,
         "gelu": functools.partial(F.gelu, approximate="tanh")}


class _Fused(nn.Module):
    """Device, raw parameters, init and the dropout generator shared by
    the fused layers."""

    def _setup(self, device, dtype, seed):
        self._kw = dict(device=resolve_device(device),
                        dtype=dtype or torch.float32)
        self._seed = seed
        self.dropout_generator = torch.Generator(
            device=self._kw["device"]).manual_seed(seed)

    def _param(self, shape, fill=None):
        t = torch.empty(shape, **self._kw)
        if fill is not None:
            t.fill_(fill)
        return nn.Parameter(t)

    def _init_xavier(self, *params):
        g = torch.Generator(device=self._kw["device"]).manual_seed(
            self._seed)
        for p in params:
            xavier_uniform_(p, g)


class FusedMultiHeadAttention(_Fused):
    """Self-attention block: (pre-LN,) the fused qkv projection, attention,
    the output projection, dropout, the residual (and post-LN). `kdim`,
    `vdim`, `need_weights` and `qkv_weight_attr` are accepted and unused,
    as in the JAX package."""

    def __init__(self, embed_dim, num_heads, dropout_rate=0.5,
                 attn_dropout_rate=0.5, kdim=None, vdim=None,
                 normalize_before=False, need_weights=False,
                 qkv_weight_attr=None, epsilon=1e-5, name=None, device=None,
                 dtype=None, seed: int = 0):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self._setup(device, dtype, seed)
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout_rate = dropout_rate
        self.attn_dropout_rate = attn_dropout_rate
        self.normalize_before = normalize_before
        self._epsilon = epsilon
        h = embed_dim
        self.qkv_weight = self._param((3, num_heads, self.head_dim, h))
        self.qkv_bias = self._param((3, num_heads, self.head_dim), 0.0)
        self.linear_weight = self._param((h, h))
        self.linear_bias = self._param((h,), 0.0)
        self.pre_ln_scale = self._param((h,), 1.0)
        self.pre_ln_bias = self._param((h,), 0.0)
        self.ln_scale = self._param((h,), 1.0)
        self.ln_bias = self._param((h,), 0.0)
        self._init_xavier(self.qkv_weight, self.linear_weight)

    def _head(self, x):
        """(residual, packed qkv [B, S, 3H]) after the optional pre-LN."""
        residual = x
        if self.normalize_before:
            x = _ln(x, self.pre_ln_scale, self.pre_ln_bias, self._epsilon)
        w = self.qkv_weight.reshape(3 * self.embed_dim, self.embed_dim)
        return residual, F.linear(x, w, self.qkv_bias.reshape(-1))

    def _split(self, qkv):
        b, s = qkv.shape[:2]
        a = qkv.reshape(b, s, 3, self.num_heads, self.head_dim)
        return a[:, :, 0], a[:, :, 1], a[:, :, 2]

    def _tail(self, o, residual, out_p=0.0):
        """The output projection, dropout, residual and optional post-LN."""
        o = o.reshape(o.shape[0], o.shape[1], self.embed_dim)
        o = o @ self.linear_weight + self.linear_bias
        o = residual + _drop(o, out_p, self.dropout_generator)
        if not self.normalize_before:
            o = _ln(o, self.ln_scale, self.ln_bias, self._epsilon)
        return o

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        """query [B, S, H]. Returns out [B, S, H], or (out, new cache)
        when `cache` is given (see the module docstring)."""
        if (key is not None and key is not query) or \
                (value is not None and value is not query):
            raise NotImplementedError(
                "FusedMultiHeadAttention computes self-attention from the "
                "fused qkv projection; cross-attention with a distinct key "
                "or value is not supported")
        attn_p = self.attn_dropout_rate if self.training else 0.0
        out_p = self.dropout_rate if self.training else 0.0
        mask = attn_mask
        if cache is not None and len(cache) in (3, 5):
            return self._static(query, mask, cache, attn_p, out_p)
        residual, qkv = self._head(query)
        q, k, v = self._split(qkv)
        b, s = q.shape[:2]
        nh, hd = self.num_heads, self.head_dim
        o = None
        if cache is not None:
            k = torch.cat([cache[0], k], dim=1)
            v = torch.cat([cache[1], v], dim=1)
        elif mask is None and use_fused_mha(s, nh, hd):
            seed = None
            if attn_p:
                seed = torch.randint(0, 2 ** 31 - 1, (1,),
                                     generator=self.dropout_generator,
                                     device=qkv.device, dtype=torch.int32)
            o = fused_mha(qkv, nh, dropout_p=attn_p, dropout_seed=seed)
        if o is None and (attn_p or mask is not None):
            o = attention_reference(q, k, v, mask=mask, dropout_p=attn_p,
                                    generator=self.dropout_generator)
        elif o is None:
            o = functional_attention(q, k, v)
        o = self._tail(o, residual, out_p)
        if cache is not None:
            return o, (k.detach(), v.detach())
        return o

    def _static(self, query, mask, cache, attn_p, out_p):
        """Static-cache decode: fixed buffers written in place at the
        cursor, a position mask, no dropout."""
        if attn_p or out_p:
            raise NotImplementedError(
                "static-cache decode is inference-only (no dropout): call "
                ".eval() or set dropout rates to 0, or use the growing "
                "(k, v) cache for cached training")
        if mask is not None:
            raise NotImplementedError(
                "static-cache decode builds its own position mask; combine "
                "custom masks on the growing-cache path")
        q8 = len(cache) == 5
        if q8 and cache[0].dtype != torch.int8:
            raise ValueError(f"5-tuple static CacheKV must carry int8 codes "
                             f"first (got {cache[0].dtype}); full-width "
                             f"caches are (k, v, pos)")
        residual, qkv = self._head(query)
        q, k, v = self._split(qkv)
        s, pos = q.shape[1], cache[-1]
        if q8:
            kc, ks, vc, vs = cache[:4]
            static_cache_update_q8(kc, ks, k, pos)
            static_cache_update_q8(vc, vs, v, pos)
            pmask = static_cache_mask(kc.shape[1], s, pos, device=q.device)
            o = attention_q8_cache(q, kc, ks, vc, vs, pmask)
            new = (kc, ks, vc, vs)
        else:
            kb, vb = cache[:2]
            static_cache_update(kb, k, pos)
            static_cache_update(vb, v, pos)
            pmask = static_cache_mask(kb.shape[1], s, pos, device=q.device)
            o = attention_reference(q, kb, vb, mask=pmask,
                                    score_dtype=q.dtype)
            new = (kb, vb)
        o = self._tail(o, residual)
        return o, tuple(t.detach() for t in new) + (pos + s,)


class FusedFeedForward(_Fused):
    """FFN block: (pre-LN,) linear1, activation ("relu" or the tanh
    "gelu"), activation dropout, linear2, dropout, the residual (and
    post-LN). `act_dropout_rate` defaults to `dropout_rate`."""

    def __init__(self, d_model, dim_feedforward, dropout_rate=0.1,
                 epsilon=1e-5, activation="relu", act_dropout_rate=None,
                 normalize_before=False, name=None, device=None, dtype=None,
                 seed: int = 0):
        super().__init__()
        self._setup(device, dtype, seed)
        self.d_model, self.dim_feedforward = d_model, dim_feedforward
        self.dropout_rate = dropout_rate
        self.act_dropout_rate = dropout_rate if act_dropout_rate is None \
            else act_dropout_rate
        self.normalize_before = normalize_before
        self._epsilon = epsilon
        self._act = _ACTS[activation]
        d, f = d_model, dim_feedforward
        self.linear1_weight = self._param((d, f))
        self.linear1_bias = self._param((f,), 0.0)
        self.linear2_weight = self._param((f, d))
        self.linear2_bias = self._param((d,), 0.0)
        self.ln1_scale = self._param((d,), 1.0)
        self.ln1_bias = self._param((d,), 0.0)
        self.ln2_scale = self._param((d,), 1.0)
        self.ln2_bias = self._param((d,), 0.0)
        self._init_xavier(self.linear1_weight, self.linear2_weight)

    def forward(self, src, cache=None):
        p_act = self.act_dropout_rate if self.training else 0.0
        p_out = self.dropout_rate if self.training else 0.0
        g, eps = self.dropout_generator, self._epsilon
        x = src
        if self.normalize_before:
            x = _ln(x, self.ln1_scale, self.ln1_bias, eps)
        h = _drop(self._act(x @ self.linear1_weight + self.linear1_bias),
                  p_act, g)
        y = src + _drop(h @ self.linear2_weight + self.linear2_bias, p_out,
                        g)
        if not self.normalize_before:
            y = _ln(y, self.ln2_scale, self.ln2_bias, eps)
        return y


class FusedTransformerEncoderLayer(nn.Module):
    """FusedMultiHeadAttention (``fused_attn``) then FusedFeedForward
    (``ffn``). `attn_dropout_rate` defaults to `dropout_rate`."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout_rate=0.1,
                 activation="relu", attn_dropout_rate=None,
                 act_dropout_rate=None, normalize_before=False, name=None,
                 device=None, dtype=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        ad = dropout_rate if attn_dropout_rate is None else attn_dropout_rate
        self.fused_attn = FusedMultiHeadAttention(
            d_model, nhead, dropout_rate=dropout_rate, attn_dropout_rate=ad,
            normalize_before=normalize_before, device=dev, dtype=dtype,
            seed=seed)
        self.ffn = FusedFeedForward(
            d_model, dim_feedforward, dropout_rate=dropout_rate,
            activation=activation, act_dropout_rate=act_dropout_rate,
            normalize_before=normalize_before, device=dev, dtype=dtype,
            seed=seed + 1)

    def forward(self, src, src_mask=None, cache=None):
        if cache is not None:
            o, new_cache = self.fused_attn(src, attn_mask=src_mask,
                                           cache=cache)
            return self.ffn(o), new_cache
        return self.ffn(self.fused_attn(src, attn_mask=src_mask))


class FusedMultiTransformer(nn.Module):
    """`num_layers` FusedTransformerEncoderLayers (``layer_{i}``), pre-LN
    and tanh GELU by default. `caches`: one cache per layer (growing or
    static, see FusedMultiHeadAttention); with them the call returns (out,
    new caches)."""

    def __init__(self, embed_dim, num_heads, dim_feedforward,
                 dropout_rate=0.0, activation="gelu", normalize_before=True,
                 num_layers=1, epsilon=1e-5, name=None, device=None,
                 dtype=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layer_{i}", FusedTransformerEncoderLayer(
                embed_dim, num_heads, dim_feedforward,
                dropout_rate=dropout_rate, activation=activation,
                attn_dropout_rate=dropout_rate,
                act_dropout_rate=dropout_rate,
                normalize_before=normalize_before, device=dev, dtype=dtype,
                seed=seed + 2 * i))

    @property
    def layers(self):
        return [getattr(self, f"layer_{i}") for i in range(self.num_layers)]

    def forward(self, src, attn_mask=None, caches=None):
        x = src
        if caches is not None:
            new_caches = []
            for layer, c in zip(self.layers, caches):
                x, nc = layer(x, src_mask=attn_mask, cache=c)
                new_caches.append(nc)
            return x, new_caches
        for layer in self.layers:
            x = layer(x, src_mask=attn_mask)
        return x


class FusedEcMoe(nn.Module):
    """Expert-computation MoE: a gshard `MoELayer` (``moe``) with the
    activation "relu" or the tanh "gelu"; `forward(x, gate_logits)` routes
    with router logits computed elsewhere when they are given.
    `weight_attr` and `bias_attr` are accepted and unused, as in the JAX
    package."""

    def __init__(self, hidden_size, inter_size, num_experts, act_type="gelu",
                 weight_attr=None, bias_attr=None, name=None, device=None,
                 dtype=None, seed: int = 0):
        super().__init__()
        from ..distributed.models.moe import MoELayer
        self.moe = MoELayer(hidden_size, inter_size, num_experts,
                            gate="gshard", activation=_ACTS[act_type],
                            device=resolve_device(device), dtype=dtype,
                            seed=seed)

    def forward(self, x, gate_logits=None):
        return self.moe(x, gate_logits=gate_logits)
