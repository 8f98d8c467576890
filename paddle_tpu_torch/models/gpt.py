"""GPT in PyTorch (the port of paddle_tpu/models/gpt.py's config, forward,
training loss, static-cache decode stack and paged-pool serving entry
points).

Module and parameter names mirror the JAX package (``gpt.wte.weight``,
``gpt.h.{i}.attn.qkv.weight``, ...), so `paddle_tpu_torch.convert` maps a
JAX state dict across by name. The projections, wte and an untied LM head
are the port's mpu layers (`distributed.mpu`), which store Linear weights
``[out, in]`` (the transpose of the JAX ``[in, out]`` layout). Without a
mesh, or with one rank on its ``mp`` axis, they are exactly nn.Linear /
nn.Embedding. Built under a mesh with ``mp`` > 1 (`distributed.set_mesh`,
`fleet.init`), the model is this rank's tensor-parallel shard: qkv and
mlp.up split their out features (qkv head by head within each of q, k and
v), attn.out and mlp.down their in features, wte (and the LM head) its
vocabulary rows; attention runs #6 over the rank's num_heads / mp heads
and `loss` the vocab-parallel route of #11. Weights drawn from a seed are
the single-device model's, cut into shards. Such a model trains (`loss`,
the cache-free `forward`, whose logits are gathered) and serves: every
call with pools or caches reads wte (and an untied head) from a
replicated table gathered once (`gather_serving_tables`, which the
sharded `ServingEngine` calls), so the embedding needs no all-reduce and
the logits are whole on every rank; the rank's heads attend its own
pools, and a forward communicates exactly the two row-parallel
all-reduces of each layer (attn.out, mlp.down). Weight-only int8 on a
shard quantizes each row as the single-device model does: the
row-parallel weights' row absmax is a max over the mp group, so every
rank's codes are the single-device codes, cut. The LM head is tied to
wte.

Training: the cache-free forward attends through
`ops.attention.functional_attention` (flash attention, kernel #6 on CUDA)
or, under the opt-in PADDLE_TPU_FLASH_PACKED=1 with head_dim 128 and S %
128 == 0, through packed flash attention on the qkv projection itself
(kernel #7 on CUDA, one d(qkv) in the backward); every LayerNorm routes
through `nn.layers.LayerNorm` (the fused LayerNorm, kernel #8, under
PADDLE_TPU_FUSED_LN=1). `GPTForCausalLM.loss` feeds the hidden states
straight into the fused LM-head cross-entropy (kernel #11 on CUDA), and in
`train()` mode `hidden_dropout` drops after the embedding sum, after
attn.out and after mlp.down with masks drawn from the model's
`dropout_generator`. With `use_recompute`, each block's activations are
recomputed in the backward under `recompute_policy`
(`distributed.recompute`). Serving (any call with pools or caches) never
drops and never recomputes.

Serving state is explicit and updated IN PLACE (this replaces JAX buffer
donation); the JAX ``lax.scan`` over decode steps is a Python loop:
  paged    every layer owns one entry of ``pools`` (the per-layer (k, v)
           or int8 (k_codes, k_scale, v_codes, v_scale) tensors from
           `inference.kv_cache.BlockPool.make_pools`);
  static   every layer owns one entry of ``caches``: fixed [B, L, H, D]
           buffers and a row cursor, (k, v, pos[, (lens, cap)]) or int8
           (k_codes, k_scale, v_codes, v_scale, pos[, (lens, cap)]); a
           growing (k, v) pair serves `generate`.
Under ``weight_dtype="int8"`` every projection and the LM head run the
weight-only int8 GEMM (`ops.int8_matmul`) on a payload quantized once per
set of weights (`quantized_params`), passed down as ``q8``.

Mixture of experts: with ``moe_num_experts`` > 0 every n-th block's MLP is
an `incubate.distributed.models.moe.MoELayer` (router, dispatch, batched
expert matmuls and combine in plain PyTorch: the JAX package has no Pallas
kernel there). The cache-free forward sums the MoE blocks' load-balance
losses into ``GPTModel.last_aux_loss``, which `loss` adds with weight
``moe_aux_weight``. Serving runs the same layer; its capacity counts each
step's b * s tokens, padded rows included, so decode can drop tokens as in
the JAX package. Experts and router stay in the model dtype under
``weight_dtype="int8"``.
"""
from __future__ import annotations

import functools
import math
import os
import secrets
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..ops.attention import (attention_q8_cache, attention_reference,
                             functional_attention,
                             paged_attention, paged_attention_q8,
                             paged_cache_write, paged_cache_write_q8,
                             paged_prefill_mask, paged_prefill_write,
                             paged_prefill_write_q8, paged_prefix_attention,
                             paged_prefix_attention_q8, quantize_kv,
                             static_cache_mask, static_cache_update,
                             static_cache_update_q8)
from ..distributed.mesh import loss_group, mesh_axis_size
from ..distributed.collective import ReduceOp, all_gather, all_reduce
from ..distributed.mpu import (ColumnParallelLinear, RowParallelLinear,
                               VocabParallelEmbedding, _c_concat,
                               _c_identity, _mp_allreduce,
                               get_rng_state_tracker, replicated_seed,
                               resolve_mp_group, shard_of)
from ..distributed.recompute import (TAGS, checkpoint_segment,
                                     checkpoint_tag, recompute,
                                     resolve_policy)
from ..incubate.distributed.models.moe import MoELayer
from ..incubate.nn.functional import _drop, fused_linear_cross_entropy
from ..nn.initializer import xavier_uniform_
from ..nn.layers import LayerNorm
from ..ops.flash_attention import flash_attention_packed_qkv
from ..ops.int8_matmul import int8_linear_nd
from ..ops.linear_ce import _mm_f32


@dataclass
class GPTConfig:
    """The fields of the JAX GPTConfig. With `moe_num_experts` > 0 every
    `moe_every_n_layers`-th block (layer_idx % n == n - 1) is an MoE
    block: its MLP is a routed-expert `MoELayer` (`moe_gate`,
    `moe_top_k`, `moe_capacity_factor`), and `loss` adds `moe_aux_weight`
    times the blocks' summed load-balance loss. `sequence_parallel` is
    accepted only at its default: the port has no sequence-parallel mesh.
    Under a mesh, `num_heads` and `vocab_size` must divide by its ``mp``
    degree (`check_mp`).
    `use_recompute`
    recomputes each block in train() mode under `recompute_policy` (None,
    "save_qkv", "save_attn", "save_big" or "dots"; see
    `distributed.recompute`). `attention_dropout` is accepted and, as in
    the JAX GPT, unused."""
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: Optional[int] = None
    max_position_embeddings: int = 1024
    hidden_dropout: float = 0.0          # train() mode, cache-free only
    attention_dropout: float = 0.0
    layer_norm_epsilon: float = 1e-5
    initializer_range: float = 0.02
    tie_word_embeddings: bool = True
    param_dtype: str = "float32"
    use_recompute: bool = False
    recompute_policy: Optional[str] = None
    moe_num_experts: int = 0
    moe_every_n_layers: int = 2
    moe_gate: str = "gshard"
    moe_top_k: Optional[int] = None
    moe_aux_weight: float = 0.01
    moe_capacity_factor: float = 1.25
    sequence_parallel: str = "ring"

    def __post_init__(self):
        if self.intermediate_size is None:
            self.intermediate_size = 4 * self.hidden_size
        if self.hidden_size % self.num_heads != 0:
            raise ValueError(f"hidden_size {self.hidden_size} is not a "
                             f"multiple of num_heads {self.num_heads}")
        resolve_policy(self.recompute_policy)
        if self.sequence_parallel != "ring":
            raise NotImplementedError(
                f"GPTConfig.sequence_parallel={self.sequence_parallel!r}: "
                f"sequence parallelism is a later multi-GPU slice "
                f"(ROADMAP.md, queue item A4)")
        self.check_mp(mesh_axis_size("mp"))
        if self.moe_num_experts:
            if self.moe_gate not in ("naive", "gshard", "switch"):
                raise ValueError(f"unknown moe_gate {self.moe_gate!r}")
            if self.moe_gate == "switch" and self.moe_top_k not in (None, 1):
                raise ValueError("switch gate is top-1 by definition")

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads

    def check_mp(self, mp: int):
        """Raise unless the heads and the vocabulary split over `mp`."""
        for what in ("num_heads", "vocab_size"):
            if getattr(self, what) % mp:
                raise ValueError(f"GPTConfig.{what}={getattr(self, what)} "
                                 f"does not divide by the mesh's mp degree "
                                 f"{mp}")


PRESETS = {
    "gpt3-125m": dict(hidden_size=768, num_layers=12, num_heads=12),
    "gpt3-350m": dict(hidden_size=1024, num_layers=24, num_heads=16),
    "gpt3-1.3b": dict(hidden_size=2048, num_layers=24, num_heads=16),
    "gpt3-2.7b": dict(hidden_size=2560, num_layers=32, num_heads=32),
    "gpt3-6.7b": dict(hidden_size=4096, num_layers=32, num_heads=32),
    "gpt3-13b": dict(hidden_size=5120, num_layers=40, num_heads=40),
}


def gpt_config(preset: str, **overrides) -> GPTConfig:
    cfg = dict(PRESETS[preset])
    cfg.update(overrides)
    return GPTConfig(**cfg)


class GPTSelfAttention(nn.Module):
    """Fused-QKV attention; the qkv output columns keep the JAX package's
    ``[3, num_heads, head_dim]`` order (under ``mp`` > 1, this rank's
    heads of each of q, k and v: ``num_heads`` is the rank's count)."""

    def __init__(self, config: GPTConfig, device=None, dtype=None):
        super().__init__()
        h = config.hidden_size
        self.num_heads = config.num_heads // mesh_axis_size("mp")
        self.head_dim = config.head_dim
        self.qkv = ColumnParallelLinear(h, 3 * h, gather_output=False,
                                        groups=3, device=device, dtype=dtype)
        self.out = RowParallelLinear(h, h, input_is_parallel=True,
                                     device=device, dtype=dtype)

    def forward(self, x, pools=None, tables=None, lens=None,
                prefill=False, start=None, cache=None, q8=None, drop=None):
        """Without `pools` or `cache`: causal self-attention over x (the
        cache-free forward, through `functional_attention`); `drop`, when
        given, is applied to the output projection. With `cache` (this layer's static or growing
        KV cache), returns (out, new cache):
          (k, v, pos[, (lens, cap)])   fixed buffers [B, L, H, D]: x's
                         K/V are written at rows pos.. in place and x
                         attends the whole buffer under static_cache_mask
                         (ragged form: columns in [lens[b], cap) of row b
                         are padding and masked);
          (k_codes, k_scale, v_codes, v_scale, pos[, (lens, cap)])
                         the int8 form: K/V quantize as they are written,
                         attention_q8_cache reads the codes;
          (k, v)         a growing cache (`generate`): K/V are appended and
                         x attends causally over the whole cache.
        With `pools` (this layer's paged KV tensors):
          start given    x is a window of tokens at positions start[b] + i
                         (suffix prefill after a prefix-cache hit, a
                         chunked-prefill window, a speculative verify
                         window; any width, 1 included). K/V are written
                         at those positions and every row attends the
                         pool up to its own position through the
                         multi-token paged kernel;
          prefill=True   x is a right-padded prompt window; `lens` holds
                         the true prompt lengths. K/V are written into
                         the rows' blocks and attention runs over the
                         prompt itself (ragged causal mask);
          otherwise      x is one decode token per row; `lens` holds the
                         tokens already cached, so the token is written
                         at position lens[b] and attends lens[b] + 1
                         rows through the paged decode kernel.
        `start` is checked before the width: a [B, 1] window with a start
        writes at start[b], not at lens[b]. `q8` holds this layer's int8
        payloads ({"attn.qkv": (codes, scale) or None, ...}) under
        weight_dtype="int8"."""
        b, s = x.shape[0], x.shape[1]
        q8 = q8 or {}
        qkv = _linear(self.qkv, x, q8.get("attn.qkv"))
        if cache is None and pools is None:
            return self.project(self.attend(qkv), q8, drop)
        qkv = qkv.view(b, s, 3, self.num_heads, self.head_dim)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        new_cache = None
        if cache is not None:
            ctx, new_cache = _attend_cache(q, k, v, cache)
        elif len(pools) == 4:
            kc, ks, vc, vs = pools
            if start is not None:
                paged_prefill_write_q8(kc, ks, k, tables, start)
                paged_prefill_write_q8(vc, vs, v, tables, start)
                ctx = paged_prefix_attention_q8(q.contiguous(), kc, ks, vc,
                                                vs, tables, start)
            elif prefill:
                # writes quantize as they land; attention runs over the
                # prompt's own codes, the static int8 path's numerics
                paged_prefill_write_q8(kc, ks, k, tables)
                paged_prefill_write_q8(vc, vs, v, tables)
                kcod, kscl = quantize_kv(k)
                vcod, vscl = quantize_kv(v)
                ctx = attention_q8_cache(q, kcod, kscl, vcod, vscl,
                                         paged_prefill_mask(s, lens))
            else:
                paged_cache_write_q8(kc, ks, k, tables, lens)
                paged_cache_write_q8(vc, vs, v, tables, lens)
                ctx = paged_attention_q8(q.contiguous(), kc, ks, vc, vs,
                                         tables, lens + 1)
        else:
            kp, vp = pools
            if start is not None:
                paged_prefill_write(kp, k, tables, start)
                paged_prefill_write(vp, v, tables, start)
                ctx = paged_prefix_attention(q.contiguous(), kp, vp, tables,
                                             start, score_dtype=q.dtype)
            elif prefill:
                paged_prefill_write(kp, k, tables)
                paged_prefill_write(vp, v, tables)
                ctx = attention_reference(q, k, v,
                                          mask=paged_prefill_mask(s, lens),
                                          score_dtype=q.dtype)
            else:
                paged_cache_write(kp, k, tables, lens)
                paged_cache_write(vp, v, tables, lens)
                ctx = paged_attention(q.contiguous(), kp, vp, tables,
                                      lens + 1, score_dtype=q.dtype)
        out = self.project(ctx, q8, drop, serve=True)
        return out if cache is None else (out, new_cache)

    def attend(self, qkv3h):
        """Causal self-attention of the cache-free forward on the packed
        projection qkv3h [B, S, 3H] (the counterpart of the JAX
        `_qkv_attention`): packed flash attention on qkv3h itself where
        `_use_packed_flash()` holds, head_dim == 128 and S % 128 == 0; else
        `functional_attention` on its [B, S, 3, nh, hd] views. Returns the
        context [B, S, nh, hd] (or [B, S, H])."""
        qkv3h = checkpoint_tag(qkv3h, "qkv_proj")
        b, s = qkv3h.shape[0], qkv3h.shape[1]
        nh, hd = self.num_heads, self.head_dim
        if hd == 128 and s % 128 == 0 and _use_packed_flash():
            ctx = flash_attention_packed_qkv(qkv3h, nh, causal=True)
        else:
            qkv = qkv3h.view(b, s, 3, nh, hd)
            ctx = functional_attention(qkv[:, :, 0], qkv[:, :, 1],
                                       qkv[:, :, 2], is_causal=True)
        return checkpoint_tag(ctx, "attn_ctx")

    def project(self, ctx, q8=None, drop=None, serve=False):
        """The output projection of the context (then `drop`, if given);
        `serve`: a call with pools or caches (see `_linear`)."""
        b, s = ctx.shape[0], ctx.shape[1]
        out = _linear(self.out,
                      ctx.reshape(b, s, self.num_heads * self.head_dim),
                      (q8 or {}).get("attn.out"), serve)
        return out if drop is None else drop(out)


def _use_packed_flash() -> bool:
    """The JAX opt-in minus its platform test: PADDLE_TPU_FLASH_PACKED=1,
    read at call time."""
    return os.environ.get("PADDLE_TPU_FLASH_PACKED") == "1"


def _linear(mod: nn.Linear, x, pay, serve: bool = False):
    """`mod`, or under weight_dtype="int8" its payload (codes [out, in],
    scale [out]) through the weight-only int8 GEMM, bias added after. A
    row-parallel shard's partial product is all-reduced over mp before
    the bias (as `RowParallelLinear` does); when serving a bf16 model it
    stays f32 through the all-reduce and is rounded once after, as the
    one-card GEMM rounds its f32 accumulator once (the fp form adds the
    bias before that rounding, as addmm's epilogue does; the int8 form
    after, as `int8_linear_nd` does)."""
    group = getattr(mod, "group", None)
    if isinstance(mod, RowParallelLinear) and group is not None and (
            pay is not None or serve):
        wide = serve and x.dtype != torch.float32
        if pay is not None:
            y = int8_linear_nd(x, pay[0], pay[1], None, w_layout="nk",
                               out_dtype=torch.float32 if wide else None)
        elif wide:
            y = _mm_f32(x.reshape(-1, x.shape[-1]), mod.weight.t()).reshape(
                *x.shape[:-1], mod.out_features)
        else:
            y = F.linear(x, mod.weight)
        if serve:
            # no autograd under serving: reduce the fresh product in place
            all_reduce(y, group=group)
        else:
            y = _mp_allreduce(y, group)
        if wide and pay is None and mod.bias is not None:
            return (y + mod.bias).to(x.dtype)    # bf16 bias promoted: exact
        y = y.to(x.dtype)
        return y if mod.bias is None else y + mod.bias
    if pay is None:
        return mod(x)
    # a column shard plans its launch as its whole layer does, so its
    # outputs are the one-card GEMM's, sliced, bit for bit
    return int8_linear_nd(x, pay[0], pay[1], mod.bias, w_layout="nk",
                          plan_n=getattr(mod, "full_out_features", None))


def _is_q8_cache(cache) -> bool:
    """True iff a static-cache tuple is the int8 form. The length alone is
    not a safe tag, the codes' dtype is: a malformed tuple raises instead
    of reading a scale buffer as the position cursor."""
    if len(cache) >= 5:
        if cache[0].dtype != torch.int8:
            raise ValueError(
                f"static KV-cache tuple of length {len(cache)} must carry "
                f"int8 codes first (got {cache[0].dtype}); fp caches are "
                f"(k, v, pos[, ragged])")
        return True
    return False


def _attend_cache(q, k, v, cache):
    """Write this step's K/V into a static or growing cache and attend;
    returns (ctx, new cache). Static buffers update in place and the
    returned tuple carries the advanced cursor."""
    s = q.shape[1]
    if len(cache) == 2:
        k = torch.cat([cache[0], k.to(cache[0].dtype)], dim=1)
        v = torch.cat([cache[1], v.to(cache[1].dtype)], dim=1)
        return attention_reference(q, k, v, is_causal=True), (k, v)
    if _is_q8_cache(cache):
        kc, ks, vc, vs, pos = cache[:5]
        ragged = cache[5] if len(cache) >= 6 else None
        static_cache_update_q8(kc, ks, k, pos)
        static_cache_update_q8(vc, vs, v, pos)
        ctx = attention_q8_cache(q, kc, ks, vc, vs,
                                 _static_mask(kc, s, pos, ragged))
        tail = (kc, ks, vc, vs, pos + s)
    else:
        kb, vb, pos = cache[:3]
        ragged = cache[3] if len(cache) >= 4 else None
        static_cache_update(kb, k, pos)
        static_cache_update(vb, v, pos)
        ctx = attention_reference(q, kb, vb,
                                  mask=_static_mask(kb, s, pos, ragged),
                                  score_dtype=q.dtype)
        tail = (kb, vb, pos + s)
    return ctx, tail + (() if ragged is None else (ragged,))


def _static_mask(buf, s, pos, ragged):
    if ragged is None:
        return static_cache_mask(buf.shape[1], s, pos, device=buf.device)
    return static_cache_mask(buf.shape[1], s, pos, prompt_lens=ragged[0],
                             prefill_cap=ragged[1])


class GPTMLP(nn.Module):
    def __init__(self, config: GPTConfig, device=None, dtype=None):
        super().__init__()
        h, m = config.hidden_size, config.intermediate_size
        self.up = ColumnParallelLinear(h, m, gather_output=False,
                                       device=device, dtype=dtype)
        self.down = RowParallelLinear(m, h, input_is_parallel=True,
                                      device=device, dtype=dtype)

    def forward(self, x, q8=None, drop=None, serve=False):
        return self.down_proj(self.up_proj(x, q8), q8, drop, serve)

    def up_proj(self, x, q8=None):
        return checkpoint_tag(_linear(self.up, x, (q8 or {}).get("mlp.up")),
                              "mlp_up")

    def down_proj(self, u, q8=None, drop=None, serve=False):
        y = _linear(self.down, F.gelu(u, approximate="tanh"),
                    (q8 or {}).get("mlp.down"), serve)
        return y if drop is None else drop(y)


class GPTBlock(nn.Module):
    """Pre-LN transformer block. An MoE block (`is_moe`, see GPTConfig)
    has a routed-expert `MoELayer` as its ``mlp``; its output is dropped
    by `drop` like the dense MLP's, and its aux loss is left on
    ``mlp.aux_loss`` (returned as well under ``with_aux``)."""

    def __init__(self, config: GPTConfig, device=None, dtype=None,
                 layer_idx: int = 0):
        super().__init__()
        h, eps = config.hidden_size, config.layer_norm_epsilon
        self.ln_1 = LayerNorm(h, eps=eps, device=device, dtype=dtype)
        self.attn = GPTSelfAttention(config, device, dtype)
        self.ln_2 = LayerNorm(h, eps=eps, device=device, dtype=dtype)
        n = max(1, config.moe_every_n_layers)
        self.is_moe = config.moe_num_experts > 0 and layer_idx % n == n - 1
        if self.is_moe:
            self.mlp = MoELayer(h, config.intermediate_size,
                                config.moe_num_experts, gate=config.moe_gate,
                                top_k=config.moe_top_k,
                                capacity_factor=config.moe_capacity_factor,
                                device=device, dtype=dtype)
        else:
            self.mlp = GPTMLP(config, device, dtype)

    def forward(self, x, pools=None, tables=None, lens=None, prefill=False,
                start=None, cache=None, q8=None, drop=None, with_aux=False):
        """Returns x, or (x, new cache) when `cache` is given, or (x, the
        MoE block's aux loss) under `with_aux`."""
        a = self.attn(self.ln_1(x), pools, tables, lens, prefill, start,
                      cache, q8, drop)
        a, new_cache = a if cache is not None else (a, None)
        x = x + a
        x = x + self._ffn(self.ln_2(x), q8, drop,
                          serve=pools is not None or cache is not None)
        if with_aux:
            return x, self.mlp.aux_loss
        return x if cache is None else (x, new_cache)

    def _ffn(self, x, q8=None, drop=None, serve=False):
        """The MLP, or the MoE layer (its weights never int8) then `drop`."""
        if not self.is_moe:
            return self.mlp(x, q8, drop, serve)
        y = self.mlp(x)
        return y if drop is None else drop(y)

    # the cache-free training forward in stages, cut at the tags
    def _qkv(self, x):
        return self.attn.qkv(self.ln_1(x))

    def _attn_out(self, x, ctx, drop):
        return x + self.attn.project(ctx, drop=drop)

    def _mlp_out(self, x, drop, with_aux=False):
        x = x + self._ffn(self.ln_2(x), drop=drop)
        return (x, self.mlp.aux_loss) if with_aux else x

    def recompute_segments(self, x, save, generators=(), drop=None,
                           with_aux=False):
        """The training forward as checkpoint regions cut after each tag
        in `save` (a prefix of qkv_proj, attn_ctx, mlp_up), so each tagged
        value is kept as the input of the next region, besides x, which
        every region that adds the residual keeps too (the JAX remat keeps
        the block input as well). An MoE block has no mlp_up: its last
        region runs from the attention context (or qkv) through the MoE
        layer, and returns the aux loss as an output under `with_aux`.
        The results equal `forward(x, drop=drop, with_aux=with_aux)`."""
        if not save or tuple(save) != TAGS[:len(save)]:
            raise ValueError(f"save must be a prefix of {TAGS}; got {save}")
        seg = functools.partial(checkpoint_segment, generators=generators)
        qkv = seg(self._qkv, x)
        if len(save) == 1:
            return seg(lambda x, qkv: self._mlp_out(self._attn_out(
                x, self.attn.attend(qkv), drop), drop, with_aux), x, qkv)
        ctx = seg(self.attn.attend, qkv)
        if len(save) == 2 or self.is_moe:
            return seg(lambda x, ctx: self._mlp_out(
                self._attn_out(x, ctx, drop), drop, with_aux), x, ctx)

        def mid(x, ctx):
            x = self._attn_out(x, ctx, drop)
            return x, self.mlp.up_proj(self.ln_2(x))
        x, u = seg(mid, x, ctx)
        return x + seg(lambda u: self.mlp.down_proj(u, drop=drop), u)


class GPTModel(nn.Module):
    """Backbone: embeddings + N blocks + final LN. ``device`` defaults to
    CUDA (raising without a card)."""

    def __init__(self, config: GPTConfig, device=None, dtype=None):
        super().__init__()
        self.config = config
        device = resolve_device(device)
        h = config.hidden_size
        config.check_mp(mesh_axis_size("mp"))
        # this model's tensor-parallel group (None: not sharded)
        self.mp_group = resolve_mp_group(None)
        self.wte = VocabParallelEmbedding(config.vocab_size, h,
                                          device=device, dtype=dtype)
        self.wpe = nn.Embedding(config.max_position_embeddings, h,
                                device=device, dtype=dtype)
        self.h = nn.ModuleList([GPTBlock(config, device, dtype, layer_idx=i)
                                for i in range(config.num_layers)])
        self.ln_f = LayerNorm(h, eps=config.layer_norm_epsilon,
                              device=device, dtype=dtype)
        # hidden dropout's masks; GPTForCausalLM seeds it
        self.dropout_generator = torch.Generator(device=device)
        # the replicated wte serving reads (gather_serving_tables) and the
        # (data pointer, version) of the shard it was gathered from
        self.serving_wte = None
        self._serving_src = None

    def _drop(self, x):
        """Inverted dropout at hidden_dropout: keep with probability 1 - p
        (a draw from `dropout_generator`), scale kept entries by 1/(1-p)."""
        return _drop(x, self.config.hidden_dropout, self.dropout_generator)

    def forward(self, input_ids, position_ids=None, pools=None, tables=None,
                lens=None, prefill=False, start=None, caches=None, q8=None):
        """Returns the final hidden states, or (hidden, new caches) when
        per-layer `caches` are given. Default positions: a static cache's
        cursor onward, a growing cache's length onward, else 0..s-1.
        Hidden dropout runs in train() mode on the cache-free forward
        only. The cache-free forward leaves the MoE blocks' summed aux loss
        on ``last_aux_loss`` (None without MoE blocks or with pools or
        caches); under recompute it is an output of each block's
        checkpoint regions."""
        s = input_ids.shape[1]
        dev = input_ids.device
        serving = pools is not None or caches is not None
        table = self.serving_wte if serving else None
        if self.mp_group is not None and (serving or q8) and table is None:
            raise ValueError(
                "a tensor-parallel GPT serves from its replicated tables: "
                "call GPTForCausalLM.gather_serving_tables(group) on every "
                "rank first (the sharded ServingEngine does)")
        if table is not None and self._serving_src != _source(self.wte):
            raise ValueError(
                "wte changed since gather_serving_tables: gather the "
                "serving tables again (rebuild the serving engine)")
        if position_ids is None:
            past = 0
            if caches is not None:
                c0 = caches[0]
                past = c0[0].shape[1] if len(c0) == 2 else \
                    c0[4] if _is_q8_cache(c0) else c0[2]
            position_ids = torch.arange(past, past + s, device=dev)[None]
        # positions past the table only occur on discarded columns (dummy
        # slots, a chunk's overshoot past a row's budget); clamping keeps
        # their lookup in bounds instead of faulting the device
        position_ids = position_ids.clamp(0, self.wpe.num_embeddings - 1)
        q8 = q8 or {}
        wte = q8.get("wte")
        if wte is None:
            tok = self.wte(input_ids) if table is None \
                else F.embedding(input_ids, table)
        else:
            # int8 row gather times the row scale: a row of the
            # dequantized table, which is never built whole
            codes, scale = wte
            tok = (codes[input_ids].float()
                   * scale[input_ids][..., None]).to(self.wte.weight.dtype)
        # wpe has no int8 consumer: it reads the dequantized copy
        wpe = q8.get("wpe")
        x = tok + F.embedding(position_ids,
                              self.wpe.weight if wpe is None else wpe)
        drop = None
        if (self.training and self.config.hidden_dropout
                and pools is None and caches is None):
            drop = self._drop
            x = drop(x)
        layers = q8.get("h")
        new_caches = [] if caches is not None else None
        free = pools is None and caches is None
        remat = (self.config.use_recompute and self.training and free
                 and layers is None)
        aux = None
        for i, block in enumerate(self.h):
            if remat:
                x = recompute(block, x, policy=self.config.recompute_policy,
                              generators=(self.dropout_generator,
                                          *get_rng_state_tracker()
                                          .generators()),
                              drop=drop, with_aux=block.is_moe)
            else:
                x = block(x, None if pools is None else pools[i], tables,
                          lens, prefill, start,
                          None if caches is None else caches[i],
                          None if layers is None else layers[i], drop,
                          with_aux=block.is_moe and free)
            if caches is not None:
                x, c = x
                new_caches.append(c)
            elif block.is_moe and free:
                x, a = x
                aux = a if aux is None else aux + a
        self.last_aux_loss = aux
        x = self.ln_f(x)
        return x if caches is None else (x, new_caches)


class GPTForCausalLM(nn.Module):
    """GPT with the LM head tied to wte (or an untied bias-free head).

    ``device`` defaults to CUDA and raises when no card is present; pass
    ``device="cpu"`` for the plain PyTorch path. Weights are drawn from a
    ``torch.Generator`` seeded with ``seed`` using the JAX package's init:
    Normal(initializer_range) for wte, the qkv/up projections and the
    experts' w1, the same scaled by 1/sqrt(2 * num_layers) for the
    out/down projections and the experts' w2, Xavier-uniform for the
    router, Normal(0, 1) for wpe, zeros for biases and ones for LayerNorm
    gains. The model starts in eval() mode; call train() for hidden dropout,
    whose masks come from ``dropout_generator`` (seeded with ``seed``)."""

    def __init__(self, config: GPTConfig, device=None, dtype=None,
                 seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        dtype = dtype or getattr(torch, config.param_dtype)
        self.config = config
        self.gpt = GPTModel(config, dev, dtype)
        # an untied head's replicated table, and which gather of the
        # serving tables is current (gather_serving_tables)
        self.serving_head = None
        self._serving_token = 0
        if not config.tie_word_embeddings:
            self.lm_head = ColumnParallelLinear(
                config.hidden_size, config.vocab_size, has_bias=False,
                gather_output=False, device=dev, dtype=dtype)
        self.reset_parameters(torch.Generator(device=dev).manual_seed(seed))
        # hidden dropout's stream: the same on every mp rank, its own on
        # each dp rank
        self.gpt.dropout_generator.manual_seed(replicated_seed(seed))
        self.eval()

    @property
    def dropout_generator(self) -> torch.Generator:
        return self.gpt.dropout_generator

    @property
    def device(self) -> torch.device:
        return self.gpt.wte.weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.gpt.wte.weight.dtype

    @property
    def mp_group(self):
        return self.gpt.mp_group

    @property
    def local_heads(self) -> int:
        """The attention heads this rank computes (num_heads / mp)."""
        return self.config.num_heads // (1 if self.mp_group is None
                                         else self.mp_group.nranks)

    @torch.no_grad()
    def gather_serving_tables(self, group=None):
        """Gather wte (and an untied LM head) over `group` (the model's mp
        group, or a group of one rank) into replicated tables that every
        call with pools or caches reads: the embedding lookup and the head
        then need no collective, and the logits are whole on every rank.
        Every rank of the group calls it (an all-gather). Returns the
        tables' bytes on this rank."""
        group = self.mp_group if group is None else group
        if self.mp_group is not None and (
                group is None or group.ranks != self.mp_group.ranks):
            raise ValueError("gather_serving_tables: the group must be the "
                             "model's mp group")

        def gather(w):
            w = w.detach().contiguous()
            return w.clone() if group is None else \
                all_gather(w, group=group).flatten(0, 1)
        self.gpt.serving_wte = gather(self.gpt.wte.weight)
        self.gpt._serving_src = _source(self.gpt.wte)
        self.serving_head = None if self.config.tie_word_embeddings \
            else gather(self.lm_head.weight)
        self._serving_token += 1
        return sum(t.numel() * t.element_size() for t in
                   (self.gpt.serving_wte, self.serving_head) if t is not None)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        """Draw every parameter from `generator` in name order; a
        tensor-parallel shard is cut from the full tensor drawn as the
        single-device model draws it, so a sharded model from a seed is
        the single-device one, sharded."""
        cfg = self.config
        std = cfg.initializer_range
        deep = std / math.sqrt(2 * cfg.num_layers)
        g = self.mp_group
        for name, p in self.named_parameters():
            if name.endswith((".bias", "mlp.b1", "mlp.b2")):
                p.zero_()
                continue
            if ".ln_" in name:
                p.fill_(1.0)
                continue
            split = getattr(p, "mp_split", None) if g is not None else None
            t = p
            if split is not None:
                full = list(p.shape)
                full[split[0]] *= g.nranks
                t = torch.empty(full, dtype=p.dtype, device=p.device)
            if name == "gpt.wpe.weight":
                t.normal_(0.0, 1.0, generator=generator)
            elif name.endswith("mlp.gate_weight"):
                xavier_uniform_(t, generator)
            elif name.endswith(("attn.out.weight", "mlp.down.weight",
                                "mlp.w2")):
                t.normal_(0.0, deep, generator=generator)
            else:
                t.normal_(0.0, std, generator=generator)
            if split is not None:
                p.copy_(shard_of(t, split[0], split[1], g.rank, g.nranks))

    def forward(self, input_ids, position_ids=None, pools=None, tables=None,
                lens=None, prefill=False, start=None, caches=None, q8=None):
        """Logits, or (logits, new caches) when per-layer `caches` are
        given (see GPTSelfAttention.forward for pools and caches). `q8` is
        the int8 payload of `_q8(weight_dtype="int8")`."""
        x = self.gpt(input_ids, position_ids, pools, tables, lens, prefill,
                     start, caches, q8)
        x, new_caches = x if caches is not None else (x, None)
        tied = self.config.tie_word_embeddings
        head = (q8 or {}).get("wte" if tied else "lm_head")
        table = None
        if pools is not None or caches is not None:
            table = self.gpt.serving_wte if tied else self.serving_head
        if head is not None:
            logits = int8_linear_nd(x, head[0], head[1], w_layout="nk")
        elif table is not None:
            # the replicated table: whole logits, no collective
            logits = x @ table.t() if tied else F.linear(x, table)
        elif self.mp_group is not None:
            # this rank's vocabulary columns, gathered
            local = F.linear(_c_identity(x, self.mp_group),
                             self.gpt.wte.weight) \
                if self.config.tie_word_embeddings else self.lm_head(x)
            logits = _c_concat(local, self.mp_group)
        elif self.config.tie_word_embeddings:
            logits = x @ self.gpt.wte.weight.t()
        else:
            logits = self.lm_head(x)
        return logits if caches is None else (logits, new_caches)

    def loss(self, input_ids, labels, loss_mask=None, position_ids=None,
             chunk_size: int = 128):
        """Training loss with the fused LM head: the hidden states go
        straight into `fused_linear_cross_entropy` (the kernel route where
        `use_linear_ce` holds), so the [B, S, vocab] logits never exist.
        Equals `GPTPretrainingCriterion()(model(ids), labels, loss_mask)`
        for in-range labels; an MoE model also adds moe_aux_weight times
        the router aux loss (the criterion takes it as ``aux_loss``). A
        tensor-parallel model runs the vocab-parallel route on its head
        shard. Inside `TrainStep(mesh=...)` a `loss_mask` mean is the
        global one over the data-parallel ranks (`_masked_mean`)."""
        x = self.gpt(input_ids, position_ids)
        tied = self.config.tie_word_embeddings
        w = self.gpt.wte.weight if tied else self.lm_head.weight
        # an untied head is nn.Linear [V, H]: the "vh" layout as it is
        per_tok = fused_linear_cross_entropy(x, w, labels,
                                             chunk_size=chunk_size,
                                             mp_group=self.mp_group)
        loss = _masked_mean(per_tok, loss_mask)
        aux = self.gpt.last_aux_loss
        if aux is not None:
            loss = loss + self.config.moe_aux_weight * aux
        return loss

    # --------------------------------------------- weight-only int8 payload
    @torch.no_grad()
    def quantized_params(self) -> Dict[str, Tuple[torch.Tensor,
                                                  torch.Tensor]]:
        """The weight-only int8 form of every 2-D parameter with at least
        ``PADDLE_TPU_Q8_DECODE_MIN`` elements (default 1 << 20): {name:
        (codes int8, scale f32)}, the scale kept with a size-1 dim, s =
        max|w| / 127 floored at 1e-12 and codes = clip(round(w / s), -127,
        127) in f32, rounding half to even. The reduction axis is the JAX
        package's, in the port's layouts: per row for the [out, in]
        projections, the untied LM head and wte (its lookup and the tied
        head both contract over H); per column for wpe.

        On a tensor-parallel shard the gate judges the full parameter's
        size, wte and an untied head are quantized from their gathered
        serving tables when those exist, and where the reduction runs
        along the split dimension (attn.out, mlp.down: split along `in`)
        each row's absmax is a max all-reduce of the shards' absmaxes over
        the mp group, so the codes are the single-device codes, cut."""
        min_size = int(os.environ.get("PADDLE_TPU_Q8_DECODE_MIN",
                                      str(1 << 20)))
        g = self.mp_group
        tables = {"gpt.wte.weight": self.gpt.serving_wte,
                  "lm_head.weight": self.serving_head}
        out = {}
        for name, p in self.named_parameters():
            split = getattr(p, "mp_split", None) if g is not None else None
            if tables.get(name) is not None:
                p, split = tables[name], None
            full = p.numel() * (1 if split is None else g.nranks)
            if p.dim() != 2 or full < min_size:
                continue
            w = p.float()
            dim = 0 if name == "gpt.wpe.weight" else 1
            amax = w.abs().amax(dim=dim, keepdim=True)
            if split is not None and split[0] == dim:
                all_reduce(amax, ReduceOp.MAX, group=g)
            s = (amax / 127.0).clamp_min(1e-12)
            q = torch.round(w / s).clamp(-127, 127).to(torch.int8)
            out[name] = (q, s)
        return out

    def _param_snapshot(self) -> tuple:
        """(data pointer, version) of every parameter: changes when any
        weight is replaced or updated in place (an optimizer step, a
        load_state_dict, a .to(dtype)); and which gather of the serving
        tables is current."""
        return tuple((p.data_ptr(), p._version) for p in
                     self.parameters()) + (self._serving_token,)

    def _q8(self, weight_dtype):
        """The payload a forward consumes under weight_dtype="int8" (None
        otherwise), quantized once per set of weights: {"wte": (codes,
        scale [V]), "wpe": the dequantized table, "lm_head": ..., "h":
        [{"attn.qkv": (codes, scale [out]), ...} per layer]}; an entry is
        None where the parameter stays unquantized."""
        if weight_dtype is None:
            return None
        if weight_dtype != "int8":
            raise ValueError(f"weight_dtype must be None or 'int8' (weight-"
                             f"only int8 GEMMs); got {weight_dtype!r}")
        snap = self._param_snapshot()
        cached = getattr(self, "_q8_cache", None)
        if cached is not None and cached[0] == snap:
            return cached[1]
        qp = self.quantized_params()

        def pay(name):
            e = qp.get(name)
            return None if e is None else (e[0], e[1].reshape(-1))

        wpe = qp.get("gpt.wpe.weight")
        tree = {"wte": pay("gpt.wte.weight"),
                "wpe": None if wpe is None
                else (wpe[0].float() * wpe[1]).to(self.dtype),
                "lm_head": pay("lm_head.weight"),
                "h": [{k: pay(f"gpt.h.{i}.{k}.weight")
                       for k in ("attn.qkv", "attn.out") + (
                           () if block.is_moe else ("mlp.up", "mlp.down"))}
                      for i, block in enumerate(self.gpt.h)]}
        self._q8_cache = (snap, tree)
        return tree

    # ------------------------------------------------ static-cache decode
    def _make_static_caches(self, c8, b, L, ragged=None):
        """Per-layer static caches: (k, v, 0) in the model dtype, or int8
        (k_codes, k_scale, v_codes, v_scale, 0) with f32 scales per (row,
        head); `ragged` = (prompt lens [B], prompt cap) rides last."""
        cfg, dev = self.config, self.device
        shape = (b, L, self.local_heads, cfg.head_dim)
        tail = () if ragged is None else (ragged,)
        out = []
        for _ in range(cfg.num_layers):
            if c8:
                base = (torch.zeros(shape, dtype=torch.int8, device=dev),
                        torch.zeros(shape[:3], device=dev),
                        torch.zeros(shape, dtype=torch.int8, device=dev),
                        torch.zeros(shape[:3], device=dev), 0)
            else:
                base = (torch.zeros(shape, dtype=self.dtype, device=dev),
                        torch.zeros(shape, dtype=self.dtype, device=dev), 0)
            out.append(base + tail)
        return out

    @torch.no_grad()
    def prefill_static(self, input_ids, max_len: int,
                       weight_dtype: str = None, cache_dtype: str = None,
                       prompt_lens=None):
        """Run the prompt once and return a prefill state that
        `decode_static` continues from.

        input_ids [B, P]; max_len > P is the cache rows per row. With
        `prompt_lens` ([B] host ints) the prompts are RIGHT-padded to P:
        rows in [len, P) hold garbage K/V that the ragged mask excludes,
        and each row continues from its true length. The state holds the
        keys of the JAX package's ("caches", "last_logits", "prompt",
        "max_len", "q8", "c8", "payload", "cdt", "param_ids", "lens").
        One state fans out to any number of decode_static continuations
        (each copies the caches first) unless one of them donates it."""
        dev = self.device
        ids = _on(input_ids, torch.int64, dev)
        b, p_len = ids.shape
        if max_len <= p_len:
            raise ValueError(f"max_len ({max_len}) must exceed the prompt "
                             f"length ({p_len}) to leave room for decode")
        q8 = self._q8(weight_dtype)
        c8 = _validate_cache_dtype(cache_dtype, self.dtype)
        lens = None
        if prompt_lens is not None:
            lens = _coerce_prompt_lens(prompt_lens, p_len, "prefill_static",
                                       dev)
        caches = self._make_static_caches(
            c8, b, int(max_len), None if lens is None else (lens, p_len))
        if lens is None:
            logits, caches = self.forward(ids, caches=caches, q8=q8)
            last = logits[:, -1].float()
        else:
            pos = torch.arange(p_len, device=dev)[None].expand(b, p_len)
            logits, caches = self.forward(ids, pos, caches=caches, q8=q8)
            last = logits[torch.arange(b, device=dev),
                          lens.long() - 1].float()
        return {"caches": caches, "last_logits": last, "prompt": ids,
                "max_len": int(max_len), "q8": q8 is not None, "c8": c8,
                "payload": q8, "cdt": str(self.dtype),
                "param_ids": self._param_snapshot(), "lens": lens}

    @torch.no_grad()
    def decode_static(self, state, max_new_tokens: int,
                      temperature: float = 0.0, top_k: int = 0,
                      top_p: float = 1.0, seed: int = 0,
                      eos_token_id: int = None, return_state: bool = False,
                      donate_cache: bool = False):
        """Continue from a `prefill_static` state for `max_new_tokens`
        steps; returns tokens [B, max_new_tokens] int64 (greedy: the tail
        of generate_static on the same prompt).

        return_state=True also returns a resumable state: the next call
        feeds the unwritten last token (`pending`) first, keeps the EOS
        mask (`done`) and offsets ragged positions by `generated`, so a
        [1, c, c, ...] chunked greedy decode equals one decode of the
        summed length. donate_cache=True (needs return_state) writes into
        the state's buffers and consumes it: its "caches" become None and
        reusing it raises. Otherwise the buffers are copied first, so one
        prefill fans out to many continuations. Sampling (temperature > 0)
        draws from a torch.Generator seeded with `seed`."""
        if donate_cache and not return_state:
            raise ValueError("donate_cache=True needs return_state=True: "
                             "without the returned state the donated "
                             "buffers would simply be destroyed")
        if max_new_tokens <= 0:
            raise ValueError("decode_static needs max_new_tokens >= 1 "
                             "(the state already holds the prompt)")
        if state["caches"] is None:
            raise ValueError("decode_static: this state's caches were "
                             "consumed by a donate_cache=True decode; "
                             "continue from the state that call returned")
        b, p_len = state["prompt"].shape
        L = state["max_len"]
        resume = state.get("pending") is not None
        gen0 = int(state.get("generated", 0))
        # the last sampled token is returned but never written, so a state
        # of L rows admits p_len + generated + max_new_tokens - 1 writes
        if p_len + gen0 + max_new_tokens - 1 > L:
            raise ValueError(
                f"decode_static: prompt ({p_len}) + generated ({gen0}) + "
                f"max_new_tokens ({max_new_tokens}) needs "
                f"{p_len + gen0 + max_new_tokens - 1} cache rows, "
                f"exceeding the prefill state's max_len ({L})")
        if str(self.dtype) != state["cdt"]:
            raise ValueError(
                f"decode_static: the model's dtype changed since prefill "
                f"({state['cdt']} -> {self.dtype}); re-run prefill_static")
        # PyTorch updates parameters in place, so identity proves nothing:
        # the snapshot holds each parameter's (data pointer, version)
        if state.get("param_ids") is not None and \
                self._param_snapshot() != state["param_ids"]:
            raise ValueError(
                "decode_static: the model's parameters changed since "
                "prefill_static; the prefill state was computed with the "
                "old weights. Re-run prefill_static after mutating weights "
                "(or decode before updating them).")
        caches = state["caches"]
        if not donate_cache:
            caches = [tuple(e.clone() if torch.is_tensor(e) else e
                            for e in c) for c in caches]
        dev = self.device
        gen = _generator(dev, seed, temperature)
        pick = dict(temperature=temperature, top_k=top_k, top_p=top_p)
        done = state.get("done")
        if done is None:
            done = torch.zeros(b, dtype=torch.bool, device=dev)
        if resume:
            toks, caches, done = self._static_steps(
                caches, state["pending"], done, range(gen0, gen0 +
                                                      max_new_tokens),
                state["payload"], gen, pick, eos_token_id, state["lens"])
        else:
            nxt = sample_logits(state["last_logits"], gen, **pick)
            if eos_token_id is not None:
                done = done | (nxt == eos_token_id)
            toks, caches, done = self._static_steps(
                caches, nxt, done, range(1, max_new_tokens),
                state["payload"], gen, pick, eos_token_id, state["lens"])
            toks = [nxt] + toks
        out = torch.stack(toks, dim=1).to(torch.int64)
        if not return_state:
            return out
        new_state = dict(state)
        new_state.update(caches=caches, pending=out[:, -1], done=done,
                         generated=gen0 + int(max_new_tokens),
                         last_logits=None)
        if donate_cache:
            state["caches"] = None
        return out, new_state

    def _static_steps(self, caches, cur, done, steps, q8, gen, pick, eos,
                      lens):
        """One static-cache decode step per entry of `steps`, feeding
        `cur` first. A step number counts generated tokens from 1: the
        token fed at step k sits at position lens[b] + k - 1 of a ragged
        row (an unragged row's position is the cache cursor). Returns
        (sampled tokens, caches, done)."""
        toks = []
        for step in steps:
            pos = None if lens is None else (lens.long() + step - 1)[:, None]
            logits, caches = self.forward(cur[:, None], pos, caches=caches,
                                          q8=q8)
            new = sample_logits(logits[:, -1].float(), gen, **pick)
            if eos is not None:
                new = torch.where(done, torch.full_like(new, eos), new)
                done = done | (new == eos)
            toks.append(new)
            cur = new
        return toks, caches, done

    @torch.no_grad()
    def generate_static(self, input_ids, max_new_tokens: int = 16,
                        temperature: float = 0.0, top_k: int = 0,
                        top_p: float = 1.0, max_len: int = None,
                        seed: int = 0, eos_token_id: int = None,
                        weight_dtype: str = None, cache_dtype: str = None):
        """Generation over fixed KV buffers of max_len (default prompt +
        new) rows: prefill, then one decode step per token; rows that
        emitted EOS keep emitting it. Returns [B, P + max_new_tokens]
        int64 (the prompt as given when max_new_tokens <= 0)."""
        return self._generate_static(
            input_ids, None, max_new_tokens, max_len, weight_dtype,
            cache_dtype, temperature=temperature, top_k=top_k, top_p=top_p,
            seed=seed, eos_token_id=eos_token_id)

    @torch.no_grad()
    def generate_static_ragged(self, input_ids, prompt_lens,
                               max_new_tokens: int = 16,
                               temperature: float = 0.0, top_k: int = 0,
                               top_p: float = 1.0, max_len: int = None,
                               seed: int = 0, eos_token_id: int = None,
                               weight_dtype: str = None,
                               cache_dtype: str = None):
        """generate_static for prompts RIGHT-padded to a cap: only columns
        < prompt_lens[b] of row b are real. Padded K/V rows are masked per
        row, and decode positions continue from each row's true length, so
        every row equals its unpadded run. Returns [B, P_cap +
        max_new_tokens]: each padded prompt followed by its
        continuation."""
        return self._generate_static(
            input_ids, prompt_lens, max_new_tokens, max_len, weight_dtype,
            cache_dtype, temperature=temperature, top_k=top_k, top_p=top_p,
            seed=seed, eos_token_id=eos_token_id)

    def _generate_static(self, input_ids, prompt_lens, max_new_tokens,
                         max_len, weight_dtype, cache_dtype, **sampling):
        ids = _on(input_ids, torch.int64, self.device)
        if max_new_tokens <= 0:
            return ids
        p_len = ids.shape[1]
        L = int(max_len or (p_len + max_new_tokens))
        if L < p_len + max_new_tokens:
            raise ValueError(f"max_len ({L}) is below prompt + "
                             f"max_new_tokens ({p_len} + {max_new_tokens})")
        st = self.prefill_static(ids, L, weight_dtype=weight_dtype,
                                 cache_dtype=cache_dtype,
                                 prompt_lens=prompt_lens)
        toks, _ = self.decode_static(st, max_new_tokens, return_state=True,
                                     donate_cache=True, **sampling)
        return torch.cat([ids, toks], dim=1)

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens: int = 16,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, seed: int = None,
                 eos_token_id: int = None):
        """Eager generation over a growing KV cache (K/V concatenated each
        step). Greedy output equals generate_static's. Sampling draws from
        a torch.Generator seeded with `seed`; seed=None draws a fresh seed
        from the OS, so repeat calls sample fresh continuations. With
        `eos_token_id`, finished rows keep emitting EOS and the loop stops
        once every row finished, so the output can be shorter than
        P + max_new_tokens."""
        cfg, dev = self.config, self.device
        ids = _on(input_ids, torch.int64, dev)
        b = ids.shape[0]
        empty = torch.zeros((b, 0, self.local_heads, cfg.head_dim),
                            dtype=self.dtype, device=dev)
        caches = [(empty, empty) for _ in range(cfg.num_layers)]
        gen = _generator(dev, secrets.randbits(62) if seed is None else seed,
                         temperature)
        done = torch.zeros(b, dtype=torch.bool, device=dev)
        out, cur = [ids], ids
        for _ in range(int(max_new_tokens)):
            logits, caches = self.forward(cur, caches=caches)
            nxt = sample_logits(logits[:, -1].float(), gen,
                                temperature=temperature, top_k=top_k,
                                top_p=top_p)[:, None]
            if eos_token_id is not None:
                nxt = torch.where(done[:, None],
                                  torch.full_like(nxt, eos_token_id), nxt)
                done = done | (nxt[:, 0] == eos_token_id)
            out.append(nxt)
            cur = nxt
            if eos_token_id is not None and bool(done.all()):
                break
        return torch.cat(out, dim=1)

    # ------------------------------------------------ paged-pool serving
    @torch.no_grad()
    def prefill_paged(self, input_ids, prompt_lens, pools, block_tables,
                      temperature: float = 0.0, top_k: int = 0,
                      top_p: float = 1.0, seed: int = 0,
                      weight_dtype: str = None, cache_dtype: str = None,
                      start=None):
        """Prefill right-padded prompts into their pool blocks.

        input_ids [n, P_cap] right-padded prompts; prompt_lens [n] true
        lengths (1 <= len <= P_cap); pools from BlockPool.make_pools();
        block_tables [n, MB] int32 rows naming each prompt's blocks (0 =
        trash). Writes every prompt's K/V into its blocks (the pools are
        updated in place) and returns ``(pools, first_token [n] int32)``,
        the first token sampled from each row's last real position.

        `start` [n] int32 switches to suffix prefill: input_ids then hold
        only the not-yet-cached suffix (right-padded; prompt_lens = suffix
        lengths), row positions run start[b] + i, and attention covers the
        pool (the cached prefix blocks mapped into the row's table plus
        the suffix itself) through the multi-token paged kernel. The
        serving engine passes the same padded [1, P_cap] or [1, chunk]
        window as the JAX engine; the padding columns are written past the
        suffix (or into the trash block) and their outputs are dropped."""
        q8 = self._q8(weight_dtype)
        dev = self.device
        ids = _on(input_ids, torch.int64, dev)
        b, p_cap = ids.shape
        lens = _coerce_prompt_lens(prompt_lens, p_cap, "prefill_paged", dev)
        tables = _on(block_tables, torch.int32, dev)
        if tables.shape[0] != b:
            raise ValueError(f"prefill_paged: block_tables rows "
                             f"({tables.shape[0]}) != batch ({b})")
        _check_pool_dtype(pools, self.dtype, cache_dtype)
        if start is None:
            logits = self.forward(ids, pools=pools, tables=tables, lens=lens,
                                  prefill=True, q8=q8)
        else:
            st = _on(start, torch.int32, dev).reshape(-1)
            if st.shape[0] != b:
                raise ValueError(f"prefill_paged: start has {st.shape[0]} "
                                 f"rows, batch is {b}")
            pos = st[:, None].long() + torch.arange(p_cap, device=dev)[None]
            logits = self.forward(ids, pos, pools=pools, tables=tables,
                                  lens=lens, start=st, q8=q8)
        last = logits[torch.arange(b, device=dev), lens.long() - 1].float()
        gen = _generator(dev, seed, temperature)
        nxt = sample_logits(last, gen, temperature=temperature,
                            top_k=top_k, top_p=top_p)
        return pools, nxt.to(torch.int32)

    @torch.no_grad()
    def decode_paged(self, pools, block_tables, lens, pending, done,
                     max_new_tokens: int, temperature: float = 0.0,
                     top_k: int = 0, top_p: float = 1.0, seed: int = 0,
                     eos_token_id: int = None, weight_dtype: str = None,
                     cache_dtype: str = None):
        """One chunk of ragged decode against the paged pool.

        Feeds `pending` (each row's sampled-but-unwritten token) first,
        writes its K/V at each row's own position `lens[b]`, and runs
        `max_new_tokens` steps; rows already `done` are forced to
        `eos_token_id`. block_tables/lens/pending/done are per-slot data
        the engine edits between chunks. Returns ``(tokens [B,
        max_new_tokens] int64, pools, lens', done')`` with the pools
        updated in place."""
        q8 = self._q8(weight_dtype)
        if max_new_tokens <= 0:
            raise ValueError("decode_paged needs max_new_tokens >= 1")
        dev = self.device
        tables = _on(block_tables, torch.int32, dev)
        ln = _on(lens, torch.int32, dev)
        cur = _on(pending, torch.int64, dev)
        dn = _on(done, torch.bool, dev)
        _check_pool_dtype(pools, self.dtype, cache_dtype)
        gen = _generator(dev, seed, temperature)
        toks = []
        for _ in range(int(max_new_tokens)):
            logits = self.forward(cur[:, None], ln[:, None].long(),
                                  pools=pools, tables=tables, lens=ln, q8=q8)
            ln = ln + 1
            new = sample_logits(logits[:, -1].float(), gen,
                                temperature=temperature, top_k=top_k,
                                top_p=top_p)
            if eos_token_id is not None:
                new = torch.where(dn, torch.full_like(new, eos_token_id),
                                  new)
                dn = dn | (new == eos_token_id)
            toks.append(new)
            cur = new
        return torch.stack(toks, dim=1).to(torch.int64), pools, ln, dn

    @torch.no_grad()
    def verify_paged(self, pools, block_tables, lens, pending, draft, done,
                     eos_token_id: int = None, weight_dtype: str = None,
                     cache_dtype: str = None):
        """One speculative-decode verify step against the paged pool:
        score a [B, k] window in one forward pass through the multi-token
        paged kernel and apply the longest-accepted-prefix rule.

        The window per row is ``[pending, draft[0], ..., draft[k-2]]``;
        its K/V are written at positions ``lens[b] + i`` (writes past the
        row's table land in the trash block) and each position takes the
        greedy argmax. Draft token i is accepted iff it equals the chain
        token emitted at window position i - 1; EOS forcing follows
        decode_paged's per-step rule in cumulative form. Rejected
        positions leave KV below the next window's start, which that
        window rewrites before it becomes attendable.

        Returns ``(emitted [B, k] int64, n_accept [B] int32, pools,
        done')``: row b emitted ``emitted[b, :n_accept[b] + 1]``; its next
        pending token is ``emitted[b, n_accept[b]]``. Greedy only."""
        q8 = self._q8(weight_dtype)
        dev = self.device
        tables = _on(block_tables, torch.int32, dev)
        b = tables.shape[0]
        ln = _on(lens, torch.int32, dev)
        pend = _on(pending, torch.int64, dev)
        dr = _on(draft, torch.int64, dev)
        if dr.dim() != 2 or dr.shape[0] != b:
            raise ValueError(f"draft must be [B, k-1]; got "
                             f"{tuple(dr.shape)} for batch {b}")
        k = dr.shape[1] + 1
        dn = _on(done, torch.bool, dev)
        _check_pool_dtype(pools, self.dtype, cache_dtype)
        window = torch.cat([pend[:, None], dr], dim=1)
        pos = ln[:, None].long() + torch.arange(k, device=dev)[None]
        logits = self.forward(window, pos, pools=pools, tables=tables,
                              lens=ln, start=ln, q8=q8)
        raw = torch.argmax(logits.float(), dim=-1)              # [B, k]
        if eos_token_id is None:
            e = raw
            done_out = dn
        else:
            # a row is done at window position i iff it was done on entry
            # or the chain emitted EOS strictly before i
            hit = (raw == eos_token_id).long()
            seen_before = torch.cumsum(hit, dim=1) - hit
            done_i = dn[:, None] | (seen_before > 0)
            e = torch.where(done_i, torch.full_like(raw, eos_token_id), raw)
        match = (dr == e[:, :-1]).long()
        n_acc = torch.cumprod(match, dim=1).sum(dim=1)
        if eos_token_id is not None:
            emitted = torch.arange(k, device=dev)[None] <= n_acc[:, None]
            done_out = dn | ((e == eos_token_id) & emitted).any(dim=1)
        return e.to(torch.int64), n_acc.to(torch.int32), pools, done_out


def _source(mod) -> tuple:
    """(data pointer, version) of a module's weight."""
    return (mod.weight.data_ptr(), mod.weight._version)


def _masked_mean(per_tok, loss_mask):
    """Mean of per-token losses, or their loss_mask-weighted sum over
    max(sum(mask), 1e-8): the one reduction both loss paths share.

    Under a data-parallel loss group (`distributed.mesh.loss_group`, set
    by TrainStep(mesh=...) around the forward) the mask's count is
    all-reduced over the group and the result scaled by its size: the
    mean of the ranks' results is then the global masked mean, and so is
    the mean of their gradients (not the mean of per-rank means, which
    differs when the mask is uneven across the ranks)."""
    if loss_mask is None:
        return per_tok.mean()
    per_tok = per_tok * loss_mask
    g = loss_group()
    if g is None:
        return per_tok.sum() / torch.clamp(loss_mask.sum(), min=1e-8)
    count = loss_mask.detach().sum().float()
    all_reduce(count, group=g)
    return per_tok.sum() * g.nranks / torch.clamp(count, min=1e-8)


def cross_entropy_per_token(logits, labels, ignore_index: int = -100):
    """Per-token softmax cross-entropy over materialised logits [..., V]
    in f32 (the role of the JAX package's ParallelCrossEntropy on one
    device); tokens labelled `ignore_index` get 0."""
    lg = logits.float()
    lse = torch.logsumexp(lg, dim=-1)
    picked = lg.gather(-1, labels.clamp_min(0).long()[..., None])[..., 0]
    return torch.where(labels == ignore_index, torch.zeros_like(lse),
                       lse - picked)


class GPTPretrainingCriterion(nn.Module):
    """Masked mean cross-entropy over materialised logits (PaddleNLP's
    GPTPretrainingCriterion)."""

    def __init__(self, config: Optional[GPTConfig] = None):
        super().__init__()

    def forward(self, logits, labels, loss_mask=None, aux_loss=None):
        """`aux_loss` (an MoE model's router loss, e.g.
        ``model.gpt.last_aux_loss``) is added to the loss as given."""
        loss = _masked_mean(cross_entropy_per_token(logits, labels),
                            loss_mask)
        return loss if aux_loss is None else loss + aux_loss


def _validate_cache_dtype(cache_dtype, dtype) -> bool:
    """Static-cache dtype check: None, the model dtype, or 'int8'.
    Returns True when the int8 KV-cache path is requested."""
    if cache_dtype == "int8":
        return True
    if cache_dtype is not None and not (
            cache_dtype == dtype or getattr(torch, str(cache_dtype), None)
            == dtype):
        raise ValueError(f"cache_dtype must be None, the model dtype, "
                         f"or 'int8'; got {cache_dtype!r}")
    return False


def _on(x, dtype, device):
    """A host array or tensor as a contiguous `dtype` tensor on `device`."""
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device=device, dtype=dtype).contiguous()


def _generator(device, seed, temperature):
    if temperature <= 0.0:
        return None
    return torch.Generator(device=device).manual_seed(int(seed))


def _coerce_prompt_lens(prompt_lens, cap, name, device):
    """Validate 1 <= len <= cap on the host (len 0 would index the padded
    tail, len > cap would unmask garbage rows) and move to the device as
    int32."""
    host = np.asarray(prompt_lens.cpu() if torch.is_tensor(prompt_lens)
                      else prompt_lens).reshape(-1)
    if host.size and (int(host.min()) < 1 or int(host.max()) > cap):
        raise ValueError(
            f"{name}: prompt_lens must satisfy 1 <= len <= P_cap ({cap}); "
            f"got range [{int(host.min())}, {int(host.max())}]")
    return torch.as_tensor(host, dtype=torch.int32, device=device)


def _check_pool_dtype(pools: Sequence, dtype, cache_dtype=None) -> bool:
    """Pools carry the model dtype, or (cache_dtype="int8") the (codes
    int8, scale f32) 4-tuple form. Returns True for the int8 form; a
    pool/request mismatch raises."""
    if cache_dtype not in (None, "int8"):
        raise ValueError(f"paged cache_dtype must be None or 'int8'; "
                         f"got {cache_dtype!r}")
    entry = pools[0]
    q8_pool = len(entry) == 4
    if q8_pool != (cache_dtype == "int8"):
        kind = "int8 codes+scales" if q8_pool else "model-dtype"
        raise ValueError(f"paged pool layout ({kind}) does not match "
                         f"cache_dtype={cache_dtype!r}; rebuild the pool "
                         f"with BlockPool(cache_dtype={cache_dtype!r})")
    if q8_pool:
        if entry[0].dtype != torch.int8 or entry[1].dtype != torch.float32:
            raise ValueError(f"int8 paged pools must be (int8 codes, f32 "
                             f"scale) pairs; got ({entry[0].dtype}, "
                             f"{entry[1].dtype})")
        return True
    if entry[0].dtype != dtype:
        raise ValueError(f"paged KV pools are {entry[0].dtype}, model is "
                         f"{dtype}; rebuild the pool after model.to(...)")
    return False


def sample_logits(last, generator: Optional[torch.Generator] = None,
                  temperature: float = 0.0, top_k: int = 0,
                  top_p: float = 1.0):
    """Next-token selection on [B, V] f32 logits. Greedy (temperature <=
    0) is argmax, first index on ties as in JAX. Otherwise temperature
    scales the logits, top_k keeps the k best (k clamped to V), top_p
    keeps the smallest sorted prefix whose preceding mass is < p (rank 0
    always), and the token is drawn with `generator` (the draws are not
    JAX's)."""
    if temperature <= 0.0:
        return torch.argmax(last, dim=-1)
    logits = last / temperature
    neg = torch.tensor(-1e30, dtype=logits.dtype, device=logits.device)
    if top_k and top_k > 0:
        kth = torch.topk(logits, min(int(top_k), logits.shape[-1]),
                         dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, neg, logits)
    if top_p < 1.0:
        sorted_logits, sort_idx = torch.sort(logits, dim=-1,
                                             descending=True, stable=True)
        probs = torch.softmax(sorted_logits, dim=-1)
        keep_sorted = (torch.cumsum(probs, dim=-1) - probs) < top_p
        keep_sorted[..., 0] = True
        keep = torch.zeros_like(keep_sorted).scatter(-1, sort_idx,
                                                     keep_sorted)
        logits = torch.where(keep, logits, neg)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


__all__: List[str] = ["GPTConfig", "PRESETS", "gpt_config",
                      "GPTSelfAttention", "GPTMLP", "GPTBlock", "GPTModel",
                      "GPTForCausalLM", "GPTPretrainingCriterion",
                      "cross_entropy_per_token", "sample_logits"]
