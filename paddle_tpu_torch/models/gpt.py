"""GPT for paged serving in PyTorch (the port of paddle_tpu/models/gpt.py's
config, forward and paged-pool serving entry points).

Module and parameter names mirror the JAX package (``gpt.wte.weight``,
``gpt.h.{i}.attn.qkv.weight``, ...), so `paddle_tpu_torch.convert` maps a
JAX state dict across by name. The mpu layers of the JAX package become
plain single-device modules: VocabParallelEmbedding -> nn.Embedding,
Column/RowParallelLinear -> nn.Linear (weights stored ``[out, in]``, the
transpose of the JAX ``[in, out]`` layout). The LM head is tied to wte.

Serving state is explicit: every layer owns one entry of ``pools`` (the
per-layer (k, v) or int8 (k_codes, k_scale, v_codes, v_scale) tensors from
`inference.kv_cache.BlockPool.make_pools`), the pools are updated IN PLACE
(this replaces JAX buffer donation), and the JAX ``lax.scan`` over a decode
chunk is a Python loop over its steps.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..ops.attention import (attention_q8_cache, attention_reference,
                             paged_attention, paged_attention_q8,
                             paged_cache_write, paged_cache_write_q8,
                             paged_prefill_mask, paged_prefill_write,
                             paged_prefill_write_q8, quantize_kv)


@dataclass
class GPTConfig:
    """The fields of the JAX GPTConfig that serving uses. MoE, recompute
    and sequence-parallel fields are accepted for config compatibility
    but only at their defaults: this port has no MoE block, no training
    remat and no sequence-parallel mesh."""
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: Optional[int] = None
    max_position_embeddings: int = 1024
    hidden_dropout: float = 0.0          # training only; serving runs eval
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
        defaults = {"use_recompute": False, "recompute_policy": None,
                    "moe_num_experts": 0, "moe_every_n_layers": 2,
                    "moe_gate": "gshard", "moe_top_k": None,
                    "moe_aux_weight": 0.01, "moe_capacity_factor": 1.25,
                    "sequence_parallel": "ring"}
        for name, default in defaults.items():
            if getattr(self, name) != default:
                raise NotImplementedError(
                    f"GPTConfig.{name}={getattr(self, name)!r}: the PyTorch "
                    f"port serves dense single-device GPT only (MoE, "
                    f"recompute and sequence parallelism are later slices)")

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads


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
    ``[3, num_heads, head_dim]`` order."""

    def __init__(self, config: GPTConfig, device=None, dtype=None):
        super().__init__()
        h = config.hidden_size
        self.num_heads, self.head_dim = config.num_heads, config.head_dim
        self.qkv = nn.Linear(h, 3 * h, device=device, dtype=dtype)
        self.out = nn.Linear(h, h, device=device, dtype=dtype)

    def forward(self, x, pools=None, tables=None, lens=None,
                prefill=False):
        """Without `pools`: causal self-attention over x (the cache-free
        forward). With `pools` (this layer's paged KV tensors):
          prefill=True   x is a right-padded prompt window; `lens` holds
                         the true prompt lengths. K/V are written into
                         the rows' blocks and attention runs over the
                         prompt itself (ragged causal mask);
          prefill=False  x is one decode token per row; `lens` holds the
                         tokens already cached, so the token is written
                         at position lens[b] and attends lens[b] + 1
                         rows through the paged decode kernel."""
        b, s = x.shape[0], x.shape[1]
        qkv = self.qkv(x).view(b, s, 3, self.num_heads, self.head_dim)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if pools is None:
            ctx = attention_reference(q, k, v, is_causal=True)
        elif len(pools) == 4:
            kc, ks, vc, vs = pools
            if prefill:
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
            if prefill:
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
        return self.out(ctx.reshape(b, s, self.num_heads * self.head_dim))


class GPTMLP(nn.Module):
    def __init__(self, config: GPTConfig, device=None, dtype=None):
        super().__init__()
        h, m = config.hidden_size, config.intermediate_size
        self.up = nn.Linear(h, m, device=device, dtype=dtype)
        self.down = nn.Linear(m, h, device=device, dtype=dtype)

    def forward(self, x):
        return self.down(F.gelu(self.up(x), approximate="tanh"))


class GPTBlock(nn.Module):
    """Pre-LN transformer block."""

    def __init__(self, config: GPTConfig, device=None, dtype=None):
        super().__init__()
        h, eps = config.hidden_size, config.layer_norm_epsilon
        self.ln_1 = nn.LayerNorm(h, eps=eps, device=device, dtype=dtype)
        self.attn = GPTSelfAttention(config, device, dtype)
        self.ln_2 = nn.LayerNorm(h, eps=eps, device=device, dtype=dtype)
        self.mlp = GPTMLP(config, device, dtype)

    def forward(self, x, pools=None, tables=None, lens=None, prefill=False):
        x = x + self.attn(self.ln_1(x), pools, tables, lens, prefill)
        return x + self.mlp(self.ln_2(x))


class GPTModel(nn.Module):
    """Backbone: embeddings + N blocks + final LN."""

    def __init__(self, config: GPTConfig, device=None, dtype=None):
        super().__init__()
        self.config = config
        h = config.hidden_size
        self.wte = nn.Embedding(config.vocab_size, h, device=device,
                                dtype=dtype)
        self.wpe = nn.Embedding(config.max_position_embeddings, h,
                                device=device, dtype=dtype)
        self.h = nn.ModuleList([GPTBlock(config, device, dtype)
                                for _ in range(config.num_layers)])
        self.ln_f = nn.LayerNorm(h, eps=config.layer_norm_epsilon,
                                 device=device, dtype=dtype)

    def forward(self, input_ids, position_ids=None, pools=None, tables=None,
                lens=None, prefill=False):
        s = input_ids.shape[1]
        if position_ids is None:
            position_ids = torch.arange(s, device=input_ids.device)[None]
        # positions past the table only occur on discarded columns (dummy
        # slots, a chunk's overshoot past a row's budget); clamping keeps
        # their lookup in bounds instead of faulting the device
        position_ids = position_ids.clamp(0, self.wpe.num_embeddings - 1)
        x = self.wte(input_ids) + self.wpe(position_ids)
        for i, block in enumerate(self.h):
            x = block(x, None if pools is None else pools[i], tables, lens,
                      prefill)
        return self.ln_f(x)


class GPTForCausalLM(nn.Module):
    """GPT with the LM head tied to wte (or an untied bias-free head).

    ``device`` defaults to CUDA and raises when no card is present; pass
    ``device="cpu"`` for the plain PyTorch path. Weights are drawn from a
    ``torch.Generator`` seeded with ``seed`` using the JAX package's init:
    Normal(initializer_range) for wte and the qkv/up projections, the
    same scaled by 1/sqrt(2 * num_layers) for the out/down projections,
    Normal(0, 1) for wpe, zeros for biases and ones for LayerNorm gains."""

    def __init__(self, config: GPTConfig, device=None, dtype=None,
                 seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        dtype = dtype or getattr(torch, config.param_dtype)
        self.config = config
        self.gpt = GPTModel(config, dev, dtype)
        if not config.tie_word_embeddings:
            self.lm_head = nn.Linear(config.hidden_size, config.vocab_size,
                                     bias=False, device=dev, dtype=dtype)
        self.reset_parameters(torch.Generator(device=dev).manual_seed(seed))
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.gpt.wte.weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.gpt.wte.weight.dtype

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        cfg = self.config
        std = cfg.initializer_range
        deep = std / math.sqrt(2 * cfg.num_layers)
        for name, p in self.named_parameters():
            if name.endswith(".bias"):
                p.zero_()
            elif ".ln_" in name:
                p.fill_(1.0)
            elif name == "gpt.wpe.weight":
                p.normal_(0.0, 1.0, generator=generator)
            elif name.endswith(("attn.out.weight", "mlp.down.weight")):
                p.normal_(0.0, deep, generator=generator)
            else:
                p.normal_(0.0, std, generator=generator)

    def forward(self, input_ids, position_ids=None, pools=None, tables=None,
                lens=None, prefill=False):
        x = self.gpt(input_ids, position_ids, pools, tables, lens, prefill)
        if self.config.tie_word_embeddings:
            return x @ self.gpt.wte.weight.t()
        return self.lm_head(x)

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
        the first token sampled from each row's last real position."""
        _unported(weight_dtype, start)
        dev = self.device
        ids = _on(input_ids, torch.int64, dev)
        b, p_cap = ids.shape
        lens = _coerce_prompt_lens(prompt_lens, p_cap, "prefill_paged", dev)
        tables = _on(block_tables, torch.int32, dev)
        if tables.shape[0] != b:
            raise ValueError(f"prefill_paged: block_tables rows "
                             f"({tables.shape[0]}) != batch ({b})")
        _check_pool_dtype(pools, self.dtype, cache_dtype)
        logits = self.forward(ids, pools=pools, tables=tables, lens=lens,
                              prefill=True)
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
        _unported(weight_dtype, None)
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
                                  pools=pools, tables=tables, lens=ln)
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


def _unported(weight_dtype, start):
    if weight_dtype is not None:
        raise NotImplementedError(
            f"weight_dtype={weight_dtype!r}: the weight-only int8 GEMM "
            f"(int8_matmul) is ported with the static-decode slice")
    if start is not None:
        raise NotImplementedError(
            "start= (suffix prefill) needs the multi-token paged kernel, "
            "ported with the prefix-cache slice")


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
                      "GPTForCausalLM", "sample_logits"]
