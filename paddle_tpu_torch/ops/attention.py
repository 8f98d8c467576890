"""Attention ops (the port of paddle_tpu/ops/attention.py): the plain
reference, the training entry points `functional_attention` and
`scaled_dot_product_attention`, the padding-mask helpers of BERT's
masked route, and the paged GPT serving ops.

Layout follows the JAX package: [batch, seq, num_heads, head_dim]. The
paged KV cache is one [num_blocks, block, H, D] pool per layer (int8 pools:
codes [NB, bs, H, D] plus f32 scales [NB, bs, H]); each request owns the
blocks its int32 table row names, and block 0 is the trash block that
padding entries and out-of-budget writes land in.

Unlike the JAX functions, the cache writes update the pools IN PLACE (the
pools are preallocated device tensors, which replaces JAX's buffer
donation) and return them for convenience.

The routers (`paged_attention`, `paged_prefix_attention` and their int8
forms) route by device and by nothing else: a CUDA tensor goes to the
hand-written kernel (ops/cuda/paged_attention.py), which launches or
raises; a CPU tensor goes to the plain PyTorch version here.
"""
from __future__ import annotations

import math

import torch

from .cuda.paged_attention import (paged_attention_cuda,
                                   paged_attention_q8_cuda,
                                   paged_prefix_attention_cuda,
                                   paged_prefix_attention_q8_cuda)

_NEG_F32 = -1e30
_NEG_LOW = -3e38


def attention_reference(q, k, v, mask=None, is_causal=False, scale=None,
                        score_dtype=None, dropout_p=0.0, generator=None):
    """Plain attention on [B, S, H, D] with f32 accumulation.

    score_dtype: dtype the [B, H, Sq, Sk] logits/probabilities are rounded
    to (the JAX package stores them in the model dtype on the serving
    path); the max, sum and both contractions stay f32. `mask` is a bool
    keep-mask or an additive float mask broadcastable to [B, H, Sq, Sk].
    The causal mask is aligned bottom-right (query i of s_q sees keys <=
    i + s_k - s_q). dropout_p > 0 drops probabilities with a mask drawn
    from `generator` and rescales the kept ones by 1 / (1 - p)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    dt = q.dtype
    sdt = torch.float32 if score_dtype is None else score_dtype
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    logits = (logits * scale).to(sdt)
    neg = torch.tensor(_NEG_F32 if sdt == torch.float32 else _NEG_LOW,
                       dtype=sdt, device=q.device)
    if is_causal:
        s_q, s_k = logits.shape[-2], logits.shape[-1]
        cmask = torch.ones((s_q, s_k), dtype=torch.bool,
                           device=q.device).tril(s_k - s_q)
        logits = torch.where(cmask, logits, neg)
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = torch.where(mask, logits, neg)
        else:
            logits = (logits.float() + mask.float()).to(sdt)
    if sdt == torch.float32:
        probs = torch.softmax(logits, dim=-1)
    else:
        m = logits.float().amax(dim=-1, keepdim=True)
        p = torch.exp(logits.float() - m).to(sdt)
        denom = p.float().sum(dim=-1, keepdim=True)
        probs = (p.float() / denom).to(sdt)
    if dropout_p > 0.0:
        keep = torch.rand(probs.shape, generator=generator,
                          device=probs.device) < 1.0 - dropout_p
        probs = torch.where(keep, probs / (1.0 - dropout_p),
                            torch.zeros((), dtype=probs.dtype,
                                        device=probs.device))
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(dt).float(),
                        v.float()).to(dt)


def _use_flash(q_shape, head_dim) -> bool:
    """The JAX routing predicate minus its platform test: head dims in
    whole sublanes and the sequence in 128-row blocks. On a CUDA tensor the
    routed call launches the kernel or raises."""
    return head_dim % 8 == 0 and q_shape[1] % 128 == 0


def functional_attention(q, k, v, *, is_causal=False, scale=None, mask=None,
                         score_dtype=None):
    """Differentiable attention on [B, S, H, D] for model code: flash
    attention (`ops.flash_attention`) where the routing predicate holds and
    no mask is given; non-causal self-attention with s >= 512 and s % 128
    != 0 pads q, k and v to the next 128 rows and masks the padded keys
    (kv_len), slicing the padded query rows off; otherwise the plain
    reference. Note the reference aligns a causal mask bottom-right and
    the flash route top-left; they agree when s_q == s_k."""
    from . import flash_attention as FA
    if mask is None and _use_flash(tuple(q.shape), q.shape[-1]):
        return FA.flash_attention(q, k, v, causal=is_causal, scale=scale)
    s = q.shape[1]
    pad = (-s) % 128
    if (mask is None and not is_causal and pad and s >= 512
            and q.shape[1] == k.shape[1]
            and _use_flash((q.shape[0], s + pad), q.shape[-1])):
        q, k, v = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
                   for t in (q, k, v))
        out = FA.flash_attention(q, k, v, causal=False, scale=scale,
                                 kv_len=s)
        return out[:, :s]
    return attention_reference(q, k, v, mask=mask, is_causal=is_causal,
                               scale=scale, score_dtype=score_dtype)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, scale=None, score_dtype=None,
                                 generator=None):
    """Tensor-level entry point: flash attention when there is no mask,
    no live dropout and the routing predicate holds; otherwise the
    reference, which applies attention dropout (in training) with masks
    drawn from `generator`."""
    from . import flash_attention as FA
    if (attn_mask is None and (dropout_p == 0.0 or not training)
            and _use_flash(tuple(query.shape), query.shape[-1])):
        return FA.flash_attention(query, key, value, causal=is_causal,
                                  scale=scale)
    return attention_reference(query, key, value, mask=attn_mask,
                               is_causal=is_causal, scale=scale,
                               score_dtype=score_dtype,
                               dropout_p=dropout_p if training else 0.0,
                               generator=generator)


def key_padding_mask(mask):
    """A 2-D [B, Sk] padding mask as attention takes it, [B, 1, 1, Sk]: a
    float mask stays additive, an integer or bool one becomes the bool
    keep-mask ``mask > 0`` (BERT's masked route). Other ranks pass as
    they are."""
    if mask is None or mask.dim() != 2:
        return mask
    if mask.is_floating_point():
        return mask[:, None, None, :]
    return (mask > 0)[:, None, None, :]


def lens_to_mask(lens, s):
    """Per-row valid lengths [B] of a right-padded batch as a 0/1 int32
    keep-mask [B, s] (column < lens[b])."""
    cols = torch.arange(s, device=lens.device)
    return (cols[None, :] < lens.long()[:, None]).to(torch.int32)


def static_cache_mask(kv_capacity, s, pos, prompt_lens=None,
                      prefill_cap=None, device=None):
    """Bool keep-mask for fixed-buffer decode: [1, 1, s, L] (query row i at
    global position pos + i sees columns <= pos + i); with prompt_lens [B]
    and prefill_cap, columns in [prompt_lens[b], prefill_cap) of row b are
    right-padding garbage and are masked too ([B, 1, s, L])."""
    if device is None and prompt_lens is not None:
        device = prompt_lens.device
    col = torch.arange(kv_capacity, device=device)[None, None, None, :]
    row = torch.arange(s, device=device)[None, None, :, None]
    keep = col <= (int(pos) + row)
    if prompt_lens is not None:
        pl = prompt_lens.to(torch.int64)[:, None, None, None]
        keep = keep & ((col < pl) | (col >= prefill_cap))
    return keep


def paged_prefill_mask(s, lens):
    """[B, 1, S, S] keep-mask for prompt self-attention over a right-padded
    ragged batch: causal AND key column < the row's true length."""
    return static_cache_mask(s, s, 0, prompt_lens=lens, prefill_cap=s)


# ----------------------------------------------------- static KV-cache ops

def static_cache_update(buf, new, pos):
    """Write `new` [B, s, ...] into the fixed buffer [B, L_max, ...] at row
    cursor `pos`, in place, and return the buffer. Any rank >= 2 with the
    row cursor on axis 1 (the int8 cache keeps its scales in [B, L_max,
    H]). `pos` is always concrete here, so overflow raises, as the eager
    JAX path does."""
    p = int(pos)
    if p + new.shape[1] > buf.shape[1]:
        raise ValueError(f"static KV cache overflow: pos {p} + "
                         f"{new.shape[1]} new rows > L_max {buf.shape[1]}")
    buf[:, p:p + new.shape[1]] = new.to(buf.dtype)
    return buf


def static_cache_update_q8(codes_buf, scale_buf, new, pos):
    """Quantize `new` K/V rows to int8 and write codes and scales at `pos`,
    in place."""
    codes, scale = quantize_kv(new)
    return (static_cache_update(codes_buf, codes, pos),
            static_cache_update(scale_buf, scale, pos))


def dequantize_kv(codes, scale, dtype):
    """codes int8 [B, L, H, D] * scale [B, L, H] -> [B, L, H, D] `dtype`."""
    return (codes.float() * scale[..., None].float()).to(dtype)


# ------------------------------------------------ int8 KV quantization

def quantize_kv(new):
    """Symmetric per-(batch, position, head) int8 quantization:
    new [B, s, H, D] -> (codes int8 [B, s, H, D], scale f32 [B, s, H])."""
    f = new.float()
    scale = f.abs().amax(dim=-1).clamp_min(1e-8) / 127.0
    codes = torch.round(f / scale[..., None]).clamp(-127, 127)
    return codes.to(torch.int8), scale


def attention_q8_cache(q, k_codes, k_scale, v_codes, v_scale, mask):
    """Attention over an int8 cache with the scales factored out of both
    contractions: q·(c_k·s_k) = (q·c_k)·s_k and Σ p·(s_v·c_v) =
    Σ (p·s_v)·c_v, so the codes enter the products widened, never
    dequantized. Softmax in f32; the scaled probabilities round to q's
    dtype as in the JAX package."""
    dt = q.dtype
    att_scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          k_codes.to(dt).float())
    ks = k_scale.permute(0, 2, 1)[:, :, None, :]          # [B, H, 1, L]
    logits = logits * (ks * att_scale)
    logits = torch.where(mask, logits,
                         torch.tensor(_NEG_F32, device=logits.device))
    probs = torch.softmax(logits, dim=-1)
    vs = v_scale.permute(0, 2, 1)[:, :, None, :]
    probs = (probs * vs).to(dt)
    return torch.einsum("bhqk,bkhd->bqhd", probs.float(),
                        v_codes.to(dt).float()).to(dt)


# ------------------------------------------------- paged KV cache writes

def paged_cache_write(pool, new, tables, lens):
    """Write one decode-step row per batch entry, in place.

    pool [NB, bs, ...]; new [B, 1, ...]; tables [B, MB] int32; lens [B] =
    tokens already cached, so row b's token lands at position lens[b]:
    block tables[b, lens[b] // bs] (slot index clipped to the table width,
    as the JAX gather clips), offset lens[b] % bs."""
    nb, bs = pool.shape[0], pool.shape[1]
    li = lens.to(torch.int64)
    slot = (li // bs).clamp(0, tables.shape[1] - 1)
    bidx = torch.gather(tables.to(torch.int64), 1, slot[:, None])[:, 0]
    dest = bidx * bs + li % bs
    flat = pool.view((nb * bs,) + tuple(pool.shape[2:]))
    flat[dest] = new[:, 0].to(pool.dtype)
    return pool


def paged_prefill_write(pool, new, tables, start=None):
    """Write a whole right-padded prompt's rows into pool blocks, in place.

    new [B, S, ...]; position p of row b goes to block tables[b, p // bs],
    offset p % bs. Positions past the table width go to the trash block
    (never clipped into the last entry, where a pad column could share a
    destination with a real one); padding inside the row's reservation is
    garbage the masks exclude until decode overwrites it.

    `start` [B] int32 (suffix prefill, chunked prefill, spec verify)
    offsets row b's positions to start[b] + p, after its cached prefix."""
    nb, bs = pool.shape[0], pool.shape[1]
    b, s = new.shape[0], new.shape[1]
    pos = torch.arange(s, device=pool.device)[None, :].expand(b, s)
    if start is not None:
        pos = pos + start.to(device=pool.device, dtype=torch.int64)[:, None]
    slot = pos // bs
    bidx = torch.gather(tables.to(torch.int64), 1,
                        slot.clamp(max=tables.shape[1] - 1))
    bidx = torch.where(slot >= tables.shape[1], 0, bidx)
    dest = (bidx * bs + pos % bs).reshape(-1)
    flat = pool.view((nb * bs,) + tuple(pool.shape[2:]))
    flat[dest] = new.reshape((b * s,) + tuple(new.shape[2:])).to(pool.dtype)
    return pool


def paged_cache_write_q8(codes_pool, scale_pool, new, tables, lens):
    """Quantize one decode-step row per batch entry and write codes and
    scales in place (the int8 form of paged_cache_write)."""
    codes, scale = quantize_kv(new)
    paged_cache_write(codes_pool, codes, tables, lens)
    paged_cache_write(scale_pool, scale, tables, lens)
    return codes_pool, scale_pool


def paged_prefill_write_q8(codes_pool, scale_pool, new, tables,
                           start=None):
    """Quantize a padded prompt (or suffix) projection and write codes and
    scales in place (the int8 form of paged_prefill_write)."""
    codes, scale = quantize_kv(new)
    paged_prefill_write(codes_pool, codes, tables, start)
    paged_prefill_write(scale_pool, scale, tables, start)
    return codes_pool, scale_pool


# ------------------------------------------------ paged decode attention

def _paged_gather(pool, tables):
    """Gather each row's blocks into a contiguous [B, MB*bs, ...] view."""
    b, mb = tables.shape
    bs = pool.shape[1]
    g = pool.index_select(0, tables.reshape(-1).to(torch.int64))
    return g.reshape((b, mb * bs) + tuple(pool.shape[2:]))


def _decode_mask(width, lens):
    col = torch.arange(width, device=lens.device)[None, None, None, :]
    return col < lens.to(torch.int64)[:, None, None, None]


def _zero_empty_rows(out, lens):
    """Rows with nothing to attend (lens == 0) are zeros."""
    return torch.where((lens > 0)[:, None, None, None], out,
                       torch.zeros((), dtype=out.dtype, device=out.device))


def paged_attention_reference(q, k_pool, v_pool, tables, lens, *,
                              scale=None, score_dtype=None):
    """Plain version of the paged decode kernel: gather the table's blocks,
    mask columns >= lens[b], attend. q [B, 1, H, D]; lens = attendable
    rows (callers pass tokens-in-cache + 1). Rows with lens == 0 give
    zeros, as the kernel does."""
    if q.shape[1] != 1:
        raise ValueError(f"paged_attention_reference serves single-token "
                         f"decode; got q seq len {q.shape[1]}")
    k = _paged_gather(k_pool, tables)
    v = _paged_gather(v_pool, tables)
    out = attention_reference(q, k, v, mask=_decode_mask(k.shape[1], lens),
                              scale=scale, score_dtype=score_dtype)
    return _zero_empty_rows(out, lens)


def paged_attention_reference_q8(q, kc_pool, ks_pool, vc_pool, vs_pool,
                                 tables, lens):
    """Plain version of the int8 paged decode kernel (gather codes and
    scales, then attention_q8_cache); lens == 0 rows are zeros."""
    if q.shape[1] != 1:
        raise ValueError(f"paged_attention_reference_q8 serves "
                         f"single-token decode; got q seq len {q.shape[1]}")
    kc = _paged_gather(kc_pool, tables)
    ks = _paged_gather(ks_pool, tables)
    vc = _paged_gather(vc_pool, tables)
    vs = _paged_gather(vs_pool, tables)
    out = attention_q8_cache(q, kc, ks, vc, vs,
                             _decode_mask(kc.shape[1], lens))
    return _zero_empty_rows(out, lens)


def _on_cuda(q) -> bool:
    if q.device.type == "cuda":
        return True
    if q.device.type == "cpu":
        return False
    raise ValueError(f"the port's kernels run on CUDA or CPU tensors; got "
                     f"{q.device}")


def paged_attention(q, k_pool, v_pool, tables, lens, *, scale=None,
                    score_dtype=None):
    """Paged decode attention: the CUDA kernel for CUDA tensors (f32
    scores whatever `score_dtype` says, like the TPU kernel), the plain
    version for CPU tensors."""
    if _on_cuda(q):
        return paged_attention_cuda(q, k_pool, v_pool, tables, lens,
                                    scale=scale)
    return paged_attention_reference(q, k_pool, v_pool, tables, lens,
                                     scale=scale, score_dtype=score_dtype)


def paged_attention_q8(q, kc_pool, ks_pool, vc_pool, vs_pool, tables, lens):
    """int8 paged decode attention, routed like paged_attention."""
    if _on_cuda(q):
        return paged_attention_q8_cuda(q, kc_pool, ks_pool, vc_pool,
                                       vs_pool, tables, lens)
    return paged_attention_reference_q8(q, kc_pool, ks_pool, vc_pool,
                                        vs_pool, tables, lens)


# ------------------------------------ multi-token (prefix) paged attention

def paged_prefix_mask(s, width, start):
    """[B, 1, S, width] keep-mask for a query window over a paged pool:
    query row i of batch row b sits at global position start[b] + i and
    sees pool columns <= its own position (causal over the cached prefix
    plus the window itself)."""
    col = torch.arange(width, device=start.device)[None, None, None, :]
    row = torch.arange(s, device=start.device)[None, None, :, None]
    return col <= (start.to(torch.int64)[:, None, None, None] + row)


def paged_prefix_attention_reference(q, k_pool, v_pool, tables, start, *,
                                     scale=None, score_dtype=None):
    """Plain version of the multi-token paged kernel: q [B, S, H, D] holds
    S query tokens per row at global positions start[b] + i; the pools
    already hold the cached prefix and the window's own K/V. Gathers the
    table's blocks and attends under `paged_prefix_mask`. Padded query
    rows produce garbage the caller drops."""
    k = _paged_gather(k_pool, tables)
    v = _paged_gather(v_pool, tables)
    mask = paged_prefix_mask(q.shape[1], k.shape[1], start)
    return attention_reference(q, k, v, mask=mask, scale=scale,
                               score_dtype=score_dtype)


def paged_prefix_attention_reference_q8(q, kc_pool, ks_pool, vc_pool,
                                        vs_pool, tables, start):
    """Plain version of the int8 multi-token paged kernel (gather codes
    and scales, then attention_q8_cache under `paged_prefix_mask`)."""
    kc = _paged_gather(kc_pool, tables)
    ks = _paged_gather(ks_pool, tables)
    vc = _paged_gather(vc_pool, tables)
    vs = _paged_gather(vs_pool, tables)
    mask = paged_prefix_mask(q.shape[1], kc.shape[1], start)
    return attention_q8_cache(q, kc, ks, vc, vs, mask)


def paged_prefix_attention(q, k_pool, v_pool, tables, start, *, scale=None,
                           score_dtype=None):
    """Ragged multi-token paged attention (suffix prefill, chunked
    prefill, speculative verify; S = 1 with start at the token's own
    position is decode): the CUDA kernel for CUDA tensors (f32 scores,
    whatever `score_dtype` says), the plain version for CPU tensors."""
    if _on_cuda(q):
        return paged_prefix_attention_cuda(q, k_pool, v_pool, tables, start,
                                           scale=scale)
    return paged_prefix_attention_reference(q, k_pool, v_pool, tables,
                                            start, scale=scale,
                                            score_dtype=score_dtype)


def paged_prefix_attention_q8(q, kc_pool, ks_pool, vc_pool, vs_pool,
                              tables, start):
    """int8 multi-token paged attention, routed like
    paged_prefix_attention."""
    if _on_cuda(q):
        return paged_prefix_attention_q8_cuda(q, kc_pool, ks_pool, vc_pool,
                                              vs_pool, tables, start)
    return paged_prefix_attention_reference_q8(q, kc_pool, ks_pool, vc_pool,
                                               vs_pool, tables, start)
