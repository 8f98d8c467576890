"""BERT in PyTorch (the port of paddle_tpu/models/bert.py): the encoder,
the MLM, sequence-classification and pretraining heads, and the fused MLM
training loss.

Module and parameter names mirror the JAX package
(``bert.embeddings.word_embeddings.weight``,
``bert.encoder.{i}.attention.qkv.weight``, ...), so
`paddle_tpu_torch.convert.model_state_from_paddle` maps a JAX state dict
across by name; the mpu projections become ``nn.Linear`` (weights stored
``[out, in]``) and the qkv columns keep their ``[q heads | k heads | v
heads]`` order. The MLM decoder is tied to the word embeddings.

Attention takes one of three routes, as in the JAX model:
  * ``seq_lens`` (per-row lengths of a right-padded batch) and no mask:
    the fused short-sequence MHA (`ops.fused_mha`, kernel #9 on CUDA)
    with the lengths as its per-row key mask;
  * no mask: the fused MHA on the packed projection output;
  * an ``attention_mask`` ([B, Sk] 0/1 keep or additive float), or a
    shape the fused gate refuses (then ``seq_lens`` become a keep-mask):
    the reference attention with bf16-stored scores in a bf16 model.
In ``train()`` mode hidden dropout (after the embedding LayerNorm, after
attention's output projection, after the MLP, on the pooled output of the
classifier) and attention-probability dropout run with masks and seeds
drawn from the model's ``dropout_generator``: the fused route draws one
int32 seed per call (kept on the device) and the kernel draws the mask
from it. LayerNorm is `nn.layers.LayerNorm` (torch's, or the fused
LayerNorm #8 under PADDLE_TPU_FUSED_LN=1) and GELU the tanh form,
computed outside the attention kernels as the JAX package computes them
outside Pallas.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..incubate.nn.functional import _drop, fused_linear_cross_entropy
from ..nn.layers import LayerNorm
from ..ops.attention import (attention_reference, functional_attention,
                             key_padding_mask, lens_to_mask)
from ..ops.fused_mha import fused_mha, use_fused_mha
from .gpt import _masked_mean

__all__ = ["BertConfig", "BertModel", "BertForMaskedLM",
           "BertForSequenceClassification", "BertForPretraining",
           "bert_config", "PRESETS"]


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: Optional[int] = None
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    layer_norm_epsilon: float = 1e-12
    initializer_range: float = 0.02
    pad_token_id: int = 0
    num_labels: int = 2
    param_dtype: str = "float32"

    def __post_init__(self):
        if self.intermediate_size is None:
            self.intermediate_size = 4 * self.hidden_size
        if self.hidden_size % self.num_heads != 0:
            raise ValueError(f"hidden_size {self.hidden_size} is not a "
                             f"multiple of num_heads {self.num_heads}")

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads


PRESETS = {
    "bert-base": dict(hidden_size=768, num_layers=12, num_heads=12),
    "bert-large": dict(hidden_size=1024, num_layers=24, num_heads=16),
}


def bert_config(preset: str, **overrides) -> BertConfig:
    cfg = dict(PRESETS[preset])
    cfg.update(overrides)
    return BertConfig(**cfg)


class _Dropout:
    """Inverted dropout and attention seeds from one generator: keep with
    probability 1 - p (a draw from `generator`), kept entries scaled by
    1 / (1 - p)."""

    def __init__(self, generator: torch.Generator, p: float):
        self.generator, self.p = generator, p

    def __call__(self, x):
        return _drop(x, self.p, self.generator)

    def seed(self, device):
        """One int32 seed on the device for the fused kernel's mask."""
        return torch.randint(0, 2 ** 31 - 1, (1,), generator=self.generator,
                             device=device, dtype=torch.int32)


class BertEmbeddings(nn.Module):
    def __init__(self, config: BertConfig, device=None, dtype=None):
        super().__init__()
        h = config.hidden_size
        kw = dict(device=device, dtype=dtype)
        self.word_embeddings = nn.Embedding(config.vocab_size, h, **kw)
        self.position_embeddings = nn.Embedding(
            config.max_position_embeddings, h, **kw)
        self.token_type_embeddings = nn.Embedding(config.type_vocab_size, h,
                                                  **kw)
        self.layer_norm = LayerNorm(h, eps=config.layer_norm_epsilon, **kw)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                drop=None):
        s = input_ids.shape[1]
        if position_ids is None:
            position_ids = torch.arange(s, device=input_ids.device)[None]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = (self.word_embeddings(input_ids)
             + self.position_embeddings(position_ids)
             + self.token_type_embeddings(token_type_ids))
        x = self.layer_norm(x)
        return x if drop is None else drop(x)


class BertAttention(nn.Module):
    """Bidirectional fused-QKV attention with an optional padding mask or
    per-row lengths (see the module docstring for the routes)."""

    def __init__(self, config: BertConfig, device=None, dtype=None):
        super().__init__()
        self.num_heads = config.num_heads
        self.head_dim = config.head_dim
        h = config.hidden_size
        self.qkv = nn.Linear(h, 3 * h, device=device, dtype=dtype)
        self.out = nn.Linear(h, h, device=device, dtype=dtype)
        self.attn_dropout_p = config.attention_dropout

    def forward(self, x, attention_mask=None, seq_lens=None, drop=None):
        nh, hd = self.num_heads, self.head_dim
        qkv = self.qkv(x)
        b, s = qkv.shape[0], qkv.shape[1]
        attn_p = self.attn_dropout_p if drop is not None else 0.0
        fused = use_fused_mha(s, nh, hd)
        if attention_mask is None and fused:
            # per-row lengths go to the kernel's key mask; the padded query
            # rows attend the valid keys and the loss masks them out
            seed = drop.seed(qkv.device) if attn_p > 0.0 else None
            ctx = fused_mha(qkv, nh, kv_len=seq_lens, dropout_p=attn_p,
                            dropout_seed=seed)
        else:
            if seq_lens is not None:
                # the lengths' keep-mask takes the place of any mask given
                attention_mask = lens_to_mask(
                    torch.as_tensor(seq_lens, device=qkv.device), s)
            a = qkv.reshape(b, s, 3, nh, hd)
            q, k, v = a[:, :, 0], a[:, :, 1], a[:, :, 2]
            mask = key_padding_mask(attention_mask)
            # a bf16 model stores the [S, S] scores in bf16 (f32 dots and
            # softmax statistics), as the JAX model does
            if attn_p == 0.0:
                o = functional_attention(q, k, v, is_causal=False, mask=mask,
                                         score_dtype=q.dtype)
            else:
                o = attention_reference(q, k, v, mask=mask, dropout_p=attn_p,
                                        generator=drop.generator,
                                        score_dtype=q.dtype)
            ctx = o.reshape(b, s, nh * hd)
        y = self.out(ctx)
        return y if drop is None else drop(y)


class BertLayer(nn.Module):
    """Post-LN encoder block (original BERT ordering)."""

    def __init__(self, config: BertConfig, device=None, dtype=None):
        super().__init__()
        h, m, eps = (config.hidden_size, config.intermediate_size,
                     config.layer_norm_epsilon)
        kw = dict(device=device, dtype=dtype)
        self.attention = BertAttention(config, **kw)
        self.ln_1 = LayerNorm(h, eps=eps, **kw)
        self.up = nn.Linear(h, m, **kw)
        self.down = nn.Linear(m, h, **kw)
        self.ln_2 = LayerNorm(h, eps=eps, **kw)

    def forward(self, x, attention_mask=None, seq_lens=None, drop=None):
        x = self.ln_1(x + self.attention(x, attention_mask, seq_lens, drop))
        y = self.down(F.gelu(self.up(x), approximate="tanh"))
        if drop is not None:
            y = drop(y)
        return self.ln_2(x + y)


def _tied_logits(h, wte):
    """Logits against the tied word-embedding table [V, H]."""
    return torch.einsum("bsh,vh->bsv", h, wte)


class BertPooler(nn.Module):
    def __init__(self, config: BertConfig, device=None, dtype=None):
        super().__init__()
        self.dense = nn.Linear(config.hidden_size, config.hidden_size,
                               device=device, dtype=dtype)

    def forward(self, x):
        return torch.tanh(self.dense(x[:, 0]))


class BertModel(nn.Module):
    """Backbone: embeddings + encoder + pooler. Holds the
    ``dropout_generator`` the heads' train() mode draws from. ``device``
    defaults to CUDA and raises when no card is present (the heads pass
    theirs)."""

    def __init__(self, config: BertConfig, device=None, dtype=None):
        super().__init__()
        self.config = config
        device = resolve_device(device)
        kw = dict(device=device, dtype=dtype)
        self.embeddings = BertEmbeddings(config, **kw)
        self.encoder = nn.ModuleList([BertLayer(config, **kw)
                                      for _ in range(config.num_layers)])
        self.pooler = BertPooler(config, **kw)
        self.dropout_generator = torch.Generator(device=device)

    def _dropout(self):
        """The train()-mode dropout, or None in eval()."""
        if not self.training:
            return None
        return _Dropout(self.dropout_generator, self.config.hidden_dropout)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None, seq_lens=None):
        """Returns (sequence output, pooled output). seq_lens: per-row
        valid lengths [B] of a right-padded batch, the fused kernel's key
        mask (no [S, S] mask tensor)."""
        drop = self._dropout()
        x = self.embeddings(input_ids, token_type_ids, position_ids, drop)
        for layer in self.encoder:
            x = layer(x, attention_mask, seq_lens, drop)
        return x, self.pooler(x)


@torch.no_grad()
def _init_params(module: nn.Module, cfg, generator: torch.Generator):
    """The JAX package's init, drawn from `generator`: Normal(
    initializer_range) for the embeddings and the qkv/up projections, the
    same scaled by 1/sqrt(2 * num_layers) for the out/down projections,
    Xavier-uniform for the plain Linear layers (pooler, transform, heads),
    zero biases and unit LayerNorm gains."""
    std = cfg.initializer_range
    deep = std / math.sqrt(2 * max(1, cfg.num_layers))
    for name, p in module.named_parameters():
        if name.endswith(".bias"):
            p.zero_()
        elif ".ln" in name or "layer_norm" in name or name.startswith("ln"):
            p.fill_(1.0)
        elif name.endswith(("attention.out.weight", "down.weight")):
            p.normal_(0.0, deep, generator=generator)
        elif name.endswith(("_embeddings.weight", "qkv.weight",
                            "up.weight")):
            p.normal_(0.0, std, generator=generator)
        else:
            fan_out, fan_in = p.shape
            bound = math.sqrt(6.0 / (fan_in + fan_out))
            p.uniform_(-bound, bound, generator=generator)


class _BertHead(nn.Module):
    """Device, dtype, init and dropout seeding shared by the heads."""

    @staticmethod
    def _setup(config, device, dtype):
        return (resolve_device(device),
                dtype or getattr(torch, config.param_dtype))

    def _finish(self, seed):
        dev = next(self.parameters()).device
        _init_params(self, self.config,
                     torch.Generator(device=dev).manual_seed(seed))
        self.dropout_generator.manual_seed(seed)
        self.eval()

    @property
    def dropout_generator(self) -> torch.Generator:
        return self._bert().dropout_generator


class BertForMaskedLM(_BertHead):
    """BERT with the MLM head (transform -> GELU -> LayerNorm -> logits
    tied to the word embeddings). ``device`` defaults to CUDA and raises
    when no card is present; pass ``device="cpu"`` for the plain PyTorch
    path. Weights and dropout draw from ``seed``; the model starts in
    eval() mode."""

    def __init__(self, config: BertConfig, device=None, dtype=None,
                 seed: int = 0):
        super().__init__()
        dev, dtype = self._setup(config, device, dtype)
        self.config = config
        kw = dict(device=dev, dtype=dtype)
        self.bert = BertModel(config, **kw)
        self.transform = nn.Linear(config.hidden_size, config.hidden_size,
                                   **kw)
        self.ln = LayerNorm(config.hidden_size,
                               eps=config.layer_norm_epsilon, **kw)
        self._finish(seed)

    def _bert(self):
        return self.bert

    def _mlm_hidden(self, seq):
        """The MLM head pipeline shared by the logits and the fused loss."""
        return self.ln(F.gelu(self.transform(seq), approximate="tanh"))

    def mlm_logits(self, seq):
        return _tied_logits(self._mlm_hidden(seq),
                            self.bert.embeddings.word_embeddings.weight)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                seq_lens=None):
        seq, _ = self.bert(input_ids, token_type_ids,
                           attention_mask=attention_mask, seq_lens=seq_lens)
        return self.mlm_logits(seq)

    def loss(self, input_ids, labels, token_type_ids=None,
             attention_mask=None, loss_mask=None, chunk_size: int = 256,
             ignore_index: int = -100, seq_lens=None):
        """Fused MLM loss: the tied decoder runs inside the fused linear
        cross-entropy (kernel #11 on CUDA where `use_linear_ce` holds), so
        the [B, S, vocab] logits never exist. Positions labelled
        `ignore_index` are masked out, and so are those where `loss_mask`
        is 0."""
        seq, _ = self.bert(input_ids, token_type_ids,
                           attention_mask=attention_mask, seq_lens=seq_lens)
        h = self._mlm_hidden(seq)
        w = self.bert.embeddings.word_embeddings.weight
        safe = torch.where(labels == ignore_index, torch.zeros_like(labels),
                           labels)
        per_tok = fused_linear_cross_entropy(h, w, safe,
                                             chunk_size=chunk_size)
        mask = (labels != ignore_index).float()
        if loss_mask is not None:
            mask = mask * loss_mask.float()
        return _masked_mean(per_tok, mask)


class BertForSequenceClassification(_BertHead):
    def __init__(self, config: BertConfig, device=None, dtype=None,
                 seed: int = 0):
        super().__init__()
        dev, dtype = self._setup(config, device, dtype)
        self.config = config
        self.bert = BertModel(config, device=dev, dtype=dtype)
        self.classifier = nn.Linear(config.hidden_size, config.num_labels,
                                    device=dev, dtype=dtype)
        self._finish(seed)

    def _bert(self):
        return self.bert

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        _, pooled = self.bert(input_ids, token_type_ids,
                              attention_mask=attention_mask)
        drop = self.bert._dropout()
        if drop is not None:
            pooled = drop(pooled)
        return self.classifier(pooled)


class BertForPretraining(_BertHead):
    """MLM + NSP heads."""

    def __init__(self, config: BertConfig, device=None, dtype=None,
                 seed: int = 0):
        super().__init__()
        dev, dtype = self._setup(config, device, dtype)
        self.config = config
        self.mlm = BertForMaskedLM(config, device=dev, dtype=dtype, seed=seed)
        self.nsp = nn.Linear(config.hidden_size, 2, device=dev, dtype=dtype)
        self._finish(seed)

    def _bert(self):
        return self.mlm.bert

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        seq, pooled = self.mlm.bert(input_ids, token_type_ids,
                                    attention_mask=attention_mask)
        return self.mlm.mlm_logits(seq), self.nsp(pooled)
