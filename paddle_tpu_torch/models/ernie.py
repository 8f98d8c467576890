"""ERNIE in PyTorch (the port of paddle_tpu/models/ernie.py): the BERT
encoder of `models.bert` plus a task-type embedding table, with the
sequence-classification head and the MLM head tied to the word
embeddings.

Module and parameter names mirror the JAX package (``ernie.embeddings``,
``ernie.task_type_embeddings``, ``ernie.layers.{i}``, ``ernie.pooler``), so
`convert.model_state_from_paddle` maps a JAX state dict across by name.
As in the JAX model, the task-type embedding is added AFTER the
embeddings' LayerNorm and dropout (published ERNIE adds it before the
LayerNorm); the port follows its reference. Attention takes BERT's routes
(`models.bert`): the fused short-sequence MHA (kernel #9 on CUDA) without
a mask, the reference attention with one; `ErnieForMaskedLM.loss` runs
the tied decoder inside the fused linear cross-entropy (kernel #11 on
CUDA where `use_linear_ce` holds).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ..incubate.nn.functional import fused_linear_cross_entropy
from .bert import (BertConfig, BertEmbeddings, BertLayer, BertPooler,
                   _BertHead, _Dropout, _tied_logits)
from .gpt import _masked_mean

__all__ = ["ErnieConfig", "ErnieModel", "ErnieForSequenceClassification",
           "ErnieForMaskedLM", "ernie_config", "PRESETS"]


@dataclass
class ErnieConfig(BertConfig):
    vocab_size: int = 18000
    use_task_id: bool = True
    task_type_vocab_size: int = 3


PRESETS = {
    "ernie-1.0": dict(vocab_size=18000, hidden_size=768, num_layers=12,
                      num_heads=12, max_position_embeddings=513),
    "ernie-3.0-medium": dict(vocab_size=40000, hidden_size=768, num_layers=6,
                             num_heads=12, max_position_embeddings=2048),
    "ernie-tiny": dict(vocab_size=18000, hidden_size=312, num_layers=4,
                       num_heads=12, max_position_embeddings=512,
                       intermediate_size=1248),
}


def ernie_config(preset: str, **overrides) -> ErnieConfig:
    cfg = dict(PRESETS[preset])
    cfg.update(overrides)
    return ErnieConfig(**cfg)


class ErnieModel(_BertHead):
    """Encoder trunk: BERT embeddings, the task-type embeddings, N BERT
    layers and the pooler; returns (sequence output, pooled output).
    ``device`` defaults to CUDA and raises when no card is present; pass
    ``device="cpu"`` for the plain PyTorch path. Weights (BERT's init) and
    the ``dropout_generator`` draw from ``seed``; the model starts in
    eval() mode."""

    def __init__(self, config: ErnieConfig, device=None, dtype=None,
                 seed: int = 0):
        super().__init__()
        dev, dtype = self._setup(config, device, dtype)
        self.config = config
        kw = dict(device=dev, dtype=dtype)
        self.embeddings = BertEmbeddings(config, **kw)
        if config.use_task_id:
            self.task_type_embeddings = nn.Embedding(
                config.task_type_vocab_size, config.hidden_size, **kw)
        self.layers = nn.ModuleList([BertLayer(config, **kw)
                                     for _ in range(config.num_layers)])
        self.pooler = BertPooler(config, **kw)
        self._generator = torch.Generator(device=dev)
        self._finish(seed)

    def _bert(self):
        return self

    @property
    def dropout_generator(self) -> torch.Generator:
        return self._generator

    def _dropout(self):
        """The train()-mode dropout, or None in eval()."""
        if not self.training:
            return None
        return _Dropout(self._generator, self.config.hidden_dropout)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None, task_type_ids=None):
        drop = self._dropout()
        h = self.embeddings(input_ids, token_type_ids, position_ids, drop)
        if self.config.use_task_id:
            if task_type_ids is None:
                task_type_ids = torch.zeros_like(input_ids)
            h = h + self.task_type_embeddings(task_type_ids)
        for layer in self.layers:
            h = layer(h, attention_mask, None, drop)
        return h, self.pooler(h)


class ErnieForSequenceClassification(_BertHead):
    """ERNIE with a classifier on the pooled output (dropped at
    `dropout`, the config's hidden_dropout by default, in train() mode).
    Device, dtype and seed as `ErnieModel`."""

    def __init__(self, config: ErnieConfig, num_classes: int = 2,
                 dropout: Optional[float] = None, device=None, dtype=None,
                 seed: int = 0):
        super().__init__()
        dev, dtype = self._setup(config, device, dtype)
        self.config = config
        self.ernie = ErnieModel(config, device=dev, dtype=dtype, seed=seed)
        self.dropout_p = config.hidden_dropout if dropout is None \
            else dropout
        self.classifier = nn.Linear(config.hidden_size, num_classes,
                                    device=dev, dtype=dtype)
        self._finish(seed)

    def _bert(self):
        return self.ernie

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None, task_type_ids=None):
        _, pooled = self.ernie(input_ids, token_type_ids, position_ids,
                               attention_mask, task_type_ids)
        if self.training:
            pooled = _Dropout(self.dropout_generator, self.dropout_p)(pooled)
        return self.classifier(pooled)


class ErnieForMaskedLM(_BertHead):
    """ERNIE with logits tied to the word embeddings (no transform, as in
    the JAX model) and the fused MLM loss. Device, dtype and seed as
    `ErnieModel`."""

    def __init__(self, config: ErnieConfig, device=None, dtype=None,
                 seed: int = 0):
        super().__init__()
        dev, dtype = self._setup(config, device, dtype)
        self.config = config
        self.ernie = ErnieModel(config, device=dev, dtype=dtype, seed=seed)
        self._finish(seed)

    def _bert(self):
        return self.ernie

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None, task_type_ids=None):
        h, _ = self.ernie(input_ids, token_type_ids, position_ids,
                          attention_mask, task_type_ids)
        return _tied_logits(h, self.ernie.embeddings.word_embeddings.weight)

    def loss(self, input_ids, labels, token_type_ids=None, position_ids=None,
             attention_mask=None, task_type_ids=None, loss_mask=None,
             chunk_size: int = 256, ignore_index: int = -100):
        """Fused MLM loss: the tied decoder runs inside the fused linear
        cross-entropy, so the [B, S, vocab] logits never exist. Positions
        labelled `ignore_index` are masked out, and so are those where
        `loss_mask` is 0."""
        h, _ = self.ernie(input_ids, token_type_ids, position_ids,
                          attention_mask, task_type_ids)
        w = self.ernie.embeddings.word_embeddings.weight
        safe = torch.where(labels == ignore_index, torch.zeros_like(labels),
                           labels)
        per_tok = fused_linear_cross_entropy(h, w, safe,
                                             chunk_size=chunk_size)
        mask = (labels != ignore_index).float()
        if loss_mask is not None:
            mask = mask * loss_mask.float()
        return _masked_mean(per_tok, mask)
