from .gpt import GPTConfig, GPTForCausalLM, PRESETS, gpt_config, sample_logits
from .bert import (BertConfig, BertForMaskedLM, BertForPretraining,
                   BertForSequenceClassification, BertModel, bert_config)
from .vit import ViTConfig, VisionTransformer, vit_config

__all__ = ["GPTConfig", "GPTForCausalLM", "PRESETS", "gpt_config",
           "sample_logits", "BertConfig", "BertModel", "BertForMaskedLM",
           "BertForSequenceClassification", "BertForPretraining",
           "bert_config", "ViTConfig", "VisionTransformer", "vit_config"]
