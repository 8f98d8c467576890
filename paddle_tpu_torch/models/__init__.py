from .gpt import GPTConfig, GPTForCausalLM, PRESETS, gpt_config, sample_logits
from .bert import (BertConfig, BertForMaskedLM, BertForPretraining,
                   BertForSequenceClassification, BertModel, bert_config)
from .vit import ViTConfig, VisionTransformer, vit_config
from .ernie import (ErnieConfig, ErnieForMaskedLM,
                    ErnieForSequenceClassification, ErnieModel, ernie_config)

__all__ = ["GPTConfig", "GPTForCausalLM", "PRESETS", "gpt_config",
           "sample_logits", "BertConfig", "BertModel", "BertForMaskedLM",
           "BertForSequenceClassification", "BertForPretraining",
           "bert_config", "ViTConfig", "VisionTransformer", "vit_config",
           "ErnieConfig", "ErnieModel", "ErnieForSequenceClassification",
           "ErnieForMaskedLM", "ernie_config"]
