from .gpt import GPTConfig, GPTForCausalLM, PRESETS, gpt_config, sample_logits

__all__ = ["GPTConfig", "GPTForCausalLM", "PRESETS", "gpt_config",
           "sample_logits"]
