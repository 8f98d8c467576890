"""Optimizers and learning-rate schedulers (the port of
paddle_tpu/optimizer)."""
from . import lr
from .lr import CosineAnnealingDecay, LinearWarmup, LRScheduler
from .optimizer import Adam, AdamW, Optimizer

__all__ = ["Adam", "AdamW", "Optimizer", "LRScheduler", "LinearWarmup",
           "CosineAnnealingDecay", "lr"]
