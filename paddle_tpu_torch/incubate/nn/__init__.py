"""Fused functional ops (the port of paddle_tpu/incubate/nn)."""
from . import functional

__all__ = ["functional"]
