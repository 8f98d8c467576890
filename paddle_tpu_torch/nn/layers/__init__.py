"""Layers of the port whose forward routes through the port's ops."""
from .norm import LayerNorm

__all__ = ["LayerNorm"]
