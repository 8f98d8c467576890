"""Fused ops beyond the plain layers and the MoE layer (the port of
paddle_tpu/incubate): `incubate.nn` and
`incubate.distributed.models.moe`."""
from . import nn
from .distributed.models import moe

__all__ = ["nn", "moe"]
