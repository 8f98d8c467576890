"""Mixture of experts (the port of
paddle_tpu/incubate/distributed/models/moe)."""
from .gate import BaseGate, GShardGate, NaiveGate, SwitchGate
from .moe_layer import MoELayer, measured_drop_rate, record_drop_rate

__all__ = ["MoELayer", "BaseGate", "NaiveGate", "GShardGate", "SwitchGate",
           "record_drop_rate", "measured_drop_rate"]
