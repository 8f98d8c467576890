"""Gate configurations (the port of
paddle_tpu/incubate/distributed/models/moe/gate.py): each gate names the
top-k and the auxiliary-loss formula; the routing projection lives in
`MoELayer`."""
from __future__ import annotations


class BaseGate:
    gate_type = "naive"
    top_k = 2

    def __init__(self, d_model=None, num_experts=None, top_k=None):
        self.d_model = d_model
        self.num_experts = num_experts
        if top_k is not None:
            self.top_k = top_k


class NaiveGate(BaseGate):
    """Plain top-k routing, no auxiliary loss."""
    gate_type = "naive"
    top_k = 2


class GShardGate(BaseGate):
    """Top-2 routing and the load-balance auxiliary loss."""
    gate_type = "gshard"
    top_k = 2


class SwitchGate(BaseGate):
    """Top-1 routing and the load-balance auxiliary loss."""
    gate_type = "switch"
    top_k = 1
