"""DistributedStrategy (the port of paddle_tpu/distributed/fleet/strategy.py):
the reference's typed configuration bag, plain Python, with
``hybrid_configs`` degrees that map onto mesh axes."""
from __future__ import annotations

from typing import Dict


class _SubConfig(dict):
    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError:
            raise AttributeError(k)

    def __setattr__(self, k, v):
        self[k] = v


_HYBRID_DEFAULTS = {"dp_degree": 1, "mp_degree": 1, "pp_degree": 1,
                    "sharding_degree": 1, "sp_degree": 1, "ep_degree": 1}


class DistributedStrategy:
    def __init__(self):
        self.amp = False
        self.amp_configs = _SubConfig(init_loss_scaling=32768.0,
                                      use_pure_bf16=False,
                                      custom_white_list=[],
                                      custom_black_list=[],
                                      use_fp16_guard=False, level="O1")
        self.recompute = False
        self.recompute_configs = _SubConfig(checkpoints=[],
                                            enable_offload=False)
        self.gradient_merge = False
        self.gradient_merge_configs = _SubConfig(k_steps=1, avg=True)
        self.sharding = False
        self.sharding_configs = _SubConfig(stage=1, degree=1, offload=False)
        self.pipeline = False
        self.pipeline_configs = _SubConfig(accumulate_steps=1,
                                           micro_batch_size=1,
                                           schedule_mode="1F1B")
        self.tensor_parallel = False
        self.tensor_parallel_configs = _SubConfig(tensor_parallel_degree=1)
        self.hybrid_configs = _SubConfig(**_HYBRID_DEFAULTS)
        self.sequence_parallel = False
        self.find_unused_parameters = False
        self.fuse_all_reduce_ops = True
        self.fuse_grad_size_in_MB = 32
        self.nccl_comm_num = 1

    def __setattr__(self, k, v):
        if k == "hybrid_configs" and isinstance(v, dict) and \
                not isinstance(v, _SubConfig):
            merged = _SubConfig(**_HYBRID_DEFAULTS)
            merged.update(v)
            v = merged
        elif k.endswith("_configs") and isinstance(v, dict) and \
                not isinstance(v, _SubConfig):
            cur = self.__dict__.get(k)
            merged = _SubConfig(**cur) if isinstance(cur, dict) \
                else _SubConfig()
            merged.update(v)
            v = merged
        object.__setattr__(self, k, v)

    def mesh_axes(self) -> Dict[str, int]:
        """The hybrid degrees above 1 as mesh axes, model-parallel last
        (fastest varying), in the JAX package's order."""
        h = self.hybrid_configs
        axes = {}
        for ax, key in (("pp", "pp_degree"), ("dp", "dp_degree"),
                        ("sdp", "sharding_degree"), ("ep", "ep_degree"),
                        ("sp", "sp_degree"), ("mp", "mp_degree")):
            d = int(h.get(key, 1))
            if d > 1:
                axes[ax] = d
        return axes

    def __repr__(self):
        on = [k for k, v in self.__dict__.items() if v is True]
        return (f"DistributedStrategy(enabled={on}, "
                f"hybrid={dict(self.hybrid_configs)})")
