"""fleet, the distributed training facade (the port of
paddle_tpu/distributed/fleet/__init__.py's collective half).

`init` joins the process group (`init_parallel_env`) when it is not
joined yet, builds the hybrid mesh from `DistributedStrategy.
hybrid_configs` and sets it; the world's ranks beyond the product of the
degrees become data parallel, as in the JAX package; a
``sharding_degree`` builds the ``sdp`` axis. `distributed_model` returns
its argument: the tensor-parallel layers (`mpu`) hold their shards and
call their collectives themselves, and `jit.TrainStep(mesh=...)` splits
the batch over ``dp``, averages the gradients and applies the mesh-aware
gradient clip. `distributed_optimizer` marks the optimizer for ZeRO under
`strategy.sharding` (stage `sharding_configs.stage`, over ``sdp``), as the
JAX package does; TrainStep runs it. ``sp_degree`` and ``ep_degree``
build the sequence- and expert-parallel axes (in the JAX package's
order: pp, dp, sdp, ep, sp, mp). Pipeline parallelism is a later slice
and raises.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .strategy import DistributedStrategy
from ..topology import CommunicateTopology, HybridCommunicateGroup
from .. import mesh as _mesh
from ..parallel import get_rank, get_world_size, init_parallel_env

_fleet_state = {"initialized": False, "strategy": None, "hcg": None}
_LATER = "a later multi-GPU slice (ROADMAP.md, queue item A4)"


def init(role_maker=None, is_collective: bool = True,
         strategy: Optional[DistributedStrategy] = None, device=None,
         init_method: Optional[str] = None):
    """Reference: fleet.init. Joins the process group if needed (see
    `init_parallel_env`: `device`, `init_method`) and sets the hybrid
    mesh."""
    strategy = strategy or DistributedStrategy()
    if not is_collective:
        raise NotImplementedError("fleet.init(is_collective=False): the "
                                  "parameter-server mode is not ported")
    if strategy.pipeline or strategy.hybrid_configs.get("pp_degree", 1) > 1:
        raise NotImplementedError(f"fleet.init: pipeline parallelism comes "
                                  f"with {_LATER}")
    axes = strategy.mesh_axes()
    init_parallel_env(init_method=init_method, device=device)
    world = get_world_size()
    need = int(np.prod(list(axes.values()))) if axes else 1
    if not axes:
        axes = {"dp": world}
    elif need < world and world % need == 0:
        # the rest of the world becomes (outer) data parallel
        axes = {"dp": (world // need) * axes.pop("dp", 1), **axes}
    mesh = _mesh.build_mesh(axes)
    topo = CommunicateTopology(
        hybrid_group_names=["data", "pipe", "sharding", "expert",
                            "sequence", "model"],
        dims=[mesh.axis_size("dp"), 1, mesh.axis_size("sdp"),
              mesh.axis_size("ep"), mesh.axis_size("sp"),
              mesh.axis_size("mp")])
    hcg = HybridCommunicateGroup(topo, mesh)
    _fleet_state.update(initialized=True, strategy=strategy, hcg=hcg)


def get_hybrid_communicate_group() -> HybridCommunicateGroup:
    return _fleet_state["hcg"]


def distributed_model(model):
    """Reference: fleet/model.py distributed_model. The mpu layers already
    hold their shards; data parallelism is TrainStep(mesh=...)'s."""
    if _fleet_state["hcg"] is None:
        raise RuntimeError("call fleet.init() first")
    return model


def distributed_optimizer(optimizer, strategy: Optional[DistributedStrategy]
                          = None):
    """Reference: fleet.distributed_optimizer. The hybrid-parallel gradient
    clip (squares of mp-sharded gradients summed over mp) is applied by
    TrainStep(mesh=...); under `strategy.sharding` the optimizer is marked
    for ZeRO stage `sharding_configs.stage` over ``sdp``
    (`sharding.shard_optimizer_state`, as in the JAX package)."""
    st = strategy or _fleet_state["strategy"]
    if st is not None and st.sharding:
        from ..sharding import shard_optimizer_state
        shard_optimizer_state(optimizer, stage=int(
            st.sharding_configs.get("stage", 1)))
    return optimizer


def worker_index():
    return get_rank()


def worker_num():
    return get_world_size()


def is_first_worker():
    return get_rank() == 0
