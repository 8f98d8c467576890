"""paddle.distributed in the port: one process per device over
`torch.distributed` (NCCL on the card, gloo when the caller asks for the
CPU).

`init_parallel_env` joins the process group; `build_mesh` /
`fleet.init` lay the ranks out on named axes (``dp``, ``mp``) with a
process group per axis; the collectives (`all_reduce`, ...) have Paddle's
per-process semantics; `mpu` holds the tensor-parallel layers and
`spawn` starts the processes of a run on one machine. `recompute` is the
activation-checkpointing module. `jit.TrainStep(mesh=...)` trains over a
``dp`` x ``mp`` mesh.
"""
from __future__ import annotations

from . import recompute  # noqa: F401  (the module)
from .parallel import (  # noqa: F401
    ParallelEnv, barrier, current_device, destroy_parallel_env, get_rank,
    get_world_size, init_parallel_env, is_initialized)
from .collective import (  # noqa: F401
    Group, ReduceOp, all_gather, all_reduce, alltoall, broadcast, get_group,
    new_group, recv, reduce, reduce_scatter, scatter, send,
    stream_all_reduce)
from .mesh import (  # noqa: F401
    HYBRID_AXES, Mesh, axis_group, build_mesh, get_mesh, mesh_axis_rank,
    mesh_axis_size, mesh_scope, set_mesh)
from .topology import CommunicateTopology, HybridCommunicateGroup  # noqa
from . import mpu  # noqa: F401
from .mpu import (  # noqa: F401
    ColumnParallelLinear, ParallelCrossEntropy, RowParallelLinear,
    VocabParallelEmbedding, get_rng_state_tracker, split)
from .spawn import spawn  # noqa: F401
from . import fleet  # noqa: F401
