"""paddle.distributed in the port: one process per device over
`torch.distributed` (NCCL on the card, gloo when the caller asks for the
CPU).

`init_parallel_env` joins the process group; `build_mesh` / `fleet.init` lay
the ranks out on named axes (``dp``, ``sdp``, ``ep``, ``sp``, ``mp``) with a
process group per axis; the collectives (`all_reduce`, ...) have Paddle's
per-process semantics; `mpu` holds the tensor-parallel layers and `spawn`
starts the processes of a run on one machine. `recompute` is the
activation-checkpointing module (`recompute_sequential`, `recompute_hybrid`).
`jit.TrainStep(mesh=...)` trains over those axes, with the int8 gradient
exchange of `quant_collectives` (`grad_comm=`) and ZeRO
(`group_sharded_parallel`); `dgc` is the top-k sparsified exchange;
`ring_attention`, `ulysses_attention` and `sequence_parallel_attention`
(`ops.ring_attention`) attend over the ``sp`` axis.
"""
from __future__ import annotations

from . import recompute  # noqa: F401  (the module)
from .recompute import recompute_hybrid, recompute_sequential  # noqa: F401
from .parallel import (  # noqa: F401
    ParallelEnv, barrier, current_device, destroy_parallel_env, get_rank,
    get_world_size, init_parallel_env, is_initialized)
from .collective import (  # noqa: F401
    Group, P2POp, ReduceOp, all_gather, all_reduce, alltoall,
    batch_isend_irecv, broadcast, get_group, irecv, isend, new_group, recv,
    reduce, reduce_scatter, scatter, send, stream_all_reduce)
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
from . import quant_collectives  # noqa: F401
from .quant_collectives import (  # noqa: F401
    build_comm_groups, comm_group_stats, default_f32_fallback,
    dequantize_chunked, int8_psum, quantize_chunked, sync_grad_groups)
from .sharding import (  # noqa: F401
    group_sharded_parallel, shard_optimizer_state, shard_parameter_specs)
from .dgc import dgc_value_and_grad, sparse_allreduce  # noqa: F401
from ..ops.ring_attention import (  # noqa: F401
    ring_attention, sequence_parallel_attention, ulysses_attention)
