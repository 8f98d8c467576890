"""Hybrid-parallel topology (the port of paddle_tpu/distributed/topology.py).

`CommunicateTopology` is the reference's rank hypercube over the
data, pipe, sharding and model dimensions (and, as in the JAX package,
the sequence and expert ones); `HybridCommunicateGroup` builds the mesh
of its dimensions (axes of degree 1 left out, ``mp`` last, so
model-parallel ranks are adjacent) over the initialised world and hands
out this rank's groups, ranks and world sizes, the sharding (``sdp``,
ZeRO's), sequence (``sp``) and expert (``ep``) axes among them.
"""
from __future__ import annotations

import itertools
from typing import Optional

import numpy as np

from . import mesh as _mesh

_CANON = {"data": "dp", "pipe": "pp", "sharding": "sdp", "model": "mp",
          "sequence": "sp", "expert": "ep"}


class CommunicateTopology:
    """Reference: fleet/base/topology.py CommunicateTopology — the names
    and degrees of the hybrid dimensions, ranks laid out row-major (the
    last name fastest)."""

    def __init__(self, hybrid_group_names=("data", "pipe", "sharding",
                                           "model"), dims=(1, 1, 1, 1)):
        self._names = list(hybrid_group_names)
        self._dims = [int(d) for d in dims]

    def get_hybrid_group_names(self):
        return self._names

    def get_dim(self, axis_name):
        return self._dims[self._names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self):
        return int(np.prod(self._dims))

    def get_rank(self, **coord):
        """The rank at the coordinates {name: index}."""
        return int(np.ravel_multi_index(
            tuple(coord[n] for n in self._names), self._dims))

    def get_coord(self, rank):
        return dict(zip(self._names, (int(c) for c in np.unravel_index(
            rank, self._dims))))

    def get_axis_list(self, axis_name, index):
        """The ranks whose coordinate on `axis_name` is `index`."""
        return [r for r in range(self.world_size())
                if self.get_coord(r)[axis_name] == index]

    def get_comm_list(self, axis_name):
        """The rank lists of every group along `axis_name`."""
        axis = self._names.index(axis_name)
        others = [range(d) for i, d in enumerate(self._dims) if i != axis]
        out = []
        for rest in itertools.product(*others):
            ranks = []
            for k in range(self._dims[axis]):
                c = list(rest)
                c.insert(axis, k)
                ranks.append(self.get_rank(**dict(zip(self._names, c))))
            out.append(ranks)
        return out


class HybridCommunicateGroup:
    """Reference: topology.py HybridCommunicateGroup. Builds (or adopts)
    the mesh of `topology` over the world and sets it as the active
    mesh."""

    def __init__(self, topology: Optional[CommunicateTopology] = None,
                 mesh: Optional[_mesh.Mesh] = None):
        self._topo = topology or CommunicateTopology()
        if mesh is None:
            dims = dict(zip(self._topo.get_hybrid_group_names(),
                            self._topo._dims))
            axes = {_CANON.get(k, k): v for k, v in dims.items() if v > 1} \
                or {"dp": 1}
            mesh = _mesh.build_mesh(axes)
        self._mesh = mesh
        _mesh.set_mesh(mesh)

    @property
    def mesh(self):
        return self._mesh

    def _deg(self, ax):
        return self._mesh.axis_size(ax)

    def _rank(self, ax):
        return self._mesh.axis_rank(ax)

    def get_global_rank(self):
        return self._mesh.rank

    def get_data_parallel_world_size(self):
        return self._deg("dp")

    def get_model_parallel_world_size(self):
        return self._deg("mp")

    def get_pipe_parallel_world_size(self):
        return self._deg("pp")

    def get_sharding_parallel_world_size(self):
        return self._deg("sdp")

    def get_sequence_parallel_world_size(self):
        return self._deg("sp")

    def get_expert_parallel_world_size(self):
        return self._deg("ep")

    def get_data_parallel_rank(self):
        return self._rank("dp")

    def get_model_parallel_rank(self):
        return self._rank("mp")

    def get_stage_id(self):
        return self._rank("pp")

    def get_sharding_parallel_rank(self):
        return self._rank("sdp")

    def get_sequence_parallel_rank(self):
        return self._rank("sp")

    def get_expert_parallel_rank(self):
        return self._rank("ep")

    def get_data_parallel_group(self):
        return self._mesh.group("dp")

    def get_model_parallel_group(self):
        return self._mesh.group("mp")

    def get_pipe_parallel_group(self):
        return self._mesh.group("pp")

    def get_sharding_parallel_group(self):
        return self._mesh.group("sdp")

    def get_sequence_parallel_group(self):
        return self._mesh.group("sp")

    def get_expert_parallel_group(self):
        return self._mesh.group("ep")

    def get_check_parallel_group(self):
        return None

    def get_parallel_mode(self):
        """"pipeline", "sharding", "model" or "data": the mode the
        reference's fleet.distributed_model dispatches on."""
        if self._deg("pp") > 1:
            return "pipeline"
        if self._deg("sdp") > 1:
            return "sharding"
        if self._deg("mp") > 1 or self._deg("sp") > 1:
            return "model"
        return "data"

    def topology(self):
        return self._topo
