"""The process mesh (the port of paddle_tpu/distributed/mesh.py).

A mesh lays the world's ranks out on named axes, ``{axis: degree}``, in
row-major order: the LAST axis varies fastest, so with
``{"dp": 2, "mp": 2}`` ranks 0 and 1 form one ``mp`` group and ranks 0
and 2 one ``dp`` group, as in the JAX package (where the last axis runs
over adjacent devices). Each process holds its coordinates and one
process group per axis (`Mesh.group`), built with `collective.new_group`
by every rank in the same order. Beside each ``mp`` group stands a gloo
group over the same ranks (`Mesh.control_group`): host messages travel
there without touching the card's stream (the sharded serving engine's
op headers).

The JAX helpers `filter_spec`, `named_sharding` and `shard_constraint`
only steer XLA's partitioner (PartitionSpecs and sharding constraints on
a global array). The port keeps each rank's shard explicitly and calls
its collectives itself (`mpu`), so they have no counterpart.
"""
from __future__ import annotations

import contextlib
import types
from typing import Dict, Optional, Tuple

import numpy as np

from .collective import Group, new_group
from .parallel import get_rank, get_world_size

HYBRID_AXES = ("dp", "pp", "sdp", "mp")  # the reference's 4D order

_state = types.SimpleNamespace(mesh=None, loss_group=None)


class Mesh:
    """This rank's view of the mesh: the axes and degrees (`shape`), its
    coordinates (`coords`) and its group along each axis."""

    def __init__(self, axes: Dict[str, int], rank: int,
                 groups: Dict[str, Group],
                 controls: Optional[Dict[str, Group]] = None):
        self.shape = dict(axes)
        self.axis_names = tuple(axes)
        self.rank = rank
        self.coords = dict(zip(self.axis_names, np.unravel_index(
            rank, tuple(axes.values())) if axes else ()))
        self.coords = {k: int(v) for k, v in self.coords.items()}
        self._groups = groups
        self._controls = controls or {}

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values()))) if self.shape else 1

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def axis_rank(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, axis: str) -> Optional[Group]:
        """This rank's group along `axis` (None if the mesh lacks it)."""
        return self._groups.get(axis)

    def control_group(self, axis: str) -> Optional[Group]:
        """The gloo twin of `group(axis)`: the same ranks, host tensors
        (built for the ``mp`` axis only; None for the others)."""
        return self._controls.get(axis)

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank}, coords={self.coords})"


def axis_groups(axes: Dict[str, int], axis: str) -> Tuple[Tuple[int, ...],
                                                          ...]:
    """Every group of global ranks along `axis`, in a fixed order: for
    each setting of the other coordinates (row-major), the ranks that
    differ only in `axis`."""
    names = list(axes)
    grid = np.arange(int(np.prod(list(axes.values())))).reshape(
        tuple(axes.values()))
    moved = np.moveaxis(grid, names.index(axis), -1)
    return tuple(tuple(int(r) for r in row)
                 for row in moved.reshape(-1, axes[axis]))


def build_mesh(axes: Dict[str, int]) -> Mesh:
    """The mesh `axes` ({name: degree}) over the initialised world; the
    degrees must multiply to the world size. Every rank must call it (it
    creates the axes' process groups and the ``mp`` groups' gloo
    twins)."""
    axes = {str(k): int(v) for k, v in axes.items()}
    world = get_world_size()
    n = int(np.prod(list(axes.values()))) if axes else 1
    if n != world:
        raise ValueError(f"mesh axes {axes} need {n} ranks; the world has "
                         f"{world}")
    rank = get_rank()
    groups, controls = {}, {}
    for ax in axes:
        for ranks in axis_groups(axes, ax):
            g = new_group(ranks)
            c = new_group(ranks, backend="gloo") if ax == "mp" else None
            if rank in ranks:
                g.axis = ax
                groups[ax] = g
                if c is not None:
                    c.axis = ax
                    controls[ax] = c
    return Mesh(axes, rank, groups, controls)


def set_mesh(mesh: Optional[Mesh]):
    _state.mesh = mesh


def get_mesh() -> Optional[Mesh]:
    """The process-global mesh (None until set_mesh / fleet.init)."""
    return _state.mesh


def mesh_axis_size(axis: str) -> int:
    m = get_mesh()
    return 1 if m is None else m.axis_size(axis)


def mesh_axis_rank(axis: str) -> int:
    m = get_mesh()
    return 0 if m is None else m.axis_rank(axis)


def axis_group(axis: str, mesh: Optional[Mesh] = None) -> Optional[Group]:
    """The group along `axis` of `mesh` (the active one), or None where
    that axis has one rank: the callers skip their collectives then."""
    m = get_mesh() if mesh is None else mesh
    if m is None or m.axis_size(axis) == 1:
        return None
    return m.group(axis)


@contextlib.contextmanager
def mesh_scope(mesh: Optional[Mesh]):
    prev = get_mesh()
    set_mesh(mesh)
    try:
        yield mesh
    finally:
        set_mesh(prev)


def loss_group() -> Optional[Group]:
    """The data-parallel group a masked-mean loss reduces its count over
    (set by `data_parallel_loss`; None outside it)."""
    return _state.loss_group


@contextlib.contextmanager
def data_parallel_loss(group: Optional[Group]):
    """Within the region, masked-mean losses (GPT's `_masked_mean`) take
    the global count over `group` (see there)."""
    prev = _state.loss_group
    _state.loss_group = group
    try:
        yield
    finally:
        _state.loss_group = prev
