"""The parallel environment (the port of paddle_tpu/distributed/parallel.py).

One process per device, as in the reference's launcher contract: each
process reads its rank from ``RANK`` (or ``PADDLE_TRAINER_ID``), the
world size from ``WORLD_SIZE`` (or ``PADDLE_TRAINERS_NUM``), its card from
``LOCAL_RANK`` (default: the rank) and meets the others through
``MASTER_ADDR`` / ``MASTER_PORT`` or an explicit ``init_method``
(``tcp://host:port``, ``file:///path``). On the card the process group is
NCCL on ``cuda:LOCAL_RANK``; gloo is used only when the caller asks for
the CPU (``device="cpu"``). A failed initialisation raises: the JAX
package's warn-and-carry-on-single-process has no counterpart.
"""
from __future__ import annotations

import datetime
import os
import types
from typing import Optional

import torch
import torch.distributed as dist

from ..device import resolve_device

_state = types.SimpleNamespace(device=None, backend=None)


def _env_int(*names, default=None):
    for n in names:
        v = os.environ.get(n)
        if v not in (None, ""):
            return int(v)
    return default


class ParallelEnv:
    """Reference: paddle.distributed.ParallelEnv — this process's rank,
    world size and card."""

    @property
    def rank(self):
        return get_rank()

    @property
    def world_size(self):
        return get_world_size()

    @property
    def nranks(self):
        return get_world_size()

    @property
    def local_rank(self):
        return _env_int("LOCAL_RANK", default=get_rank())

    @property
    def dev_id(self):
        return self.local_rank

    @property
    def device(self) -> Optional[torch.device]:
        return _state.device


def init_parallel_env(init_method: Optional[str] = None, device=None,
                      backend: Optional[str] = None,
                      timeout_s: float = 600.0) -> ParallelEnv:
    """Join the process group (once; a second call returns the same
    environment). ``device`` defaults to CUDA, which raises without a
    card; the process's card is ``cuda:LOCAL_RANK`` and the backend NCCL.
    ``device="cpu"`` takes gloo. A backend that does not fit the device
    (gloo on the card, NCCL on the CPU) raises."""
    if dist.is_initialized():
        return ParallelEnv()
    dev = resolve_device(device)
    rank = _env_int("RANK", "PADDLE_TRAINER_ID", default=0)
    world = _env_int("WORLD_SIZE", "PADDLE_TRAINERS_NUM", default=1)
    if dev.type == "cuda":
        local = _env_int("LOCAL_RANK", default=rank)
        if local >= torch.cuda.device_count():
            raise RuntimeError(f"LOCAL_RANK {local} has no card: "
                               f"{torch.cuda.device_count()} visible")
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
        want = "nccl"
    elif dev.type == "cpu":
        want = "gloo"
    else:
        raise ValueError(f"init_parallel_env: no process group for {dev}")
    backend = backend or want
    if backend != want:
        raise ValueError(f"init_parallel_env: backend {backend!r} on "
                         f"{dev.type}; the port runs {want!r} there")
    if init_method is None:
        if not (os.environ.get("MASTER_ADDR") and
                os.environ.get("MASTER_PORT")):
            raise RuntimeError("init_parallel_env: set MASTER_ADDR and "
                               "MASTER_PORT, or pass init_method=")
        init_method = "env://"
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    _state.device, _state.backend = dev, backend
    return ParallelEnv()


def destroy_parallel_env():
    """Leave the process group and drop the mesh built on it."""
    from . import mesh as _mesh
    _mesh.set_mesh(None)
    if dist.is_initialized():
        dist.destroy_process_group()
    _state.device, _state.backend = None, None


def get_rank(group=None) -> int:
    """This process's rank: in `group` when given, else in the world (0
    before initialisation)."""
    if group is not None:
        return group.rank
    return dist.get_rank() if dist.is_initialized() else 0


def get_world_size(group=None) -> int:
    if group is not None:
        return group.nranks
    return dist.get_world_size() if dist.is_initialized() else 1


def is_initialized() -> bool:
    return dist.is_initialized()


def current_device() -> Optional[torch.device]:
    """The device the process group was initialised for."""
    return _state.device


def barrier(group=None):
    """Block until every rank of `group` (the world) arrives."""
    if not dist.is_initialized():
        return
    pg = None if group is None else group.process_group
    if _state.backend == "nccl":
        dist.barrier(group=pg, device_ids=[_state.device.index])
    else:
        dist.barrier(group=pg)
