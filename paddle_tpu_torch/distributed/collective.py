"""The communication API (the port of paddle_tpu/distributed/collective.py)
over `torch.distributed`, with Paddle's per-process semantics: every rank
calls the collective with its own tensor, and the result lands in place.

The JAX package models a group's ranks as rows of one stacked ``[nranks,
...]`` array in a single process; here rank r's tensor is row r of that
view, and each function computes what row r of the JAX result holds.
`src` and `dst` are global ranks, as in Paddle (`Group.get_group_rank`
maps them into the group). A CUDA tensor travels over NCCL and a CPU
tensor over gloo; a tensor on the other backend's device raises, so a
card's tensor never falls back to gloo. Where gloo lacks a collective
(reduce-scatter), the CPU path computes it from an all-reduce.

`sync_op=False` returns the backend's work handle (``wait()``); the
default waits and returns None. Each group counts the all-reduces it ran
over more than one rank (`Group.all_reduces`): the tensor-parallel
serving plan is exactly two a layer a forward, and the tests and the
smoke read it there.
"""
from __future__ import annotations

import itertools
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist


class ReduceOp:
    """Reference: paddle.distributed.ReduceOp."""
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


_TORCH_OP = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.MAX: dist.ReduceOp.MAX,
             ReduceOp.MIN: dist.ReduceOp.MIN,
             ReduceOp.PROD: dist.ReduceOp.PRODUCT}
_ids = itertools.count(1)
# the gather into / reduce-scatter from one flat tensor (newer torch
# renames them)
_gather_flat = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_scatter_flat = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


class Group:
    """A communicator: the global ranks it spans, in group-rank order, and
    its process group (None for the world group). ``rank`` is this
    process's rank in the group, -1 when it is not a member. ``axis``
    names the mesh axis the group runs along, when it has one."""

    def __init__(self, ranks: Sequence[int], pg=None, gid: Optional[int] = None,
                 axis: Optional[str] = None):
        self.ranks = [int(r) for r in ranks]
        self.process_group = pg
        self.id = next(_ids) if gid is None else gid
        self.axis = axis
        # all-reduces run over this group with more than one rank
        self.all_reduces = 0
        me = dist.get_rank() if dist.is_initialized() else 0
        self.rank = self.ranks.index(me) if me in self.ranks else -1

    @property
    def nranks(self) -> int:
        return len(self.ranks)

    world_size = nranks

    @property
    def name(self) -> str:
        return f"axis:{self.axis}" if self.axis else f"group:{self.id}"

    @property
    def backend(self) -> str:
        return dist.get_backend(self.process_group)

    def is_member(self) -> bool:
        return self.rank >= 0

    def get_group_rank(self, rank: int) -> int:
        """The group rank of global rank `rank` (-1 if not a member)."""
        return self.ranks.index(rank) if rank in self.ranks else -1

    def __repr__(self):
        return (f"Group(ranks={self.ranks}, rank={self.rank}, "
                f"axis={self.axis!r}, id={self.id})")


_world: List[Optional[Group]] = [None]


def _world_group() -> Group:
    if not dist.is_initialized():
        raise RuntimeError("the process group is not initialised; call "
                           "distributed.init_parallel_env() first")
    g = _world[0]
    if g is None or g.nranks != dist.get_world_size():
        g = _world[0] = Group(range(dist.get_world_size()), None, gid=0)
    return g


def new_group(ranks: Optional[Sequence[int]] = None, backend=None,
              axis: Optional[str] = None) -> Group:
    """A group over the global `ranks` (all of them when None). Every
    process must call it, members or not, in the same order (the
    torch.distributed rule). `axis` selects a mesh axis's group of this
    rank instead (`mesh.get_mesh().group(axis)`)."""
    if axis is not None:
        from .mesh import get_mesh
        m = get_mesh()
        if m is None:
            raise RuntimeError("new_group(axis=...): no mesh is set")
        return m.group(axis)
    world = _world_group()
    if ranks is None and backend is None:
        return world
    ranks = sorted(int(r) for r in (range(world.nranks) if ranks is None
                                    else ranks))
    from .parallel import group_timeout
    return Group(ranks, dist.new_group(ranks, backend=backend,
                                       timeout=group_timeout()))


def get_group(gid: int = 0) -> Group:
    """The world group (Paddle's group 0)."""
    return _world_group()


def _resolve(group: Optional[Group]) -> Group:
    return _world_group() if group is None else group


def _check(tensor, group: Group, opname: str):
    if not group.is_member():
        raise ValueError(f"{opname}: this rank is not in {group}")
    backend = group.backend
    if tensor.is_cuda and backend != "nccl":
        raise ValueError(f"{opname}: a CUDA tensor on a {backend} group; "
                         f"the card's tensors travel over NCCL only")
    if not tensor.is_cuda and backend == "nccl":
        raise ValueError(f"{opname}: a {tensor.device} tensor on an NCCL "
                         f"group")


def _done(work, sync_op):
    if sync_op:
        if work is not None:
            work.wait()
        return None
    return work


def all_reduce(tensor, op=ReduceOp.SUM, group: Optional[Group] = None,
               sync_op: bool = True):
    """Reduce `tensor` over the group's ranks, in place on every rank."""
    group = _resolve(group)
    _check(tensor, group, "all_reduce")
    if group.nranks == 1:
        return None
    group.all_reduces += 1
    if op == ReduceOp.AVG:
        dist.all_reduce(tensor, dist.ReduceOp.SUM,
                        group=group.process_group)
        tensor.div_(group.nranks)
        return None
    return _done(dist.all_reduce(tensor, _TORCH_OP[op],
                                 group=group.process_group,
                                 async_op=not sync_op), sync_op)


def all_gather(tensor_list: Optional[List], tensor=None,
               group: Optional[Group] = None, sync_op: bool = True):
    """Every rank's `tensor`, in group-rank order: appended to
    `tensor_list`, or returned stacked on a new dim 0 when called as
    ``all_gather(tensor)``."""
    if tensor is None:
        tensor, tensor_list = tensor_list, None
    group = _resolve(group)
    _check(tensor, group, "all_gather")
    t = tensor.contiguous()
    out = torch.empty((group.nranks,) + tuple(t.shape), dtype=t.dtype,
                      device=t.device)
    if group.nranks == 1:
        out[0].copy_(t)
    else:
        _gather_flat(out.view(-1), t.view(-1), group=group.process_group)
    if tensor_list is None:
        return out
    tensor_list.extend(out.unbind(0))
    return None


def broadcast(tensor, src: int = 0, group: Optional[Group] = None,
              sync_op: bool = True):
    """Global rank `src`'s tensor, in place on every rank."""
    group = _resolve(group)
    _check(tensor, group, "broadcast")
    if group.nranks == 1:
        return None
    return _done(dist.broadcast(tensor, src, group=group.process_group,
                                async_op=not sync_op), sync_op)


def reduce(tensor, dst: int = 0, op=ReduceOp.SUM,
           group: Optional[Group] = None, sync_op: bool = True):
    """The reduction lands on global rank `dst`; the other ranks keep
    their input (the JAX package's rule)."""
    group = _resolve(group)
    _check(tensor, group, "reduce")
    if group.nranks == 1:
        return None
    buf = tensor.clone()
    if op == ReduceOp.AVG:
        dist.reduce(buf, dst, dist.ReduceOp.SUM, group=group.process_group)
        buf.div_(group.nranks)
    else:
        dist.reduce(buf, dst, _TORCH_OP[op], group=group.process_group)
    if dist.get_rank() == dst:
        tensor.copy_(buf)
    return None


def reduce_scatter(tensor, tensor_list=None, op=ReduceOp.SUM,
                   group: Optional[Group] = None, sync_op: bool = True):
    """Rank r receives, in `tensor`, the reduction of every rank's chunk r:
    chunk r of `tensor_list` (a list of nranks tensors), or, without a
    list, of the rank's input `tensor` cut into nranks equal pieces on
    dim 0 (then `tensor` is replaced by its chunk and returned)."""
    group = _resolve(group)
    n = group.nranks
    inp = torch.stack(list(tensor_list)) if tensor_list else tensor
    _check(inp, group, "reduce_scatter")
    if inp.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim 0 of {tuple(inp.shape)} does "
                         f"not split into {n} chunks")
    chunks = inp.reshape((n, inp.shape[0] // n) + tuple(inp.shape[1:])) \
        if not tensor_list else inp
    if n == 1:
        out = chunks[0].clone()
    elif group.backend == "nccl" and op != ReduceOp.AVG:
        out = torch.empty_like(chunks[0])
        _scatter_flat(out.view(-1), chunks.contiguous().view(-1),
                      _TORCH_OP[op], group=group.process_group)
    else:
        full = chunks.clone()
        all_reduce(full, ReduceOp.SUM if op == ReduceOp.AVG else op, group)
        out = full[group.rank].clone()
    if op == ReduceOp.AVG and n > 1:
        out.div_(n)
    if tensor_list:
        tensor.copy_(out.reshape(tensor.shape))
        return None
    return out


def alltoall(in_tensor_list, out_tensor_list=None,
             group: Optional[Group] = None, sync_op: bool = True):
    """Rank r sends chunk j of its input to rank j and receives chunk r of
    every rank, in group-rank order. The input is a list of nranks equal
    tensors or one tensor whose dim 0 splits into nranks chunks; the
    output is appended to `out_tensor_list`, or returned in the input's
    form."""
    group = _resolve(group)
    n = group.nranks
    listed = isinstance(in_tensor_list, (list, tuple))
    inp = torch.stack(list(in_tensor_list)) if listed else in_tensor_list
    _check(inp, group, "alltoall")
    if inp.shape[0] % n:
        raise ValueError(f"alltoall: dim 0 of {tuple(inp.shape)} does not "
                         f"split into {n} chunks")
    inp = inp.contiguous()
    out = torch.empty_like(inp)
    if n == 1:
        out.copy_(inp)
    else:
        dist.all_to_all_single(out, inp, group=group.process_group)
    if out_tensor_list is not None:
        out_tensor_list.extend(out.chunk(n, dim=0) if not listed
                               else out.unbind(0))
        return None
    return list(out.unbind(0)) if listed else out


def scatter(tensor, tensor_list=None, src: int = 0,
            group: Optional[Group] = None, sync_op: bool = True):
    """Global rank `src` cuts its data into nranks chunks (`tensor_list`,
    or its `tensor` split on dim 0 when no list is given) and rank r
    receives chunk r in `tensor` (which, without a list, is returned as
    the chunk)."""
    group = _resolve(group)
    n = group.nranks
    me = dist.get_rank()
    if tensor_list:
        chunks = [t.contiguous() for t in tensor_list]
        out = tensor
    else:
        if tensor.shape[0] % n:
            raise ValueError(f"scatter: dim 0 of {tuple(tensor.shape)} does "
                             f"not split into {n} chunks")
        chunks = [c.contiguous() for c in tensor.chunk(n, dim=0)]
        out = torch.empty_like(chunks[0])
    _check(out, group, "scatter")
    if n == 1:
        out.copy_(chunks[0].reshape(out.shape))
    else:
        dist.scatter(out, chunks if me == src else None, src=src,
                     group=group.process_group)
    return None if tensor_list else out


def send(tensor, dst: int, group: Optional[Group] = None,
         sync_op: bool = True):
    """Point-to-point send to global rank `dst`."""
    group = _resolve(group)
    _check(tensor, group, "send")
    if sync_op:
        dist.send(tensor.contiguous(), dst, group=group.process_group)
        return None
    return dist.isend(tensor.contiguous(), dst, group=group.process_group)


def recv(tensor, src: int, group: Optional[Group] = None,
         sync_op: bool = True):
    """Point-to-point receive from global rank `src`, into `tensor`."""
    group = _resolve(group)
    _check(tensor, group, "recv")
    if sync_op:
        dist.recv(tensor, src, group=group.process_group)
        return None
    return dist.irecv(tensor, src, group=group.process_group)


def stream_all_reduce(*args, **kwargs):
    return all_reduce(*args, **kwargs)
