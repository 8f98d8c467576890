"""paddle.distributed.spawn (the port of paddle_tpu/distributed/spawn.py):
start `nprocs` processes on this machine with the rank environment set
and run `func(*args)` in each.

Each process gets ``RANK`` = ``LOCAL_RANK`` = its index, ``WORLD_SIZE`` =
nprocs, ``MASTER_ADDR`` = 127.0.0.1 and a free ``MASTER_PORT`` (plus
Paddle's ``PADDLE_TRAINER_ID`` / ``PADDLE_TRAINERS_NUM``), so
`init_parallel_env()` in `func` joins the group; a caller may pass its own
``init_method`` (a file store) instead. Processes start with the "spawn"
method: `func` must be importable by name, and a child imports only what
`func`'s module imports. A process that raises ends the run: the others
are terminated and the child's traceback is raised here.
"""
from __future__ import annotations

import os
import socket
import time
from typing import Dict, Optional, Sequence

import torch.multiprocessing as tmp


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(rank, func, nprocs, port, env, args):
    os.environ.update({"RANK": str(rank), "LOCAL_RANK": str(rank),
                       "WORLD_SIZE": str(nprocs),
                       "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                       "PADDLE_TRAINER_ID": str(rank),
                       "PADDLE_TRAINERS_NUM": str(nprocs)})
    os.environ.update(env or {})
    func(*args)


def spawn(func, args: Sequence = (), nprocs: int = -1, join: bool = True,
          daemon: bool = False, timeout: Optional[float] = 600,
          env: Optional[Dict[str, str]] = None):
    """Reference: paddle.distributed.spawn(func, args, nprocs, join).
    Returns the processes' context; with `join`, `wait`s for them first."""
    if nprocs < 1:
        nprocs = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
    ctx = tmp.start_processes(_worker, args=(func, nprocs, free_port(), env,
                                             tuple(args)),
                              nprocs=nprocs, join=False, daemon=daemon,
                              start_method="spawn")
    return wait(ctx, timeout) if join else ctx


def wait(ctx, timeout: Optional[float] = 600):
    """Wait up to `timeout` seconds for the processes of `spawn(...,
    join=False)`; raise if one fails or the time runs out (the processes
    are terminated then)."""
    deadline = None if timeout is None else time.monotonic() + timeout
    while not ctx.join(timeout=5):
        if deadline is not None and time.monotonic() > deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
            for p in ctx.processes:
                p.join(10)
                if p.is_alive():
                    p.kill()
            raise RuntimeError(f"spawned processes timed out after "
                               f"{timeout} s")
    return ctx
