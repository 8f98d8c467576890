"""The leader/follower runner of tensor-parallel paged serving
(`ServingConfig(paged=True, shards=N)`).

The JAX engine is one controller over its mesh: one process decides what
runs next and every device runs it. The port runs one process a card, so
the controller is a LEADER, rank 0 of the engine's ``mp`` group, and the
other ranks are FOLLOWERS. The leader owns everything on the host (the
queue, admission, the block allocator and tables, the radix trie, the
spill tier, drafts, metrics, the ops surface, the clock); a follower
owns only its card's pools and its shard of the model. Every device
operation goes through `ShardRunner.call` on the leader:

  1. the op's header and host vectors (tables, lens, pending tokens,
     done flags, starts, admitted ids, drafts, seeds) are packed into one
     int64 buffer of fixed size and broadcast from the leader over the
     group's gloo twin (`Mesh.control_group`), so a follower reads it
     without a device sync;
  2. every rank, the leader included, unpacks the same buffer and runs
     the op on its own pools (`handlers`): the model's collectives (two
     mp all-reduces a layer) then meet on the NCCL group.

A decode chunk is one op, so the cost is paid once a chunk, not once a
token. Clock reads, the draft source, probes and audits all stay on the
leader, so no decision can differ between ranks and leave them in
mismatched collectives.

Failure is loud. An exception inside an op on the leader sends an ABORT
header where it can and marks the runner broken; a follower raises
`LeaderAborted` when it reads one, or the group's error when the leader's
process is gone (a collective or header wait then fails), so `follow()`
raises and a follower's process exits non-zero instead of hanging. Every
wait carries the group's timeout; while the leader is idle a keepalive
thread sends a NOOP every `KEEPALIVE_S` seconds, so an idle server does
not look dead. `close()` sends CLOSE: the followers' `follow()` returns.
"""
from __future__ import annotations

import datetime
import threading
import time
import weakref
from typing import Callable, Dict

import numpy as np
import torch

from ..distributed.collective import Group, broadcast

MAGIC = 0x5EA7ED
HEADER = 4                 # magic, sequence number, op code, payload words
KEEPALIVE_S = 10.0
ABORT_WAIT_S = 1.0         # how long a failing leader offers its ABORT
OPS = ("noop", "close", "abort", "prefill", "decode", "verify", "cow",
       "spill_read", "spill_write", "reset", "reference")
_CODE = {name: i for i, name in enumerate(OPS)}


class LeaderAborted(RuntimeError):
    """The leader failed inside an op and told its followers."""


def pack(arrays) -> np.ndarray:
    """Host vectors as one int64 word vector: their count, each one's rank
    and shape, then their elements in order."""
    head = [len(arrays)]
    flat = []
    for a in arrays:
        a = np.asarray(a)
        head += [a.ndim, *a.shape]
        flat.append(a.astype(np.int64).reshape(-1))
    return np.concatenate([np.asarray(head, np.int64)] + flat)


def unpack(words: np.ndarray) -> list:
    """The inverse of `pack` (every vector comes back as int64)."""
    n, i, shapes = int(words[0]), 1, []
    for _ in range(n):
        nd = int(words[i])
        shapes.append(tuple(int(d) for d in words[i + 1:i + 1 + nd]))
        i += 1 + nd
    out = []
    for shp in shapes:
        k = int(np.prod(shp)) if shp else 1
        out.append(words[i:i + k].reshape(shp))
        i += k
    return out


class ShardRunner:
    """One rank's side of the runner over `group` (the engine's ``mp``
    group, NCCL on the card) and `control` (its gloo twin). `handlers`
    maps an op name to ``fn(*vectors, extra=...)``, run on every rank;
    `words` bounds a packed op's payload. The leader is the group's first
    rank."""

    def __init__(self, group: Group, control: Group,
                 handlers: Dict[str, Callable], words: int):
        if control.ranks != group.ranks:
            raise ValueError("the control group must span the mp group's "
                             "ranks")
        self.group, self.control = group, control
        self.handlers = handlers
        self.leader = group.ranks[0]
        self.is_leader = group.rank == 0
        self.words = HEADER + int(words)
        self._buf = torch.zeros(self.words, dtype=torch.int64)
        self._seq = 0
        self._lock = threading.Lock()
        self._last = time.monotonic()
        self.closed = False
        self.broken = False
        # per op: calls, header-send µs on the leader, header-wait µs on
        # a follower (the time it sat idle before the op)
        self.stats = {op: {"calls": 0, "send_us": 0.0, "wait_us": 0.0}
                      for op in OPS}
        self._keepalive = None
        if self.is_leader and group.nranks > 1:
            ref = weakref.ref(self)
            self._keepalive = threading.Thread(
                target=_keepalive, args=(ref,), daemon=True,
                name="shard-runner-keepalive")
            self._keepalive.start()

    # ------------------------------------------------------------ leader
    def call(self, op: str, *arrays, extra=None):
        """Run `op` on every rank with the host vectors `arrays`; returns
        the leader's result. `extra` reaches the leader's handler only (a
        spill payload: the handler moves it to the followers over the
        device group)."""
        if not self.is_leader:
            raise RuntimeError("only the leader issues ops; a follower "
                               "runs them in follow()")
        if self.broken or self.closed:
            raise RuntimeError("the sharded runner is "
                               + ("closed" if self.closed else
                                  "broken by an earlier failure"))
        words = pack(arrays)
        if words.shape[0] > self.words - HEADER:
            raise ValueError(f"op {op!r} packs {words.shape[0]} words; the "
                             f"runner holds {self.words - HEADER}")
        with self._lock:
            try:
                self._send(op, words)
                return self.handlers[op](*unpack(words), extra=extra)
            except BaseException:
                self.broken = True
                self._abort()
                raise

    def close(self):
        """End the followers' `follow()` (idempotent)."""
        if self.closed or not self.is_leader:
            return
        with self._lock:
            if not self.broken:
                self._send("close", np.zeros(1, np.int64))
            self.closed = True

    def _send(self, op: str, words: np.ndarray):
        st = self.stats[op]
        st["calls"] += 1
        if self.group.nranks == 1:
            return
        t0 = time.perf_counter()
        self._seq += 1
        buf = self._buf
        buf[:HEADER] = torch.tensor([MAGIC, self._seq, _CODE[op],
                                     words.shape[0]])
        buf[HEADER:HEADER + words.shape[0]] = torch.from_numpy(words)
        broadcast(buf, src=self.leader, group=self.control)
        self._last = time.monotonic()
        st["send_us"] += (time.perf_counter() - t0) * 1e6

    def _abort(self):
        """Tell the followers, if they are waiting for a header: one that
        sits in a collective of the failed op cannot read it, and fails
        when this process is gone or the group's timeout passes."""
        self.stats["abort"]["calls"] += 1
        if self.group.nranks == 1:
            return
        self._buf[:HEADER] = torch.tensor([MAGIC, self._seq + 1,
                                           _CODE["abort"], 0])
        try:
            work = broadcast(self._buf, src=self.leader, group=self.control,
                             sync_op=False)
            work.wait(datetime.timedelta(seconds=ABORT_WAIT_S))
        except Exception:
            pass                # the followers are busy or gone

    def _noop(self):
        with self._lock:
            if self.closed or self.broken or \
                    time.monotonic() - self._last < KEEPALIVE_S:
                return
            self._send("noop", np.zeros(1, np.int64))

    # ---------------------------------------------------------- follower
    def follow(self):
        """A follower's loop: read each header, run its op on this rank's
        pools; return at CLOSE, raise `LeaderAborted` at ABORT (and the
        group's error if the leader is gone)."""
        if self.is_leader:
            raise RuntimeError("the leader drives the engine; follow() is "
                               "for the other ranks of its mp group")
        while True:
            t0 = time.perf_counter()
            broadcast(self._buf, src=self.leader, group=self.control)
            wait = (time.perf_counter() - t0) * 1e6
            head = self._buf[:HEADER].tolist()
            if head[0] != MAGIC:
                raise RuntimeError(f"sharded runner: bad header {head}")
            op = OPS[head[2]]
            st = self.stats[op]
            st["calls"] += 1
            st["wait_us"] += wait
            if op == "close":
                self.closed = True
                return
            if op == "abort":
                self.broken = True
                raise LeaderAborted(
                    f"the leader (rank {self.leader}) failed inside an op "
                    f"and aborted the sharded engine")
            if op == "noop":
                continue
            words = self._buf[HEADER:HEADER + head[3]].numpy().copy()
            self.handlers[op](*unpack(words), extra=None)

    def summary(self) -> dict:
        """Ops run and the host µs they cost a call: header send on the
        leader, header wait on a follower."""
        return {op: {"calls": s["calls"],
                     "send_us_per_call": s["send_us"] / s["calls"],
                     "wait_us_per_call": s["wait_us"] / s["calls"]}
                for op, s in self.stats.items() if s["calls"]}


def _keepalive(ref):
    while True:
        time.sleep(KEEPALIVE_S / 2)
        runner = ref()
        if runner is None or runner.closed or runner.broken:
            return
        try:
            runner._noop()
        except Exception:
            runner.broken = True
            return
        del runner
