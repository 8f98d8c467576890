"""Block-paged KV-cache pool for serving (the port of
paddle_tpu/inference/kv_cache.py's BlockPool).

Device state is one fixed-shape tensor per layer and K/V plane,
``[num_blocks, block_size, num_heads, head_dim]`` (int8 pools: codes of
that shape plus f32 scales ``[num_blocks, block_size, num_heads]``), plus
an int32 block table ``[B, max_blocks]`` and a length vector ``[B]`` that
the engine ships with every call. A request owns ``ceil(tokens /
block_size)`` blocks scattered anywhere in the pool; they return to the
free list the moment it finishes.

``BlockPool`` is the HOST-side allocator: free list, per-owner block
lists, occupancy accounting. The device tensors it creates belong to the
caller, which updates them in place.

Block 0 is the TRASH block: table padding entries and writes that must go
nowhere (right-padded prompt columns past a row's blocks, dummy batch
slots) land there, so the scatters never need a mask. Usable capacity is
``(num_blocks - 1) * block_size`` tokens.

Blocks are refcounted: the prefix cache (inference/prefix_cache.py)
retains the blocks it caches, and a request admitted on a cached prefix
maps them SHARED into its own reservation; a block returns to the free
list when its last reference drops.

The host spill tier: ``read_block`` copies one block's payload (every
layer's K and V planes, and the int8 scales) to host memory, pinned when
the pool lives on a CUDA device, and ``write_block`` copies it back into a
pool block; ``HostSpillTier`` is the host byte budget and the counters of
the prefix cache's spilled blocks.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from . import executables


class BlockPool:
    """Fixed-size KV block allocator (host bookkeeping + device pools).

    num_blocks counts the reserved trash block 0; block_size is KV rows
    per block; num_layers / num_heads / head_dim / dtype / device give
    the pool geometry, normally from the model via :meth:`for_model`;
    device None is CUDA (``resolve_device``: it raises where there is
    none, like the models and the optimizers). cache_dtype None keeps the model dtype, "int8" stores (codes int8,
    scale f32) with one factored scale per (row, head)."""

    def __init__(self, *, num_blocks: int, block_size: int,
                 num_layers: int, num_heads: int, head_dim: int,
                 dtype=torch.float32, device=None, cache_dtype=None):
        if num_blocks < 2:
            raise ValueError("num_blocks must be >= 2 (block 0 is the "
                             "reserved trash block)")
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        if cache_dtype not in (None, "int8"):
            raise ValueError(f"cache_dtype must be None or 'int8'; "
                             f"got {cache_dtype!r}")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.num_layers = int(num_layers)
        self.num_heads = int(num_heads)
        self.head_dim = int(head_dim)
        self.dtype = dtype
        self.device = resolve_device(device)
        self.cache_dtype = cache_dtype
        # LIFO free list: recently freed blocks are re-issued first
        self._free: List[int] = list(range(self.num_blocks - 1, 0, -1))
        self._rows: Dict[int, List[int]] = {}
        self._refs: Dict[int, int] = {}     # block id -> reference count
        # observer poked after every occupancy change (alloc, free, take,
        # release, reset): the MemoryLedger's per-owner delta stream rides
        # it, so it must stay host-side and cheap
        self.on_change = None

    @classmethod
    def for_model(cls, model, *, num_blocks: int, block_size: int,
                  cache_dtype=None):
        """Geometry, dtype and device from a GPTForCausalLM."""
        cfg = model.config
        return cls(num_blocks=num_blocks, block_size=block_size,
                   num_layers=cfg.num_layers, num_heads=cfg.num_heads,
                   head_dim=cfg.head_dim, dtype=model.dtype,
                   device=model.device, cache_dtype=cache_dtype)

    def make_pools(self) -> List[tuple]:
        """Fresh zeroed pools on the pool's device. Per layer ``(k, v)``
        each ``[NB, bs, H, D]``, or for int8 ``(k_codes, k_scale,
        v_codes, v_scale)`` with int8 codes and f32 ``[NB, bs, H]``
        scales. The allocator keeps no reference to them."""
        shape = (self.num_blocks, self.block_size, self.num_heads,
                 self.head_dim)

        def zeros(shp, dt):
            return torch.zeros(shp, dtype=dt, device=self.device)

        if self.cache_dtype == "int8":
            return [(zeros(shape, torch.int8), zeros(shape[:3], torch.float32),
                     zeros(shape, torch.int8), zeros(shape[:3], torch.float32))
                    for _ in range(self.num_layers)]
        return [(zeros(shape, self.dtype), zeros(shape, self.dtype))
                for _ in range(self.num_layers)]

    # ------------------------------------------------------------- sizing
    def blocks_needed(self, tokens: int) -> int:
        return max(0, math.ceil(int(tokens) / self.block_size))

    @property
    def capacity_blocks(self) -> int:
        """Allocatable blocks (trash block excluded)."""
        return self.num_blocks - 1

    @property
    def capacity_tokens(self) -> int:
        return self.capacity_blocks * self.block_size

    @property
    def bytes_per_block(self) -> int:
        """Device bytes ONE block pins across every layer's K and V pools
        (codes and f32 scales for int8): the unit the prefix cache's byte
        budget is charged in."""
        rows = self.block_size * self.num_heads
        if self.cache_dtype == "int8":
            per = rows * self.head_dim + rows * 4
        else:
            per = rows * self.head_dim * self.dtype.itemsize
        return 2 * per * self.num_layers

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return self.capacity_blocks - len(self._free)

    def fits_ever(self, tokens: int) -> bool:
        """Could a request needing `tokens` KV rows ever be served (with
        every other request drained)? False means reject: waiting would
        never help."""
        return self.blocks_needed(tokens) <= self.capacity_blocks

    # --------------------------------------------------------- alloc/free
    def alloc(self, owner: int, tokens: int,
              shared=None) -> Optional[np.ndarray]:
        """Reserve blocks covering `tokens` KV rows for `owner`.

        `shared` maps already-populated blocks, in prefix order, into the
        reservation: each gains a reference, and only
        ``blocks_needed(tokens) - len(shared)`` fresh blocks come off the
        free list, after the shared run. Returns the int32 block-id vector
        (the owner's table row in position order), or None when too few
        blocks are free right now. An owner holds one reservation; a
        second alloc raises."""
        if owner in self._rows:
            raise ValueError(f"owner {owner} already holds "
                             f"{len(self._rows[owner])} blocks; free first")
        shared = [int(b) for b in (shared or ())]
        if any(b == 0 for b in shared):
            raise ValueError("the trash block (0) is never shared")
        n = self.blocks_needed(tokens) - len(shared)
        if n < 0:
            raise ValueError(f"shared prefix ({len(shared)} blocks) longer "
                             f"than the reservation ({tokens} tokens)")
        if n > len(self._free):
            return None
        for b in shared:
            if self._refs.get(b, 0) < 1:
                raise ValueError(f"block {b} is not live; cannot share")
            self._refs[b] += 1
        fresh = [self._free.pop() for _ in range(n)]
        for b in fresh:
            self._refs[b] = 1
        blocks = shared + fresh
        self._rows[owner] = blocks
        self._notify()
        return np.asarray(blocks, dtype=np.int32)

    def free(self, owner: int) -> int:
        """Drop `owner`'s reference on every block it holds; returns how
        many actually returned to the free list (a block another owner or
        the prefix cache still references stays resident). Freeing an
        unknown owner is a no-op (0)."""
        blocks = self._rows.pop(owner, None)
        if not blocks:
            return 0
        freed = self._deref(reversed(blocks))
        self._notify()
        return freed

    def take(self, n: int = 1) -> Optional[List[int]]:
        """Reserve `n` ownerless blocks at refcount 1: the rehydrate
        path's allocation (a spilled prefix block coming back from host
        memory belongs to the cache, not to a request); balanced by
        :meth:`release`. Returns the block ids, or None when the free list
        is short."""
        if n < 1 or n > len(self._free):
            return None
        out = []
        for _ in range(n):
            b = self._free.pop()
            self._refs[b] = 1
            out.append(b)
        self._notify()
        return out

    # ------------------------------------------------- cache references
    def retain(self, blocks) -> None:
        """Add one reference per block: how the prefix cache pins a cached
        prefix independent of the request that computed it."""
        for b in blocks:
            b = int(b)
            if b == 0:
                raise ValueError("the trash block (0) is never retained")
            if self._refs.get(b, 0) < 1:
                raise ValueError(f"block {b} is not live; cannot retain")
            self._refs[b] += 1

    def release(self, blocks) -> int:
        """Drop one reference per block (cache eviction); returns how many
        hit zero and went back to the free list."""
        freed = self._deref(int(b) for b in blocks)
        self._notify()
        return freed

    def refcount(self, block: int) -> int:
        return self._refs.get(int(block), 0)

    def _deref(self, blocks) -> int:
        freed = 0
        for b in blocks:
            b = int(b)
            r = self._refs.get(b, 0)
            if r < 1:
                raise ValueError(f"refcount underflow on block {b}")
            if r == 1:
                del self._refs[b]
                self._free.append(b)
                freed += 1
            else:
                self._refs[b] = r - 1
        return freed

    def owned(self, owner: int) -> List[int]:
        return list(self._rows.get(owner, ()))

    def table_row(self, owner: int, width: int) -> np.ndarray:
        """The owner's int32 block-table row, zero-padded (trash block) to
        `width` entries."""
        blocks = self._rows.get(owner, ())
        if len(blocks) > width:
            raise ValueError(f"owner {owner} holds {len(blocks)} blocks "
                             f"> table width {width}")
        row = np.zeros((width,), dtype=np.int32)
        row[:len(blocks)] = blocks
        return row

    # --------------------------------------------------------- accounting
    def occupancy(self, live_tokens: int) -> float:
        """True-token occupancy: live KV rows over pooled capacity."""
        return live_tokens / max(self.capacity_tokens, 1)

    def slots_occupancy(self) -> float:
        """Allocated blocks over capacity (includes within-block padding
        and worst-case reservations)."""
        return self.used_blocks / max(self.capacity_blocks, 1)

    def reset(self):
        self._free = list(range(self.num_blocks - 1, 0, -1))
        self._rows.clear()
        self._refs.clear()
        self._notify()

    def _notify(self):
        cb = self.on_change
        if cb is not None:
            cb()

    # ---------------------------------------------------- spill payloads
    def read_block(self, pools, block: int) -> tuple:
        """ONE block's payload copied to host memory: the spill tier's
        device->host serialization. Every layer's planes for `block` are
        stacked on the device into one tensor per storage dtype (fp
        pools: one [2L, bs, H, D] stack, K then V per layer; int8 pools:
        an int8 code stack and an f32 [2L, bs, H] scale stack) and each
        stack moves to the host in ONE copy, into pinned memory when the
        pool is on a CUDA device. The copy is a blocking one, so the
        payload is complete when this returns. Returns the tuple of host
        tensors `write_block` takes back verbatim: the round trip moves
        bytes and never recomputes them."""
        b = int(block)
        if self.cache_dtype == "int8":
            stacks = (torch.stack([layer[i][b] for layer in pools
                                   for i in (0, 2)]),
                      torch.stack([layer[i][b] for layer in pools
                                   for i in (1, 3)]))
        else:
            stacks = (torch.stack([p[b] for layer in pools
                                   for p in layer]),)
        pin = stacks[0].device.type == "cuda"
        out = []
        for st in stacks:
            host = torch.empty(st.shape, dtype=st.dtype, pin_memory=pin)
            host.copy_(st)
            out.append(host)
        return tuple(out)

    def write_block(self, pools, block: int, payload: tuple):
        """Copy one spilled payload back into pool position `block`, in
        place: one host->device copy per payload tensor (asynchronous from
        pinned memory, on the current stream, so every later launch on
        that stream reads the written block), then one multi-tensor copy
        per payload tensor of its slices into every layer's planes (one
        dtype a call). Returns the pools."""
        executables.note_process(self._spill_sig())
        b = int(block)
        dev = pools[0][0].device
        planes = (0, 2) if self.cache_dtype == "int8" else (0, 1)
        for k, t in enumerate(payload):
            stack = t.to(dev, non_blocking=True)
            torch._foreach_copy_([layer[i + k][b] for layer in pools
                                  for i in planes], list(stack.unbind(0)))
        return pools

    def _spill_sig(self) -> tuple:
        return ("spill_scatter", self.num_blocks, self.block_size,
                self.num_layers, self.num_heads, self.head_dim,
                str(self.dtype), self.cache_dtype, 1)

    def __repr__(self):
        return (f"BlockPool(blocks={self.num_blocks}x{self.block_size}, "
                f"free={self.free_blocks}/{self.capacity_blocks}, "
                f"owners={len(self._rows)})")


class HostSpillTier:
    """Host-memory budget and counters of spilled prefix blocks.

    The PrefixCache owns the trie-side mechanics (which node spills,
    where payloads live, LRU ordering); this class is the accounting: a
    byte budget charged at ``bytes_per_block`` per spilled block (the host
    copy carries the same payload bytes as the device block), occupancy,
    and the spill/rehydrate/drop/copy counters. An LRU-evicted full block
    copies here instead of vanishing, and a later trie hit rehydrates it
    with one host->device copy per payload tensor instead of recomputing
    its prefill."""

    def __init__(self, *, bytes_per_block: int, byte_budget: int):
        if byte_budget < bytes_per_block:
            raise ValueError(
                f"spill byte_budget {byte_budget} holds zero blocks "
                f"(one block = {bytes_per_block} bytes)")
        self.bytes_per_block = int(bytes_per_block)
        self.byte_budget = int(byte_budget)
        self.spilled_blocks = 0       # resident in the tier right now
        self.spilled_total = 0        # blocks ever copied to host
        self.rehydrated_total = 0     # blocks copied back to the device
        self.dropped_total = 0        # tier-LRU final deaths (payload
        #                               discarded for good)
        self.upgraded_total = 0       # spilled entries replaced in
        #                               place by a recomputed device
        #                               block (the prefix survives: not
        #                               a drop)
        self.d2h_copies = 0           # host tensors fetched (spill side)
        self.h2d_copies = 0           # host tensors shipped (rehydrate)

    @property
    def capacity_blocks(self) -> int:
        return self.byte_budget // self.bytes_per_block

    @property
    def host_bytes(self) -> int:
        return self.spilled_blocks * self.bytes_per_block

    @property
    def over_budget_blocks(self) -> int:
        """Blocks the tier must drop to get back under budget."""
        return max(0, self.spilled_blocks - self.capacity_blocks)

    def stats(self) -> dict:
        return {"spilled_blocks": self.spilled_blocks,
                "host_bytes": self.host_bytes,
                "byte_budget": self.byte_budget,
                "spilled_total": self.spilled_total,
                "rehydrated_total": self.rehydrated_total,
                "dropped_total": self.dropped_total,
                "upgraded_total": self.upgraded_total,
                "d2h_copies": self.d2h_copies,
                "h2d_copies": self.h2d_copies}

    def metrics_text(self, prefix: str = "paddle_tpu_spill") -> str:
        """Prometheus exposition of the tier, registered beside the
        serving producers in `ServingEngine.metrics_registry()`."""
        from ..profiler._metrics import counter_lines, gauge_lines
        lines: List[str] = []
        for name, help_ in (
                ("spilled", "prefix blocks serialized to host RAM"),
                ("rehydrated", "spilled blocks copied back to device"),
                ("dropped", "spilled blocks evicted from the host tier "
                            "(payload lost for good)"),
                ("upgraded", "spilled entries replaced in place by a "
                             "recomputed device block"),
                ("d2h_copies", "device->host payload arrays (spill)"),
                ("h2d_copies", "host->device payload arrays (rehydrate)")):
            attr = name if name.endswith("copies") else f"{name}_total"
            lines.extend(counter_lines(prefix, f"{name}_total",
                                       getattr(self, attr), help_))
        lines.extend(gauge_lines(prefix, "host_blocks",
                                 self.spilled_blocks,
                                 "spilled blocks resident in host RAM"))
        lines.extend(gauge_lines(prefix, "host_bytes", self.host_bytes,
                                 "host RAM the spill tier pins"))
        return "\n".join(lines) + "\n"

    def __repr__(self):
        return (f"HostSpillTier(blocks={self.spilled_blocks}/"
                f"{self.capacity_blocks}, bytes={self.host_bytes}/"
                f"{self.byte_budget})")
