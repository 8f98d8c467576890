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
``(num_blocks - 1) * block_size`` tokens. Shared (refcounted) blocks and
the host spill tier arrive with the prefix-cache slice.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch


class BlockPool:
    """Fixed-size KV block allocator (host bookkeeping + device pools).

    num_blocks counts the reserved trash block 0; block_size is KV rows
    per block; num_layers / num_heads / head_dim / dtype / device give
    the pool geometry, normally from the model via :meth:`for_model`.
    cache_dtype None keeps the model dtype, "int8" stores (codes int8,
    scale f32) with one factored scale per (row, head)."""

    def __init__(self, *, num_blocks: int, block_size: int,
                 num_layers: int, num_heads: int, head_dim: int,
                 dtype=torch.float32, device="cpu", cache_dtype=None):
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
        self.device = torch.device(device)
        self.cache_dtype = cache_dtype
        # LIFO free list: recently freed blocks are re-issued first
        self._free: List[int] = list(range(self.num_blocks - 1, 0, -1))
        self._rows: Dict[int, List[int]] = {}

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
    def alloc(self, owner: int, tokens: int) -> Optional[np.ndarray]:
        """Reserve blocks covering `tokens` KV rows for `owner`. Returns
        the int32 block-id vector (the owner's table row in position
        order), or None when too few blocks are free right now. An owner
        holds one reservation; a second alloc raises."""
        if owner in self._rows:
            raise ValueError(f"owner {owner} already holds "
                             f"{len(self._rows[owner])} blocks; free first")
        n = self.blocks_needed(tokens)
        if n > len(self._free):
            return None
        blocks = [self._free.pop() for _ in range(n)]
        self._rows[owner] = blocks
        return np.asarray(blocks, dtype=np.int32)

    def free(self, owner: int) -> int:
        """Return every block `owner` holds to the free list; returns how
        many. Freeing an unknown owner is a no-op (0)."""
        blocks = self._rows.pop(owner, None)
        if not blocks:
            return 0
        self._free.extend(reversed(blocks))
        return len(blocks)

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

    def __repr__(self):
        return (f"BlockPool(blocks={self.num_blocks}x{self.block_size}, "
                f"free={self.free_blocks}/{self.capacity_blocks}, "
                f"owners={len(self._rows)})")
