"""Radix-trie prefix cache over the paged KV block pool (the port of
paddle_tpu/inference/prefix_cache.py, without its host spill tier).

Serving traffic repeats prefixes: system prompts, retries, multi-turn
histories. This module caches the KV of already-computed token prefixes
at block granularity and lets admission map them straight into a new
request's block table:

  radix trie    one node per FULL block of tokens, keyed by the block's
                token tuple, so matching a prompt is a walk of
                ``len(prompt) // block_size`` dict lookups, and two prompts
                sharing 3 system-prompt blocks share 3 trie nodes (and 3
                physical pool blocks).
  alignment     only full blocks are cached and shared. A partially
                filled block keeps taking decode writes from its owner, so
                it is never mapped into another request; the suffix past
                the matched blocks is prefilled (or, when it is just the
                last prompt token, re-decoded) privately.
  refcounts     the cache retains every block it caches (BlockPool
                refcounts); a request mapping a cached block adds its own
                reference. A cached block at refcount 1 (cache-only) is
                reclaimable; one a live request maps is not.
  copy-on-write the engine copies the LAST matched block into a private
                block when a full-hit request must write into it (the
                re-decode of the last prompt token lands at position
                ``plen - 1``, inside that block): shared blocks are never
                mutated.
  eviction      LRU over reclaimable leaves, cascading up the trie, under
                an optional byte budget (``bytes_per_block`` per node),
                and on demand when admission runs out of free blocks
                (``reclaim``): cached-but-idle prefixes are soft capacity.

The trie stores host data only (block ids and token keys); the pool
payloads stay on the device and are never read back. Content correctness
rests on determinism: the K/V rows at a position are a function of the
token prefix and the weights, so any block reached by the same token path
holds the same payload, and insert keeps the FIRST block cached under a
key and drops later duplicates without comparing device bytes.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple


class _Node:
    """One cached full block: token key, pool block id and LRU stamp."""
    __slots__ = ("key", "block", "parent", "children", "last_used")

    def __init__(self, key, block, parent):
        self.key = key                       # tuple of block_size token ids
        self.block = block                   # pool block id (never 0)
        self.parent = parent                 # _Node or the root
        self.children: Dict[tuple, "_Node"] = {}
        self.last_used = 0


class PrefixCache:
    """Radix trie of cached token prefixes over one :class:`BlockPool`.

    The cache does not own the device pools: it holds references on pool
    blocks (``pool.retain``) and releases them on eviction. All methods are
    host-side and O(prompt blocks) except the eviction scans, which are
    O(cached blocks) and run only on insert over budget and on reclaim."""

    def __init__(self, pool, *, byte_budget: Optional[int] = None):
        if byte_budget is not None and byte_budget < pool.bytes_per_block:
            raise ValueError(
                f"byte_budget {byte_budget} holds zero blocks "
                f"(one block = {pool.bytes_per_block} bytes)")
        self.pool = pool
        self.byte_budget = byte_budget
        self._root = _Node(key=None, block=0, parent=None)
        self._count = 0                     # cached blocks (nodes)
        self._tick = 0                      # monotonic LRU clock
        self.inserted_total = 0
        self.evicted_total = 0

    # ------------------------------------------------------------ stats
    @property
    def cached_blocks(self) -> int:
        return self._count

    @property
    def cached_bytes(self) -> int:
        return self._count * self.pool.bytes_per_block

    # ------------------------------------------------------------ match
    def _key(self, tokens, i: int) -> tuple:
        bs = self.pool.block_size
        return tuple(int(t) for t in tokens[i * bs:(i + 1) * bs])

    def match(self, tokens) -> Tuple[List[int], int]:
        """Longest cached full-block-aligned prefix of `tokens`: returns
        ``(block_ids, matched_tokens)``, block ids in prefix order and
        ``matched_tokens = len(block_ids) * block_size``. Stamps the
        matched chain's LRU clock (a hit is a use)."""
        self._tick += 1
        node = self._root
        blocks: List[int] = []
        for i in range(int(len(tokens)) // self.pool.block_size):
            child = node.children.get(self._key(tokens, i))
            if child is None:
                break
            child.last_used = self._tick
            blocks.append(child.block)
            node = child
        return blocks, len(blocks) * self.pool.block_size

    def lookup_continuation(self, tokens, n: int) -> List[int]:
        """Prompt-lookup drafting: the next up-to-``n`` tokens the trie
        remembers AFTER the prefix ``tokens``.

        Walks the full blocks of ``tokens`` like :meth:`match`, then
        follows children whose keys extend the partial tail: a matched
        node's token key is the continuation, so repeated traffic drafts
        its own future from what earlier requests computed. Returns a list
        of ints (possibly empty, shorter than ``n`` where the cached path
        ends). Read-only: a peek for a draft does not stamp the LRU clock.
        Where several cached paths extend the tail the first child wins
        (insertion order); a wrong guess costs one rejected draft token."""
        bs = self.pool.block_size
        node = self._root
        n_full = int(len(tokens)) // bs
        for i in range(n_full):
            child = node.children.get(self._key(tokens, i))
            if child is None:
                return []             # history diverged from every cache
            node = child
        tail = tuple(int(t) for t in tokens[n_full * bs:])
        out: List[int] = []
        while len(out) < n:
            nxt = None
            for key, child in node.children.items():
                if key[:len(tail)] == tail:
                    out.extend(key[len(tail):])
                    nxt = child
                    break
            if nxt is None:
                break
            node, tail = nxt, ()
        return out[:n]

    # ----------------------------------------------------------- insert
    def insert(self, tokens, blocks) -> int:
        """Cache the full-block prefix of `tokens`, whose K/V already
        lives in `blocks` (the owning request's table, prefix order).

        Existing nodes are kept and only stamped; each new node retains
        its block in the pool. Returns how many blocks were newly cached;
        evicts LRU reclaimable entries past the byte budget."""
        self._tick += 1
        node = self._root
        n = min(int(len(tokens)) // self.pool.block_size, len(blocks))
        added = 0
        for i in range(n):
            key = self._key(tokens, i)
            child = node.children.get(key)
            if child is None:
                blk = int(blocks[i])
                if blk == 0:
                    break                   # trash is never cached
                self.pool.retain([blk])
                child = _Node(key=key, block=blk, parent=node)
                node.children[key] = child
                self._count += 1
                added += 1
            child.last_used = self._tick
            node = child
        self.inserted_total += added
        if self.byte_budget is not None:
            self.evict_to_bytes(self.byte_budget)
        return added

    # --------------------------------------------------------- eviction
    def _reclaimable_leaves(self, protect=frozenset()) -> List[_Node]:
        out, stack = [], list(self._root.children.values())
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children.values())
            elif n.block not in protect and \
                    self.pool.refcount(n.block) == 1:  # cache-only ref
                out.append(n)
        return out

    def _drop(self, node: _Node) -> None:
        """Remove `node` from the trie and release its pool block."""
        del node.parent.children[node.key]
        self.pool.release([node.block])
        self._count -= 1
        self.evicted_total += 1

    def evict(self, n_blocks: int = 1, protect=()) -> int:
        """Free up to `n_blocks` blocks from LRU reclaimable entries
        (cascading: an evicted leaf may expose its parent). `protect`
        names blocks an in-flight admission has matched but not yet
        mapped: they survive even at refcount 1. Returns how many blocks
        went back to the pool's free list."""
        protect = frozenset(int(b) for b in protect)
        freed = 0
        while freed < n_blocks:
            leaves = self._reclaimable_leaves(protect)
            if not leaves:
                break
            leaves.sort(key=lambda n: n.last_used)
            for leaf in leaves:
                if freed >= n_blocks:
                    break
                self._drop(leaf)
                freed += 1
                # walk up while the parent became a reclaimable leaf:
                # deepest first keeps the hot prefix roots resident
                p = leaf.parent
                while (freed < n_blocks and p is not self._root
                       and p.block not in protect
                       and self.pool.refcount(p.block) == 1
                       and not p.children):
                    self._drop(p)
                    freed += 1
                    p = p.parent
        return freed

    def evict_to_bytes(self, budget: int) -> int:
        """Evict LRU entries until ``cached_bytes <= budget`` (or nothing
        reclaimable remains); returns blocks freed."""
        over = self.cached_bytes - budget
        if over <= 0:
            return 0
        need = -(-over // self.pool.bytes_per_block)
        return self.evict(need)

    def reclaim(self, n_blocks: int, protect=()) -> bool:
        """Admission pressure valve: evict until the pool has `n_blocks`
        free, sparing the `protect` blocks the admission is about to map.
        Returns True when the pool can now serve the allocation."""
        short = n_blocks - self.pool.free_blocks
        if short > 0:
            self.evict(short, protect=protect)
        return self.pool.free_blocks >= n_blocks

    def clear(self, release: bool = True) -> int:
        """Drop every cached entry; returns how many. ``release=False``
        skips the pool deref, for recovery after ``pool.reset()`` already
        wiped the refcounts."""
        dropped = 0
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            if release:
                self.pool.release([n.block])
            dropped += 1
        self._root.children.clear()
        self._count = 0
        self.evicted_total += dropped
        return dropped

    def __repr__(self):
        return (f"PrefixCache(blocks={self._count}, "
                f"bytes={self.cached_bytes}, budget={self.byte_budget})")
