"""Radix-trie prefix cache over the paged KV block pool (the port of
paddle_tpu/inference/prefix_cache.py).

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

The trie stores host data only (block ids and token keys); pool payloads
stay on the device — except through the optional host spill tier
(:meth:`PrefixCache.attach_spill`): with a ``kv_cache.HostSpillTier``
attached, an LRU-evicted full block copies its device payload to host
memory instead of vanishing (``node.block = SPILLED``, the payload parked
on the node), and a later trie hit REHYDRATES it: one ownerless pool block
(``BlockPool.take``) and one host->device copy of the stacked payload.
The round trip moves bytes and never recomputes them, so a rehydrated
block equals its bytes before the spill. The tier's own byte budget drops
LRU spilled leaves for good when host memory runs out. Invariant: a
spilled node's descendants are all spilled (spill cascades deepest-first,
rehydrate and upgrade walk root-down), so the tier's LRU always finds a
childless spilled leaf to drop.

Content correctness rests on determinism: the K/V rows at a position are
a function of the token prefix and the weights, so any block reached by
the same token path holds the same payload; insert keeps the FIRST block
cached under a key and drops later duplicates without comparing device
bytes (and an insert that passes a spilled node upgrades it in place with
the freshly recomputed block).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

# node.block sentinel: the payload lives in the host spill tier, not in
# any pool block (real ids are >= 1; 0 is the pool's trash block)
SPILLED = -1


class _Node:
    """One cached full block: token key, pool block id (or SPILLED),
    LRU stamp, and — while spilled — the host payload."""
    __slots__ = ("key", "block", "parent", "children", "last_used",
                 "payload")

    def __init__(self, key, block, parent):
        self.key = key                       # tuple of block_size token ids
        self.block = block                   # pool block id (never 0)
        self.parent = parent                 # _Node or the root
        self.children: Dict[tuple, "_Node"] = {}
        self.last_used = 0
        self.payload = None                  # host arrays while spilled


class PrefixCache:
    """Radix trie of cached token prefixes over one :class:`BlockPool`.

    The cache does NOT own the device pools — it holds references on pool
    blocks (``pool.retain``) and releases them on eviction. All methods
    are host-side and O(prompt blocks) except eviction scans, which are
    O(cached blocks) and only run on insert-over-budget / reclaim."""

    def __init__(self, pool, *, byte_budget: Optional[int] = None):
        if byte_budget is not None and byte_budget < pool.bytes_per_block:
            raise ValueError(
                f"byte_budget {byte_budget} holds zero blocks "
                f"(one block = {pool.bytes_per_block} bytes)")
        self.pool = pool
        self.byte_budget = byte_budget
        self._root = _Node(key=None, block=0, parent=None)
        self._count = 0                     # device-cached blocks (nodes)
        self._spilled = 0                   # host-spilled nodes
        self._tick = 0                      # monotonic LRU clock
        self.inserted_total = 0
        self.evicted_total = 0
        # host spill tier : attach_spill wires these
        self._spill = None                  # kv_cache.HostSpillTier
        self._read = None                   # reader(block) -> payload
        self._write = None                  # writer(block, payload)
        self._rehydrating = None            # node mid-rehydrate: the
        #                                     tier's own LRU must not
        #                                     drop it (its eviction path
        #                                     can run INSIDE _rehydrate)

    def attach_spill(self, tier, *, reader, writer) -> "PrefixCache":
        """Wire the host-RAM spill tier: ``reader(block) -> payload``
        serializes one device block (the engine's ``pool.read_block``
        over its live pools), ``writer(block, payload)`` copies a
        payload into a fresh device block of the engine's pools — both
        are closures over the engine because the cache deliberately never
        holds the device tensors."""
        self._spill = tier
        self._read = reader
        self._write = writer
        return self

    # ------------------------------------------------------------ stats
    @property
    def cached_blocks(self) -> int:
        return self._count

    @property
    def spilled_blocks(self) -> int:
        return self._spilled

    @property
    def cached_bytes(self) -> int:
        return self._count * self.pool.bytes_per_block

    # ------------------------------------------------------------ match
    def _key(self, tokens, i: int) -> tuple:
        bs = self.pool.block_size
        return tuple(int(t) for t in tokens[i * bs:(i + 1) * bs])

    def match(self, tokens) -> Tuple[List[int], int]:
        """Longest cached full-block-aligned prefix of `tokens`.

        Returns ``(block_ids, matched_tokens)`` — block ids in prefix
        order, ``matched_tokens = len(block_ids) * block_size``. Stamps
        the matched chain's LRU clock (a hit is a use). A SPILLED node
        on the walk is rehydrated in place (one fresh pool block, one
        host→device copy) before its id joins the match; when no pool
        block can be found even after evicting, the walk stops there —
        the request simply prefills the rest, and its insert upgrades
        the spilled node with the recomputed block."""
        self._tick += 1
        node = self._root
        blocks: List[int] = []
        for i in range(int(len(tokens)) // self.pool.block_size):
            child = node.children.get(self._key(tokens, i))
            if child is None:
                break
            if child.block == SPILLED and not self._rehydrate(child,
                                                              blocks):
                break
            child.last_used = self._tick
            blocks.append(child.block)
            node = child
        return blocks, len(blocks) * self.pool.block_size

    def _rehydrate(self, node: _Node, protect) -> bool:
        """Bring one spilled node back on device: take an ownerless pool
        block (evicting/spilling a colder one if the free list is dry,
        sparing the `protect` run this match already claimed), scatter
        the host payload into it (one host→device copy per payload
        tensor), and make the node a normal
        device-cached entry again."""
        # the eviction below may spill another block, whose _trim_spill
        # scans LRU spilled leaves — this very node is one (stale stamp,
        # childless) and must survive until its payload is written back
        self._rehydrating = node
        try:
            got = self.pool.take(1)
            if got is None and self.evict(1, protect=protect):
                got = self.pool.take(1)
        finally:
            self._rehydrating = None
        if got is None:
            return False
        blk = got[0]
        self._write(blk, node.payload)
        t = self._spill
        t.h2d_copies += len(node.payload)
        t.rehydrated_total += 1
        t.spilled_blocks -= 1
        node.block = blk
        node.payload = None
        self._spilled -= 1
        self._count += 1
        return True

    def lookup_continuation(self, tokens, n: int):
        """Prompt-lookup drafting: the next up-to-``n`` tokens
        the trie remembers AFTER the prefix ``tokens``.

        Walks the full blocks of ``tokens`` exactly like :meth:`match`,
        then follows children whose keys extend the partial tail — a
        matched node's cached token key IS the continuation, so repeated
        / agentic traffic (identical prompts, retries, multi-turn
        histories) drafts its own future from what earlier requests
        already computed, with no draft model at all. Returns a list of
        ints (possibly empty; shorter than ``n`` when the cached path
        runs out). Read-only: does NOT stamp the LRU clock — peeking for
        a draft must not pin a prefix resident the way serving KV from
        it does. When several cached paths extend the same tail the
        first child wins (dict insertion order — deterministic within a
        process); a wrong guess costs one rejected draft token, nothing
        more."""
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

        Existing nodes are kept as-is (same token path = bit-identical
        payload — see module docstring) and only stamped; each NEW node
        retains its block in the pool. Returns how many blocks were newly
        cached; evicts LRU reclaimable entries past the byte budget."""
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
            elif child.block == SPILLED:
                # the inserting request RECOMPUTED this block's KV (its
                # match stopped short of a rehydrate) — upgrade in
                # place: adopt the fresh device block, drop the host
                # payload (determinism: same token path ⇒ bit-identical
                # bytes either way)
                blk = int(blocks[i])
                if blk == 0:
                    break
                self.pool.retain([blk])
                child.block = blk
                child.payload = None
                self._spilled -= 1
                self._count += 1
                added += 1
                if self._spill is not None:
                    self._spill.spilled_blocks -= 1
                    self._spill.upgraded_total += 1
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

    def _spill_candidates(self, protect=frozenset()) -> List[_Node]:
        """Device-resident, cache-only-referenced nodes whose children
        are ALL spilled (or absent) — the spill analog of a reclaimable
        leaf. The all-spilled condition keeps the invariant that a
        spilled node's descendants are spilled, so the tier's LRU drop
        always finds a childless victim."""
        out, stack = [], list(self._root.children.values())
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            if (n.block != SPILLED and n.block not in protect
                    and self.pool.refcount(n.block) == 1
                    and all(c.block == SPILLED
                            for c in n.children.values())):
                out.append(n)
        return out

    def _drop(self, node: _Node) -> None:
        """Remove `node` from the trie for good: a device node releases
        its pool block; a spilled node releases its host payload (the
        tier's final-death accounting — its device eviction was already
        counted when it spilled)."""
        del node.parent.children[node.key]
        if node.block == SPILLED:
            node.payload = None
            self._spilled -= 1
            if self._spill is not None:
                self._spill.spilled_blocks -= 1
                self._spill.dropped_total += 1
        else:
            self.pool.release([node.block])
            self._count -= 1
            self.evicted_total += 1

    def _spill_node(self, node: _Node) -> None:
        """Device→host spill of one node: serialize the block's payload
        (one stacked device→host fetch), free the device block, keep the
        node in the trie as SPILLED. Trims the tier's own LRU afterwards
        so host RAM stays inside its budget."""
        payload = self._read(node.block)
        self.pool.release([node.block])
        node.block = SPILLED
        node.payload = payload
        self._count -= 1
        self._spilled += 1
        self.evicted_total += 1
        t = self._spill
        t.spilled_blocks += 1
        t.spilled_total += 1
        t.d2h_copies += len(payload)
        self._trim_spill()

    def _trim_spill(self) -> None:
        """Drop LRU childless spilled leaves until the host tier is back
        under its byte budget — the spill tier's own final eviction."""
        t = self._spill
        while t.over_budget_blocks > 0:
            leaves = []
            stack = list(self._root.children.values())
            while stack:
                n = stack.pop()
                stack.extend(n.children.values())
                if n.block == SPILLED and not n.children \
                        and n is not self._rehydrating:
                    leaves.append(n)
            if not leaves:
                break
            leaves.sort(key=lambda n: n.last_used)
            for leaf in leaves[:t.over_budget_blocks]:
                self._drop(leaf)

    def evict(self, n_blocks: int = 1, protect=()) -> int:
        """Free up to `n_blocks` DEVICE blocks from LRU reclaimable
        entries (cascading: an evicted leaf may expose its parent).
        With a spill tier attached the evicted payloads serialize to
        host RAM (the node survives as SPILLED and can rehydrate);
        without one this is the final death it always was. `protect`
        names blocks an in-flight admission has matched but not yet
        mapped — they must survive even at refcount 1. Returns how many
        blocks went back to the pool's free list."""
        protect = frozenset(int(b) for b in protect)
        spill = self._spill is not None
        freed = 0
        while freed < n_blocks:
            leaves = self._spill_candidates(protect) if spill \
                else self._reclaimable_leaves(protect)
            if not leaves:
                break
            leaves.sort(key=lambda n: n.last_used)
            for leaf in leaves:
                if freed >= n_blocks:
                    break
                self._spill_node(leaf) if spill else self._drop(leaf)
                freed += 1
                # walk up while the parent became a candidate —
                # deepest-first keeps the hot prefix roots resident
                p = leaf.parent
                while (freed < n_blocks and p is not self._root
                       and p.block != SPILLED
                       and p.block not in protect
                       and self.pool.refcount(p.block) == 1
                       and (all(c.block == SPILLED
                                for c in p.children.values())
                            if spill else not p.children)):
                    self._spill_node(p) if spill else self._drop(p)
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
        free (cached-but-idle prefixes are soft capacity), sparing the
        `protect` blocks the admission is about to map. Returns True
        when the pool can now serve the allocation."""
        short = n_blocks - self.pool.free_blocks
        if short > 0:
            self.evict(short, protect=protect)
        return self.pool.free_blocks >= n_blocks

    def clear(self, release: bool = True) -> int:
        """Drop every cached entry — device AND spilled. ``release=
        False`` skips the pool deref — for recovery after
        ``pool.reset()`` already wiped the refcounts (the engine's
        exception path); spilled payloads are dropped either way."""
        dropped = device_dropped = 0
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            if n.block == SPILLED:
                # its DEVICE eviction was already counted at spill time
                n.payload = None
                if self._spill is not None:
                    self._spill.spilled_blocks -= 1
                    self._spill.dropped_total += 1
            else:
                if release:
                    self.pool.release([n.block])
                device_dropped += 1
            dropped += 1
        self._root.children.clear()
        self._count = 0
        self._spilled = 0
        self.evicted_total += device_dropped
        return dropped

    def __repr__(self):
        return (f"PrefixCache(blocks={self._count}, "
                f"spilled={self._spilled}, "
                f"bytes={self.cached_bytes}, "
                f"budget={self.byte_budget})")
