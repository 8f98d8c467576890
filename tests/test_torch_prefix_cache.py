"""PyTorch port vs JAX package: the prefix cache's radix trie and the block
pool's refcounts.

The port's PrefixCache + BlockPool and the JAX package's are driven
through one sequence of shared allocations, inserts, matches, prompt
lookups, evictions, reclaims and clears; every returned value, block id,
refcount and free count must be equal, and every reference must be
accounted for (owners' plus the cache's).
"""
import numpy as np
import pytest
import torch

from paddle_tpu.inference.kv_cache import BlockPool as JBlockPool
from paddle_tpu.inference.prefix_cache import PrefixCache as JPrefixCache
import paddle_tpu_torch as pt

GEO = dict(num_blocks=24, block_size=4, num_layers=2, num_heads=2,
           head_dim=8)


def _pair(byte_budget_blocks=None):
    tp, jp = pt.BlockPool(**GEO, device="cpu"), JBlockPool(**GEO)
    budget = None if byte_budget_blocks is None \
        else byte_budget_blocks * tp.bytes_per_block
    return (tp, pt.PrefixCache(tp, byte_budget=budget),
            jp, JPrefixCache(jp, byte_budget=budget))


def _same_state(tp, tc, jp, jc):
    assert tp.free_blocks == jp.free_blocks
    assert tp._free == jp._free
    assert tp._refs == jp._refs
    assert tc.cached_blocks == jc.cached_blocks
    assert tc.cached_bytes == jc.cached_bytes
    # conservation: each live block's refcount is its owners' references
    # plus one when the trie caches it
    held = {}
    for blocks in tp._rows.values():
        for b in blocks:
            held[b] = held.get(b, 0) + 1
    stack = list(tc._root.children.values())
    while stack:
        n = stack.pop()
        stack.extend(n.children.values())
        held[n.block] = held.get(n.block, 0) + 1
    assert held == tp._refs
    assert len(tp._refs) + tp.free_blocks == tp.capacity_blocks


def _prompt(seed, n):
    return np.random.RandomState(seed).randint(1, 50, (n,)).astype(np.int64)


def test_bytes_per_block_matches_jax():
    for cache_dtype in (None, "int8"):
        a = pt.BlockPool(**GEO, cache_dtype=cache_dtype, device="cpu")
        b = JBlockPool(**GEO, cache_dtype=cache_dtype)
        assert a.bytes_per_block == b.bytes_per_block


def test_pool_without_a_device_is_a_cuda_pool(monkeypatch):
    """BlockPool resolves its device as the models and optimizers do: no
    device means CUDA, and without CUDA that raises resolve_device's error
    instead of building a CPU pool nobody asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        pt.BlockPool(**GEO)
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        pt.BlockPool(**GEO, cache_dtype="int8")
    assert pt.BlockPool(**GEO, device="cpu").device == torch.device("cpu")


def test_shared_alloc_refcounts_match_jax():
    tp, _, jp, _ = _pair()
    for p in (tp, jp):
        p.alloc(0, 12)
    shared = tp.owned(0)[:2]
    a = tp.alloc(1, 14, shared=shared)
    b = jp.alloc(1, 14, shared=shared)
    np.testing.assert_array_equal(a, b)
    assert [tp.refcount(x) for x in a] == [jp.refcount(x) for x in b]
    assert tp.refcount(shared[0]) == 2
    got = [tp.take(2), tp.free(0), tp.free(1)]
    want = [jp.take(2), jp.free(0), jp.free(1)]
    got.append(tp.release(got[0]))
    want.append(jp.release(want[0]))
    assert got == want and got[-1] == 2
    assert tp.free_blocks == tp.capacity_blocks
    assert tp._refs == jp._refs and tp._free == jp._free
    for p in (tp, jp):
        with pytest.raises(ValueError, match="trash"):
            p.alloc(9, 4, shared=[0])
        with pytest.raises(ValueError, match="not live"):
            p.retain([23])
        with pytest.raises(ValueError, match="longer than"):
            p.alloc(9, 4, shared=[int(x) for x in a[:2]])


def test_trie_sequence_matches_jax():
    """Insert two prompts sharing two blocks, match, look up drafts, free
    the owners, evict, reclaim under pressure with a protected run, and
    clear: the port and the JAX package agree at every step."""
    tp, tc, jp, jc = _pair()
    base = _prompt(0, 16)
    other = base.copy()
    other[8:] = _prompt(1, 8)
    ops = [("alloc", 0, base, 16), ("insert", 0, base, 16),
           ("alloc", 1, other, 20), ("insert", 1, other, 16),
           ("match", None, base, None), ("match", None, other, None),
           ("match", None, _prompt(2, 9), None),
           ("lookup", None, base[:6], 8), ("lookup", None, other[:9], 3),
           ("lookup", None, _prompt(3, 5), 4),
           ("free", 0, None, None),
           ("evict", None, None, 1), ("match", None, base, None),
           ("free", 1, None, None), ("reclaim", None, other, 22),
           ("alloc", 2, base, 8), ("insert", 2, base, 8),
           ("evict", None, None, 5), ("free", 2, None, None),
           ("clear", None, None, None)]
    for op, owner, toks, n in ops:
        outs = []
        for pool, cache in ((tp, tc), (jp, jc)):
            if op == "alloc":
                matched, t = cache.match(toks)
                blocks = pool.alloc(owner, n, shared=matched)
                outs.append((None if blocks is None else list(blocks), t))
            elif op == "insert":
                outs.append(cache.insert(toks[:n], pool.owned(owner)))
            elif op == "match":
                outs.append(cache.match(toks))
            elif op == "lookup":
                outs.append(cache.lookup_continuation(toks, n))
            elif op == "free":
                outs.append(pool.free(owner))
            elif op == "evict":
                outs.append(cache.evict(n))
            elif op == "reclaim":
                protect = cache.match(toks)[0]
                outs.append((cache.reclaim(n, protect=protect),
                             [pool.refcount(b) for b in protect]))
            else:
                outs.append(cache.clear())
        assert outs[0] == outs[1], (op, outs)
        _same_state(tp, tc, jp, jc)
    assert tp.free_blocks == tp.capacity_blocks


def test_byte_budget_evicts_like_jax():
    """A 3-block budget: inserting a third prompt's blocks evicts the LRU
    reclaimable leaves, cascading up, exactly as the JAX cache does."""
    tp, tc, jp, jc = _pair(byte_budget_blocks=3)
    for i in range(3):
        toks = _prompt(10 + i, 8)
        for pool, cache in ((tp, tc), (jp, jc)):
            pool.alloc(i, 8)
            cache.insert(toks, pool.owned(i))
            pool.free(i)
        _same_state(tp, tc, jp, jc)
        assert tc.cached_blocks <= 3
    assert tc.evicted_total == jc.evicted_total > 0
    assert tc.inserted_total == jc.inserted_total == 6
    with pytest.raises(ValueError, match="zero blocks"):
        pt.PrefixCache(tp, byte_budget=tp.bytes_per_block - 1)
