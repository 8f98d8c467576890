"""Compile accounting of the serving engines.

The port builds its kernels once per process and runs every shape through
them, so it has no executable cache to miss. The engines still report the
JAX engines' compile counters (`statusz()["compile"]`), kept with the JAX
bookkeeping: each device call names the signature the JAX package would
compile it under (its kind and shapes), and the first call of a signature
is a build. Signatures live where the JAX package keeps its executables:
per model, in an LRU of 16 (`GPTForCausalLM._gen_cache_get`), and per
process for the spill tier's scatter. On the same traffic the engines'
compile counts therefore equal the JAX engines'.
"""
from __future__ import annotations

import weakref
from collections import OrderedDict

_PER_MODEL: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_PROCESS: set = set()
_BUILDS = [0]
_MODEL_CAP = 16


def note(model, sig: tuple) -> int:
    """Record a call of `model`'s executable `sig`; returns 1 when it is
    the signature's first call (a build), else 0."""
    cache = _PER_MODEL.get(model)
    if cache is None:
        cache = _PER_MODEL[model] = OrderedDict()
    if sig in cache:
        cache.move_to_end(sig)
        return 0
    cache[sig] = True
    while len(cache) > _MODEL_CAP:
        cache.popitem(last=False)
    _BUILDS[0] += 1
    return 1


def note_process(sig: tuple) -> int:
    """The same for an executable shared by every engine of the process."""
    if sig in _PROCESS:
        return 0
    _PROCESS.add(sig)
    _BUILDS[0] += 1
    return 1


def builds() -> int:
    """Builds recorded in this process: the engines difference it around a
    step, as the JAX engines difference the jit cache-miss counter."""
    return _BUILDS[0]
