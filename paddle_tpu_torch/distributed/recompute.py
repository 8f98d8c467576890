"""Recompute (activation checkpointing): the port of
paddle_tpu/distributed/recompute.py's `recompute`, `resolve_policy`,
`checkpoint_tag`, `recompute_sequential` and `recompute_hybrid`.

The JAX package wraps a segment in `jax.checkpoint` with a save policy;
XLA then keeps what the policy names and rematerialises the rest in the
backward. Here a segment is a non-reentrant `torch.utils.checkpoint`
region: only its inputs are kept, and its forward runs again in the
backward up to the last saved activation it needs. The policies:

  None          the whole segment is recomputed (only its inputs kept);
  "save_qkv"    keep the QKV projection output ``qkv_proj`` [B, S, 3H];
  "save_attn"   also keep the attention context ``attn_ctx`` [B, S, H];
  "save_big"    also keep the MLP up-projection output ``mlp_up``
                [B, S, 4H];
  "dots"        keep the output of every matrix product without batch
                dims (``aten.mm``/``aten.addmm``), recompute the rest
                (JAX's dots_with_no_batch_dims_saveable).

A save-list policy is realised by cutting the segment into several
checkpoint regions at the tagged values (`checkpoint_tag` marks them, as
JAX's checkpoint_name does), so each tagged value is kept as the input of
the region after it: the function must provide
``recompute_segments(*args, save=tags, generators=..., **kwargs)`` (GPT's
block does). "dots" uses torch's selective checkpointing, which caches
the outputs of dispatcher ops: it is safe beside the hand-written kernels,
which are launched through ctypes and write into buffers the dispatcher
never sees, because it caches nothing but the matrix products. A JAX
policy callable has no counterpart and is refused.

Dropout masks drawn from an explicit ``torch.Generator`` (the models'
``dropout_generator``) are not covered by `torch.utils.checkpoint`'s RNG
stash, which saves the global generators only: each region saves the
state of the ``generators`` it is given when its forward starts and
replays it while it is recomputed, so the recomputed masks are the ones
the forward drew. While a region is being recomputed, `replaying()` is
True: code with a host-side effect per forward (the MoE drop-rate
telemetry) skips it then, so a recomputed forward is not counted twice.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

TAGS = ("qkv_proj", "attn_ctx", "mlp_up")
_NAMED = {"save_qkv": TAGS[:1], "save_attn": TAGS[:2], "save_big": TAGS}
_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
_REPLAYING = [0]


def replaying() -> bool:
    """True while a checkpoint region's forward runs again in the
    backward."""
    return _REPLAYING[0] > 0


def resolve_policy(policy):
    """None for None (recompute everything), the tuple of saved tags for
    a named save-list policy, "dots" for "dots"; raises ValueError for
    anything else, a JAX policy callable included."""
    if policy is None or policy == "dots":
        return policy
    if isinstance(policy, str) and policy in _NAMED:
        return _NAMED[policy]
    if callable(policy):
        raise ValueError("recompute: a JAX checkpoint policy callable has "
                         "no counterpart in the port; name a policy: None, "
                         "'save_qkv', 'save_attn', 'save_big' or 'dots'")
    raise ValueError(f"recompute: unknown policy {policy!r}; expected "
                     f"None, 'save_qkv', 'save_attn', 'save_big' or 'dots'")


def checkpoint_tag(t, name: str):
    """Mark `t` as the value a save-list policy keeps under `name` (one of
    "qkv_proj", "attn_ctx", "mlp_up"). The identity: the segmented
    forward of a recomputed block cuts its checkpoint regions at these
    values."""
    if name not in TAGS:
        raise ValueError(f"unknown checkpoint tag {name!r}; expected one "
                         f"of {TAGS}")
    return t


def _save_matmuls(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _MATMULS else \
        CheckpointPolicy.PREFER_RECOMPUTE


def checkpoint_segment(function, *args, generators=(), dots=False,
                       **kwargs):
    """`function(*args, **kwargs)` as one non-reentrant checkpoint region
    whose recomputation replays the `generators`' states; with `dots`, the
    matrix products' outputs are kept (selective checkpointing)."""
    states = [g.get_state() for g in generators]
    first = True

    def run(*a, **kw):
        if first:
            return function(*a, **kw)
        now = [g.get_state() for g in generators]
        for g, s in zip(generators, states):
            g.set_state(s)
        _REPLAYING[0] += 1
        try:
            return function(*a, **kw)
        finally:
            _REPLAYING[0] -= 1
            for g, s in zip(generators, now):
                g.set_state(s)

    context_fn = functools.partial(create_selective_checkpoint_contexts,
                                   _save_matmuls) if dots else noop_context_fn
    out = checkpoint(run, *args, use_reentrant=False, context_fn=context_fn,
                     **kwargs)
    first = False
    return out


def recompute(function, *args, policy=None, generators=(), **kwargs):
    """`function(*args, **kwargs)` with its activations recomputed in the
    backward under `policy` (see the module docstring). `generators`: the
    explicit generators the function draws dropout masks from."""
    saved = resolve_policy(policy)
    if isinstance(saved, tuple):
        segmented = getattr(function, "recompute_segments", None)
        if segmented is None:
            raise ValueError(f"recompute: policy {policy!r} keeps tagged "
                             f"values, and {function!r} does not provide "
                             f"recompute_segments to cut it at its tags")
        return segmented(*args, save=saved, generators=generators,
                         **kwargs)
    return checkpoint_segment(function, *args, generators=generators,
                              dots=saved == "dots", **kwargs)


def recompute_sequential(ctx, functions, *args, **kwargs):
    """Reference: recompute.py recompute_sequential. The layers of
    `functions` (an nn.Sequential or a list of callables) cut into
    ``ctx["segments"]`` runs of len // segments layers each (the last run
    takes the rest); each run is one `recompute` region. `kwargs` go to
    `recompute` (``policy``, ``generators``). A layer receives the
    previous one's output, unpacked when it is a tuple."""
    segments = int(ctx.get("segments", 1)) if isinstance(ctx, dict) else 1
    layers = list(functions)
    n = len(layers)
    seg = max(1, n // max(1, segments))

    def run_span(lo, hi):
        def f(*inp):
            y = inp if len(inp) > 1 else inp[0]
            for layer in layers[lo:hi]:
                y = layer(*y) if isinstance(y, tuple) else layer(y)
            return y
        return f

    cur, i = tuple(args), 0
    while i < n:
        hi = min(n, i + seg)
        out = recompute(run_span(i, hi), *cur, **kwargs)
        cur = out if isinstance(out, tuple) else (out,)
        i = hi
    return cur if len(cur) > 1 else cur[0]


def recompute_hybrid(ctx, function, *args, **kwargs):
    """Reference: recompute_hybrid.py, the tensor-parallel variant. The
    port's regions already replay the generators they are given (the
    model-parallel RNG tracker's among them), so it is `recompute`;
    `ctx` (the reference's mp group and offload flags) is accepted and
    unused."""
    return recompute(function, *args, **kwargs)
