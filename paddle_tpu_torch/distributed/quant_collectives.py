"""Quantized gradient all-reduce: int8 sync with per-chunk factored scales
(the port of paddle_tpu/distributed/quant_collectives.py).

References: EQuARX (arxiv 2506.17615), an int8 all-reduce with per-block
scales that cuts gradient-sync wire bytes about 4x; T3 (arxiv 2401.16677),
per-layer gradient collectives issued as the backward produces each
layer's gradients, so they overlap the rest of the backward.

The JAX package runs `int8_psum` under a shard_map over the dp axis; here
it is an all-reduce over a process `Group` (NCCL on the card, gloo on the
CPU), in the same overflow-free recipe:

  per chunk of `chunk` elements:
    amax   = max |x| over the chunk          (local)
    gmax   = all-reduce MAX of amax, in f32  (the factored scales must
                                              agree across the ranks)
    levels = 127 // D                        (D = the group's size)
    scale  = max(gmax, eps) / levels
    codes  = clip(round(x / scale), +-levels) as int8
    total  = all-reduce SUM of codes, int8   (D codes of magnitude at most
                                              127 // D cannot overflow)
    out    = total * (scale / D)             (the mean folded in)

in the JAX order of operations (divide, round half to even, clip, cast),
so the deterministic path gives the JAX function's bits.

Wire math per step for n gradient elements over D ranks (ring terms):
  f32 all-reduce   ~ 2 n 4 bytes
  int8 all-reduce  ~ 2 n 1 + 2 (n / chunk) 4 bytes   (codes + scale max)
about 3.9x fewer bytes at the default chunk of 256.

Stochastic rounding replaces round() with floor(q + u), u ~ U[0, 1), drawn
from an explicit `torch.Generator` that every rank of the group seeds
alike (`group_seed`): unbiased, and every rank rounds the same way, the
JAX invariant of one key on every shard.

`jit.TrainStep(grad_comm="int8")` runs this per `grad_layer_groups` group,
each group's exchange started as soon as its gradients exist in the
backward (`GroupSync`), with an f32 lane for norm-sensitive leaves
(`default_f32_fallback`: 0/1-d parameters).
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from .collective import Group, ReduceOp, all_reduce

DEFAULT_CHUNK = 256
_EPS = 1e-30


def _pad_to_chunks(flat, chunk: int):
    """flat zero-padded to whole chunks: ([n_chunks, chunk], n)."""
    n = flat.numel()
    pad = -n % chunk
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.view(-1, chunk), n


def _codes(q, scales, levels: int, stochastic: bool, generator):
    """clip(round(q / scale), +-levels) as int8; floor(q / scale + u) with
    u ~ U[0, 1) from `generator` when stochastic."""
    q = q / scales[:, None]
    if stochastic:
        if generator is None:
            raise ValueError("stochastic rounding needs a torch.Generator")
        q = torch.floor(q + torch.rand(q.shape, generator=generator,
                                       dtype=torch.float32, device=q.device))
    else:
        q = torch.round(q)
    return torch.clamp(q, -levels, levels).to(torch.int8)


def quantize_chunked(x, chunk: int = DEFAULT_CHUNK, levels: int = 127,
                     stochastic: bool = False, generator=None):
    """Per-chunk symmetric int8 quantization of any tensor: (codes int8
    [n_chunks, chunk], scales f32 [n_chunks]), the tail chunk zero-padded;
    `dequantize_chunked` undoes both. `levels` is the clip magnitude (127
    for storage, 127 // D for an overflow-free sum over D ranks)."""
    q, _ = _pad_to_chunks(x.reshape(-1).float(), chunk)
    scales = torch.clamp(q.abs().amax(dim=1), min=_EPS) / levels
    return _codes(q, scales, levels, stochastic, generator), scales


def dequantize_chunked(codes, scales, n: int, shape=None,
                       dtype=torch.float32):
    """codes [n_chunks, chunk] x scales [n_chunks] -> the first `n`
    elements, reshaped to `shape`."""
    out = (codes.float() * scales[:, None]).reshape(-1)[:n]
    if shape is not None:
        out = out.reshape(shape)
    return out.to(dtype)


def _levels(group: Optional[Group]) -> Tuple[int, int]:
    d = 1 if group is None else group.nranks
    return d, max(127 // d, 1)


def int8_psum_start(x, group: Optional[Group], chunk: int = DEFAULT_CHUNK,
                    stochastic: bool = False, generator=None,
                    scale_group: Optional[Group] = None):
    """The first half of `int8_psum`: the scales agreed (an f32 MAX
    all-reduce over `scale_group`, by default `group`), the codes made
    and their int8 SUM all-reduce started. Returns (codes, scales, n,
    work); `int8_psum_finish` waits and dequantizes."""
    d, levels = _levels(group)
    q, n = _pad_to_chunks(x.reshape(-1).float(), chunk)
    amax = q.abs().amax(dim=1)
    if d > 1:
        all_reduce(amax, ReduceOp.MAX, group=scale_group or group)
    scales = torch.clamp(amax, min=_EPS) / levels
    codes = _codes(q, scales, levels, stochastic, generator)
    work = all_reduce(codes, group=group, sync_op=False) if d > 1 else None
    return codes, scales, n, work


def int8_psum_finish(codes, scales, n: int, d: int, mean: bool = True,
                     work=None):
    """The summed codes times the scale (over D for the mean), f32 [n]."""
    if work is not None:
        work.wait()
    div = float(d) if mean else 1.0
    return (codes.float() * (scales / div)[:, None]).reshape(-1)[:n]


def int8_psum(x, group: Optional[Group], chunk: int = DEFAULT_CHUNK,
              stochastic: bool = False, generator=None, mean: bool = True):
    """Quantize -> int8 all-reduce -> dequantize over `group` (every rank
    calls it with its own x). Returns the mean (default) or the sum over
    the ranks, in x's dtype and shape."""
    d, _ = _levels(group)
    codes, scales, n, work = int8_psum_start(x, group, chunk, stochastic,
                                             generator)
    out = int8_psum_finish(codes, scales, n, d, mean, work)
    return out.reshape(x.shape).to(x.dtype)


def default_f32_fallback(name: str, shape: Sequence[int]) -> bool:
    """The default norm-sensitive-leaf rule: 0/1-d parameters (layer-norm
    scales and biases, bias vectors) sync in f32; every matrix and
    embedding is quantized."""
    return len(shape) <= 1


def build_comm_groups(param_names: Sequence[str],
                      param_shapes: Sequence[Sequence[int]],
                      grad_groups: Sequence[Tuple[str, Sequence[int]]],
                      f32_fallback: Optional[Callable[[str, Sequence[int]],
                                                      bool]] = None):
    """The per-layer-group sync plan: for each `grad_layer_groups` group
    (path, param indices), which leaves ride the int8 lane and which the
    f32 one: [(path, quant_idxs, f32_idxs)]."""
    fb = f32_fallback or default_f32_fallback
    plan = []
    for path, idxs in grad_groups:
        q_idxs = [i for i in idxs
                  if not fb(param_names[i], tuple(param_shapes[i]))]
        f_idxs = [i for i in idxs if i not in set(q_idxs)]
        plan.append((path, tuple(q_idxs), tuple(f_idxs)))
    return plan


def comm_group_stats(plan, param_shapes) -> dict:
    """Static wire accounting of a build_comm_groups plan: elements per
    lane and the f32 twin's all-reduce bytes against the int8 plan's
    (ring terms, the scale all-reduce included)."""
    n_q = sum(int(math.prod(param_shapes[i]) or 1)
              for _, qs, _ in plan for i in qs)
    n_f = sum(int(math.prod(param_shapes[i]) or 1)
              for _, _, fs in plan for i in fs)
    total = n_q + n_f
    f32_bytes = 2 * 4 * total
    int8_bytes = (2 * 1 * n_q + 2 * 4 * -(-n_q // DEFAULT_CHUNK)
                  + 2 * 4 * n_f)
    return {"groups": len(plan), "quant_elems": n_q, "f32_elems": n_f,
            "f32_twin_bytes": f32_bytes, "int8_bytes": int8_bytes,
            "ratio": f32_bytes / max(int8_bytes, 1)}


def group_seed(seed: int, gi: int) -> int:
    """The stochastic-rounding seed of group `gi` under the step seed
    `seed` (the JAX `fold_in(key, gi)`); the same on every rank."""
    return (int(seed) * 0x9E3779B1 + 0x5C * 1000003 + int(gi)) % (1 << 62)


def _flat32(grads, idxs, flip=()):
    """The leaves idxs flattened into one f32 vector, a leaf in `flip`
    transposed first (the JAX element order of an nn.Linear weight)."""
    parts = [(grads[i].t() if i in flip else grads[i]).reshape(-1).float()
             for i in idxs]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _unflatten(flat, grads, idxs, out, flip=()):
    off = 0
    for i in idxs:
        g = grads[i]
        n = g.numel()
        part = flat[off:off + n]
        part = part.view(g.shape[::-1]).t() if i in flip else \
            part.view(g.shape)
        out[i] = part.to(g.dtype)
        off += n


class GroupSync:
    """One layer group's exchange in two halves: `start` issues its
    collectives (the int8 lane's scale agreement, then its int8 SUM, and
    the f32 lane's SUM, both asynchronous), `finish` waits and writes the
    synced leaves back in their dtypes. `scale_group` carries the tiny
    scale all-reduce on a communicator of its own, so that it never
    queues behind an earlier group's payload. The leaves in `flip` (2-D)
    enter the int8 lane transposed, so that its chunks are the JAX
    package's for the same parameter (an nn.Linear weight, [in, out]
    there)."""

    def __init__(self, group: Optional[Group], chunk: int = DEFAULT_CHUNK,
                 stochastic: bool = False, mean: bool = True,
                 scale_group: Optional[Group] = None, flip=()):
        self.group, self.chunk = group, int(chunk)
        self.stochastic, self.mean = bool(stochastic), mean
        self.scale_group = scale_group
        self.flip = frozenset(flip)
        self.d, _ = _levels(group)

    def generator(self, seed: int, gi: int, device):
        if not self.stochastic:
            return None
        g = torch.Generator(device=device)
        g.manual_seed(group_seed(seed, gi))
        return g

    def start(self, grads, entry, gi: int = 0, seed: int = 0):
        """Start group `entry` = (path, quant_idxs, f32_idxs) of `grads`
        (indexable by parameter index); returns the pending exchange."""
        _, q_idxs, f_idxs = entry
        pend = {"q": None, "f": None}
        if q_idxs:
            cat = _flat32(grads, q_idxs, self.flip)
            pend["q"] = int8_psum_start(
                cat, self.group, self.chunk, self.stochastic,
                self.generator(seed, gi, cat.device), self.scale_group)
        if f_idxs:
            cat = _flat32(grads, f_idxs)
            if cat.data_ptr() == grads[f_idxs[0]].data_ptr():
                cat = cat.clone()      # never reduce into a caller's leaf
            work = all_reduce(cat, group=self.group, sync_op=False) \
                if self.d > 1 else None
            pend["f"] = (cat, work)
        return grads, entry, pend

    def finish(self, pending, out):
        """Wait for a started group; its synced leaves land in `out`."""
        grads, (_, q_idxs, f_idxs), pend = pending
        if pend["q"] is not None:
            codes, scales, n, work = pend["q"]
            _unflatten(int8_psum_finish(codes, scales, n, self.d, self.mean,
                                        work), grads, q_idxs, out, self.flip)
        if pend["f"] is not None:
            cat, work = pend["f"]
            if work is not None:
                work.wait()
            if self.mean and self.d > 1:
                cat = cat / self.d
            _unflatten(cat, grads, f_idxs, out)
        return out


def sync_grad_groups(grads: List, plan, group: Optional[Group],
                     chunk: int = DEFAULT_CHUNK, stochastic: bool = False,
                     seed: int = 0, mean: bool = True, flip=()) -> List:
    """Per-layer-group gradient sync over `group`: per group, the
    quantizable leaves concatenated into one int8_psum and the fallback
    leaves into one f32 all-reduce (the mean by default); the leaves come
    back in their positions and dtypes. `seed` seeds the stochastic
    rounding of group gi with `group_seed(seed, gi)`; `flip` as in
    GroupSync."""
    sync = GroupSync(group, chunk, stochastic, mean, flip=flip)
    out = list(grads)
    for gi, entry in enumerate(plan):
        sync.finish(sync.start(grads, entry, gi, seed), out)
    return out
