"""Anomaly dumps — persist a failing step so it replays standalone (the
port of paddle_tpu/debugging/dump.py; the same directory and files).

When a NumericsEvent fires, the step that produced it is written to
``<dump_dir>/step<K>_<kind>/``:

  meta.json      — step index, the firing event(s), the model's dropout
                   generator state (where the JAX dump keeps the RNG key's
                   words), loss, stats-row paths, batch tree spec, the
                   parameters' layout and the dtypes stored as bit
                   patterns
  batch.npz      — the offending batch's tensor leaves (leaf0, leaf1, ...)
  params.npz     — parameter tensors by qualified name, in the port's own
                   layout (nn.Linear weights [out, in], where the JAX dump
                   holds [in, out]; `convert.py`'s names)
  opt_state.npz  — optimizer-state tensors as "<param>::<slot>"
  stats.npz      — the fetched [rows, N_STATS] stats array

numpy has no bfloat16, so bf16 tensors are stored as their int16 bit
patterns and `meta["bit_dtypes"]` names them; loading restores them
exactly. Because TrainStep's numerics mode skips non-finite updates
(skip_nonfinite_updates), the params on disk are the exact pre-step
values — replaying the dump re-runs the computation that blew up.
``replay()`` is the library entry: load the params into a model built
like the dumped one, re-run forward + backward from the dumped dropout
generator state with sentinels installed, and return the reproduced
stats tree + events.
"""
from __future__ import annotations

import json
import os
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from .sentinel import (StatsTree, check_layer_numerics, collect_stats,
                       grad_layer_groups, grad_stat_rows)
from .anomaly import AnomalyDetector, NumericsEvent

PARAM_LAYOUT = ("paddle_tpu_torch: named as the JAX package, nn.Linear "
                "weights [out, in] (the JAX dump holds [in, out])")


# -- tiny tree spec: tuple/list/dict/leaf, enough for batch trees ------------

def tree_spec(obj):
    if isinstance(obj, (list, tuple)):
        return {"t": "tuple" if isinstance(obj, tuple) else "list",
                "c": [tree_spec(o) for o in obj]}
    if isinstance(obj, dict):
        return {"t": "dict", "k": sorted(obj),
                "c": [tree_spec(obj[k]) for k in sorted(obj)]}
    if obj is None:
        return {"t": "none"}
    return {"t": "leaf"}


def tree_leaves(obj) -> List:
    """The leaves of `obj` in tree_spec's order (dict keys sorted)."""
    if isinstance(obj, (list, tuple)):
        return [x for o in obj for x in tree_leaves(o)]
    if isinstance(obj, dict):
        return [x for k in sorted(obj) for x in tree_leaves(obj[k])]
    if obj is None:
        return []
    return [obj]


def tree_build(spec, leaves: List):
    """Inverse of tree_spec; consumes `leaves` left-to-right."""
    t = spec["t"]
    if t == "leaf":
        return leaves.pop(0)
    if t == "none":
        return None
    if t == "dict":
        return {k: tree_build(c, leaves) for k, c in zip(spec["k"], spec["c"])}
    seq = [tree_build(c, leaves) for c in spec["c"]]
    return tuple(seq) if t == "tuple" else seq


# -- writer ------------------------------------------------------------------

def _host(t, key: str, bit_dtypes: dict) -> np.ndarray:
    """A tensor (or array / number) as a numpy array; bf16 as its int16
    bits, noted in `bit_dtypes`."""
    if not torch.is_tensor(t):
        return np.asarray(t)
    t = t.detach()
    if t.dtype == torch.bfloat16:
        bit_dtypes[key] = "bfloat16"
        t = t.view(torch.int16)
    return t.cpu().numpy()


def _restore(arr: np.ndarray, key: str, bit_dtypes: dict) -> torch.Tensor:
    t = torch.from_numpy(np.array(arr))
    if bit_dtypes.get(key) == "bfloat16":
        t = t.view(torch.bfloat16)
    return t


def write_dump(dump_dir: str, *, step: int, events: Sequence[NumericsEvent],
               batch_leaves: Sequence, batch_spec: dict,
               param_names: Sequence[str], param_arrays: Sequence,
               opt_state: Optional[Sequence] = None,
               generator_state: Optional[torch.Tensor] = None,
               loss: Optional[float] = None,
               stats: Optional[StatsTree] = None,
               extra_meta: Optional[dict] = None) -> str:
    """Persist one failing step; returns the dump directory path."""
    kind = events[0].kind if events else "manual"
    out = os.path.join(dump_dir, f"step{step}_{kind}")
    os.makedirs(out, exist_ok=True)
    bits: dict = {}
    batch = {f"leaf{i}": _host(a, f"batch:leaf{i}", bits)
             for i, a in enumerate(batch_leaves)}
    params = {n: _host(a, f"param:{n}", bits)
              for n, a in zip(param_names, param_arrays)}
    slots = {}
    if opt_state is not None:
        for n, st in zip(param_names, opt_state):
            for k, v in (st or {}).items():
                slots[f"{n}::{k}"] = _host(v, f"opt:{n}::{k}", bits)
    meta = {
        "step": step,
        "events": [e.to_dict() for e in events],
        "dropout_generator_state": (
            None if generator_state is None
            else generator_state.cpu().tolist()),
        "loss": None if loss is None else float(loss),
        "batch_spec": batch_spec,
        "n_batch_leaves": len(batch_leaves),
        "param_names": list(param_names),
        "param_layout": PARAM_LAYOUT,
        "bit_dtypes": bits,
        "stats_paths": stats.paths if stats is not None else None,
    }
    meta.update(extra_meta or {})
    with open(os.path.join(out, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2)
    np.savez(os.path.join(out, "batch.npz"), **batch)
    np.savez(os.path.join(out, "params.npz"), **params)
    if opt_state is not None:
        np.savez(os.path.join(out, "opt_state.npz"), **slots)
    if stats is not None:
        np.savez(os.path.join(out, "stats.npz"), stats=stats.values)
    return out


# -- loader / replay ---------------------------------------------------------

class Dump:
    """A loaded anomaly dump. Parameters and optimizer state come back as
    CPU tensors in their saved dtypes; the optimizer state (twice the
    parameters' bytes under Adam) is read at its first use."""

    def __init__(self, path: str):
        self.path = path
        with open(os.path.join(path, "meta.json")) as f:
            self.meta = json.load(f)
        bits = self.meta.get("bit_dtypes", {})
        bz = np.load(os.path.join(path, "batch.npz"))
        self.batch_leaves = [
            _restore(bz[f"leaf{i}"], f"batch:leaf{i}", bits)
            for i in range(self.meta["n_batch_leaves"])]
        pz = np.load(os.path.join(path, "params.npz"))
        self.params = {n: _restore(pz[n], f"param:{n}", bits)
                       for n in pz.files}
        self._opt_state = None
        sp = os.path.join(path, "stats.npz")
        self.stats = None
        if os.path.exists(sp) and self.meta.get("stats_paths"):
            self.stats = StatsTree(self.meta["stats_paths"],
                                   np.load(sp)["stats"],
                                   step=self.meta["step"])

    @property
    def opt_state(self) -> Optional[dict]:
        """Slot tensors keyed "<param>::<slot>" (None without
        opt_state.npz)."""
        op = os.path.join(self.path, "opt_state.npz")
        if self._opt_state is None and os.path.exists(op):
            bits = self.meta.get("bit_dtypes", {})
            oz = np.load(op)
            self._opt_state = {n: _restore(oz[n], f"opt:{n}", bits)
                               for n in oz.files}
        return self._opt_state

    @property
    def step(self) -> int:
        return self.meta["step"]

    @property
    def events(self) -> List[dict]:
        return self.meta["events"]

    def batch(self, device=None):
        """The batch tree, rebuilt from its spec (tensors on `device`)."""
        leaves = [t.to(device) if device is not None else t
                  for t in self.batch_leaves]
        return tree_build(self.meta["batch_spec"], list(leaves))

    def generator_state(self) -> Optional[torch.Tensor]:
        st = self.meta.get("dropout_generator_state")
        if st is None:
            return None
        return torch.tensor(st, dtype=torch.uint8)


def load_dump(path: str) -> Dump:
    return Dump(path)


class ReplayResult:
    def __init__(self, loss, stats: Optional[StatsTree],
                 events: List[NumericsEvent], matches: Optional[bool]):
        self.loss = loss
        self.stats = stats
        self.events = events
        self.matches = matches   # reproduced stats == dumped stats (where both exist)


def replay(dump: Dump, model, loss_fn: Callable,
           detector: Optional[AnomalyDetector] = None,
           compute_grads: bool = True) -> ReplayResult:
    """Re-run the dumped step against `model` (built like the dumped one).

    Loads the dumped params into the model by qualified name (in their
    dumped values, cast to each parameter's dtype), sets the model's
    dropout generator to the dumped state, installs the numerics
    sentinels, replays ``loss_fn(*batch)`` (and its backward when
    `compute_grads`) and returns the reproduced stats tree + the events
    a fresh detector raises on it. `matches` is True when every dumped
    stats row that exists in the replay reproduces its nan/inf
    presence."""
    name_to_param = dict(model.named_parameters())
    device = next(iter(name_to_param.values())).device
    with torch.no_grad():
        for n, arr in dump.params.items():
            if n in name_to_param:
                p = name_to_param[n]
                p.copy_(arr.to(device=p.device, dtype=p.dtype))
    gen = getattr(model, "dropout_generator", None)
    state = dump.generator_state()
    if gen is not None and state is not None:
        gen.set_state(state)

    handle = check_layer_numerics(model)
    root = type(model).__name__
    batch = dump.batch(device=device)
    try:
        with collect_stats() as col:
            if isinstance(batch, (list, tuple)):
                out = loss_fn(*batch)
            else:
                out = loss_fn(batch)
        paths, rows = list(col.paths), list(col.rows)
        loss = out
        if compute_grads and torch.is_tensor(out) and out.requires_grad:
            names = [n for n, p in name_to_param.items() if p.requires_grad]
            grads = torch.autograd.grad(
                out.float(), [name_to_param[n] for n in names],
                allow_unused=True)
            kept = [(n, g) for n, g in zip(names, grads) if g is not None]
            if kept:
                gpaths, grows = grad_stat_rows(
                    [g for _, g in kept],
                    grad_layer_groups([n for n, _ in kept], root))
                paths += gpaths
                rows += grows
        stats = StatsTree(paths, torch.stack(rows),
                          step=dump.step) if rows else None
    finally:
        handle.remove()

    det = detector or AnomalyDetector()
    events = det.observe(dump.step, tree=stats) if stats is not None else []

    matches = None
    if stats is not None and dump.stats is not None:
        matches = True
        for p, r in stats.rows():
            if p in dump.stats.paths:
                ref = dump.stats.row(p)
                if (r["nan"] > 0) != (ref["nan"] > 0) or \
                        (r["inf"] > 0) != (ref["inf"] > 0):
                    matches = False
    loss_val = float(loss.detach().double()) \
        if torch.is_tensor(loss) and loss.numel() == 1 else None
    return ReplayResult(loss_val, stats, events, matches)
