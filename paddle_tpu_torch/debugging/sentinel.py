"""Numerics sentinels: per-tensor stats rows that stay on the device (the
port of paddle_tpu/debugging/sentinel.py).

The reference's training-health surface (FLAGS_check_nan_inf,
paddle.amp.debugging.check_numerics, nan_inf_utils.cc per-op scans) is an
eager host-side scan: every check is a device->host round trip. Here each
instrumented module reduces its output to a 6-float stats row ON THE
DEVICE, the rows stack into one compact [rows, 6] float32 tensor a step,
and the host only reads it when asked (every N steps or on demand): no
per-step sync, a few scalar reductions of cost. Nothing here calls
`.item()`, `float()` or `bool()` on a tensor.

Stats columns (STAT_NAMES order):
  finite  — count of finite elements
  nan     — count of NaNs
  inf     — count of +/-Inf
  absmax  — max |x| over finite elements (0 if none)
  mean    — mean over finite elements
  l2      — sqrt(sum x^2) over finite elements

Non-finite values are masked out of absmax/mean/l2 so one NaN doesn't
poison the magnitudes the anomaly detectors (dead-layer, grad explosion)
read — the nan/inf counts carry the non-finite signal on their own.

Rows are named by module path, the JAX way: ``Root/name/with/slashes``
from `named_modules()`, with ``type(model).__name__`` as the root; the
port names parameters as the JAX package does, so the same model gives
the same paths, except for sublayers that exist on one side only.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

STAT_NAMES = ("finite", "nan", "inf", "absmax", "mean", "l2")
N_STATS = len(STAT_NAMES)

_tls = threading.local()


def array_stats(a: torch.Tensor) -> torch.Tensor:
    """[N_STATS] float32 stats row of one tensor, on its device.

    The nan/inf masks are computed in the tensor's own dtype (a finite
    float64 value beyond float32's range counts as finite); the magnitude
    columns reduce in float32. Non-finite elements read as 0 through one
    copy in the tensor's own dtype; absmax is taken in that dtype (exact),
    the sum and the l2 norm reduce with `dtype=float32` rather than on a
    float32 copy of the tensor."""
    x = a if a.is_floating_point() else a.float()
    n_nan = torch.isnan(x).sum(dtype=torch.float32)
    n_inf = torch.isinf(x).sum(dtype=torch.float32)
    n_fin = float(x.numel()) - n_nan - n_inf
    xz = torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)
    if xz.dtype == torch.float64:
        xz = xz.float()        # float64 magnitudes reduce in float32 too
    if x.numel():
        absmax = torch.linalg.vector_norm(xz, float("inf")).float()
    else:
        absmax = torch.zeros((), dtype=torch.float32, device=x.device)
    mean = xz.sum(dtype=torch.float32) / torch.clamp(n_fin, min=1.0)
    l2 = torch.linalg.vector_norm(xz, dtype=torch.float32)
    return torch.stack([n_fin, n_nan, n_inf, absmax, mean, l2])


def merge_stat_rows(rows: Sequence[torch.Tensor]) -> torch.Tensor:
    """Combine stats rows of DISJOINT tensors into one row (e.g. the grads
    of all params under one layer): counts add, absmax maxes, mean
    re-weights by finite count, l2 combines in quadrature."""
    st = torch.stack(list(rows))                     # [k, N_STATS]
    n_fin = st[:, 0].sum()
    mean = (st[:, 0] * st[:, 4]).sum() / torch.clamp(n_fin, min=1.0)
    return torch.stack([n_fin, st[:, 1].sum(), st[:, 2].sum(),
                        st[:, 3].amax(), mean,
                        torch.sqrt((st[:, 5] ** 2).sum())])


def merge_stacked(stacked: torch.Tensor) -> torch.Tensor:
    """Reduce [k, R, N_STATS] microbatch-stacked stats to [R, N_STATS]
    with merge_stat_rows semantics along dim 0 (grad accumulation)."""
    n_fin = stacked[..., 0].sum(0)
    mean = (stacked[..., 0] * stacked[..., 4]).sum(0) \
        / torch.clamp(n_fin, min=1.0)
    return torch.stack([
        n_fin,
        stacked[..., 1].sum(0),
        stacked[..., 2].sum(0),
        stacked[..., 3].amax(0),
        mean,
        torch.sqrt((stacked[..., 5] ** 2).sum(0)),
    ], dim=-1)


class StatsTree:
    """Host-side view of one fetched stats array: named rows of STAT_NAMES
    columns. Activation rows are qualified module paths (the
    profiler.annotate_layers naming, e.g. ``GPTForCausalLM/gpt/h/0/mlp``);
    gradient rows carry a ``grad:`` prefix."""

    def __init__(self, paths: Sequence[str], values, step: Optional[int] = None):
        self.paths = list(paths)
        if torch.is_tensor(values):
            values = values.detach().float().cpu().numpy()
        self.values = np.asarray(values, dtype=np.float32)
        self.step = step
        if self.values.ndim != 2 or self.values.shape[0] != len(self.paths) \
                or self.values.shape[1] != N_STATS:
            raise ValueError(
                f"stats shape {self.values.shape} does not match "
                f"{len(self.paths)} paths x {N_STATS} stats")

    def __len__(self):
        return len(self.paths)

    def row(self, path: str) -> Dict[str, float]:
        i = self.paths.index(path)
        return dict(zip(STAT_NAMES, (float(v) for v in self.values[i])))

    def rows(self):
        for p, v in zip(self.paths, self.values):
            yield p, dict(zip(STAT_NAMES, (float(x) for x in v)))

    def nonfinite_rows(self) -> List[Tuple[str, Dict[str, float]]]:
        return [(p, r) for p, r in self.rows() if r["nan"] or r["inf"]]

    def first_nonfinite(self) -> Optional[Tuple[str, Dict[str, float]]]:
        bad = self.nonfinite_rows()
        return bad[0] if bad else None

    def to_dict(self) -> dict:
        return {"step": self.step, "stat_names": list(STAT_NAMES),
                "rows": {p: [float(x) for x in v]
                         for p, v in zip(self.paths, self.values)}}

    def format(self) -> str:
        w = max((len(p) for p in self.paths), default=4)
        head = f"{'row':<{w}}  " + "".join(f"{s:>12}" for s in STAT_NAMES)
        lines = [head]
        for p, v in zip(self.paths, self.values):
            cells = "".join(
                f"{int(x):>12}" if i < 3 else f"{x:>12.4g}"
                for i, x in enumerate(v))
            lines.append(f"{p:<{w}}  {cells}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# collection scope: instrumented modules record (path, stats_row) here while
# a scope is active on this thread


class StatsCollector:
    def __init__(self):
        self.paths: List[str] = []
        self.rows: List[torch.Tensor] = []
        self._counts: Dict[str, int] = {}

    def record(self, path: str, stats_row):
        # a module called twice in one forward (weight-tied decode) gets
        # distinct rows: path, path#2, ...
        n = self._counts.get(path, 0) + 1
        self._counts[path] = n
        self.paths.append(path if n == 1 else f"{path}#{n}")
        self.rows.append(stats_row)

    def stacked(self) -> Optional[torch.Tensor]:
        return torch.stack(self.rows) if self.rows else None

    def tree(self, step: Optional[int] = None) -> Optional[StatsTree]:
        if not self.rows:
            return None
        return StatsTree(self.paths, self.stacked(), step=step)


def _stack() -> list:
    s = getattr(_tls, "stack", None)
    if s is None:
        s = _tls.stack = []
    return s


def active_collector() -> Optional[StatsCollector]:
    s = getattr(_tls, "stack", None)
    return s[-1] if s else None


@contextlib.contextmanager
def collect_stats():
    """Open a collection scope on this thread: instrumented modules
    (check_layer_numerics) record their output stats into the yielded
    collector. Nestable. TrainStep closes its scope after the forward and
    before the backward, so a recomputed region's second forward (run by
    the backward) records nothing."""
    col = StatsCollector()
    _stack().append(col)
    try:
        yield col
    finally:
        _stack().pop()


# ---------------------------------------------------------------------------
# module instrumentation


class _SentinelHandle:
    """Returned by check_layer_numerics; .remove() uninstalls the hooks."""

    def __init__(self, removers, paths):
        self._removers = removers
        self.paths = paths

    def remove(self):
        for r in self._removers:
            r.remove()
        self._removers = []


def _float_leaves(outputs) -> List[torch.Tensor]:
    """The floating tensors of a module output (tensor / tuple / list /
    dict), in order."""
    out: List[torch.Tensor] = []

    def walk(o):
        if torch.is_tensor(o):
            if o.is_floating_point():
                out.append(o)
        elif isinstance(o, (list, tuple)):
            for x in o:
                walk(x)
        elif isinstance(o, dict):
            for k in sorted(o):
                walk(o[k])
    walk(outputs)
    return out


def check_layer_numerics(model, root: Optional[str] = None) -> _SentinelHandle:
    """Instrument every submodule of `model` (itself included) so that,
    while a collect_stats() scope is active (TrainStep's numerics mode
    opens one around the forward), each forward reduces its floating
    outputs to one stats row named by the module's qualified path.

    Outside a scope the hook is a thread-local read and a None check —
    safe to leave installed. Idempotent per module. Returns a handle whose
    ``.remove()`` uninstalls."""
    root = root or type(model).__name__
    removers, paths = [], []
    for name, layer in model.named_modules():
        path = root if not name else f"{root}/{name.replace('.', '/')}"
        if getattr(layer, "_numerics_path", None) is not None:
            continue

        def _hook(lyr, inputs, outputs, _path=path):
            col = active_collector()
            if col is None:
                return None
            arrs = _float_leaves(outputs)
            if not arrs:
                return None
            with torch.no_grad():
                row = array_stats(arrs[0]) if len(arrs) == 1 else \
                    merge_stat_rows([array_stats(a) for a in arrs])
            col.record(_path, row)
            return None

        h = layer.register_forward_hook(_hook)
        layer._numerics_path = path

        class _Remover:
            def __init__(self, lyr, hook_handle):
                self._lyr, self._h = lyr, hook_handle

            def remove(self):
                self._h.remove()
                self._lyr._numerics_path = None

        removers.append(_Remover(layer, h))
        paths.append(path)
    return _SentinelHandle(removers, paths)


# ---------------------------------------------------------------------------
# gradient rows


def grad_layer_groups(param_names: Sequence[str], root: str
                      ) -> List[Tuple[str, List[int]]]:
    """Group param indices by owning layer path: 'moe.w1' -> 'Root/moe';
    a root-level param -> 'Root'. Order: first appearance."""
    groups: Dict[str, List[int]] = {}
    order: List[str] = []
    for i, name in enumerate(param_names):
        head = name.rsplit(".", 1)[0] if "." in name else ""
        path = root if not head else f"{root}/{head.replace('.', '/')}"
        key = f"grad:{path}"
        if key not in groups:
            groups[key] = []
            order.append(key)
        groups[key].append(i)
    return [(k, groups[k]) for k in order]


def grad_stat_rows(grads, groups) -> Tuple[List[str], List[torch.Tensor]]:
    """Per-layer grad stats rows for grad_layer_groups output."""
    paths, rows = [], []
    with torch.no_grad():
        for key, idxs in groups:
            per = [array_stats(grads[i]) for i in idxs]
            rows.append(per[0] if len(per) == 1 else merge_stat_rows(per))
            paths.append(key)
    return paths, rows


def found_inf(grads) -> torch.Tensor:
    """0-d bool tensor, on the grads' device: True iff any grad holds a
    non-finite value (no host read)."""
    grads = [g for g in grads if g is not None]
    if not grads:
        return torch.tensor(False)
    with torch.no_grad():
        flags = torch.stack([torch.isfinite(g).all() for g in grads])
        return torch.logical_not(flags.all())


def model_param_stats(model, root: Optional[str] = None,
                      grads: bool = False) -> StatsTree:
    """Eager stats tree over a model's parameters (and optionally their
    .grad) — the host-side fallback when the training loop is not a
    TrainStep. One device->host fetch for the whole tree."""
    root = root or type(model).__name__
    paths, rows = [], []
    with torch.no_grad():
        for name, p in model.named_parameters():
            head = name.rsplit(".", 1)[0] if "." in name else ""
            path = root if not head else f"{root}/{head.replace('.', '/')}"
            src = p.grad if grads else p
            if src is None:
                continue
            paths.append((f"grad:{path}/{name.rsplit('.', 1)[-1]}" if grads
                          else f"param:{path}/{name.rsplit('.', 1)[-1]}"))
            rows.append(array_stats(src.detach()))
    values = torch.stack(rows) if rows else \
        np.zeros((0, N_STATS), np.float32)
    return StatsTree(paths, values)
