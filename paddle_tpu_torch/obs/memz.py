"""MemoryLedger — owner-attributed device-memory accounting (the port of
paddle_tpu/obs/memz.py).

The obs stack says where the TIME went; this module says where the device
memory went, with the same conservation discipline:

  owners        every live device byte belongs to a REGISTERED owner —
                model params, KV block pools (reserved at allocator
                granularity), prefix-cache retained blocks (an OVERLAY:
                those blocks live inside the pool's reservation, so they
                are reported but never double-counted in the conservation
                sum) and the host-RAM spill tier (a host owner: tracked
                separately, never summed against device memory).
  conservation  `census()` reconciles the attributed sum against the CUDA
                caching allocator's ``torch.cuda.memory_allocated``:
                attributed + unattributed ≡ allocator view, by
                construction — the ledger cannot silently lose bytes, it
                can only grow `unattributed` (workspaces, the int8 weight
                payload, activations the allocator still holds).
  never sync    a ledger read touches HOST counters only. Owners are
                zero-arg readers over accounting the engine already keeps
                (``pool.num_blocks * bytes_per_block``, tensor metadata);
                ``memory_allocated`` is the allocator's host counter. A
                CPU ledger has no allocator view: `allocated_bytes` and
                `capacity_bytes` are None by construction (no exception
                is caught to get there).
  deltas        every owner change appends one row to a bounded delta
                ring: the growth curve behind an out-of-memory.
  forensics     `post_mortem()` dumps the full census + the last N delta
                rows + the offending request/step to a structured JSONL
                artifact (`render_report` renders it); the serving step
                loop calls it when an allocation failure unwinds through
                it (`looks_like_oom`). `check_headroom()` emits one
                structured ``{"headroom_low"}`` row per episode.

Exposure: the ``/memz`` route (`memz()`), registry gauges
``hbm_bytes{owner=...}`` / ``hbm_headroom_bytes`` (`metrics_text()`, the
JAX package's family names), and a `/statusz` memory block
(`statusz_block()`).
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

_logger = logging.getLogger("paddle_tpu_torch.obs.memz")

__all__ = ["MemoryLedger", "looks_like_oom", "load_postmortem",
           "render_report"]

# substrings that identify a device-allocator failure: the CUDA caching
# allocator raises torch.cuda.OutOfMemoryError ("CUDA out of memory"), a
# kernel launch reports cudaErrorMemoryAllocation ("out of memory")
_OOM_MARKERS = ("resource_exhausted", "resource exhausted",
                "out of memory", "oom", "failed to allocate",
                "allocation failure")


def looks_like_oom(exc: BaseException) -> bool:
    """Is this exception a device allocation failure? MemoryError and
    torch.cuda.OutOfMemoryError always; anything else by the
    out-of-memory markers in its text — the serving step gates the
    post-mortem dump on this so an ordinary bug does not masquerade as an
    OOM."""
    import torch
    if isinstance(exc, (MemoryError, torch.cuda.OutOfMemoryError)):
        return True
    text = f"{type(exc).__name__}: {exc}".lower()
    return any(m in text for m in _OOM_MARKERS)


class _Owner:
    __slots__ = ("name", "kind", "device", "overlay", "reader",
                 "bytes", "high", "meta", "detail")

    def __init__(self, name, kind, device, overlay, reader, meta):
        self.name = name
        self.kind = kind
        self.device = device        # counts toward the device conservation sum
        self.overlay = overlay      # bytes live INSIDE another owner's
        #                             reservation: reported, never summed
        self.reader = reader
        self.bytes = 0
        self.high = 0               # high-watermark since registration
        self.meta = dict(meta or {})
        self.detail: Dict = {}

    def to_dict(self) -> dict:
        out = {"owner": self.name, "kind": self.kind,
               "bytes": self.bytes, "high_watermark_bytes": self.high,
               "device": self.device}
        if self.overlay:
            out["overlay"] = True
        if self.meta:
            out["meta"] = self.meta
        if self.detail:
            out["detail"] = self.detail
        return out


class MemoryLedger:
    """See module docstring.

        ledger = MemoryLedger()
        ledger.register("kv_pool", lambda: pool.num_blocks * bpb,
                        kind="kv")
        ledger.set("ckpt_inflight", nbytes, kind="checkpoint",
                   device=False)
        ledger.census()      # owner table + unattributed residual
        ledger.memz({})      # the /memz route payload

    `device` is the device whose allocator the ledger reconciles
    against: CUDA by default (raises without a card, like every entry
    point of the port); a CPU ledger has no allocator view, so its
    allocated and capacity columns are None. `allocated_fn` /
    `capacity_bytes` inject the allocator view (tests, deterministic
    smokes). `headroom_low_frac`: headroom below this fraction of
    capacity emits one ``{"headroom_low"}`` row per episode through
    `on_row`/`jsonl_path`; recovery emits the inert
    ``{"headroom_low_clear"}`` twin.
    """

    def __init__(self, *, device=None,
                 capacity_bytes: Optional[int] = None,
                 allocated_fn: Optional[Callable[[], Optional[int]]] = None,
                 delta_ring: int = 256,
                 headroom_low_frac: float = 0.10,
                 jsonl_path: Optional[str] = None,
                 on_row: Optional[Callable[[dict], None]] = None,
                 postmortem_dir: Optional[str] = None):
        if int(delta_ring) < 1:
            raise ValueError(f"delta_ring must be >= 1, got {delta_ring}")
        from ..device import resolve_device
        self.device = resolve_device(device)
        self.capacity_bytes = capacity_bytes
        self._allocated_fn = allocated_fn
        self.headroom_low_frac = float(headroom_low_frac)
        self.jsonl_path = jsonl_path
        self.on_row = on_row
        self.postmortem_dir = postmortem_dir
        self._lock = threading.RLock()
        self._owners: Dict[str, _Owner] = {}
        self._deltas: deque = deque(maxlen=int(delta_ring))
        self._attr_high = 0        # high-watermark of the attributed sum
        self._headroom_low = False  # episode state (one row per episode)
        self._pm_seq = 0
        self.samples_total = 0
        self.postmortems_total = 0
        self.headroom_low_total = 0

    # ------------------------------------------------------------- owners
    def register(self, name: str,
                 reader: Optional[Callable[[], object]] = None, *,
                 kind: str = "other", device: bool = True,
                 overlay: bool = False, meta: Optional[dict] = None,
                 replace: bool = False) -> "MemoryLedger":
        """Register one owner. `reader` is a ZERO-ARG host-side callable
        returning the owner's current bytes (int, or a dict with a
        "bytes" key whose other entries become the owner's `detail`) —
        it must never touch device state. Reader-less owners are updated
        by `set()`/`add()` pushes instead. Registering an existing name
        raises unless `replace=True` (an engine rebuilding its pools
        replaces deliberately; two subsystems colliding is a bug)."""
        with self._lock:
            if name in self._owners and not replace:
                raise ValueError(f"memory owner {name!r} already "
                                 f"registered (replace=True to rebind)")
            self._owners[name] = _Owner(name, kind, bool(device),
                                        bool(overlay), reader, meta)
        if reader is not None:
            self.sample(name)
        return self

    def unregister(self, name: str) -> bool:
        with self._lock:
            return self._owners.pop(name, None) is not None

    @property
    def owners(self) -> List[str]:
        with self._lock:
            return list(self._owners)

    def _apply(self, o: _Owner, nbytes: int, now: float):
        nbytes = max(int(nbytes), 0)
        if nbytes == o.bytes:
            return
        self._deltas.append({"ts": now, "owner": o.name,
                             "bytes": nbytes,
                             "delta": nbytes - o.bytes})
        o.bytes = nbytes
        o.high = max(o.high, nbytes)
        if o.device and not o.overlay:
            attr = sum(w.bytes for w in self._owners.values()
                       if w.device and not w.overlay)
            self._attr_high = max(self._attr_high, attr)

    def set(self, name: str, nbytes: int, *, kind: str = "other",
            device: bool = True, overlay: bool = False,
            meta: Optional[dict] = None) -> "MemoryLedger":
        """Push-update one owner's bytes (auto-registers a reader-less
        owner on first set — the checkpoint manager's in-flight snapshot
        comes and goes without ceremony)."""
        now = time.time()
        with self._lock:
            o = self._owners.get(name)
            if o is None:
                o = _Owner(name, kind, bool(device), bool(overlay),
                           None, meta)
                self._owners[name] = o
            self._apply(o, nbytes, now)
        return self

    def add(self, name: str, delta: int, **kw) -> "MemoryLedger":
        with self._lock:
            cur = self._owners[name].bytes if name in self._owners else 0
        return self.set(name, cur + int(delta), **kw)

    def sample(self, *names: str) -> "MemoryLedger":
        """Pull every reader-backed owner (or just `names`): host-side
        arithmetic over counters the engine already keeps — cheap enough
        to ride every BlockPool alloc/free (`pool.on_change`)."""
        now = time.time()
        with self._lock:
            self.samples_total += 1
            targets = [self._owners[n] for n in names
                       if n in self._owners] if names \
                else list(self._owners.values())
            for o in targets:
                if o.reader is None:
                    continue
                try:
                    val = o.reader()
                except Exception as e:      # noqa: BLE001 — a broken
                    # reader must not take the scrape (or an alloc
                    # path!) down; the stale value + the log are the
                    # degraded-but-visible behavior
                    _logger.warning("memz reader %r failed: %s",
                                    o.name, e)
                    continue
                if isinstance(val, dict):
                    nbytes = int(val.get("bytes", 0))
                    o.detail = {k: v for k, v in val.items()
                                if k != "bytes"}
                else:
                    nbytes = int(val)
                self._apply(o, nbytes, now)
        return self

    # ------------------------------------------------------------- census
    def _allocated(self) -> Optional[int]:
        """The caching allocator's live bytes on the ledger's CUDA device
        (a host counter: no synchronisation); None on a CPU ledger."""
        if self._allocated_fn is not None:
            v = self._allocated_fn()
            return None if v is None else int(v)
        if self.device.type != "cuda":
            return None
        import torch
        return int(torch.cuda.memory_allocated(self.device))

    def _capacity(self) -> Optional[int]:
        if self.capacity_bytes is not None:
            return int(self.capacity_bytes)
        if self.device.type != "cuda":
            return None
        import torch
        return int(torch.cuda.get_device_properties(
            self.device).total_memory)

    def attributed_bytes(self) -> int:
        """Sum of device owners (overlays excluded — their bytes already
        live inside another owner's reservation)."""
        with self._lock:
            return sum(o.bytes for o in self._owners.values()
                       if o.device and not o.overlay)

    def quick_stats(self) -> dict:
        """The StepMonitor's per-record memory sample when a ledger is
        attached: host counters only."""
        with self._lock:
            attr = sum(o.bytes for o in self._owners.values()
                       if o.device and not o.overlay)
            return {"bytes_in_use": attr,
                    "peak_bytes_in_use": max(self._attr_high, attr),
                    "source": "memz_ledger"}

    def top_owners(self, n: int = 3) -> List[dict]:
        """Largest device owners — the "who to evict" list the kv_oom
        reject reason carries."""
        with self._lock:
            owners = sorted((o for o in self._owners.values()
                             if o.device and not o.overlay),
                            key=lambda o: -o.bytes)
            return [{"owner": o.name, "bytes": o.bytes}
                    for o in owners[:max(int(n), 0)] if o.bytes > 0]

    def census(self, *, reconcile: bool = True) -> dict:
        """The full owner table + the conservation columns. Samples every
        reader first; `reconcile=False` skips the allocator view (pure
        owner table — the per-alloc hot path never wants the live-array
        walk)."""
        self.sample()
        allocated = self._allocated() if reconcile else None
        capacity = self._capacity() if reconcile else None
        with self._lock:
            device = [o.to_dict() for o in self._owners.values()
                      if o.device]
            host = [o.to_dict() for o in self._owners.values()
                    if not o.device]
            attributed = sum(o.bytes for o in self._owners.values()
                             if o.device and not o.overlay)
            attr_high = max(self._attr_high, attributed)
        device.sort(key=lambda d: -d["bytes"])
        host.sort(key=lambda d: -d["bytes"])
        out = {"ts": time.time(),
               "owners": device, "host_owners": host,
               "attributed_bytes": attributed,
               "attributed_high_watermark_bytes": attr_high,
               "allocated_bytes": allocated,
               "unattributed_bytes": (allocated - attributed
                                      if allocated is not None else None),
               "capacity_bytes": capacity,
               "headroom_bytes": (capacity - allocated
                                  if capacity is not None
                                  and allocated is not None else None)}
        if capacity:
            for row in out["owners"]:
                row["pct_of_hbm"] = round(100.0 * row["bytes"]
                                          / capacity, 2)
            if allocated is not None:
                out["headroom_frac"] = round(
                    out["headroom_bytes"] / capacity, 4)
        out["source"] = "allocator" if self.device.type == "cuda" \
            else None
        return out

    def deltas(self, n: Optional[int] = None) -> List[dict]:
        with self._lock:
            rows = list(self._deltas)
        return rows if n is None else rows[-max(int(n), 0):]

    # ----------------------------------------------------------- headroom
    def check_headroom(self, census: Optional[dict] = None
                       ) -> Optional[dict]:
        """Evaluate the headroom-low episode state; returns the emitted
        row (entry or clear transition) or None. The entry row carries a
        ``headroom_low`` key, raised BEFORE the OOM; the clear row's key is
        inert by the *_clear convention."""
        c = census if census is not None else self.census()
        headroom, capacity = c.get("headroom_bytes"), c.get(
            "capacity_bytes")
        if headroom is None or not capacity:
            return None
        low = headroom < self.headroom_low_frac * capacity
        with self._lock:
            if low == self._headroom_low:
                return None
            self._headroom_low = low
            if low:
                self.headroom_low_total += 1
        body = {"headroom_bytes": headroom, "capacity_bytes": capacity,
                "headroom_frac": round(headroom / capacity, 4),
                "threshold_frac": self.headroom_low_frac,
                "top_owners": self.top_owners(3)}
        key = "headroom_low" if low else "headroom_low_clear"
        return self._emit({key: body, "ts": time.time()})

    def _emit(self, row: dict) -> dict:
        if self.jsonl_path:
            with open(self.jsonl_path, "a") as f:
                f.write(json.dumps(row) + "\n")
        if self.on_row is not None:
            self.on_row(row)
        return row

    # ------------------------------------------------------------ surface
    def memz(self, query: Optional[dict] = None) -> dict:
        """TelemetryServer route handler for /memz: the census table,
        the last ``?deltas=N`` owner-delta rows (default 32) and the
        headroom state. Evaluates the headroom trigger as a side effect
        — every scrape is also an arming opportunity."""
        q = query or {}
        try:
            n_deltas = int(q.get("deltas", 32))
        except (TypeError, ValueError):
            raise ValueError(f"deltas must be an integer, "
                             f"got {q.get('deltas')!r}")
        c = self.census()
        self.check_headroom(c)
        return {**c, "deltas": self.deltas(n_deltas),
                "headroom_low": self._headroom_low,
                "postmortems_total": self.postmortems_total}

    def statusz_block(self) -> dict:
        """The compact /statusz memory block: one line per owner +
        conservation summary (the full table is /memz's job)."""
        c = self.census()
        return {"owners": {d["owner"]: d["bytes"] for d in c["owners"]},
                "host_owners": {d["owner"]: d["bytes"]
                                for d in c["host_owners"]},
                "attributed_bytes": c["attributed_bytes"],
                "allocated_bytes": c["allocated_bytes"],
                "unattributed_bytes": c["unattributed_bytes"],
                "headroom_bytes": c["headroom_bytes"],
                "headroom_low": self._headroom_low}

    def metrics_text(self, prefix: str = "paddle_tpu") -> str:
        """Registry producer: ``hbm_bytes{owner=...}`` (device owners,
        overlays included — they carry their own label), per-owner high watermarks,
        ``host_bytes{owner=...}`` for the host tier, and the scalar
        conservation/headroom gauges the SLO machinery consumes."""
        from ..profiler._metrics import (counter_lines, gauge_lines,
                                         labeled_gauge_lines)
        c = self.census()
        lines: List[str] = []
        lines += labeled_gauge_lines(
            prefix, "hbm_bytes", "owner",
            [(d["owner"], d["bytes"]) for d in c["owners"]],
            "live device bytes attributed to each registered owner")
        lines += labeled_gauge_lines(
            prefix, "hbm_high_watermark_bytes", "owner",
            [(d["owner"], d["high_watermark_bytes"])
             for d in c["owners"]],
            "per-owner high watermark since registration")
        lines += labeled_gauge_lines(
            prefix, "host_bytes", "owner",
            [(d["owner"], d["bytes"]) for d in c["host_owners"]],
            "host-RAM bytes attributed to each host-tier owner")
        lines += gauge_lines(prefix, "hbm_attributed_bytes",
                             c["attributed_bytes"],
                             "sum of device owners (overlays excluded)")
        lines += gauge_lines(prefix, "hbm_allocated_bytes",
                             c["allocated_bytes"],
                             "allocator view the ledger reconciles "
                             "against")
        lines += gauge_lines(prefix, "hbm_unattributed_bytes",
                             c["unattributed_bytes"],
                             "allocator bytes no registered owner "
                             "claims")
        lines += gauge_lines(prefix, "hbm_headroom_bytes",
                             c["headroom_bytes"],
                             "capacity minus allocated — the admission/"
                             "flight-recorder arming signal")
        lines += counter_lines(prefix, "hbm_headroom_low_total",
                               self.headroom_low_total,
                               "headroom-low episodes entered")
        lines += counter_lines(prefix, "hbm_postmortems_total",
                               self.postmortems_total,
                               "OOM post-mortem artifacts written")
        return "\n".join(lines) + "\n" if lines else ""

    # ---------------------------------------------------------- forensics
    def post_mortem(self, *, error: Optional[BaseException] = None,
                    context: Optional[dict] = None,
                    dir: Optional[str] = None,
                    deltas: int = 64) -> Optional[str]:
        """Dump the OOM forensics artifact: one JSONL file holding the
        full census (headed by the largest owner — the one-line answer),
        the last `deltas` owner-delta rows (the growth curve) and the
        offending request/step context. Returns the artifact path, or
        None when it could not be written — the dump rides an exception
        handler and must never mask the original failure."""
        out_dir = dir or self.postmortem_dir or "oom_postmortem"
        try:
            os.makedirs(out_dir, exist_ok=True)
            c = self.census()
            top = c["owners"][0] if c["owners"] else None
            with self._lock:
                self._pm_seq += 1
                seq = self._pm_seq
            path = os.path.join(
                out_dir, f"oom_{os.getpid()}_{seq:03d}.jsonl")
            head = {"oom": {
                "ts": time.time(),
                "error": (f"{type(error).__name__}: {error}"
                          if error is not None else None),
                "is_alloc_failure": (looks_like_oom(error)
                                     if error is not None else None),
                "context": context or {},
                "largest_owner": top["owner"] if top else None,
                "largest_owner_bytes": top["bytes"] if top else None}}
            with open(path, "w") as f:
                f.write(json.dumps(head) + "\n")
                f.write(json.dumps({"census": c}) + "\n")
                for d in self.deltas(deltas):
                    f.write(json.dumps({"delta": d}) + "\n")
            with self._lock:
                self.postmortems_total += 1
            _logger.error("memz: OOM post-mortem written to %s "
                          "(largest owner: %s)", path,
                          top["owner"] if top else "<none>")
            return path
        except Exception as e:          # noqa: BLE001 — see docstring
            _logger.warning("memz: post-mortem dump failed: %s", e)
            return None


# ------------------------------------------------------------- rendering

def _fmt_bytes(n) -> str:
    if n is None:
        return "-"
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024.0 or unit == "TiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024.0
    return f"{n:.1f}TiB"


def load_postmortem(path: str) -> dict:
    """Parse one post-mortem artifact back into
    {"oom": ..., "census": ..., "deltas": [...]}. Raises ValueError on a
    file that is not a memz artifact."""
    oom = census = None
    deltas: List[dict] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            row = json.loads(line)
            if "oom" in row:
                oom = row["oom"]
            elif "census" in row:
                census = row["census"]
            elif "delta" in row:
                deltas.append(row["delta"])
    if oom is None or census is None:
        raise ValueError(f"{path} is not a memz post-mortem artifact "
                         f"(missing oom/census rows)")
    return {"oom": oom, "census": census, "deltas": deltas}


def render_report(path: str) -> str:
    """Human rendering of one artifact: the headline (largest owner +
    error), the owner table with bytes / % of device memory / high
    watermarks, the host tier, and each owner's recent growth
    from the delta rows."""
    pm = load_postmortem(path)
    oom, census, deltas = pm["oom"], pm["census"], pm["deltas"]
    lines = ["OOM post-mortem", "=" * 60]
    if oom.get("error"):
        lines.append(f"error:   {oom['error']}")
    if oom.get("largest_owner"):
        lines.append(f"largest owner: {oom['largest_owner']} "
                     f"({_fmt_bytes(oom.get('largest_owner_bytes'))})")
    ctx = oom.get("context") or {}
    if ctx:
        lines.append("context: " + ", ".join(
            f"{k}={v}" for k, v in sorted(ctx.items())))
    lines.append("")
    lines.append(f"{'owner':<24}{'bytes':>12}{'% HBM':>8}{'high':>12}")
    lines.append("-" * 60)
    for d in census.get("owners", []):
        pct = d.get("pct_of_hbm")
        lines.append(
            f"{d['owner'][:23]:<24}{_fmt_bytes(d['bytes']):>12}"
            f"{(f'{pct:.1f}' if pct is not None else '-'):>8}"
            f"{_fmt_bytes(d.get('high_watermark_bytes')):>12}")
    lines.append("-" * 60)
    lines.append(f"{'attributed':<24}"
                 f"{_fmt_bytes(census.get('attributed_bytes')):>12}")
    lines.append(f"{'allocated':<24}"
                 f"{_fmt_bytes(census.get('allocated_bytes')):>12}")
    lines.append(f"{'unattributed':<24}"
                 f"{_fmt_bytes(census.get('unattributed_bytes')):>12}")
    lines.append(f"{'headroom':<24}"
                 f"{_fmt_bytes(census.get('headroom_bytes')):>12}")
    hosts = census.get("host_owners", [])
    if hosts:
        lines.append("")
        lines.append("host tier:")
        for d in hosts:
            lines.append(f"  {d['owner'][:22]:<24}"
                         f"{_fmt_bytes(d['bytes']):>12}")
    if deltas:
        lines.append("")
        lines.append(f"growth curve (last {len(deltas)} owner deltas):")
        for d in deltas:
            sign = "+" if d["delta"] >= 0 else ""
            step = f"{sign}{_fmt_bytes(d['delta'])}"
            lines.append(f"  {d['owner'][:22]:<24}{step:>12}  "
                         f"-> {_fmt_bytes(d['bytes'])}")
    return "\n".join(lines)
