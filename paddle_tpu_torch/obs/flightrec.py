"""FlightRecorder — anomaly-triggered profiling with a bounded capture ring
(the port of paddle_tpu/obs/flightrec.py).

Every alerting signal the port emits (SLO burn-rate alerts, numerics
events, recompiles, probe failures, memory pressure) dies as a JSONL row;
by the time a human attaches the Profiler the anomaly is gone. The flight
recorder keeps the profiler armed, captures cheap and bounded, and lets
the anomaly pull the trigger.

  ring        a bounded ring of capture records. Two kinds: `periodic`
              low-duty-cycle background captures (N steps every M steps,
              `every=0` disables) and `trigger` captures pinned by an
              anomaly. Eviction under ring pressure NEVER removes a
              pinned capture while a periodic one remains; only a ring
              full of pinned captures evicts its oldest pinned entry
              (capacity is a hard bound either way). Evicted captures
              drop their trace file from disk.
  trigger bus `attach(monitor=..., slo=..., metrics=...)` chains onto
              the existing structured-row hooks (StepMonitor.on_report,
              SLOMonitor.on_alert, ServingMetrics.on_record — previous
              hooks are preserved and restored by `detach()`) and sniffs
              rows for `slo_alert` / `straggler` / `recompile` /
              `mem_pressure` / `headroom_low` / `probe_fail` /
              `invariant_violation` / `numerics`-with-events. A matching
              row requests capture of the NEXT `trigger_steps` steps.
              Dedup is two-layer: a trigger while a capture is
              pending/active COALESCES into it (and pins it), and a
              trigger within `cooldown_s` of the last trigger-started
              capture is SUPPRESSED — an alert storm yields ONE capture.
  steps       the recorder is step-hook driven: `begin_step()` /
              `end_step()` (StepMonitor calls them when the recorder is
              attached) start the backend trace at the next step
              boundary and stop it `steps` later. Triggers from any
              thread only flip state under a lock; the profiler is only
              ever touched from the step thread — a poller thread can
              never race it.
  evidence    every finished capture appends one structured
              `{"capture": ...}` JSONL row (when `jsonl_path` is set)
              linking trigger kind -> trace path -> the trigger's own
              row verbatim, and lands in the ring for `/profilez`
              (`profilez()` is a TelemetryServer route handler: list
              captures, render KernelView/DeviceView/DistributedView
              tables from a capture's trace, download the raw
              trace.json.gz).

The capture backend is injectable: `TorchProfilerBackend` (default)
drives a `torch.profiler` capture (CUDA activity on a card) and writes
its chrome trace; `FixtureBackend` materializes a given trace file
instead (deterministic tests). A failing backend counts `capture_errors`
and the recorder re-arms: as in the JAX package, profiling never takes
the job down, and callers that must see a capture check
`capture_errors` and the capture's `error`.
"""
from __future__ import annotations

import gzip
import json
import logging
import os
import shutil
import threading
import time
from typing import Callable, List, Optional

_logger = logging.getLogger("paddle_tpu_torch.obs.flightrec")

__all__ = ["FlightRecorder", "TorchProfilerBackend", "FixtureBackend",
           "TRIGGER_KEYS"]

# structured-row keys the trigger bus fires on (transition rows only:
# *_clear rows carry different keys and stay inert). mem_pressure /
# headroom_low: the ledger's episode-entry rows arm a pinned capture
# before the OOM the episode foreshadows. probe_fail /
# invariant_violation: a correctness sentinel tripping pins the capture
# at the moment of divergence
TRIGGER_KEYS = ("slo_alert", "straggler", "recompile",
                "mem_pressure", "headroom_low", "probe_fail",
                "invariant_violation")


class TorchProfilerBackend:
    """Default capture backend: a `torch.profiler` capture with CPU
    activity, and CUDA activity when a card is present. `start()` opens
    it from the step thread; `stop(dest)` waits for the device, closes
    it and writes its chrome trace gzipped to `dest`
    (`trace_analysis.export_capture`). Returns the dest path."""

    def __init__(self):
        self._prof = None

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
        self._prof = prof

    def stop(self, dest: str) -> Optional[str]:
        import torch
        from ..profiler.trace_analysis import export_capture
        prof, self._prof = self._prof, None
        if prof is None:
            return None
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        return export_capture(prof, dest)


class FixtureBackend:
    """Capture backend that 'captures' a given trace file: stop() copies
    `src` to the destination (gzipping .json -> .json.gz when needed).
    Gives tests a deterministic capture independent of the tracer."""

    def __init__(self, src: str):
        self.src = src
        self.captures = 0

    def start(self):
        pass

    def stop(self, dest: str) -> Optional[str]:
        self.captures += 1
        if self.src.endswith(".gz") or not dest.endswith(".gz"):
            shutil.copyfile(self.src, dest)
        else:
            with open(self.src, "rb") as f, gzip.open(dest, "wb") as g:
                shutil.copyfileobj(f, g)
        return dest


class FlightRecorder:
    """See module docstring.

        rec = FlightRecorder("run/flightrec", ring=8, every=200,
                             capture_steps=3, cooldown_s=60)
        rec.attach(monitor=monitor, slo=slo)     # the trigger bus
        ... monitor.begin_step()/end_step() drive it per step ...
        rec.profilez({})                         # the /profilez payload

    `every=0` (default) disables periodic captures — trigger-only.
    `trigger_steps` defaults to `capture_steps`. `clock` is the cooldown
    clock (monotonic seconds; injectable for tests)."""

    def __init__(self, dir: str, *, ring: int = 8, every: int = 0,
                 capture_steps: int = 2,
                 trigger_steps: Optional[int] = None,
                 cooldown_s: float = 30.0,
                 backend=None, jsonl_path: Optional[str] = None,
                 on_capture: Optional[Callable[[dict], None]] = None,
                 clock: Callable[[], float] = time.monotonic):
        if int(ring) < 1:
            raise ValueError(f"ring must be >= 1, got {ring}")
        if int(every) < 0:
            raise ValueError(f"every must be >= 0, got {every}")
        self.dir = os.path.abspath(dir)
        os.makedirs(self.dir, exist_ok=True)
        self.ring = int(ring)
        self.every = int(every)
        self.capture_steps = max(1, int(capture_steps))
        self.trigger_steps = max(1, int(trigger_steps
                                        if trigger_steps is not None
                                        else capture_steps))
        self.cooldown_s = float(cooldown_s)
        self.backend = backend if backend is not None \
            else TorchProfilerBackend()
        self.jsonl_path = jsonl_path
        self.on_capture = on_capture
        self._clock = clock
        self._lock = threading.RLock()
        self.captures: List[dict] = []      # the ring, oldest..newest
        self._seq = 0
        self._step = 0                      # steps seen (begin_step count)
        self._pending: Optional[dict] = None  # requested, tracer not on
        self._active: Optional[dict] = None   # tracer running
        # first periodic capture starts at the first step, then every
        # `every` steps from each periodic start
        self._next_periodic = 1
        self._last_trigger_t: Optional[float] = None
        self.triggers_total = 0
        self.triggers_coalesced = 0
        self.triggers_suppressed = 0
        self.captures_total = 0
        self.captures_pinned_total = 0
        self.capture_errors = 0
        self.evicted_periodic = 0
        self.evicted_pinned = 0
        self._attached: List[tuple] = []

    # ------------------------------------------------------------ triggers
    def trigger(self, kind: str, row: Optional[dict] = None
                ) -> Optional[str]:
        """Request a pinned capture of the next `trigger_steps` steps.
        Thread-safe and cheap — only state flips here; the device tracer
        starts at the next begin_step(). Returns the capture id the
        trigger landed on (a new pending capture, or the pending/active
        one it coalesced into), or None when suppressed by cooldown."""
        trig = {"kind": str(kind), "step": None, "ts": time.time(),
                "row": row}
        with self._lock:
            self.triggers_total += 1
            trig["step"] = self._step
            tgt = self._active if self._active is not None else self._pending
            if tgt is not None:
                # coalesce: the storm's later alerts become evidence on
                # the one capture already in flight — and pin it (a
                # periodic capture that caught an anomaly is evidence)
                tgt["pinned"] = True
                tgt["triggers"].append(trig)
                tgt["steps_left"] = max(tgt["steps_left"],
                                        self.trigger_steps)
                self.triggers_coalesced += 1
                return tgt["id"]
            now = self._clock()
            if (self.cooldown_s > 0 and self._last_trigger_t is not None
                    and now - self._last_trigger_t < self.cooldown_s):
                self.triggers_suppressed += 1
                return None
            self._last_trigger_t = now
            self._pending = self._new_capture(
                "trigger", pinned=True, steps=self.trigger_steps,
                triggers=[trig])
            return self._pending["id"]

    def _new_capture(self, kind: str, *, pinned: bool, steps: int,
                     triggers: List[dict]) -> dict:
        self._seq += 1
        return {"id": f"c{self._seq:04d}", "kind": kind, "pinned": pinned,
                "steps_left": steps, "triggers": triggers,
                "step_first": None, "step_last": None,
                "t0": None, "_mono0": None,
                "trace_path": None, "wall_s": None, "error": None}

    # --------------------------------------------------------------- steps
    def begin_step(self):
        """Step boundary: start a due capture (pending trigger first,
        else a due periodic). Called from the step thread only — the one
        place the backend's start() runs."""
        cap = None
        with self._lock:
            self._step += 1
            if self._active is not None:
                return
            if self._pending is None and self.every > 0 \
                    and self._step >= self._next_periodic:
                self._pending = self._new_capture(
                    "periodic", pinned=False, steps=self.capture_steps,
                    triggers=[])
            cap, self._pending = self._pending, None
            if cap is None:
                return
            if self.every > 0:
                # any capture resets the periodic cadence — back-to-back
                # trigger + periodic captures of the same steps would be
                # duplicate evidence
                self._next_periodic = self._step + self.every
            cap["step_first"] = self._step
            cap["t0"] = time.time()
            cap["_mono0"] = time.monotonic()
            self._active = cap
        try:
            self.backend.start()
        except Exception as e:              # noqa: BLE001 — see docstring
            with self._lock:
                self.capture_errors += 1
                self._active = None
            _logger.warning("flightrec capture start failed: %s", e)

    def end_step(self):
        """Step boundary: one captured step elapsed; finalize the active
        capture when its step budget is spent."""
        with self._lock:
            cap = self._active
            if cap is None:
                return None
            cap["steps_left"] -= 1
            if cap["steps_left"] > 0:
                return None
            cap["step_last"] = self._step
            cap["wall_s"] = time.monotonic() - cap["_mono0"]
            self._active = None             # triggers now start fresh
        return self._finalize(cap)

    def _finalize(self, cap: dict) -> dict:
        dest = os.path.join(self.dir, f"{cap['id']}.trace.json.gz")
        try:
            cap["trace_path"] = self.backend.stop(dest)
        except Exception as e:              # noqa: BLE001 — see docstring
            cap["error"] = f"{type(e).__name__}: {e}"
            _logger.warning("flightrec capture %s failed: %s",
                            cap["id"], e)
        meta = self._meta(cap)
        with self._lock:
            self.captures.append(cap)
            self.captures_total += 1
            if cap["pinned"]:
                self.captures_pinned_total += 1
            if cap["error"] is not None:
                self.capture_errors += 1
            while len(self.captures) > self.ring:
                self._evict_one()
        if self.jsonl_path:
            with open(self.jsonl_path, "a") as f:
                f.write(json.dumps({"capture": meta, "ts": time.time()})
                        + "\n")
        if self.on_capture is not None:
            self.on_capture(meta)
        return cap

    def _evict_one(self):
        """Oldest periodic capture first; only a ring that is ALL pinned
        evicts its oldest pinned entry (the hard capacity bound)."""
        victim = next((c for c in self.captures if not c["pinned"]), None)
        if victim is None:
            victim = self.captures[0]
            self.evicted_pinned += 1
        else:
            self.evicted_periodic += 1
        self.captures.remove(victim)
        if victim.get("trace_path"):
            try:
                os.remove(victim["trace_path"])
            except OSError:
                pass

    # --------------------------------------------------------- trigger bus
    def attach(self, *, monitor=None, slo=None, metrics=None
               ) -> "FlightRecorder":
        """Wire the trigger bus into existing emitters, preserving any
        hook already installed (the chained previous hook still runs
        first). `monitor` additionally gets its `flightrec` slot set so
        its begin_step/end_step drive the capture state machine.
        `detach()` undoes everything in reverse order."""
        if monitor is not None:
            if getattr(monitor, "flightrec", None) is not None \
                    and monitor.flightrec is not self:
                raise ValueError("monitor already has a flight recorder "
                                 "attached")
            monitor.flightrec = self
            self._attached.append(("slot", monitor))
            self._chain(monitor, "on_report")
        if slo is not None:
            self._chain(slo, "on_alert")
        if metrics is not None:
            self._chain(metrics, "on_record")
        return self

    def _chain(self, obj, attr: str):
        prev = getattr(obj, attr, None)
        tap = self.tap

        def chained(row, _prev=prev, _tap=tap):
            if _prev is not None:
                _prev(row)
            _tap(row)
        setattr(obj, attr, chained)
        self._attached.append(("hook", obj, attr, prev))

    def detach(self):
        for entry in reversed(self._attached):
            if entry[0] == "slot":
                entry[1].flightrec = None
            else:
                _, obj, attr, prev = entry
                setattr(obj, attr, prev)
        self._attached = []
        return self

    def tap(self, row):
        """The trigger bus: sniff one structured row; anomaly rows
        request a capture, everything else is a dict-key probe."""
        if not isinstance(row, dict):
            return
        for key in TRIGGER_KEYS:
            if key in row:
                self.trigger(key, row)
                return
        num = row.get("numerics")
        if isinstance(num, dict) and num.get("events"):
            self.trigger("numerics", row)

    # ------------------------------------------------------------ reporting
    @staticmethod
    def _meta(cap: dict) -> dict:
        steps = None
        if cap["step_first"] is not None and cap["step_last"] is not None:
            steps = cap["step_last"] - cap["step_first"] + 1
        return {"id": cap["id"], "kind": cap["kind"],
                "pinned": cap["pinned"], "ts": cap["t0"],
                "step_first": cap["step_first"],
                "step_last": cap["step_last"], "steps": steps,
                "wall_s": (round(cap["wall_s"], 6)
                           if cap["wall_s"] is not None else None),
                "trace_path": cap["trace_path"], "error": cap["error"],
                "triggers": [{"kind": t["kind"], "step": t["step"],
                              "ts": t["ts"], "row": t["row"]}
                             for t in cap["triggers"]]}

    def summary(self) -> dict:
        with self._lock:
            pinned = sum(1 for c in self.captures if c["pinned"])
            return {"dir": self.dir, "ring": self.ring,
                    "retained": len(self.captures),
                    "retained_pinned": pinned,
                    "every": self.every,
                    "capture_steps": self.capture_steps,
                    "trigger_steps": self.trigger_steps,
                    "cooldown_s": self.cooldown_s,
                    "step": self._step,
                    "active": (self._active or {}).get("id"),
                    "pending": (self._pending or {}).get("id"),
                    "captures_total": self.captures_total,
                    "captures_pinned_total": self.captures_pinned_total,
                    "capture_errors": self.capture_errors,
                    "triggers_total": self.triggers_total,
                    "triggers_coalesced": self.triggers_coalesced,
                    "triggers_suppressed": self.triggers_suppressed,
                    "evicted_periodic": self.evicted_periodic,
                    "evicted_pinned": self.evicted_pinned}

    def metrics_text(self, prefix: str = "paddle_tpu_flightrec") -> str:
        from ..profiler._metrics import counter_lines, gauge_lines
        s = self.summary()
        lines: List[str] = []
        lines += gauge_lines(prefix, "ring_retained", s["retained"],
                             "captures currently in the ring")
        lines += gauge_lines(prefix, "ring_pinned", s["retained_pinned"],
                             "pinned captures currently in the ring")
        for name, val, help_ in (
                ("captures_total", s["captures_total"],
                 "captures finished"),
                ("captures_pinned_total", s["captures_pinned_total"],
                 "trigger-pinned captures"),
                ("capture_errors_total", s["capture_errors"],
                 "captures that failed"),
                ("triggers_total", s["triggers_total"],
                 "trigger-bus firings"),
                ("triggers_coalesced_total", s["triggers_coalesced"],
                 "triggers merged into an in-flight capture"),
                ("triggers_suppressed_total", s["triggers_suppressed"],
                 "triggers dropped by the cooldown window"),
                ("evictions_total",
                 s["evicted_periodic"] + s["evicted_pinned"],
                 "captures evicted from the ring")):
            lines += counter_lines(prefix, name, val, help_)
        return "\n".join(lines) + "\n"

    # ------------------------------------------------------------ /profilez
    def _find(self, cid: str) -> dict:
        with self._lock:
            for c in self.captures:
                if c["id"] == cid:
                    return c
        raise ValueError(f"unknown capture id {cid!r}")

    def profilez(self, query: Optional[dict] = None):
        """TelemetryServer route handler. No `id`: the capture list
        (newest first) + summary. With `?id=`: `view=kernel|device|
        distributed` returns the view's structured rows AND its rendered
        table text (byte-identical to what `trace_analysis` prints from
        the same trace file); `fmt=raw` streams the trace.json.gz
        itself. ValueError on bad input -> HTTP 400."""
        q = query or {}
        cid = q.get("id")
        if not cid:
            with self._lock:
                caps = [self._meta(c) for c in reversed(self.captures)]
            return {"summary": self.summary(), "captures": caps}
        cap = self._find(cid)
        path = cap.get("trace_path")
        if not path or not os.path.exists(path):
            raise ValueError(f"capture {cid} has no trace file "
                             f"({cap.get('error') or 'evicted?'})")
        if q.get("fmt") == "raw":
            from .server import Raw
            with open(path, "rb") as f:
                body = f.read()
            ctype = "application/gzip" if path.endswith(".gz") \
                else "application/json"
            return Raw(body, content_type=ctype,
                       filename=os.path.basename(path))
        from ..profiler.trace_analysis import analyze
        steps = None
        if cap["step_first"] is not None and cap["step_last"] is not None:
            steps = cap["step_last"] - cap["step_first"] + 1
        an = analyze(path, steps=steps)
        view = q.get("view", "kernel")
        if view == "kernel":
            rows, table = an.op_totals(), an.kernel_view()
        elif view == "device":
            rows, table = an.lane_busy(), an.device_view()
        elif view in ("distributed", "collective", "collectives"):
            rows, table = an.collective_rows(), an.distributed_view()
        else:
            raise ValueError(f"unknown view {view!r}; one of "
                             f"kernel|device|distributed (or fmt=raw)")
        return {"capture": self._meta(cap), "view": view,
                "rows": rows, "table": table,
                "total_device_us": an.total_device_us(),
                "overlap": an.overlap()}
