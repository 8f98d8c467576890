"""StepMonitor — per-step telemetry of a step loop (the port of
paddle_tpu/profiler/monitor.py).

The serving engine keeps one as its batch monitor; any step loop can:

  - per-step wall time and items/sec (tokens or images; the caller sets
    `items_per_step` or passes `items=` per step);
  - achieved MFU against the card's peak rate (`peak_flops`, or the
    H100 data sheet's dense bf16 rate when the current CUDA device is an
    H100; None elsewhere);
  - live/peak device memory from the attached MemoryLedger's host
    counters, or `torch.cuda.memory_allocated` /
    `max_memory_allocated` (host counters: neither synchronises);
  - compile accounting and a recompilation detector: the step owner
    calls `record_compile` when a step built a new executable; one with
    a prior signature is a RECOMPILE, and its shape delta is logged and
    recorded;
  - the compute/communication overlap of the latest captured trace
    (`record_overlap`, fed `trace_analysis.TraceAnalysis.overlap()`) and
    its per-collective ledger (`record_collectives`, fed
    `collective_rows()`);
  - shard skew: `record_shard_steps` takes one step's wall per shard
    (rank), keeps the slowest-shard and skew-ratio gauges and runs the
    straggler state machine: one {"straggler"} row when the skew reaches
    `straggler_threshold`, one {"straggler_clear"} row when it recovers,
    never a row a step;
  - the step brackets of an attached `obs.FlightRecorder` (its capture
    state machine advances at step boundaries, outside the timed window).

Each step appends one JSONL row when `jsonl_path` is set, and `on_report`
(if given) is called with the row dict (`_emit` is the shared path,
mirroring ServingMetrics). `jit.TrainStep(monitor=...)` feeds it.
"""
from __future__ import annotations

import contextlib
import json
import logging
import time
from typing import Callable, Optional

logger = logging.getLogger("paddle_tpu_torch.profiler.monitor")

# NVIDIA H100 SXM dense peak rates (the data sheet), FLOP/s by dtype
H100_PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


def shape_delta(old_sig, new_sig) -> str:
    """Human-readable delta between two abstract-shape signatures (tuples of
    (shape, dtype) leaves) — the payload of a recompilation log line."""
    if old_sig is None:
        return "first compile"
    old, new = list(old_sig), list(new_sig)
    if len(old) != len(new):
        return f"leaf count {len(old)} -> {len(new)}"
    diffs = []
    for i, (o, n) in enumerate(zip(old, new)):
        if o != n:
            diffs.append(f"leaf[{i}]: {o} -> {n}")
    return "; ".join(diffs) if diffs else "signature changed (non-shape key)"


class StepMonitor:
    """Record per-step metrics; see module docstring.

    flops_per_step / flops_per_item: model FLOPs for the MFU figure (set
    either; `flops_per_item` multiplies the per-step item count). May be
    assigned after the run, before report(): MFU is computed at report
    time. `peak_flops` defaults to the H100's bf16 rate
    (`H100_PEAK_FLOPS`; pass the f32 entry for an f32 model)."""

    def __init__(self, *, flops_per_step: Optional[float] = None,
                 flops_per_item: Optional[float] = None,
                 items_per_step: Optional[float] = None,
                 unit: str = "items/s", peak_flops: Optional[float] = None,
                 jsonl_path: Optional[str] = None,
                 on_report: Optional[Callable[[dict], None]] = None,
                 track_memory: bool = True,
                 memory_sample_every: Optional[int] = None,
                 log_recompiles: bool = True,
                 straggler_threshold: float = 1.5,
                 jsonl_flush_every: int = 1):
        self.flops_per_step = flops_per_step
        self.flops_per_item = flops_per_item
        self.items_per_step = items_per_step
        self.unit = unit
        self.peak_flops = peak_flops
        self.jsonl_path = jsonl_path
        # 1 opens/appends/closes per row; > 1 keeps one handle and
        # flushes every N rows
        self.jsonl_flush_every = max(1, int(jsonl_flush_every))
        self._jsonl_f = None
        self._jsonl_unflushed = 0
        self.on_report = on_report
        self.track_memory = track_memory
        # allocator counters are cheap to read every step; without a card
        # there are none, and the sample is taken every 10th step
        self.memory_sample_every = memory_sample_every
        self._mem_every = None
        self.log_recompiles = log_recompiles
        self.records = []          # one dict per end_step
        self.compiles = 0          # executables built in monitored steps
        self.recompiles = 0        # compiles beyond the first per kind
        self.recompile_events = []  # {step, kind, delta}
        self.overlap = None        # latest compute/comm overlap (dict)
        self.collectives = []      # latest per-collective ledger rows
        # shard skew: at or above `straggler_threshold` (slowest shard's
        # wall over the median of the others) a shard is straggling; a row
        # goes out at each transition into and out of that state
        self.straggler_threshold = float(straggler_threshold)
        self.shard_skew = None     # latest record_shard_steps figures
        self.straggler_events = []  # straggler / straggler_clear rows
        self.stragglers_total = 0   # transitions into straggling
        self._straggling = False
        self.numerics_events = []
        self._last_numerics = {}
        self._steps = 0
        self._t0 = None
        self._compiled_this_step = 0
        # an attached obs.FlightRecorder rides the step brackets
        self.flightrec = None
        # an attached MemoryLedger: per-step memory samples read its host
        # counters instead of the allocator's
        self.memz = None

    # ------------------------------------------------------------- steps
    def begin_step(self):
        fr = self.flightrec
        if fr is not None:
            fr.begin_step()
        self._compiled_this_step = 0
        self._t0 = time.perf_counter()

    def end_step(self, items: Optional[float] = None, steps: int = 1,
                 wall_s: Optional[float] = None):
        """Close the step opened by begin_step (or record an externally
        timed window via `wall_s`). `steps` > 1 amortizes one multi-step
        launch over its step count."""
        external = wall_s is not None
        if wall_s is None:
            if self._t0 is None:
                return
            wall_s = time.perf_counter() - self._t0
        self._t0 = None
        self._steps += steps
        if items is None and self.items_per_step is not None:
            items = self.items_per_step * steps
        rec = {"step": self._steps, "wall_s": wall_s, "steps": steps,
               "step_ms": wall_s / max(steps, 1) * 1e3,
               "compiled": self._compiled_this_step > 0,
               "recompiles_total": self.recompiles,
               "ts": time.time()}
        if items is not None:
            rec["items"] = items
            rec["items_per_s"] = items / wall_s if wall_s > 0 else None
            mfu = self._mfu(items / max(steps, 1),
                            wall_s / max(steps, 1))
            if mfu is not None:
                rec["mfu"] = round(mfu, 4)
        self._compiled_this_step = 0
        if self.track_memory and self._memory_due():
            mem = self._memory()
            if mem is not None:
                rec["hbm_bytes_in_use"] = mem.get("bytes_in_use")
                rec["hbm_peak_bytes"] = mem.get("peak_bytes_in_use")
        self.records.append(rec)
        out = self._emit(rec)
        fr = self.flightrec
        if fr is not None:
            fr.end_step()
            if external:
                # externally timed launches (TrainStep's wall_s path) never
                # call begin_step: each end is the step boundary, so arm
                # the recorder here for the next launch
                fr.begin_step()
        return out

    @contextlib.contextmanager
    def step(self, items: Optional[float] = None, steps: int = 1):
        self.begin_step()
        try:
            yield self
        finally:
            self.end_step(items=items, steps=steps)

    # ----------------------------------------------------------- emission
    def _emit(self, row: dict, report: bool = True,
              jsonl: bool = True) -> dict:
        """One emission path for every structured row: JSONL append and
        the on_report hook stay in lockstep. `report=False` keeps a row
        JSONL-only (the overlap row, as in the JAX monitor); `jsonl=False`
        keeps a row hook-only (the JSONL stream stays one row per
        step)."""
        if jsonl and self.jsonl_path:
            if self.jsonl_flush_every <= 1:
                with open(self.jsonl_path, "a") as f:
                    f.write(json.dumps(row) + "\n")
            else:
                if self._jsonl_f is None:
                    self._jsonl_f = open(self.jsonl_path, "a")
                self._jsonl_f.write(json.dumps(row) + "\n")
                self._jsonl_unflushed += 1
                if self._jsonl_unflushed >= self.jsonl_flush_every:
                    self.flush_jsonl()
        if report and self.on_report is not None:
            self.on_report(row)
        return row

    def flush_jsonl(self):
        if self._jsonl_f is not None:
            self._jsonl_f.flush()
            self._jsonl_unflushed = 0

    def close(self):
        """Flush and release the buffered JSONL handle (idempotent)."""
        if self._jsonl_f is not None:
            self._jsonl_f.flush()
            self._jsonl_f.close()
            self._jsonl_f = None
            self._jsonl_unflushed = 0

    # ----------------------------------------------------------- compiles
    def record_compile(self, kind: str, sig, prev_sig=None,
                       count: bool = True):
        """Called by the step owner when a step built a new executable. A
        build with a prior signature is a RECOMPILE: log the shape delta.
        count=False logs and records the shape-delta warning without
        feeding the counters (a request refused because it would have
        forced a new executable)."""
        if count:
            self.compiles += 1
            self._compiled_this_step += 1
        if prev_sig is not None:
            if count:
                self.recompiles += 1
            delta = shape_delta(prev_sig, sig)
            self.recompile_events.append(
                {"step": self._steps + 1, "kind": kind, "delta": delta})
            if self.log_recompiles:
                logger.warning("%s of %s at step %d: %s",
                               "recompilation" if count
                               else "refused shape change",
                               kind, self._steps + 1, delta)
            self._emit({"recompile": {"step": self._steps + 1,
                                      "kind": kind, "delta": delta,
                                      "counted": bool(count)},
                        "ts": time.time()}, jsonl=False)

    # ------------------------------------------------------------ overlap
    def record_overlap(self, overlap):
        """Adopt a compute/communication overlap measurement as a gauge:
        `overlap` is `trace_analysis.TraceAnalysis.overlap()`'s dict (or a
        bare ratio). It lands in report()'s and metrics_text()'s
        `overlap_ratio` and, when it has a ratio, as one JSONL row."""
        if overlap is None:
            return
        if not isinstance(overlap, dict):
            overlap = {"ratio": float(overlap)}
        self.overlap = dict(overlap)
        if overlap.get("ratio") is not None:
            self._emit({"overlap": self.overlap, "ts": time.time()},
                       report=False)
        return self.overlap

    def record_collectives(self, rows):
        """Adopt a per-collective ledger (`trace_analysis.TraceAnalysis
        .collective_rows()`) as gauges: per op its seconds, exposed
        seconds, bytes and bus bandwidth land in report() and
        metrics_text(), labeled by op, and the rows go out as one JSONL
        row."""
        self.collectives = [dict(r) for r in (rows or [])]
        if self.collectives:
            self._emit({"collectives": self.collectives,
                        "ts": time.time()}, report=False)
        return self.collectives

    def record_shard_steps(self, walls, step: Optional[int] = None):
        """One step's wall seconds per shard ({shard: wall}). In a step
        the collectives synchronise, every shard waits for the slowest,
        so the skew ratio (slowest over the median of the others) says
        what the straggler costs. Updates the `shard_skew` gauges and runs
        the straggler state machine (one row a transition, flushed at
        once). Returns the figures."""
        walls = {str(k): float(v) for k, v in dict(walls).items()}
        if not walls:
            return None
        slowest = max(walls, key=walls.get)
        # the baseline leaves the slowest out: with two shards a median of
        # all would let the straggler judge itself
        rest = sorted(v for k, v in walls.items() if k != slowest) \
            or [walls[slowest]]
        n = len(rest)
        median = rest[n // 2] if n % 2 \
            else (rest[n // 2 - 1] + rest[n // 2]) / 2.0
        skew = walls[slowest] / median if median > 0 else 1.0
        self.shard_skew = {"step": step, "shards": len(walls),
                           "walls": walls,
                           "slowest_shard": slowest,
                           "slowest_wall_s": walls[slowest],
                           "median_wall_s": median,
                           "skew_ratio": skew}
        straggling = len(walls) > 1 and skew >= self.straggler_threshold
        if straggling != self._straggling:
            self._straggling = straggling
            kind = "straggler" if straggling else "straggler_clear"
            if straggling:
                self.stragglers_total += 1
            event = {kind: dict(self.shard_skew,
                                threshold=self.straggler_threshold),
                     "ts": time.time()}
            self.straggler_events.append(event)
            if straggling:
                logger.warning(
                    "straggler at step %s: shard %s at %.4fs vs median "
                    "%.4fs (skew %.2fx >= %.2fx)", step, slowest,
                    walls[slowest], median, skew,
                    self.straggler_threshold)
            self._emit(event)
            self.flush_jsonl()
        return self.shard_skew

    @property
    def straggling(self) -> bool:
        return self._straggling

    # ----------------------------------------------------------- numerics
    def record_numerics(self, step: int, loss: Optional[float] = None,
                        grad_norm: Optional[float] = None, events=()):
        """Loss / grad-norm scalars already on the host land in the JSONL
        stream (one `numerics` row per call); every event is recorded and
        logged."""
        row = {"numerics": {"step": step, "loss": loss,
                            "grad_norm": grad_norm},
               "ts": time.time()}
        self._last_numerics = {"step": step, "loss": loss,
                               "grad_norm": grad_norm}
        evs = [e.to_dict() if hasattr(e, "to_dict") else dict(e)
               for e in events]
        if evs:
            row["numerics"]["events"] = evs
            self.numerics_events.extend(evs)
            for e in evs:
                logger.warning("numerics event at step %s: %s %s — %s",
                               e.get("step"), e.get("kind"),
                               e.get("path") or "", e.get("message"))
        return self._emit(row)

    # ------------------------------------------------------------ internals
    def _peak(self) -> Optional[float]:
        """The given peak, else the H100 data sheet's bf16 rate when the
        current CUDA device is an H100; None elsewhere (no figure of
        another card is assumed)."""
        if self.peak_flops is not None:
            return self.peak_flops
        import torch
        if torch.cuda.is_available() and \
                "H100" in torch.cuda.get_device_name():
            return H100_PEAK_FLOPS["bfloat16"]
        return None

    def _mfu(self, items_per_step, step_s) -> Optional[float]:
        flops = self.flops_per_step
        if flops is None and self.flops_per_item is not None \
                and items_per_step is not None:
            flops = self.flops_per_item * items_per_step
        if flops is None or not step_s:
            return None
        peak = self._peak()
        if peak is None:
            return None
        return flops / step_s / peak

    def _memory_due(self) -> bool:
        if self.memz is not None:
            return True               # the ledger's host counters are free
        if self._mem_every is None:
            every = self.memory_sample_every
            if every is None:
                import torch
                every = 1 if torch.cuda.is_available() else 10
            self._mem_every = max(1, int(every))
        n = len(self.records) + 1   # this end_step call's ordinal
        return n == 1 or n % self._mem_every == 0

    def _memory(self) -> Optional[dict]:
        if self.memz is not None:
            return self.memz.quick_stats()
        import torch
        if not torch.cuda.is_available():
            return None
        return {"bytes_in_use": torch.cuda.memory_allocated(),
                "peak_bytes_in_use": torch.cuda.max_memory_allocated()}

    # -------------------------------------------------- resumable counters
    def state_dict(self) -> dict:
        """Counter continuity across a resume: steps keep accumulating and
        the compile counters keep their baseline."""
        return {"steps": int(self._steps), "compiles": int(self.compiles),
                "recompiles": int(self.recompiles),
                "stragglers": int(self.stragglers_total)}

    def set_state_dict(self, state: dict):
        self._steps = int(state.get("steps", 0))
        self.compiles = int(state.get("compiles", 0))
        self.recompiles = int(state.get("recompiles", 0))
        self.stragglers_total = int(state.get("stragglers", 0))
        return self

    # ------------------------------------------------------------- report
    def report(self) -> dict:
        """Aggregate summary. Steady step time is the median over steps
        that built no executable."""
        steady = [r for r in self.records if not r["compiled"]] or self.records
        step_ms = sorted(r["step_ms"] for r in steady) if steady else []
        med = step_ms[len(step_ms) // 2] if step_ms else None
        items_s = None
        tot_items = sum(r.get("items", 0) for r in steady)
        tot_wall = sum(r["wall_s"] for r in steady)
        if tot_items and tot_wall:
            items_s = tot_items / tot_wall
        mfu = self._mfu(
            tot_items / max(sum(r["steps"] for r in steady), 1) if tot_items
            else None,
            med / 1e3 if med else None)
        peak_hbm = max((r.get("hbm_peak_bytes") or 0 for r in self.records),
                       default=0) or None
        last_hbm = next((r.get("hbm_bytes_in_use") for r in
                         reversed(self.records)
                         if r.get("hbm_bytes_in_use") is not None), None)
        num = {"numerics_events": len(self.numerics_events)}
        if self._last_numerics:
            num["loss"] = self._last_numerics.get("loss")
            num["grad_norm"] = self._last_numerics.get("grad_norm")
        shard = {}
        if self.shard_skew is not None:
            shard = {"shard_skew_ratio": round(
                         self.shard_skew["skew_ratio"], 4),
                     "slowest_shard": self.shard_skew["slowest_shard"],
                     "stragglers_total": self.stragglers_total,
                     "straggling": self._straggling}
        coll = {}
        if self.collectives:
            coll = {"collectives": [
                {"name": r["name"],
                 "ms": round(r["dur_us"] / 1e3, 3),
                 "exposed_ms": round(r["exposed_us"] / 1e3, 3),
                 "bytes": r.get("bytes"),
                 "bus_gbps": (round(r["bus_gbps"], 2)
                              if r.get("bus_gbps") is not None else None)}
                for r in self.collectives]}
        return {"steps": self._steps,
                **num,
                "overlap_ratio": (self.overlap or {}).get("ratio"),
                **shard, **coll,
                "step_ms": round(med, 3) if med is not None else None,
                "items_per_s": round(items_s, 1) if items_s else None,
                "unit": self.unit,
                "mfu": round(mfu, 4) if mfu is not None else None,
                "hbm_bytes_in_use": last_hbm,
                "hbm_peak_bytes": peak_hbm,
                "compiles": self.compiles,
                "recompiles": self.recompiles}

    def metrics_text(self, prefix: str = "paddle_tpu") -> str:
        """Prometheus exposition of report(), through the shared
        `_metrics` formatter (ServingMetrics uses the same one, so one
        page carries both blocks). The metric names are the JAX
        monitor's."""
        from ._metrics import gauge_lines
        r = self.report()
        lines = []

        def gauge(name, val, help_):
            lines.extend(gauge_lines(prefix, name, val, help_))

        gauge("steps_total", r["steps"], "steps recorded")
        if r["step_ms"] is not None:
            gauge("step_seconds", round(r["step_ms"] / 1e3, 6),
                  "median steady step wall time")
        gauge("throughput", r["items_per_s"],
              f"steady throughput ({r['unit']})")
        gauge("mfu", r["mfu"], "achieved model FLOPs utilization")
        gauge("hbm_bytes_in_use", r["hbm_bytes_in_use"],
              "live device memory")
        gauge("hbm_peak_bytes", r["hbm_peak_bytes"], "peak device memory")
        gauge("compiles_total", r["compiles"], "traced-step compiles")
        gauge("recompiles_total", r["recompiles"],
              "recompilations (shape-signature changes)")
        gauge("overlap_ratio", r["overlap_ratio"],
              "compute/comm overlap: fraction of collective time hidden "
              "under device compute (latest captured trace)")
        if self.collectives:
            from .trace_analysis import collective_series_lines
            lines += collective_series_lines(self.collectives, prefix)
        if self.shard_skew is not None:
            from ._metrics import labeled_gauge_lines
            lines += labeled_gauge_lines(
                prefix, "shard_step_seconds", "shard",
                sorted(self.shard_skew["walls"].items()),
                "latest per-shard step wall time")
            gauge("shard_skew_ratio", r.get("shard_skew_ratio"),
                  "slowest shard step wall / median shard step wall")
            slowest = self.shard_skew["slowest_shard"]
            try:
                gauge("slowest_shard", int(slowest),
                      "shard id with the slowest latest step wall")
            except (TypeError, ValueError):
                pass          # a named shard: the labeled walls say which
            gauge("straggling", 1 if self._straggling else 0,
                  "a shard is currently straggling (skew over threshold)")
            gauge("stragglers_total", self.stragglers_total,
                  "transitions into straggling state")
        gauge("numerics_events_total", r["numerics_events"],
              "numerics anomalies detected (nan/inf/grad/loss/dead-layer)")
        gauge("loss", r.get("loss"), "latest fetched training loss")
        gauge("grad_norm", r.get("grad_norm"),
              "latest fetched global gradient norm")
        return "\n".join(lines) + "\n"
