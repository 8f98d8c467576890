"""The ops surface of the port (paddle_tpu/obs, less its multi-device
readers):

  MetricsRegistry    composes every exposition producer into ONE
                     collision-checked, lint-clean Prometheus page
                     (registry.py; `lint_exposition` is the promtool-style
                     check over the shared profiler/_metrics parser).
  TelemetryServer    threaded HTTP server on 127.0.0.1: /metrics,
                     /healthz, /statusz, /tracez plus extra JSON routes
                     (/memz, /probez) and poller threads (server.py).
  TraceBuffer        bounded per-request trace retention with TAIL
                     sampling: every failure + the slowest decile always
                     kept (tracez.py).
  SLOMonitor         declarative TTFT/TPOT/e2e/goodput objectives as
                     multi-window burn rates over the log-bucket
                     histograms (slo.py; `parse_slo` / `evaluate_slo`).
  MemoryLedger       owner-attributed device-memory accounting reconciled
                     against the CUDA caching allocator (memz.py).
  Prober             golden-canary correctness probes through the real
                     serving path, bitwise against `generate_static_ragged`
                     goldens (probez.py).
  InvariantAuditor   deep host-side audits of the block pool and the
                     radix trie (probez.py).
  FlightRecorder     anomaly-triggered torch.profiler captures in a
                     bounded ring, served on /profilez (flightrec.py).

Every scrape reads host counters only: no device->host copy, no
synchronisation. `ServingEngine.serve_telemetry()` wires them around a
live engine. The fleet aggregator and the collective ledger belong to
the multi-GPU slice (ROADMAP.md, queue A).
"""
from .flightrec import (FixtureBackend, FlightRecorder,  # noqa: F401
                        TorchProfilerBackend, TRIGGER_KEYS)
from .memz import (MemoryLedger, load_postmortem,  # noqa: F401
                   looks_like_oom, render_report)
from .probez import (GoldenStore, InvariantAuditor, Prober,  # noqa: F401
                     config_fingerprint)
from .registry import (ExpositionError, MetricsCollisionError,  # noqa: F401
                       MetricsRegistry, lint_exposition)
from .server import Raw, TelemetryServer  # noqa: F401
from .slo import (SLOMonitor, SLOTarget, evaluate_slo,  # noqa: F401
                  format_slo_table, parse_slo)
from .tracez import TraceBuffer, chrome_trace  # noqa: F401

__all__ = ["ExpositionError", "MetricsCollisionError", "MetricsRegistry",
           "lint_exposition", "TelemetryServer", "Raw", "SLOMonitor",
           "SLOTarget", "parse_slo", "evaluate_slo", "format_slo_table",
           "TraceBuffer", "chrome_trace", "MemoryLedger", "looks_like_oom",
           "load_postmortem", "render_report", "Prober", "GoldenStore",
           "InvariantAuditor", "config_fingerprint", "FlightRecorder",
           "TorchProfilerBackend", "FixtureBackend", "TRIGGER_KEYS"]
