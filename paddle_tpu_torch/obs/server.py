"""TelemetryServer — the replica's ops surface, stdlib-only (the port of
paddle_tpu/obs/server.py).

One threaded HTTP server (http.server.ThreadingHTTPServer on a daemon
thread; no new dependencies) exposes the four endpoints the fleet layer
scrapes — each aimed at a specific consumer:

  /metrics   Prometheus exposition from a MetricsRegistry (dashboard /
             metrics pipeline). Collision-checked and lint-clean per
             scrape; a broken producer 500s loudly.
  /healthz   JSON liveness + load: drain state, queue depth, inflight,
             overloaded_total — exactly the autoscaler/router inputs.
             HTTP 200 while serving, 503 while draining (the code a load
             balancer keys ejection on; the body says why).
  /statusz   JSON config/occupancy snapshot (humans + fleet inventory).
  /tracez    tail-sampled request traces from a TraceBuffer
             (?order=slowest&limit=N&status=timeout) — "why was p99
             slow" without logging every request.

The handlers only READ host-side telemetry state (counter/gauge dicts,
the trace ring, config scalars) — they never touch device state or the
engine's serving loop, so a scrape cannot trigger a compile, a sync or a
lock-order inversion with the serving thread. That is the whole design:
the ops surface rides the accounting the engine already keeps.

Two extensions:

  `routes={...}`   extra JSON GET routes — a handler is a callable taking
                   the (single-valued) query-param dict and returning a
                   JSON-able payload; the serving engine mounts /memz
                   and /probez this way.
  `add_poller()`   a server-OWNED timer thread calling `fn()` every
                   `interval` seconds between start() and close(), so
                   burn-rate evaluation (and its push alerts) run without
                   any outside caller, and the thread dies with the
                   server.
"""
from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional
from urllib.parse import parse_qs, urlsplit

_logger = logging.getLogger("paddle_tpu_torch.obs.server")

from .registry import MetricsRegistry
from .tracez import TraceBuffer

__all__ = ["TelemetryServer", "Raw"]

_CONTENT_PROM = "text/plain; version=0.0.4; charset=utf-8"
_CONTENT_JSON = "application/json; charset=utf-8"


class Raw:
    """A non-JSON payload an extra-route handler may return: raw bytes +
    content type (+ optional download filename). Lets a route stream a
    binary artifact — /profilez's trace.json.gz download — through the
    same dispatch that serves JSON."""

    __slots__ = ("body", "content_type", "filename")

    def __init__(self, body: bytes,
                 content_type: str = "application/octet-stream",
                 filename: Optional[str] = None):
        self.body = bytes(body)
        self.content_type = content_type
        self.filename = filename


def _json_default(o):
    try:
        import numpy as np
        if isinstance(o, np.generic):
            # isinstance-guarded numpy scalar: host data by construction
            return o.item()
        if isinstance(o, np.ndarray):
            return o.tolist()
    except Exception:
        pass
    return repr(o)


class _Handler(BaseHTTPRequestHandler):
    server_version = "paddle-tpu-telemetry/1.0"
    protocol_version = "HTTP/1.1"

    def log_message(self, *args):               # quiet: scrapes are chatty
        pass

    def _send(self, code: int, body: bytes, content_type: str):
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, payload):
        self._send(code, (json.dumps(payload, default=_json_default)
                          + "\n").encode(), _CONTENT_JSON)

    def do_GET(self):                           # noqa: N802 (stdlib name)
        url = urlsplit(self.path)
        route = "/" + url.path.strip("/")
        srv: "TelemetryServer" = self.server.telemetry
        try:
            extra = srv.routes.get(route)
            if extra is not None:
                q = parse_qs(url.query)
                try:
                    payload = extra({k: v[0] for k, v in q.items() if v})
                except ValueError as e:
                    # handler contract: ValueError = bad CLIENT input
                    # (?limit=abc) — a 400, not a 500 a monitor would
                    # page on as an aggregator failure
                    self._send_json(400, {"error": str(e)})
                    return
                if isinstance(payload, Raw):
                    self.send_response(200)
                    self.send_header("Content-Type", payload.content_type)
                    if payload.filename:
                        self.send_header(
                            "Content-Disposition",
                            f'attachment; filename="{payload.filename}"')
                    self.send_header("Content-Length",
                                     str(len(payload.body)))
                    self.end_headers()
                    self.wfile.write(payload.body)
                    return
                self._send_json(200, payload if payload is not None
                                else {})
            elif route == "/metrics":
                body = srv.registry.render().encode()
                self._send(200, body, _CONTENT_PROM)
            elif route == "/healthz":
                payload = srv._call(srv.health) or {"status": "ok"}
                code = 200 if payload.get("status") == "ok" else 503
                self._send_json(code, payload)
            elif route == "/statusz":
                self._send_json(200, srv._call(srv.status) or {})
            elif route == "/tracez":
                if srv.tracez is None:
                    self._send_json(404, {"error": "no trace buffer "
                                                   "attached"})
                    return
                q = parse_qs(url.query)

                def one(key, default=None):
                    v = q.get(key)
                    return v[0] if v else default
                traces = srv.tracez.snapshot(
                    limit=int(one("limit", 64)),
                    status=one("status"),
                    order=one("order", "recent"))
                if one("fmt") == "chrome":
                    # Perfetto/Chrome trace-event export: the
                    # span trees as a timeline ui.perfetto.dev loads
                    from .tracez import chrome_trace
                    self._send_json(200, chrome_trace(traces))
                    return
                self._send_json(200, {"summary": srv.tracez.summary(),
                                      "traces": traces})
            else:
                self._send_json(404, {"error": f"unknown route {route}",
                                      "routes": ["/metrics", "/healthz",
                                                 "/statusz", "/tracez"]
                                      + sorted(srv.routes)})
        except BrokenPipeError:
            pass                                # scraper hung up; its call
        except Exception as e:                  # noqa: BLE001 — a broken
            # producer must fail THE SCRAPE (visibly), not the server
            try:
                self._send_json(500, {"error": f"{type(e).__name__}: {e}"})
            except Exception:
                pass


class TelemetryServer:
    """See module docstring.

        srv = TelemetryServer(registry, health=engine.health,
                              status=engine.statusz,
                              tracez=buffer).start()
        ... curl http://127.0.0.1:{srv.port}/metrics ...
        srv.close()

    `port=0` binds an ephemeral port (read `.port` after construction —
    the socket binds in __init__, requests are served once `start()`
    spins the thread). `health`/`status` are zero-arg callables returning
    JSON-able dicts; `tracez` a TraceBuffer (or None to 404 the route).
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None, *,
                 host: str = "127.0.0.1", port: int = 0,
                 health: Optional[Callable[[], dict]] = None,
                 status: Optional[Callable[[], dict]] = None,
                 tracez: Optional[TraceBuffer] = None,
                 routes: Optional[Dict[str, Callable]] = None):
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.health = health
        self.status = status
        self.tracez = tracez
        # extra JSON routes: "/memz" -> fn(query_dict) -> payload
        self.routes = {("/" + r.strip("/")): fn
                       for r, fn in (routes or {}).items()}
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.telemetry = self
        self._thread: Optional[threading.Thread] = None
        self._pollers: list = []

    @staticmethod
    def _call(fn):
        return fn() if fn is not None else None

    # ------------------------------------------------------------- routes
    def add_route(self, route: str, fn: Callable) -> "TelemetryServer":
        """Mount an extra GET route on a live server (same handler
        contract as the `routes=` ctor arg). Replaces any previous
        handler at that path."""
        self.routes["/" + route.strip("/")] = fn
        return self

    def remove_route(self, route: str) -> "TelemetryServer":
        self.routes.pop("/" + route.strip("/"), None)
        return self

    @property
    def host(self) -> str:
        return self._httpd.server_address[0]

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def url(self, route: str = "/") -> str:
        return f"http://{self.host}:{self.port}/{route.lstrip('/')}"

    # ------------------------------------------------------------ pollers
    def add_poller(self, fn: Callable[[], object], interval: float,
                   name: str = "poller") -> "TelemetryServer":
        """Own a timer thread calling `fn()` every `interval` seconds
        for the server's lifetime (first call one interval after start —
        a burn-rate window needs traffic before it means anything). A
        raising poll is logged and counted on the poller record, never
        fatal: the alerting loop must not die on one transient. Threads
        start with start() and stop with close()."""
        if interval is None or interval <= 0:
            raise ValueError(f"poller interval must be > 0, "
                             f"got {interval}")
        rec = {"fn": fn, "interval": float(interval), "name": name,
               "stop": threading.Event(), "thread": None,
               "polls": 0, "errors": 0}
        self._pollers.append(rec)
        if self._thread is not None:        # server already serving
            self._start_poller(rec)
        return self

    def _start_poller(self, rec):
        if rec["thread"] is not None:
            return
        if rec["stop"].is_set():            # server re-started post-close
            rec["stop"] = threading.Event()

        def loop():
            while not rec["stop"].wait(rec["interval"]):
                try:
                    rec["fn"]()
                    rec["polls"] += 1
                except Exception:           # noqa: BLE001 — see docstring
                    rec["errors"] += 1
                    _logger.exception("telemetry poller %r failed",
                                      rec["name"])
        rec["thread"] = threading.Thread(
            target=loop, name=f"paddle-tpu-telemetry-{rec['name']}",
            daemon=True)
        rec["thread"].start()

    @property
    def pollers(self) -> list:
        return [{k: r[k] for k in ("name", "interval", "polls", "errors")}
                for r in self._pollers]

    def start(self) -> "TelemetryServer":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever,
                kwargs={"poll_interval": 0.1},
                name="paddle-tpu-telemetry", daemon=True)
            self._thread.start()
        for rec in self._pollers:
            self._start_poller(rec)
        return self

    def close(self):
        for rec in self._pollers:
            rec["stop"].set()
        for rec in self._pollers:
            if rec["thread"] is not None:
                rec["thread"].join(timeout=5.0)
                rec["thread"] = None
        if self._thread is not None:
            self._httpd.shutdown()
            self._thread.join(timeout=5.0)
            self._thread = None
        self._httpd.server_close()

    def __enter__(self) -> "TelemetryServer":
        return self.start()

    def __exit__(self, *exc):
        self.close()
