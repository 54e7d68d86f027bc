"""OpenMetrics/Prometheus HTTP exporter for the telemetry registry (port
of the JAX package's ``monitoring/exporter.py``).

A stdlib-only ``http.server`` on a localhost daemon thread (behind
``spark.rapids.sql.metrics.port``; 0 = never started: tests read
:func:`telemetry.render_text` directly). Endpoints:

- ``/metrics``: the OpenMetrics text exposition;
- ``/healthz``: liveness ("ok").

Bound to 127.0.0.1 only: the scrape surface carries query shapes, so
exposure beyond the host is a deliberate operator decision, not a
default.
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

_LOCK = threading.Lock()
_SERVER: Optional[ThreadingHTTPServer] = None
_THREAD: Optional[threading.Thread] = None
_PORT = 0

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class _Handler(BaseHTTPRequestHandler):

    def do_GET(self):  # noqa: N802 (http.server API)
        if self.path.split("?", 1)[0] == "/metrics":
            from spark_rapids_tpu_torch.monitoring import telemetry
            try:
                body = telemetry.render_text().encode("utf-8")
            except Exception as e:     # a scrape must never wedge a query
                self.send_response(500)
                self.end_headers()
                self.wfile.write(f"render failed: {e}".encode())
                return
            self.send_response(200)
            self.send_header("Content-Type", CONTENT_TYPE)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif self.path == "/healthz":
            self.send_response(200)
            self.end_headers()
            self.wfile.write(b"ok")
        else:
            self.send_response(404)
            self.end_headers()

    def log_message(self, fmt, *args):  # silence per-request stderr lines
        pass


def ensure_started(port: int) -> int:
    """Start the exporter on 127.0.0.1:``port`` if not already running
    (idempotent; a running exporter keeps its original port). ``port``
    0 binds an ephemeral port (tests). Returns the bound port."""
    global _SERVER, _THREAD, _PORT
    with _LOCK:
        if _SERVER is not None:
            return _PORT
        server = ThreadingHTTPServer(("127.0.0.1", int(port)), _Handler)
        server.daemon_threads = True
        thread = threading.Thread(
            target=server.serve_forever, kwargs={"poll_interval": 0.25},
            name="srt-metrics-exporter", daemon=True)
        thread.start()
        _SERVER, _THREAD = server, thread
        _PORT = server.server_address[1]
        return _PORT


def stop() -> None:
    """Shut the exporter down (tests; production lets the daemon thread
    die with the process)."""
    global _SERVER, _THREAD, _PORT
    with _LOCK:
        server, thread = _SERVER, _THREAD
        _SERVER, _THREAD, _PORT = None, None, 0
    if server is not None:
        server.shutdown()
        server.server_close()
    if thread is not None:
        thread.join(timeout=5.0)


def running() -> bool:
    with _LOCK:
        return _SERVER is not None


def port() -> int:
    with _LOCK:
        return _PORT
