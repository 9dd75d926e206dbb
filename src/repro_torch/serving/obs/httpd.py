"""Stdlib HTTP surface for the serving metrics: ``/metrics`` + ``/healthz``.

``MetricsServer`` runs a ``ThreadingHTTPServer`` on a daemon thread:

  * ``GET /metrics``  -> 200, Prometheus text exposition of the registry
  * ``GET /metrics.json`` -> 200, the registry's JSON snapshot
  * ``GET /healthz``  -> JSON health document from ``health_fn`` — 200 when
    ``status == "ok"``, 503 under backpressure or drain (the load-balancer
    contract: a saturated or draining shard stops receiving traffic)

``port=0`` binds an ephemeral port (read it back from ``server.port``) —
what the tests and the CI smoke use.  The handler threads only ever READ
engine state through the registry's callback gauges and ``health_fn``
(plain attribute loads under the GIL), so scraping is safe against a serve
loop running on the main thread.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

from repro_torch.serving.obs.registry import MetricsRegistry

PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class MetricsServer:
    def __init__(self, registry: MetricsRegistry,
                 health_fn: Optional[Callable[[], dict]] = None,
                 host: str = "127.0.0.1", port: int = 0):
        self.registry = registry
        self.health_fn = health_fn
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # route access logs to logging, not
                pass                    # stderr (quiet under benchmarks)

            def _send(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                if path == "/metrics":
                    self._send(200, outer.registry.render().encode(),
                               PROM_CONTENT_TYPE)
                elif path == "/metrics.json":
                    self._send(
                        200,
                        json.dumps(outer.registry.snapshot()).encode(),
                        "application/json")
                elif path == "/healthz":
                    doc = (outer.health_fn() if outer.health_fn is not None
                           else {"status": "ok"})
                    code = 200 if doc.get("status") == "ok" else 503
                    self._send(code, json.dumps(doc).encode(),
                               "application/json")
                else:
                    self._send(404, b"not found\n", "text/plain")

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        host = self._httpd.server_address[0]
        return f"http://{host}:{self.port}"

    def start(self) -> "MetricsServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="asd-metrics",
            daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
