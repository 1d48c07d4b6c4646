"""Metrics exposition endpoints: Prometheus scrape + JSON artifacts.

:class:`MetricsServer` is the live side of ``serve_integrals
--metrics-port``: a daemon-threaded stdlib HTTP server answering

* ``GET /metrics``      — Prometheus text exposition (scrapeable),
* ``GET /metrics.json`` — the JSON snapshot,
* ``GET /convergence``  — per-stream stderr-vs-rounds trajectories.

It binds on construction (so a busy port fails loudly at startup, not
at first scrape) and serves whatever the registry holds at request
time — no caching, no background aggregation.

:func:`write_snapshot` is the batch side (``--metrics-json``): one JSON
file carrying the metrics snapshot, the convergence trajectories and a
wall-clock stamp.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from repro_torch.obs import clock


class MetricsServer:
    """Serve a registry (and optional convergence log) over HTTP."""

    def __init__(self, registry, *, port: int = 0, host: str = "127.0.0.1",
                 convergence=None):
        self.registry = registry
        self.convergence = convergence
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):                      # noqa: N802 (stdlib API)
                if self.path.rstrip("/") in ("", "/metrics".rstrip("/"),
                                             "/metrics"):
                    body = outer.registry.render_prometheus().encode()
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif self.path == "/metrics.json":
                    body = json.dumps(outer.registry.snapshot(),
                                      sort_keys=True).encode()
                    ctype = "application/json"
                elif self.path == "/convergence":
                    log = outer.convergence
                    body = json.dumps(log.snapshot() if log else {},
                                      sort_keys=True).encode()
                    ctype = "application/json"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):          # silence per-request spam
                return None

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="metrics-server",
            daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)

    def __enter__(self) -> "MetricsServer":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


def write_snapshot(path: str, registry, *, convergence=None,
                   extra: dict | None = None) -> dict:
    """Write the one-file JSON artifact (metrics + trajectories)."""
    payload = {
        "wall_time": clock.wall(),
        "metrics": registry.snapshot(),
        "convergence": convergence.snapshot() if convergence else {},
    }
    if extra:
        payload.update(extra)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
    return payload
