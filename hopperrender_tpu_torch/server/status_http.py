"""HTTP status & control endpoint — the property page / SettingsInterface equivalent.

The reference exposes live state through a COM settings page refreshed at source-fps
cadence (ref: HopperRenderSettings.cpp:142-220; iez.h:12-51). The server equivalent is
a tiny stdlib HTTP endpoint on a background thread:

  GET  /metrics   -> JSON ServerMetrics snapshot (the 23 GetCurrentSettings fields)
  GET  /settings  -> JSON persisted-settings view
  POST /settings  -> JSON body of Settings fields; applied live (UpdateUserSettings)
  GET  /healthz   -> 200 ok / 503 wedged (engine-thread heartbeat when a
                     PipelinedServer is attached: detects device calls that
                     HANG, e.g. a dead accelerator transport)

No external dependencies; intended for dashboards/curl, not the public internet.

PyTorch port of hopperrender_tpu/server/status_http.py. /metrics carries the
port's ServerMetrics, which has every field of the JAX package's but
warp_apron (the TPU band warp's apron tier, which the port has no use for):
the two endpoints' /metrics differ by exactly that key.
"""

from __future__ import annotations

import dataclasses
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from hopperrender_tpu_torch.server.frame_server import FrameServer
from hopperrender_tpu_torch.utils.logging import get_logger

log = get_logger("status_http")


def _make_handler(server: FrameServer, pipeline=None):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload) -> None:
            body = json.dumps(payload, indent=2).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (stdlib casing)
            if self.path == "/metrics":
                self._send(200, dataclasses.asdict(server.metrics()))
            elif self.path == "/settings":
                self._send(200, dataclasses.asdict(server.settings))
            elif self.path == "/healthz":
                if pipeline is not None and not pipeline.healthy():
                    self._send(503, {
                        "status": "wedged",
                        "stall_seconds": round(pipeline.stall_seconds(), 1),
                        "engine_error": repr(pipeline._error)
                        if pipeline._error else None,
                    })
                else:
                    self._send(200, {"status": "ok"})
            else:
                self._send(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):  # noqa: N802
            if self.path != "/settings":
                self._send(404, {"error": f"unknown path {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                updates = json.loads(self.rfile.read(length) or b"{}")
                known = {f.name for f in dataclasses.fields(server.settings)}
                bad = set(updates) - known
                if bad:
                    self._send(400, {"error": f"unknown settings: {sorted(bad)}"})
                    return
                server.update_settings(**updates)
                self._send(200, dataclasses.asdict(server.settings))
            except (ValueError, TypeError) as e:
                self._send(400, {"error": str(e)})

        def log_message(self, fmt, *args):  # route to our logger, not stderr
            log.debug("http: " + fmt, *args)

    return Handler


class StatusServer:
    """Background status endpoint bound to (host, port); port 0 picks a free port."""

    def __init__(self, server: FrameServer, host: str = "127.0.0.1", port: int = 0,
                 pipeline=None):
        self._httpd = ThreadingHTTPServer((host, port),
                                          _make_handler(server, pipeline))
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="hrt-status-http", daemon=True)
        self._thread.start()
        log.info("status endpoint on http://%s:%d", self.host, self.port)

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)
