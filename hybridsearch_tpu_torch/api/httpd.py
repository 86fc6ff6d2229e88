"""Zero-dependency HTTP server for the router (stdlib http.server; the
port of ``hybridsearch_tpu/api/httpd.py``).

The reference serves via FastAPI + uvicorn (reference api.py / cli.py:162-
172); neither need be installed, so the primary server is a stdlib
ThreadingHTTPServer adapter over api/app.py's router. The FastAPI adapter
(api/fastapi_app.py) provides the same routes when fastapi is installed.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qsl, urlparse

from hybridsearch_tpu_torch.api.app import EngineState, Router, build_router
from hybridsearch_tpu_torch.utils.tracing import GLOBAL_COUNTERS as _COUNTERS


def make_handler(router: Router):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _dispatch(self, method: str) -> None:
            parsed = urlparse(self.path)
            if method == "GET" and parsed.path in ("/", "/ui"):
                from hybridsearch_tpu_torch.api.webui import HTML_PAGE

                raw = HTML_PAGE.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(raw)))
                self.end_headers()
                self.wfile.write(raw)
                return
            # repeated params collect into a list (the reference's /rerank
            # takes repeated doc_ids query params, api.py:521-524); single
            # values stay scalar
            query = {}
            for k, v in parse_qsl(parsed.query):
                if k in query:
                    if isinstance(query[k], list):
                        query[k].append(v)
                    else:
                        query[k] = [query[k], v]
                else:
                    query[k] = v
            body = {}
            length = int(self.headers.get("Content-Length") or 0)
            if length:
                try:
                    body = json.loads(self.rfile.read(length) or b"{}")
                except json.JSONDecodeError:
                    self._send(400, {"detail": "invalid JSON body"}, {})
                    return
            api_key = self.headers.get("X-API-Key") or None
            auth = self.headers.get("Authorization", "")
            if api_key is None and auth.startswith("Bearer "):
                api_key = auth[7:]
            client_ip = self.client_address[0] if self.client_address else "unknown"
            status, payload, headers = router.dispatch(
                method, parsed.path, body=body, query=query,
                api_key=api_key, client_ip=client_ip,
            )
            self._send(status, payload, headers)

        def _send(self, status: int, payload: dict, headers: dict) -> None:
            if isinstance(payload, dict) and "_text" in payload:
                raw = str(payload["_text"]).encode()
                ctype = "text/plain; version=0.0.4"
            else:
                raw = json.dumps(payload).encode()
                ctype = "application/json"
            try:
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(raw)))
                for k, v in headers.items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(raw)
            except (BrokenPipeError, ConnectionResetError, TimeoutError):
                # client hung up (loadgen timeout, impatient browser):
                # nothing to deliver to; count it and keep the worker
                # thread alive instead of dumping a traceback per drop
                _COUNTERS.inc("client_disconnect")
                self.close_connection = True

        def do_GET(self):  # noqa: N802
            self._dispatch("GET")

        def do_POST(self):  # noqa: N802
            self._dispatch("POST")

        def do_DELETE(self):  # noqa: N802
            self._dispatch("DELETE")

        def log_message(self, fmt, *args):  # silence default stderr logging
            pass

    return Handler


class _ThreadingServer(ThreadingHTTPServer):
    # socketserver's listen backlog is 5: a burst of clients connecting at
    # once past it is dropped or reset by the kernel before a handler runs
    request_queue_size = 1024


class APIServer:
    """Threaded HTTP server wrapper; use .serve_forever() or as a context
    manager (background thread) for tests."""

    def __init__(self, state: EngineState, host: str = "0.0.0.0",
                 port: int = 8000) -> None:
        self.state = state
        self.router = build_router(state)
        self.httpd = _ThreadingServer((host, port), make_handler(self.router))
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def serve_forever(self) -> None:
        self.httpd.serve_forever()

    def __enter__(self) -> "APIServer":
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)


def serve(state: EngineState, host: str = "0.0.0.0", port: int = 8000) -> None:
    server = APIServer(state, host, port)
    print(f"hybridsearch_tpu_torch API listening on http://{host}:{server.port}",
          flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        state.close()
