"""HTTP edge for the fleet router: one /generate in front of N replicas.

Clients talk to this exactly like a single replica's ``InferenceServer``
(``POST /generate``, streaming or not) — the difference is what happens
behind it: the router places each request (canary split → session pin →
prefix affinity → least-loaded), mints the ``X-Request-Id`` when the
client sent none, propagates it to the replica, and fails queued
requests over to survivors.  The envelope and every SSE terminal event
carry the replica that actually served the tokens plus the failover
count; the access-log line (same ``deeplearning4j_tpu_torch.serving.access``
logger, emitted BEFORE the response flushes) adds the placement reason.

Failover contract at this edge: a replica death before the first token
is invisible to the client (retried via the router); a death mid-stream
is a clean terminal ``data: {"error": ..., "done": true}`` event — never
a silently truncated stream.
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from deeplearning4j_tpu_torch.observability.tracing import new_trace_id
from deeplearning4j_tpu_torch.serving.admission import ServingError

logger = logging.getLogger("deeplearning4j_tpu_torch.fleet")
access_logger = logging.getLogger("deeplearning4j_tpu_torch.serving.access")


class FleetFrontend:
    """See module docstring."""

    def __init__(self, router, port: int = 0, access_log: bool = False):
        self.router = router
        self.access_log = bool(access_log)
        self._requested_port = port
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self.port: Optional[int] = None

    def _access(self, freq, status: str, http_status: int,
                reason: Optional[str]) -> None:
        if not self.access_log:
            return
        try:
            access_logger.info(json.dumps({
                "trace_id": freq.trace_id if freq is not None else None,
                "endpoint": "fleet_generate",
                "replica": freq.replica_id if freq is not None else None,
                "placement_reason": reason,
                "failovers": freq.failovers if freq is not None else None,
                "status": status,
                "http_status": http_status,
                "tokens": len(freq.tokens) if freq is not None else None,
                "finish_reason": (freq.finish_reason
                                  if freq is not None else None),
            }))
        except Exception:
            logger.debug("fleet access-log line failed", exc_info=True)

    def start(self) -> int:
        frontend = self
        router = self.router

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _json(self, obj, code=200):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    live = [r for r in router.replicas() if r["live"]]
                    self._json({"status": "ok" if live else "unavailable",
                                "live_replicas": len(live)},
                               code=200 if live else 503)
                elif self.path == "/fleet":
                    self._json({"replicas": router.replicas()})
                else:
                    self.send_error(404)

            def do_POST(self):
                if self.path != "/generate":
                    self.send_error(404)
                    return
                # minted at the router edge when absent — the SAME id
                # rides to the replica and back (request tracing)
                tid = self.headers.get("X-Request-Id") or new_trace_id()
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    obj = json.loads(self.rfile.read(n).decode())
                    assert isinstance(obj, dict) and "prompt" in obj
                except Exception:
                    self._json({"error": 'generate body must be '
                                '{"prompt": [token ids], ...}',
                                "trace_id": tid}, code=400)
                    return
                stream = bool(obj.get("stream", False))
                kw = {}
                for src, dst in (("temperature", "temperature"),
                                 ("top_k", "top_k"), ("top_p", "top_p"),
                                 ("seed", "seed"),
                                 ("deadline_s", "deadline_s"),
                                 ("stop_token", "stop_token")):
                    if obj.get(src) is not None:
                        kw[dst] = obj[src]
                freq = None
                try:
                    freq = router.submit(
                        [int(t) for t in obj["prompt"]],
                        int(obj.get("max_tokens", 32)),
                        session_id=obj.get("session_id"),
                        trace_id=tid, **kw)
                except ServingError as e:
                    frontend._access(freq, type(e).__name__,
                                     e.http_status, None)
                    self._json({"error": str(e), "type": type(e).__name__,
                                "trace_id": tid}, code=e.http_status)
                    return
                except (TypeError, ValueError) as e:
                    self._json({"error": str(e), "type": type(e).__name__,
                                "trace_id": tid}, code=400)
                    return
                reason = (freq.placements[-1].reason
                          if freq.placements else None)
                if stream:
                    self._stream(freq, tid, reason)
                else:
                    self._unary(freq, tid, reason)

            def _unary(self, freq, tid, reason):
                try:
                    tokens = freq.result()
                except ServingError as e:
                    frontend._access(freq, type(e).__name__,
                                     e.http_status, reason)
                    self._json({"error": str(e), "type": type(e).__name__,
                                "trace_id": tid,
                                "replica": freq.replica_id},
                               code=e.http_status)
                    return
                except Exception as e:
                    frontend._access(freq, type(e).__name__, 502, reason)
                    self._json({"error": str(e), "type": type(e).__name__,
                                "trace_id": tid,
                                "replica": freq.replica_id}, code=502)
                    return
                frontend._access(freq, "ok", 200, reason)
                self._json({"tokens": tokens,
                            "finish_reason": freq.finish_reason,
                            "trace_id": tid, "replica": freq.replica_id,
                            "failovers": freq.failovers,
                            "placement_reason": reason})

            def _stream(self, freq, tid, reason):
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-store")
                self.send_header("Connection", "close")
                self.end_headers()

                def event(payload):
                    self.wfile.write(
                        f"data: {json.dumps(payload)}\n\n".encode())
                    self.wfile.flush()

                status, code = "ok", 200
                try:
                    for i, tok in enumerate(freq.stream()):
                        event({"token": tok, "index": i, "trace_id": tid})
                    event({"done": True, "tokens": len(freq.tokens),
                           "finish_reason": freq.finish_reason,
                           "trace_id": tid, "replica": freq.replica_id,
                           "failovers": freq.failovers})
                except BrokenPipeError:
                    freq.cancel()
                    status, code = "client_disconnected", 499
                except Exception as e:
                    # mid-stream replica death (or any terminal error):
                    # the client gets a CLEAN terminal event, not EOF
                    status = type(e).__name__
                    code = getattr(e, "http_status", 502)
                    try:
                        event({"error": str(e), "type": status,
                               "trace_id": tid, "done": True,
                               "replica": freq.replica_id,
                               "failovers": freq.failovers})
                    except Exception:
                        pass
                frontend._access(freq, status, code, reason)

        self._httpd = ThreadingHTTPServer(
            ("127.0.0.1", self._requested_port), Handler)
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="fleet-frontend", daemon=True)
        self._thread.start()
        self.port = self._httpd.server_address[1]
        return self.port

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
