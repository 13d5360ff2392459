"""Replica handles the fleet router places onto.

Two shapes, one duck type (``submit → handle.stream()/result()``,
``pin_prefix``/``unpin_prefix``, optional ``deploy``/``rollback``/
``commit_swap``):

* ``InProcessReplica`` wraps a started ``GenerationEngine`` directly —
  the unit-test and rollout-drill shape (rollouts need ``deploy``,
  which requires the model OBJECT and therefore a shared process).
* ``HTTPReplica`` fronts a subprocess replica's ``InferenceServer``
  over urllib: ``submit`` is a streaming ``POST /generate`` whose
  admission rejections come back as typed ``ServingError`` subclasses
  (the router's failover classification needs the real types, not
  strings), and whose transport deaths surface as ``ConnectionError``s
  — transient by the retry classification, which is exactly what makes
  a SIGKILLed replica's queued requests retryable on a survivor.
"""

from __future__ import annotations

import json
import threading
import urllib.error
import urllib.request
import uuid
from typing import Any, Dict, List, Optional, Sequence

from deeplearning4j_tpu_torch.serving.admission import (
    DeadlineExceededError, ModelNotFoundError, QueueFullError,
    ServingError, ShuttingDownError)

_ERROR_TYPES = {c.__name__: c for c in (
    QueueFullError, ShuttingDownError, DeadlineExceededError,
    ModelNotFoundError)}


class ReplicaError(RuntimeError):
    """A replica-side failure that is not a typed admission rejection
    (transient vs fatal falls back to message classification)."""


def _map_error(etype: Optional[str], msg: str,
               http_status: Optional[int] = None) -> BaseException:
    cls = _ERROR_TYPES.get(etype or "")
    if cls is not None:
        return cls(msg)
    if http_status == 400 or etype == "_BadRequest":
        return ValueError(msg)         # the client's fault: fatal, no retry
    return ReplicaError(f"{etype or 'error'}: {msg}")


class InProcessReplica:
    """A started ``GenerationEngine`` as a fleet replica (class doc)."""

    can_deploy = True

    def __init__(self, replica_id: str, engine):
        self.replica_id = str(replica_id)
        self.engine = engine
        self._epoch = uuid.uuid4().hex[:12]
        self._seq = 0
        self._lock = threading.Lock()

    # -------- routing-table row for aggregator-less (unit-test) routers
    def local_view(self) -> Dict[str, Any]:
        eng = self.engine
        alive = eng._thread is not None and eng._thread.is_alive()
        with self._lock:
            if alive:
                # seq advances only while the decode thread lives, so a
                # router death-mark keyed on (epoch, seq) stays put for a
                # stopped engine — same contract as a publisher going
                # silent after SIGKILL
                self._seq += 1
            seq = self._seq
        return {"worker": self.replica_id, "stale": False,
                "healthy": alive, "epoch": self._epoch, "seq": seq,
                "state": {"scheduler": eng.scheduler.as_dict()},
                "prefix_cache": (eng.prefix_cache.stats()
                                 if eng.prefix_cache is not None else None)}

    # ------------------------------------------------------------ serving
    def submit(self, prompt: Sequence[int], max_new_tokens: int = 32,
               **kw):
        return self.engine.submit(list(prompt), max_new_tokens, **kw)

    def pin_prefix(self, prompt: Sequence[int]) -> int:
        return self.engine.pin_prefix(list(prompt))

    def unpin_prefix(self, pin_id: int) -> None:
        self.engine.unpin_prefix(pin_id)

    def cache_stats(self) -> Dict[str, Any]:
        return self.engine.cache_stats()

    # ------------------------------------------------------------ rollout
    def deploy(self, name: str, model, **kw):
        return self.engine.deploy(name, model, **kw)

    def rollback(self, name: str):
        return self.engine.rollback(name)

    def commit_swap(self, name: str) -> None:
        self.engine.commit_swap(name)


class _HTTPStream:
    """One in-flight streaming ``POST /generate``: SSE parse + the
    GenerationRequest-shaped surface the router consumes."""

    def __init__(self, resp, trace_id: Optional[str]):
        self._resp = resp
        self.trace_id = trace_id
        self.tokens: List[int] = []
        self.finish_reason: Optional[str] = None
        self.ttft_ms: Optional[float] = None
        self.replica: Optional[str] = None

    def stream(self, timeout: Optional[float] = None):
        """Yield token ids; raises the mapped replica error from a
        terminal SSE error event, or ``ConnectionError`` when the
        stream dies without one (killed replica)."""
        while True:
            line = self._resp.readline()
            if not line:
                raise ConnectionError(
                    "replica stream ended without terminal event "
                    f"[trace {self.trace_id}]")
            line = line.strip()
            if not line.startswith(b"data: "):
                continue
            ev = json.loads(line[len(b"data: "):].decode())
            if "token" in ev:
                tok = int(ev["token"])
                self.tokens.append(tok)
                yield tok
            elif ev.get("error"):
                self.replica = ev.get("replica")
                raise _map_error(ev.get("type"), ev["error"])
            elif ev.get("done"):
                self.finish_reason = ev.get("finish_reason")
                self.ttft_ms = ev.get("ttft_ms")
                self.replica = ev.get("replica")
                return

    def result(self, timeout: Optional[float] = None) -> List[int]:
        for _ in self.stream(timeout=timeout):
            pass
        return list(self.tokens)

    def cancel(self) -> None:
        # closing the socket surfaces as BrokenPipeError in the replica's
        # SSE writer, which cancels the decode request server-side
        try:
            self._resp.close()
        except Exception:
            pass


class HTTPReplica:
    """A subprocess replica behind its ``InferenceServer`` (class doc)."""

    can_deploy = False   # deploy needs the model object: in-process only

    def __init__(self, replica_id: str, url: str, timeout: float = 60.0):
        self.replica_id = str(replica_id)
        self.url = url.rstrip("/")
        self.timeout = float(timeout)

    def _post(self, path: str, body: Dict[str, Any],
              headers: Optional[Dict[str, str]] = None,
              stream: bool = False):
        req = urllib.request.Request(
            f"{self.url}{path}", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json", **(headers or {})})
        try:
            resp = urllib.request.urlopen(req, timeout=self.timeout)
        except urllib.error.HTTPError as e:
            try:
                payload = json.loads(e.read().decode())
            except Exception:
                payload = {}
            raise _map_error(payload.get("type"),
                             payload.get("error", str(e)),
                             http_status=e.code) from e
        if stream:
            return resp
        with resp:
            return json.loads(resp.read().decode())

    def _get(self, path: str) -> Dict[str, Any]:
        try:
            with urllib.request.urlopen(f"{self.url}{path}",
                                        timeout=self.timeout) as resp:
                return json.loads(resp.read().decode())
        except urllib.error.HTTPError as e:
            try:
                payload = json.loads(e.read().decode())
            except Exception:
                payload = {}
            raise _map_error(payload.get("type"),
                             payload.get("error", str(e)),
                             http_status=e.code) from e

    # ------------------------------------------------------------ serving
    def submit(self, prompt: Sequence[int], max_new_tokens: int = 32, *,
               temperature: float = 0.0, top_k=None, top_p=None,
               seed: int = 0, deadline_s=None, stop_token=None,
               trace_id: Optional[str] = None) -> _HTTPStream:
        body = {"prompt": [int(t) for t in prompt],
                "max_tokens": int(max_new_tokens),
                "temperature": temperature, "seed": seed, "stream": True}
        if top_k is not None:
            body["top_k"] = top_k
        if top_p is not None:
            body["top_p"] = top_p
        if deadline_s is not None:
            body["deadline_s"] = deadline_s
        if stop_token is not None:
            body["stop_token"] = stop_token
        headers = {"X-Request-Id": trace_id} if trace_id else None
        resp = self._post("/generate", body, headers=headers, stream=True)
        return _HTTPStream(resp, trace_id)

    def pin_prefix(self, prompt: Sequence[int]) -> int:
        return int(self._post("/generation/pin",
                              {"prompt": [int(t) for t in prompt]})["pin_id"])

    def unpin_prefix(self, pin_id: int) -> None:
        self._post("/generation/unpin", {"pin_id": int(pin_id)})

    # --------------------------------------------------------------- probes
    def healthz(self) -> bool:
        try:
            return bool(self._get("/healthz").get("dispatcher_alive"))
        except (ServingError, ValueError, ReplicaError, OSError):
            return False

    def health(self) -> Dict[str, Any]:
        # /health answers 503 WITH the verdict body when unhealthy —
        # the caller wants the verdict either way, not an exception
        try:
            with urllib.request.urlopen(f"{self.url}/health",
                                        timeout=self.timeout) as resp:
                return json.loads(resp.read().decode())
        except urllib.error.HTTPError as e:
            return json.loads(e.read().decode())

    def cache_stats(self) -> Dict[str, Any]:
        return self._get("/generation/cache")

    def metrics_text(self) -> str:
        with urllib.request.urlopen(f"{self.url}/metrics",
                                    timeout=self.timeout) as resp:
            return resp.read().decode()
