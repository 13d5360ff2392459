"""Model serving and streaming pipelines — counterpart of
``deeplearning4j_tpu/streaming/serving.py``: the HTTP ``InferenceServer``
and the broker-based ``StreamingPipeline`` and ``ServingPipeline``, in
front of the port's engines.

``/predict`` and ``ServingPipeline`` go through the port's
``serving.ServingEngine`` (bucketed dynamic batching; on the card each
bucket a captured ``output`` graph), ``/generate`` through the port's
``generation.GenerationEngine`` (continuous batching over captured
decode and prefill graphs).  The server touches no device tensor
itself: a handler thread (``ThreadingHTTPServer``, one a connection)
only parses, enqueues and waits, and a ``/generate`` SSE event carries a
token the engine already read to the host.  ``POST /models/<name>``
loads a ``models/serialization.py`` zip onto the server's ``device``
(the card unless it was built with ``device="cpu"``) and swaps it in
through ``ServingEngine.deploy``: the incoming version's buckets are
captured on the handler thread under ``backend.device.capture_lock``
while the dispatcher keeps replaying the old version.  A body with
``"retain_old": true`` keeps the displaced version for
``POST /models/<name>/rollback``, which flips back without capturing.
Endpoints, status codes, trace ids and access-log lines are the
reference's.
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.observability.health import (
    HealthEvaluator, HealthRule, default_serving_rules,
)
from deeplearning4j_tpu_torch.observability.tracing import new_trace_id
from deeplearning4j_tpu_torch.serving import (
    ServingEngine, ServingError, ShuttingDownError,
)

logger = logging.getLogger("deeplearning4j_tpu_torch.streaming")
access_logger = logging.getLogger("deeplearning4j_tpu_torch.serving.access")
from deeplearning4j_tpu_torch.streaming.pubsub import MessageBroker
from deeplearning4j_tpu_torch.streaming.serde import (
    array_to_base64, base64_to_array, record_to_dataset,
)


class InferenceServer:
    """HTTP front-end over a ``ServingEngine``.

    Endpoints:

    - ``POST /predict`` — NDArray envelope or plain JSON list body; the
      request joins the engine's bucketed micro-batches.  Malformed
      bodies get a structured 400; shed requests 429; shutdown 503;
      deadline expiry 504; model errors 400.
    - ``GET /healthz`` — LIVENESS: cheap dispatcher-thread check, 503
      only when it is dead (a busy-but-working instance must not get
      restarted; no SLO rules evaluated on this path).
    - ``GET /health`` — READINESS/alerting: the full SLO verdict, every
      rule with its observed value, limit, and pass/fail; 503 when any
      rule fails.  Rules default to dispatcher liveness + queue-depth +
      recompile budget; pass ``health_rules=`` for custom SLOs
      (``observability.health.HealthRule``).
    - ``GET /metrics`` — Prometheus scrape of the metrics registry.
    - ``GET /models`` — engine/model-registry state (versions, queue).
    - ``GET /generation/cache`` (when a ``generation=`` engine is
      wired) — paged-pool occupancy plus the persistent prefix cache's
      stats: hit rate, resident/pinned pages, host-tier bytes,
      offload/restore/eviction counters (``null`` under the legacy
      free-on-release policy); 404 without a generation engine.
    - ``POST /models/<name>`` — hot-swap: body ``{"path": <checkpoint>}``
      loads a ``models/serialization.py`` zip, warms every bucket shape,
      and atomically swaps it in with zero dropped requests;
      ``"retain_old": true`` keeps the old version for ``POST
      /models/<name>/rollback``.
    - ``POST /generate`` (when a ``generation=`` engine is wired) —
      continuous-batching autoregressive decode: body ``{"prompt":
      [ids], "max_tokens": n, "temperature": t, "top_k": k, "top_p": p,
      "seed": s, "stop_token": id, "stream": bool}``.  Without
      ``stream`` the full completion returns as ``{"tokens": [...],
      "finish_reason": ..., "ttft_ms": ..., "trace_id": ...}``; with
      ``stream: true`` the response is Server-Sent Events — one ``data:
      {"token": id, "index": i}`` event per generated token as the
      running decode batch produces it, closed by ``data: {"done":
      true, ...}`` (an error mid-stream becomes a final ``data:
      {"error": ...}`` event: the status line already went out).  Shed/
      deadline mapping (429/503/504), ``X-Request-Id`` trace ids, and
      the access log behave exactly as on ``/predict``.

    Request tracing: every ``/predict`` request gets a ``trace_id`` —
    taken from an ``X-Request-Id`` header when the client sent one,
    minted otherwise — that is propagated through the engine (queue and
    execute spans, shed errors, latency exemplars) and echoed in EVERY
    JSON response body, success or error (429/503/504 included), so a
    client-side timeout can be joined against the server-side spans.
    With ``access_log=True`` one structured JSON line per completed
    request (trace_id, status, bucket, queue_wait_ms, execute_ms) is
    emitted on the ``deeplearning4j_tpu_torch.serving.access`` logger.

    The constructor builds an engine from ``model=``; ``engine=``
    supplies a custom (possibly shared, multi-model) engine instead.
    """

    def __init__(self, model=None, max_batch: int = 32,
                 max_wait_ms: float = 2.0, port: int = 0, registry=None,
                 max_queue: int = 256, deadline_s: float = 30.0,
                 example: Optional[np.ndarray] = None,
                 engine: Optional[ServingEngine] = None,
                 health_rules=None, access_log: bool = False,
                 generation=None, replica_id: Optional[str] = None,
                 device=None):
        if engine is None:
            if model is None:
                raise ValueError("InferenceServer needs a model or an engine")
            engine = ServingEngine(
                model, max_batch=max_batch, max_wait_ms=max_wait_ms,
                max_queue=max_queue, deadline_s=deadline_s,
                registry=registry, example=example)
            self._owns_engine = True
        else:
            if model is not None:
                # the engine serves ITS registered models; silently never
                # serving the passed one would be a trap
                raise ValueError(
                    "pass either model= (server builds its own engine) or "
                    "engine= (serve that engine's models), not both — "
                    "register extra models via engine.deploy()")
            self._owns_engine = False
        self.engine = engine
        # optional generation.GenerationEngine behind POST /generate; its
        # lifecycle (start/stop, deploys) belongs to its owner — the
        # server only routes, exactly like a shared predict engine
        self.generation = generation
        # fleet identity: when set (subprocess replicas behind the fleet
        # router), every /generate envelope, SSE terminal event, and
        # access-log line names the replica that served it — the "which
        # replica did this come from" half of the routing trace
        self.replica_id = replica_id
        self.model = model
        # where POST /models/<name> restores a checkpoint (None: the card)
        self.device = device
        self.max_batch = engine.policy.max_batch
        self.max_wait_ms = engine.batcher.max_wait_s * 1000.0
        self.registry = engine.metrics.registry
        # SLO-driven health: the binary healthz is now a summary of this
        # evaluator's verdict.  The dispatcher-liveness predicate needs
        # the engine object, so it is appended here rather than in
        # default_serving_rules.
        rules = list(health_rules) if health_rules is not None else (
            default_serving_rules(
                max_queue_depth=max(1.0, 0.9 * engine.admission.max_queue)))
        rules.append(HealthRule(
            "dispatcher_alive", "predicate",
            fn=lambda eng: (eng.batcher.is_alive(),
                            eng.batcher.is_alive(),
                            "micro-batch dispatcher thread liveness")))
        self.health = HealthEvaluator(rules, component="serving",
                                      registry=self.registry)
        self.access_log = bool(access_log)
        self._requested_port = port
        self._httpd: Optional[ThreadingHTTPServer] = None

    def predict(self, features: np.ndarray, model: Optional[str] = None,
                deadline_s: Optional[float] = None,
                trace_id: Optional[str] = None) -> np.ndarray:
        """Thread-safe enqueue + bounded wait (usable in-process without
        HTTP).  Raises typed ``ServingError`` subclasses on shed/timeout
        instead of ever hanging the caller."""
        return self.engine.predict(features, model=model,
                                   deadline_s=deadline_s, trace_id=trace_id)

    def _access_line(self, trace_id: str, status: str, http_status: int,
                     model: Optional[str]) -> None:
        """One structured JSON log line per completed /predict request
        (behind ``access_log=``): trace id, outcome, and the per-stage
        breakdown read back from the span tracer."""
        if not self.access_log:
            return
        try:
            br = self.engine.request_breakdown(trace_id)
            access_logger.info(json.dumps({
                "trace_id": trace_id,
                "model": model or self.engine.default_model,
                "status": status,
                "http_status": http_status,
                "bucket": br["bucket"],
                "queue_wait_ms": br["queue_wait_ms"],
                "execute_ms": br["execute_ms"],
                "total_ms": br["total_ms"],
            }))
        except Exception:   # an access-log failure must never 500 a reply
            logger.debug("access-log line failed", exc_info=True)

    def _gen_access_line(self, trace_id: str, status: str, http_status: int,
                         req=None) -> None:
        """The /generate analog of ``_access_line``: same logger, same
        trace-id key, generation-shaped fields (token count, TTFT,
        inter-token p50, SLO verdict — the per-request SLO evidence
        that survives outside the metrics window)."""
        if not self.access_log:
            return
        try:
            access_logger.info(json.dumps({
                "trace_id": trace_id,
                "endpoint": "generate",
                "replica": self.replica_id,
                "status": status,
                "http_status": http_status,
                "tokens": len(req.tokens) if req is not None else None,
                "ttft_ms": (round(req.ttft_s * 1e3, 3)
                            if req is not None and req.ttft_s is not None
                            else None),
                "itl_p50_ms": (req.itl_p50_ms()
                               if req is not None else None),
                "slo_ok": (getattr(req, "slo_ok", None)
                           if req is not None else None),
                "finish_reason": (req.finish_reason
                                  if req is not None else None),
            }))
        except Exception:
            logger.debug("access-log line failed", exc_info=True)

    # ------------------------------------------------------------- lifecycle
    def start(self, warmup: bool = True) -> int:
        server = self

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

            def _read_json(self):
                """Parse the request body; raises _BadRequest (-> 400)
                instead of letting a traceback escape as a 500."""
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    return json.loads(self.rfile.read(n).decode())
                except (ValueError, UnicodeDecodeError) as e:
                    raise _BadRequest(f"malformed JSON body: {e}")

            def do_GET(self):
                if self.path == "/healthz":
                    # LIVENESS probe: cheap and binary — fails only on a
                    # dead dispatcher (an instance at its queue budget is
                    # busy, not dead, and restarting busy instances under
                    # load cascades).  Load balancers hit this every few
                    # seconds, so no rule evaluation happens here; the
                    # SLO verdict lives on /health.
                    alive = server.engine.batcher.is_alive()
                    self._json({
                        "status": "ok" if alive else "unavailable",
                        "dispatcher_alive": alive,
                    }, code=200 if alive else 503)
                elif self.path == "/health":
                    # the detailed verdict: every rule with observed vs
                    # limit — the "which SLO is violated" answer
                    verdict = server.health.evaluate(extra=server.engine)
                    self._json(verdict.to_dict(),
                               code=200 if verdict.healthy else 503)
                elif self.path == "/metrics":
                    body = server.registry.to_prometheus().encode()
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "text/plain; version=0.0.4; charset=utf-8")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path == "/models":
                    self._json(server.engine.stats())
                elif self.path == "/generation/cache":
                    # paged-pool occupancy + persistent prefix-cache
                    # stats (hit rate, resident/pinned pages, host tier)
                    if server.generation is None:
                        self._json({"error": "this server has no "
                                    "generation engine", "type":
                                    "ModelNotFoundError"}, code=404)
                    else:
                        self._json(server.generation.cache_stats())
                else:
                    self.send_error(404)

            def do_POST(self):
                self._trace_id = None
                try:
                    if self.path == "/predict":
                        self._predict()
                    elif self.path == "/generate":
                        self._generate()
                    elif self.path in ("/generation/pin",
                                       "/generation/unpin"):
                        self._pin(self.path.endswith("/unpin"))
                    elif (self.path.startswith("/models/")
                          and self.path.endswith("/rollback")):
                        self._rollback(
                            self.path[len("/models/"):-len("/rollback")])
                    elif self.path.startswith("/models/"):
                        self._swap(self.path[len("/models/"):])
                    else:
                        self.send_error(404)
                except _BadRequest as e:
                    self._error_json(str(e), type(e).__name__, 400)
                except ServingError as e:
                    self._error_json(str(e), type(e).__name__,
                                     e.http_status,
                                     trace_id=getattr(e, "trace_id", None))
                except Exception as e:  # never drop the socket without a
                    self._error_json(str(e),  # structured response
                                     type(e).__name__, 500)

            def _error_json(self, msg, etype, code, trace_id=None):
                tid = trace_id or self._trace_id
                body = {"error": msg, "type": etype}
                if tid is not None:
                    body["trace_id"] = tid
                    # log BEFORE the response flushes: the client must
                    # never observe a completed request whose access-log
                    # line has not been emitted yet
                    if self.path == "/generate":
                        server._gen_access_line(tid, etype, code, None)
                    else:
                        server._access_line(tid, etype, code, None)
                self._json(body, code=code)

            def _predict(self):
                # trace id from the client when it sent one, minted at
                # the HTTP edge otherwise — the same id rides the engine
                # stages and comes back in the response body
                tid = self.headers.get("X-Request-Id") or new_trace_id()
                self._trace_id = tid
                obj = self._read_json()
                try:
                    if isinstance(obj, dict) and "data" in obj:
                        # validate=True: an undecodable, shape-lying, or
                        # NaN/Inf envelope is a structured 400 here — it
                        # must never reach a forward pass it would share
                        # a micro-batch with other clients' rows in
                        feats = base64_to_array(obj, validate=True)
                    else:
                        feats = np.asarray(obj, np.float32)
                        if not np.isfinite(feats).all():
                            raise _BadRequest(
                                "request payload contains NaN/Inf values")
                except (ValueError, KeyError, TypeError) as e:
                    raise _BadRequest(f"bad request envelope: {e}")
                try:
                    out = server.predict(feats, trace_id=tid)
                except ServingError:
                    raise
                except Exception as e:  # model errors surface as 400s
                    server._access_line(tid, type(e).__name__, 400, None)
                    self._json({"error": str(e), "trace_id": tid}, code=400)
                    return
                # log BEFORE the response flushes (see _error_json)
                server._access_line(tid, "ok", 200, None)
                self._json({**array_to_base64(out), "trace_id": tid})

            def _generate(self):
                """POST /generate — continuous-batching decode.  The
                request joins the RUNNING decode batch at the next step
                boundary; shed/deadline semantics mirror /predict."""
                gen = server.generation
                if gen is None:
                    raise _BadRequest(
                        "this server has no generation engine (pass "
                        "generation= to InferenceServer)")
                tid = self.headers.get("X-Request-Id") or new_trace_id()
                self._trace_id = tid
                obj = self._read_json()
                if not isinstance(obj, dict) or "prompt" not in obj:
                    raise _BadRequest(
                        'generate body must be {"prompt": [token ids], ...}')
                stream = bool(obj.get("stream", False))
                try:
                    prompt = [int(t) for t in obj["prompt"]]
                    req = gen.submit(
                        prompt,
                        max_new_tokens=int(obj.get("max_tokens", 32)),
                        temperature=float(obj.get("temperature", 0.0)),
                        top_k=obj.get("top_k"),
                        top_p=obj.get("top_p"),
                        seed=int(obj.get("seed", 0)),
                        deadline_s=obj.get("deadline_s"),
                        stop_token=obj.get("stop_token"),
                        trace_id=tid)
                except ServingError:
                    raise          # 429/503 mapping via do_POST
                except (TypeError, ValueError) as e:
                    raise _BadRequest(f"bad generate request: {e}")
                if stream:
                    self._stream_tokens(gen, req, tid)
                    return
                try:
                    tokens = req.result()
                except ServingError:
                    raise          # 504 deadline / 503 shutdown mapping
                except Exception as e:   # model/decode failure -> 400
                    server._gen_access_line(tid, type(e).__name__, 400, req)
                    self._json({"error": str(e), "trace_id": tid}, code=400)
                    return
                server._gen_access_line(tid, "ok", 200, req)
                self._json({"tokens": tokens,
                            "finish_reason": req.finish_reason,
                            "ttft_ms": (round(req.ttft_s * 1e3, 3)
                                        if req.ttft_s is not None else None),
                            "trace_id": tid,
                            "replica": server.replica_id})

            def _pin(self, unpin):
                """POST /generation/pin {"prompt": [ids]} -> {"pin_id"}
                and /generation/unpin {"pin_id"} — the HTTP face of
                ``pin_prefix``/``unpin_prefix``, so the fleet router can
                pin sticky sessions on subprocess replicas."""
                gen = server.generation
                if gen is None or getattr(gen, "prefix_cache", None) is None:
                    raise _BadRequest(
                        "this server has no prefix-cache-enabled "
                        "generation engine")
                obj = self._read_json()
                if unpin:
                    if not isinstance(obj, dict) or "pin_id" not in obj:
                        raise _BadRequest('unpin body must be {"pin_id": n}')
                    try:
                        gen.unpin_prefix(int(obj["pin_id"]))
                    except KeyError as e:
                        raise _BadRequest(f"unknown pin: {e}")
                    self._json({"ok": True,
                                "replica": server.replica_id})
                    return
                if not isinstance(obj, dict) or "prompt" not in obj:
                    raise _BadRequest(
                        'pin body must be {"prompt": [token ids]}')
                try:
                    pin_id = gen.pin_prefix([int(t) for t in obj["prompt"]])
                except (TypeError, ValueError) as e:
                    raise _BadRequest(f"bad pin request: {e}")
                self._json({"pin_id": pin_id,
                            "replica": server.replica_id})

            def _stream_tokens(self, gen, req, tid):
                """Server-Sent Events: one event per token as the decode
                batch produces it.  The 200 goes out before the first
                token, so a later failure is delivered as a terminal
                ``data: {"error": ...}`` event instead of a status."""
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
                    for i, tok in enumerate(req.stream()):
                        event({"token": tok, "index": i, "trace_id": tid})
                    event({"done": True, "tokens": len(req.tokens),
                           "finish_reason": req.finish_reason,
                           "ttft_ms": (round(req.ttft_s * 1e3, 3)
                                       if req.ttft_s is not None else None),
                           "trace_id": tid,
                           "replica": server.replica_id})
                except ServingError as e:
                    status, code = type(e).__name__, e.http_status
                    event({"error": str(e), "type": status,
                           "trace_id": tid, "done": True,
                           "replica": server.replica_id})
                except BrokenPipeError:
                    # client went away: stop wasting decode slots on it
                    req.cancel()
                    status, code = "client_disconnected", 499
                except Exception as e:
                    status, code = type(e).__name__, 500
                    try:
                        event({"error": str(e), "type": status,
                               "trace_id": tid, "done": True})
                    except Exception:
                        pass
                server._gen_access_line(tid, status, code, req)

            def _swap(self, name):
                obj = self._read_json()
                if not isinstance(obj, dict) or "path" not in obj:
                    raise _BadRequest(
                        'hot-swap body must be {"path": <checkpoint>}')
                try:
                    mv = server.engine.deploy(
                        name, obj["path"],
                        retain_old=bool(obj.get("retain_old", False)),
                        device=server.device)
                except Exception as e:
                    # unloadable file, bad zip, or a checkpoint whose
                    # model fails its warmup forward (any exception type)
                    # — the swap aborted and the fault is the artifact's,
                    # so classify as a client error, not a server fault
                    raise _BadRequest(f"cannot deploy checkpoint: {e}")
                self._json({"model": mv.name, "version": mv.version,
                            "state": mv.state})

            def _rollback(self, name):
                """POST /models/<name>/rollback — flip back to the version
                retained by the last retaining hot-swap (the operator's
                manual undo; the online pipeline's watch window calls the
                same engine path automatically)."""
                from deeplearning4j_tpu_torch.serving import ModelNotFoundError

                try:
                    mv = server.engine.rollback(name)
                except ModelNotFoundError as e:
                    raise _BadRequest(str(e))
                self._json({"model": mv.name, "version": mv.version,
                            "state": mv.state})

        if self._owns_engine:
            self.engine.start(warmup=warmup)
        self._httpd = ThreadingHTTPServer(("127.0.0.1", self._requested_port),
                                          Handler)
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self._httpd.server_address[1]

    def stop(self, drain: bool = True):
        if self._owns_engine:
            self.engine.stop(drain=drain)
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if getattr(self, "_thread", None) is not None:
            # shutdown() unblocked serve_forever — bounded join so a
            # stop/start cycle never races the old acceptor thread
            self._thread.join(timeout=5.0)
            self._thread = None


class _BadRequest(ValueError):
    """Client error in the HTTP body; rendered as a structured 400."""


class StreamingPipeline:
    """Consume records from a broker topic, convert to DataSets, train.

    ≙ ``SparkStreamingPipeline.java``: Kafka -> DataVec conversion ->
    fit on each micro-batch.  Records are JSON lists on `topic`; every
    `batch_size` records become one minibatch."""

    def __init__(self, model, broker: MessageBroker, topic: str,
                 label_index: int, num_classes: Optional[int] = None,
                 regression: bool = False, batch_size: int = 32):
        self.model = model
        self.topic = topic
        self.label_index = label_index
        self.num_classes = num_classes
        self.regression = regression
        self.batch_size = batch_size
        self._queue = broker.subscribe(topic)
        self._stop = threading.Event()
        self.batches_trained = 0

    def _drain_batch(self, timeout: float):
        examples = []
        while len(examples) < self.batch_size and not self._stop.is_set():
            try:
                msg = self._queue.get(timeout=timeout)
            except Exception:
                break
            examples.append(record_to_dataset(
                json.loads(msg), self.label_index, self.num_classes,
                self.regression))
        return examples

    def run(self, max_batches: Optional[int] = None, timeout: float = 1.0):
        """Blocking consume-train loop; returns after `max_batches` or when
        the topic stays quiet past `timeout`."""
        while not self._stop.is_set():
            examples = self._drain_batch(timeout)
            if not examples:
                return
            ds = DataSet.merge(examples)
            if len(ds) < self.batch_size:
                ds = ds.pad_batch(self.batch_size)
            self.model.fit(ds.features, ds.labels, lmask=ds.labels_mask)
            self.batches_trained += 1
            if max_batches and self.batches_trained >= max_batches:
                return

    def stop(self):
        self._stop.set()


class ServingPipeline:
    """Consume feature records from `in_topic`, predict, publish predictions
    to `out_topic`.  ≙ ``DL4jServeRouteBuilder.java`` (predictions published
    back to a Kafka topic) — but predictions route through a
    ``ServingEngine``, so concurrent pipelines (or a pipeline plus the HTTP
    server) sharing one engine micro-batch into bucketed forward passes
    instead of paying a per-message ``model.output`` call."""

    def __init__(self, model=None, broker: MessageBroker = None,
                 in_topic: str = "features", out_topic: str = "predictions",
                 transform: Optional[Callable] = None,
                 engine: Optional[ServingEngine] = None,
                 model_name: Optional[str] = None, max_batch: int = 32):
        if broker is None:
            raise ValueError("ServingPipeline needs a broker")
        if engine is None:
            if model is None:
                raise ValueError("ServingPipeline needs a model or an engine")
            engine = ServingEngine(model, max_batch=max_batch)
            self._owns_engine = True
        else:
            self._owns_engine = False
        self.engine = engine
        self.model = model
        self.model_name = model_name
        self.broker = broker
        self.in_topic = in_topic
        self.out_topic = out_topic
        self.transform = transform
        self._queue = broker.subscribe(in_topic)
        self._stop = threading.Event()
        self._engine_started = False
        self._running = False

    def run(self, max_messages: Optional[int] = None, timeout: float = 1.0):
        """Blocking consume-predict-publish loop.  An OWNED engine (no
        ``engine=`` passed) lives only while ``run()`` executes — it is
        started on entry and stopped on exit, so a dropped pipeline never
        leaks the dispatch thread or pins the model; re-warming on a
        later ``run()`` re-warms from the capture cache in milliseconds.  A
        SHARED engine's lifecycle belongs to its owner and is never
        touched."""
        if self._owns_engine and not self._engine_started:
            self.engine.start()
            self._engine_started = True
        served = 0
        self._running = True
        try:
            while not self._stop.is_set():
                try:
                    msg = self._queue.get(timeout=timeout)
                except Exception:
                    return
                feats = np.asarray(json.loads(msg), np.float32)
                if feats.ndim == 1:
                    feats = feats[None, :]
                if self.transform is not None:
                    feats = self.transform(feats)
                try:
                    out = self.engine.predict(feats, model=self.model_name)
                except ShuttingDownError:
                    return
                except ServingError as e:
                    # transient shed on a SHARED engine (queue burst,
                    # deadline) must not kill the consumer loop
                    logger.warning("dropping message from %r: %s",
                                   self.in_topic, e)
                    continue
                self.broker.publish(self.out_topic,
                                    json.dumps(array_to_base64(out)))
                served += 1
                if max_messages and served >= max_messages:
                    return
        finally:
            self._running = False
            if self._owns_engine:
                self._shutdown_engine()

    def _shutdown_engine(self):
        if self._engine_started:
            self.engine.stop()
            self._engine_started = False

    def stop(self):
        """Stop consuming; also covers the belt-and-braces case of an
        owned engine started but never run."""
        self._stop.set()
        if self._owns_engine and not self._running:
            self._shutdown_engine()
