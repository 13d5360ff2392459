"""Topic-based pub/sub message broker + NDArray publisher/consumer.

Reference: the Kafka plumbing in ``dl4j-streaming`` —
``kafka/NDArrayKafkaClient.java`` (broker handle),
``kafka/NDArrayPublisher.java`` (publish base64 arrays to a topic),
``kafka/NDArrayConsumer.java`` (consume them back).  The TPU framework
replaces the Kafka dependency with a self-contained broker: named topics,
bounded per-subscriber queues, thread-safe, with an optional HTTP
transport so producers/consumers can sit in different processes
(the ``UIServer``-style stdlib HTTP stack — no external deps).

Port: a copy of ``deeplearning4j_tpu/streaming/pubsub.py`` with its imports
rewritten to the port.
"""

from __future__ import annotations

import json
import logging
import queue
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

import numpy as np

from deeplearning4j_tpu_torch.streaming.serde import array_to_base64, base64_to_array

_DROPPED = "dl4j_stream_dropped_total"
_DROP_WARN_INTERVAL_S = 30.0

logger = logging.getLogger("deeplearning4j_tpu_torch.streaming")


class MessageBroker:
    """In-process topic broker; each subscriber gets an independent bounded
    queue (Kafka consumer-group-of-one semantics)."""

    def __init__(self, queue_size: int = 1024, registry=None):
        self._queue_size = queue_size
        self._topics: Dict[str, List[queue.Queue]] = {}
        self._lock = threading.Lock()
        self._registry = registry
        self._last_drop_warn: Dict[str, float] = {}
        self._httpd = None
        self._thread: Optional[threading.Thread] = None

    def subscribe(self, topic: str) -> "queue.Queue[str]":
        q: "queue.Queue[str]" = queue.Queue(maxsize=self._queue_size)
        with self._lock:
            self._topics.setdefault(topic, []).append(q)
        return q

    def unsubscribe(self, topic: str, q: "queue.Queue") -> None:
        with self._lock:
            subs = self._topics.get(topic, [])
            if q in subs:
                subs.remove(q)

    def publish(self, topic: str, message: str) -> int:
        """Deliver to every subscriber.  A full subscriber queue drops its
        OLDEST message (bounded-lag semantics, like a Kafka consumer falling
        behind a retention window) — publish never blocks on a slow or
        abandoned consumer.  Every message discarded this way is counted in
        ``dl4j_stream_dropped_total{topic}`` and surfaced by a rate-limited
        warning naming the topic — silent data loss on a training stream is
        a model-quality bug, not a transport detail."""
        dropped = 0
        with self._lock:
            subs = list(self._topics.get(topic, []))
        for q in subs:
            while True:
                try:
                    q.put_nowait(message)
                    break
                except queue.Full:
                    try:
                        q.get_nowait()
                        dropped += 1
                    except queue.Empty:
                        pass
        if dropped:
            self._count_drops(topic, dropped)
        return len(subs)

    def _count_drops(self, topic: str, n: int) -> None:
        reg = self._registry
        if reg is None:
            from deeplearning4j_tpu_torch.observability import get_registry

            reg = get_registry()
        reg.counter(
            _DROPPED, "Messages discarded because a subscriber queue was "
            "full (oldest-first, bounded-lag semantics) — a consumer "
            "falling behind its topic", labels=("topic",)
        ).inc(n, topic=topic)
        now = time.monotonic()
        with self._lock:
            last = self._last_drop_warn.get(topic)
            warn = last is None or now - last >= _DROP_WARN_INTERVAL_S
            if warn:
                self._last_drop_warn[topic] = now
        if warn:
            logger.warning(
                "topic %r dropped %d message(s): a subscriber queue is full "
                "(queue_size=%d) and the oldest messages were discarded — "
                "see dl4j_stream_dropped_total{topic=%r}",
                topic, n, self._queue_size, topic)

    # ---------------------------------------------------------- HTTP server
    def serve(self, port: int = 0, sub_idle_timeout: float = 300.0) -> int:
        """Expose the broker over HTTP: POST /publish/<topic> (body = message),
        GET /poll/<topic>?sub=<id> long-polls the named subscription.
        Subscriptions idle past `sub_idle_timeout` seconds are dropped so an
        abandoned poller can't accumulate messages forever."""
        import time as _time

        broker = self
        http_subs: Dict[str, list] = {}  # key -> [queue, topic, last_poll]
        lock = threading.Lock()

        def purge():
            now = _time.monotonic()
            with lock:
                for key in [k for k, v in http_subs.items()
                            if now - v[2] > sub_idle_timeout]:
                    q, topic, _ = http_subs.pop(key)
                    broker.unsubscribe(topic, q)

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_POST(self):
                if not self.path.startswith("/publish/"):
                    self.send_error(404)
                    return
                purge()
                topic = self.path[len("/publish/"):]
                n = int(self.headers.get("Content-Length", 0))
                count = broker.publish(topic, self.rfile.read(n).decode())
                body = json.dumps({"delivered": count}).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path, _, query = self.path.partition("?")
                if not path.startswith("/poll/"):
                    self.send_error(404)
                    return
                purge()  # GET-only clients must also trigger idle cleanup
                topic = path[len("/poll/"):]
                params = dict(p.split("=", 1) for p in query.split("&")
                              if "=" in p)
                key = topic + ":" + params.get("sub", "default")
                with lock:
                    if key not in http_subs:
                        http_subs[key] = [broker.subscribe(topic), topic,
                                          _time.monotonic()]
                    http_subs[key][2] = _time.monotonic()
                    q = http_subs[key][0]
                try:
                    msg = q.get(timeout=float(params.get("timeout", 5.0)))
                    self.send_response(200)
                    body = msg.encode()
                except queue.Empty:
                    self.send_response(204)
                    body = b""
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self._httpd.server_address[1]

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            # bounded join: shutdown() above unblocks serve_forever, so
            # this returns promptly — without it a restart could race the
            # old acceptor thread on the (reused) port
            self._thread.join(timeout=5.0)
            self._thread = None


class NDArrayPublisher:
    """Publishes numpy arrays to a topic (local broker or remote HTTP one).
    ≙ ``NDArrayPublisher.java``."""

    def __init__(self, topic: str, broker: Optional[MessageBroker] = None,
                 url: Optional[str] = None, timeout: float = 5.0):
        if (broker is None) == (url is None):
            raise ValueError("exactly one of broker/url required")
        self.topic = topic
        self.broker = broker
        self.url = url.rstrip("/") if url else None
        self.timeout = timeout

    def publish(self, arr: np.ndarray) -> None:
        msg = json.dumps(array_to_base64(np.asarray(arr)))
        if self.broker is not None:
            self.broker.publish(self.topic, msg)
        else:
            req = urllib.request.Request(
                f"{self.url}/publish/{self.topic}", data=msg.encode(),
                headers={"Content-Type": "application/json"})
            urllib.request.urlopen(req, timeout=self.timeout)


class NDArrayConsumer:
    """Consumes numpy arrays from a topic.  ≙ ``NDArrayConsumer.java``."""

    def __init__(self, topic: str, broker: Optional[MessageBroker] = None,
                 url: Optional[str] = None, sub_id: str = "default",
                 timeout: float = 5.0):
        if (broker is None) == (url is None):
            raise ValueError("exactly one of broker/url required")
        self.topic = topic
        self.url = url.rstrip("/") if url else None
        self.sub_id = sub_id
        self.timeout = timeout
        self._queue = broker.subscribe(topic) if broker is not None else None

    def poll(self, timeout: Optional[float] = None) -> Optional[np.ndarray]:
        timeout = self.timeout if timeout is None else timeout
        if self._queue is not None:
            try:
                msg = self._queue.get(timeout=timeout)
            except queue.Empty:
                return None
        else:
            req = (f"{self.url}/poll/{self.topic}?sub={self.sub_id}"
                   f"&timeout={timeout}")
            with urllib.request.urlopen(req, timeout=timeout + 5) as resp:
                if resp.status == 204:
                    return None
                msg = resp.read().decode()
        return base64_to_array(json.loads(msg))
