"""Hardened stream consumer: validation, quarantine, transport retry.

The trusting path (``NDArrayConsumer.poll`` -> ``fit``) has three silent
failure modes this class closes:

- **poisoned records** — a NaN/Inf payload, a bit-flipped base64 string,
  or a shape-lying envelope would corrupt a whole training window.  Every
  message is decoded through ``serde.consume_dataset_json`` (strict
  validation); anything raising ``BadRecordError`` is published to a
  quarantine (dead-letter) topic with its reason and counted in
  ``dl4j_stream_quarantined_total{topic,reason}`` — the window never sees
  it, and the original payload is preserved verbatim for the runbook
  (docs/online.md) to replay after a fix;
- **transport outages** — the HTTP transport raises connection errors
  while the broker endpoint is dead or restarting; polls ride the
  ``RetryPolicy`` (exponential backoff, seeded jitter), and because the
  broker keys HTTP subscriptions by ``sub=<id>``, a consumer that backed
  off through a restart resumes the SAME subscription — no duplicated,
  no silently skipped messages for anything published after the broker
  came back;
- **invisible lag** — ``delivered`` / ``quarantined`` counters expose the
  consumer's position, and the broker side counts its own overflow drops
  (``dl4j_stream_dropped_total{topic}``).

Port: a copy of ``deeplearning4j_tpu/online/consumer.py`` with its
imports rewritten; records decode to numpy ``DataSet``s.
"""

from __future__ import annotations

import json
import logging
import queue
import time
import urllib.error
import urllib.request
from collections import deque
from typing import Any, Dict, Optional, Tuple

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.resilience.retry import RetryPolicy, TransientError
from deeplearning4j_tpu_torch.streaming.pubsub import MessageBroker
from deeplearning4j_tpu_torch.streaming.serde import (
    BadRecordError, consume_dataset_json,
)

_QUARANTINED = "dl4j_stream_quarantined_total"
_QUARANTINE_WARN_INTERVAL_S = 30.0

logger = logging.getLogger("deeplearning4j_tpu_torch.online")


class StreamConsumer:
    """Validated, quarantining, retrying consumer of DataSet messages
    (module docstring).  Exactly one of ``broker`` (in-process) or
    ``url`` (HTTP transport) is required, mirroring ``NDArrayConsumer``.
    """

    def __init__(self, topic: str, broker: Optional[MessageBroker] = None,
                 url: Optional[str] = None, sub_id: str = "online",
                 quarantine_topic: Optional[str] = None,
                 retry_policy: Optional[RetryPolicy] = None,
                 dead_letter_capacity: int = 256,
                 registry=None, timeout: float = 5.0):
        if (broker is None) == (url is None):
            raise ValueError("exactly one of broker/url required")
        self.topic = topic
        self.broker = broker
        self.url = url.rstrip("/") if url else None
        self.sub_id = sub_id
        self.timeout = float(timeout)
        self.quarantine_topic = quarantine_topic or f"{topic}.quarantine"
        self.retry = retry_policy
        self._registry = registry
        self._queue = broker.subscribe(topic) if broker is not None else None
        self._last_quarantine_warn: Optional[float] = None
        self.delivered = 0          # valid DataSets handed to the caller
        self.quarantined = 0
        # the broker is fire-and-forget (no retention): a dead letter
        # published before anyone subscribed the quarantine topic would
        # be lost — so the consumer ALSO retains the newest envelopes
        # locally, where the runbook can always find them
        self.dead_letters: "deque[Dict[str, Any]]" = deque(
            maxlen=int(dead_letter_capacity))

    def _reg(self):
        if self._registry is not None:
            return self._registry
        from deeplearning4j_tpu_torch.observability import get_registry

        return get_registry()

    # ------------------------------------------------------------ transport
    def _poll_once(self, timeout: float) -> Optional[str]:
        """One raw poll: the message text, or None when the topic stayed
        quiet.  HTTP connection failures surface as ``TransientError`` so
        the retry policy classifies them without string matching."""
        if self._queue is not None:
            try:
                return self._queue.get(timeout=timeout)
            except queue.Empty:
                return None
        req = (f"{self.url}/poll/{self.topic}?sub={self.sub_id}"
               f"&timeout={timeout}")
        try:
            with urllib.request.urlopen(req, timeout=timeout + 5) as resp:
                if resp.status == 204:
                    return None
                return resp.read().decode()
        except (urllib.error.URLError, ConnectionError, TimeoutError,
                OSError) as e:
            raise TransientError(
                f"broker poll on {self.url!r} failed: {e}") from e

    def poll_raw(self, timeout: Optional[float] = None) -> Optional[str]:
        """Raw message text with transport retries (dead broker endpoint
        -> exponential backoff until it answers again or the budget is
        exhausted)."""
        timeout = self.timeout if timeout is None else timeout
        if self.retry is None:
            return self._poll_once(timeout)
        return self.retry.run(lambda: self._poll_once(timeout),
                              description=f"poll {self.topic}")

    # ------------------------------------------------------------- datasets
    def poll_dataset(self, timeout: Optional[float] = None
                     ) -> Optional[Tuple[DataSet, Dict[str, Any]]]:
        """The validated consume: ``(DataSet, meta)`` for the next GOOD
        record, or None when the topic stays quiet for ``timeout``.  Bad
        records are quarantined and skipped WITHOUT consuming the time
        budget's patience — the poll keeps going until the deadline."""
        timeout = self.timeout if timeout is None else timeout
        deadline = time.monotonic() + timeout
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return None
            raw = self.poll_raw(timeout=remaining)
            if raw is None:
                return None
            try:
                ds, meta = consume_dataset_json(raw)
            except BadRecordError as e:
                self.quarantine(raw, e)
                continue
            except Exception as e:
                # defense in depth: ANY record-shaped failure quarantines —
                # one poisoned message must never kill the consumer loop
                self.quarantine(raw, BadRecordError(
                    f"undecodable record: {e!r}", reason="bad_envelope"))
                continue
            self.delivered += 1
            return ds, meta

    # ----------------------------------------------------------- quarantine
    def quarantine(self, raw: str, err: BadRecordError) -> None:
        """Dead-letter one bad record: preserve the payload verbatim on
        the quarantine topic (wrapped with its reason + timestamp), count
        it, flight-record it, and warn (rate-limited)."""
        self.quarantined += 1
        reason = getattr(err, "reason", "invalid")
        record = {
            "reason": reason, "error": str(err)[:300],
            "topic": self.topic, "quarantined_at": time.time(),
            "payload": raw,
        }
        self.dead_letters.append(record)
        envelope = json.dumps(record)
        try:
            if self.broker is not None:
                self.broker.publish(self.quarantine_topic, envelope)
            else:
                req = urllib.request.Request(
                    f"{self.url}/publish/{self.quarantine_topic}",
                    data=envelope.encode(),
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=self.timeout):
                    pass    # drain + close; a leaked fd per dead letter
                    # would turn a poisoned-record flood into EMFILE
        except Exception:
            # the dead-letter write is best-effort: a broker outage here
            # must not turn ONE bad record into a dead consumer — the
            # counter and flight event still record the loss
            logger.debug("quarantine publish failed", exc_info=True)
        self._reg().counter(
            _QUARANTINED, "Stream records rejected by consume-side "
            "validation and published to the quarantine (dead-letter) "
            "topic instead of reaching fit, by topic and reason",
            labels=("topic", "reason")).inc(topic=self.topic, reason=reason)
        from deeplearning4j_tpu_torch.observability import get_flight_recorder

        get_flight_recorder().record(
            "stream_quarantined", topic=self.topic, reason=reason,
            error=str(err)[:200])
        now = time.monotonic()
        if (self._last_quarantine_warn is None
                or now - self._last_quarantine_warn
                >= _QUARANTINE_WARN_INTERVAL_S):
            self._last_quarantine_warn = now
            logger.warning(
                "quarantined a bad record from %r (%s: %s) -> %r "
                "[%d quarantined so far]", self.topic, reason, err,
                self.quarantine_topic, self.quarantined)
