"""Admission control: bounded queue, per-request deadlines, load shedding.

Copied from ``deeplearning4j_tpu/serving/admission.py`` (framework-free).

Under overload an unbounded serving queue converts excess traffic into
unbounded latency — every queued request eventually times out client-side
but still costs a forward pass.  The production-correct behaviour is to
REJECT at the door (HTTP 429) the moment the queue exceeds its budget,
fail queued requests whose deadline has already passed without running
them, and fail fast (503) during shutdown so no waiter ever hangs on a
dead dispatcher.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np


class ServingError(RuntimeError):
    """Base class for admission/serving rejections; carries the HTTP
    status the front-end should answer with, and — when raised for a
    specific request — that request's ``trace_id`` so a shed/deadline
    error names the request it killed."""

    http_status = 500
    shed_reason: Optional[str] = None
    trace_id: Optional[str] = None


class QueueFullError(ServingError):
    """Request shed because the pending queue exceeded its budget."""

    http_status = 429
    shed_reason = "queue_full"


class ShuttingDownError(ServingError):
    """Request shed (or failed while queued) because the engine is
    stopping/stopped."""

    http_status = 503
    shed_reason = "shutdown"


class DeadlineExceededError(ServingError):
    """Request failed its deadline — either expired while queued (the
    batcher drops it without running the model) or the waiter timed out
    (e.g. the dispatcher died)."""

    http_status = 504
    shed_reason = "deadline"


class ModelNotFoundError(ServingError):
    """No such model registered (or no active version)."""

    http_status = 404


class Request:
    """One enqueued predict: features plus everything needed to batch,
    deadline-check, and deliver it."""

    __slots__ = ("features", "rows", "model", "enqueued", "enqueued_ns",
                 "deadline", "done", "result", "cancelled", "orig_seq",
                 "trace_id", "queue_wait_ns", "execute_ns", "batch_rows")

    def __init__(self, features: np.ndarray, model: str,
                 deadline_s: float, orig_seq: Optional[int] = None,
                 trace_id: Optional[str] = None):
        self.features = features
        self.rows = len(features)
        self.model = model
        self.enqueued = time.monotonic()
        self.enqueued_ns = time.perf_counter_ns()  # span clock (tracing)
        self.deadline = self.enqueued + deadline_s
        self.done = threading.Event()
        self.result: list = []          # [np.ndarray] or [Exception]
        self.cancelled = False          # waiter gave up; skip, drop output
        self.orig_seq = orig_seq        # pre-seq-bucket length, for slicing
        self.trace_id = trace_id        # end-to-end request trace id
        # stage timings stamped by the batcher at dispatch (the O(1)
        # source request_breakdown/access-log read — the span ring is a
        # bounded diagnostic buffer, not the primary record)
        self.queue_wait_ns: Optional[int] = None
        self.execute_ns: Optional[int] = None
        self.batch_rows: Optional[int] = None

    def deliver(self, value) -> None:
        self.result.append(value)
        self.done.set()

    def expired(self, now: Optional[float] = None) -> bool:
        return (now if now is not None else time.monotonic()) > self.deadline


class AdmissionController:
    """Queue-budget + deadline policy (the batcher consults it under its
    own lock, so the controller itself is just arithmetic + metrics)."""

    def __init__(self, max_queue: int = 256, default_deadline_s: float = 30.0,
                 metrics=None):
        if max_queue < 1:
            raise ValueError(f"max_queue={max_queue} must be >= 1")
        if default_deadline_s <= 0:
            raise ValueError(
                f"default_deadline_s={default_deadline_s} must be > 0")
        self.max_queue = int(max_queue)
        self.default_deadline_s = float(default_deadline_s)
        self._metrics = metrics

    def shed(self, exc_type, detail: str = "",
             trace_id: Optional[str] = None):
        """Record the shed in the metrics registry and build the error;
        ``trace_id`` is stamped on the error (attribute AND message) so
        the rejection names the request it killed."""
        if self._metrics is not None and exc_type.shed_reason:
            self._metrics.shed.inc(reason=exc_type.shed_reason)
        if trace_id:
            detail = f"{detail} [trace {trace_id}]" if detail else (
                f"[trace {trace_id}]")
        err = exc_type(detail)
        err.trace_id = trace_id
        return err

    def check_admit(self, queued: int, stopping: bool,
                    trace_id: Optional[str] = None):
        """Raise the appropriate rejection for a new request, or return
        None to admit.  Called by the batcher with its lock held."""
        if stopping:
            raise self.shed(ShuttingDownError, "engine is shutting down",
                            trace_id=trace_id)
        if queued >= self.max_queue:
            raise self.shed(
                QueueFullError,
                f"queue budget exceeded ({queued} >= {self.max_queue})",
                trace_id=trace_id)

    def deadline_for(self, deadline_s: Optional[float]) -> float:
        d = self.default_deadline_s if deadline_s is None else float(deadline_s)
        if d <= 0:
            raise ValueError(f"deadline_s={d} must be > 0")
        return d
