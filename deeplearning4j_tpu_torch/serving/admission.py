"""Admission control — the part of ``deeplearning4j_tpu/serving/admission.py``
the generation engine uses, copied (framework-free): the serving errors
with their HTTP statuses and the queue-budget/deadline policy.

Under overload the engine REJECTS at the door (429) the moment the queue
exceeds its budget, fails queued requests whose deadline already passed
without running them (504), and fails fast (503) during shutdown, so no
waiter ever hangs.
"""

from __future__ import annotations

from typing import Optional


class ServingError(RuntimeError):
    """Base class for admission/serving rejections; carries the HTTP
    status the front-end should answer with, and — when raised for a
    specific request — that request's ``trace_id``."""

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
    """Request failed its deadline (expired while queued, or mid-flight)."""

    http_status = 504
    shed_reason = "deadline"


class AdmissionController:
    """Queue-budget + deadline policy (the scheduler consults it under its
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
        """Record the shed in the metrics registry (when one is wired)
        and build the error, stamped with ``trace_id``."""
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
        None to admit."""
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
