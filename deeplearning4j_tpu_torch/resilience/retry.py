"""Step retry with exponential backoff + deterministic jitter.

The reference stack survives a lost executor by letting Spark re-dispatch
the partition (SparkNet §3); a single-controller run has no
re-dispatcher, so the fit loops carry their own: a ``RetryPolicy`` wraps
each step dispatch, classifies the exception (transient infrastructure
hiccup vs deterministic model bug), and re-runs transient failures after an
exponential backoff with seeded jitter.  Fatal errors — shape errors, NaN
guards, programming bugs — re-raise immediately: retrying a deterministic
failure just burns the backoff budget and buries the real traceback.

Every retry lands in ``dl4j_step_retries_total{component}`` and the flight
recorder (``retry`` events), so a run that is limping on retries is visible
on /metrics long before it exhausts the budget
(``dl4j_retry_exhausted_total``).

Port: a copy of ``deeplearning4j_tpu/resilience/retry.py`` with its imports
rewritten to the port.
"""

from __future__ import annotations

import logging
import random
import time
from typing import Any, Callable, Optional, Tuple

_RETRIES = "dl4j_step_retries_total"
_EXHAUSTED = "dl4j_retry_exhausted_total"

logger = logging.getLogger("deeplearning4j_tpu_torch.resilience")


class TransientError(RuntimeError):
    """Raise (or subclass) to mark an error as retryable regardless of its
    message."""


# Status substrings that mark an infrastructure error as transient: the
# gRPC-style codes a runtime error carries when a device or collective
# call fails mid-run (preempted host, briefly unreachable coordinator,
# memory pressure that a retry after backoff may clear).
_TRANSIENT_PATTERNS: Tuple[str, ...] = (
    "resource_exhausted", "unavailable", "deadline_exceeded", "aborted",
    "cancelled", "connection reset", "connection refused", "broken pipe",
    "socket closed", "temporarily unavailable", "transport closed",
    "failed to connect",
)

_TRANSIENT_TYPES = (TransientError, ConnectionError, TimeoutError)

# Never retried: interpreter shutdown, user interrupt, OOM of the host
# process, and the classic deterministic-bug types.
_FATAL_TYPES = (KeyboardInterrupt, SystemExit, GeneratorExit, MemoryError,
                ValueError, TypeError, KeyError, IndexError, AssertionError,
                NotImplementedError)


def is_transient(exc: BaseException) -> bool:
    """Transient vs fatal classification (see module docstring)."""
    if isinstance(exc, _TRANSIENT_TYPES):
        return True
    if isinstance(exc, _FATAL_TYPES):
        return False
    msg = f"{type(exc).__name__}: {exc}".lower()
    return any(p in msg for p in _TRANSIENT_PATTERNS)


class RetryPolicy:
    """Exponential-backoff-with-jitter retry for one component's steps.

    ``delay(attempt) = min(max_delay, base * multiplier**attempt)``, scaled
    by a seeded jitter factor in ``[1 - jitter, 1 + jitter]`` — seeded so a
    test (or a post-mortem replay) sees the exact same backoff schedule.

    ``run(fn)`` executes ``fn`` and retries transient failures up to
    ``max_retries`` times; fatal failures and exhausted budgets re-raise
    the original exception.
    """

    def __init__(self, max_retries: int = 3, base_delay_s: float = 0.5,
                 max_delay_s: float = 30.0, multiplier: float = 2.0,
                 jitter: float = 0.25, seed: int = 0,
                 component: str = "fit",
                 classify: Optional[Callable[[BaseException], bool]] = None,
                 sleep: Callable[[float], None] = time.sleep,
                 registry=None):
        if max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {max_retries}")
        if not 0.0 <= jitter <= 1.0:
            raise ValueError(f"jitter must be in [0, 1], got {jitter}")
        self.max_retries = int(max_retries)
        self.base_delay_s = float(base_delay_s)
        self.max_delay_s = float(max_delay_s)
        self.multiplier = float(multiplier)
        self.jitter = float(jitter)
        self.component = component
        self.classify = classify or is_transient
        self._sleep = sleep
        self._rng = random.Random(seed)
        self._registry = registry
        self.retries = 0            # total retries over this policy's life

    def _reg(self):
        if self._registry is not None:
            return self._registry
        from deeplearning4j_tpu_torch.observability import get_registry

        return get_registry()

    def delay(self, attempt: int) -> float:
        """Backoff before retry ``attempt`` (0-based), jitter applied."""
        d = min(self.max_delay_s,
                self.base_delay_s * (self.multiplier ** attempt))
        if self.jitter:
            d *= 1.0 + self.jitter * (2.0 * self._rng.random() - 1.0)
        return max(0.0, d)

    def run(self, fn: Callable[[], Any], *, description: str = "step",
            context: Optional[dict] = None) -> Any:
        """Execute ``fn()`` with transient-failure retries."""
        from deeplearning4j_tpu_torch.observability import get_flight_recorder

        attempt = 0
        while True:
            try:
                return fn()
            except BaseException as e:
                transient = self.classify(e)
                if not transient:
                    raise
                if attempt >= self.max_retries:
                    self._reg().counter(
                        _EXHAUSTED, "Transient step failures that exhausted "
                        "their retry budget and re-raised",
                        labels=("component",)).inc(component=self.component)
                    get_flight_recorder().record(
                        "retry_exhausted", component=self.component,
                        description=description, attempts=attempt,
                        error=repr(e), **(context or {}))
                    raise
                d = self.delay(attempt)
                attempt += 1
                self.retries += 1
                self._reg().counter(
                    _RETRIES, "Step retries after a transient failure "
                    "(exponential backoff with seeded jitter)",
                    labels=("component",)).inc(component=self.component)
                get_flight_recorder().record(
                    "retry", component=self.component,
                    description=description, attempt=attempt,
                    backoff_s=round(d, 4), error=repr(e), **(context or {}))
                logger.warning(
                    "transient failure in %s %s (attempt %d/%d, backing off "
                    "%.2fs): %r", self.component, description, attempt,
                    self.max_retries, d, e)
                if d:
                    self._sleep(d)
