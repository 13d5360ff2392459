"""Shape-keyed dynamic micro-batcher.

Copied from ``deeplearning4j_tpu/serving/batcher.py`` with its imports
pointed at the port's own copies.

Fixes the two latency bugs of the first ``InferenceServer`` dispatch loop
and generalises it into the engine's core:

- **immediate dispatch**: the old loop unconditionally slept
  ``max_wait_ms`` before forming a batch, taxing every request even when
  a full batch was already queued.  Here a batch dispatches the moment
  its row budget saturates (or the head request is oversized); the wait
  only applies while a batch could still grow, and is measured from the
  OLDEST request's enqueue time.
- **O(1) queue ops**: pending requests live in ``collections.deque``
  per (model, row-shape) key — ``list.pop(0)`` was O(n) per request.

Keying by (model, row shape) means a batch is always concatenable and a
malformed request (wrong feature width) can only poison its own key,
never a well-formed neighbour's batch.  Expired-deadline requests are
dropped at the queue (their waiter gets ``DeadlineExceededError``)
without wasting a forward pass; on shutdown the loop either drains
(every queued request still served) or fails fast — either way no
waiter is left hanging.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.observability.tracing import get_tracer
from deeplearning4j_tpu_torch.serving.admission import (
    AdmissionController, DeadlineExceededError, Request, ShuttingDownError,
)

logger = logging.getLogger("deeplearning4j_tpu_torch.serving")

_Key = Tuple[str, Tuple[int, ...]]


class DynamicBatcher:
    """One dispatch thread multiplexing all models/shapes of an engine.

    ``execute(model_name, feats)`` is the engine's bucket-padded forward
    pass; it runs OUTSIDE the queue lock so enqueues never block on the
    accelerator."""

    def __init__(self, execute: Callable[[str, np.ndarray], np.ndarray],
                 admission: AdmissionController, max_batch: int = 32,
                 max_wait_ms: float = 2.0, metrics=None):
        self._execute = execute
        self.admission = admission
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1000.0
        self._metrics = metrics
        self._cv = threading.Condition()
        self._pending: Dict[_Key, deque] = {}
        self._queued = 0
        # lower bound on the earliest pending deadline: the full O(queued)
        # purge scan only runs when it can actually expire something, so a
        # deep backlog drains in O(n) dispatches, not O(n) scans per
        # dispatch
        self._earliest_deadline = float("inf")
        self._stop = False
        self._drain = True
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ client side
    @property
    def queued(self) -> int:
        # dl4jlint: disable-next-line=lock-discipline -- lock-free gauge read: GIL-atomic int, bound into dl4j_serving_queue_depth; must never contend with submit/dispatch
        return self._queued

    def queued_for(self, model: str) -> int:
        """Pending (not yet dispatched) requests targeting one model name
        — the canary teardown waits on this before the name leaves the
        registry, so no queued request can fail its lease."""
        with self._cv:
            return sum(len(dq) for key, dq in self._pending.items()
                       if key[0] == model)

    def is_alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def submit(self, req: Request) -> None:
        """Admit + enqueue (raises QueueFullError / ShuttingDownError)."""
        key = (req.model, tuple(req.features.shape[1:]))
        with self._cv:
            self.admission.check_admit(self._queued, self._stop,
                                       trace_id=req.trace_id)
            self._pending.setdefault(key, deque()).append(req)
            self._queued += 1
            if req.deadline < self._earliest_deadline:
                self._earliest_deadline = req.deadline
            self._cv.notify_all()

    # --------------------------------------------------------------- lifecycle
    def start(self) -> None:
        if self.is_alive():
            # e.g. a previous stop() timed out on a stuck execute: the old
            # loop still owns the queue — a second loop must never race it
            raise RuntimeError("dispatch thread is still running; "
                               "stop() it (and let it finish) first")
        with self._cv:
            self._stop = False
            self._drain = True
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="dl4j-serving-dispatch")
        self._thread.start()

    def stop(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Stop accepting work; ``drain=True`` serves everything already
        queued first, ``drain=False`` fails queued waiters immediately."""
        with self._cv:
            self._stop = True
            self._drain = drain
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                # the loop still owns the queue (e.g. stuck in a long graph
                # capture): failing its waiters here would race its own
                # deliveries, and is_alive() must keep reporting the truth
                logger.warning("serving dispatch thread did not exit "
                               "within %.1fs; leaving it to finish",
                               timeout)
                return
            self._thread = None
        # belt-and-braces: if the thread was never started (or died), the
        # queue may still hold waiters — fail them rather than hang them
        self._fail_all_locked_safe()

    # ------------------------------------------------------------ loop innards
    def _fail_all_locked_safe(self) -> None:
        with self._cv:
            self._fail_all()

    def _fail_all(self) -> None:
        """Deliver shutdown errors to every queued waiter (lock held)."""
        for dq in self._pending.values():
            for req in dq:
                if not req.cancelled:
                    req.deliver(self.admission.shed(
                        ShuttingDownError, "engine stopped before dispatch",
                        trace_id=req.trace_id))
        self._pending.clear()
        self._queued = 0

    def _purge(self, now: float) -> None:
        """Drop cancelled/expired requests from every deque (lock held).
        Expired waiters get DeadlineExceededError without costing a
        forward pass.  Skipped entirely (O(1)) while no pending deadline
        can have passed; a full scan recomputes the exact next one."""
        if now < self._earliest_deadline:
            return
        earliest = float("inf")
        for key in list(self._pending):
            dq = self._pending[key]
            kept = None
            for req in dq:
                if req.cancelled:
                    self._queued -= 1
                elif req.expired(now):
                    req.deliver(self.admission.shed(
                        DeadlineExceededError,
                        f"deadline passed after "
                        f"{now - req.enqueued:.3f}s in queue",
                        trace_id=req.trace_id))
                    self._queued -= 1
                else:
                    if kept is None:
                        kept = deque()
                    kept.append(req)
                    if req.deadline < earliest:
                        earliest = req.deadline
            if kept is None:
                del self._pending[key]
            elif len(kept) != len(dq):
                self._pending[key] = kept
        self._earliest_deadline = earliest

    def _saturated(self, dq: deque) -> bool:
        """True when the takeable prefix cannot grow: the head alone
        overflows the budget, the budget is exactly met, or the next
        request would overflow it."""
        rows = 0
        for req in dq:
            if rows == 0 and req.rows >= self.max_batch:
                return True
            if rows + req.rows > self.max_batch:
                return True
            rows += req.rows
            if rows == self.max_batch:
                return True
        return False

    def _pick(self, now: float) -> Tuple[Optional[_Key], Optional[float]]:
        """(key ready to dispatch now, earliest future wakeup time).
        Readiness: stopping (drain fast), saturated budget, or oldest
        request aged past max_wait.  Among ready keys the OLDEST head
        wins — first-ready-in-dict-order would let one continuously
        saturated key starve every other key's traffic.  Lock held."""
        wake = None
        ready, ready_head = None, None
        for key, dq in self._pending.items():
            if not dq:
                continue
            head = dq[0].enqueued
            head_ready_at = head + self.max_wait_s
            if self._stop or now >= head_ready_at or self._saturated(dq):
                if ready is None or head < ready_head:
                    ready, ready_head = key, head
                continue
            t = min(head_ready_at, dq[0].deadline)
            wake = t if wake is None else min(wake, t)
        return ready, None if ready is not None else wake

    def _take(self, key: _Key) -> list:
        """Pop the dispatchable prefix: requests until the row budget
        fills (a single oversized request is taken alone — the engine
        chunks it through the bucket set).  Lock held."""
        dq = self._pending[key]
        batch, rows = [], 0
        while dq and (not batch or rows + dq[0].rows <= self.max_batch):
            req = dq.popleft()
            self._queued -= 1
            if req.cancelled:
                continue
            batch.append(req)
            rows += req.rows
        if not dq:
            del self._pending[key]
        return batch

    def _loop(self) -> None:
        while True:
            batch = None
            with self._cv:
                while batch is None:
                    now = time.monotonic()
                    self._purge(now)
                    if self._stop and (not self._drain or self._queued == 0):
                        if not self._drain:
                            self._fail_all()
                        return
                    key, wake = self._pick(now)
                    if key is not None:
                        batch = self._take(key)
                        if not batch:      # all cancelled; re-evaluate
                            batch = None
                        continue
                    # also wake for the earliest pending deadline, which
                    # may sit mid-deque where _pick's head scan missed it
                    if self._earliest_deadline != float("inf"):
                        wake = (self._earliest_deadline if wake is None
                                else min(wake, self._earliest_deadline))
                    self._cv.wait(None if wake is None
                                  else max(0.0, wake - now))
            self._dispatch(batch)

    def _dispatch(self, batch: list) -> None:
        now = time.monotonic()
        now_ns = time.perf_counter_ns()
        tracer = get_tracer()
        for req in batch:
            req.queue_wait_ns = now_ns - req.enqueued_ns
            if self._metrics is not None:
                self._metrics.queue_wait.observe(now - req.enqueued,
                                                 exemplar=req.trace_id)
            if req.trace_id:
                # per-request queue stage: enqueue -> batch dispatch
                tracer.record_span("serving_queue_wait", req.enqueued_ns,
                                   now_ns, trace_id=req.trace_id,
                                   model=req.model, rows=req.rows)
        feats = (batch[0].features if len(batch) == 1
                 else np.concatenate([r.features for r in batch]))
        if self._metrics is not None:
            self._metrics.batch_rows.observe(len(feats))
        err = None
        t_ex0 = time.perf_counter_ns()
        try:
            out = self._execute(batch[0].model, feats)
        except Exception as e:  # deliver to waiters; the loop must survive
            err = e
        t_ex1 = time.perf_counter_ns()
        pos = 0
        for req in batch:
            req.execute_ns = t_ex1 - t_ex0
            req.batch_rows = len(feats)
            if req.trace_id:
                # the execute stage is shared by the whole micro-batch;
                # each request gets its own span so a trace-id query
                # returns the full queue/execute breakdown
                tracer.record_span(
                    "serving_execute", t_ex0, t_ex1, trace_id=req.trace_id,
                    model=req.model, rows=req.rows, batch_rows=len(feats),
                    **({"error": repr(err)} if err is not None else {}))
            if err is not None:
                req.deliver(err)
            else:
                req.deliver(out[pos:pos + req.rows])
                pos += req.rows
