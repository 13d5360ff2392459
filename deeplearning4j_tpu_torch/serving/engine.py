"""ServingEngine: bucketed batching + AOT warmup + hot-swap + admission.

Copied from ``deeplearning4j_tpu/serving/engine.py`` with its imports
pointed at the port's own copies.  On the card every dispatch replays the
bucket's captured ``output`` graph; the version's detector counts a
capture as a compile, so steady-state serving counts zero.

The production serving core the HTTP ``InferenceServer`` and the
broker-based ``ServingPipeline`` are thin front-ends over.  One engine
owns:

- a ``BucketPolicy`` (the closed shape set the card captures),
- a ``ModelRegistry`` (named/versioned models, atomic hot-swap),
- an ``AdmissionController`` (queue budget, deadlines, shedding),
- a ``DynamicBatcher`` (one dispatch thread multiplexing all models),
- a ``ServingMetrics`` bundle (Prometheus-convention families).

Request path: ``predict`` normalises features, stamps a deadline,
submits through admission, and waits BOUNDED on the result — a dead
dispatcher or an overloaded queue surfaces as a typed error, never a
hang.  Batches resolve their model version only at execution time (a
registry lease), which is what makes ``deploy`` a zero-drop swap: warm
the incoming version while the old one serves, flip atomically, let the
old version's in-flight batches drain, retire it.
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time
import weakref
from collections import OrderedDict
from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.observability.flightrecorder import (
    get_flight_recorder, step_guard,
)
from deeplearning4j_tpu_torch.observability.servingmetrics import ServingMetrics
from deeplearning4j_tpu_torch.observability.tracing import get_tracer, new_trace_id
from deeplearning4j_tpu_torch.serving.admission import (
    AdmissionController, DeadlineExceededError, ModelNotFoundError,
    QueueFullError, Request, ServingError, ShuttingDownError,
)
from deeplearning4j_tpu_torch.serving.batcher import DynamicBatcher
from deeplearning4j_tpu_torch.serving.buckets import BucketPolicy
from deeplearning4j_tpu_torch.serving.registry import (
    ModelRegistry, ModelVersion, load_version_from_checkpoint,
)
from deeplearning4j_tpu_torch.serving.warmup import (
    NoWarmupShapeError, forward, warmup_version,
)

logger = logging.getLogger("deeplearning4j_tpu_torch.serving")

DEFAULT_MODEL = "default"


class _CanaryRoute:
    """Traffic split for one model name: requests for the primary are
    rerouted to the canary version with probability ``fraction`` (seeded
    RNG — tests and replays see the same routing sequence), and every
    rerouted request's outcome is tallied.  The promotion watch decides
    promote-vs-reject on these counts, so sheds are tracked separately:
    a full queue is the engine's state, not the canary's fault, while
    errors and deadline expiries on canary traffic are exactly the
    regressions a canary exists to absorb before a full swap would."""

    def __init__(self, canary_model: str, fraction: float, seed: int = 0):
        self.canary_model = canary_model
        self.fraction = float(fraction)
        self.started = time.time()
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self.counts = {"ok": 0, "error": 0, "deadline": 0, "shed": 0}

    def take(self) -> bool:
        if self.fraction >= 1.0:
            return True
        if self.fraction <= 0.0:
            return False
        with self._lock:
            return self._rng.random() < self.fraction

    def record(self, status: str) -> None:
        with self._lock:
            if status not in self.counts:
                status = ("shed" if status in ("queue_full", "shutdown")
                          else "error")
            self.counts[status] += 1

    def as_dict(self) -> dict:
        with self._lock:
            counts = dict(self.counts)
        total = sum(counts.values())
        # sheds are visible but JUDGE nothing: a full queue is the
        # engine's load, not the canary's regression — the evidence
        # threshold and the error rate are over requests that actually
        # reached (or should have reached) the model
        judged = counts["ok"] + counts["error"] + counts["deadline"]
        bad = counts["error"] + counts["deadline"]
        return {"canary_model": self.canary_model,
                "fraction": self.fraction,
                "requests": total, "judged": judged, "bad": bad,
                "error_rate": (bad / judged) if judged else 0.0,
                **counts}


class ServingEngine:
    """See module docstring.  Minimal use::

        engine = ServingEngine(model, max_batch=32,
                               example=np.zeros((n_in,), np.float32))
        engine.start()            # AOT-warms every bucket shape
        out = engine.predict(x)   # thread-safe, batched, deadline-bounded
        engine.deploy("default", new_model)   # zero-drop hot-swap
        engine.stop()             # graceful drain
    """

    def __init__(self, model=None, *, max_batch: int = 32,
                 max_wait_ms: float = 2.0, max_queue: int = 256,
                 deadline_s: float = 30.0, policy: Optional[BucketPolicy] = None,
                 models: Optional[ModelRegistry] = None, registry=None,
                 example: Optional[np.ndarray] = None,
                 default_model: str = DEFAULT_MODEL):
        self.policy = policy or BucketPolicy(max_batch=max_batch)
        self.metrics = ServingMetrics(registry)
        self.metrics.set_max_batch(self.policy.max_batch)
        self.models = models or ModelRegistry(
            metrics_registry=self.metrics.registry)
        self.default_model = default_model
        if model is not None:
            self.models.register(default_model, model, example=example)
        self.admission = AdmissionController(
            max_queue=max_queue, default_deadline_s=deadline_s,
            metrics=self.metrics)
        self.batcher = DynamicBatcher(
            self._execute_batch, self.admission,
            max_batch=self.policy.max_batch, max_wait_ms=max_wait_ms,
            metrics=self.metrics)
        self._bind_queue_gauge()
        self._swap_lock = threading.Lock()
        # trace_id -> per-stage breakdown of recently completed requests
        # (bounded LRU; O(1) for the access log — the span ring is the
        # fallback for ids that have aged out of this cache)
        self._breakdowns: "OrderedDict[str, dict]" = OrderedDict()
        self._breakdown_lock = threading.Lock()
        self._breakdown_cap = 2048
        # name -> _CanaryRoute: a fraction of this model's traffic is
        # diverted to a candidate version (see start_canary).  Routing
        # lookups happen on every predict, so the map gets its own tiny
        # lock instead of riding _swap_lock (whose holders may be deep in
        # a warm-up capture); mutators hold BOTH: _swap_lock serialises the
        # canary lifecycle, _canary_lock makes each map op atomic against
        # the readers.  Lock order: _swap_lock outer, _canary_lock inner.
        self._canary: "dict[str, _CanaryRoute]" = {}
        self._canary_lock = threading.Lock()
        # per-model outcome tallies (see status_counts)
        self._model_status: "dict[str, dict[str, int]]" = {}

    def _bind_queue_gauge(self) -> None:
        # weakref: the registry outlives the engine — a strong closure
        # would pin the batcher (and through it the models) forever
        ref = weakref.ref(self.batcher)
        self.metrics.bind_queue_depth(
            lambda: b.queued if (b := ref()) is not None else 0.0)

    # ------------------------------------------------------------- lifecycle
    def start(self, warmup: bool = True) -> "ServingEngine":
        """Start the dispatcher; with ``warmup`` (default) precompile
        every bucket shape of every registered model so steady-state
        serving triggers zero compiles (captures).  A model whose input shape
        cannot be derived (and that has no example) is skipped with a
        warning — its first live shapes compile on demand instead; any
        OTHER warmup failure means a broken model and propagates."""
        if warmup:
            for name in self.models.names():
                mv = self.models.active(name)
                try:
                    warmup_version(mv, self.policy, metrics=self.metrics)
                except NoWarmupShapeError as e:
                    logger.warning("skipping warmup: %s", e)
        self.batcher.start()
        self._bind_queue_gauge()   # stop() freezes the gauge; re-arm it
        return self

    def stop(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Graceful shutdown: with ``drain`` every queued request is
        still served; without, queued waiters fail with 503 — in both
        cases no waiter is left hanging."""
        self.batcher.stop(drain=drain, timeout=timeout)
        self.metrics.freeze_queue_depth()

    # ---------------------------------------------------------------- predict
    def predict(self, features: np.ndarray, model: Optional[str] = None,
                deadline_s: Optional[float] = None,
                trace_id: Optional[str] = None) -> np.ndarray:
        """Thread-safe batched inference.  Raises ``QueueFullError``
        (shed), ``ShuttingDownError``, ``DeadlineExceededError``, or the
        model's own failure — bounded by the request deadline either
        way.

        ``trace_id`` (minted here when absent) rides the request end to
        end: queue and execute stages record spans stamped with it
        (``SpanTracer.spans_for_trace``), shed/deadline errors carry it
        (``.trace_id`` attribute + message), shed flight events name it,
        and it is sampled as the exemplar onto the latency histogram."""
        trace_id = trace_id or new_trace_id()
        primary = model = model or self.default_model
        with self._canary_lock:
            route = self._canary.get(model)
        if route is not None and route.take():
            model = route.canary_model
        else:
            route = None
        feats = np.asarray(features, np.float32)
        if feats.ndim == 1:
            feats = feats[None, :]
        if len(feats) == 0:
            raise ValueError("predict called with zero rows")
        orig_seq = None
        if self.policy.seq_buckets is not None and feats.ndim >= 3:
            orig_seq = feats.shape[1]
            target = self.policy.bucket_seq(orig_seq)
            if target > orig_seq:
                pad = np.zeros(
                    (feats.shape[0], target - orig_seq) + feats.shape[2:],
                    feats.dtype)
                feats = np.concatenate([feats, pad], axis=1)
        deadline = self.admission.deadline_for(deadline_s)
        req = Request(feats, model, deadline, orig_seq, trace_id=trace_id)
        t0 = time.perf_counter()
        t0_ns = time.perf_counter_ns()
        status = "error"
        try:
            try:
                res = self._predict_wait(req, model, deadline, trace_id, t0,
                                         quiet_model_missing=route is not None)
            except ModelNotFoundError:
                if route is None:
                    raise
                # the canary was torn down between routing and dispatch
                # (stop_canary's queue drain cannot see a request that
                # passed take() but hasn't submitted yet) — the zero-drop
                # contract outranks the split: fall back to the primary
                model = primary
                req = Request(feats, model, deadline, orig_seq,
                              trace_id=trace_id)
                res = self._predict_wait(req, model, deadline, trace_id, t0)
            status = "ok"
            if (orig_seq is not None and res.ndim >= 3
                    and res.shape[1] > orig_seq):
                res = res[:, :orig_seq]   # trim time-distributed pad steps
            return res
        except ServingError as e:
            status = e.shed_reason or "error"
            raise
        finally:
            t1_ns = time.perf_counter_ns()
            get_tracer().record_span(
                "serving_request", t0_ns, t1_ns,
                trace_id=trace_id, model=model, rows=req.rows,
                status=status)
            self._remember_breakdown(req, trace_id, status,
                                     (t1_ns - t0_ns) / 1e6)
            if route is not None:
                route.record(status)

    def _predict_wait(self, req: Request, model: str, deadline: float,
                      trace_id: str, t0: float,
                      quiet_model_missing: bool = False) -> np.ndarray:
        """Submit + bounded wait + result classification (the predict
        body; split so ``predict`` can bracket it with the request
        span).  ``quiet_model_missing`` (the canary-routed attempt): a
        ``ModelNotFoundError`` result re-raises WITHOUT counters or
        flight events — the caller retries on the primary, and one
        client call must not show up as a phantom error next to its own
        success in the metrics the SLO rules read."""
        try:
            self.batcher.submit(req)
        except ServingError as e:
            self.metrics.requests.inc(status="shed")
            get_flight_recorder().record("shed", model=model,
                                         reason=type(e).__name__,
                                         trace_id=trace_id)
            raise
        # +grace so the queue-side deadline purge (which produces the more
        # informative error and owns shed{reason="deadline"}) normally
        # wins the race against this waiter
        if not req.done.wait(max(0.0, req.deadline - time.monotonic()) + 0.5):
            req.cancelled = True
            # the purge may have delivered between the timeout and here —
            # prefer its result so the shed counter is bumped exactly once
            if not req.done.is_set():
                self.metrics.requests.inc(status="deadline")
                get_flight_recorder().record("shed", model=model,
                                             reason="deadline",
                                             trace_id=trace_id)
                err = DeadlineExceededError(
                    f"no result within {deadline:.3f}s deadline "
                    f"(dispatcher dead or engine overloaded) "
                    f"[trace {trace_id}]")
                err.trace_id = trace_id
                raise err
        res = req.result[0]
        if quiet_model_missing and isinstance(res, ModelNotFoundError):
            raise res    # primary retry owns this request's accounting
        self.metrics.latency.observe(time.perf_counter() - t0,
                                     exemplar=trace_id)
        self.metrics.request_rows.observe(req.rows)
        if isinstance(res, Exception):
            if isinstance(res, DeadlineExceededError):
                self.metrics.requests.inc(status="deadline")
            elif isinstance(res, (QueueFullError, ShuttingDownError)):
                self.metrics.requests.inc(status="shed")
            else:
                self.metrics.requests.inc(status="error")
            if isinstance(res, ServingError):
                get_flight_recorder().record("shed", model=model,
                                             reason=type(res).__name__,
                                             trace_id=trace_id)
            raise res
        self.metrics.requests.inc(status="ok")
        return res

    def _remember_breakdown(self, req: Request, trace_id: str, status: str,
                            total_ms: float) -> None:
        """Cache the completed request's per-stage timings (stamped on
        the Request by the batcher) under its trace id — O(1) for the
        access log, immune to span-ring eviction.  Also tallies the
        outcome under the request's MODEL name (``status_counts``): the
        shared ``dl4j_serving_requests_total`` counter has no model
        label, and the promotion watch must not attribute another
        model's errors to a freshly swapped candidate."""
        entry = {
            "trace_id": trace_id,
            "queue_wait_ms": (None if req.queue_wait_ns is None
                              else req.queue_wait_ns / 1e6),
            "execute_ms": (None if req.execute_ns is None
                           else req.execute_ns / 1e6),
            "total_ms": total_ms,
            "status": status,
            "batch_rows": req.batch_rows,
            "bucket": (None if not req.batch_rows else self.policy.
                       bucket_rows(min(int(req.batch_rows),
                                       self.policy.max_batch))),
        }
        with self._breakdown_lock:
            self._breakdowns[trace_id] = entry
            self._breakdowns.move_to_end(trace_id)
            while len(self._breakdowns) > self._breakdown_cap:
                self._breakdowns.popitem(last=False)
            tally = self._model_status.setdefault(req.model, {})
            tally[status] = tally.get(status, 0) + 1

    def status_counts(self, model: str) -> dict:
        """Cumulative request outcomes for ONE model name (``ok`` /
        ``error`` / ``deadline`` / ``queue_full`` / ``shutdown``) — the
        per-model view the promotion watch diffs across its window."""
        with self._breakdown_lock:
            return dict(self._model_status.get(model, {}))

    def request_breakdown(self, trace_id: str) -> dict:
        """Per-stage timing of one traced request: queue wait, execute
        time, and the bucket its batch dispatched at (None for stages
        that never ran — e.g. a shed request has no execute stage).
        Served O(1) from the completed-request cache; falls back to a
        span-ring scan for ids that aged out of it."""
        with self._breakdown_lock:
            hit = self._breakdowns.get(trace_id)
            if hit is not None:
                return dict(hit)
        out = {"trace_id": trace_id, "queue_wait_ms": None,
               "execute_ms": None, "total_ms": None, "status": None,
               "batch_rows": None, "bucket": None}
        for s in get_tracer().spans_for_trace(trace_id):
            if s.name == "serving_queue_wait":
                out["queue_wait_ms"] = s.duration_ms
            elif s.name == "serving_execute":
                out["execute_ms"] = s.duration_ms
                rows = s.attrs.get("batch_rows")
                out["batch_rows"] = rows
                if rows:
                    out["bucket"] = self.policy.bucket_rows(
                        min(int(rows), self.policy.max_batch))
            elif s.name == "serving_request":
                out["total_ms"] = s.duration_ms
                out["status"] = s.attrs.get("status")
        return out

    # ----------------------------------------------------------- model admin
    def deploy(self, name: str, model_or_path, *, example=None,
               version: Optional[int] = None, warmup: bool = True,
               retain_old: bool = False, drain_timeout: float = 30.0,
               device=None) -> ModelVersion:
        """Register a model (or load a checkpoint path via
        ``models/serialization.py``) as the next version of ``name`` and
        hot-swap it in: the incoming version is warmed across all bucket
        shapes BEFORE the atomic flip, in-flight batches finish on the
        old version under their leases, then the old version retires.
        No request is dropped at any point.

        With ``retain_old`` the displaced version is NOT retired: it
        stays loaded in state ``retained`` as the ``rollback`` target —
        the promotion watch window's undo button.  Close the window with
        ``commit_swap`` (keep the new version, retire the old) or
        ``rollback`` (flip back, retire the new).  A still-unresolved
        retained version from an earlier retaining swap is committed
        first — at most one rollback target exists per name.  A
        checkpoint is restored onto ``device`` (the card unless the
        caller asks for the CPU).  Without ``example`` the version it
        replaces lends its example row to the warm-up."""
        with self._swap_lock:   # serialize swaps per engine
            if example is None and name in self.models.names():
                # the incoming version takes the rows the serving one
                # takes: warm it on the same example (a checkpoint posted
                # over HTTP carries none, and a conv or graph model's row
                # shape cannot be read from its config)
                example = self.models.active(name).example
            if isinstance(model_or_path, (str, bytes, os.PathLike)):
                mv = load_version_from_checkpoint(
                    self.models, name, model_or_path, example=example,
                    device=device)
            else:
                mv = self.models.new_version(
                    name, model_or_path, example=example, version=version)
            if warmup:
                # only the no-known-shape case is tolerable; a model that
                # FAILS its warmup forward must never be activated — the
                # raise here aborts the swap with the old version intact
                try:
                    warmup_version(mv, self.policy, metrics=self.metrics)
                except NoWarmupShapeError as e:
                    logger.warning("deploying %s unwarmed: %s", mv.key, e)
            # ANY swap supersedes a still-open rollback window: commit it
            # (drain + release the retained weights) rather than letting
            # activate() park the stale version in the history with its
            # model pinned
            self._commit_locked(name, drain_timeout)
            old = self.models.activate(mv, retain=retain_old)
            get_flight_recorder().record(
                "swap", model=name, version=mv.version,
                replaced=old.version if old else None,
                retained=bool(retain_old and old is not None))
            if old is not None:
                self.metrics.swaps.inc(model=name)
                if not retain_old and not self.models.retire(
                        old, timeout=drain_timeout):
                    logger.warning(
                        "old version %s still has in-flight batches after "
                        "%.1fs; left un-retired", old.key, drain_timeout)
            logger.info("%s now serving (replaced %s%s)", mv.key,
                        old.key if old else "nothing",
                        ", retained for rollback"
                        if retain_old and old else "")
            return mv

    def rollback(self, name: str, *,
                 drain_timeout: float = 30.0) -> ModelVersion:
        """Undo the last retaining swap of ``name``: atomically flip the
        active pointer back to the retained previous version, then retire
        the displaced (regressed) version after its in-flight batches
        drain.  Zero requests are dropped: a request leasing during the
        flip completes on whichever version its batch pinned.  Raises
        ``ModelNotFoundError`` when no rollback window is open."""
        with self._swap_lock:
            restored, displaced = self.models.rollback(name)
            get_flight_recorder().record(
                "rollback", model=name, restored=restored.version,
                displaced=displaced.version if displaced else None)
            self.metrics.swaps.inc(model=name)
            logger.warning(
                "%s ROLLED BACK to %s (displacing %s)", name, restored.key,
                displaced.key if displaced else "nothing")
            if displaced is not None and not self.models.retire(
                    displaced, timeout=drain_timeout):
                logger.warning(
                    "rolled-back version %s still has in-flight batches "
                    "after %.1fs; left un-retired", displaced.key,
                    drain_timeout)
            return restored

    def commit_swap(self, name: str, *,
                    drain_timeout: float = 30.0) -> Optional[ModelVersion]:
        """Close the rollback window after a ``deploy(...,
        retain_old=True)`` that watched clean: retire the retained
        previous version (drain, release weights).  Returns it, or None
        when no window was open — committing twice is harmless."""
        with self._swap_lock:
            return self._commit_locked(name, drain_timeout)

    def _commit_locked(self, name: str,
                       drain_timeout: float) -> Optional[ModelVersion]:
        mv = self.models.release_retained(name)
        if mv is not None and not self.models.retire(
                mv, timeout=drain_timeout):
            logger.warning(
                "retained version %s still has in-flight batches after "
                "%.1fs; left un-retired", mv.key, drain_timeout)
        return mv

    # ---------------------------------------------------------------- canary
    def start_canary(self, name: str, model_or_path, *,
                     fraction: float = 0.1, example=None,
                     seed: int = 0, device=None) -> ModelVersion:
        """Serve a candidate next to ``name`` on a traffic fraction: the
        candidate is warmed and registered under ``<name>:canary``, and
        each later ``predict(model=name)`` is rerouted to it with
        probability ``fraction`` (seeded).  Outcomes of rerouted requests
        are tallied (``canary_stats``); ``stop_canary`` tears the split
        down again.  The primary version is untouched throughout — a
        canary that fails its warmup never serves a single request."""
        if not 0.0 < fraction <= 1.0:
            raise ValueError(f"fraction must be in (0, 1], got {fraction}")
        with self._swap_lock:
            if name in self._canary:
                raise ValueError(f"{name!r} already has a live canary")
            self.models.active(name)   # primary must exist (raises if not)
            canary_name = f"{name}:canary"
            if isinstance(model_or_path, (str, bytes, os.PathLike)):
                mv = load_version_from_checkpoint(
                    self.models, canary_name, model_or_path, example=example,
                    device=device)
            else:
                mv = self.models.new_version(
                    canary_name, model_or_path, example=example)
            try:
                warmup_version(mv, self.policy, metrics=self.metrics)
            except NoWarmupShapeError as e:
                logger.warning("canary %s unwarmed: %s", mv.key, e)
            self.models.activate(mv)
            with self._canary_lock:
                self._canary[name] = _CanaryRoute(canary_name, fraction,
                                                  seed=seed)
            get_flight_recorder().record(
                "canary_start", model=name, version=mv.version,
                fraction=fraction)
            logger.info("canary %s serving %.0f%% of %r traffic", mv.key,
                        100.0 * fraction, name)
            return mv

    def canary_stats(self, name: str) -> Optional[dict]:
        with self._canary_lock:
            route = self._canary.get(name)
        return route.as_dict() if route is not None else None

    def stop_canary(self, name: str, *,
                    drain_timeout: float = 30.0) -> Optional[dict]:
        """Tear down ``name``'s traffic split: stop routing new requests
        to the canary, wait (bounded) until every request already queued
        for the canary name has dispatched — a queued request must never
        fail its lease against a removed registry entry — then retire the
        canary version.  Returns the final outcome tally, or None when no
        canary was live.  The queue wait happens OUTSIDE the swap lock so
        deploys/rollbacks are never blocked behind a canary backlog."""
        with self._swap_lock:
            with self._canary_lock:
                route = self._canary.pop(name, None)
            if route is None:
                return None
            stats = route.as_dict()
            try:
                mv = self.models.active(route.canary_model)
            except ModelNotFoundError:
                mv = None
        deadline = time.monotonic() + drain_timeout
        while (self.batcher.queued_for(route.canary_model) > 0
               and time.monotonic() < deadline):
            time.sleep(0.005)
        with self._swap_lock:
            if name not in self._canary:
                # a NEW canary for this name may have started while we
                # waited; the registry entry then belongs to it — only
                # tear the name down while OUR version still owns it
                try:
                    if self.models.active(route.canary_model) is mv:
                        self.models.remove(route.canary_model)
                except ModelNotFoundError:
                    pass
            if mv is not None and not self.models.retire(
                    mv, timeout=drain_timeout):
                logger.warning(
                    "canary %s still has in-flight batches after %.1fs; "
                    "left un-retired", mv.key, drain_timeout)
            get_flight_recorder().record(
                "canary_stop", model=name,
                version=mv.version if mv else None, **{
                    k: stats[k] for k in
                    ("requests", "judged", "bad", "error_rate")})
            return stats

    def stats(self) -> dict:
        """Live engine state for the HTTP /models endpoint."""
        with self._canary_lock:   # snapshot: start/stop_canary mutate
            canaries = list(self._canary.items())
        return {
            "models": self.models.as_dict(),
            "queue_depth": self.batcher.queued,
            "max_batch": self.policy.max_batch,
            "batch_buckets": list(self.policy.batch_buckets),
            "seq_buckets": (list(self.policy.seq_buckets)
                            if self.policy.seq_buckets else None),
            "max_queue": self.admission.max_queue,
            "dispatcher_alive": self.batcher.is_alive(),
            "canaries": {n: r.as_dict() for n, r in canaries},
        }

    # ------------------------------------------------------------- execution
    def _execute_batch(self, model_name: str, feats: np.ndarray) -> np.ndarray:
        """Forward one concatenated batch under a version lease: chunk to
        the row budget, pad each chunk UP to its bucket (never to full
        ``max_batch`` unless needed), fingerprint through the version's
        recompile detector, slice the padding back off."""
        with step_guard("serving_dispatch", model=model_name,
                        rows=len(feats)):
            return self._execute_leased(model_name, feats)

    def _execute_leased(self, model_name: str, feats: np.ndarray) -> np.ndarray:
        with self.models.lease(model_name) as mv:
            n = len(feats)
            outs = []
            i = 0
            while i < n:
                take = min(self.policy.max_batch, n - i)
                chunk = feats[i:i + take]
                bucket = self.policy.bucket_rows(take)
                if bucket > take:
                    pad = np.zeros((bucket - take,) + chunk.shape[1:],
                                   chunk.dtype)
                    chunk = np.concatenate([chunk, pad])
                self.metrics.bucket_util.observe(take / bucket)
                outs.append(forward(mv, chunk)[:take])
                i += take
            return outs[0] if len(outs) == 1 else np.concatenate(outs)
