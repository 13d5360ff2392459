"""Cache-aware fleet router: placement, health-gated membership, failover.

The first subsystem that makes N ``GenerationEngine`` replicas act as one
service.  The scoring math itself lives in
``fleet/placement.py`` (stdlib-only, CI-simulatable); this module is the
live half:

* **membership** — the routing table is refreshed from the fleet
  ``FleetAggregator`` view: a replica whose snapshots go stale or whose
  published ``/health`` verdict fails is drained from new placements
  before requests ever error against it.  Replica handles are
  ``attach``-ed explicitly (the supervisor or test wires them); the
  aggregator decides whether an attached replica is placeable.
* **failover** — a dead replica's in-queue requests (nothing streamed
  yet) are transparently retried on a survivor through the
  ``RetryPolicy`` (its transient/fatal classification, seeded backoff,
  and retry metrics), with ``dl4j_fleet_router_failovers_total{reason}``
  on record.  A request that already streamed tokens is NOT replayed —
  the client would see duplicated output — it gets the terminal error
  (the HTTP frontend turns that into the clean terminal SSE event).
  The death mark is keyed on the replica's last published
  ``(epoch, seq)``: a restart publishes a fresh epoch (which the
  aggregator re-bases exactly), clearing the mark so the replica
  rejoins automatically.
* **tracing** — every placement records a ``fleet_route`` span (scored
  candidates, chosen replica, placement reason) under the request's
  ``X-Request-Id``, which the router mints at the edge when the client
  did not.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from deeplearning4j_tpu_torch.fleet.placement import (
    DEFAULT_OVERLOAD_FACTOR, ReplicaView, choose)
from deeplearning4j_tpu_torch.observability.metrics import get_registry
from deeplearning4j_tpu_torch.observability.tracing import get_tracer, new_trace_id
from deeplearning4j_tpu_torch.resilience.retry import RetryPolicy, is_transient
from deeplearning4j_tpu_torch.serving.admission import (
    QueueFullError, ServingError, ShuttingDownError)

logger = logging.getLogger("deeplearning4j_tpu_torch.fleet")

# failover reasons (the {reason} label values)
REPLICA_DEAD = "replica_dead"
DRAINING = "draining"
QUEUE_FULL = "queue_full"


class NoLiveReplicaError(ServingError):
    """Every attached replica is stale, unhealthy, drained, or dead —
    there is nowhere to place the request.  503, and FATAL for retry
    purposes: backoff inside the router cannot conjure a replica."""

    http_status = 503
    shed_reason = "no_live_replica"


def _failover_reason(exc: BaseException) -> Optional[str]:
    """Map a submit/stream failure to a failover reason, or None when it
    is the client's problem (bad request → no retry, no blame)."""
    if isinstance(exc, QueueFullError):
        return QUEUE_FULL
    if isinstance(exc, ShuttingDownError):
        return DRAINING
    if isinstance(exc, NoLiveReplicaError) or not is_transient(exc):
        return None
    return REPLICA_DEAD


def _failover_transient(exc: BaseException) -> bool:
    """Retry classification for the router's RetryPolicy: retryable is
    exactly what has a failover reason (queue-full and draining replicas
    are retryable-elsewhere even though their messages don't match the
    infra-transient patterns)."""
    return _failover_reason(exc) is not None


class _Entry:
    """One attached replica: its handle plus the router's view of it."""

    __slots__ = ("handle", "view", "dead_mark", "ok", "bad", "joined")

    def __init__(self, handle, view: ReplicaView):
        self.handle = handle
        self.view = view
        # (epoch, seq) at death observation; cleared when the published
        # stream moves past it (fresh epoch or seq advance = alive again)
        self.dead_mark: Optional[Tuple[Optional[str], int]] = None
        self.ok = 0       # finished requests (length/stop)
        self.bad = 0      # terminal errors attributed to this replica
        self.joined = False


class Placement:
    """One routing decision, as recorded in the ``fleet_route`` span."""

    __slots__ = ("replica_id", "reason", "scores", "trace_id", "n")

    def __init__(self, replica_id: str, reason: str,
                 scores: Dict[str, Dict[str, Any]], trace_id: str, n: int):
        self.replica_id = replica_id
        self.reason = reason
        self.scores = scores
        self.trace_id = trace_id
        self.n = n

    def as_dict(self) -> Dict[str, Any]:
        return {"replica": self.replica_id, "reason": self.reason,
                "trace_id": self.trace_id, "n": self.n,
                "scores": self.scores}


class FleetRouter:
    """Places generation requests across attached replicas (module
    docstring).  Thread-safe; one instance fronts the whole fleet."""

    def __init__(self, *, aggregator=None, page_size: int = 16,
                 seed: int = 0, registry=None, retry_policy=None,
                 refresh_interval_s: float = 0.25,
                 policy: str = "affinity",
                 overload_factor: float = DEFAULT_OVERLOAD_FACTOR,
                 shadow_max_pages: int = 8192):
        self.aggregator = aggregator
        self.page_size = int(page_size)
        self.seed = int(seed)
        self.policy = policy
        self.overload_factor = float(overload_factor)
        self.shadow_max_pages = int(shadow_max_pages)
        self.refresh_interval_s = float(refresh_interval_s)
        self.registry = registry or get_registry()
        # short fuse: failover should land on a survivor in well under a
        # second, not wait out the training-path default backoff
        self.retry_policy = retry_policy or RetryPolicy(
            max_retries=3, base_delay_s=0.05, max_delay_s=1.0,
            seed=self.seed, component="fleet_router",
            classify=_failover_transient, registry=self.registry)
        self._lock = threading.RLock()
        self._replicas: Dict[str, _Entry] = {}
        self._sessions: Dict[str, Dict[str, Any]] = {}
        self._split: Optional[Tuple[str, float, int]] = None
        self._n = 0                    # request index (tie/canary coins)
        self._last_refresh = 0.0
        self._m_requests = self.registry.counter(
            "dl4j_fleet_router_requests_total",
            "Requests placed, by chosen replica and placement reason",
            labels=("replica", "reason"))
        self._m_failovers = self.registry.counter(
            "dl4j_fleet_router_failovers_total",
            "Placement retries after a replica failed a request it had "
            "not streamed from yet", labels=("reason",))
        self._m_replicas = self.registry.gauge(
            "dl4j_fleet_router_replicas",
            "Routing-table population by liveness", labels=("state",))
        self._m_affinity_pages = self.registry.counter(
            "dl4j_fleet_router_affinity_pages_total",
            "Prefix pages predicted resident on the chosen replica at "
            "placement time (the pages the placement saved)")

    # ---------------------------------------------------------- membership
    def attach(self, handle, replica_id: Optional[str] = None) -> str:
        """Add a replica handle to the table.  It becomes placeable once
        the aggregator reports it fresh+healthy (or immediately when the
        router runs aggregator-less, e.g. in-process unit tests)."""
        rid = str(replica_id or getattr(handle, "replica_id"))
        with self._lock:
            view = ReplicaView(rid, page_size=self.page_size,
                               shadow_max_pages=self.shadow_max_pages)
            self._replicas[rid] = _Entry(handle, view)
        self.refresh(force=True)
        return rid

    def detach(self, replica_id: str) -> None:
        with self._lock:
            self._replicas.pop(replica_id, None)
            for sid in [s for s, b in self._sessions.items()
                        if b["replica"] == replica_id]:
                self._sessions[sid]["pin_id"] = None

    def drain(self, replica_id: str, draining: bool = True) -> None:
        """Admin drain: stop NEW placements (rollout waves, ops); does
        not touch requests already on the replica."""
        with self._lock:
            e = self._replicas.get(replica_id)
            if e is None:
                raise KeyError(f"unknown replica {replica_id!r}")
            e.view.draining = bool(draining)

    def replicas(self) -> List[Dict[str, Any]]:
        self.refresh()
        with self._lock:
            return [dict(e.view.as_dict(), ok=e.ok, bad=e.bad)
                    for e in self._replicas.values()]

    def refresh(self, force: bool = False) -> None:
        """Fold the aggregator's ``workers()`` table into the routing
        views: health gate, load, free pages, cache version (which gates
        each shadow index), and death-mark clearing on epoch re-base."""
        now = time.monotonic()
        with self._lock:
            if not force and now - self._last_refresh < self.refresh_interval_s:
                return
            self._last_refresh = now
            rows = {}
            if self.aggregator is not None:
                try:
                    rows = {r["worker"]: r for r in self.aggregator.workers()}
                except Exception:
                    logger.warning("fleet router: aggregator refresh failed",
                                   exc_info=True)
                    return
            for rid, e in self._replicas.items():
                v = e.view
                if self.aggregator is None:
                    # aggregator-less (in-process tests): ask the handle
                    row = getattr(e.handle, "local_view", lambda: None)()
                else:
                    row = rows.get(rid)
                if row is None:
                    # never published (still warming) or expired outright
                    v.stale = e.joined  # unknown-yet != stale
                    v.healthy = None if not e.joined else False
                    continue
                e.joined = True
                v.stale = bool(row.get("stale"))
                v.healthy = row.get("healthy")
                sched = (row.get("state") or {}).get("scheduler") or {}
                v.slots = int(sched.get("slots") or v.slots)
                v.active = int(sched.get("active") or 0)
                v.queued = int(sched.get("queued") or 0)
                cache = sched.get("cache") or {}
                v.free_pages = int(cache.get("free_pages") or 0)
                pc = row.get("prefix_cache") or {}
                v.cache_version = pc.get("version")
                v.shadow.observe_version(v.cache_version)
                if e.dead_mark is not None:
                    epoch, seq = e.dead_mark
                    if row.get("epoch") != epoch or int(row.get("seq") or 0) > seq:
                        # fresh publisher epoch (restart) or the stream
                        # advanced past the death point: it rejoined
                        e.dead_mark = None
                        v.dead = False
            by_state = {"live": 0, "stale": 0, "unhealthy": 0,
                        "draining": 0, "dead": 0}
            for e in self._replicas.values():
                v = e.view
                if v.dead:
                    by_state["dead"] += 1
                elif v.draining:
                    by_state["draining"] += 1
                elif v.stale:
                    by_state["stale"] += 1
                elif v.healthy is False:
                    by_state["unhealthy"] += 1
                else:
                    by_state["live"] += 1
            for state, count in by_state.items():
                self._m_replicas.set(count, state=state)

    # ------------------------------------------------------------- rollout
    def set_traffic_split(self, replica_id: str, fraction: float,
                          seed: int = 0) -> None:
        """Arm the seeded canary split: ``fraction`` of placements land
        on ``replica_id`` (the fleet-rollout canary phase)."""
        if not 0.0 <= fraction <= 1.0:
            raise ValueError(f"fraction must be in [0,1], got {fraction}")
        with self._lock:
            if replica_id not in self._replicas:
                raise KeyError(f"unknown replica {replica_id!r}")
            self._split = (replica_id, float(fraction), int(seed))

    def clear_traffic_split(self) -> None:
        with self._lock:
            self._split = None

    def status_counts(self, replica_id: str) -> Dict[str, int]:
        """Per-replica terminal outcomes (ok/bad) — the fleet rollout's
        watch evidence, same judged/bad vocabulary as the online promotion's watch."""
        with self._lock:
            e = self._replicas.get(replica_id)
            if e is None:
                raise KeyError(f"unknown replica {replica_id!r}")
            return {"ok": e.ok, "bad": e.bad, "judged": e.ok + e.bad}

    def _note_outcome(self, replica_id: str, ok: bool) -> None:
        with self._lock:
            e = self._replicas.get(replica_id)
            if e is not None:
                if ok:
                    e.ok += 1
                else:
                    e.bad += 1

    # ----------------------------------------------------------- placement
    def place(self, prompt: Sequence[int], *,
              session_id: Optional[str] = None,
              exclude: Iterable[str] = (),
              trace_id: Optional[str] = None) -> Placement:
        """One placement decision + its ``fleet_route`` span.  Raises
        ``NoLiveReplicaError`` when the live set is empty."""
        t0 = time.perf_counter_ns()
        tid = trace_id or new_trace_id()
        self.refresh()
        with self._lock:
            n = self._n
            self._n += 1
            session_replica = None
            if session_id is not None:
                bound = self._sessions.get(session_id)
                if bound is not None:
                    session_replica = bound["replica"]
            rid, reason, scores = choose(
                [e.view for e in self._replicas.values()], prompt,
                seed=self.seed, n=n, session_replica=session_replica,
                split=self._split, exclude=exclude,
                overload_factor=self.overload_factor, policy=self.policy)
            if rid is None:
                raise NoLiveReplicaError(
                    f"no live replica among {sorted(self._replicas)} "
                    f"[trace {tid}]")
            if session_replica is not None and rid != session_replica:
                reason = "repin"   # pinned replica gone; survivor chosen
            e = self._replicas[rid]
            saved = e.view.shadow.matched_pages(prompt)
            e.view.shadow.insert(prompt)
            e.view.inflight += 1
        self._m_requests.inc(replica=rid, reason=reason)
        if saved:
            self._m_affinity_pages.inc(saved)
        get_tracer().record_span(
            "fleet_route", t0, time.perf_counter_ns(), trace_id=tid,
            replica=rid, reason=reason, n=n,
            candidates={r: {"affinity_pages": s["affinity_pages"],
                            "load": s["load"],
                            "free_pages": s["free_pages"]}
                        for r, s in scores.items()})
        return Placement(rid, reason, scores, tid, n)

    def _entry(self, replica_id: str) -> _Entry:
        with self._lock:
            return self._replicas[replica_id]

    def _release(self, replica_id: str) -> None:
        with self._lock:
            e = self._replicas.get(replica_id)
            if e is not None and e.view.inflight > 0:
                e.view.inflight -= 1

    def _record_failover(self, reason: str, replica_id: str,
                         exc: BaseException) -> None:
        self._m_failovers.inc(reason=reason)
        with self._lock:
            e = self._replicas.get(replica_id)
            if e is not None and reason in (REPLICA_DEAD, DRAINING):
                e.view.dead = True
                e.dead_mark = (e.view.cache_version, 0)
                # mark against the replica's LAST PUBLISHED position so a
                # later snapshot (fresh epoch after restart, or the seq
                # advancing past the death) clears it
                if self.aggregator is not None:
                    try:
                        for row in self.aggregator.workers():
                            if row["worker"] == replica_id:
                                e.dead_mark = (row.get("epoch"),
                                               int(row.get("seq") or 0))
                                break
                    except Exception:
                        pass
                else:
                    e.dead_mark = (None, 0)
        logger.warning("fleet router: failover off %s (%s): %s",
                       replica_id, reason, exc)

    # -------------------------------------------------------------- submit
    def submit(self, prompt: Sequence[int], max_new_tokens: int = 32, *,
               session_id: Optional[str] = None,
               trace_id: Optional[str] = None,
               **gen_kw) -> "FleetRequest":
        """Place and submit; returns a handle whose ``stream()`` /
        ``result()`` transparently fail over while nothing has been
        streamed yet."""
        tid = trace_id or new_trace_id()
        return FleetRequest(self, list(prompt), int(max_new_tokens),
                            gen_kw, session_id, tid)

    # ------------------------------------------------------------ sessions
    def pin_session(self, session_id: str, prompt: Sequence[int]) -> str:
        """Pin a conversation: place its prefix, ``pin_prefix`` it on the
        chosen replica, and bind the session so later ``submit``s with
        this ``session_id`` stick there.  Returns the replica id."""
        placement = self.place(prompt, session_id=session_id)
        rid = placement.replica_id
        self._release(rid)   # pin itself is not an in-flight request
        pin_id = None
        try:
            pin_id = self._entry(rid).handle.pin_prefix(list(prompt))
        except Exception:
            logger.warning("fleet router: pin_prefix failed on %s "
                           "(session sticks unpinned)", rid, exc_info=True)
        with self._lock:
            self._sessions[session_id] = {
                "replica": rid, "pin_id": pin_id,
                "prompt": tuple(int(t) for t in prompt)}
        return rid

    def release_session(self, session_id: str) -> None:
        with self._lock:
            bound = self._sessions.pop(session_id, None)
        if bound and bound["pin_id"] is not None:
            try:
                self._entry(bound["replica"]).handle.unpin_prefix(
                    bound["pin_id"])
            except Exception:
                pass

    def session_replica(self, session_id: str) -> Optional[str]:
        with self._lock:
            bound = self._sessions.get(session_id)
            return bound["replica"] if bound else None

    def _rebind_session(self, session_id: str, replica_id: str) -> None:
        """Re-pin a session on the survivor after its replica died: bind
        immediately (stickiness must not lapse), re-pin best-effort (the
        prefix pages re-enter the survivor's tree on first decode)."""
        with self._lock:
            bound = self._sessions.get(session_id)
            if bound is None or bound["replica"] == replica_id:
                return
            prompt = bound["prompt"]
            bound.update(replica=replica_id, pin_id=None)
        try:
            pin_id = self._entry(replica_id).handle.pin_prefix(list(prompt))
            with self._lock:
                bound = self._sessions.get(session_id)
                if bound is not None and bound["replica"] == replica_id:
                    bound["pin_id"] = pin_id
        except Exception:
            logger.warning("fleet router: re-pin failed on %s", replica_id,
                           exc_info=True)


class FleetRequest:
    """One routed request.  Failover contract: a replica failure BEFORE
    the first streamed token is retried on a survivor (RetryPolicy
    backoff, failover metrics, session re-bind); a failure AFTER tokens
    flowed is terminal — replaying would duplicate client-visible
    output.  Queue-full rejections try another replica without marking
    the busy one dead."""

    def __init__(self, router: FleetRouter, prompt: List[int],
                 max_new_tokens: int, gen_kw: Dict[str, Any],
                 session_id: Optional[str], trace_id: str):
        self.router = router
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.gen_kw = gen_kw
        self.session_id = session_id
        self.trace_id = trace_id
        self.tokens: List[int] = []
        self.failovers = 0
        self.placements: List[Placement] = []
        self.replica_id: Optional[str] = None
        self.finish_reason: Optional[str] = None
        self.error: Optional[BaseException] = None
        self._handle = None
        self._exclude: set = set()
        self._done = False
        self._submit()

    # one placement + submit attempt, driven by RetryPolicy.run so
    # backoff, retry metrics, and flight events all come from the RetryPolicy
    def _submit(self) -> None:
        def attempt():
            placement = self.router.place(
                self.prompt, session_id=self.session_id,
                exclude=self._exclude, trace_id=self.trace_id)
            rid = placement.replica_id
            try:
                handle = self.router._entry(rid).handle.submit(
                    self.prompt, self.max_new_tokens,
                    trace_id=self.trace_id, **self.gen_kw)
            except BaseException as exc:
                self.router._release(rid)
                reason = _failover_reason(exc)
                if reason is not None:
                    self.failovers += 1
                    self.router._record_failover(reason, rid, exc)
                    self._exclude.add(rid)
                raise
            return placement, handle

        placement, handle = self.router.retry_policy.run(
            attempt, description="fleet submit",
            context={"trace_id": self.trace_id})
        self.placements.append(placement)
        self.replica_id = placement.replica_id
        self._handle = handle
        if self.session_id is not None:
            self.router._rebind_session(self.session_id, self.replica_id)

    def cancel(self) -> None:
        if self._handle is not None:
            try:
                self._handle.cancel()
            except Exception:
                pass

    def stream(self, timeout: Optional[float] = None):
        """Yield token ids; fails over while the stream is untouched."""
        while True:
            rid, h = self.replica_id, self._handle
            try:
                for tok in h.stream(timeout=timeout):
                    self.tokens.append(int(tok))
                    yield int(tok)
                self.finish_reason = (getattr(h, "finish_reason", None)
                                      or "length")
                self._finish(rid, ok=self.finish_reason in ("length", "stop"))
                return
            except GeneratorExit:
                # consumer abandoned the stream — not the replica's fault
                self.cancel()
                self.router._release(rid)
                self._done = True
                raise
            except BaseException as exc:
                reason = _failover_reason(exc)
                if (self.tokens or reason is None
                        or self.failovers >= self.router.retry_policy.max_retries):
                    self._finish(rid, ok=False, error=exc)
                    raise
                self.failovers += 1
                self.router._release(rid)
                self.router._record_failover(reason, rid, exc)
                self._exclude.add(rid)
                # seeded backoff before re-placing on a survivor
                time.sleep(self.router.retry_policy.delay(self.failovers - 1))
                self._submit()

    def result(self, timeout: Optional[float] = None) -> List[int]:
        """Consume the stream to completion (failover included)."""
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        for _ in self.stream(timeout=timeout):
            if deadline is not None and time.monotonic() > deadline:
                self.cancel()
                raise TimeoutError(
                    f"fleet request still running [trace {self.trace_id}]")
        return list(self.tokens)

    def _finish(self, replica_id: Optional[str], ok: bool,
                error: Optional[BaseException] = None) -> None:
        if self._done:
            return
        self._done = True
        self.error = error
        if replica_id is not None:
            self.router._release(replica_id)
            self.router._note_outcome(replica_id, ok)

    def as_dict(self) -> Dict[str, Any]:
        return {"trace_id": self.trace_id, "replica": self.replica_id,
                "tokens": len(self.tokens), "failovers": self.failovers,
                "finish_reason": self.finish_reason,
                "placements": [p.as_dict() for p in self.placements]}
