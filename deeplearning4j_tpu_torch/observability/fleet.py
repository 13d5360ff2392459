"""Fleet telemetry plane: cross-process metrics federation + decode SLOs.

Every telemetry consumer so far (``/metrics``, ``/health``,
``HealthEvaluator``, the bench snapshots) reads one in-process
``MetricsRegistry``.  Multi-host training and an N-replica serving fleet
need one process to see N: this module makes registry
state travel.

- ``TelemetryPublisher`` serializes a bounded, schema-versioned snapshot
  of the local registry (counters as monotonic totals, gauges, histogram
  bucket arrays) plus the local health verdict, arbitrary worker state,
  the prefix-cache stats surface, and the SLO tracker onto a
  ``MessageBroker`` topic at a configurable interval.  Snapshots carry a
  per-process ``epoch`` (fresh UUID per publisher) and a monotonically
  increasing ``seq`` so the aggregator can merge counters delta-safely
  across publisher restarts.
- ``FleetAggregator`` subscribes (local broker or the broker's HTTP
  long-poll transport), merges per-worker snapshots into a
  worker-labeled fleet registry, marks workers whose snapshots stop
  arriving as STALE after ``expire_after_s`` (their gauges are dropped
  rather than frozen-healthy; counters and histograms — being monotonic
  history — persist), and serves fleet-level ``GET /metrics``,
  ``GET /fleet`` (per-worker table + staleness + the router-facing
  prefix-cache stats), and a fleet-scoped ``GET /health``.
- ``SLOTracker`` computes TTFT- and ITL-attainment fractions against
  configurable targets plus goodput (requests/sec meeting BOTH SLOs,
  rolling window) — the decode-quality number a router places on.

Counter-epoch merge rules (documented in docs/observability.md "Fleet
telemetry"):  within one epoch, the merged total advances by
``new_total - last_total`` and replayed/reordered sequence numbers are
dropped; a NEW epoch (publisher restart) contributes its full totals on
top of the history already merged — no double-count, and no
reset-to-zero artifact.  Histograms merge the same way on their
(count, bucket_counts) arrays.

Copied from ``deeplearning4j_tpu/observability/fleet.py`` with its
imports pointed at the port's own ``health``, ``metrics`` and
``resilience.retry``.  It imports neither torch nor numpy: the
publisher reads host gauges only, on its own thread, so publishing
never waits on the card.  The wire form is the reference's, so either
package's aggregator ingests the other's snapshots.
"""

from __future__ import annotations

import json
import logging
import math
import threading
import time
import uuid
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from deeplearning4j_tpu_torch.observability.health import (
    HealthEvaluator, HealthRule, HealthVerdict,
)
from deeplearning4j_tpu_torch.observability.metrics import (
    DEFAULT_BUCKETS, MetricsRegistry, get_registry,
)

SCHEMA_VERSION = 1
DEFAULT_TOPIC = "fleet.telemetry"

_GOODPUT = "dl4j_decode_goodput_rps"
_ATTAIN = "dl4j_decode_slo_attainment"
_WORKERS = "dl4j_fleet_workers"
_STALE = "dl4j_fleet_stale_workers"
_AGE = "dl4j_fleet_snapshot_age_seconds"
_SNAPSHOTS = "dl4j_fleet_snapshots_total"
_SKIPS = "dl4j_fleet_merge_skips_total"
_LAG = "dl4j_fleet_ingest_lag_seconds"
_PUBLISH = "dl4j_fleet_publish_seconds"
_BYTES = "dl4j_fleet_snapshot_bytes"

_H_SNAPSHOTS = ("Telemetry snapshots merged into the fleet view, per "
                "publishing worker")
_H_SKIPS = ("Snapshots or snapshot fragments the aggregator dropped "
            "instead of raising (reason: parse/schema/fields/replay/"
            "family/export)")

logger = logging.getLogger("deeplearning4j_tpu_torch.observability")

_WARN_INTERVAL_S = 30.0


def _finite(v: Any) -> Optional[float]:
    """float(v) if finite else None — NaN/Inf gauges must not poison a
    strict-JSON snapshot (json.dumps(allow_nan=False))."""
    try:
        f = float(v)
    except (TypeError, ValueError):
        return None
    return f if math.isfinite(f) else None


def _num(v: Any) -> Optional[float]:
    """A finite number from the wire, or None (bools excluded)."""
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        return None
    return float(v) if math.isfinite(v) else None


def _quantile(values: Sequence[float], q: float) -> float:
    vs = sorted(values)
    if not vs:
        return float("nan")
    pos = q * (len(vs) - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(vs) - 1)
    return vs[lo] + (vs[hi] - vs[lo]) * (pos - lo)


class _RateLimitedWarn:
    """One warning per key per _WARN_INTERVAL_S — a wedged peer must not
    turn the log into a firehose."""

    def __init__(self):
        self._lock = threading.Lock()
        self._last: Dict[str, float] = {}

    def __call__(self, key: str, msg: str) -> None:
        now = time.monotonic()
        with self._lock:
            last = self._last.get(key)
            if last is not None and now - last < _WARN_INTERVAL_S:
                return
            self._last[key] = now
        logger.warning(msg)


# -------------------------------------------------------------------- SLOs
class SLOTracker:
    """Per-request SLO attainment + goodput for one generation engine.

    A finished request is GOOD when it completed normally AND its TTFT is
    within ``ttft_target_s`` AND the p95 of its inter-token latencies is
    within ``itl_target_s`` (a request short enough to have no
    inter-token gaps passes the ITL leg vacuously).  Goodput is good
    requests per second over a rolling ``goodput_window_s`` window —
    the TTFT/TBT goodput framing of continuous-batching serving.

    Owns the ``dl4j_decode_goodput_rps{engine}`` and
    ``dl4j_decode_slo_attainment{engine,slo}`` gauge families (lazy:
    resolved at scrape time, nothing on the decode hot path).
    """

    def __init__(self, ttft_target_s: float = 0.2,
                 itl_target_s: float = 0.05,
                 goodput_window_s: float = 30.0,
                 registry: Optional[MetricsRegistry] = None,
                 engine_id: str = "engine"):
        reg = registry if registry is not None else get_registry()
        self.ttft_target_s = float(ttft_target_s)
        self.itl_target_s = float(itl_target_s)
        self.goodput_window_s = float(goodput_window_s)
        self.engine_id = str(engine_id)
        self._lock = threading.Lock()
        self.finished = 0
        self.ttft_met = 0
        self.itl_met = 0
        self.good_total = 0
        self._good_times: deque = deque()
        reg.gauge(
            _GOODPUT, "Requests per second finishing while meeting BOTH "
            "the TTFT and inter-token-latency SLO targets (rolling "
            "window)", labels=("engine",)
        ).set_function(self.goodput_rps, engine=self.engine_id)
        attain = reg.gauge(
            _ATTAIN, "Fraction of finished generation requests meeting "
            "the labeled SLO leg (ttft | itl | both) against the "
            "configured targets", labels=("engine", "slo"))
        attain.set_function(self.ttft_attainment,
                            engine=self.engine_id, slo="ttft")
        attain.set_function(self.itl_attainment,
                            engine=self.engine_id, slo="itl")
        attain.set_function(self.good_attainment,
                            engine=self.engine_id, slo="both")

    def observe_request(self, *, ttft_s: Optional[float],
                        itl_s: Optional[Sequence[float]] = None,
                        completed: bool = True,
                        now: Optional[float] = None) -> bool:
        """Record one finished request; returns whether it was good."""
        itl = [float(x) for x in (itl_s or ())]
        ttft_ok = ttft_s is not None and float(ttft_s) <= self.ttft_target_s
        itl_ok = (not itl) or _quantile(itl, 0.95) <= self.itl_target_s
        good = bool(completed) and ttft_ok and itl_ok
        now = time.monotonic() if now is None else float(now)
        with self._lock:
            self.finished += 1
            if ttft_ok:
                self.ttft_met += 1
            if itl_ok:
                self.itl_met += 1
            if good:
                self.good_total += 1
                self._good_times.append(now)
            self._prune(now)
        return good

    def _prune(self, now: float) -> None:
        cutoff = now - self.goodput_window_s
        # every caller (observe_request, goodput_rps) holds self._lock
        # dl4jlint: disable-next-line=lock-discipline -- callers hold _lock
        while self._good_times and self._good_times[0] < cutoff:
            self._good_times.popleft()

    def goodput_rps(self, now: Optional[float] = None) -> float:
        now = time.monotonic() if now is None else float(now)
        with self._lock:
            self._prune(now)
            return len(self._good_times) / self.goodput_window_s

    def _frac(self, attr: str) -> float:
        with self._lock:
            met = getattr(self, attr)
            return met / self.finished if self.finished else float("nan")

    def ttft_attainment(self) -> float:
        return self._frac("ttft_met")

    def itl_attainment(self) -> float:
        return self._frac("itl_met")

    def good_attainment(self) -> float:
        return self._frac("good_total")

    def as_dict(self) -> Dict[str, Any]:
        """JSON-safe summary (rides in the federated snapshot)."""
        with self._lock:
            finished = self.finished
            good = self.good_total
            ttft_met, itl_met = self.ttft_met, self.itl_met
        return {
            "targets": {"ttft_s": self.ttft_target_s,
                        "itl_p95_s": self.itl_target_s,
                        "goodput_window_s": self.goodput_window_s},
            "finished": finished,
            "good_total": good,
            "ttft_attainment": ttft_met / finished if finished else None,
            "itl_attainment": itl_met / finished if finished else None,
            "good_attainment": good / finished if finished else None,
            "goodput_rps": self.goodput_rps(),
        }


# -------------------------------------------------------------- publisher
class TelemetryPublisher:
    """Publishes bounded, schema-versioned registry snapshots to a topic.

    Transport is the existing ``MessageBroker``: pass ``broker=`` for an
    in-process broker or ``url=`` for a remote one exposed via
    ``MessageBroker.serve()`` (POST ``/publish/<topic>``).  With neither,
    ``snapshot()`` still works (tests, bench probes).

    Reads ONLY host-side state: counters/gauges/histograms are plain
    Python numbers, prefix-cache stats and the SLO tracker are host
    dicts, and lazy gauges holding device scalars resolve through the
    registry's scrape-time ``float()`` exactly like ``/metrics`` does —
    publishing never adds a device->host sync to the decode loop.
    """

    def __init__(self, worker_id: str, *, broker=None,
                 url: Optional[str] = None, topic: str = DEFAULT_TOPIC,
                 interval_s: float = 2.0,
                 registry: Optional[MetricsRegistry] = None,
                 health: Optional[HealthEvaluator] = None,
                 state_fn: Optional[Callable[[], Dict[str, Any]]] = None,
                 prefix_cache=None,
                 slo: Optional[SLOTracker] = None,
                 max_samples_per_family: int = 64,
                 timeout: float = 5.0, retry_policy=None):
        if broker is not None and url is not None:
            raise ValueError("pass broker= or url=, not both")
        self.worker_id = str(worker_id)
        self.broker = broker
        self.url = url.rstrip("/") if url else None
        self.topic = topic
        self.interval_s = float(interval_s)
        self.timeout = float(timeout)
        self.health = health
        self.state_fn = state_fn
        self.prefix_cache = prefix_cache
        self.slo = slo
        self.max_samples_per_family = int(max_samples_per_family)
        self.epoch = uuid.uuid4().hex[:12]
        self.seq = 0
        self._registry = registry
        self._warn = _RateLimitedWarn()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        reg = registry if registry is not None else get_registry()
        self._m_publish = reg.histogram(
            _PUBLISH, "Wall time to serialize and publish one telemetry "
            "snapshot")
        self._m_bytes = reg.gauge(
            _BYTES, "Serialized size of the most recently published "
            "telemetry snapshot")
        # publish-loop hygiene (RetryPolicy): a transient broker /
        # aggregator outage backs off and resumes instead of warning
        # every period — load-bearing now that the fleet router reads
        # snapshot liveness as a membership signal.  Backoff sleeps go
        # through the stop event so stop() never waits out a retry.
        if retry_policy is None:
            from deeplearning4j_tpu_torch.resilience.retry import RetryPolicy
            retry_policy = RetryPolicy(
                max_retries=3, base_delay_s=min(0.25, self.interval_s),
                max_delay_s=max(2.0, self.interval_s),
                component="telemetry", registry=reg,
                sleep=self._stop.wait)
        self.retry_policy = retry_policy

    # ------------------------------------------------------------ snapshot
    def _prefix_cache_stats(self) -> Optional[Dict[str, Any]]:
        pc = self.prefix_cache
        if pc is None:
            return None
        try:
            stats = pc() if callable(pc) else pc.stats()
        except Exception as e:
            self._warn("pc", f"prefix-cache stats failed: {e!r}")
            return None
        return stats if isinstance(stats, dict) else None

    def snapshot(self) -> Dict[str, Any]:
        """One bounded, JSON-safe view of the local telemetry state."""
        reg = self._registry if self._registry is not None else get_registry()
        self.seq += 1
        health = None
        if self.health is not None:
            try:
                # evaluate FIRST so the mirrored dl4j_health_status gauge
                # in the registry walk below is this verdict, not the last
                health = self.health.evaluate().to_dict()
            except Exception as e:
                self._warn("health", f"health evaluation failed: {e!r}")
        state = None
        if self.state_fn is not None:
            try:
                state = self.state_fn()
                if not isinstance(state, dict):
                    state = None
            except Exception as e:
                self._warn("state", f"state_fn failed: {e!r}")
        families: Dict[str, Any] = {}
        truncated = 0
        for fam in reg.families():
            pairs = fam.samples()
            if len(pairs) > self.max_samples_per_family:
                truncated += len(pairs) - self.max_samples_per_family
                pairs = pairs[:self.max_samples_per_family]
            samples = []
            for label_pairs, child in pairs:
                labels = {str(k): str(v) for k, v in label_pairs}
                if fam.kind == "histogram":
                    hs = child.snapshot()
                    samples.append({
                        "labels": labels,
                        "count": int(hs["count"]),
                        "sum": _finite(hs["sum"]) or 0.0,
                        "min": _finite(hs["min"]),
                        "max": _finite(hs["max"]),
                        "bucket_counts": [int(c) for c in
                                          hs["bucket_counts"]],
                    })
                else:
                    samples.append({"labels": labels,
                                    "value": _finite(child.value)})
            if not samples:
                continue
            fd: Dict[str, Any] = {
                "kind": fam.kind, "help": fam.help,
                "label_names": list(fam.label_names),
                "samples": samples,
            }
            if fam.kind == "histogram":
                fd["buckets"] = [float(b) for b in fam._buckets]
            families[fam.name] = fd
        snap: Dict[str, Any] = {
            "schema": SCHEMA_VERSION,
            "worker": self.worker_id,
            "epoch": self.epoch,
            "seq": self.seq,
            "ts": time.time(),
            "families": families,
        }
        if truncated:
            snap["truncated_samples"] = truncated
        if health is not None:
            snap["health"] = health
        if state is not None:
            snap["state"] = state
        pc = self._prefix_cache_stats()
        if pc is not None:
            snap["prefix_cache"] = pc
        if self.slo is not None:
            snap["slo"] = self.slo.as_dict()
        return snap

    # ------------------------------------------------------------- publish
    def serialize(self) -> str:
        """Deterministic wire form (sorted keys; NaN already mapped to
        null by the snapshot walk, so the strict encoder never trips)."""
        return json.dumps(self.snapshot(), sort_keys=True, allow_nan=False)

    def _send(self, payload: str) -> int:
        """Raw transport send; raises on failure."""
        if self.broker is not None:
            return self.broker.publish(self.topic, payload)
        if self.url is not None:
            import urllib.request

            req = urllib.request.Request(
                f"{self.url}/publish/{self.topic}",
                data=payload.encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req,
                                        timeout=self.timeout) as resp:
                return int(json.loads(resp.read().decode()
                                      or '{"delivered": 0}')
                           .get("delivered", 0))
        return 0

    def publish_once(self) -> int:
        """Serialize + publish one snapshot; delivered-subscriber count
        (HTTP: the broker's count), -1 on any failure — the decode/train
        loop must never die because telemetry could not flush."""
        t0 = time.perf_counter()
        try:
            payload = self.serialize()
        except Exception as e:
            self._warn("snapshot", f"snapshot serialization failed: {e!r}")
            return -1
        self._m_bytes.set(float(len(payload)))
        try:
            return self._send(payload)
        except Exception as e:
            self._warn("publish", f"telemetry publish failed: {e!r}")
            return -1
        finally:
            self._m_publish.observe(time.perf_counter() - t0)

    def _publish_strict(self) -> int:
        """``publish_once`` minus the swallow, for the retrying publish
        loop: serialization failures raise AS-IS (a snapshot that cannot
        serialize is a deterministic bug — fatal to the RetryPolicy, so
        it surfaces instead of backing off), transport outages raise
        ``TransientError`` (including broker-side 5xx, which the message
        classification alone would call fatal)."""
        from deeplearning4j_tpu_torch.resilience.retry import (
            TransientError, is_transient)

        t0 = time.perf_counter()
        payload = self.serialize()
        self._m_bytes.set(float(len(payload)))
        try:
            return self._send(payload)
        except Exception as e:
            code = getattr(e, "code", None)
            if is_transient(e) or (isinstance(code, int) and code >= 500):
                raise TransientError(
                    f"telemetry publish failed: {e!r}") from e
            raise
        finally:
            self._m_publish.observe(time.perf_counter() - t0)

    def start(self) -> "TelemetryPublisher":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name=f"telemetry-pub-{self.worker_id}",
            daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        # first snapshot immediately, not after a wait; every period then
        # rides the RetryPolicy — transient outages back off (stop-event
        # interruptible) and resume, anything past the retry budget (or
        # fatal outright) surfaces once per warn interval and the loop
        # carries on at the next period
        first = True
        while True:
            if not first and self._stop.wait(self.interval_s):
                return
            first = False
            if self._stop.is_set():
                return
            try:
                self.retry_policy.run(self._publish_strict,
                                      description="telemetry publish",
                                      context={"worker": self.worker_id})
            except Exception as e:
                self._warn("publish",
                           f"telemetry publish failed after retries: {e!r}")

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=self.timeout + 5.0)
        self._thread = None


# ------------------------------------------------------------- aggregator
class _WorkerView:
    """Merged state for one publishing worker."""

    __slots__ = ("worker", "epoch", "seq", "last_recv", "last_ts",
                 "snapshots", "truncated", "meta", "counters",
                 "counter_last", "hists", "hist_last", "gauges",
                 "health", "state", "prefix_cache", "slo")

    def __init__(self, worker: str):
        self.worker = worker
        self.epoch: Optional[str] = None
        self.seq = 0
        self.last_recv = time.monotonic()
        self.last_ts: Optional[float] = None
        self.snapshots = 0
        self.truncated = 0
        # family -> {"kind","help","label_names","buckets"}
        self.meta: Dict[str, Dict[str, Any]] = {}
        # family -> {label_values_tuple -> merged cumulative total}
        self.counters: Dict[str, Dict[Tuple[str, ...], float]] = {}
        # family -> {key -> last raw total seen in the CURRENT epoch}
        self.counter_last: Dict[str, Dict[Tuple[str, ...], float]] = {}
        self.hists: Dict[str, Dict[Tuple[str, ...], Dict[str, Any]]] = {}
        self.hist_last: Dict[str, Dict[Tuple[str, ...], Dict[str, Any]]] = {}
        self.gauges: Dict[str, Dict[Tuple[str, ...], float]] = {}
        self.health: Optional[Dict[str, Any]] = None
        self.state: Optional[Dict[str, Any]] = None
        self.prefix_cache: Optional[Dict[str, Any]] = None
        self.slo: Optional[Dict[str, Any]] = None


class FleetAggregator:
    """Merges per-worker telemetry snapshots into one fleet view.

    Ingest is forward-compatible by construction: unparseable messages,
    unknown schema versions, missing fields, and malformed family
    fragments are counted in ``dl4j_fleet_merge_skips_total{reason}``
    and logged (rate-limited) — never raised.  Unknown EXTRA keys are
    ignored, so newer publishers can talk to an older aggregator.

    The fleet registry is rebuilt from the merged books on every read
    (``registry()``): each worker's families come back worker-labeled,
    STALE workers (no snapshot for ``expire_after_s``) contribute their
    monotonic counters/histograms but NOT their gauges — a dead worker
    must never look frozen-healthy.  Families that already declare a
    ``worker`` label keep it and gain an ``origin`` label instead.
    """

    FLEET_LABEL = "worker"

    def __init__(self, *, broker=None, url: Optional[str] = None,
                 topic: str = DEFAULT_TOPIC, expire_after_s: float = 10.0,
                 rules: Sequence[HealthRule] = (),
                 min_workers: int = 0,
                 registry: Optional[MetricsRegistry] = None,
                 timeout: float = 5.0):
        if broker is not None and url is not None:
            raise ValueError("pass broker= or url=, not both")
        self.broker = broker
        self.url = url.rstrip("/") if url else None
        self.topic = topic
        self.expire_after_s = float(expire_after_s)
        self.rules = list(rules)
        self.min_workers = int(min_workers)
        self.timeout = float(timeout)
        self._lock = threading.Lock()
        self._workers: Dict[str, _WorkerView] = {}
        self._warn = _RateLimitedWarn()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._queue = None
        self._sub_id = uuid.uuid4().hex[:8]
        self._httpd = None
        self._http_thread: Optional[threading.Thread] = None
        reg = registry if registry is not None else get_registry()
        self._m_snapshots = reg.counter(_SNAPSHOTS, _H_SNAPSHOTS,
                                        labels=("worker",))
        self._m_skips = reg.counter(_SKIPS, _H_SKIPS, labels=("reason",))
        self._m_lag = reg.histogram(
            _LAG, "Wall-clock delay between a snapshot's publish "
            "timestamp and its ingestion by the fleet aggregator")
        self._skips: Dict[str, int] = {}

    # -------------------------------------------------------------- ingest
    def _skip(self, reason: str, detail: str = "") -> None:
        with self._lock:
            self._skips[reason] = self._skips.get(reason, 0) + 1
        self._m_skips.inc(reason=reason)
        if detail:
            self._warn(f"skip:{reason}",
                       f"fleet snapshot dropped ({reason}): {detail}")

    def ingest(self, message: str) -> bool:
        """Merge one wire snapshot; False (never an exception) on drop."""
        try:
            snap = json.loads(message)
        except Exception as e:
            self._skip("parse", repr(e))
            return False
        if not isinstance(snap, dict):
            self._skip("parse", f"non-object snapshot: {type(snap).__name__}")
            return False
        if snap.get("schema") != SCHEMA_VERSION:
            self._skip("schema",
                       f"schema={snap.get('schema')!r} from "
                       f"worker={snap.get('worker')!r}, "
                       f"want {SCHEMA_VERSION}")
            return False
        worker = snap.get("worker")
        if not worker or not isinstance(worker, str):
            self._skip("fields", "snapshot without a worker id")
            return False
        epoch = str(snap.get("epoch") or "")
        seq_n = _num(snap.get("seq"))
        if seq_n is None:
            # defaulting would pin the worker at seq 0 and drop every
            # later same-epoch snapshot as a replay
            self._skip("fields",
                       f"snapshot from {worker!r} without a numeric seq")
            return False
        seq = int(seq_n)
        now = time.monotonic()
        # skips found under the lock are emitted after release: _skip
        # re-acquires self._lock, so calling it here would deadlock
        pending_skips: List[Tuple[str, str]] = []
        with self._lock:
            ws = self._workers.get(worker)
            if ws is None:
                ws = self._workers[worker] = _WorkerView(worker)
            if epoch == ws.epoch and seq <= ws.seq:
                replay = True
                pending_skips.append(
                    ("replay", f"worker {worker} epoch {epoch} seq "
                               f"{seq} <= {ws.seq}"))
            else:
                replay = False
                new_epoch = epoch != ws.epoch
                if new_epoch:
                    # restart: the next totals are a fresh base, the old
                    # merged history stays — delta-safe by construction
                    ws.counter_last = {}
                    ws.hist_last = {}
                fams = snap.get("families")
                if isinstance(fams, dict):
                    for name, fd in fams.items():
                        try:
                            self._merge_family(ws, str(name), fd)
                        except Exception as e:
                            pending_skips.append(
                                ("family", f"family {name!r} from "
                                           f"{worker}: {e!r}"))
                ws.epoch, ws.seq = epoch, seq
                ws.last_recv = now
                ws.snapshots += 1
                ws.last_ts = _num(snap.get("ts"))
                ws.truncated = int(_num(snap.get("truncated_samples")) or 0)
                for attr in ("health", "state", "prefix_cache", "slo"):
                    val = snap.get(attr)
                    setattr(ws, attr, val if isinstance(val, dict) else None)
        for reason, detail in pending_skips:
            self._skip(reason, detail)
        if replay:
            return False
        self._m_snapshots.inc(worker=worker)
        if ws.last_ts is not None:
            lag = time.time() - ws.last_ts
            if 0 <= lag < 3600:
                self._m_lag.observe(lag)
        return True

    def _merge_family(self, ws: _WorkerView, name: str, fd: Any) -> None:
        if not isinstance(fd, dict):
            return
        kind = fd.get("kind")
        if kind not in ("counter", "gauge", "histogram"):
            return
        label_names = tuple(str(x) for x in (fd.get("label_names") or ()))
        buckets = tuple(float(b) for b in (fd.get("buckets") or ())
                        if _num(b) is not None)
        meta = ws.meta.get(name)
        if (meta is None or meta["kind"] != kind
                or meta["label_names"] != label_names
                or (kind == "histogram" and meta["buckets"] != buckets)):
            # first sight, or re-registered with a different shape:
            # restart this family's books (shape changes can't be added)
            for book in (ws.counters, ws.counter_last, ws.hists,
                         ws.hist_last, ws.gauges):
                book.pop(name, None)
            meta = ws.meta[name] = {"kind": kind,
                                    "help": str(fd.get("help") or ""),
                                    "label_names": label_names,
                                    "buckets": buckets}
        else:
            meta["help"] = str(fd.get("help") or meta["help"])
        samples = fd.get("samples")
        if not isinstance(samples, list):
            return
        if kind == "gauge":
            # snapshots carry full gauge state: replace the family's
            # book wholesale so label-sets that stop appearing (e.g.
            # truncated away) don't stay frozen at their last value
            book: Dict[Tuple[str, ...], float] = {}
            for s in samples:
                if not isinstance(s, dict):
                    continue
                labels = s.get("labels")
                labels = labels if isinstance(labels, dict) else {}
                key = tuple(str(labels.get(k, "")) for k in label_names)
                v = _num(s.get("value"))
                if v is not None:
                    book[key] = v
            if book:
                ws.gauges[name] = book
            else:
                ws.gauges.pop(name, None)
            return
        for s in samples:
            if not isinstance(s, dict):
                continue
            labels = s.get("labels")
            labels = labels if isinstance(labels, dict) else {}
            key = tuple(str(labels.get(k, "")) for k in label_names)
            if kind == "counter":
                v = _num(s.get("value"))
                if v is None or v < 0:
                    continue
                book = ws.counters.setdefault(name, {})
                last = ws.counter_last.setdefault(name, {})
                prev = last.get(key)
                # same-epoch advance merges the delta; an unseen key or
                # an in-epoch regression (shouldn't happen — counters are
                # monotonic) contributes the full total as a fresh base
                delta = v if (prev is None or v < prev) else v - prev
                book[key] = book.get(key, 0.0) + delta
                last[key] = v
            else:  # histogram
                cnt = _num(s.get("count"))
                sm = _num(s.get("sum"))
                counts = s.get("bucket_counts")
                if (cnt is None or sm is None
                        or not isinstance(counts, list)
                        or len(counts) != len(buckets)):
                    continue
                counts = [int(c) for c in counts
                          if _num(c) is not None and c >= 0]
                if len(counts) != len(buckets):
                    continue
                cnt = int(cnt)
                book = ws.hists.setdefault(name, {})
                last = ws.hist_last.setdefault(name, {})
                prev = last.get(key)
                fresh = (prev is None or cnt < prev["count"]
                         or any(c < p for c, p in zip(counts,
                                                      prev["counts"])))
                if fresh:
                    d_sum, d_cnt, d_counts = sm, cnt, counts
                else:
                    d_sum = sm - prev["sum"]
                    d_cnt = cnt - prev["count"]
                    d_counts = [c - p for c, p in zip(counts,
                                                      prev["counts"])]
                cur = book.get(key)
                mn, mx = _num(s.get("min")), _num(s.get("max"))
                if cur is None:
                    book[key] = {"sum": d_sum, "count": d_cnt,
                                 "counts": list(d_counts),
                                 "min": mn, "max": mx}
                else:
                    cur["sum"] += d_sum
                    cur["count"] += d_cnt
                    cur["counts"] = [a + b for a, b in
                                     zip(cur["counts"], d_counts)]
                    if mn is not None:
                        cur["min"] = mn if cur["min"] is None \
                            else min(cur["min"], mn)
                    if mx is not None:
                        cur["max"] = mx if cur["max"] is None \
                            else max(cur["max"], mx)
                last[key] = {"sum": sm, "count": cnt,
                             "counts": list(counts)}

    # --------------------------------------------------------------- reads
    def _is_stale(self, ws: _WorkerView, now: float) -> bool:
        return (now - ws.last_recv) > self.expire_after_s

    def registry(self) -> MetricsRegistry:
        """Rebuild the worker-labeled fleet registry from the merged
        books (fresh object per call: gauge dropping for stale workers
        falls out of the rebuild instead of needing deletion support)."""
        reg = MetricsRegistry()
        now = time.monotonic()
        with self._lock:
            views = sorted(self._workers.values(), key=lambda w: w.worker)
            n_stale = 0
            for ws in views:
                stale = self._is_stale(ws, now)
                n_stale += int(stale)
                for name, meta in ws.meta.items():
                    fleet_label = (self.FLEET_LABEL
                                   if self.FLEET_LABEL
                                   not in meta["label_names"] else "origin")
                    label_names = meta["label_names"] + (fleet_label,)
                    try:
                        if meta["kind"] == "counter":
                            fam = reg.counter(name, meta["help"],
                                              labels=label_names)
                            for key, total in (ws.counters.get(name)
                                               or {}).items():
                                labels = dict(zip(meta["label_names"], key))
                                labels[fleet_label] = ws.worker
                                fam.labels(**labels).inc(total)
                        elif meta["kind"] == "gauge":
                            if stale:
                                continue
                            fam = reg.gauge(name, meta["help"],
                                            labels=label_names)
                            for key, v in (ws.gauges.get(name)
                                           or {}).items():
                                labels = dict(zip(meta["label_names"], key))
                                labels[fleet_label] = ws.worker
                                fam.labels(**labels).set(v)
                        else:
                            if not meta["buckets"]:
                                continue
                            fam = reg.histogram(name, meta["help"],
                                                labels=label_names,
                                                buckets=meta["buckets"])
                            for key, cur in (ws.hists.get(name)
                                             or {}).items():
                                labels = dict(zip(meta["label_names"], key))
                                labels[fleet_label] = ws.worker
                                fam.labels(**labels).restore(
                                    bucket_counts=cur["counts"],
                                    sum=cur["sum"], count=cur["count"],
                                    min=cur["min"], max=cur["max"])
                    except ValueError as e:
                        # cross-worker family shape conflict: first
                        # registration wins, the loser is counted
                        self._skips["export"] = \
                            self._skips.get("export", 0) + 1
                        self._warn(f"export:{name}",
                                   f"family {name!r} from {ws.worker} "
                                   f"conflicts with an already-exported "
                                   f"shape: {e!r}")
            reg.gauge(
                _WORKERS, "Workers currently publishing fresh telemetry "
                "snapshots into the fleet aggregator"
            ).set(float(len(views) - n_stale))
            reg.gauge(
                _STALE, "Workers whose snapshots stopped arriving for "
                "longer than expire_after_s (their gauges are dropped "
                "from the fleet view)"
            ).set(float(n_stale))
            age = reg.gauge(
                _AGE, "Seconds since the last snapshot was received from "
                "the labeled worker", labels=("worker",))
            snaps = reg.counter(_SNAPSHOTS, _H_SNAPSHOTS,
                                labels=("worker",))
            for ws in views:
                age.set(now - ws.last_recv, worker=ws.worker)
                snaps.inc(ws.snapshots, worker=ws.worker)
            skips = reg.counter(_SKIPS, _H_SKIPS, labels=("reason",))
            for reason, n in sorted(self._skips.items()):
                skips.inc(n, reason=reason)
        return reg

    def workers(self) -> List[Dict[str, Any]]:
        """Per-worker table: staleness, merge bookkeeping, the last
        health verdict/SLO summary, and the router-facing prefix-cache
        stats (resident/pinned pages, host-tier bytes, hit rate, tree
        version tag) exactly as the worker published them."""
        now = time.monotonic()
        with self._lock:
            out = []
            for ws in sorted(self._workers.values(),
                             key=lambda w: w.worker):
                out.append({
                    "worker": ws.worker,
                    "stale": self._is_stale(ws, now),
                    "age_s": round(now - ws.last_recv, 3),
                    "epoch": ws.epoch,
                    "seq": ws.seq,
                    "snapshots": ws.snapshots,
                    "truncated_samples": ws.truncated,
                    "healthy": (ws.health or {}).get("healthy"),
                    "failing": (ws.health or {}).get("failing") or [],
                    "slo": ws.slo,
                    "prefix_cache": ws.prefix_cache,
                    "state": ws.state,
                })
        return out

    def fleet_table(self) -> Dict[str, Any]:
        with self._lock:
            skips = dict(self._skips)
        return {"topic": self.topic,
                "expire_after_s": self.expire_after_s,
                "workers": self.workers(),
                "merge_skips": skips}

    def evaluate_health(self, registry: Optional[MetricsRegistry] = None
                        ) -> HealthVerdict:
        """Fleet-scoped verdict over the rebuilt registry: the caller's
        extra rules plus built-in staleness/population/peer-health
        predicates that NAME the offending workers."""
        reg = registry if registry is not None else self.registry()
        now = time.monotonic()
        with self._lock:
            views = list(self._workers.values())
            stale = sorted(w.worker for w in views
                           if self._is_stale(w, now))
            fresh = [w for w in views if not self._is_stale(w, now)]
            unhealthy = sorted(
                w.worker for w in fresh
                if (w.health or {}).get("healthy") is False)
        rules = list(self.rules)

        def _fresh_rule(_):
            return (not stale, len(stale),
                    "stale workers: " + (", ".join(stale) or "none"))

        def _peers_rule(_):
            return (not unhealthy, len(unhealthy),
                    "unhealthy workers: " + (", ".join(unhealthy)
                                             or "none"))

        rules.append(HealthRule("workers_fresh", "predicate",
                                fn=_fresh_rule))
        rules.append(HealthRule("workers_healthy", "predicate",
                                fn=_peers_rule))
        if self.min_workers:
            def _population_rule(_):
                return (len(fresh) >= self.min_workers, len(fresh),
                        f"need >= {self.min_workers} fresh workers")
            rules.append(HealthRule("fleet_population", "predicate",
                                    fn=_population_rule))
        return HealthEvaluator(rules, component="fleet",
                               registry=reg).evaluate()

    # ------------------------------------------------------------ consume
    def start(self) -> "FleetAggregator":
        if self._thread is not None:
            return self
        if self.broker is not None and self._queue is None:
            self._queue = self.broker.subscribe(self.topic)
        self._stop.clear()
        self._thread = threading.Thread(target=self._drain,
                                        name="fleet-aggregator",
                                        daemon=True)
        self._thread.start()
        return self

    def _drain(self) -> None:
        import queue as _queue

        while not self._stop.is_set():
            if self._queue is not None:
                try:
                    msg = self._queue.get(timeout=0.25)
                except _queue.Empty:
                    continue
                self.ingest(msg)
            elif self.url is not None:
                try:
                    import urllib.request

                    url = (f"{self.url}/poll/{self.topic}"
                           f"?sub={self._sub_id}&timeout=1.0")
                    with urllib.request.urlopen(
                            url, timeout=self.timeout) as resp:
                        if resp.status == 204:
                            continue
                        self.ingest(resp.read().decode())
                except Exception as e:
                    self._warn("poll", f"fleet poll failed: {e!r}")
                    if self._stop.wait(0.5):
                        return
            else:
                # nothing to consume from; callers drive ingest() directly
                if self._stop.wait(0.25):
                    return

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.timeout + 5.0)
            self._thread = None
        if self.broker is not None and self._queue is not None:
            self.broker.unsubscribe(self.topic, self._queue)
            self._queue = None
        self.stop_server()

    # --------------------------------------------------------- HTTP surface
    def serve(self, port: int = 0) -> int:
        """Fleet endpoints: GET /metrics (worker-labeled Prometheus text
        incl. the mirrored fleet health gauge), GET /fleet (per-worker
        table), GET /health (fleet verdict; 503 when failing)."""
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        agg = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, code: int, body: bytes,
                      ctype: str = "application/json") -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.partition("?")[0]
                try:
                    if path == "/metrics":
                        reg = agg.registry()
                        agg.evaluate_health(registry=reg)
                        self._send(200, reg.to_prometheus().encode(),
                                   "text/plain; version=0.0.4")
                    elif path == "/fleet":
                        self._send(200, json.dumps(
                            agg.fleet_table()).encode())
                    elif path == "/health":
                        verdict = agg.evaluate_health()
                        self._send(200 if verdict.healthy else 503,
                                   json.dumps(verdict.to_dict()).encode())
                    else:
                        self.send_error(404)
                except Exception as e:  # a scrape must not kill the server
                    self._send(500, json.dumps({"error": repr(e)}).encode())

        self._httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)
        self._http_thread.start()
        return self._httpd.server_address[1]

    def stop_server(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._http_thread is not None:
            self._http_thread.join(timeout=5.0)
            self._http_thread = None


# ---------------------------------------------------------------- selftest
def _data_lines(reg: MetricsRegistry) -> str:
    """Prometheus text minus the aggregator's own meta families (their
    age/skip values move with the wall clock; the DATA must not)."""
    return "\n".join(
        ln for ln in reg.to_prometheus().splitlines()
        if "dl4j_fleet_" not in ln)


def schema_roundtrip_selftest(verbose: bool = False) -> int:
    """CI gate: serialize -> merge -> re-export must be bit-stable.

    Proves (1) the wire form is deterministic (sorted keys, two dumps of
    one state identical), (2) re-ingesting the SAME totals under a new
    sequence number changes nothing (no double-count), (3) a publisher
    restart (new epoch, totals reset) adds exactly the new totals on top
    of the merged history (no reset-to-zero artifact), and (4) the
    merged registry re-exports the original values exactly.
    Returns 0 on success, 1 with a message on failure — stdlib only, no
    jax/numpy, callable from scripts/ci_checks.py in a fast subprocess.
    """
    def say(msg):
        if verbose:
            print(f"  {msg}")

    try:
        # throwaway registry with selftest-only families: never exported
        # from a live process, so no docs/observability.md rows
        reg = MetricsRegistry()
        # dl4jlint: disable-next-line=metrics-docs -- selftest-only family
        reg.counter("dl4j_selftest_requests_total", "selftest counter",
                    labels=("status",)).inc(5, status="ok")
        reg.counter("dl4j_selftest_requests_total",
                    labels=("status",)).inc(2, status="error")
        # dl4jlint: disable-next-line=metrics-docs -- selftest-only family
        reg.gauge("dl4j_selftest_depth", "selftest gauge").set(3.25)
        # dl4jlint: disable-next-line=metrics-docs -- selftest-only family
        reg.gauge("dl4j_selftest_nan", "selftest NaN gauge").set(
            float("nan"))
        # dl4jlint: disable-next-line=metrics-docs -- selftest-only family
        hist = reg.histogram("dl4j_selftest_seconds", "selftest histogram",
                             buckets=(0.1, 1.0))
        for v in (0.05, 0.5, 0.7, 5.0):
            hist.observe(v)
        pub = TelemetryPublisher(
            "w0", registry=reg,
            prefix_cache=lambda: {"version": 7, "resident_pages": 3,
                                  "host_tier_bytes": 4096,
                                  "pinned_pages": 1, "hit_rate": 0.5})
        wire1 = pub.serialize()
        snap = json.loads(wire1)
        assert snap["schema"] == SCHEMA_VERSION, "schema version missing"
        assert snap["prefix_cache"]["version"] == 7, "prefix stats lost"
        nan_sample = snap["families"]["dl4j_selftest_nan"]["samples"][0]
        assert nan_sample["value"] is None, "NaN gauge must map to null"
        redump = json.dumps(json.loads(wire1), sort_keys=True,
                            allow_nan=False)
        assert redump == wire1, "wire form is not round-trip stable"
        say("wire form deterministic")

        agg = FleetAggregator(expire_after_s=3600.0,
                              registry=MetricsRegistry())
        assert agg.ingest(wire1), "first ingest rejected"
        out1 = _data_lines(agg.registry())
        assert 'dl4j_selftest_requests_total{status="ok",worker="w0"} 5' \
            in out1, f"counter not re-exported:\n{out1}"
        assert 'dl4j_selftest_depth{worker="w0"} 3.25' in out1, \
            "gauge not re-exported"
        assert 'dl4j_selftest_seconds_count{worker="w0"} 4' in out1, \
            "histogram count not re-exported"
        assert 'le="+Inf"' in out1, "histogram buckets not re-exported"

        # same totals again (new seq): the merged view must not move
        assert agg.ingest(pub.serialize()), "second ingest rejected"
        out2 = _data_lines(agg.registry())
        assert out2 == out1, ("re-merging unchanged totals changed the "
                              "fleet export (double-count)")
        say("idempotent under unchanged totals")

        # replayed seq: dropped
        assert not agg.ingest(wire1), "stale seq replay was accepted"

        # publisher restart: fresh epoch, totals reset below history
        reg2 = MetricsRegistry()
        reg2.counter("dl4j_selftest_requests_total", "selftest counter",
                     labels=("status",)).inc(3, status="ok")
        pub2 = TelemetryPublisher("w0", registry=reg2)
        assert agg.ingest(pub2.serialize()), "restart ingest rejected"
        out3 = _data_lines(agg.registry())
        assert 'dl4j_selftest_requests_total{status="ok",worker="w0"} 8' \
            in out3, ("epoch-aware merge wrong after restart "
                      f"(want 5+3=8):\n{out3}")
        say("epoch-aware restart merge exact")
        return 0
    except AssertionError as e:
        print(f"fleet schema round-trip selftest FAILED: {e}")
        return 1


if __name__ == "__main__":
    import sys

    sys.exit(schema_roundtrip_selftest(verbose=True))
