"""Cluster health: per-worker aggregation, straggler detection, SLO rules.

SparkNet (arxiv 1511.06051) and DeepSpark (arxiv 1602.08191) both observe
that synchronous distributed training runs at the speed of the SLOWEST
replica — so the first diagnostic question for "this 8-worker run is slow"
is *which worker*, and the reference stack answered it with Spark's
driver-side stage timing.  This module is that layer on top of the
telemetry core:

- ``WorkerTelemetry`` — what the training masters publish into: per-worker
  (or per-pipeline-stage) step time and throughput as labeled registry
  families, plus a rolling sample window per worker;
- ``StragglerDetector`` — flags a worker whose rolling median step time
  exceeds ``threshold`` x the cluster median, counts it in
  ``dl4j_stragglers_total{component,worker}``, and emits one rate-limited
  warning carrying the offending phase breakdown;
- ``ClusterStatsAggregator`` — merges per-worker snapshots (plain dicts,
  so they travel across processes as JSON) into one cluster view:
  mean/p50/p99/max step time, slowest worker id, total throughput;
- ``HealthEvaluator`` — declarative SLO rules (max step-time p99, max
  queue depth, min throughput, recompile budget, ...) evaluated against
  the registry; powers the ``GET /health`` endpoints on the inference
  server and the training UI server.

Everything here reads metrics the hot loops already record; nothing in
this module runs on the dispatch path.

Port: a copy of ``deeplearning4j_tpu/observability/health.py`` with its
imports rewritten to the port.
"""

from __future__ import annotations

import logging
import math
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence

from deeplearning4j_tpu_torch.observability.metrics import (
    Histogram, MetricsRegistry, get_registry,
)

_STEP = "dl4j_worker_step_seconds"
_TPUT = "dl4j_worker_samples_per_second"
_STRAGGLERS = "dl4j_stragglers_total"
_HEALTH = "dl4j_health_status"

logger = logging.getLogger("deeplearning4j_tpu_torch.observability")


def _median(values: Sequence[float]) -> float:
    vs = sorted(values)
    n = len(vs)
    if not n:
        return float("nan")
    mid = n // 2
    return vs[mid] if n % 2 else 0.5 * (vs[mid - 1] + vs[mid])


def _quantile(values: Sequence[float], q: float) -> float:
    vs = sorted(values)
    if not vs:
        return float("nan")
    pos = q * (len(vs) - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(vs) - 1)
    return vs[lo] + (vs[hi] - vs[lo]) * (pos - lo)


def histogram_quantile(hist: Histogram, q: float) -> float:
    """Prometheus-style quantile from cumulative buckets (linear
    interpolation within the containing bucket; NaN on an empty
    histogram).  An upper-bound estimate capped at the observed max when
    the quantile lands in the +Inf bucket."""
    snap = hist.snapshot()
    count = snap["count"]
    if not count:
        return float("nan")
    rank = q * count
    prev_bound, prev_cum = 0.0, 0
    for bound, cum in snap["cumulative_buckets"]:
        if cum >= rank:
            if math.isinf(bound):
                return snap["max"]
            if cum == prev_cum:
                return bound
            frac = (rank - prev_cum) / (cum - prev_cum)
            return prev_bound + (bound - prev_bound) * frac
        prev_bound, prev_cum = bound, cum
    return snap["max"]


# ------------------------------------------------------------- stragglers
class StragglerDetector:
    """Rolling-window straggler detection for one component's workers.

    A worker is flagged when its rolling median step time exceeds
    ``threshold`` times the cluster median (the median of the OTHER
    workers' rolling medians — excluding the candidate keeps a straggler
    from dragging the reference toward itself, which in a 2-worker
    cluster would make the criterion unsatisfiable) — the
    SparkNet/DeepSpark slow-replica criterion —
    AND the absolute excess over the cluster median is at least
    ``min_excess_s``.  The absolute floor keeps sub-millisecond jitter
    (host scheduling noise on fast steps) from pattern-matching as a
    straggler: a worker "2x slower" by 40 microseconds is not an
    actionable fix.  Every flagged observation increments
    ``dl4j_stragglers_total{component,worker}``; the WARNING (with the
    phase breakdown of the offending worker, when the caller provides
    one) is rate-limited to one per ``warn_interval_s`` per worker.
    """

    def __init__(self, component: str, threshold: float = 2.0,
                 window: int = 32, min_steps: int = 4,
                 min_excess_s: float = 0.010,
                 warn_interval_s: float = 30.0, registry=None,
                 warn: Optional[Callable[[str], None]] = None):
        if threshold <= 1.0:
            raise ValueError(f"threshold must be > 1.0, got {threshold}")
        self.component = component
        self.threshold = float(threshold)
        self.min_excess_s = float(min_excess_s)
        self.window = int(window)
        self.min_steps = max(2, int(min_steps))
        self.warn_interval_s = float(warn_interval_s)
        self.warn = warn or logger.warning
        self._lock = threading.Lock()
        self._windows: Dict[str, deque] = {}
        self._last_warn: Dict[str, float] = {}
        self.flag_counts: Dict[str, int] = {}
        reg = registry if registry is not None else get_registry()
        self._m_stragglers = reg.counter(
            _STRAGGLERS, "Straggler observations: a worker/stage whose "
            "rolling median step time exceeded the configured multiple of "
            "the cluster median", labels=("component", "worker"))

    def observe(self, worker, seconds: float,
                phases: Optional[Dict[str, float]] = None) -> bool:
        """Record one step time for ``worker``; returns True when this
        observation flags the worker as a straggler."""
        worker = str(worker)
        with self._lock:
            win = self._windows.get(worker)
            if win is None:
                win = self._windows[worker] = deque(maxlen=self.window)
            win.append(float(seconds))
            if len(self._windows) < 2:
                return False
            medians = {w: _median(win) for w, win in self._windows.items()
                       if len(win) >= self.min_steps}
            if len(medians) < 2 or worker not in medians:
                return False
            # cluster reference EXCLUDES this worker: including it lets a
            # straggler drag the median toward itself — with 2 workers
            # 'mine > 2x median(mine, other)' is unsatisfiable, so a slow
            # half of a 2-replica/2-stage cluster would never be named
            mine = medians[worker]
            cluster = _median([m for w, m in medians.items() if w != worker])
            if (not (cluster > 0) or mine <= self.threshold * cluster
                    or mine - cluster < self.min_excess_s):
                return False
            self.flag_counts[worker] = self.flag_counts.get(worker, 0) + 1
            now = time.monotonic()
            should_warn = (now - self._last_warn.get(worker, -math.inf)
                           >= self.warn_interval_s)
            if should_warn:
                self._last_warn[worker] = now
        self._m_stragglers.inc(component=self.component, worker=worker)
        if should_warn:
            try:
                # performance attribution: a straggler verdict arms the
                # installed StepProfiler to capture the next step, so the
                # trace shows what the degraded window actually did.
                # Gated on the rate-limited warning path: a persistently
                # slow worker must not re-arm a capture every window.
                from deeplearning4j_tpu_torch.observability import profiling

                profiling.notify_straggler(self.component, worker)
            except Exception:
                pass
        if should_warn:
            breakdown = ""
            if phases:
                parts = ", ".join(f"{k}={v * 1e3:.1f}ms"
                                  for k, v in phases.items())
                breakdown = f" (phases: {parts})"
            self.warn(
                f"straggler in {self.component}: worker {worker} rolling "
                f"median step {mine * 1e3:.1f}ms > {self.threshold:.1f}x "
                f"cluster median {cluster * 1e3:.1f}ms{breakdown}")
        return True

    def stragglers(self) -> Dict[str, int]:
        """worker -> times flagged (empty when the cluster is healthy)."""
        with self._lock:
            return dict(self.flag_counts)


class WorkerTelemetry:
    """Per-worker/per-stage publication seam for one component.

    ``observe(worker, seconds, ...)`` lands in
    ``dl4j_worker_step_seconds{component,worker}`` (histogram) and
    ``dl4j_worker_samples_per_second{component,worker}`` (gauge), keeps a
    rolling sample window per worker for ``snapshot()``, and feeds the
    attached ``StragglerDetector``."""

    def __init__(self, component: str, registry=None,
                 detector: Optional[StragglerDetector] = None,
                 threshold: float = 2.0, window: int = 32,
                 min_steps: int = 4, min_excess_s: float = 0.010):
        reg = registry if registry is not None else get_registry()
        self.component = component
        self.step_seconds = reg.histogram(
            _STEP, "Per-worker (or per-pipeline-stage) step time published "
            "by the training masters", labels=("component", "worker"))
        self.throughput = reg.gauge(
            _TPUT, "Per-worker throughput implied by the most recent step",
            labels=("component", "worker"))
        self.detector = detector or StragglerDetector(
            component, threshold=threshold, window=window,
            min_steps=min_steps, min_excess_s=min_excess_s, registry=reg)
        self._lock = threading.Lock()
        self._windows: Dict[str, deque] = {}
        self._last: Dict[str, Dict[str, Any]] = {}

    def observe(self, worker, seconds: float, batch: Optional[int] = None,
                phases: Optional[Dict[str, float]] = None) -> bool:
        worker = str(worker)
        seconds = float(seconds)
        self.step_seconds.observe(seconds, component=self.component,
                                  worker=worker)
        sps = None
        if batch and seconds > 0:
            sps = batch / seconds
            self.throughput.set(sps, component=self.component, worker=worker)
        with self._lock:
            win = self._windows.get(worker)
            if win is None:
                win = self._windows[worker] = deque(maxlen=64)
            win.append(seconds)
            self._last[worker] = {"seconds": seconds,
                                  "samples_per_second": sps}
        return self.detector.observe(worker, seconds, phases=phases)

    def snapshot(self) -> List[Dict[str, Any]]:
        """Per-worker summaries as plain dicts (JSON-safe, mergeable
        across processes by ``ClusterStatsAggregator.merge``)."""
        with self._lock:
            items = [(w, list(win)) for w, win in self._windows.items()]
            last = dict(self._last)
        out = []
        for worker, samples in sorted(items):
            out.append({
                "worker": worker,
                "count": len(samples),
                "mean": sum(samples) / len(samples) if samples else None,
                "p50": _median(samples),
                "p99": _quantile(samples, 0.99),
                "max": max(samples) if samples else None,
                "last": last.get(worker, {}).get("seconds"),
                "samples_per_second":
                    last.get(worker, {}).get("samples_per_second"),
                "samples": samples,
            })
        return out

    def cluster_view(self) -> Dict[str, Any]:
        return ClusterStatsAggregator.merge(self.snapshot())


class ClusterStatsAggregator:
    """Merges per-worker snapshot dicts into one cluster view.

    Works on plain dicts so multi-process deployments can ship each
    process's ``WorkerTelemetry.snapshot()`` as JSON and merge driver-side
    (the Spark-driver stage-timing pattern without the driver in the data
    path)."""

    #: schema tag a wire-delivered snapshot MAY carry.  Absent = legacy
    #: in-process snapshot (accepted); equal = accepted; anything else
    #: was produced by a worker this process does not understand and is
    #: skipped with a log line, never raised on.
    SNAPSHOT_SCHEMA = 1

    @staticmethod
    def _usable(s: Any) -> bool:
        """Tolerant per-snapshot gate for wire-delivered dicts from
        heterogeneous workers: non-dicts, mismatched schema tags and
        unparseable counts are log-and-skip; unknown extra keys ride
        through untouched; a missing/zero count is silently empty
        (pre-existing semantics)."""
        if not isinstance(s, dict):
            if s:   # None/{} stay silent — the legacy empty-slot case
                logger.warning("cluster merge: skipping non-dict "
                               "snapshot (%s)", type(s).__name__)
            return False
        schema = s.get("schema", ClusterStatsAggregator.SNAPSHOT_SCHEMA)
        if schema != ClusterStatsAggregator.SNAPSHOT_SCHEMA:
            logger.warning("cluster merge: skipping snapshot from %r "
                           "with unknown schema %r",
                           s.get("worker"), schema)
            return False
        count = s.get("count")
        if count is None or count == 0:
            return False
        if not isinstance(count, (int, float)) or isinstance(count, bool):
            logger.warning("cluster merge: skipping snapshot from %r "
                           "with unparseable count %r",
                           s.get("worker"), count)
            return False
        return True

    @staticmethod
    def _f(v: Any) -> Optional[float]:
        """A numeric field or None — wire snapshots may carry anything."""
        return float(v) if (isinstance(v, (int, float))
                            and not isinstance(v, bool)) else None

    @staticmethod
    def merge(snapshots: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
        _f = ClusterStatsAggregator._f
        snapshots = [s for s in (snapshots or ())
                     if ClusterStatsAggregator._usable(s)]
        pooled: List[float] = []
        throughput = 0.0
        has_tput = False
        slowest = None
        for s in snapshots:
            samples = s.get("samples")
            if isinstance(samples, (list, tuple)):
                pooled.extend(v for v in map(_f, samples)
                              if v is not None)
            sps = _f(s.get("samples_per_second"))
            if sps:
                throughput += sps
                has_tput = True
            if slowest is None or (_f(s.get("mean")) or 0) > (
                    _f(slowest.get("mean")) or 0):
                slowest = s
        view: Dict[str, Any] = {
            "workers": len(snapshots),
            "steps": int(sum(s["count"] for s in snapshots)),
            "slowest_worker": slowest.get("worker") if slowest else None,
            "samples_per_second_total": throughput if has_tput else None,
            "per_worker": [
                {k: v for k, v in s.items() if k != "samples"}
                for s in snapshots
            ],
        }
        if pooled:
            view["step_seconds"] = {
                "mean": sum(pooled) / len(pooled),
                "p50": _median(pooled),
                "p99": _quantile(pooled, 0.99),
                "max": max(pooled),
            }
        return view

    @staticmethod
    def from_registry(registry: Optional[MetricsRegistry] = None,
                      component: Optional[str] = None) -> Dict[str, Any]:
        """Cluster view reconstructed from the shared registry's
        ``dl4j_worker_step_seconds`` children (useful when the master
        object is out of reach, e.g. from a /health handler)."""
        reg = registry if registry is not None else get_registry()
        fam = reg.get(_STEP)
        snapshots = []
        if fam is not None:
            for label_pairs, child in fam.samples():
                labels = dict(label_pairs)
                if component and labels.get("component") != component:
                    continue
                snap = child.snapshot()
                if not snap["count"]:
                    continue
                snapshots.append({
                    "worker": labels.get("worker"),
                    "component": labels.get("component"),
                    "count": snap["count"],
                    "mean": snap["sum"] / snap["count"],
                    "p50": histogram_quantile(child, 0.5),
                    "p99": histogram_quantile(child, 0.99),
                    "max": snap["max"],
                    "samples": [],
                })
        pooled_view = ClusterStatsAggregator.merge(snapshots)
        # histograms carry no raw samples; synthesize the cluster step
        # stats from the per-worker quantiles instead of the empty pool
        if snapshots:
            pooled_view["step_seconds"] = {
                "mean": (sum(s["mean"] * s["count"] for s in snapshots)
                         / sum(s["count"] for s in snapshots)),
                "p50": _median([s["p50"] for s in snapshots]),
                "p99": max(s["p99"] for s in snapshots),
                "max": max(s["max"] for s in snapshots),
            }
        return pooled_view


# ------------------------------------------------------------------ health
class HealthRule:
    """One declarative SLO rule evaluated against the registry.

    Kinds (``metric`` defaults in parentheses):

    - ``max_step_p99`` — p99 of a step-time histogram, max over children
      (``dl4j_fit_step_seconds``) must be <= ``limit`` seconds
    - ``max_queue_depth`` — max gauge child (``dl4j_serving_queue_depth``)
      must be <= ``limit``
    - ``min_throughput`` — max gauge child
      (``dl4j_fit_samples_per_second``) must be >= ``limit``
    - ``max_recompiles`` — summed counter (``dl4j_recompiles_total``)
      must be <= ``limit``
    - ``max_stragglers`` — summed counter (``dl4j_stragglers_total``)
      must be <= ``limit``
    - ``max_checkpoint_staleness`` — max gauge child
      (``dl4j_checkpoint_staleness_seconds``) must be <= ``limit``
      seconds: flags a run whose CheckpointManager stopped committing
      (or never started) long before the lost progress is discovered
      the hard way
    - ``max_evicted_replicas`` — max gauge child
      (``dl4j_elastic_evicted_replicas``) must be <= ``limit``: a
      degraded-mode mesh (replicas evicted from the averaging collective,
      docs/resilience.md "Elasticity") is tolerable up to a budget —
      beyond it the run is limping and /health should say so
    - ``max_nonfinite_steps`` — summed counter
      (``dl4j_nonfinite_steps_total``) must be <= ``limit``: the
      stability engine's guard turns poisoned steps into no-ops, but a
      run skipping many steps is limping — budget it
      (docs/resilience.md "Stability")
    - ``max_divergence_rewinds`` — summed counter
      (``dl4j_divergence_rewinds_total``) must be <= ``limit``: every
      auto-rewind re-trains from an older checkpoint; repeated rewinds
      mean the run cannot make it past a divergence wall
    - ``max_dead_fraction`` — max gauge child
      (``dl4j_layer_dead_fraction``) must be <= ``limit``: a layer whose
      activations are (nearly) all zero is a dying-ReLU / dead-unit
      layer; the failing layer is named in the detail
      (docs/observability.md "Training introspection")
    - ``update_ratio_band`` — every ``dl4j_layer_update_ratio`` gauge
      child must lie in ``[limit_low, limit]``: the update:param norm
      ratio doctrine (~1e-3 healthy) — too low means the layer is
      frozen/vanishing, too high means the LR is about to bounce the
      weights; the worst offender is named
    - ``max_gradient_norm_ratio`` — the max:min spread over
      ``dl4j_layer_gradient_norm`` children must be <= ``limit``:
      vanishing/exploding gradients across depth, with both extreme
      layers named
    - ``predicate`` — ``fn(extra) -> bool`` (or ``(ok, observed, detail)``)
      for liveness checks that live outside the registry

    A rule with no data passes unless ``require_data=True`` — "nothing
    has trained/served yet" is healthy, "metrics stopped flowing" can be
    made a failure per rule.
    """

    _DEFAULT_METRIC = {
        "max_step_p99": "dl4j_fit_step_seconds",
        "max_queue_depth": "dl4j_serving_queue_depth",
        "min_throughput": "dl4j_fit_samples_per_second",
        "max_recompiles": "dl4j_recompiles_total",
        "max_stragglers": "dl4j_stragglers_total",
        "max_checkpoint_staleness": "dl4j_checkpoint_staleness_seconds",
        "max_evicted_replicas": "dl4j_elastic_evicted_replicas",
        "max_nonfinite_steps": "dl4j_nonfinite_steps_total",
        "max_divergence_rewinds": "dl4j_divergence_rewinds_total",
        "max_dead_fraction": "dl4j_layer_dead_fraction",
        "update_ratio_band": "dl4j_layer_update_ratio",
        "max_gradient_norm_ratio": "dl4j_layer_gradient_norm",
    }

    def __init__(self, name: str, kind: str, limit: Optional[float] = None,
                 metric: Optional[str] = None,
                 labels: Optional[Dict[str, str]] = None,
                 require_data: bool = False,
                 fn: Optional[Callable[[Any], Any]] = None,
                 limit_low: Optional[float] = None):
        if kind != "predicate" and kind not in self._DEFAULT_METRIC:
            raise ValueError(f"unknown health-rule kind {kind!r}")
        if kind == "predicate" and fn is None:
            raise ValueError("predicate rules need fn=")
        if kind != "predicate" and limit is None:
            raise ValueError(f"rule {name!r} ({kind}) needs limit=")
        if kind == "update_ratio_band":
            if limit_low is None:
                raise ValueError("update_ratio_band needs limit_low=")
            if limit_low > limit:
                raise ValueError(
                    f"limit_low {limit_low} > limit {limit}")
        self.name = name
        self.kind = kind
        self.limit = limit
        self.limit_low = limit_low
        self.metric = metric or self._DEFAULT_METRIC.get(kind)
        self.labels = dict(labels or {})
        self.require_data = require_data
        self.fn = fn

    # ---------------------------------------------------------- observation
    def _children(self, reg: MetricsRegistry):
        fam = reg.get(self.metric)
        if fam is None:
            return []
        out = []
        for label_pairs, child in fam.samples():
            labels = dict(label_pairs)
            if all(labels.get(k) == v for k, v in self.labels.items()):
                out.append((labels, child))
        return out

    def _observed(self, reg: MetricsRegistry):
        """(observed value, detail) for metric-backed kinds; observed is
        None when the family/children don't exist yet."""
        children = self._children(reg)
        if self.kind == "max_step_p99":
            vals = [(histogram_quantile(c, 0.99), labels)
                    for labels, c in children if c.count]
            vals = [(v, l) for v, l in vals if not math.isnan(v)]
            if not vals:
                return None, "no step samples yet"
            v, labels = max(vals, key=lambda t: t[0])
            return v, f"worst child: {labels or 'unlabeled'}"
        if self.kind in ("max_queue_depth", "min_throughput",
                         "max_checkpoint_staleness",
                         "max_evicted_replicas", "max_dead_fraction"):
            vals = [(c.value, labels) for labels, c in children]
            vals = [(v, l) for v, l in vals if not math.isnan(v)]
            if not vals:
                return None, "no gauge children yet"
            # all these kinds take the MAX child: deepest queue for the
            # depth cap, best current throughput for the floor (a stale
            # low gauge from a finished side model must not fail the
            # floor forever — narrow with labels= to watch one child),
            # the stalest checkpoint manager for the staleness cap, the
            # most-degraded component for the eviction budget, and the
            # most-dead layer for the dead-unit cap
            v, labels = max(vals, key=lambda t: t[0])
            which = {"max_queue_depth": "deepest",
                     "min_throughput": "best",
                     "max_checkpoint_staleness": "stalest",
                     "max_evicted_replicas": "most degraded",
                     "max_dead_fraction": "most dead"}[self.kind]
            return v, f"{which} child: {labels or 'unlabeled'}"
        if self.kind == "update_ratio_band":
            vals = [(c.value, labels) for labels, c in children
                    if not math.isnan(c.value)]
            if not vals:
                return None, "no gauge children yet"

            def badness(v):
                # multiplicative distance outside [limit_low, limit];
                # <= 1 means inside the band
                if v <= 0:
                    return math.inf
                return max(self.limit_low / v, v / self.limit)

            v, labels = max(vals, key=lambda t: badness(t[0]))
            return v, f"worst child: {labels or 'unlabeled'}"
        if self.kind == "max_gradient_norm_ratio":
            vals = [(c.value, labels) for labels, c in children
                    if math.isfinite(c.value) and c.value > 0]
            if len(vals) < 2:
                return None, "fewer than two layers with gradient norms"
            lo_v, lo_l = min(vals, key=lambda t: t[0])
            hi_v, hi_l = max(vals, key=lambda t: t[0])
            return hi_v / lo_v, (f"max {hi_l or 'unlabeled'}={hi_v:.3g} vs "
                                 f"min {lo_l or 'unlabeled'}={lo_v:.3g}")
        # counters: sum over matching children
        if not children:
            return None, "counter not registered yet"
        return sum(c.value for _, c in children), \
            f"summed over {len(children)} children"

    def evaluate(self, reg: MetricsRegistry,
                 extra: Any = None) -> Dict[str, Any]:
        if self.kind == "predicate":
            try:
                res = self.fn(extra)
            except Exception as e:
                return {"name": self.name, "kind": self.kind, "ok": False,
                        "observed": None, "limit": None,
                        "detail": f"predicate raised: {e!r}"}
            if isinstance(res, tuple):
                ok, observed, detail = (list(res) + [None, None])[:3]
            else:
                ok, observed, detail = bool(res), res, None
            return {"name": self.name, "kind": self.kind, "ok": bool(ok),
                    "observed": observed, "limit": self.limit,
                    "detail": detail}
        observed, detail = self._observed(reg)
        if observed is None:
            ok = not self.require_data
            detail = f"no data ({detail}); " + (
                "required -> fail" if self.require_data else "pass")
        elif self.kind == "min_throughput":
            ok = observed >= self.limit
        elif self.kind == "update_ratio_band":
            ok = self.limit_low <= observed <= self.limit
        else:
            ok = observed <= self.limit
        return {"name": self.name, "kind": self.kind, "ok": ok,
                "observed": observed, "limit": self.limit,
                "metric": self.metric, "detail": detail}


class HealthVerdict:
    """Outcome of one evaluation: overall flag + per-rule results."""

    def __init__(self, component: str, results: List[Dict[str, Any]]):
        self.component = component
        self.results = results
        self.healthy = all(r["ok"] for r in results)
        self.failing = [r for r in results if not r["ok"]]

    def to_dict(self) -> Dict[str, Any]:
        return {"healthy": self.healthy, "component": self.component,
                "failing": [r["name"] for r in self.failing],
                "rules": self.results}


class HealthEvaluator:
    """Evaluates a rule set against the (shared) registry and mirrors the
    verdict into ``dl4j_health_status{component}`` (1 healthy / 0 not) so
    scrapes see health flips even between /health polls."""

    def __init__(self, rules: Sequence[HealthRule], component: str = "main",
                 registry=None):
        self.rules = list(rules)
        self.component = component
        self._registry = registry

    def evaluate(self, extra: Any = None) -> HealthVerdict:
        reg = (self._registry if self._registry is not None
               else get_registry())
        verdict = HealthVerdict(
            self.component, [r.evaluate(reg, extra) for r in self.rules])
        reg.gauge(
            _HEALTH, "Most recent HealthEvaluator verdict (1 = all SLO "
            "rules passing)", labels=("component",)
        ).set(1.0 if verdict.healthy else 0.0, component=self.component)
        return verdict


def default_training_rules(max_step_p99_s: Optional[float] = None,
                           min_samples_per_sec: Optional[float] = None,
                           max_recompiles: float = 100.0,
                           max_stragglers: Optional[float] = None,
                           max_checkpoint_staleness_s: Optional[float] = None,
                           max_evicted_replicas: Optional[float] = None,
                           max_nonfinite_steps: Optional[float] = None,
                           max_divergence_rewinds: Optional[float] = None,
                           max_dead_fraction: Optional[float] = None,
                           update_ratio_band=None,
                           max_gradient_norm_ratio: Optional[float] = None,
                           ) -> List[HealthRule]:
    """Sensible defaults for a training process: an optional step-time
    SLO, an optional throughput floor, a recompile budget (steady-state
    shape churn is the classic silent TPU throughput bug), an optional
    straggler budget, an optional checkpoint-staleness cap (a run whose
    CheckpointManager stopped committing fails /health while the progress
    is still recoverable — docs/resilience.md), an optional evicted-
    replica budget (degraded-mode training past the budget fails /health
    even though the loop is still making progress), optional
    stability budgets: guarded-skip steps and divergence auto-rewinds
    (docs/resilience.md "Stability"), and optional introspection anomaly
    budgets: dead-unit fraction cap, update:param ratio band
    ``(low, high)``, and cross-layer gradient-norm spread
    (docs/observability.md "Training introspection")."""
    rules = [HealthRule("recompile_budget", "max_recompiles",
                        max_recompiles)]
    if max_step_p99_s is not None:
        rules.append(HealthRule("step_p99", "max_step_p99", max_step_p99_s))
    if min_samples_per_sec is not None:
        rules.append(HealthRule("throughput_floor", "min_throughput",
                                min_samples_per_sec))
    if max_stragglers is not None:
        rules.append(HealthRule("straggler_budget", "max_stragglers",
                                max_stragglers))
    if max_checkpoint_staleness_s is not None:
        rules.append(HealthRule("checkpoint_staleness",
                                "max_checkpoint_staleness",
                                max_checkpoint_staleness_s))
    if max_evicted_replicas is not None:
        rules.append(HealthRule("evicted_replicas", "max_evicted_replicas",
                                max_evicted_replicas))
    if max_nonfinite_steps is not None:
        rules.append(HealthRule("nonfinite_steps", "max_nonfinite_steps",
                                max_nonfinite_steps))
    if max_divergence_rewinds is not None:
        rules.append(HealthRule("divergence_rewinds",
                                "max_divergence_rewinds",
                                max_divergence_rewinds))
    # training-introspection anomaly budgets (per-layer gradient/update/
    # activation gauges published by StatsListener harvests —
    # docs/observability.md "Training introspection")
    if max_dead_fraction is not None:
        rules.append(HealthRule("dead_fraction", "max_dead_fraction",
                                max_dead_fraction))
    if update_ratio_band is not None:
        lo, hi = update_ratio_band
        rules.append(HealthRule("update_ratio_band", "update_ratio_band",
                                hi, limit_low=lo))
    if max_gradient_norm_ratio is not None:
        rules.append(HealthRule("gradient_norm_ratio",
                                "max_gradient_norm_ratio",
                                max_gradient_norm_ratio))
    return rules


def default_serving_rules(max_queue_depth: float,
                          max_request_p99_s: Optional[float] = None,
                          max_recompiles: float = 100.0) -> List[HealthRule]:
    """Defaults for a serving process; the dispatcher-liveness predicate
    is added by the server (it needs the engine object)."""
    rules = [
        HealthRule("queue_depth", "max_queue_depth", max_queue_depth),
        HealthRule("recompile_budget", "max_recompiles", max_recompiles),
    ]
    if max_request_p99_s is not None:
        rules.append(HealthRule(
            "request_p99", "max_step_p99", max_request_p99_s,
            metric="dl4j_serving_request_seconds"))
    return rules
