"""Process-wide metrics registry: counters, gauges, histograms with labels.

Copied from ``deeplearning4j_tpu/observability/metrics.py`` (framework-free).
A lazy gauge value here is a callable or a device tensor, read with
``float()`` when the registry is scraped.

The data model every layer shares (SURVEY.md: the reference scatters timing
over ``IterationListener`` / ``PerformanceListener`` / the SBE-encoded
``StatsListener`` pipeline with no common store; SparkNet/DeepSpark show
that distributed-throughput tuning needs one).  Naming follows Prometheus
conventions — ``dl4j_`` prefix, base units (seconds, bytes), ``_total``
suffix on counters — and the registry renders both JSON (``to_json``) and
Prometheus text exposition format (``to_prometheus``).

Design point: gauges accept LAZY values — an on-device scalar
(or a zero-arg callable) is stored as-is and only converted with
``float()`` at scrape/render time, so the training hot loop never pays a
device->host sync to record its score (the same contract as
``LazyScoreMixin``).
"""

from __future__ import annotations

import json
import math
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

# Latency buckets in SECONDS (Prometheus base unit), spanning the sub-ms
# dispatch floor of LeNet-class steps up to multi-second ResNet/compile
# events.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


def _as_float(v: Any) -> float:
    """Resolve a lazily-stored gauge value (callable or device scalar).
    A raising callback degrades to NaN — a broken live gauge must never
    take down a /metrics scrape or a flight-recorder dump."""
    if callable(v):
        try:
            v = v()
        except Exception:
            return float("nan")
    try:
        return float(v)
    except (TypeError, ValueError):
        return float("nan")


def _escape_label(v: Any) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(pairs: Sequence[Tuple[str, Any]]) -> str:
    if not pairs:
        return ""
    body = ",".join(f'{k}="{_escape_label(v)}"' for k, v in pairs)
    return "{" + body + "}"


def _fmt_value(v: float) -> str:
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


class Counter:
    """Monotonically increasing value (one labeled child of a family)."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter increment must be >= 0, got {amount}")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        # dl4jlint: disable-next-line=lock-discipline -- monitoring read of a GIL-atomic float; scrapes tolerate one stale increment
        return self._value


class Gauge:
    """Point-in-time value; accepts lazy values (device scalar / callable)."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value: Any = 0.0

    def set(self, value: Any) -> None:
        """Store without conversion: an on-device scalar stays on device
        until scrape time (no sync in the hot loop)."""
        # dl4jlint: disable-next-line=lock-discipline -- blind GIL-atomic reference publish from the single hot-loop writer; inc() locks because it read-modify-writes
        self._value = value

    def set_function(self, fn) -> None:
        """Gauge computed at scrape time (e.g. a queue depth)."""
        # dl4jlint: disable-next-line=lock-discipline -- blind GIL-atomic reference publish (see set)
        self._value = fn

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value = _as_float(self._value) + amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    @property
    def value(self) -> float:
        # dl4jlint: disable-next-line=lock-discipline -- monitoring read of a GIL-atomic reference; scrapes tolerate one stale set
        return _as_float(self._value)


class Histogram:
    """Cumulative-bucket histogram + running sum/count/min/max.

    min/max are beyond the Prometheus exposition model but kept so
    registry-backed phase timers can reproduce the ``PhaseStats.as_dict``
    schema exactly (count/total/mean/min/max per phase).
    """

    __slots__ = ("_lock", "buckets", "_bucket_counts", "_sum", "_count",
                 "_min", "_max", "_exemplars")

    def __init__(self, buckets: Sequence[float] = DEFAULT_BUCKETS):
        self._lock = threading.Lock()
        self.buckets = tuple(sorted(float(b) for b in buckets))
        self._bucket_counts = [0] * len(self.buckets)
        self._sum = 0.0
        self._count = 0
        self._min = math.inf
        self._max = -math.inf
        # bucket index -> last exemplar that landed there (OpenMetrics
        # style: a trace id sampled onto the latency distribution, so a
        # p99 spike comes with a concrete request to go look at).  Index
        # len(buckets) is the +Inf overflow bucket.
        self._exemplars: Dict[int, Dict[str, Any]] = {}

    def observe(self, value: float, exemplar: Optional[str] = None) -> None:
        value = float(value)
        with self._lock:
            self._sum += value
            self._count += 1
            if value < self._min:
                self._min = value
            if value > self._max:
                self._max = value
            idx = len(self.buckets)
            for i, b in enumerate(self.buckets):
                if value <= b:
                    self._bucket_counts[i] += 1
                    idx = i
                    break
            if exemplar is not None:
                self._exemplars[idx] = {"trace_id": str(exemplar),
                                        "value": value, "ts": time.time()}

    def time(self):
        """Context manager observing the elapsed seconds of the block."""
        return _HistogramTimer(self)

    def restore(self, bucket_counts: Sequence[int], sum: float, count: int,
                min: Optional[float] = None,
                max: Optional[float] = None) -> None:
        """Overwrite this histogram's state from an exported snapshot —
        the import half of the fleet-federation wire format
        (observability.fleet): per-bucket counts, running sum/count, and
        optional min/max (NaN when the exporter didn't carry them, so a
        merged histogram never fabricates extremes)."""
        bucket_counts = [int(c) for c in bucket_counts]
        if len(bucket_counts) != len(self.buckets):
            raise ValueError(
                f"restore() got {len(bucket_counts)} bucket counts for "
                f"{len(self.buckets)} buckets")
        with self._lock:
            self._bucket_counts = bucket_counts
            self._sum = float(sum)
            self._count = int(count)
            if self._count:
                self._min = float("nan") if min is None else float(min)
                self._max = float("nan") if max is None else float(max)
            else:
                self._min = math.inf
                self._max = -math.inf

    @property
    def count(self) -> int:
        # dl4jlint: disable-next-line=lock-discipline -- monitoring read of one GIL-atomic int; snapshot() is the consistent view
        return self._count

    @property
    def sum(self) -> float:
        # dl4jlint: disable-next-line=lock-discipline -- monitoring read of one GIL-atomic float; snapshot() is the consistent view
        return self._sum

    @property
    def min(self) -> float:
        # dl4jlint: disable-next-line=lock-discipline -- monitoring read; count/min may straddle an observe, snapshot() is the consistent view
        return self._min if self._count else float("nan")

    @property
    def max(self) -> float:
        # dl4jlint: disable-next-line=lock-discipline -- monitoring read; count/max may straddle an observe, snapshot() is the consistent view
        return self._max if self._count else float("nan")

    def snapshot(self) -> Dict[str, Any]:
        """One CONSISTENT view of the histogram taken under a single lock
        acquisition: count/sum/min/max and the cumulative buckets all
        describe the same instant, even while other threads keep
        observing (the watchdog, the dispatcher, and the fit loop now
        read histograms concurrently with writers)."""
        with self._lock:
            count = self._count
            bucket_counts = list(self._bucket_counts)
            exemplars = {i: dict(e) for i, e in self._exemplars.items()}
            out = {
                "count": count,
                "sum": self._sum,
                "min": self._min if count else None,
                "max": self._max if count else None,
            }
        out["exemplars"] = {
            ("+Inf" if i == len(self.buckets)
             else _fmt_value(self.buckets[i])): e
            for i, e in exemplars.items()}
        cum, running = [], 0
        for b, c in zip(self.buckets, bucket_counts):
            running += c
            cum.append((b, running))
        cum.append((math.inf, count))
        out["cumulative_buckets"] = cum
        out["bucket_counts"] = bucket_counts
        return out

    def cumulative_buckets(self) -> List[Tuple[float, int]]:
        """(upper_bound, cumulative_count) pairs, +Inf last."""
        return self.snapshot()["cumulative_buckets"]

    def exemplars(self) -> Dict[str, Dict[str, Any]]:
        """Bucket upper-bound -> last exemplar sampled into that bucket."""
        return self.snapshot()["exemplars"]

    def to_dict(self) -> Dict[str, Any]:
        snap = self.snapshot()
        out = {
            "count": snap["count"],
            "sum": snap["sum"],
            "min": snap["min"],
            "max": snap["max"],
            "buckets": {
                _fmt_value(b): c
                for b, c in zip(self.buckets, snap["bucket_counts"])
            },
        }
        if snap["exemplars"]:
            out["exemplars"] = snap["exemplars"]
        return out


class _HistogramTimer:
    __slots__ = ("_hist", "_t0")

    def __init__(self, hist: Histogram):
        self._hist = hist

    def __enter__(self):
        import time

        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import time

        self._hist.observe(time.perf_counter() - self._t0)
        return False


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricFamily:
    """A named metric plus its labeled children.  With no declared labels
    the family proxies its single unlabeled child, so
    ``registry.counter("x").inc()`` works without a ``labels()`` hop."""

    def __init__(self, name: str, kind: str, help: str,
                 label_names: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        self.name = name
        self.kind = kind
        self.help = help
        self.label_names = tuple(label_names)
        self._buckets = tuple(buckets)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[Any, ...], Any] = {}

    def labels(self, **labels) -> Any:
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"metric {self.name!r} declares labels {self.label_names}, "
                f"got {tuple(labels)}")
        key = tuple(labels[k] for k in self.label_names)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                cls = _KINDS[self.kind]
                child = (cls(self._buckets) if self.kind == "histogram"
                         else cls())
                self._children[key] = child
            return child

    # unlabeled convenience: family proxies its single child
    def _default(self):
        return self.labels()

    def inc(self, amount: float = 1.0, **labels):
        (self.labels(**labels) if labels else self._default()).inc(amount)

    def set(self, value, **labels):
        (self.labels(**labels) if labels else self._default()).set(value)

    def set_function(self, fn, **labels):
        (self.labels(**labels) if labels else self._default()).set_function(fn)

    def observe(self, value, exemplar=None, **labels):
        (self.labels(**labels) if labels
         else self._default()).observe(value, exemplar=exemplar)

    def time(self, **labels):
        return (self.labels(**labels) if labels else self._default()).time()

    def samples(self) -> List[Tuple[Tuple[Tuple[str, Any], ...], Any]]:
        with self._lock:
            items = list(self._children.items())
        return [(tuple(zip(self.label_names, key)), child)
                for key, child in items]

    def get(self, **labels):
        """Existing child or None (no implicit creation)."""
        key = tuple(labels.get(k) for k in self.label_names)
        with self._lock:
            return self._children.get(key)


class MetricsRegistry:
    """Process-wide metric store; export as JSON or Prometheus text."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, MetricFamily] = {}

    # ------------------------------------------------------------ creation
    def _family(self, name: str, kind: str, help: str,
                labels: Sequence[str], buckets=None) -> MetricFamily:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind:
                    raise ValueError(
                        f"metric {name!r} already registered as {fam.kind}, "
                        f"requested {kind}")
                if tuple(labels) != fam.label_names:
                    raise ValueError(
                        f"metric {name!r} already registered with labels "
                        f"{fam.label_names}, requested {tuple(labels)}")
                return fam
            fam = MetricFamily(name, kind, help, labels,
                               buckets or DEFAULT_BUCKETS)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> MetricFamily:
        return self._family(name, "counter", help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> MetricFamily:
        return self._family(name, "gauge", help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> MetricFamily:
        return self._family(name, "histogram", help, labels, buckets)

    # ------------------------------------------------------------- reading
    def families(self) -> List[MetricFamily]:
        with self._lock:
            return list(self._families.values())

    def get(self, name: str) -> Optional[MetricFamily]:
        with self._lock:
            return self._families.get(name)

    def get_value(self, name: str, **labels) -> Optional[float]:
        """Scalar value of a counter/gauge child, or None if absent."""
        fam = self.get(name)
        if fam is None:
            return None
        child = fam.get(**labels) if labels else fam.get()
        if child is None:
            return None
        return child.value if not isinstance(child, Histogram) else None

    def family_total(self, name: str, **labels) -> float:
        """Sum of a counter/gauge family's children matching ``labels``
        (0.0 when the family is absent) — the read used by summed-counter
        consumers (early-stopping's non-finite guard, bench snapshots)."""
        fam = self.get(name)
        if fam is None:
            return 0.0
        total = 0.0
        for label_pairs, child in fam.samples():
            if isinstance(child, Histogram):
                continue
            d = dict(label_pairs)
            if all(d.get(k) == v for k, v in labels.items()):
                total += child.value
        return total

    def to_json(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for fam in self.families():
            vals = []
            for label_pairs, child in fam.samples():
                entry: Dict[str, Any] = {"labels": dict(label_pairs)}
                if isinstance(child, Histogram):
                    entry.update(child.to_dict())
                else:
                    entry["value"] = child.value
                vals.append(entry)
            out[fam.name] = {"type": fam.kind, "help": fam.help,
                             "values": vals}
        return out

    def to_json_str(self, **kw) -> str:
        return json.dumps(self.to_json(), **kw)

    def to_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        lines: List[str] = []
        for fam in self.families():
            if fam.help:
                lines.append(f"# HELP {fam.name} {fam.help}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            for label_pairs, child in fam.samples():
                base = list(label_pairs)
                if isinstance(child, Histogram):
                    # one consistent snapshot per child: sum/count/buckets
                    # must describe the same instant under concurrent
                    # observe() calls
                    snap = child.snapshot()
                    for bound, cum in snap["cumulative_buckets"]:
                        le = "+Inf" if math.isinf(bound) else _fmt_value(bound)
                        lines.append(
                            f"{fam.name}_bucket"
                            f"{_fmt_labels(base + [('le', le)])} {cum}")
                    lines.append(
                        f"{fam.name}_sum{_fmt_labels(base)} "
                        f"{_fmt_value(snap['sum'])}")
                    lines.append(
                        f"{fam.name}_count{_fmt_labels(base)} "
                        f"{snap['count']}")
                else:
                    lines.append(
                        f"{fam.name}{_fmt_labels(base)} "
                        f"{_fmt_value(child.value)}")
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        with self._lock:
            self._families.clear()


_global_lock = threading.Lock()
_global_registry: Optional[MetricsRegistry] = None


def get_registry() -> MetricsRegistry:
    """The process-wide default registry (created on first use)."""
    global _global_registry
    with _global_lock:
        if _global_registry is None:
            _global_registry = MetricsRegistry()
        return _global_registry


def set_registry(registry: Optional[MetricsRegistry]) -> MetricsRegistry:
    """Swap the process-wide registry (tests); returns the new one."""
    global _global_registry
    with _global_lock:
        _global_registry = registry or MetricsRegistry()
        return _global_registry
