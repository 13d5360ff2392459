"""Decode SLO attainment — ``SLOTracker`` and its helpers, copied from
``deeplearning4j_tpu/observability/fleet.py`` (framework-free).

The reference module is the fleet telemetry plane; its
``TelemetryPublisher`` and ``FleetAggregator`` come with the fleet
(ROADMAP A11).  This copy does not import ``health`` (the reference's
``fleet.py:54`` does, for the aggregator's verdicts).

- ``SLOTracker`` computes TTFT- and ITL-attainment fractions against
  configurable targets plus goodput (requests/sec meeting BOTH SLOs,
  rolling window) — the decode-quality number a router places on.
"""

from __future__ import annotations

import logging
import math
import threading
import time
from collections import deque
from typing import Any, Dict, Optional, Sequence

from deeplearning4j_tpu_torch.observability.metrics import (
    MetricsRegistry, get_registry,
)

_GOODPUT = "dl4j_decode_goodput_rps"
_ATTAIN = "dl4j_decode_slo_attainment"

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
