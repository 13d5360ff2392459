"""Fit-loop telemetry handles shared by both model facades.

One ``FitTelemetry`` per model kind (MultiLayerNetwork / ComputationGraph),
cached at module level so the hot loop does a dict lookup + a few metric
updates per iteration and the facades never hold registry objects (keeps
them trivially copyable/serializable).  The score gauge stores the
*on-device* loss scalar — the ``LazyScoreMixin`` contract — so recording it
costs no device->host sync; the transfer happens at scrape time.

Port: a copy of ``deeplearning4j_tpu/observability/fitmetrics.py`` with
its imports rewritten; ``models/common.fit_loop`` records each step.

Metric names (see docs/observability.md):

- ``dl4j_fit_iterations_total{model=}``    counter
- ``dl4j_fit_step_seconds{model=}``        histogram (host wall time around
  the step: on the card the captured graph's staging and replay launch,
  which return before the device finishes — the number the asynchronous
  fit loop pays per step)
- ``dl4j_fit_last_step_seconds{model=}``   gauge
- ``dl4j_fit_samples_per_second{model=}``  gauge
- ``dl4j_fit_batch_size{model=}``          gauge
- ``dl4j_fit_score{model=}``               gauge (lazy device scalar)
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional, Tuple

from deeplearning4j_tpu_torch.observability.metrics import (
    MetricsRegistry, get_registry,
)
from deeplearning4j_tpu_torch.observability.tracing import get_tracer


class FitTelemetry:
    """Pre-resolved metric children for one model kind."""

    __slots__ = ("model_kind", "iterations", "step_seconds", "last_step",
                 "samples_per_sec", "batch_size", "score")

    def __init__(self, model_kind: str, registry: MetricsRegistry):
        self.model_kind = model_kind
        lab = dict(model=model_kind)
        self.iterations = registry.counter(
            "dl4j_fit_iterations_total",
            "Training iterations completed by the fit loop",
            labels=("model",)).labels(**lab)
        self.step_seconds = registry.histogram(
            "dl4j_fit_step_seconds",
            "Per-iteration host wall time around the train-step dispatch",
            labels=("model",)).labels(**lab)
        self.last_step = registry.gauge(
            "dl4j_fit_last_step_seconds",
            "Most recent iteration's step time",
            labels=("model",)).labels(**lab)
        self.samples_per_sec = registry.gauge(
            "dl4j_fit_samples_per_second",
            "Throughput implied by the most recent step",
            labels=("model",)).labels(**lab)
        self.batch_size = registry.gauge(
            "dl4j_fit_batch_size",
            "Most recent minibatch size seen by the fit loop",
            labels=("model",)).labels(**lab)
        self.score = registry.gauge(
            "dl4j_fit_score",
            "Most recent training loss (lazy device scalar; synced at "
            "scrape)", labels=("model",)).labels(**lab)

    def span(self, iteration: int):
        """Per-iteration span (parent/child nesting handled by the
        tracer)."""
        return get_tracer().span("fit_step", model=self.model_kind,
                                 iteration=iteration)

    def record_step(self, dt_s: float, batch: Optional[int],
                    score: Any, steps: int = 1, model: Any = None) -> None:
        """Record one fit-loop dispatch.  ``score`` may be an on-device
        scalar (stored lazily).  ``steps`` > 1 for scanned windows where
        one dispatch carries several weight updates.  When ``model`` is
        given, the per-step time and throughput are also stamped on it
        (``last_step_seconds`` / ``last_samples_per_second``) so consumers
        holding the model (``ui.stats.StatsListener``) read timing that is
        identity-correct — the registry gauges below are keyed by model
        KIND and would cross-contaminate two same-class models."""
        self.iterations.inc(steps)
        per = dt_s / max(1, steps)
        self.step_seconds.observe(per)
        self.last_step.set(per)
        sps = (batch * steps / dt_s) if (batch and dt_s > 0) else None
        if batch:
            self.batch_size.set(batch)
            if sps is not None:
                self.samples_per_sec.set(sps)
        if score is not None:
            self.score.set(score)
        if model is not None:
            model.last_step_seconds = per
            if sps is not None:
                model.last_samples_per_second = sps


_lock = threading.Lock()
_cache: Dict[str, Tuple[MetricsRegistry, FitTelemetry]] = {}


def fit_telemetry(model_kind: str) -> FitTelemetry:
    """Cached handle for the current global registry; rebuilt transparently
    when tests swap the registry via ``set_registry`` AND when the same
    registry is wiped via ``reset()`` (a stale handle would keep writing
    into orphaned children that no export can see)."""
    reg = get_registry()
    with _lock:
        hit = _cache.get(model_kind)
        if (hit is not None and hit[0] is reg
                and reg.get("dl4j_fit_iterations_total") is not None):
            return hit[1]
        tel = FitTelemetry(model_kind, reg)
        _cache[model_kind] = (reg, tel)
        return tel
