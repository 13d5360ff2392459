"""Registry-backed phase timers — the ``PhaseStats`` successor.

Copied from ``deeplearning4j_tpu/observability/phases.py`` with its imports
pointed at the port's own copies.

≙ ``CommonSparkTrainingStats.java`` / ``ParameterAveragingTrainingMasterStats
.java``: the reference times count/split/repartition/mapPartitions/aggregate
per fit; here the phases are the device pipeline's sections (fetch /
place / dispatch / device_sync, gradient compute vs all-reduce vs host
sync).

Each timed phase is recorded twice:

- into a per-instance ``Histogram`` so ``as_dict()`` keeps the exact
  ``PhaseStats`` schema (count/total_ms/mean_ms/min_ms/max_ms per phase)
  that ``training_stats()`` consumers and tests rely on;
- into the process-wide registry family
  ``dl4j_phase_seconds{component=..., phase=...}`` so /metrics scrapes and
  bench snapshots see phase timing without holding a master reference.

Migration from the old private ``PhaseStats``: the class below is a drop-in
(same ``phase()`` context manager, ``steps`` counter, ``enabled`` flag,
``as_dict()``), re-exported from ``parallel.training_master`` under the old
name.  See docs/observability.md.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

from deeplearning4j_tpu_torch.observability.metrics import (
    Histogram, MetricsRegistry, get_registry,
)

_FAMILY = "dl4j_phase_seconds"


class _NullTimer:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullTimer()


class _Timer:
    __slots__ = ("_local", "_shared", "_t0")

    def __init__(self, local: Histogram, shared):
        self._local = local
        self._shared = shared

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._local.observe(dt)
        if self._shared is not None:
            self._shared.observe(dt)
        return False


class PhaseTimers:
    """Phase-timed stats for one component instance (see module doc)."""

    def __init__(self, component: str, enabled: bool = True,
                 registry: Optional[MetricsRegistry] = None):
        self.component = component
        self.enabled = enabled
        self.steps = 0
        self._registry = registry
        self._local: Dict[str, Histogram] = {}
        self._shared: Dict[str, Any] = {}
        self._shared_reg: Optional[MetricsRegistry] = None

    def phase(self, name: str):
        if not self.enabled:
            return _NULL
        reg = (self._registry if self._registry is not None
               else get_registry())
        if reg is not self._shared_reg or reg.get(_FAMILY) is None:
            # registry swapped (set_registry) or wiped (reset()): drop the
            # shared children so timings land in the LIVE registry; the
            # per-instance _local aggregates (as_dict) carry on unbroken
            self._shared.clear()
            self._shared_reg = reg
        local = self._local.get(name)
        if local is None:
            local = self._local[name] = Histogram()
        if name not in self._shared:
            self._shared[name] = reg.histogram(
                _FAMILY, "Per-phase wall time of distributed-training and "
                "pipeline components", labels=("component", "phase"),
            ).labels(component=self.component, phase=name)
        return _Timer(local, self._shared.get(name))

    def totals(self) -> Dict[str, float]:
        """Cumulative seconds per phase — cheap enough to snapshot before/
        after a batch for per-batch phase deltas (pipeline per-stage
        attribution)."""
        return {name: h.sum for name, h in self._local.items()}

    def as_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"steps": self.steps, "phases": {}}
        for name, h in self._local.items():
            if not h.count:
                continue
            out["phases"][name] = {
                "count": h.count,
                "total_ms": round(h.sum * 1e3, 3),
                "mean_ms": round(h.sum / h.count * 1e3, 3),
                "min_ms": round(h.min * 1e3, 3),
                "max_ms": round(h.max * 1e3, 3),
            }
        return out
