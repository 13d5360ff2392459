"""Training stats collection: the StatsListener pipeline.

Reference: ``deeplearning4j-ui-model/.../stats/StatsListener.java`` (score,
timing, JVM/GC memory :183-196, param/update/activation histograms & summary
stats :230-244 at configurable frequency), ``stats/api/
StatsUpdateConfiguration.java``, SBE-encoded ``Persistable`` records
(``stats/sbe/*``), ``stats/impl/SbeStatsReport.java``.

Port of ``deeplearning4j_tpu/ui/stats.py``: the histograms and summary
statistics are torch reductions where the parameters lie (on the card
for a net on the card), stacked so that a report makes ONE device-to-host copy;
records are JSON-serialisable dataclasses (replacing the SBE codegen).
Device memory comes from ``torch.cuda.memory_stats`` instead of JVM MX
beans (``observability/memory.py``).  The in-step statistics
(introspection, the numerics ledger) are harvested from the updater
state the captured step writes, one copy each per report.
"""

from __future__ import annotations

import itertools
import json
import time
from dataclasses import asdict, dataclass, field, fields
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.observability.memory import (
    device_memory_stats,  # re-exported: ui.device_memory_stats is public API
    sample_once as _sample_device_memory,
)
from deeplearning4j_tpu_torch.optimize.listeners import IterationListener

# Monotonic per-process suffix for generated session ids: two listeners
# created in the same millisecond must NOT silently interleave their
# reports into one session (the old ms-timestamp ids collided).
_SESSION_SEQ = itertools.count()


def _new_session_id(prefix: str) -> str:
    return f"{prefix}_{int(time.time() * 1000)}_{next(_SESSION_SEQ)}"


@dataclass
class StatsUpdateConfiguration:
    """≙ ``stats/api/StatsUpdateConfiguration.java``."""

    reporting_frequency: int = 1
    collect_score: bool = True
    collect_timing: bool = True
    collect_memory: bool = True
    collect_histograms_params: bool = True
    collect_histograms_updates: bool = False
    collect_histograms_activations: bool = False
    collect_mean_magnitudes: bool = True
    num_histogram_bins: int = 20
    # training introspection (device-side per-layer gradient/update/
    # activation stats, docs/observability.md): harvested into the
    # report when the model's conf enables it; anomaly_detection runs
    # the AnomalyMonitor rules on each harvested report
    collect_introspection: bool = True
    anomaly_detection: bool = True
    # precision ledger (device-side per-layer dynamic-range / format-
    # safety stats, docs/observability.md "Numerics"): harvested into
    # the report when the model's conf enables it; anomaly_detection
    # also runs the NumericsMonitor format-safety rules on each harvest
    collect_numerics: bool = True


@dataclass
class StatsInitializationReport:
    """Session-start record. ≙ ``SbeStatsInitializationReport``."""

    session_id: str
    model_class: str
    num_params: int
    num_layers: int
    start_time: float
    backend: str
    device_count: int
    model_config_json: Optional[str] = None

    def to_json(self) -> str:
        return json.dumps({"type": "init", **asdict(self)})


@dataclass
class StatsReport:
    """Per-collection record. ≙ ``SbeStatsReport``."""

    session_id: str
    iteration: int
    timestamp: float
    score: float = float("nan")
    iteration_time_ms: float = 0.0
    samples_per_second: float = 0.0
    memory: Dict[str, Any] = field(default_factory=dict)
    param_histograms: Dict[str, Any] = field(default_factory=dict)
    update_histograms: Dict[str, Any] = field(default_factory=dict)
    param_stats: Dict[str, Any] = field(default_factory=dict)
    learning_rate: float = float("nan")
    # training introspection (device-computed, one transfer per report):
    # per-layer {"norm", ["per_replica"]}, {"norm", "ratio",
    # "param_norm"}, {"mean", "std", "zero_fraction"}; replicas is the
    # data-parallel replica count when the stats are per-replica
    gradient_stats: Dict[str, Any] = field(default_factory=dict)
    update_stats: Dict[str, Any] = field(default_factory=dict)
    activation_stats: Dict[str, Any] = field(default_factory=dict)
    replicas: Optional[int] = None
    # precision ledger (device-computed, one transfer per report):
    # {"iteration", "loss_scale", "gradients"/"moments"/"activations":
    # {layer: {"max_abs", "underflow", "overflow",
    # "exponent_histogram", "verdicts"}}}
    numerics: Dict[str, Any] = field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps({"type": "update", **asdict(self)})

    @staticmethod
    def from_json(s: str) -> "StatsReport":
        d = json.loads(s)
        d.pop("type", None)
        return StatsReport.from_dict(d)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "StatsReport":
        # forward-compatible: fields a NEWER writer added are dropped
        # instead of raising, so mixed-version FileStatsStorage files
        # stay readable
        known = {f.name for f in fields(StatsReport)}
        return StatsReport(**{k: v for k, v in d.items() if k in known})


def _summary_rows(flat: torch.Tensor, bins: int):
    """One leaf's summary row (min, max, mean, stdev, mean magnitude),
    its ``bins + 1`` histogram edges and its ``bins`` counts, on the
    leaf's device: the reference's ``_summary_and_histogram`` (a bin
    index is ``clip(int((x - min) / span * bins), 0, bins - 1)``)."""
    flat = flat.detach().reshape(-1).float()
    mn, mx = flat.min(), flat.max()
    mean = flat.mean()
    std = flat.std(correction=0)
    mean_mag = flat.abs().mean()
    span = torch.clamp(mx - mn, min=1e-12)
    steps = torch.arange(bins + 1, device=flat.device,
                         dtype=torch.float32)
    edges = mn + span * steps / bins
    idx = torch.clamp(((flat - mn) / span * bins).to(torch.int32),
                      0, bins - 1).long()
    counts = torch.zeros(bins, dtype=torch.float32, device=flat.device)
    counts.scatter_add_(0, idx, torch.ones_like(flat))
    return torch.stack([mn, mx, mean, std, mean_mag]), edges, counts


def _leaf_entries(tree):
    """(name, tensor) per param leaf, walking nested subtrees
    (composite layers) in sorted key order."""
    out = []

    def walk(prefix, t):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(prefix + (str(k),), t[k])
        elif t is not None:
            out.append(("/".join(prefix), t))

    for layer, params in tree.items():
        if params:
            walk((str(layer),), params)
    return out


def _tensor_stats(tree, bins: int) -> Dict[str, Any]:
    """Every leaf's summary and histogram, computed where the leaves lie
    and copied to the host together (the report's one copy)."""
    entries = _leaf_entries(tree)
    if not entries:
        return {}
    names = [n for n, _ in entries]
    with torch.no_grad():
        parts = [_summary_rows(t, bins) for _, t in entries]
        packed = torch.cat([torch.cat(p) for p in parts]).cpu().numpy()
    width = 5 + (bins + 1) + bins
    out = {}
    for i, name in enumerate(names):
        row = packed[i * width:(i + 1) * width]
        mn, mx, mean, std, mm = (float(v) for v in row[:5])
        out[name] = {
            "min": mn, "max": mx, "mean": mean, "stdev": std,
            "mean_magnitude": mm,
            "bins": [float(v) for v in row[5:6 + bins]],
            "counts": [int(v) for v in row[6 + bins:]],
        }
    return out


def _backend_of(model) -> str:
    """``cuda`` or ``cpu``: where the model's tensors lie."""
    dev = getattr(model, "device", None)
    return getattr(dev, "type", None) or (
        "cuda" if torch.cuda.is_available() else "cpu")


# device_memory_stats lives in observability.memory (torch.cuda memory
# statistics, ≙ JVM memory MX beans in the reference); imported above.


class StatsListener(IterationListener):
    """Collects per-iteration stats into a StatsStorage router.
    ≙ ``StatsListener.java``.

    Timing/throughput come from the shared metrics registry (the fit loops
    record ``dl4j_fit_last_step_seconds`` / ``dl4j_fit_samples_per_second``
    around the actual step dispatch) instead of re-deriving them from this
    listener's own wall clock; the clock remains as a fallback for custom
    training loops that bypass the instrumented facades."""

    def __init__(self, storage, session_id: Optional[str] = None,
                 config: Optional[StatsUpdateConfiguration] = None,
                 registry=None, anomaly_monitor=None):
        self.storage = storage
        self.session_id = session_id or _new_session_id("session")
        self.config = config or StatsUpdateConfiguration()
        self.registry = registry
        self._anomaly = anomaly_monitor   # lazily defaulted on first use
        self._num_anomaly = None          # NumericsMonitor, same lifecycle
        self._last_time: Optional[float] = None
        self._initialized = False

    def _registry_timing(self, model):
        """(step_seconds, samples_per_sec) for THIS model, or Nones.

        The fit loops stamp ``last_step_seconds`` / ``last_samples_per_
        second`` on the model instance (identity-correct even with several
        same-class models in one process); the kind-labeled registry gauges
        are NOT used here precisely because they would cross-contaminate."""
        return (getattr(model, "last_step_seconds", None),
                getattr(model, "last_samples_per_second", None))

    def _init_report(self, model) -> None:
        rep = StatsInitializationReport(
            session_id=self.session_id,
            model_class=type(model).__name__,
            num_params=model.num_params() if hasattr(model, "num_params") else 0,
            num_layers=len(getattr(model, "layers", [])) or
                       len(getattr(getattr(model, "conf", None), "nodes", [])),
            start_time=time.time(),
            backend=_backend_of(model),
            device_count=max(1, torch.cuda.device_count()),
            model_config_json=(model.conf.to_json()
                               if hasattr(model, "conf") and
                               hasattr(model.conf, "to_json") else None),
        )
        self.storage.put_init_report(rep)
        self._initialized = True

    def iteration_done(self, model, iteration: int) -> None:
        cfg = self.config
        if not self._initialized:
            self._init_report(model)
        if iteration % max(cfg.reporting_frequency, 1) != 0:
            return
        now = time.time()
        dt_ms = (now - self._last_time) * 1000 if self._last_time else 0.0
        self._last_time = now
        rep = StatsReport(session_id=self.session_id, iteration=iteration,
                          timestamp=now)
        if cfg.collect_score:
            rep.score = float(getattr(model, "score_value", float("nan")))
        if cfg.collect_timing:
            step_s, sps = self._registry_timing(model)
            rep.iteration_time_ms = (step_s * 1e3 if step_s else dt_ms)
            if sps:
                rep.samples_per_second = sps
        if cfg.collect_memory:
            # one shared sample: the report embeds it AND the registry
            # gauges (dl4j_device_memory_bytes) pick it up
            rep.memory = _sample_device_memory(self.registry)
        if cfg.collect_histograms_params and getattr(model, "params", None):
            rep.param_histograms = _tensor_stats(model.params,
                                                 cfg.num_histogram_bins)
        if cfg.collect_mean_magnitudes and getattr(model, "params", None):
            rep.param_stats = {
                k: {"mean_magnitude": v["mean_magnitude"]}
                for k, v in (rep.param_histograms or _tensor_stats(
                    model.params, cfg.num_histogram_bins)).items()}
        if cfg.collect_introspection:
            self._collect_introspection(model, rep, iteration)
        if cfg.collect_numerics:
            self._collect_numerics(model, rep, iteration)
        self.storage.put_update(rep)

    def _collect_introspection(self, model, rep: StatsReport,
                               iteration: int) -> None:
        """Harvest the device-side introspection subtree (one batched
        transfer), extend the report, mirror the dl4j_layer_* gauges,
        and run the anomaly rules.  A model without
        ``conf.introspection`` contributes nothing."""
        from deeplearning4j_tpu_torch.observability import introspection

        harvested = introspection.harvest_model(model)
        if harvested is None:
            return
        rep.gradient_stats = harvested["gradient_stats"]
        rep.update_stats = harvested["update_stats"]
        rep.activation_stats = harvested["activation_stats"]
        rep.replicas = harvested["replicas"]
        introspection.publish_metrics(harvested, registry=self.registry)
        if self.config.anomaly_detection:
            if self._anomaly is None:
                self._anomaly = introspection.AnomalyMonitor(
                    component=type(model).__name__)
            self._anomaly.check(harvested, iteration=iteration)

    def _collect_numerics(self, model, rep: StatsReport,
                          iteration: int) -> None:
        """Harvest the device-side precision ledger (one batched
        transfer), embed it in the report, mirror the
        ``dl4j_layer_overflow_risk`` / ``dl4j_layer_max_abs`` gauges,
        and run the format-safety rules.  A model without
        ``conf.numerics`` contributes nothing."""
        from deeplearning4j_tpu_torch.observability import numerics

        harvested = numerics.harvest_model(model)
        if harvested is None:
            return
        rep.numerics = harvested
        numerics.publish_metrics(harvested, registry=self.registry)
        if self.config.anomaly_detection:
            if self._num_anomaly is None:
                self._num_anomaly = numerics.NumericsMonitor(
                    component=type(model).__name__)
            self._num_anomaly.check(harvested, iteration=iteration)


class HistogramIterationListener(StatsListener):
    """Weight-histogram collection shorthand.
    ≙ ``ui/weights/HistogramIterationListener.java``."""

    def __init__(self, storage, frequency: int = 1):
        super().__init__(storage, config=StatsUpdateConfiguration(
            reporting_frequency=frequency,
            collect_histograms_params=True,
            collect_memory=False))


class FlowIterationListener(IterationListener):
    """Model-structure snapshot (layer DAG + per-layer param counts) —
    feeds the flow view.  ≙ ``ui/flow/FlowIterationListener.java``."""

    def __init__(self, storage, session_id: Optional[str] = None,
                 frequency: int = 10):
        self.storage = storage
        self.session_id = session_id or _new_session_id("flow")
        self.frequency = frequency

    def iteration_done(self, model, iteration: int) -> None:
        if iteration % max(self.frequency, 1) != 0:
            return
        layers = []
        if hasattr(model, "layers"):
            for l in model.layers:
                layers.append({
                    "name": l.name,
                    "type": type(l).__name__,
                    "params": int(sum(
                        int(np.prod(p.shape)) for _, p in _leaf_entries(
                            {l.name: model.params.get(l.name, {})}))),
                })
        self.storage.put_update(StatsReport(
            session_id=self.session_id, iteration=iteration,
            timestamp=time.time(),
            param_stats={"flow": {"layers": layers}}))
