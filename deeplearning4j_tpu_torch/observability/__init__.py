"""Telemetry core (counterpart of ``deeplearning4j_tpu.observability``):
metrics registry, span tracing, recompile (capture) detection,
device-memory gauges, phase timers, the serving and decode metric
bundles, the decode SLO tracker, the flight recorder, and the health
rules with the cluster aggregation, the fit telemetry, the in-step
introspection and numerics engines (``introspection``, ``numerics``:
their host halves, and the monitors) and the float64 kernel-trust
sweep (``kerneldiff``), the step profiler with its cost and memory
attribution (``profiling``), the bench regression sentinel
(``regression``), the fleet's telemetry publisher and aggregator, and
the sharding ledger with the slot programs' collective census
(``shardstats``).
"""

from deeplearning4j_tpu_torch.observability.metrics import (
    DEFAULT_BUCKETS, Counter, Gauge, Histogram, MetricFamily,
    MetricsRegistry, get_registry, set_registry,
)
from deeplearning4j_tpu_torch.observability.tracing import (
    Span, SpanTracer, get_tracer, new_trace_id, set_tracer,
)
from deeplearning4j_tpu_torch.observability.profiling import (
    PEAK_FLOPS, StepProfiler, active_profiler, live_buffer_snapshot,
    memory_attribution, model_memory_breakdown, peak_flops_for,
    peak_memory_snapshot,
)
from deeplearning4j_tpu_torch.observability.recompile import (
    RecompileDetector, compile_counter, fingerprint, instrument,
)
from deeplearning4j_tpu_torch.observability.memory import (
    DeviceMemoryMonitor, device_memory_stats, sample_once,
)
from deeplearning4j_tpu_torch.observability.phases import PhaseTimers
from deeplearning4j_tpu_torch.observability.fleet import (
    FleetAggregator, SLOTracker, TelemetryPublisher,
)
from deeplearning4j_tpu_torch.observability.servingmetrics import (
    GenerationMetrics, ServingMetrics,
)
from deeplearning4j_tpu_torch.observability.health import (
    ClusterStatsAggregator, HealthEvaluator, HealthRule, HealthVerdict,
    StragglerDetector, WorkerTelemetry, default_serving_rules,
    default_training_rules, histogram_quantile,
)
from deeplearning4j_tpu_torch.observability.flightrecorder import (
    FlightEvent, FlightRecorder, StepWatchdog, crash_dump,
    dump_flight_report, get_flight_recorder, get_watchdog,
    read_flight_report, set_flight_recorder, step_guard,
)
from deeplearning4j_tpu_torch.observability.fitmetrics import (
    FitTelemetry, fit_telemetry,
)
from deeplearning4j_tpu_torch.observability import (  # noqa: E402
    introspection, kerneldiff, numerics, regression,
)
from deeplearning4j_tpu_torch.observability.introspection import (
    AnomalyMonitor,
)
from deeplearning4j_tpu_torch.observability.numerics import NumericsMonitor

__all__ = [
    "DEFAULT_BUCKETS", "Counter", "Gauge", "Histogram", "MetricFamily",
    "MetricsRegistry", "get_registry", "set_registry",
    "Span", "SpanTracer", "get_tracer", "new_trace_id", "set_tracer",
    "PEAK_FLOPS", "StepProfiler", "active_profiler", "live_buffer_snapshot",
    "memory_attribution", "model_memory_breakdown", "peak_flops_for",
    "peak_memory_snapshot",
    "RecompileDetector", "compile_counter", "fingerprint", "instrument",
    "DeviceMemoryMonitor", "device_memory_stats", "sample_once",
    "PhaseTimers", "FleetAggregator", "SLOTracker", "TelemetryPublisher",
    "GenerationMetrics", "ServingMetrics",
    "ClusterStatsAggregator", "HealthEvaluator", "HealthRule",
    "HealthVerdict", "StragglerDetector", "WorkerTelemetry",
    "default_serving_rules", "default_training_rules", "histogram_quantile",
    "FlightEvent", "FlightRecorder", "StepWatchdog", "crash_dump",
    "dump_flight_report", "get_flight_recorder", "get_watchdog",
    "read_flight_report", "set_flight_recorder", "step_guard",
    "FitTelemetry", "fit_telemetry", "introspection", "kerneldiff",
    "numerics", "regression", "AnomalyMonitor", "NumericsMonitor",
]
