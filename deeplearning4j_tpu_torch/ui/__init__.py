"""Training UI (counterpart of ``deeplearning4j_tpu.ui``): the stats
listeners and storages, the declarative chart and table components, the
activation renders with ``ConvolutionalIterationListener``, and the HTTP
dashboard ``UIServer`` (SSE stream, run comparison, per-layer drill-down,
introspection, numerics, ``/metrics``, ``/memory``, ``/health``, the
generation-cache and fleet panels, ``POST /collect``) with
``RemoteStatsListener``.
"""

from deeplearning4j_tpu_torch.ui.components import (
    ChartHistogram,
    ChartLine,
    ChartScatter,
    ChartStackedArea,
    Component,
    ComponentDiv,
    ComponentTable,
    ComponentText,
    StyleChart,
    component_from_dict,
)
from deeplearning4j_tpu_torch.ui.render import (
    ConvolutionalIterationListener, activation_grid, write_png,
)
from deeplearning4j_tpu_torch.ui.server import RemoteStatsListener, UIServer
from deeplearning4j_tpu_torch.ui.stats import (
    FlowIterationListener,
    HistogramIterationListener,
    StatsInitializationReport,
    StatsListener,
    StatsReport,
    StatsUpdateConfiguration,
    device_memory_stats,
)
from deeplearning4j_tpu_torch.ui.storage import (
    FileStatsStorage,
    InMemoryStatsStorage,
    StatsStorage,
)

__all__ = [
    "ChartHistogram", "ChartLine", "ChartScatter", "ChartStackedArea",
    "Component", "ComponentDiv", "ComponentTable", "ComponentText",
    "StyleChart", "component_from_dict", "ConvolutionalIterationListener",
    "activation_grid", "write_png", "RemoteStatsListener", "UIServer",
    "FlowIterationListener", "HistogramIterationListener",
    "StatsInitializationReport", "StatsListener", "StatsReport",
    "StatsUpdateConfiguration", "device_memory_stats", "FileStatsStorage",
    "InMemoryStatsStorage", "StatsStorage",
]
