"""Training UI (counterpart of ``deeplearning4j_tpu.ui``): the stats
listeners and the stats storage.  The HTTP dashboard (``server.py``), the
declarative components and the renders come with ROADMAP A8.
"""

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
    "FlowIterationListener", "HistogramIterationListener",
    "StatsInitializationReport", "StatsListener", "StatsReport",
    "StatsUpdateConfiguration", "device_memory_stats", "FileStatsStorage",
    "InMemoryStatsStorage", "StatsStorage",
]
