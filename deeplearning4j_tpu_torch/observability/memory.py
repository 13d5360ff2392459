"""Device-memory gauges: ``torch.cuda``'s memory counters sampled into the
registry — counterpart of ``deeplearning4j_tpu/observability/memory.py``,
re-derived on ``torch.cuda.memory_stats`` and ``torch.cuda.mem_get_info``
(the reference reads PJRT's ``memory_stats()`` per
``jax.local_devices()``).

Per card, the same three stats as the reference: ``bytes_in_use`` (the
caching allocator's allocated bytes), ``peak_bytes_in_use`` (their peak
since the process started or the peak was reset) and ``bytes_limit``
(the card's total memory).  Without a card everything degrades to a
graceful no-op (the gauges simply never appear), as on the reference's
CPU backend.

``DeviceMemoryMonitor`` samples on a configurable interval from a daemon
thread; ``sample_once()`` is the synchronous one-shot.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

_GAUGE = "dl4j_device_memory_bytes"
_STATS = ("bytes_in_use", "peak_bytes_in_use", "bytes_limit")


def device_memory_stats() -> Dict[str, Any]:
    """Per-card memory stats; empty dict when no card is present."""
    import torch

    out: Dict[str, Any] = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        ms = torch.cuda.memory_stats(i)
        _free, total = torch.cuda.mem_get_info(i)
        out[f"device_{i}"] = {
            "bytes_in_use": ms.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": ms.get("allocated_bytes.all.peak", 0),
            "bytes_limit": total,
        }
    return out


def sample_once(registry=None) -> Dict[str, Any]:
    """One sample: fetch the stats and mirror them into registry gauges
    ``dl4j_device_memory_bytes{device=..., stat=...}``.  Returns the raw
    per-device dict."""
    from deeplearning4j_tpu_torch.observability.metrics import get_registry

    stats = device_memory_stats()
    if stats:
        fam = (registry if registry is not None else get_registry()).gauge(
            _GAUGE, "Per-device memory stats from torch.cuda (absent "
            "without a card, e.g. CPU)", labels=("device", "stat"))
        for dev, per in stats.items():
            for stat, v in per.items():
                if v is not None:
                    fam.set(v, device=dev, stat=stat)
    return stats


class DeviceMemoryMonitor:
    """Background sampler: calls ``sample_once`` every ``interval_s``
    seconds from a daemon thread until ``stop()``.

    Usage::

        mon = DeviceMemoryMonitor(interval_s=10.0).start()
        ...
        mon.stop()
    """

    def __init__(self, interval_s: float = 10.0, registry=None):
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        self.interval_s = float(interval_s)
        self._registry = registry
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.samples = 0

    def _run(self):
        while not self._stop.is_set():
            try:
                sample_once(self._registry)
                self.samples += 1
            except Exception:
                pass  # a flaky backend must not kill the sampler thread
            self._stop.wait(self.interval_s)

    def start(self) -> "DeviceMemoryMonitor":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="dl4j-memory-monitor", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
