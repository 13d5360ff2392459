"""Performance attribution: step profiling, step cost, MFU gauges, and
memory attribution — counterpart of
``deeplearning4j_tpu/observability/profiling.py``, re-derived on
``torch.profiler``, ``torch.cuda`` events and the port's own step cost.

- **Step cost** (``helpers/cost.py``): flops and bytes per signature of
  an instrumented step (``recompile.instrument``), counted once, on the
  signature's first eager run — on the card the genuine step that
  ``models/capture.py`` runs before it captures — under a
  ``TorchDispatchMode`` that sums matmul and convolution operations
  (``torch.utils.flop_counter``'s formulas) and each op's bytes; each
  kernel wrapper adds its own analytic operations and bytes, since the
  dispatcher never sees a ``ctypes`` launch.
- **MFU / roofline gauges**: ``dl4j_step_flops_total{fn=}``,
  ``dl4j_model_flops_utilization{component=}`` (step flops over the
  step's time over the card's peak for the tracked model's compute
  type, clamped to 1.0 as in the reference), ``dl4j_model_flops_utilization_unclamped{component=}``
  (the same ratio unclamped: above 1 is a miscount or a mistimed step,
  and shows) and ``dl4j_step_bytes_per_flop{component=}``.  A captured
  step's host seconds measure its launch, not its work (the fit loop
  does not sync between steps), so on the card the step's time is the
  device span between two CUDA events recorded around it on the current
  stream; they are read when they have completed — at a later step
  boundary, never by a wait — or at a capture's end, which syncs anyway.
  Without a card the host seconds stand, against
  ``CPU_PEAK_FLOPS_ESTIMATE``.
- **On-demand / trigger-driven trace capture** (``StepProfiler``):
  capture step N, the next step after a straggler verdict or a watchdog
  dump, or on ``request_capture()``.  A capture wraps the step in one
  ``torch.profiler.profile`` session (CPU and CUDA activity: kernels
  replayed from a CUDA graph appear by name) exported as a Chrome trace
  (``torch_trace.json``), and also exports the host-side span window as
  ``host_spans.trace.json`` and its numbers as ``capture.json``, under a
  bounded on-disk budget (oldest capture directories deleted first).
  ``torch.profiler`` sessions do not nest: a capture that comes due
  while another session runs (the tracer's ``profile``, a
  ``ProfilerListener``, a caller's) is skipped and counted in
  ``dl4j_profile_captures_skipped_total{reason}``.
- **Memory attribution**: per-leaf param/updater/net-state byte
  breakdown of tracked models, live tensors grouped by shape and dtype,
  and a per-step peak-allocation gauge from ``torch.cuda``'s counters —
  all surfaced in flight-recorder dumps so a watchdog or crash report
  shows *what held memory*.

Hot-loop cost while installed: a dict write per dispatch
(``note_dispatch``), two CUDA events and a few gauge stores per step;
nothing here waits on the device outside a capture.
"""

from __future__ import annotations

import gc
import itertools
import json
import os
import shutil
import threading
import time
import weakref
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import torch

_FLOPS = "dl4j_step_flops_total"
_MFU = "dl4j_model_flops_utilization"
_MFU_RAW = "dl4j_model_flops_utilization_unclamped"
_BPF = "dl4j_step_bytes_per_flop"
_PEAK = "dl4j_backend_peak_flops"
_CAPTURES = "dl4j_profile_captures_total"
_SKIPPED = "dl4j_profile_captures_skipped_total"
_STEP_PEAK_MEM = "dl4j_step_peak_memory_bytes"

# Dense peak FLOP/s of each card, by compute type (NVIDIA's data sheet for
# the H100 SXM part, without sparsity), keyed by a prefix of the name
# ``torch.cuda.get_device_name`` gives.  Those rates assume the card's
# full power limit.
PEAK_FLOPS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100": {"bfloat16": 989e12, "float16": 989e12,
                    "float32": 67e12},
}

# ESTIMATE: one modern server socket sustains O(100) GFLOP/s fp32 through
# a CPU step.  Only order-of-magnitude accurate — every consumer labels
# CPU-derived MFU as an estimate, and MFU is clamped to 1.0.
CPU_PEAK_FLOPS_ESTIMATE = 1e11


def peak_flops_for(device=None, dtype: str = "float32"
                   ) -> Tuple[float, str]:
    """(peak FLOP/s, source) for a torch device (default: the card when
    there is one, else the CPU) and a compute type.  source: ``"table"``
    (the data sheet), ``"cpu-estimate"`` (``CPU_PEAK_FLOPS_ESTIMATE``),
    or ``"unknown"`` (0.0 — MFU not computable)."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type == "cpu":
        return CPU_PEAK_FLOPS_ESTIMATE, "cpu-estimate"
    if dev.type != "cuda" or not torch.cuda.is_available():
        return 0.0, "unknown"
    name = torch.cuda.get_device_name(dev)
    for prefix, peaks in PEAK_FLOPS.items():
        if name.startswith(prefix) and dtype in peaks:
            return peaks[dtype], "table"
    return 0.0, "unknown"


# -------------------------------------------------------- memory attribution
def _flat(tree, path: str = ""):
    """(path, leaf) of nested dicts, lists and tuples, in the
    reference's ``keystr`` form (``['layer_0']['W']``)."""
    if isinstance(tree, dict):
        for k in tree:
            yield from _flat(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def _leaf_bytes(leaf) -> int:
    n = getattr(leaf, "nbytes", None)
    return int(n) if n is not None else 0


def model_memory_breakdown(net, top: int = 16) -> Dict[str, Any]:
    """Per-leaf byte breakdown of a model facade's params / updater state /
    net state — the "what holds the card's memory" answer for a parked
    model.  Returns section totals plus the ``top`` largest leaves with
    their tree paths."""
    sections = {
        "params": getattr(net, "params", None),
        "updater_state": getattr(net, "updater_state", None),
        "net_state": getattr(net, "net_state", None),
    }
    totals: Dict[str, int] = {}
    leaves: List[Dict[str, Any]] = []
    for section, tree in sections.items():
        total = 0
        for path, leaf in _flat(tree or {}):
            b = _leaf_bytes(leaf)
            total += b
            leaves.append({
                "section": section, "path": path, "bytes": b,
                "shape": list(getattr(leaf, "shape", ()) or ()),
                "dtype": str(getattr(leaf, "dtype", "")).replace(
                    "torch.", ""),
            })
        totals[f"{section}_bytes"] = total
    leaves.sort(key=lambda d: d["bytes"], reverse=True)
    return {
        **totals,
        "total_bytes": sum(totals.values()),
        "top_leaves": leaves[:top],
    }


def _live_tensors(device_type: str):
    """Live tensors of ``device_type`` reachable by the garbage collector,
    one per storage (views of one storage count once)."""
    seen = set()
    for obj in gc.get_objects():
        # the type, not isinstance: a proxy's __class__ may warn or raise
        if (not issubclass(type(obj), torch.Tensor)
                or obj.device.type != device_type):
            continue
        try:
            storage = obj.untyped_storage()
            key = (storage.data_ptr(), storage.nbytes())
        except (RuntimeError, NotImplementedError):
            continue
        if key in seen:
            continue
        seen.add(key)
        yield obj, key[1]


def live_buffer_snapshot(top: int = 20) -> Dict[str, Any]:
    """The live tensors of the process — on the card its CUDA tensors,
    without one the CPU's — grouped by (shape, dtype) and sorted by total
    bytes: the "what is holding memory RIGHT NOW" view a crash or hang
    dump needs.  Cost is a walk of the collector's objects; called at
    capture and dump time, never per step."""
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    groups: Dict[Tuple, List[int]] = {}
    total = count = 0
    for t, nbytes in _live_tensors(dev):
        total += nbytes
        count += 1
        key = (tuple(t.shape), str(t.dtype).replace("torch.", ""))
        g = groups.setdefault(key, [0, 0])
        g[0] += 1
        g[1] += nbytes
    ranked = sorted(groups.items(), key=lambda kv: kv[1][1], reverse=True)
    return {
        "device": dev, "total_bytes": total, "count": count,
        "top": [{"shape": list(shape), "dtype": dtype, "count": n,
                 "bytes": b} for (shape, dtype), (n, b) in ranked[:top]],
    }


def peak_memory_snapshot() -> Dict[str, Any]:
    """Per-card peak allocation (``torch.cuda``'s allocated-bytes peak);
    without a card, the live-tensor total, labeled as the estimate it
    is."""
    from deeplearning4j_tpu_torch.observability.memory import (
        device_memory_stats,
    )

    stats = device_memory_stats()
    if stats:
        return {"source": "torch.cuda", "devices": stats,
                "peak_bytes": max((per.get("peak_bytes_in_use") or 0)
                                  for per in stats.values())}
    live = live_buffer_snapshot(top=0)
    return {"source": "live_buffers_estimate",
            "peak_bytes": live["total_bytes"]}


def memory_attribution() -> Dict[str, Any]:
    """The flight-dump memory section: live tensors, the peak allocation
    and the per-leaf breakdown of every model the active profiler
    tracks."""
    out: Dict[str, Any] = {"live_buffers": live_buffer_snapshot(),
                           "peak": peak_memory_snapshot()}
    prof = _active
    if prof is not None:
        models = {}
        for kind, net in prof.tracked_models():
            try:
                models[kind] = model_memory_breakdown(net)
            except Exception as e:
                models[kind] = {"error": repr(e)}
        out["models"] = models
    return out


# --------------------------------------------------------------- profiler
class StepProfiler:
    """On-demand and trigger-driven step capture + MFU attribution.

    Usage::

        prof = StepProfiler("profiles", capture_step=3).install()
        net.fit(batches)          # step 3 is captured; MFU gauges filled
        prof.uninstall()

    or as a context manager (``with StepProfiler(...) as prof:``).

    Capture triggers (each capture is one step wrapped in a
    ``torch.profiler`` session + a host-span Chrome-trace export, named
    in a ``profile_capture`` flight event):

    - ``capture_step=N`` / ``capture_steps=(...)``: the step whose
      ``step_guard`` ``iteration`` attr matches;
    - straggler verdict (``capture_on_straggler``): the
      ``StragglerDetector`` arms a one-shot capture of the next step;
    - watchdog dump (``capture_on_watchdog``): a hang report arms a
      capture of the next step that runs;
    - ``request_capture(reason)``: manual one-shot.

    Disk budget: capture directories under ``profile_dir`` are deleted
    oldest-first once their total size exceeds ``max_disk_bytes`` (the
    newest capture is always kept).

    MFU is taken against the peak of the step's tracked model's compute
    type on its device (``peak_flops_for``; float32 where the conf names
    none or no model is tracked); ``peak_flops`` overrides it.  While
    installed,
    every ``instrument``-wrapped step reports its signature's cost
    through ``note_dispatch`` and the ``step_guard`` seam turns it into
    per-step MFU/roofline gauges — see the module docstring.
    """

    def __init__(self, profile_dir: str = "profiles", *,
                 capture_step: Optional[int] = None,
                 capture_steps: Tuple[int, ...] = (),
                 capture_on_straggler: bool = True,
                 capture_on_watchdog: bool = True,
                 max_disk_bytes: int = 256 << 20,
                 use_torch_profiler: bool = True,
                 cost_analysis: bool = True,
                 peak_flops: Optional[float] = None,
                 registry=None):
        from deeplearning4j_tpu_torch.observability.metrics import (
            get_registry,
        )

        self.profile_dir = str(profile_dir)
        self.capture_step = capture_step
        self.capture_steps = tuple(capture_steps)
        self.capture_on_straggler = capture_on_straggler
        self.capture_on_watchdog = capture_on_watchdog
        self.max_disk_bytes = int(max_disk_bytes)
        self.use_torch_profiler = use_torch_profiler
        self.cost_analysis = cost_analysis
        self.peak_flops = None if peak_flops is None else float(peak_flops)
        self._timed = torch.cuda.is_available()
        reg = registry if registry is not None else get_registry()
        self._registry = reg
        self._m_flops = reg.counter(
            _FLOPS, "FLOPs dispatched per instrumented step (the step "
            "cost counted on its signature's first run, counted once per "
            "call)", labels=("fn",))
        self._m_mfu = reg.gauge(
            _MFU, "Model FLOPs utilization of the most recent step: step "
            "FLOPs / step seconds (device span on the card) / peak FLOP/s "
            "(clamped to 1.0; the CPU peak is a documented estimate)",
            labels=("component",))
        self._m_mfu_raw = reg.gauge(
            _MFU_RAW, "The most recent step's FLOPs / seconds / peak "
            "FLOP/s, unclamped (above 1: a miscounted or mistimed step)",
            labels=("component",))
        self._m_bpf = reg.gauge(
            _BPF, "Roofline position of the most recent step: bytes "
            "moved / flops (high = memory-bound)", labels=("component",))
        self._m_peak = reg.gauge(
            _PEAK, "Peak FLOP/s assumed for the most recent step's MFU "
            "(the card's data sheet for the model's compute type; on CPU "
            "a documented order-of-magnitude estimate)",
            labels=("source",))
        self._m_caps = reg.counter(
            _CAPTURES, "Profiler trace captures written, by trigger",
            labels=("reason",))
        self._m_skipped = reg.counter(
            _SKIPPED, "Profiler trace captures skipped, by cause (busy: "
            "another torch.profiler session was running)",
            labels=("reason",))
        self._m_peak_mem = reg.gauge(
            _STEP_PEAK_MEM, "Peak device allocation observed at the end "
            "of the most recent step (torch.cuda's allocated-bytes peak; "
            "absent without a card)", labels=("component", "device"))
        self._lock = threading.Lock()
        self._pending: Optional[str] = None
        self._tls = threading.local()
        self._cap_ids = itertools.count(1)
        self._models: "weakref.WeakValueDictionary[str, Any]" = (
            weakref.WeakValueDictionary())
        # timed steps whose end events have not been read yet
        self._unread: "deque[Dict[str, Any]]" = deque()
        self.capture_paths: List[str] = []

    # ------------------------------------------------------------ lifecycle
    def install(self) -> "StepProfiler":
        global _active
        if self.peak_flops is not None:
            self._m_peak.set(self.peak_flops, source="override")
        _active = self
        return self

    def uninstall(self) -> None:
        global _active
        if _active is self:
            _active = None
        self.flush()

    def flush(self) -> None:
        """Wait for the timed steps not read yet and fill their gauges
        (``uninstall`` does; a reader that wants the newest step now)."""
        while self._unread:
            step = self._unread.popleft()
            step["events"][1].synchronize()
            self._finish_step(step)

    def __enter__(self) -> "StepProfiler":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()

    # ------------------------------------------------------------- triggers
    def request_capture(self, reason: str) -> None:
        """Arm a one-shot capture of the NEXT guarded step (thread-safe;
        a second request while one is pending is coalesced)."""
        from deeplearning4j_tpu_torch.observability.flightrecorder import (
            get_flight_recorder,
        )

        with self._lock:
            if self._pending is not None:
                return
            self._pending = str(reason)
        get_flight_recorder().record("profile_requested", reason=reason)

    # -------------------------------------------------------- model tracking
    def track_model(self, net, kind: str) -> None:
        """Weakly register a model facade for memory attribution (fit
        loops call this; a dropped model unregisters itself)."""
        self._models[str(kind)] = net

    def tracked_models(self) -> List[Tuple[str, Any]]:
        return [(k, v) for k, v in self._models.items() if v is not None]

    def peak_for(self, component: str) -> Tuple[float, str]:
        """(peak FLOP/s, source) for a step of ``component``: the
        override, else the data sheet's for the tracked model's compute
        type on its device (float32 where the conf names none)."""
        if self.peak_flops is not None:
            return self.peak_flops, "override"
        net = self._models.get(str(component))
        conf = getattr(net, "conf", None)
        dtype = getattr(conf, "compute_dtype", None) or "float32"
        return peak_flops_for(getattr(net, "device", None), dtype)

    # ------------------------------------------------------- step_guard seam
    def on_step_begin(self, name: str, attrs: Dict[str, Any]) -> Dict:
        """Called by ``step_guard`` on entry; returns the per-step frame
        that accumulates this step's dispatched cost."""
        self._read_finished()
        reason = None
        with self._lock:
            if self._pending is not None:
                reason, self._pending = self._pending, None
        if reason is None:
            it = attrs.get("iteration")
            if it is not None and (it == self.capture_step
                                   or it in self.capture_steps):
                reason = f"step:{it}"
        frame = {"flops": 0.0, "bytes": 0.0, "capture": None,
                 "events": None}
        if reason is not None:
            frame["capture"] = self._begin_capture(reason)
        if self._timed_on_card(attrs, name):
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            frame["events"] = (start, torch.cuda.Event(enable_timing=True))
        stack = getattr(self._tls, "frames", None)
        if stack is None:
            stack = self._tls.frames = []
        stack.append(frame)
        return frame

    def _timed_on_card(self, attrs: Dict[str, Any], name: str) -> bool:
        """CUDA events time the step when there is a card and the step's
        tracked model, if any, lives on it (a CPU net's step keeps its
        host seconds)."""
        if not self._timed:
            return False
        net = self._models.get(str(attrs.get("model") or attrs.get(
            "component") or name))
        dev = getattr(net, "device", None)
        return dev is None or getattr(dev, "type", None) == "cuda"

    def note_dispatch(self, fn_name: str, cost: Optional[Dict]) -> None:
        """Called by ``recompile._Instrumented`` per call with the
        signature's counted cost; accumulates into the innermost active
        step frame on this thread."""
        if not cost:
            return
        flops = float(cost.get("flops") or 0.0)
        nbytes = float(cost.get("bytes_accessed") or 0.0)
        if flops > 0:
            self._m_flops.inc(flops, fn=fn_name)
        stack = getattr(self._tls, "frames", None)
        if stack:
            stack[-1]["flops"] += flops
            stack[-1]["bytes"] += nbytes

    def on_step_end(self, name: str, seconds: float, attrs: Dict[str, Any],
                    frame: Dict, error: Optional[BaseException] = None) -> None:
        stack = getattr(self._tls, "frames", None)
        if stack:
            # remove by IDENTITY: nested frames with equal contents (all
            # zeros before any dispatch) must not evict each other
            for i in range(len(stack) - 1, -1, -1):
                if stack[i] is frame:
                    del stack[i]
                    break
        component = (attrs.get("model") or attrs.get("component") or name)
        step = {"component": component, "flops": frame["flops"],
                "bytes": frame["bytes"], "host_seconds": seconds,
                "events": frame["events"]}
        if step["events"] is not None:
            step["events"][1].record()
        cap = frame.get("capture")
        if cap is not None:
            if step["events"] is not None:
                step["events"][1].synchronize()
            self._finish_step(step)
            self._finish_capture(cap, name, step, attrs, error)
        elif step["events"] is None:
            self._finish_step(step)
        else:
            self._unread.append(step)
            self._read_finished()
        self._sample_step_memory(component)

    def _read_finished(self) -> None:
        """Gauges of the timed steps whose end event has completed, in
        order; the rest wait for a later boundary (``query`` never
        blocks)."""
        while self._unread and self._unread[0]["events"][1].query():
            self._finish_step(self._unread.popleft())

    def _finish_step(self, step: Dict[str, Any]) -> None:
        """MFU of one step: its flops over its device span (host seconds
        without a card) over the peak."""
        step["host_timed"] = step["events"] is None
        if step["events"] is not None:
            start, end = step["events"]
            step["seconds"] = start.elapsed_time(end) / 1e3
            step["events"] = None
        else:
            step["seconds"] = step["host_seconds"]
        component, flops = step["component"], step["flops"]
        seconds = step["seconds"]
        peak, step["peak_source"] = self.peak_for(component)
        step["peak_flops"] = peak
        step["mfu"] = step["mfu_unclamped"] = None
        if flops > 0 and seconds > 0:
            self._m_peak.set(peak, source=step["peak_source"])
            if peak > 0:
                raw = flops / seconds / peak
                step["mfu_unclamped"], step["mfu"] = raw, min(1.0, raw)
                self._m_mfu.set(step["mfu"], component=component)
                self._m_mfu_raw.set(raw, component=component)
            self._m_bpf.set(step["bytes"] / flops, component=component)

    def _sample_step_memory(self, component: str) -> None:
        from deeplearning4j_tpu_torch.observability.memory import (
            device_memory_stats,
        )

        for dev, per in device_memory_stats().items():
            peak = per.get("peak_bytes_in_use")
            if peak is not None:
                self._m_peak_mem.set(peak, component=component, device=dev)

    # --------------------------------------------------------------- capture
    def _begin_capture(self, reason: str) -> Optional[Dict]:
        """A capture directory and, with ``use_torch_profiler``, one
        ``torch.profiler`` session; None (counted, recorded) when another
        session is running."""
        from deeplearning4j_tpu_torch.observability.flightrecorder import (
            get_flight_recorder,
        )

        if self.use_torch_profiler and torch.autograd._profiler_enabled():
            self._m_skipped.inc(reason="busy")
            get_flight_recorder().record("profile_skipped", reason=reason,
                                         cause="busy")
            return None
        safe = "".join(c if (c.isalnum() or c in "._-") else "-"
                       for c in reason)[:48]
        cap_dir = os.path.join(self.profile_dir,
                               f"cap-{next(self._cap_ids):04d}-{safe}")
        os.makedirs(cap_dir, exist_ok=True)
        cap = {"reason": reason, "dir": cap_dir, "session": None,
               "t0_ns": time.perf_counter_ns()}
        if self.use_torch_profiler:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            session = profile(activities=acts)
            session.start()
            cap["session"] = session
        return cap

    def _finish_capture(self, cap: Dict, name: str, step: Dict[str, Any],
                        attrs: Dict, error: Optional[BaseException]) -> None:
        from deeplearning4j_tpu_torch.observability.flightrecorder import (
            get_flight_recorder,
        )
        from deeplearning4j_tpu_torch.observability.tracing import get_tracer

        trace_path = None
        if cap["session"] is not None:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            cap["session"].stop()
            trace_path = os.path.join(cap["dir"], "torch_trace.json")
            cap["session"].export_chrome_trace(trace_path)
        t1_ns = time.perf_counter_ns()
        tracer = get_tracer()
        span_path = os.path.join(cap["dir"], "host_spans.trace.json")
        spans = tracer.export_chrome_trace(
            span_path, tracer.spans_between(cap["t0_ns"], t1_ns))
        meta = {
            "reason": cap["reason"],
            "step": name,
            "attrs": {k: v for k, v in attrs.items()
                      if isinstance(v, (str, int, float, bool, type(None)))},
            "seconds": step["seconds"],
            "host_seconds": step["host_seconds"],
            "timed_on": "host" if step["host_timed"] else "cuda_events",
            "flops": step["flops"],
            "bytes_accessed": step["bytes"],
            "mfu": step["mfu"],
            "mfu_unclamped": step["mfu_unclamped"],
            "peak_flops": step["peak_flops"],
            "peak_flops_source": step["peak_source"],
            "host_spans": spans,
            "torch_trace": trace_path,
            "error": repr(error) if error is not None else None,
            "memory": {**peak_memory_snapshot(),
                       "live_buffers": live_buffer_snapshot()},
        }
        with open(os.path.join(cap["dir"], "capture.json"), "w") as f:
            json.dump(meta, f, indent=1, default=str)
        category = cap["reason"].split(":", 1)[0]
        self._m_caps.inc(reason=category)
        self.capture_paths.append(cap["dir"])
        get_flight_recorder().record(
            "profile_capture", reason=cap["reason"], step=name,
            path=cap["dir"], trace_file=span_path, torch_trace=trace_path,
            seconds=round(step["seconds"], 6), flops=step["flops"],
            mfu=None if step["mfu"] is None else round(step["mfu"], 6))
        self._enforce_budget()

    def _enforce_budget(self) -> None:
        """Delete oldest capture directories once the on-disk total
        exceeds ``max_disk_bytes`` (newest always kept)."""
        caps = []
        for entry in os.listdir(self.profile_dir):
            path = os.path.join(self.profile_dir, entry)
            if not (entry.startswith("cap-") and os.path.isdir(path)):
                continue
            size = 0
            for root, _dirs, files in os.walk(path):
                for fl in files:
                    size += os.path.getsize(os.path.join(root, fl))
            caps.append((os.path.getmtime(path), entry, path, size))
        caps.sort()   # oldest first (a name's sequence number breaks ties)
        total = sum(c[3] for c in caps)
        while total > self.max_disk_bytes and len(caps) > 1:
            _, _, path, size = caps.pop(0)
            shutil.rmtree(path, ignore_errors=True)
            total -= size


# ------------------------------------------------------------ module seams
_active: Optional[StepProfiler] = None


def active_profiler() -> Optional[StepProfiler]:
    """The installed profiler, or None (lock-free read: module-global
    assignment is atomic)."""
    return _active


def notify_straggler(component: str, worker: str) -> None:
    """Straggler-verdict hook (called by ``health.StragglerDetector``):
    arms a one-shot capture of the next step so the trace shows what the
    degraded window actually did."""
    prof = _active
    if prof is not None and prof.capture_on_straggler:
        prof.request_capture(f"straggler:{component}:{worker}")


def notify_watchdog(reason: str) -> None:
    """Watchdog-dump hook (called by ``flightrecorder.StepWatchdog``)."""
    prof = _active
    if prof is not None and prof.capture_on_watchdog:
        prof.request_capture(f"watchdog:{reason}")
