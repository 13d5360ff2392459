"""Flight recorder + step watchdog: the crash/hang diagnosis layer.

Copied from ``deeplearning4j_tpu/observability/flightrecorder.py`` with its
imports pointed at the port's own copies.  The report's ``device_memory``
section reads ``observability/memory.py`` (``torch.cuda``'s counters),
its ``memory_attribution`` section ``observability/profiling.py``, its
``sharding_ledger`` section ``observability/shardstats.py`` (the newest
ledger of each master).

When an 8-worker training run (or a serving dispatcher) stops making
progress, a Prometheus scrape tells you *that* it is stuck, not *where*.
The reference stack leaned on Spark's driver UI for that; here the
equivalent is a **flight recorder** — a bounded ring buffer of structured
events (step begin/end, compile, model swap, shed, checkpoint) that the
fit loops, the training masters, and the serving engine feed as they run —
plus a **step watchdog**: a daemon thread that notices an armed step or
dispatch exceeding its deadline and dumps everything a human needs to
diagnose the hang into one JSONL report:

- the flight record (the last N structured events, newest last),
- the live span stack of every thread (what each thread is *inside of*
  right now — ``SpanTracer.live_spans``),
- a registry snapshot (every metric family as JSON),
- device-memory stats (HBM pressure is the classic accelerator hang
  cause).

The same report is produced on a fit-loop exception (``crash_dump``), so a
crashed run leaves the identical artifact a hung run would.  Reading a
dump: docs/observability.md ("reading a flight-recorder dump").

Hot-loop cost: ``record()`` is one lock + deque append; ``step_guard`` adds
two of those plus a dict store when a watchdog is armed.  Nothing here ever
forces a device->host sync.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

_DUMPS = "dl4j_watchdog_dumps_total"


class FlightEvent:
    """One structured event: wall-clock + monotonic timestamps, a kind
    (``step_begin``/``step_end``/``step_error``/``compile``/``swap``/
    ``shed``/``checkpoint``/...), and free-form attrs."""

    __slots__ = ("ts", "mono_ns", "kind", "attrs")

    def __init__(self, kind: str, attrs: Dict[str, Any]):
        self.ts = time.time()
        self.mono_ns = time.perf_counter_ns()
        self.kind = kind
        self.attrs = attrs

    def to_dict(self) -> Dict[str, Any]:
        return {"ts": self.ts, "mono_ns": self.mono_ns, "kind": self.kind,
                **self.attrs}


class FlightRecorder:
    """Bounded ring buffer of recent ``FlightEvent``s (O(1) memory however
    long the run; ``dropped`` counts evictions)."""

    def __init__(self, capacity: int = 2048):
        self.capacity = capacity
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=capacity)
        self.dropped = 0

    def record(self, kind: str, **attrs) -> None:
        ev = FlightEvent(kind, attrs)
        with self._lock:
            if len(self._events) == self._events.maxlen:
                self.dropped += 1
            self._events.append(ev)

    def events(self) -> List[FlightEvent]:
        with self._lock:
            return list(self._events)

    def to_list(self) -> List[Dict[str, Any]]:
        return [e.to_dict() for e in self.events()]

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0


_global_lock = threading.Lock()
_global_recorder: Optional[FlightRecorder] = None


def get_flight_recorder() -> FlightRecorder:
    """The process-wide default recorder (created on first use)."""
    global _global_recorder
    rec = _global_recorder
    if rec is not None:
        return rec
    with _global_lock:
        if _global_recorder is None:
            _global_recorder = FlightRecorder()
        return _global_recorder


def set_flight_recorder(rec: Optional[FlightRecorder]) -> FlightRecorder:
    """Swap the process-wide recorder (tests); returns the new one."""
    global _global_recorder
    with _global_lock:
        _global_recorder = rec or FlightRecorder()
        return _global_recorder


# --------------------------------------------------------------- dump report
def dump_flight_report(path: str, reason: str, *, recorder=None, tracer=None,
                       registry=None, context: Optional[Dict] = None) -> str:
    """Write the full diagnosis artifact as JSON lines (one record per
    line; the ``record`` field says which kind).  Every section is
    best-effort — a broken backend must not prevent the rest of the dump."""
    from deeplearning4j_tpu_torch.observability.metrics import get_registry
    from deeplearning4j_tpu_torch.observability.tracing import get_tracer

    rec = recorder if recorder is not None else get_flight_recorder()
    tr = tracer if tracer is not None else get_tracer()
    reg = registry if registry is not None else get_registry()
    lines: List[Dict[str, Any]] = [{
        "record": "meta", "reason": reason, "time": time.time(),
        "pid": os.getpid(), "context": context or {},
        "events_dropped": rec.dropped,
    }]
    for ev in rec.events():
        lines.append({"record": "event", **ev.to_dict()})
    try:
        for span in tr.live_spans():
            lines.append({"record": "live_span", **span})
    except Exception as e:
        lines.append({"record": "error", "section": "live_spans",
                      "error": repr(e)})
    try:
        lines.append({"record": "registry", "metrics": reg.to_json()})
    except Exception as e:
        lines.append({"record": "error", "section": "registry",
                      "error": repr(e)})
    try:
        from deeplearning4j_tpu_torch.observability.memory import device_memory_stats

        lines.append({"record": "device_memory",
                      "devices": device_memory_stats()})
    except Exception as e:
        lines.append({"record": "error", "section": "device_memory",
                      "error": repr(e)})
    try:
        # WHAT holds the memory: live buffers by shape/dtype plus the
        # per-leaf breakdown of any profiler-tracked model
        from deeplearning4j_tpu_torch.observability import profiling

        lines.append({"record": "memory_attribution",
                      **profiling.memory_attribution()})
    except Exception as e:
        lines.append({"record": "error", "section": "memory_attribution",
                      "error": repr(e)})
    try:
        # WHERE the bytes live: the most recent sharding ledger per
        # component (per-device bytes, replication factors, ZeRO
        # projection) so an OOM-adjacent hang dump carries per-tree
        # byte attribution in the post-mortem
        from deeplearning4j_tpu_torch.observability import shardstats

        lines.append({"record": "sharding_ledger",
                      "ledgers": shardstats.latest_ledgers()})
    except Exception as e:
        lines.append({"record": "error", "section": "sharding_ledger",
                      "error": repr(e)})
    with open(path, "w") as f:
        for obj in lines:
            f.write(json.dumps(obj, default=str) + "\n")
    return path


def read_flight_report(path: str) -> List[Dict[str, Any]]:
    """Parse a report back into its records (runbook/test helper)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


class StepWatchdog:
    """Daemon thread watching armed steps/dispatches against a deadline.

    Usage::

        wd = StepWatchdog(deadline_s=120.0, report_dir="diag").install()
        # fit loops / serving automatically arm via step_guard(); a step
        # exceeding its deadline dumps flight-<reason>-<pid>-<n>.jsonl
        ...
        wd.uninstall()

    One dump per hung step (re-armed steps dump again); a completed step
    disarms itself.  ``dump()`` is public so crash paths (fit-loop
    exceptions) produce the identical artifact.
    """

    def __init__(self, deadline_s: float = 60.0, report_dir: str = ".",
                 poll_interval_s: Optional[float] = None, recorder=None,
                 tracer=None, registry=None):
        if deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        self.deadline_s = float(deadline_s)
        self.report_dir = str(report_dir)
        self.poll_interval_s = (poll_interval_s if poll_interval_s is not None
                                else max(0.05, min(1.0, deadline_s / 4.0)))
        self._recorder = recorder
        self._tracer = tracer
        self._registry = registry
        self._lock = threading.Lock()
        self._armed: Dict[int, Dict[str, Any]] = {}
        self._tokens = itertools.count(1)
        self._seq = itertools.count(1)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.dumps: List[str] = []          # report paths, oldest first

    # ------------------------------------------------------------ arm/disarm
    def arm(self, name: str, deadline_s: Optional[float] = None,
            **attrs) -> int:
        token = next(self._tokens)
        entry = {
            "name": name, "attrs": attrs,
            "armed_at": time.monotonic(),
            "deadline": time.monotonic() + (deadline_s or self.deadline_s),
            "thread": threading.current_thread().name,
            "dumped": False,
        }
        with self._lock:
            self._armed[token] = entry
        return token

    def disarm(self, token: int) -> None:
        with self._lock:
            self._armed.pop(token, None)

    @contextmanager
    def watch(self, name: str, deadline_s: Optional[float] = None, **attrs):
        token = self.arm(name, deadline_s, **attrs)
        try:
            yield
        finally:
            self.disarm(token)

    # --------------------------------------------------------------- thread
    def _run(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            now = time.monotonic()
            overdue = []
            with self._lock:
                for entry in self._armed.values():
                    if not entry["dumped"] and now > entry["deadline"]:
                        entry["dumped"] = True
                        overdue.append(entry)
            for entry in overdue:
                try:
                    self.dump("hang", step=entry["name"],
                              thread=entry["thread"],
                              overdue_s=round(now - entry["deadline"], 3),
                              armed_s=round(now - entry["armed_at"], 3),
                              **entry["attrs"])
                except Exception:
                    pass   # a failing dump must not kill the watchdog

    def dump(self, reason: str, **context) -> str:
        """Write one report now (used by the poll loop and by crash
        paths); returns the report path."""
        from deeplearning4j_tpu_torch.observability.metrics import get_registry

        os.makedirs(self.report_dir, exist_ok=True)
        path = os.path.join(
            self.report_dir,
            f"flight-{reason}-{os.getpid()}-{next(self._seq)}.jsonl")
        dump_flight_report(path, reason, recorder=self._recorder,
                           tracer=self._tracer, registry=self._registry,
                           context=context)
        reg = (self._registry if self._registry is not None
               else get_registry())
        reg.counter(
            _DUMPS, "Flight-recorder reports written by the step watchdog "
            "(hang) and crash paths (exception)", labels=("reason",)
        ).inc(reason=reason)
        self.dumps.append(path)
        try:
            # capture-on-watchdog: arm the installed profiler so the next
            # step that runs after this dump gets a full trace capture
            from deeplearning4j_tpu_torch.observability import profiling

            profiling.notify_watchdog(reason)
        except Exception:
            pass
        return path

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "StepWatchdog":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="dl4j-step-watchdog", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def install(self) -> "StepWatchdog":
        """Start and make this the process-wide watchdog that
        ``step_guard`` arms automatically."""
        global _active_watchdog
        self.start()
        _active_watchdog = self
        return self

    def uninstall(self) -> None:
        global _active_watchdog
        if _active_watchdog is self:
            _active_watchdog = None
        self.stop()


_active_watchdog: Optional[StepWatchdog] = None


def get_watchdog() -> Optional[StepWatchdog]:
    """The installed watchdog, or None (reads are lock-free: assignment of
    a module global is atomic)."""
    return _active_watchdog


# ------------------------------------------------------------- integration
@contextmanager
def step_guard(name: str, **attrs):
    """The one hook fit loops, masters, and the serving dispatcher wrap
    their step/dispatch in: records ``step_begin``/``step_end`` (or
    ``step_error``) flight events and arms the installed watchdog for
    the duration, and — when a ``StepProfiler`` is installed — opens the
    per-step attribution frame that turns dispatched FLOPs into
    MFU/roofline gauges (and trace captures on trigger).  Dump-on-
    exception lives in ``crash_dump`` (called once at the fit-loop level)
    so a failing step is recorded here but reported exactly once there."""
    rec = get_flight_recorder()
    rec.record("step_begin", name=name, **attrs)
    wd = _active_watchdog
    token = wd.arm(name, **attrs) if wd is not None else None
    prof = frame = None
    try:
        from deeplearning4j_tpu_torch.observability import profiling

        prof = profiling.active_profiler()
        if prof is not None:
            frame = prof.on_step_begin(name, attrs)
    except Exception:   # a broken profiler must never break training
        prof = frame = None
    t0 = time.perf_counter()
    err = None
    try:
        yield
    except BaseException as e:
        err = e
        rec.record("step_error", name=name, error=repr(e), **attrs)
        raise
    else:
        rec.record("step_end", name=name,
                   seconds=round(time.perf_counter() - t0, 6), **attrs)
    finally:
        if wd is not None:
            wd.disarm(token)
        if prof is not None and frame is not None:
            try:
                prof.on_step_end(name, time.perf_counter() - t0, attrs,
                                 frame, error=err)
            except Exception:
                pass


def crash_dump(reason: str, **context) -> Optional[str]:
    """Record a ``crash`` flight event and, when a watchdog is installed,
    write the same JSONL report a hang would produce.  Returns the report
    path (None when no watchdog is installed — there is nowhere configured
    to write to)."""
    get_flight_recorder().record("crash", reason=reason, **context)
    wd = _active_watchdog
    if wd is None:
        return None
    try:
        return wd.dump(reason, **context)
    except Exception:
        return None
