"""Lightweight span tracer: context-manager API, monotonic clocks,
parent/child nesting, JSON-lines export.

Copied from ``deeplearning4j_tpu/observability/tracing.py``; the profiler
passthrough is re-derived on ``torch.profiler``.

Spans are host-side wall-time markers around *dispatch* (on the card
the device work is async — a span brackets what the host did, which is
exactly the phase-attribution SparkNet/DeepSpark-style throughput
tuning needs).  For *device* time, enable the profiler passthrough:
with ``use_torch_profiler=True`` every span also enters a
``torch.profiler.record_function`` so spans line up with the CUDA
kernels in a ``torch.profiler`` trace, and ``SpanTracer.profile(log_dir)``
brackets a whole region with one ``torch.profiler.profile`` (CPU and, on
the card, CUDA activity) that exports a Chrome trace into ``log_dir``.

Request tracing: serving mints (or accepts via ``X-Request-Id``) a
``trace_id`` per request and stamps it on the per-stage spans
(``serving_request`` / ``serving_queue_wait`` / ``serving_execute``), so
``spans_for_trace(trace_id)`` answers "where did THIS request's time go".
``export_chrome_trace`` renders any span set as Chrome-trace JSON
(loadable in ``chrome://tracing`` / Perfetto).
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional, Tuple


def new_trace_id() -> str:
    """A 16-hex-char request trace id (random; no global coordination)."""
    return os.urandom(8).hex()


class Span:
    """One finished (or in-flight) span."""

    __slots__ = ("name", "span_id", "parent_id", "start_ns", "end_ns",
                 "attrs", "thread")

    def __init__(self, name: str, span_id: int, parent_id: Optional[int],
                 start_ns: int, attrs: Dict[str, Any],
                 thread: Optional[str] = None):
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.start_ns = start_ns
        self.end_ns: Optional[int] = None
        self.attrs = attrs
        self.thread = (thread if thread is not None
                       else threading.current_thread().name)

    @property
    def duration_ns(self) -> Optional[int]:
        if self.end_ns is None:
            return None
        return self.end_ns - self.start_ns

    @property
    def duration_ms(self) -> Optional[float]:
        d = self.duration_ns
        return None if d is None else d / 1e6

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start_ns": self.start_ns,
            "end_ns": self.end_ns,
            "duration_ns": self.duration_ns,
            "attrs": self.attrs,
            "thread": self.thread,
        }

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Span":
        s = Span(d["name"], d["span_id"], d.get("parent_id"),
                 d["start_ns"], d.get("attrs") or {},
                 thread=d.get("thread") or "unknown")
        s.end_ns = d.get("end_ns")
        return s


class SpanTracer:
    """Nesting tracer with a bounded in-memory buffer of finished spans.

    Per-thread parent tracking (a serving handler thread and the training
    loop can both trace without cross-linking), monotonic
    ``perf_counter_ns`` clocks, O(1) memory via a ``deque(maxlen=...)``.
    """

    def __init__(self, max_spans: int = 4096,
                 use_torch_profiler: bool = False):
        self.max_spans = max_spans
        self.use_torch_profiler = use_torch_profiler
        self._ids = itertools.count(1)
        self._tls = threading.local()
        self._lock = threading.Lock()
        self._finished: deque = deque(maxlen=max_spans)
        # registration id -> (thread object, live stack list).  The stack
        # is the SAME list the owning thread mutates; registering it here
        # lets the watchdog read every thread's in-flight spans at dump
        # time.  Keyed by a monotonic id, NOT thread ident: CPython
        # recycles idents immediately, so a new thread would overwrite a
        # dead thread's retained open-span entry — exactly the crash
        # evidence live_spans() promises to keep.
        self._live: Dict[int, Tuple[threading.Thread, List[Span]]] = {}
        self._live_ids = itertools.count(1)
        self._profiles = itertools.count(1)   # profile() trace files
        self.dropped = 0  # finished spans evicted by the bound

    def _stack(self) -> List[Span]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
            t = threading.current_thread()
            with self._lock:
                self._live[next(self._live_ids)] = (t, st)
        return st

    def live_spans(self) -> List[Dict[str, Any]]:
        """In-flight (unfinished) spans across ALL threads, outermost
        first per thread, each dict annotated with ``thread`` and
        ``depth``.  Reading copies each stack once; the owning thread may
        race an append/pop, which at worst makes the copy one span stale
        — acceptable for a diagnosis dump, and safe under CPython.

        Entries for threads that have exited with an EMPTY stack are
        pruned here (thread churn — per-fit prefetch workers, handler
        threads — must not grow ``_live`` for the process lifetime); a
        dead thread that still holds open spans is kept, since "this
        thread died inside span X" is exactly what a crash dump needs."""
        with self._lock:
            for rid in [rid for rid, (t, st) in self._live.items()
                        if not t.is_alive() and not st]:
                del self._live[rid]
            stacks = list(self._live.values())
        out: List[Dict[str, Any]] = []
        for t, stack in stacks:
            for depth, s in enumerate(list(stack)):
                d = s.to_dict()
                d["thread"] = t.name
                d["depth"] = depth
                out.append(d)
        return out

    @contextmanager
    def span(self, name: str, **attrs) -> Iterator[Span]:
        stack = self._stack()
        parent = stack[-1].span_id if stack else None
        s = Span(name, next(self._ids), parent, time.perf_counter_ns(), attrs)
        stack.append(s)
        annot = None
        if self.use_torch_profiler:
            try:
                import torch.profiler

                annot = torch.profiler.record_function(name)
                annot.__enter__()
            except Exception:
                annot = None
        try:
            yield s
        finally:
            if annot is not None:
                annot.__exit__(None, None, None)
            s.end_ns = time.perf_counter_ns()
            stack.pop()
            with self._lock:
                if len(self._finished) == self._finished.maxlen:
                    self.dropped += 1
                self._finished.append(s)

    @contextmanager
    def profile(self, log_dir: str) -> Iterator[None]:
        """Bracket a region with one ``torch.profiler.profile`` (CUDA
        activity too when a card is present) and export its Chrome trace
        to ``log_dir/trace-<pid>-<n>.json``; no-ops if the profiler is
        unavailable."""
        prof = None
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            prof.__enter__()
        except Exception:
            prof = None
        try:
            yield
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
                os.makedirs(str(log_dir), exist_ok=True)
                prof.export_chrome_trace(os.path.join(
                    str(log_dir),
                    f"trace-{os.getpid()}-{next(self._profiles)}.json"))

    def record_span(self, name: str, start_ns: int, end_ns: int,
                    **attrs) -> Span:
        """Record an already-timed span directly (no stack involvement):
        the batcher uses this for queue-wait and execute stages whose
        start happened on a different thread than their end.  Clocks are
        ``perf_counter_ns`` like everything else here."""
        s = Span(name, next(self._ids), None, int(start_ns), attrs)
        s.end_ns = int(end_ns)
        with self._lock:
            if len(self._finished) == self._finished.maxlen:
                self.dropped += 1
            self._finished.append(s)
        return s

    # -------------------------------------------------------------- queries
    def spans_for_trace(self, trace_id: str) -> List[Span]:
        """Finished spans stamped with ``trace_id=`` (request tracing):
        the per-stage breakdown of one serving request."""
        return [s for s in self.spans()
                if s.attrs.get("trace_id") == trace_id]

    def spans_between(self, start_ns: int, end_ns: int) -> List[Span]:
        """Finished spans overlapping the [start_ns, end_ns) window (the
        profiler's capture export)."""
        out = []
        for s in self.spans():
            if s.start_ns < end_ns and (s.end_ns or end_ns) > start_ns:
                out.append(s)
        return out

    # ------------------------------------------------------------- export
    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._finished)

    def to_jsonl(self) -> str:
        return "\n".join(json.dumps(s.to_dict()) for s in self.spans())

    def export_jsonl(self, path: str) -> int:
        """Write finished spans as JSON lines; returns the span count."""
        spans = self.spans()
        with open(path, "w") as f:
            for s in spans:
                f.write(json.dumps(s.to_dict()) + "\n")
        return len(spans)

    def to_chrome_trace(self, spans: Optional[List[Span]] = None) -> Dict:
        """Render spans as the Chrome trace event format (``ph: "X"``
        complete events, microsecond clocks) — loadable in
        ``chrome://tracing`` and Perfetto with no TensorBoard plugin.
        Threads become trace ``tid``s with ``thread_name`` metadata."""
        spans = self.spans() if spans is None else spans
        pid = os.getpid()
        tids: Dict[str, int] = {}
        events: List[Dict[str, Any]] = []
        for s in spans:
            if s.end_ns is None:
                continue
            tid = tids.setdefault(s.thread, len(tids) + 1)
            events.append({
                "name": s.name, "cat": "span", "ph": "X",
                "ts": s.start_ns / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
                "pid": pid, "tid": tid,
                "args": {**s.attrs, "span_id": s.span_id,
                         "parent_id": s.parent_id},
            })
        meta = [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                 "args": {"name": thread}} for thread, tid in tids.items()]
        return {"traceEvents": meta + events, "displayTimeUnit": "ms"}

    def export_chrome_trace(self, path: str,
                            spans: Optional[List[Span]] = None) -> int:
        """Write a Chrome-trace JSON file; returns the span event count."""
        doc = self.to_chrome_trace(spans)
        with open(path, "w") as f:
            json.dump(doc, f, default=str)
        return sum(1 for e in doc["traceEvents"] if e.get("ph") == "X")

    @staticmethod
    def read_jsonl(path: str) -> List[Span]:
        out = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    out.append(Span.from_dict(json.loads(line)))
        return out

    def clear(self) -> None:
        with self._lock:
            self._finished.clear()
            self.dropped = 0


_global_lock = threading.Lock()
_global_tracer: Optional[SpanTracer] = None


def get_tracer() -> SpanTracer:
    """The process-wide default tracer (created on first use)."""
    global _global_tracer
    with _global_lock:
        if _global_tracer is None:
            _global_tracer = SpanTracer()
        return _global_tracer


def set_tracer(tracer: Optional[SpanTracer]) -> SpanTracer:
    """Swap the process-wide tracer (tests / profiling runs)."""
    global _global_tracer
    with _global_lock:
        _global_tracer = tracer or SpanTracer()
        return _global_tracer
