"""Training-event listeners — the observability spine.

Reference: ``optimize/api/IterationListener.java`` invoked from the SGD hot
loop (``StochasticGradientDescent.java:65-66``); built-ins
``ScoreIterationListener``, ``PerformanceListener`` (samples/sec :71-86),
``CollectScoresIterationListener``, ``ComposableIterationListener``.
Listeners run on the host after each step's replay, so they never break
the captured graph; the score they may read is the lazy device scalar, and
a listener that does not read it forces no sync.

Port: a copy of ``deeplearning4j_tpu/optimize/listeners.py``; the
``ProfilerListener`` traces with ``torch.profiler`` and exports a Chrome
trace.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, List, Optional

logger = logging.getLogger("deeplearning4j_tpu_torch")


class IterationListener:
    def iteration_done(self, model, iteration: int) -> None:
        raise NotImplementedError


class ScoreIterationListener(IterationListener):
    def __init__(self, print_iterations: int = 10, log=None):
        self.freq = max(1, print_iterations)
        self.log = log or logger.info

    def iteration_done(self, model, iteration):
        if iteration % self.freq == 0:
            score = getattr(model, "score_value", None)
            if score is None:  # models without a score surface (e.g. raw
                score = float("nan")  # pretrain wrappers) must not crash
            self.log(f"Score at iteration {iteration} is {score}")


class PerformanceListener(IterationListener):
    """Throughput: samples/sec, batches/sec, iteration wall time.

    Beyond the per-iteration instant numbers it keeps a rolling window
    (last ``window`` iterations) whose smoothed samples/sec rides along in
    every report, and — when the caller knows the run length
    (``total_iterations``) — an ETA extrapolated from the rolling mean
    iteration time.  An unknown epoch/run length is fine: the ETA simply
    stays out of the report (most streaming iterators cannot predict
    their length)."""

    def __init__(self, frequency: int = 1, report: Optional[Callable] = None,
                 total_iterations: Optional[int] = None, window: int = 50):
        from collections import deque

        self.freq = max(1, frequency)
        self.report = report or logger.info
        self.total_iterations = total_iterations
        self._last_time: Optional[float] = None
        self.last_samples_per_sec: Optional[float] = None
        self.last_iteration_ms: Optional[float] = None
        self.rolling_samples_per_sec: Optional[float] = None
        self.eta_seconds: Optional[float] = None
        self._batch_size: Optional[int] = None
        self._dts = deque(maxlen=max(2, window))
        self._samples = deque(maxlen=max(2, window))
        self._seen = 0   # iterations THIS listener observed (the model's
        # global counter survives resumes/earlier fits and would zero the
        # ETA of any run that isn't the model's first)

    def set_batch_size(self, n: int):
        """Called automatically by the fit loops with the actual minibatch
        size (``models.common.notify_listeners``); manual calls still work
        for custom training loops."""
        self._batch_size = n

    def iteration_done(self, model, iteration):
        now = time.perf_counter()
        if self._last_time is not None:
            dt = now - self._last_time
            self.last_iteration_ms = dt * 1e3
            # prefer the explicitly wired batch size; fall back to the fit
            # loop's last_batch_size mirror so samples/sec always reports
            bs = self._batch_size or getattr(model, "last_batch_size", None)
            if bs:
                self.last_samples_per_sec = bs / dt
            self._dts.append(dt)
            self._samples.append(bs or 0)
            wall = sum(self._dts)
            if wall > 0 and sum(self._samples):
                self.rolling_samples_per_sec = sum(self._samples) / wall
            if self.total_iterations:
                remaining = max(0, self.total_iterations - (self._seen + 1))
                self.eta_seconds = remaining * (wall / len(self._dts))
            if iteration % self.freq == 0:
                msg = f"iteration {iteration}; iteration time: {self.last_iteration_ms:.2f} ms"
                if self.last_samples_per_sec:
                    msg += f"; samples/sec: {self.last_samples_per_sec:.2f}"
                if self.rolling_samples_per_sec:
                    msg += (f"; rolling samples/sec: "
                            f"{self.rolling_samples_per_sec:.2f}")
                if self.eta_seconds is not None:
                    msg += f"; ETA: {self.eta_seconds:.1f}s"
                self.report(msg)
        self._seen += 1
        self._last_time = now


class CollectScoresIterationListener(IterationListener):
    def __init__(self, frequency: int = 1):
        self.freq = max(1, frequency)
        self.scores: List[tuple] = []

    def iteration_done(self, model, iteration):
        if iteration % self.freq == 0:
            self.scores.append((iteration, model.score_value))


class ComposableIterationListener(IterationListener):
    def __init__(self, *listeners):
        self.listeners = list(listeners)

    def set_batch_size(self, n: int):
        for l in self.listeners:
            setter = getattr(l, "set_batch_size", None)
            if setter is not None:
                setter(n)

    def iteration_done(self, model, iteration):
        for l in self.listeners:
            l.iteration_done(model, iteration)


class ProfilerListener(IterationListener):
    """Captures a ``torch.profiler`` trace (CPU and, on the card, CUDA
    activity) of the ``duration`` training steps AFTER iteration
    ``start_iteration``, written as a Chrome trace
    (``<log_dir>/trace.json``) when the window closes.  The trace opens
    in step ``start``'s ``iteration_done`` and closes in step
    ``start + duration``'s.  View it in ``chrome://tracing`` or Perfetto.
    """

    def __init__(self, log_dir: str, start_iteration: int = 5,
                 duration: int = 5):
        self.log_dir = str(log_dir)
        self.start = start_iteration
        self.end = start_iteration + duration
        self._active = False
        self._prof = None
        self.trace_path: Optional[str] = None

    def iteration_done(self, model, iteration):
        """Callback-driven capture (see the class docstring).  If training
        ends inside the window, the trace stays open until ``stop()`` —
        call it from the training script — or the atexit flush at
        process exit."""
        if not self._active and self.start <= iteration < self.end:
            import atexit

            import torch

            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()
            self._active = True
            atexit.register(self.stop)
        elif self._active and iteration >= self.end:
            self.stop()

    def stop(self):
        if not self._active:
            return
        import os

        import torch

        if torch.cuda.is_available():
            # the captured window holds finished device work
            torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        os.makedirs(self.log_dir, exist_ok=True)
        self.trace_path = os.path.join(self.log_dir, "trace.json")
        self._prof.export_chrome_trace(self.trace_path)
        self._prof = None
        self._active = False
