"""Preemption handling: SIGTERM/SIGINT -> priority checkpoint -> clean stop.

TPU VMs (and any spot/preemptible fleet) get a termination notice as
SIGTERM with a short grace window.  The reference stack rode out executor
loss via Spark lineage; a single-controller run must instead treat the
signal as "checkpoint NOW and exit cleanly": the ``PreemptionHandler``
watches the signals, requests a priority save from its
``CheckpointManager``, and raises a flag every fit loop checks at its next
step boundary (all the loops in this codebase poll
``preemption_requested()`` once per step — a module-global read in one
process).

Signal-handler discipline: the handler itself only sets plain flags (no
locks, no IO — a signal can interrupt the main thread while it holds the
very metrics lock a counter increment would need).  The metrics/flight
bookkeeping happens on the fit-loop thread when the stop is first noticed.
The SECOND signal restores the previous disposition first, so a stuck
drain can still be killed the ordinary way.

Port: a copy of ``deeplearning4j_tpu/resilience/preemption.py`` with its imports
rewritten to the port.  Across processes one rank's notice stops every
rank at the same step: a check there is a small gather over the ranks'
own gloo group, so a resilient master folds it into its one agreement a
step (``FitResilience.boundary``), and a master without resilience
checks only when a rank has a handler installed as its fit begins
(``preemption_watched``: one gather a fit).
"""

from __future__ import annotations

import logging
import signal
import threading
from typing import Any, Dict, List, Optional

_PREEMPTS = "dl4j_preemptions_total"

logger = logging.getLogger("deeplearning4j_tpu_torch.resilience")


class PreemptionHandler:
    """SIGTERM/SIGINT watcher driving checkpoint-then-stop (see module
    docstring).

    Usage::

        cm = CheckpointManager("ckpts", save_every_steps=100)
        with PreemptionHandler(cm).install() as ph:
            net.fit(iterator, checkpoint_manager=cm)
        if ph.stop_requested:      # fit stopped early at a step boundary
            ...                    # with a priority checkpoint committed

    ``trigger()`` simulates the signal without OS delivery (worker threads,
    tests of non-main-thread fits).  Installation outside the main thread
    degrades to trigger-only mode with a warning instead of failing.
    """

    def __init__(self, checkpoint_manager=None,
                 signals=(signal.SIGTERM, signal.SIGINT), registry=None):
        self.checkpoint_manager = checkpoint_manager
        self.signals = tuple(signals)
        self._registry = registry
        self._stop = threading.Event()
        self._signum: Optional[int] = None
        self._noticed = False
        self._prev: Dict[int, Any] = {}
        self._installed = False

    # ----------------------------------------------------------- signal path
    def _on_signal(self, signum, frame) -> None:
        # flags only — no locks, no allocation-heavy work (see module
        # docstring); everything observable happens in notice()
        self._signum = signum
        self._stop.set()
        if self.checkpoint_manager is not None:
            self.checkpoint_manager.request_priority_save()
        # second signal escalates: restore previous dispositions so the
        # default action (terminate) goes through if the drain hangs
        self._restore()

    def trigger(self, signum: int = signal.SIGTERM) -> None:
        """Simulate signal delivery (tests / non-main-thread fits)."""
        self._on_signal(signum, None)

    # ------------------------------------------------------------- lifecycle
    def install(self) -> "PreemptionHandler":
        """Register the handlers and make this the process-wide handler the
        fit loops poll."""
        global _active
        try:
            for s in self.signals:
                self._prev[s] = signal.signal(s, self._on_signal)
            self._installed = True
        except ValueError:
            # signal.signal only works on the main thread; degrade to
            # trigger-only mode so worker-thread fits still get the polling
            self._prev.clear()
            logger.warning(
                "PreemptionHandler.install: not on the main thread — OS "
                "signals not hooked, use trigger() to request a stop")
        _active = self
        return self

    def _restore(self) -> None:
        for s, prev in list(self._prev.items()):
            try:
                signal.signal(s, prev)
            except (ValueError, TypeError):
                pass
        self._prev.clear()
        self._installed = False

    def uninstall(self) -> None:
        global _active
        self._restore()
        if _active is self:
            _active = None

    def __enter__(self) -> "PreemptionHandler":
        return self if (_active is self) else self.install()

    def __exit__(self, *exc) -> bool:
        self.uninstall()
        return False

    # -------------------------------------------------------------- queries
    @property
    def stop_requested(self) -> bool:
        return self._stop.is_set()

    @property
    def signal_received(self) -> Optional[int]:
        return self._signum

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._stop.wait(timeout)

    def notice(self) -> None:
        """Called by the fit loop that observes the stop: does the
        bookkeeping the signal handler could not (metrics + flight event),
        exactly once."""
        if self._noticed or not self._stop.is_set():
            return
        self._noticed = True
        signum = self._signum
        name = (signal.Signals(signum).name
                if signum is not None else "manual")
        try:
            from deeplearning4j_tpu_torch.observability import (
                get_flight_recorder, get_registry,
            )

            reg = (self._registry if self._registry is not None
                   else get_registry())
            reg.counter(
                _PREEMPTS, "Preemption signals observed by the fit loops "
                "(SIGTERM/SIGINT -> priority checkpoint + clean stop)",
                labels=("signal",)).inc(signal=name)
            get_flight_recorder().record("preempt", signal=name)
        except Exception:   # bookkeeping must never break the drain
            pass
        logger.warning("preemption (%s): stopping fit at the next step "
                       "boundary", name)

    def reset(self) -> None:
        """Re-arm after a handled stop (long-lived trainer loops).  The
        first signal restored the previous OS dispositions (the
        second-signal escalation path), so re-hook them too — otherwise
        the next preemption would take the default action with no
        checkpoint."""
        had_signal = self._signum is not None
        self._stop.clear()
        self._signum = None
        self._noticed = False
        if had_signal and _active is self and not self._prev:
            try:
                for s in self.signals:
                    self._prev[s] = signal.signal(s, self._on_signal)
                self._installed = True
            except ValueError:
                pass    # non-main thread: stays trigger-only


_active: Optional[PreemptionHandler] = None


def get_preemption_handler() -> Optional[PreemptionHandler]:
    """The installed handler, or None (module-global read — the fit loops
    call this once per step)."""
    return _active


def preemption_seen() -> bool:
    """Whether this process's handler has seen its signal (noticed once);
    a module-global read."""
    h = _active
    seen = h is not None and h._stop.is_set()
    if seen:
        h.notice()
    return seen


def preemption_requested(mesh=None) -> bool:
    """True when an installed handler has seen its signal.  Fit loops call
    this at every step boundary; when it flips, they commit a priority
    checkpoint (if a manager is wired) and return cleanly.  With a
    ``mesh`` that spans processes it is true on every rank when any
    rank's handler has seen its signal (one small gather a call over the
    ranks' own gloo group), so every rank stops, and commits, at the same
    step."""
    seen = preemption_seen()
    if mesh is not None and mesh.spans_processes:
        from deeplearning4j_tpu_torch.backend import mesh as mesh_mod

        return mesh_mod.process_any(seen)
    return seen


def preemption_watched(mesh=None) -> bool:
    """Whether a fit over ``mesh`` checks ``preemption_requested`` at its
    step boundaries: in one process always; across processes only when
    some rank has a handler installed as the fit begins (one gather a
    fit), since each check there is a gather.  A handler installed on a
    rank during such a fit is watched from the next fit."""
    if mesh is None or not mesh.spans_processes:
        return True
    from deeplearning4j_tpu_torch.backend import mesh as mesh_mod

    return mesh_mod.process_any(_active is not None)
