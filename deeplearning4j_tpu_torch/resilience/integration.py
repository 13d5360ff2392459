"""Fit-loop resilience driver — counterpart of
``deeplearning4j_tpu/resilience/integration.py``: the one object both
facades' ``fit`` talk to.

1. **auto-resume** on entry: when a ``CheckpointManager`` with
   ``auto_resume=True`` holds a checkpoint ahead of the model, restore it
   (params, updater state, layer state, key stream, iteration; written
   into the net's tensors in place) and skip the batches the restored run
   already consumed, so the resumed run replays the exact steps of an
   uninterrupted one;
2. **per-step scope**: the step runs inside the fault-injection hook and
   the ``RetryPolicy``; before every attempt the net's key stream
   (``net._keys``, ``backend/rng.py``) is set back to where the step
   found it, so a retried step draws the keys an unfailed one would;
3. **boundary duties**: ``maybe_save`` after each step, and a preemption
   check before it — on SIGTERM the loop commits a priority checkpoint
   and returns cleanly.

What may be retried: the port's step writes params, updater state and
layer state in place (a captured graph's replay, or the eager body).  An
injected step fault (``FaultInjector.on_step``) is raised before the
step stages anything, so nothing has moved and the step is retried in
place.  An error raised by the step itself may come after its in-place
writes began, so it is never retried here: it is re-raised as
``StepStateLost`` (fatal for every ``RetryPolicy``), chained to the
original, and the run resumes from the last committed checkpoint.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from deeplearning4j_tpu_torch.resilience.faults import get_fault_injector
from deeplearning4j_tpu_torch.resilience.preemption import (
    preemption_requested,
)


class StepStateLost(RuntimeError):
    """A step failed after it may have begun writing the net's state in
    place; not retryable (resume from the last committed checkpoint)."""


class FitResilience:
    """Per-fit-call resilience state (see module docstring)."""

    def __init__(self, component: str, checkpoint_manager=None,
                 retry_policy=None, *, net=None, mesh=None):
        self.component = component
        self.cm = checkpoint_manager
        self.retry = retry_policy
        self.resumed_from: Optional[int] = None
        self.skip = 0              # iterations the restored run already ran
        self._skipped = 0
        self.stopped = False
        if net is not None and self.cm is not None and self.cm.auto_resume:
            entry = int(getattr(net, "iteration", 0))
            restored = self.cm.resume(net, mesh=mesh)
            if restored is not None:
                self.resumed_from = restored
                self.skip = restored - entry

    # ------------------------------------------------------------ batch gate
    def skip_batch(self) -> bool:
        """True while replaying past batches a resumed checkpoint already
        covers (call once per batch, before any compute)."""
        if self._skipped < self.skip:
            self._skipped += 1
            return True
        return False

    def skip_window(self, steps: int) -> bool:
        """Skip a batch that advances the iteration by ``steps``
        (``num_iterations > 1``, TBPTT's windows) only when the whole of
        it is covered: checkpoints are taken at batch boundaries, so on
        the same batch stream the remaining skip is 0 or at least
        ``steps``."""
        remaining = self.skip - self._skipped
        if remaining >= steps > 0:
            self._skipped += steps
            return True
        return False

    def should_stop(self) -> bool:
        return self.stopped or preemption_requested()

    # -------------------------------------------------------------- the step
    def step(self, fn: Callable[[], Any], iteration: int, net=None) -> Any:
        """Run one step under fault injection and retry; with ``net``,
        its key stream is set back to this step's start before every
        attempt."""
        keys = getattr(net, "_keys", None) if net is not None else None
        saved = keys.get_state() if keys is not None else None

        def run():
            if keys is not None:
                keys.set_state(saved)
            inj = get_fault_injector()
            if inj is not None:
                inj.on_step(self.component, iteration)
            if self.retry is None:
                return fn()
            try:
                return fn()
            except Exception as e:
                if self.retry.classify(e):
                    raise StepStateLost(
                        f"{self.component} step {iteration} failed after "
                        "its in-place writes may have begun; resume from "
                        "the last committed checkpoint") from e
                raise

        if self.retry is None:
            return run()
        return self.retry.run(run, description=f"{self.component} step",
                              context={"iteration": iteration})

    def after_step(self, net) -> None:
        if self.cm is not None:
            self.cm.maybe_save(net)

    # --------------------------------------------------------------- stopping
    def on_preempt(self, net) -> None:
        """Commit a priority checkpoint (blocking: the process may be
        about to die) and mark the fit stopped."""
        self.stopped = True
        if self.cm is not None:
            self.cm.save_if_stale(net, trigger="preempt", block=True)
