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
3. **boundary duties**: a save when one is due after each step, and a
   preemption check before the next — on SIGTERM the loop commits a
   priority checkpoint and returns cleanly.

What may be retried: the port's step writes params, updater state and
layer state in place (a captured graph's replay, or the eager body).  An
injected step fault (``FaultInjector.on_step``) is raised before the
step stages anything, so nothing has moved and the step is retried in
place.  An error raised by the step itself may come after its in-place
writes began, so it is never retried here: it is re-raised as
``StepStateLost`` (fatal for every ``RetryPolicy``), chained to the
original, and the run resumes from the last committed checkpoint.

**Across processes** (``mesh=`` a mesh that spans processes) the ranks
agree on every decision that would otherwise split them, over a gloo
group of their own (``backend/mesh.py``: ``process_agree``,
``process_codes``).  The resume step is process 0's choice
(``CheckpointManager.resume``), so the batches to skip are too.  The
rest are agreed once a step, in ONE small gather at the boundary before
it (``boundary``): a preemption notice on any rank stops every rank; the
save due after the step just run is process 0's trigger, or a priority
request on any rank; and a step fault seen on one rank before the step
(the injector's hook) is every rank's: each rank contributes its verdict
(none, retryable, fatal) and the worst one wins, the other ranks raising
``PeerStepFault`` of that kind, so a retryable fault on one rank is
retried on all of them and a fatal one raises on all of them at once,
before any rank enters the step's exchange (a retry's later attempts
agree again).  A save goes through ``trees`` (the master's ``Sharded``
trees) over the mesh, each process its own blocks.  The masters (the
sync master and ``ParallelWrapper``) call ``boundary`` in one process
too, where it gathers nothing.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

from deeplearning4j_tpu_torch.resilience.faults import get_fault_injector
from deeplearning4j_tpu_torch.resilience.preemption import (
    preemption_requested, preemption_seen,
)
from deeplearning4j_tpu_torch.resilience.retry import TransientError

_TRIGGERS = (None, "step_interval", "time_interval", "priority")


class StepStateLost(RuntimeError):
    """A step failed after it may have begun writing the net's state in
    place; not retryable (resume from the last committed checkpoint)."""


class PeerStepFault(RuntimeError):
    """Another rank's step fault, raised on this rank so that every rank
    takes the same branch (fatal)."""


class TransientPeerStepFault(TransientError, PeerStepFault):
    """Another rank's retryable step fault: every rank retries."""


class FitResilience:
    """Per-fit-call resilience state (see module docstring)."""

    def __init__(self, component: str, checkpoint_manager=None,
                 retry_policy=None, *, net=None, mesh=None, trees=None):
        self.component = component
        self.cm = checkpoint_manager
        self.retry = retry_policy
        self.resumed_from: Optional[int] = None
        self.skip = 0              # iterations the restored run already ran
        self._skipped = 0
        self.stopped = False
        self._stepped = False      # a step ran since the last boundary
        self._first = None         # (iteration, the agreed first fault)
        self.mesh = mesh
        self._across = mesh is not None and mesh.spans_processes
        # across processes a save is each process's blocks of the
        # master's trees over the mesh
        self._trees = trees if self._across else None
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
        return self.stopped or preemption_requested(self.mesh)

    # ------------------------------------------------------ the boundary
    def boundary(self, iteration: int, last: bool = False
                 ) -> Tuple[bool, Optional[str]]:
        """The step boundary at ``iteration``, before its step (``last``:
        after the fit's last step): whether to stop (a preemption notice)
        and the checkpoint trigger due after the step just run (None
        before a fit's first step), which the caller saves now.  It also
        runs the fault injector's hook for the next step's first attempt,
        which ``step`` raises.  Across processes the three are agreed in
        one gather (module docstring)."""
        trigger = None
        if self._stepped and self.cm is not None:
            trigger = self.cm.due(iteration)
        self._stepped = False
        err = None if last else self._hook(iteration)
        seen = preemption_seen()
        if self._across and not (last and self.cm is None):
            from deeplearning4j_tpu_torch.backend import mesh as mesh_mod

            codes = mesh_mod.process_codes(
                [int(seen), _TRIGGERS.index(trigger), self._code(err)])
            seen = bool(codes[:, 0].any())
            trigger = _TRIGGERS[3 if (codes[:, 1] == 3).any()
                                else int(codes[0, 1])]
            err = self._verdict(err, codes[:, 2], iteration)
        self._first = None if last else (iteration, err)
        return seen, trigger

    def _hook(self, iteration: int):
        """The injector's step fault for ``iteration``, caught, or None."""
        inj = get_fault_injector()
        if inj is None:
            return None
        try:
            inj.on_step(self.component, iteration)
        except Exception as e:     # raised by ``step``, agreed first
            return e
        return None

    def _code(self, err) -> int:
        """0 no fault, 1 retryable, 2 fatal."""
        if err is None:
            return 0
        return 1 if self.retry is not None and self.retry.classify(err) \
            else 2

    def _verdict(self, err, codes, iteration: int):
        """The worst of every rank's ``codes`` is every rank's: this
        rank's own error when it is that bad, else a ``PeerStepFault``
        of that kind."""
        worst = int(codes.max())
        if worst == 0 or self._code(err) == worst:
            return err
        ranks = [int(r) for r in (codes == worst).nonzero()[0]]
        kind = TransientPeerStepFault if worst == 1 else PeerStepFault
        return kind(f"{self.component} step {iteration}: rank(s) {ranks} "
                    f"failed it before it began ("
                    f"{'retryable' if worst == 1 else 'fatal'}); every rank "
                    "takes the same branch")

    # -------------------------------------------------------------- the step
    def step(self, fn: Callable[[], Any], iteration: int, net=None) -> Any:
        """Run one step under fault injection and retry; with ``net``,
        its key stream is set back to this step's start before every
        attempt.  The first attempt's fault is the one ``boundary``
        agreed, where it ran; every other attempt runs the hook (and,
        across processes, agrees on it) itself."""
        keys = getattr(net, "_keys", None) if net is not None else None
        saved = keys.get_state() if keys is not None else None

        def run():
            if keys is not None:
                keys.set_state(saved)
            first, self._first = self._first, None
            if first is not None and first[0] == iteration:
                err = first[1]
            else:
                err = self._hook(iteration)
                if self._across:
                    from deeplearning4j_tpu_torch.backend import (
                        mesh as mesh_mod,
                    )

                    err = self._verdict(
                        err, mesh_mod.process_codes([self._code(err)])[:, 0],
                        iteration)
            if err is not None:
                raise err
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

        out = (run() if self.retry is None else
               self.retry.run(run, description=f"{self.component} step",
                              context={"iteration": iteration}))
        self._stepped = True
        return out

    def save(self, net, trigger: str):
        """``cm.save`` of the fit's state (across processes each
        process's blocks of the master's trees, over the mesh)."""
        return self.cm.save(net, trigger=trigger, **self._save_kw())

    def _save_kw(self):
        if not self._across:
            return {}
        return {"trees": self._trees() if self._trees is not None else None,
                "mesh": self.mesh}

    def after_step(self, net) -> None:
        """A one-process fit's save after its step, when one is due (the
        masters save at ``boundary``)."""
        if self.cm is not None:
            self.cm.maybe_save(net)

    # --------------------------------------------------------------- stopping
    def on_preempt(self, net) -> None:
        """Commit a priority checkpoint (blocking: the process may be
        about to die) and mark the fit stopped."""
        self.stopped = True
        if self.cm is not None:
            self.cm.save_if_stale(net, trigger="preempt", block=True,
                                  **self._save_kw())
