"""Deterministic fault injection — the chaos harness the resilience tests
drive the REAL code paths with.

The reference stack's fault tolerance was exercised by Spark killing
executors; here the equivalent is a seeded ``FaultInjector`` that the fit
loops, the checkpoint writer, and the worker-telemetry seams consult at
well-defined points:

- ``fail_at_step(n)`` — the fit loops call ``on_step(component, step)``
  inside their retry scope, so an injected step fault exercises the real
  ``RetryPolicy`` backoff (transient) or the real crash-dump path (fatal);
- ``crash_after_files(n)`` — ``CheckpointManager``'s writer calls
  ``on_checkpoint_file(path)`` after each staged file, so the injector can
  kill the writer BETWEEN shard files, leaving exactly the torn ``.tmp``
  directory a preempted VM would;
- ``delay_worker(k, seconds)`` — the in-process worker-timing seams add the
  delay to worker ``k``'s reported step time, turning the straggler
  detector's input deterministic (and, when an ``ElasticController`` is
  attached, the synchrony-barrier simulation actually stalls the window
  by the slowest ACTIVE worker's delay — the lockstep collapse the
  elasticity layer exists to fix);
- ``hang_worker(k)`` / ``kill_worker(k, at_step)`` — mark a worker hung
  (stops responding) or dead (process gone) from a given step; the
  elastic layer polls ``worker_state(k, step)`` at every window boundary
  and evicts, and ``until_step`` / ``clear_worker`` model the fault
  clearing so re-admission paths are just as deterministic;
- ``poison_gradients(k, at_step, mode=nan|inf|spike, until_step=)`` —
  worker ``k``'s minibatch features are poisoned before dispatch (the
  fit loops and both data-parallel masters consult ``poison_batch`` /
  ``poison_replica_slots`` / ``poison_rows``), so the injected NaN/Inf/
  spike flows through the REAL forward/backward into the loss and
  gradients — the deterministic harness for the stability engine's
  device-side guard, per-replica poison masking, and divergence
  sentinel (``resilience/stability.py``);
- ``corrupt_checkpoint(dir)`` — post-hoc bit-flip / truncation / marker
  deletion of a COMMITTED checkpoint, for proving ``latest()`` skips torn
  snapshots.

Everything is seeded (``random.Random(seed)``) and counts deterministically
— the same test run injects the same faults in the same order.

Port: a copy of ``deeplearning4j_tpu/resilience/faults.py`` with its imports
rewritten to the port. ``poison_batch`` also
takes torch tensors (poisoned where they lie); the worker hooks are
called by the port's ``ParallelWrapper`` and ``SyncTrainingMaster``,
and ``poison_replica_labels`` poisons a replica's labels where its
features are token ids.
"""

from __future__ import annotations

import os
import random
import threading
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

from deeplearning4j_tpu_torch.resilience.retry import TransientError


class InjectedFault(RuntimeError):
    """A fault raised by the FaultInjector (fatal flavor)."""


class TransientInjectedFault(TransientError, InjectedFault):
    """A fault the RetryPolicy classifies as transient (retryable)."""


class FaultInjector:
    """Seeded, deterministic fault harness (see module docstring).

    All arming calls return ``self`` so rules chain::

        inj = (FaultInjector(seed=7)
               .fail_at_step(3, transient=True)
               .crash_after_files(1))
        with inject_faults(inj):
            net.fit(iterator, checkpoint_manager=cm, retry_policy=rp)
    """

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self.rng = random.Random(seed)
        self._lock = threading.Lock()
        self._step_rules: List[Dict[str, Any]] = []
        self._file_crash_after: Optional[int] = None
        self._file_crash_exc: Optional[BaseException] = None
        self._files_seen = 0
        self._worker_delays: Dict[str, float] = {}
        self._worker_states: List[Dict[str, Any]] = []
        self._poison_rules: List[Dict[str, Any]] = []
        self.injected: List[Dict[str, Any]] = []   # what fired, in order

    # ------------------------------------------------------------ step faults
    def fail_at_step(self, step: int, exc: Optional[BaseException] = None, *,
                     component: Optional[str] = None, times: int = 1,
                     transient: bool = True) -> "FaultInjector":
        """Raise when a fit loop reaches global iteration ``step`` (fires
        ``times`` times, then disarms; ``component`` narrows to one loop)."""
        with self._lock:   # arming can race a live run's on_step scan
            self._step_rules.append({
                "step": int(step), "component": component,
                "times": int(times), "exc": exc, "transient": transient,
            })
        return self

    def on_step(self, component: str, step: int) -> None:
        """Called by the fit loops at each step boundary (inside the retry
        scope).  Raises if an armed rule matches."""
        fire = None
        with self._lock:
            for rule in self._step_rules:
                if rule["times"] <= 0:
                    continue
                if rule["step"] != int(step):
                    continue
                if rule["component"] and rule["component"] != component:
                    continue
                rule["times"] -= 1
                fire = rule
                break
            if fire is not None:
                self.injected.append({"kind": "step_fault",
                                      "component": component, "step": step})
        if fire is None:
            return
        if fire["exc"] is not None:
            raise fire["exc"]
        if fire["transient"]:
            raise TransientInjectedFault(
                f"injected transient fault at {component} step {step}")
        raise InjectedFault(
            f"injected fatal fault at {component} step {step}")

    # ------------------------------------------------------- writer crashes
    def crash_after_files(self, n: int,
                          exc: Optional[BaseException] = None
                          ) -> "FaultInjector":
        """Kill the checkpoint writer after the ``n``-th staged file lands
        (n=1 → crash between the shard file and the manifest)."""
        with self._lock:   # the async writer thread reads these in
            self._file_crash_after = int(n)   # on_checkpoint_file
            self._file_crash_exc = exc
            self._files_seen = 0
        return self

    def on_checkpoint_file(self, path: str) -> None:
        """Called by ``write_snapshot`` after each staged checkpoint file."""
        with self._lock:
            if self._file_crash_after is None:
                return
            self._files_seen += 1
            if self._files_seen != self._file_crash_after:
                return
            self._file_crash_after = None   # one-shot
            self.injected.append({"kind": "writer_crash", "path": path})
            exc = self._file_crash_exc
        raise exc if exc is not None else InjectedFault(
            f"injected writer crash after {path}")

    # --------------------------------------------------------- slow workers
    def delay_worker(self, worker, seconds: float) -> "FaultInjector":
        """Make worker ``k`` look ``seconds`` slower to the telemetry seams
        (deterministic straggler)."""
        with self._lock:   # elastic tests (re)arm this mid-run
            self._worker_delays[str(worker)] = float(seconds)
        return self

    def worker_delay(self, worker) -> float:
        with self._lock:
            return self._worker_delays.get(str(worker), 0.0)

    def clear_worker_delay(self, worker) -> "FaultInjector":
        """Remove an armed ``delay_worker`` (the straggler recovered)."""
        with self._lock:
            self._worker_delays.pop(str(worker), None)
        return self

    # ------------------------------------------------------ hung/dead workers
    def hang_worker(self, worker, at_step: int = 0, *,
                    until_step: Optional[int] = None) -> "FaultInjector":
        """Worker ``k`` stops responding from global step ``at_step``
        (state ``"hung"``): it never reports a step result, so a lockstep
        run stalls on it forever while an elastic run evicts it at the
        next window boundary.  ``until_step`` models the hang clearing on
        its own (deterministic re-admission tests); ``clear_worker`` does
        it explicitly."""
        with self._lock:   # arming can race worker_state polls
            self._worker_states.append({
                "worker": str(worker), "kind": "hung",
                "at_step": int(at_step),
                "until_step": None if until_step is None
                else int(until_step),
                "fired": False,
            })
        return self

    def kill_worker(self, worker, at_step: int, *,
                    until_step: Optional[int] = None) -> "FaultInjector":
        """Worker ``k`` dies at global step ``at_step`` (state ``"dead"``
        — the per-worker SIGTERM / preempted-VM case).  ``until_step``
        models a replacement worker coming back for re-admission."""
        with self._lock:
            self._worker_states.append({
                "worker": str(worker), "kind": "dead",
                "at_step": int(at_step),
                "until_step": None if until_step is None
                else int(until_step),
                "fired": False,
            })
        return self

    def clear_worker(self, worker) -> "FaultInjector":
        """Clear every armed hang/kill/poison for ``worker`` (the fault
        is over; an elastic run re-admits at the next window boundary)."""
        worker = str(worker)
        with self._lock:
            self._worker_states = [r for r in self._worker_states
                                   if r["worker"] != worker]
            self._poison_rules = [r for r in self._poison_rules
                                  if r["worker"] != worker]
        return self

    def worker_state(self, worker, step: int) -> str:
        """``"ok"`` | ``"hung"`` | ``"dead"`` | ``"poisoned"`` for
        ``worker`` at global ``step`` — the elastic layer polls this at
        window boundaries.  ``dead`` > ``hung`` > ``poisoned`` when
        several are armed.  A poisoned worker is NOT evicted on sight:
        the device-side guard weights it out per window, and eviction
        comes from the repeat-offender count (``TrainingStability.
        poison_evict_after``) — but the state keeps an evicted
        ``"poisoned"`` replica out until the rule clears."""
        worker = str(worker)
        state = "ok"
        with self._lock:
            for rule in self._worker_states:
                if rule["worker"] != worker:
                    continue
                if int(step) < rule["at_step"]:
                    continue
                if (rule["until_step"] is not None
                        and int(step) >= rule["until_step"]):
                    continue
                if not rule["fired"]:
                    rule["fired"] = True
                    self.injected.append({
                        "kind": f"worker_{rule['kind']}", "worker": worker,
                        "step": int(step)})
                if rule["kind"] == "dead":
                    return "dead"
                state = "hung"
        if state == "ok" and self.poison_mode(worker, step) is not None:
            state = "poisoned"
        return state

    # ----------------------------------------------------- gradient poison
    def poison_gradients(self, worker, at_step: int = 0,
                         mode: str = "nan", *,
                         until_step: Optional[int] = None
                         ) -> "FaultInjector":
        """Worker ``k`` produces poisoned gradients from global step
        ``at_step`` (same arming shape as ``hang_worker``/``kill_worker``).
        Deterministically applied by the fit loops / parallel masters to
        the worker's minibatch features BEFORE dispatch — poisoned data
        is exactly the motivating failure (one bad batch/replica writes
        NaN into params and the all-reduce broadcasts it), and it drives
        the REAL device-side guard rather than a mock.  Modes: ``nan``
        (features become NaN), ``inf`` (become +Inf), ``spike``
        (scaled by 1e4 — finite but divergent, for sentinel tests).
        ``until_step`` models the poison clearing (re-admission tests);
        ``clear_worker`` clears it explicitly.  Single-device fit loops
        poison under worker id ``"0"``."""
        if mode not in ("nan", "inf", "spike"):
            raise ValueError(f"unknown poison mode {mode!r}")
        with self._lock:   # arming can race a live run's poison polls
            self._poison_rules.append({
                "worker": str(worker), "mode": mode,
                "at_step": int(at_step),
                "until_step": None if until_step is None
                else int(until_step),
                "fired": False,
            })
        return self

    def has_poison(self) -> bool:
        """Cheap hot-loop gate: any poison rule armed at all."""
        with self._lock:
            return bool(self._poison_rules)

    def poison_mode(self, worker, step: int) -> Optional[str]:
        """The poison mode active for ``worker`` at ``step``, or None."""
        worker = str(worker)
        with self._lock:
            for rule in self._poison_rules:
                if rule["worker"] != worker:
                    continue
                if int(step) < rule["at_step"]:
                    continue
                if (rule["until_step"] is not None
                        and int(step) >= rule["until_step"]):
                    continue
                if not rule["fired"]:
                    rule["fired"] = True
                    self.injected.append({
                        "kind": "worker_poisoned", "worker": worker,
                        "mode": rule["mode"], "step": int(step)})
                return rule["mode"]
        return None

    @staticmethod
    def _apply_poison(mode: str, arr):
        import numpy as np

        arr = np.array(arr, copy=True)
        if not np.issubdtype(arr.dtype, np.floating):
            return arr                     # integer ids cannot be non-finite
        if mode == "nan":
            arr[...] = np.nan
        elif mode == "inf":
            arr[...] = np.inf
        else:                              # spike: finite but divergent
            arr *= 1e4
        return arr

    def _poison_tree(self, mode: str, tree):
        """Apply poison to every floating array of a (possibly nested)
        features structure; returns a poisoned copy."""
        import numpy as np

        if isinstance(tree, dict):
            return {k: self._poison_tree(mode, v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self._poison_tree(mode, v) for v in tree)
        if hasattr(tree, "is_floating_point"):      # a torch tensor
            t = tree.clone()
            if not t.is_floating_point():
                return t
            if mode == "spike":
                return t.mul_(1e4)
            return t.fill_(float("nan") if mode == "nan" else float("inf"))
        arr = np.asarray(tree)
        return self._apply_poison(mode, arr)

    def poison_batch(self, worker, step: int, x, y):
        """Single-device hook (both facades): poison this step's features
        when a rule for ``worker`` is live.  Labels are left alone — the
        forward pass propagates the poison into loss AND gradients."""
        mode = self.poison_mode(worker, step)
        if mode is None:
            return x, y
        return self._poison_tree(mode, x), y

    def poison_replica_slots(self, worker_ids, step: int, xs):
        """ParallelWrapper hook: ``xs`` is the stacked ``[F, K, B, ...]``
        window; replica ``k``'s slot is ``xs[:, k]``."""
        import numpy as np

        out = None
        for k, worker in enumerate(worker_ids):
            mode = self.poison_mode(worker, step)
            if mode is None:
                continue
            if out is None:
                out = np.array(xs, copy=True)
            out[:, k] = self._apply_poison(mode, out[:, k])
        return xs if out is None else out

    def poison_replica_labels(self, worker_ids, step: int, xs, ys):
        """ParallelWrapper hook beside ``poison_replica_slots``: where the
        window's features ``xs`` are integer token ids, which cannot be
        non-finite (the reference's hook leaves such a replica healthy),
        replica ``k``'s labels ``ys[:, k]`` are poisoned instead, so a
        token model's replica can be poisoned too.  Returns ``ys``, or a
        poisoned copy."""
        import numpy as np

        if np.issubdtype(np.asarray(xs).dtype, np.floating):
            return ys
        out = None
        for k, worker in enumerate(worker_ids):
            mode = self.poison_mode(worker, step)
            if mode is None:
                continue
            if out is None:
                out = np.array(ys, copy=True)
            out[:, k] = self._apply_poison(mode, out[:, k])
        return ys if out is None else out

    def poison_rows(self, worker_ids, step: int, features, n_slots: int):
        """SyncTrainingMaster hook: data slot ``k`` owns the contiguous
        row block ``[k*B/K, (k+1)*B/K)`` of the global batch."""
        import numpy as np

        out = None
        per = len(features) // n_slots
        for k, worker in enumerate(worker_ids):
            mode = self.poison_mode(worker, step)
            if mode is None:
                continue
            if out is None:
                out = np.array(features, copy=True)
            rows = slice(k * per, (k + 1) * per)
            out[rows] = self._apply_poison(mode, out[rows])
        return features if out is None else out

    # --------------------------------------------------- on-disk corruption
    def corrupt_checkpoint(self, directory: str, mode: str = "truncate"
                           ) -> str:
        """Damage a COMMITTED checkpoint directory in place; returns the
        path touched.  Modes: ``truncate`` (cut a shard file in half),
        ``corrupt`` (flip bytes at a seeded offset, size unchanged),
        ``drop_commit`` (delete the COMMIT marker).  ``latest()`` must
        refuse the result in every mode."""
        if mode == "drop_commit":
            path = os.path.join(directory, "COMMIT")
            os.remove(path)
            with self._lock:
                self.injected.append({"kind": "corrupt", "mode": mode,
                                      "path": path})
            return path
        shards = sorted(f for f in os.listdir(directory)
                        if f.startswith("shards-"))
        if not shards:
            raise FileNotFoundError(f"no shard files in {directory}")
        path = os.path.join(directory, shards[0])
        size = os.path.getsize(path)
        if mode == "truncate":
            with open(path, "r+b") as f:
                f.truncate(max(1, size // 2))
        elif mode == "corrupt":
            with self._lock:   # reset() swaps self.rng concurrently
                off = self.rng.randrange(max(1, size - 8))
            with open(path, "r+b") as f:
                f.seek(off)
                chunk = f.read(8)
                f.seek(off)
                f.write(bytes(b ^ 0xFF for b in chunk))
        else:
            raise ValueError(f"unknown corruption mode {mode!r}")
        with self._lock:
            self.injected.append({"kind": "corrupt", "mode": mode,
                                  "path": path})
        return path

    def reset(self) -> None:
        with self._lock:
            self._step_rules.clear()
            self._file_crash_after = None
            self._files_seen = 0
            self._worker_delays.clear()
            self._worker_states.clear()
            self._poison_rules.clear()
            self.injected.clear()
            self.rng = random.Random(self.seed)


_active: Optional[FaultInjector] = None


def get_fault_injector() -> Optional[FaultInjector]:
    """The active injector, or None (the production value — every hook
    site is a single global read + None check)."""
    return _active


def set_fault_injector(inj: Optional[FaultInjector]) -> Optional[FaultInjector]:
    global _active
    _active = inj
    return inj


@contextmanager
def inject_faults(inj: FaultInjector):
    """Scope an injector over a block (tests)."""
    global _active
    prev = _active
    _active = inj
    try:
        yield inj
    finally:
        _active = prev
