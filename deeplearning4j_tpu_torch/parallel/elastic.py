"""Elastic data parallelism: degraded-mode eviction and re-admission —
a copy of ``deeplearning4j_tpu/parallel/elastic.py`` (host logic only)
with its imports rewritten to the port.  ``window_barrier`` also counts
the stalls it pays (``barrier_stalls``, ``barrier_stall_seconds``), so a
lockstep run and a degraded one compare by counted stalls, not by two
wall times.

Across processes every rank runs its own controller over the global
replica ids.  Its inputs are the same on every rank: the fault
injector's plan, and the replicas' window times, each measured by the
process that owns the replica and gathered in rank order
(``gather_worker_rows``).  So every rank takes the same verdicts at the
same window; ``check_mask`` holds the masks equal through one small
all-gather and raises on a mismatch.  A dead process is not survivable,
as in the reference's multi-controller job: the process group's
timeout turns it into an error.

The reference's text follows.

DeepSpark (arXiv 1602.08191) observes that a synchronous averaging window
runs at the speed of its slowest replica, and that relaxing synchrony over
a *degraded worker set* — drop the straggler from the collective,
renormalize the average over the healthy replicas, keep going — preserves
convergence while restoring throughput.  This module is that protocol for
the single-program mesh world of ``ParallelWrapper`` /
``SyncTrainingMaster``:

- **eviction** is a *mask*, not a topology change: the K-replica vmapped
  window program is compiled once, and an evicted replica is excluded by
  a runtime ``[K]`` weight vector — the parameter/updater average is
  renormalized over the healthy set (``sum(w*x)/sum(w)``), so the XLA
  shape set stays closed and eviction costs zero recompiles;
- **verdicts** come from three deterministic sources, polled once per
  window boundary: the ``StragglerDetector`` (a replica flagged
  ``evict_after_flags`` times since admission), a per-worker fault signal
  (``FaultInjector.hang_worker`` — the worker stopped responding), and
  worker death (``FaultInjector.kill_worker`` — per-worker SIGTERM /
  preempted host);
- **re-admission** happens at a window boundary after the fault clears
  (hang/death) or after ``readmit_after_windows`` of quarantine
  (straggler probation).  Catch-up is checkpoint-fed by construction:
  every window broadcasts the renormalized healthy average into *all* K
  slots — evicted ones included — so the returning replica's slot already
  holds the current averaged params the moment its weight flips back to
  1.  A re-admitted straggler starts a fresh flag budget; if it is still
  slow it is simply evicted again;
- the **synchrony barrier simulation** makes the cost model honest on the
  virtual-device test tier: with a ``FaultInjector`` active, each window
  stalls for the slowest ACTIVE worker's injected delay (lockstep
  semantics — what a real mesh pays in ICI wait).  Degraded mode's win is
  exactly the stall it no longer pays; ``bench_elastic`` measures it.

Every transition lands in the flight recorder (``elastic_eviction`` /
``elastic_readmission`` events naming the replica) and the
``dl4j_elastic_*`` metric families, and the ``max_evicted_replicas``
health rule (observability.health) turns a too-degraded mesh into a
failing ``/health``.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np

from deeplearning4j_tpu_torch.backend import mesh as mesh_mod

_EVICTIONS = "dl4j_elastic_evictions_total"
_READMISSIONS = "dl4j_elastic_readmissions_total"
_ACTIVE = "dl4j_elastic_active_replicas"
_EVICTED = "dl4j_elastic_evicted_replicas"
_DEGRADED = "dl4j_elastic_degraded_windows_total"
_STALL = "dl4j_elastic_window_stall_seconds"
_REFUSALS = "dl4j_elastic_eviction_refusals_total"


class ElasticConfig:
    """Tuning for one component's ``ElasticController``.

    ``degraded_mode`` — master switch: off keeps full lockstep semantics
    (no evictions ever; the barrier simulation still stalls on every
    worker — this is the "today's behavior" arm of ``bench_elastic``).
    ``evict_after_flags`` — straggler verdicts (detector flags since
    admission) that trigger eviction; ``None`` disables straggler-based
    eviction (hang/death still evict).  ``min_healthy`` — never evict
    below this many active replicas.  ``max_evicted`` — cap on
    simultaneously evicted replicas (default ``K - min_healthy``); the
    ``max_evicted_replicas`` health rule typically mirrors it.
    ``readmit_after_windows`` — quarantine length before a straggler
    eviction is probationally re-admitted.  The ``straggler_*`` fields
    parameterize the detector the wrapper builds when elasticity is on
    (``min_steps`` low so verdicts arrive within a few windows).
    ``hang_stall_s`` — what the barrier simulation charges per window for
    an ACTIVE hung worker (a stand-in for a watchdog timeout; evicting is
    the fix).
    """

    def __init__(self, degraded_mode: bool = True,
                 evict_after_flags: Optional[int] = 2,
                 min_healthy: int = 1,
                 max_evicted: Optional[int] = None,
                 readmit_after_windows: int = 16,
                 straggler_threshold: float = 2.0,
                 straggler_window: int = 32,
                 straggler_min_steps: int = 2,
                 straggler_min_excess_s: float = 0.010,
                 hang_stall_s: float = 0.05):
        if min_healthy < 1:
            raise ValueError(f"min_healthy must be >= 1, got {min_healthy}")
        self.degraded_mode = bool(degraded_mode)
        self.evict_after_flags = evict_after_flags
        self.min_healthy = int(min_healthy)
        self.max_evicted = max_evicted
        self.readmit_after_windows = int(readmit_after_windows)
        self.straggler_threshold = float(straggler_threshold)
        self.straggler_window = int(straggler_window)
        self.straggler_min_steps = int(straggler_min_steps)
        self.straggler_min_excess_s = float(straggler_min_excess_s)
        self.hang_stall_s = float(hang_stall_s)

    def make_worker_telemetry(self, component: str):
        """The per-worker telemetry parameterized by this config's
        ``straggler_*`` fields — the single construction point shared by
        ``ParallelWrapper`` and ``SyncTrainingMaster``, so a new tuning
        field cannot silently diverge between the two masters."""
        from deeplearning4j_tpu_torch.observability import WorkerTelemetry

        return WorkerTelemetry(
            component,
            threshold=self.straggler_threshold,
            window=self.straggler_window,
            min_steps=self.straggler_min_steps,
            min_excess_s=self.straggler_min_excess_s)


class ElasticController:
    """Per-fit elasticity state machine for one component (module
    docstring).  ``worker_ids`` fixes the replica naming the component
    already publishes telemetry under (``"0".."K-1"`` for the wrapper,
    ``"d<id>"`` for the sync master), so detector verdicts, injected
    faults, and eviction events all name the same replica."""

    def __init__(self, component: str, worker_ids: List[str], *,
                 config: Optional[ElasticConfig] = None,
                 detector=None, registry=None,
                 aliases: Optional[Dict[str, List[str]]] = None):
        self.component = component
        self.workers = [str(w) for w in worker_ids]
        self.K = len(self.workers)
        self.barrier_stalls = 0            # windows that paid a stall
        self.barrier_stall_seconds = 0.0
        self.cfg = config or ElasticConfig()
        self.detector = detector       # attached by the wrapper once built
        # aliases: every device id a worker slot answers for.  On a
        # data x model mesh one DATA slot spans several devices; a fault
        # or straggler verdict on ANY of them must evict the whole slot
        # (the collective is gated by the slot's slowest member).
        aliases = aliases or {}
        self.aliases: Dict[str, List[str]] = {
            w: [str(a) for a in aliases.get(w, (w,))] for w in self.workers
        }
        if registry is None:
            from deeplearning4j_tpu_torch.observability import get_registry
            registry = get_registry()
        self._m_evictions = registry.counter(
            _EVICTIONS, "Replica evictions from the data-parallel "
            "collective, by reason (straggler / hang / dead / poisoned / "
            "manual) — the evicted replica is named in the worker label",
            labels=("component", "worker", "reason"))
        self._m_readmissions = registry.counter(
            _READMISSIONS, "Replica re-admissions into the collective "
            "after catch-up (broadcast of the averaged params at a window "
            "boundary)", labels=("component", "worker"))
        self._m_active = registry.gauge(
            _ACTIVE, "Replicas currently participating in the averaging "
            "collective", labels=("component",))
        self._m_evicted = registry.gauge(
            _EVICTED, "Replicas currently evicted from the averaging "
            "collective (read by the max_evicted_replicas health rule)",
            labels=("component",))
        self._m_degraded = registry.counter(
            _DEGRADED, "Averaging windows executed with at least one "
            "replica evicted (renormalized over the healthy set)",
            labels=("component",))
        self._m_stall = registry.histogram(
            _STALL, "Synchrony-barrier stall charged per window by the "
            "slowest ACTIVE worker (fault-injection simulation of the "
            "lockstep ICI wait)", labels=("component",))
        self._m_refusals = registry.counter(
            _REFUSALS, "Evictions refused by the min_healthy/max_evicted "
            "caps — the faulty replica is STILL in the averaging "
            "collective; one increment per refused (worker, reason) "
            "episode", labels=("component", "worker", "reason"))
        self._state: Dict[str, Dict[str, Any]] = {
            w: {"active": True, "reason": None, "since": None,
                "windows_out": 0, "flag_base": 0, "refused": None}
            for w in self.workers
        }
        self._publish_gauges()

    # ------------------------------------------------------------- queries
    @property
    def active_workers(self) -> List[str]:
        return [w for w in self.workers if self._state[w]["active"]]

    @property
    def evicted_workers(self) -> List[str]:
        return [w for w in self.workers if not self._state[w]["active"]]

    def active_mask(self) -> np.ndarray:
        return np.asarray(
            [1.0 if self._state[w]["active"] else 0.0 for w in self.workers],
            np.float32)

    def summary(self) -> Dict[str, Any]:
        return {
            "component": self.component,
            "workers": self.K,
            "active": len(self.active_workers),
            "evicted": {w: {"reason": self._state[w]["reason"],
                            "since_step": self._state[w]["since"],
                            "windows_out": self._state[w]["windows_out"]}
                        for w in self.evicted_workers},
        }

    # --------------------------------------------------------- transitions
    def _publish_gauges(self) -> None:
        n_active = len(self.active_workers)
        self._m_active.set(float(n_active), component=self.component)
        self._m_evicted.set(float(self.K - n_active),
                            component=self.component)

    def _max_evicted(self) -> int:
        if self.cfg.max_evicted is not None:
            return min(int(self.cfg.max_evicted),
                       self.K - self.cfg.min_healthy)
        return self.K - self.cfg.min_healthy

    def evict(self, worker, reason: str, step: int) -> bool:
        """Evict ``worker`` at the next window boundary; refused (False)
        when degraded mode is off (lockstep semantics admit no evictions,
        manual or otherwise), when it would leave fewer than
        ``min_healthy`` active replicas, or when it would exceed
        ``max_evicted``."""
        from deeplearning4j_tpu_torch.observability import get_flight_recorder

        if not self.cfg.degraded_mode:
            return False
        worker = str(worker)
        st = self._state[worker]
        if not st["active"]:
            return True
        if (len(self.active_workers) - 1 < self.cfg.min_healthy
                or len(self.evicted_workers) + 1 > self._max_evicted()):
            return False
        st.update(active=False, reason=reason, since=int(step),
                  windows_out=0, refused=None)
        self._m_evictions.inc(component=self.component, worker=worker,
                              reason=reason)
        self._publish_gauges()
        get_flight_recorder().record(
            "elastic_eviction", component=self.component, worker=worker,
            reason=reason, step=int(step),
            active=len(self.active_workers))
        return True

    def readmit(self, worker, step: int) -> None:
        """Re-admit ``worker`` at a window boundary.  Its slot already
        holds the current averaged params (every window broadcasts the
        healthy average into all K slots), so no further catch-up is
        needed; its straggler flag budget restarts from now."""
        from deeplearning4j_tpu_torch.observability import get_flight_recorder

        worker = str(worker)
        st = self._state[worker]
        if st["active"]:
            return
        st.update(active=True, reason=None, since=None, windows_out=0,
                  flag_base=self._flags(worker), refused=None)
        self._m_readmissions.inc(component=self.component, worker=worker)
        self._publish_gauges()
        get_flight_recorder().record(
            "elastic_readmission", component=self.component, worker=worker,
            step=int(step), active=len(self.active_workers))

    def attach_detector(self, detector) -> None:
        """Point verdicts at ``detector``, rebasing every worker's flag
        budget on its current counts.  A controller that outlives one fit
        (``ParameterAveragingTrainingMaster`` re-wraps per epoch) gets a
        fresh ``StragglerDetector`` each time; without the rebase, stale
        ``flag_base`` values from the previous detector would demand
        ``base + evict_after_flags`` flags before the next eviction."""
        if detector is self.detector:
            return
        self.detector = detector
        for w in self.workers:
            self._state[w]["flag_base"] = self._flags(w)

    def _evict_or_report(self, worker: str, reason: str, step: int) -> None:
        """Evict, or make the refusal VISIBLE: a dead/hung/straggling
        replica the caps keep in the collective is the worst degraded
        state — without this, the evicted-replicas gauge and the
        max_evicted_replicas health rule both read healthy while garbage
        params keep entering the average.  One metric increment + flight
        event per (worker, reason) episode, re-armed when the fault
        clears or the eviction finally lands."""
        from deeplearning4j_tpu_torch.observability import get_flight_recorder

        st = self._state[worker]
        if self.evict(worker, reason, step):
            return
        if st["refused"] == reason:
            return                      # already reported this episode
        st["refused"] = reason
        self._m_refusals.inc(component=self.component, worker=worker,
                             reason=reason)
        get_flight_recorder().record(
            "elastic_eviction_refused", component=self.component,
            worker=worker, reason=reason, step=int(step),
            active=len(self.active_workers),
            min_healthy=self.cfg.min_healthy,
            max_evicted=self._max_evicted())

    def report_poisoned(self, worker, step: int) -> None:
        """Device-side repeat-offender verdict from the stability engine
        (``resilience/stability.py``): the named replica's gradients were
        non-finite in ``poison_evict_after``+ averaging windows — evict
        it with reason ``"poisoned"`` (or make the cap refusal visible).
        Re-admission follows the straggler probation path once the fault
        clears."""
        worker = str(worker)
        if not self._state[worker]["active"]:
            return
        self._evict_or_report(worker, "poisoned", step)

    def _flags(self, worker: str) -> int:
        if self.detector is None:
            return 0
        flags = self.detector.stragglers()
        return sum(flags.get(a, 0) for a in self.aliases[worker])

    def _worker_fault(self, inj, worker: str, step: int) -> str:
        """Worst injected state over the slot's member devices
        (``dead`` > ``hung`` > ``poisoned`` > ``ok``)."""
        if inj is None:
            return "ok"
        rank = {"ok": 0, "poisoned": 1, "hung": 2, "dead": 3}
        state = "ok"
        for a in self.aliases[worker]:
            s = inj.worker_state(a, step)
            if s == "dead":
                return "dead"
            if rank.get(s, 0) > rank[state]:
                state = s
        return state

    # ------------------------------------------------------ window protocol
    def begin_window(self, step: int) -> np.ndarray:
        """Poll verdict sources and apply due transitions; returns the
        ``[K]`` float mask for this window (all ones when degraded mode is
        off or the mesh is healthy)."""
        from deeplearning4j_tpu_torch.resilience import get_fault_injector

        inj = get_fault_injector()
        if self.cfg.degraded_mode:
            for w in self.workers:
                st = self._state[w]
                fault = self._worker_fault(inj, w, step)
                if st["active"]:
                    if fault == "dead":
                        self._evict_or_report(w, "dead", step)
                    elif fault == "hung":
                        self._evict_or_report(w, "hang", step)
                    elif (self.cfg.evict_after_flags is not None
                          and self._flags(w) - st["flag_base"]
                          >= self.cfg.evict_after_flags):
                        self._evict_or_report(w, "straggler", step)
                    elif fault == "ok":
                        st["refused"] = None   # episode over: fault gone
                    # fault == "poisoned": an ACTIVE poisoned replica is
                    # handled device-side (its gradients are weighted out
                    # of the average per window); eviction arrives via
                    # report_poisoned once it is a repeat offender
                else:
                    st["windows_out"] += 1
                    if fault != "ok":
                        continue       # fault still live: stay evicted
                    if st["reason"] in ("dead", "hang"):
                        self.readmit(w, step)   # fault cleared
                    elif (st["reason"] in ("straggler", "poisoned")
                          and st["windows_out"]
                          >= self.cfg.readmit_after_windows):
                        # probation: a straggler verdict or poison streak
                        # may have been transient (bad data window) — the
                        # next offense just re-evicts
                        self.readmit(w, step)
                    # any other reason (e.g. "manual") stays evicted until
                    # an explicit readmit() — an operator decision is not
                    # a fault that clears or a verdict that expires
        mask = self.active_mask()
        if mask.sum() < self.K:
            self._m_degraded.inc(component=self.component)
        return mask

    def window_barrier(self, step: int) -> float:
        """Synchrony-barrier simulation: stall this window by the slowest
        ACTIVE worker's injected delay (plus ``hang_stall_s`` for an
        active hung worker).  A no-op without a ``FaultInjector`` — real
        hardware pays this wait inside the collective, not here."""
        from deeplearning4j_tpu_torch.resilience import get_fault_injector

        inj = get_fault_injector()
        if inj is None:
            return 0.0
        stall = 0.0
        for w in self.active_workers:
            d = max(inj.worker_delay(a) for a in self.aliases[w])
            if self._worker_fault(inj, w, step) != "ok":
                d = max(d, self.cfg.hang_stall_s)
            stall = max(stall, d)
        if stall > 0.0:
            self.barrier_stalls += 1
            self.barrier_stall_seconds += stall
            time.sleep(stall)
            self._m_stall.observe(stall, component=self.component)
        return stall


def check_mask(mask: np.ndarray, what: str) -> None:
    """Across processes: every rank's ``[K]`` mask for this window is
    the same (one all-gather of K words), else ``RuntimeError``."""
    if not mesh_mod.processes_up():
        return
    import torch

    got = mesh_mod.process_all_gather(
        torch.as_tensor(np.asarray(mask, np.float32)), "elastic-mask")
    if not bool((got == got[0]).all()):
        raise RuntimeError(
            f"{what}: the ranks' elastic masks differ at this window "
            f"({got.tolist()})")


def gather_worker_rows(rows) -> np.ndarray:
    """This process's replicas' rows (``[K/W, c]``: each replica's
    window time and the like, measured by the process that owns it) and
    every other process's, in rank order: ``[K, c]`` float64, the same on
    every rank, so every rank's straggler detector takes the same
    inputs (the rows themselves without a process group)."""
    rows = np.asarray(rows, np.float64)
    if not mesh_mod.processes_up():
        return rows
    import torch

    return mesh_mod.process_gather_slots(torch.as_tensor(rows)).numpy()
