"""Fleet-wide canary rollout: the online promotion state machine at fleet scope.

Single-engine promotion (``online/promotion.py``) walks gate → canary →
watch → rollback|commit against ONE engine.  ``FleetRollout.consider``
runs the same machine across N replicas:

* **canary** — deploy the candidate on ONE replica (``retain_old=True``,
  the same two-resident-versions contract as single-engine canary) and
  have the ROUTER shift a seeded traffic fraction there
  (``set_traffic_split``) — the fleet analog of the serving engine's
  seeded per-request canary router.  Judged evidence is the canary
  replica's SLO delta from the fleet aggregator (finished/good since the
  split opened; sheds never count) with the router's own terminal-outcome
  tallies as the aggregator-less fallback.  Insufficient evidence inside
  the deadline → not promotable, same as the online canary's abstention.
* **wave** — remaining replicas one at a time, each deploy followed by a
  watch window evaluated through ``HealthEvaluator`` over the SAME
  default watch rules as single-engine promotion (error-rate delta +
  probe), fed from per-replica SLO deltas.
* **rollback** — any canary breach or watch regression rolls back EVERY
  replica deployed so far, newest first, and re-clears the traffic
  split; a replica whose rollback itself fails reports
  ``rollback_failed`` (the alarm outcome, exactly the online promotion's).
* **commit** — all replicas watched clean → ``commit_swap`` everywhere.

Outcomes land in ``dl4j_fleet_rollout_total{outcome}`` and the flight
recorder; the outcome vocabulary is ``online.promotion``'s, imported
lazily so this module stays importable without the online stack.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, List, Optional

from deeplearning4j_tpu_torch.observability.health import HealthEvaluator
from deeplearning4j_tpu_torch.observability.metrics import get_registry

logger = logging.getLogger("deeplearning4j_tpu_torch.fleet")

# same outcome vocabulary as online.promotion (string-equal on purpose:
# dashboards already aggregate these label values)
REJECTED = "rejected"
CANARY_REJECTED = "canary_rejected"
ROLLED_BACK = "rolled_back"
ROLLBACK_FAILED = "rollback_failed"
PROMOTED = "promoted"


def _default_watch_rules(max_error_rate: float, min_requests: int):
    # the online promotion's rule builders read plain extra dicts — reuse them verbatim
    from deeplearning4j_tpu_torch.online.promotion import default_watch_rules
    return default_watch_rules(max_error_rate=max_error_rate,
                               min_requests=min_requests)


class FleetRolloutResult:
    """One candidate's walk across the fleet."""

    def __init__(self, candidate_id: str):
        self.candidate_id = candidate_id
        self.outcome: Optional[str] = None
        self.canary: Optional[Dict[str, Any]] = None
        self.waves: List[Dict[str, Any]] = []
        self.rolled_back: List[str] = []      # replicas restored
        self.committed: List[str] = []
        self.detail: Optional[str] = None

    @property
    def promoted(self) -> bool:
        return self.outcome == PROMOTED

    def as_dict(self) -> Dict[str, Any]:
        return {"candidate": self.candidate_id, "outcome": self.outcome,
                "canary": self.canary, "waves": self.waves,
                "rolled_back": self.rolled_back,
                "committed": self.committed, "detail": self.detail}


class FleetRollout:
    """See module docstring.  ``replicas`` maps replica id → handle;
    every handle must be deploy-capable (``can_deploy``), i.e. the
    in-process shape — subprocess replicas would need the model object
    shipped across the boundary, which ``HTTPReplica`` does not do."""

    def __init__(self, router, replicas: Dict[str, Any], *,
                 model_name: str = "default",
                 canary_fraction: float = 0.25,
                 canary_min_requests: int = 8,
                 canary_timeout_s: float = 30.0,
                 canary_max_error_rate: float = 0.05,
                 watch_rules=None,
                 watch_window_s: float = 2.0,
                 watch_poll_s: float = 0.1,
                 watch_min_requests: int = 1,
                 watch_max_error_rate: float = 0.05,
                 watch_extra_fn: Optional[Callable[[str], dict]] = None,
                 split_seed: int = 0,
                 registry=None):
        undeployable = [rid for rid, h in replicas.items()
                        if not getattr(h, "can_deploy", False)]
        if undeployable:
            raise ValueError(
                f"fleet rollout needs deploy-capable replicas; "
                f"{undeployable} are not (HTTP replicas cannot receive "
                f"a model object)")
        self.router = router
        self.replicas = dict(replicas)
        self.model_name = model_name
        self.canary_fraction = float(canary_fraction)
        self.canary_min_requests = int(canary_min_requests)
        self.canary_timeout_s = float(canary_timeout_s)
        self.canary_max_error_rate = float(canary_max_error_rate)
        self._watch_rules = watch_rules
        self.watch_window_s = float(watch_window_s)
        self.watch_poll_s = float(watch_poll_s)
        self.watch_min_requests = int(watch_min_requests)
        self.watch_max_error_rate = float(watch_max_error_rate)
        self.watch_extra_fn = watch_extra_fn
        self.split_seed = int(split_seed)
        self.registry = registry or get_registry()
        self._m_outcomes = self.registry.counter(
            "dl4j_fleet_rollout_total",
            "Fleet-wide rollout outcomes", labels=("outcome",))

    # ------------------------------------------------------------- evidence
    def _slo_counts(self, replica_id: str) -> Dict[str, int]:
        """(finished, good) for one replica: the aggregator's published
        SLO row when available, the router's terminal tallies otherwise."""
        agg = getattr(self.router, "aggregator", None)
        if agg is not None:
            try:
                for row in agg.workers():
                    if row["worker"] == replica_id and row.get("slo"):
                        slo = row["slo"]
                        return {"finished": int(slo.get("finished") or 0),
                                "good": int(slo.get("good_total") or 0)}
            except Exception:
                logger.warning("fleet rollout: aggregator evidence read "
                               "failed", exc_info=True)
        counts = self.router.status_counts(replica_id)
        return {"finished": counts["judged"], "good": counts["ok"]}

    def _watch_extra(self, replica_id: str,
                     base: Dict[str, int]) -> Dict[str, Any]:
        now = self._slo_counts(replica_id)
        requests = max(0, now["finished"] - base["finished"])
        good = max(0, now["good"] - base["good"])
        bad = max(0, requests - good)
        extra: Dict[str, Any] = {
            "replica": replica_id, "requests": requests, "bad": bad,
            "error_rate": bad / requests if requests else 0.0,
        }
        if self.watch_extra_fn is not None:
            extra.update(self.watch_extra_fn(replica_id) or {})
        return extra

    # ------------------------------------------------------------ mechanics
    def _finish(self, res: FleetRolloutResult, outcome: str,
                detail: Optional[str] = None) -> FleetRolloutResult:
        res.outcome, res.detail = outcome, detail
        self._m_outcomes.inc(outcome=outcome)
        try:
            from deeplearning4j_tpu_torch.observability import get_flight_recorder
            get_flight_recorder().record(
                "fleet_rollout", candidate=res.candidate_id,
                outcome=outcome, detail=detail,
                rolled_back=list(res.rolled_back),
                committed=list(res.committed))
        except Exception:
            pass
        return res

    def _rollback_all(self, res: FleetRolloutResult,
                      deployed: List[str]) -> Optional[str]:
        """Newest-first fleet restore; returns the failure detail when a
        rollback itself broke (→ ROLLBACK_FAILED)."""
        failed = None
        for rid in reversed(deployed):
            try:
                self.replicas[rid].rollback(self.model_name)
                res.rolled_back.append(rid)
            except Exception as e:
                logger.error("fleet rollout: rollback FAILED on %s",
                             rid, exc_info=True)
                failed = f"rollback failed on {rid}: {e}"
        return failed

    # --------------------------------------------------------------- driver
    def consider(self, model, candidate_id: str = "candidate"
                 ) -> FleetRolloutResult:
        res = FleetRolloutResult(candidate_id)
        order = sorted(self.replicas)
        live = {r["replica"] for r in self.router.replicas() if r["live"]}
        placeable = [rid for rid in order if rid in live]
        if not placeable:
            return self._finish(res, REJECTED, "no live replica to canary")
        canary_id = placeable[0]
        deployed: List[str] = []

        # ---- canary: one replica + seeded router split
        try:
            self.replicas[canary_id].deploy(self.model_name, model,
                                            retain_old=True)
            deployed.append(canary_id)
        except Exception as e:
            return self._finish(res, REJECTED,
                                f"canary deploy broke on {canary_id}: {e}")
        base = self._slo_counts(canary_id)
        self.router.set_traffic_split(canary_id, self.canary_fraction,
                                      seed=self.split_seed)
        try:
            deadline = time.monotonic() + self.canary_timeout_s
            while True:
                extra = self._watch_extra(canary_id, base)
                if extra["requests"] >= self.canary_min_requests:
                    break
                if time.monotonic() > deadline:
                    break
                time.sleep(self.watch_poll_s)
        finally:
            self.router.clear_traffic_split()
        res.canary = dict(extra, replica=canary_id,
                          fraction=self.canary_fraction)
        if extra["requests"] < self.canary_min_requests:
            failed = self._rollback_all(res, deployed)
            return self._finish(
                res, ROLLBACK_FAILED if failed else CANARY_REJECTED,
                failed or f"insufficient canary evidence "
                f"({extra['requests']}/{self.canary_min_requests})")
        if extra["error_rate"] > self.canary_max_error_rate:
            failed = self._rollback_all(res, deployed)
            return self._finish(
                res, ROLLBACK_FAILED if failed else CANARY_REJECTED,
                failed or f"canary error rate {extra['error_rate']:.3f} > "
                f"{self.canary_max_error_rate}")

        # ---- wave: remaining replicas one at a time, watched
        rules = (self._watch_rules if self._watch_rules is not None
                 else _default_watch_rules(self.watch_max_error_rate,
                                           self.watch_min_requests))
        watcher = HealthEvaluator(rules, component="fleet_rollout",
                                  registry=self.registry)
        for rid in [r for r in order if r != canary_id]:
            try:
                self.replicas[rid].deploy(self.model_name, model,
                                          retain_old=True)
                deployed.append(rid)
            except Exception as e:
                failed = self._rollback_all(res, deployed)
                return self._finish(
                    res, ROLLBACK_FAILED if failed else ROLLED_BACK,
                    failed or f"wave deploy broke on {rid}: {e}")
            base = self._slo_counts(rid)
            verdict = None
            wave_deadline = time.monotonic() + self.watch_window_s
            while True:
                extra = self._watch_extra(rid, base)
                verdict = watcher.evaluate(extra=extra)
                if not verdict.healthy or time.monotonic() > wave_deadline:
                    break
                time.sleep(self.watch_poll_s)
            res.waves.append({"replica": rid, "extra": extra,
                              "healthy": verdict.healthy,
                              "failing": list(verdict.failing)})
            if not verdict.healthy:
                failed = self._rollback_all(res, deployed)
                return self._finish(
                    res, ROLLBACK_FAILED if failed else ROLLED_BACK,
                    failed or f"watch regression on {rid}: "
                    f"{verdict.failing}")

        # ---- commit everywhere
        for rid in deployed:
            try:
                self.replicas[rid].commit_swap(self.model_name)
                res.committed.append(rid)
            except Exception as e:
                logger.warning("fleet rollout: commit_swap failed on %s "
                               "(old version stays resident): %s", rid, e)
        return self._finish(res, PROMOTED)
