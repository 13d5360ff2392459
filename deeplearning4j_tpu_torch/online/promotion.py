"""SLO-gated promotion: evaluate -> gate -> canary -> swap -> watch ->
commit | rollback.

Every candidate the online pipeline trains walks this state machine
before (and after) it touches serving:

1. **evaluate** — score the candidate (and the currently active version,
   for a relative baseline) on a held-out eval set;
2. **gate** — a ``HealthEvaluator`` over declarative ``HealthRule``
   predicates reading the eval report (absolute loss cap, accuracy
   floor, no-worse-than-active regression bound).  A failing candidate is
   recorded (``promotion_rejected`` flight event naming it +
   ``dl4j_promotions_total{outcome="rejected"}``) and never touches the
   registry;
3. **canary** — the candidate serves a seeded traffic fraction under
   ``<name>:canary`` (``ServingEngine.start_canary``) until it has seen
   ``canary_min_requests`` rerouted requests (or the phase times out);
   an error rate above ``canary_max_error_rate`` tears the canary down
   and rejects — the primary version never stopped serving;
4. **swap** — ``deploy(..., retain_old=True)``: zero-drop atomic flip
   with the previous version RETAINED as the rollback target;
5. **watch** — for ``watch_window_s`` the post-swap serving metrics are
   re-evaluated every poll (request error-rate delta since the swap,
   plus an optional self-probe through the real serving path); any
   failing watch rule triggers **automatic rollback** to the retained
   version (``dl4j_promotions_total{outcome="rolled_back"}``), otherwise
   the swap commits and the retained version retires.

The gate and the watch both reuse ``observability.health``
(``HealthEvaluator`` / ``HealthRule``), so promotion SLOs read exactly
like the /health SLOs operators already write — see docs/online.md.

Port of ``deeplearning4j_tpu/online/promotion.py``: a candidate's
outputs are copied to the host before they are judged, and the
evaluation's accuracy is computed wherever the labels are one-hot
classes and the output has their shape.  An error from a port net on
the way (a kernel that fails to build or launch) propagates: it is a
fault of the run, not a missing accuracy.  Only the baseline's absence
(no active version yet) is passed over.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Optional

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.observability.flightrecorder import (
    get_flight_recorder,
)
from deeplearning4j_tpu_torch.observability.health import (
    HealthEvaluator, HealthRule,
)
from deeplearning4j_tpu_torch.serving.admission import (
    ModelNotFoundError, ServingError,
)
from deeplearning4j_tpu_torch.serving.engine import DEFAULT_MODEL, ServingEngine

_PROMOTIONS = "dl4j_promotions_total"
_FRESHNESS = "dl4j_online_model_freshness_seconds"

logger = logging.getLogger("deeplearning4j_tpu_torch.online")

REJECTED = "rejected"
CANARY_REJECTED = "canary_rejected"
ROLLED_BACK = "rolled_back"
ROLLBACK_FAILED = "rollback_failed"   # watch failed, retained version gone
PROMOTED = "promoted"


def _host(out) -> np.ndarray:
    """A model's output as a host array."""
    if hasattr(out, "detach"):
        return out.detach().float().cpu().numpy()
    return np.asarray(out)


def _port_net(model) -> bool:
    """A net of this package (either facade). Its error while it is
    scored, canaried or deployed (a kernel that does not build or
    launch) is the run's fault, never a rejected candidate."""
    return hasattr(model, "_graph_cache")


def default_gate_rules(max_eval_loss: Optional[float] = None,
                       min_accuracy: Optional[float] = None,
                       max_loss_regression: Optional[float] = 0.25,
                       ) -> List[HealthRule]:
    """Gate SLOs over the candidate eval report (the ``extra`` the
    predicates receive): an absolute loss cap, an accuracy floor, and a
    relative bound — candidate loss may not exceed the ACTIVE version's
    loss by more than ``max_loss_regression`` (fractional).  Rules with
    no data to judge (no eval set, no active baseline) pass — same
    "no data is healthy" convention as ``HealthRule.require_data``."""
    rules: List[HealthRule] = []
    if max_eval_loss is not None:
        def _loss_cap(r, limit=max_eval_loss):
            loss = (r or {}).get("loss")
            if loss is None:
                return True, None, "no eval loss; pass"
            return (np.isfinite(loss) and loss <= limit, loss,
                    f"candidate eval loss vs cap {limit}")
        rules.append(HealthRule("candidate_loss_cap", "predicate",
                                fn=_loss_cap))
    if min_accuracy is not None:
        def _acc_floor(r, limit=min_accuracy):
            acc = (r or {}).get("accuracy")
            if acc is None:
                return True, None, "no eval accuracy; pass"
            return acc >= limit, acc, f"candidate accuracy vs floor {limit}"
        rules.append(HealthRule("candidate_accuracy_floor", "predicate",
                                fn=_acc_floor))
    if max_loss_regression is not None:
        def _no_regression(r, tol=max_loss_regression):
            r = r or {}
            loss, active = r.get("loss"), r.get("active_loss")
            if loss is None or active is None or not np.isfinite(active):
                return True, loss, "no active baseline; pass"
            limit = active * (1.0 + tol) if active >= 0 else \
                active * (1.0 - tol)
            return (np.isfinite(loss) and loss <= limit, loss,
                    f"candidate loss vs active {active:.6g} * (1+{tol})")
        rules.append(HealthRule("no_loss_regression_vs_active", "predicate",
                                fn=_no_regression))
    return rules


def default_watch_rules(max_error_rate: float = 0.05,
                        min_requests: int = 1) -> List[HealthRule]:
    """Post-swap SLOs over the watch window's ``extra``: the request
    error-rate delta since the swap (errors + deadline expiries over all
    requests; sheds excluded — a full queue is load, not the model) and
    the self-probe verdict.  Below ``min_requests`` the error-rate rule
    abstains — one unlucky request must not roll a good model back."""
    def _error_rate(e):
        e = e or {}
        n, rate = e.get("requests", 0), e.get("error_rate", 0.0)
        if n < min_requests:
            return (True, rate,
                    f"only {n} post-swap requests (< {min_requests}); "
                    f"insufficient evidence")
        return (rate <= max_error_rate, rate,
                f"{e.get('bad', 0)}/{n} bad post-swap requests vs limit "
                f"{max_error_rate}")

    def _probe(e):
        e = e or {}
        return (bool(e.get("probe_ok", True)), e.get("probe_ok"),
                e.get("probe_detail"))

    return [HealthRule("post_swap_error_rate", "predicate", fn=_error_rate),
            HealthRule("post_swap_probe", "predicate", fn=_probe)]


class PromotionResult:
    """One candidate's walk through the state machine."""

    def __init__(self, candidate_id: str):
        self.candidate_id = candidate_id
        self.outcome: Optional[str] = None
        self.version: Optional[int] = None      # registry version if swapped
        self.report: Dict[str, Any] = {}        # eval metrics
        self.gate: Optional[dict] = None        # gate verdict
        self.canary: Optional[dict] = None      # canary stats
        self.watch: Optional[dict] = None       # watch verdict + extra
        self.freshness_s: Optional[float] = None
        # host wall of each phase this candidate reached, in ms
        self.split_ms: Dict[str, float] = {}

    @property
    def promoted(self) -> bool:
        return self.outcome == PROMOTED

    def as_dict(self) -> dict:
        return {"candidate_id": self.candidate_id, "outcome": self.outcome,
                "version": self.version, "report": self.report,
                "gate": self.gate, "canary": self.canary,
                "watch": self.watch, "freshness_s": self.freshness_s,
                "split_ms": self.split_ms}


class PromotionManager:
    """Drives the promotion state machine for one served model name
    (module docstring).  ``canary_fraction=None`` (or
    ``canary_min_requests=0``) skips the canary phase;
    ``watch_window_s=0`` swaps-and-commits immediately (no rollback
    window).  ``self_probe`` routes the eval set through the REAL
    serving path during canary and watch — with no external traffic the
    state machine still gathers evidence, and the probes co-batch with
    live requests when there are any."""

    def __init__(self, engine: ServingEngine,
                 model_name: str = DEFAULT_MODEL, *,
                 eval_set: Optional[DataSet] = None,
                 gate_rules: Optional[List[HealthRule]] = None,
                 watch_rules: Optional[List[HealthRule]] = None,
                 canary_fraction: Optional[float] = 0.25,
                 canary_min_requests: int = 8,
                 canary_timeout_s: float = 10.0,
                 canary_max_error_rate: float = 0.0,
                 watch_window_s: float = 1.0,
                 watch_poll_s: float = 0.05,
                 watch_min_requests: int = 1,
                 watch_max_error_rate: float = 0.05,
                 self_probe: Optional[bool] = None,
                 probe_deadline_s: float = 5.0,
                 example: Optional[np.ndarray] = None,
                 registry=None, sleep=time.sleep):
        self.engine = engine
        self.model_name = model_name
        self.eval_set = eval_set
        self.gate_rules = (list(gate_rules) if gate_rules is not None
                           else default_gate_rules())
        self.watch_rules = (list(watch_rules) if watch_rules is not None
                            else default_watch_rules(
                                max_error_rate=watch_max_error_rate,
                                min_requests=watch_min_requests))
        self.canary_fraction = canary_fraction
        self.canary_min_requests = int(canary_min_requests)
        self.canary_timeout_s = float(canary_timeout_s)
        self.canary_max_error_rate = float(canary_max_error_rate)
        self.watch_window_s = float(watch_window_s)
        self.watch_poll_s = float(watch_poll_s)
        self.self_probe = (self_probe if self_probe is not None
                           else eval_set is not None)
        self.probe_deadline_s = float(probe_deadline_s)
        self.example = example
        self._registry = registry
        self._sleep = sleep
        self._canary_seed = 0

    # -------------------------------------------------------------- plumbing
    def _reg(self):
        if self._registry is not None:
            return self._registry
        from deeplearning4j_tpu_torch.observability import get_registry

        return get_registry()

    def _count(self, outcome: str) -> None:
        self._reg().counter(
            _PROMOTIONS, "Candidate models by promotion outcome: promoted "
            "(swap committed), rejected (failed the eval gate, never "
            "touched the registry), canary_rejected (regressed on canary "
            "traffic), rolled_back (post-swap watch window regressed — "
            "previous version restored), rollback_failed (watch regressed "
            "but the retained version was gone — candidate left serving, "
            "operator attention required)", labels=("model", "outcome")
        ).inc(model=self.model_name, outcome=outcome)

    def _example(self) -> Optional[np.ndarray]:
        if self.example is not None:
            return self.example
        if self.eval_set is not None:
            return np.asarray(self.eval_set.features[0], np.float32)
        return None

    # ------------------------------------------------------------- the walk
    def consider(self, candidate, candidate_id: str = "candidate", *,
                 event_ts: Optional[float] = None) -> PromotionResult:
        """Walk ``candidate`` through the full state machine and return
        where it ended up.  ``event_ts`` (publish wall-time of the oldest
        stream event the candidate learned from) feeds the
        ``dl4j_online_model_freshness_seconds`` gauge on promotion."""
        res = PromotionResult(candidate_id)
        t0 = time.perf_counter()

        def lap(phase):
            nonlocal t0
            t1 = time.perf_counter()
            res.split_ms[phase] = (t1 - t0) * 1e3
            t0 = t1

        try:
            res.report = self._evaluate(candidate, candidate_id)
            lap("evaluate")
        except Exception as e:
            # another model that cannot even be scored offline is broken —
            # an outcome, not a pipeline crash; a net of this package
            # failing (a kernel that does not build or launch) fails the run
            if _port_net(candidate):
                raise
            return self._reject_broken(res, candidate_id, "evaluate", e)

        verdict = HealthEvaluator(
            self.gate_rules, component=f"gate.{self.model_name}",
            registry=self._reg()).evaluate(extra=res.report)
        res.gate = verdict.to_dict()
        if not verdict.healthy:
            res.outcome = REJECTED
            self._count(REJECTED)
            get_flight_recorder().record(
                "promotion_rejected", model=self.model_name,
                candidate=candidate_id,
                failed_rules=[r["name"] for r in verdict.failing],
                loss=res.report.get("loss"),
                active_loss=res.report.get("active_loss"))
            logger.warning(
                "candidate %s REJECTED at the gate (%s) — registry "
                "untouched", candidate_id,
                ", ".join(r["name"] for r in verdict.failing))
            return res

        if self.canary_fraction and self.canary_min_requests > 0:
            try:
                ok, stats = self._canary_phase(candidate, candidate_id)
            except Exception as e:
                # another model that cannot even start its canary (warmup
                # forward failed, unloadable artifact) is an OUTCOME, not
                # a pipeline crash — the primary version never stopped
                # serving; a net of this package failing fails the run
                if _port_net(candidate):
                    raise
                return self._reject_broken(res, candidate_id, "canary", e)
            res.canary = stats
            lap("canary")
            if not ok:
                res.outcome = CANARY_REJECTED
                self._count(CANARY_REJECTED)
                get_flight_recorder().record(
                    "canary_rejected", model=self.model_name,
                    candidate=candidate_id,
                    error_rate=stats.get("error_rate"),
                    requests=stats.get("requests"))
                logger.warning(
                    "candidate %s rejected on canary traffic "
                    "(error_rate=%.3f over %d requests)", candidate_id,
                    stats.get("error_rate", 0.0), stats.get("requests", 0))
                return res

        try:
            mv = self.engine.deploy(self.model_name, candidate,
                                    example=self._example(), retain_old=True)
        except Exception as e:
            # deploy aborts BEFORE activation on a broken warmup forward —
            # the old version is intact, so classify another model and
            # move on; a net of this package failing fails the run
            if _port_net(candidate):
                raise
            return self._reject_broken(res, candidate_id, "deploy", e)
        res.version = mv.version
        lap("swap")
        get_flight_recorder().record(
            "promotion_swap", model=self.model_name, candidate=candidate_id,
            version=mv.version)

        if self.watch_window_s > 0:
            watch_verdict, extra = self._watch_phase()
            lap("watch")
            res.watch = {"verdict": watch_verdict.to_dict(), **extra}
            if not watch_verdict.healthy:
                try:
                    self.engine.rollback(self.model_name)
                except ModelNotFoundError as e:
                    # the rollback window was closed under us (a
                    # concurrent manual deploy/commit) — the regressed
                    # candidate is still serving and an operator must
                    # know; an uncaught raise here would kill the
                    # pipeline loop instead
                    res.outcome = ROLLBACK_FAILED
                    self._count(ROLLBACK_FAILED)
                    get_flight_recorder().record(
                        "rollback_failed", model=self.model_name,
                        candidate=candidate_id, version=mv.version,
                        error=str(e),
                        failed_rules=[r["name"]
                                      for r in watch_verdict.failing])
                    logger.error(
                        "candidate %s (v%d) FAILED its watch but cannot "
                        "be rolled back (%s) — still serving", candidate_id,
                        mv.version, e)
                    return res
                res.outcome = ROLLED_BACK
                self._count(ROLLED_BACK)
                logger.warning(
                    "candidate %s (v%d) ROLLED BACK: post-swap watch "
                    "failed (%s)", candidate_id, mv.version,
                    ", ".join(r["name"] for r in watch_verdict.failing))
                return res

        self.engine.commit_swap(self.model_name)
        res.outcome = PROMOTED
        self._count(PROMOTED)
        if event_ts is not None:
            res.freshness_s = max(0.0, time.time() - float(event_ts))
            self._reg().gauge(
                _FRESHNESS, "Seconds from the publish timestamp of the "
                "oldest stream event in the last promoted window to the "
                "moment its model committed into serving (end-to-end "
                "stream-to-serving staleness)", labels=("model",)
            ).set(res.freshness_s, model=self.model_name)
        get_flight_recorder().record(
            "promotion_committed", model=self.model_name,
            candidate=candidate_id, version=mv.version,
            freshness_s=res.freshness_s)
        logger.info("candidate %s promoted as %s", candidate_id, mv.key)
        return res

    def _reject_broken(self, res: PromotionResult, candidate_id: str,
                       stage: str, err: BaseException) -> PromotionResult:
        res.outcome = REJECTED
        res.report.setdefault("broken", f"{stage}: {err!r}")
        self._count(REJECTED)
        get_flight_recorder().record(
            "promotion_rejected", model=self.model_name,
            candidate=candidate_id, failed_rules=[f"broken_{stage}"],
            error=repr(err))
        logger.warning("candidate %s REJECTED: %s failed: %r",
                       candidate_id, stage, err)
        return res

    # --------------------------------------------------------------- phases
    def _evaluate(self, candidate, candidate_id: str) -> Dict[str, Any]:
        report: Dict[str, Any] = {"candidate_id": candidate_id}
        ds = self.eval_set
        if ds is None:
            return report
        x, y = ds.features, ds.labels
        fm, lm = ds.features_mask, ds.labels_mask
        report["loss"] = float(candidate.score(x, y, fmask=fm, lmask=lm))
        try:
            active = self.engine.models.active(self.model_name).model
        except ModelNotFoundError:
            active = None   # first deploy: the relative rules pass
        if active is not None:
            report["active_loss"] = float(
                active.score(x, y, fmask=fm, lmask=lm))
        if np.ndim(y) == 2 and np.shape(y)[1] >= 2:
            from deeplearning4j_tpu_torch.evaluation import Evaluation

            try:
                out = _host(candidate.output(x))
            except Exception:
                if _port_net(candidate):
                    raise   # a net of this package failing is the run's
                # another model that cannot answer the eval rows: the
                # loss rules still gate, and the canary judges it live
                out = None
            if out is not None and np.shape(out) == np.shape(y):
                # a classification output: its accuracy gates too
                ev = Evaluation()
                ev.eval(y, out, mask=lm)
                report["accuracy"] = float(ev.accuracy())
        return report

    def _canary_phase(self, candidate, candidate_id: str):
        self._canary_seed += 1
        self.engine.start_canary(
            self.model_name, candidate, fraction=float(self.canary_fraction),
            example=self._example(), seed=self._canary_seed)
        deadline = time.monotonic() + self.canary_timeout_s
        probe_failed = None
        try:
            while time.monotonic() < deadline:
                if self.self_probe:
                    verdict, detail = self._probe()
                    if verdict is False:
                        # NaN/garbage outputs don't raise, so transport
                        # tallies alone would score them "ok" — the probe
                        # verdict is canary evidence too
                        probe_failed = detail
                        break
                stats = self.engine.canary_stats(self.model_name)
                # "judged" excludes sheds: a full queue is the engine's
                # load, not canary evidence — 8 shed requests must not
                # satisfy the evidence threshold with error_rate 0
                if (stats is not None
                        and stats["judged"] >= self.canary_min_requests):
                    break
                self._sleep(self.watch_poll_s)
        finally:
            stats = self.engine.stop_canary(self.model_name) or {}
        if probe_failed is not None:
            return False, dict(stats, probe_detail=probe_failed)
        if not stats.get("judged"):
            # a quiet (or fully shed) canary produced no evidence either
            # way; the watch window after the swap is the backstop
            return True, dict(stats, detail="no judged canary traffic")
        ok = stats["error_rate"] <= self.canary_max_error_rate
        return ok, stats

    def _watch_phase(self):
        base = self._status_counts()
        evaluator = HealthEvaluator(
            self.watch_rules, component=f"watch.{self.model_name}",
            registry=self._reg())
        deadline = time.monotonic() + self.watch_window_s
        probe_ok, probe_detail = True, None
        while True:
            extra = self._watch_extra(base, probe_ok, probe_detail)
            verdict = evaluator.evaluate(extra=extra)
            if not verdict.healthy or time.monotonic() >= deadline:
                return verdict, extra
            if self.self_probe:
                v, probe_detail = self._probe()
                probe_ok = v is not False   # None (shed) is inconclusive
            self._sleep(self.watch_poll_s)

    def _probe(self):
        """One eval-set round trip through the REAL serving path.
        ``False`` only on MODEL-quality failures (a raise, wrong shape,
        non-finite outputs); a shed/deadline is the ENGINE's load, so it
        returns ``None`` (inconclusive) — the error-rate rules own that
        signal, and a load spike must not masquerade as a bad model."""
        ds = self.eval_set
        if ds is None:
            return True, "no eval set; probe skipped"
        try:
            out = self.engine.predict(ds.features, model=self.model_name,
                                      deadline_s=self.probe_deadline_s)
        except ServingError as e:
            return None, f"probe inconclusive (shed): {e}"
        except Exception as e:
            return False, f"probe raised: {e!r}"
        out = _host(out)
        if len(out) != len(ds.features):
            return False, (f"probe returned {len(out)} rows for "
                           f"{len(ds.features)} inputs")
        if not np.isfinite(out).all():
            return False, "probe outputs contain NaN/Inf"
        return True, "probe ok"

    def _status_counts(self) -> Dict[str, float]:
        # per-MODEL outcomes (engine-internal tally): the shared
        # requests counter has no model label, and another model's
        # errors during the window must not roll this candidate back
        # (nor may its ok-traffic dilute a real regression)
        return {k: float(v) for k, v in
                self.engine.status_counts(self.model_name).items()}

    def _watch_extra(self, base: Dict[str, float], probe_ok: bool,
                     probe_detail) -> Dict[str, Any]:
        now = self._status_counts()
        delta = {k: now.get(k, 0.0) - base.get(k, 0.0)
                 for k in set(now) | set(base)}
        # same "judged" convention as the canary: sheds are visible in
        # ``statuses`` but appear in neither the evidence count nor the
        # error-rate denominator — 95 queue_full deltas must not dilute
        # 2 failures out of 5 judged requests below the SLO
        bad = max(0.0, delta.get("error", 0.0)) + \
            max(0.0, delta.get("deadline", 0.0))
        judged = bad + max(0.0, delta.get("ok", 0.0))
        return {
            "requests": int(judged), "bad": int(bad),
            "error_rate": (bad / judged) if judged else 0.0,
            "statuses": {k: v for k, v in delta.items() if v},
            "probe_ok": probe_ok, "probe_detail": probe_detail,
        }
