"""Training stability engine — counterpart of
``deeplearning4j_tpu/resilience/stability.py``, re-derived in torch.

**Device half** (``guarded_update_``, called by ``common.sgd_step``, so
inside a captured train step's graph on the card): the loss is multiplied
by the loss scale before ``torch.autograd.grad``, the gradients are
unscaled, one finiteness verdict covers the loss and every gradient
(``all_finite``), and a non-finite step becomes a no-op: the update is
``where(finite, u, 0) * lr_scale`` (exactly 0, since multiplying a NaN by
0 keeps it), and the new updater state, layer state (BatchNorm's running
stats) and TBPTT carries are chosen with ``where`` against the old ones
BEFORE anything is written in place.  The scale, the growth streak, the
LR multiplier and the non-finite counter are float32 device scalars in
``updater_state["__stability__"]`` (``STATE_KEY``): the graph reads them,
rewrites them (dynamic scaling) and the host rewrites them in place (a
backoff), so a captured step keeps scaling without being captured again
and a poisoned batch replays the same graph.  No Python float enters the
region as a tensor.  The state rides with the updater state, so it
checkpoints and resumes with it.

With ``loss_scaling="none"`` or a static power-of-two scale, a guarded
healthy step equals an unguarded one bit for bit: multiplying by a power
of two and back is exact in every op of the backward pass.

**Host half** (``StabilityRuntime``): the divergence sentinel, polled at
fit-loop boundaries; every ``check_every`` steps it reads the device
scalars (the engine's only host syncs), publishes the metric families,
and escalates: skip (free, on the device) -> LR backoff (the device
multiplier scaled in place) -> auto-rewind to the newest checkpoint of a
``CheckpointManager`` taken while the run was healthy.

**The data-parallel masters' half**: the sync master zeroes poisoned
rows before the forward (``finite_rows``, ``zero_nonfinite_rows``) and
folds them out of the labels mask, and reports which data slots held
them (``slot_poison_flags``); the wrapper weights a poisoned replica out
of its window average.  Both feed ``StabilityRuntime.accumulate`` with
device tensors (adds, no sync) and poll ``poll_master`` at window
boundaries, which publishes ``dl4j_poisoned_replica_windows_total{
worker}`` for the runtime's ``worker_ids``, records a
``replica_poisoned`` flight event naming the replica, and reports a
repeat offender to the elastic controller.

Metric families: ``dl4j_nonfinite_steps_total``, ``dl4j_loss_scale``,
``dl4j_stability_lr_scale``, ``dl4j_divergence_backoffs_total``,
``dl4j_divergence_rewinds_total``; the ``max_nonfinite_steps`` and
``max_divergence_rewinds`` health rules read the counters.
"""

from __future__ import annotations

import collections
import math
from typing import Dict, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.conf import TrainingStability
from deeplearning4j_tpu_torch.optimize import updaters as upd

STATE_KEY = "__stability__"

_NONFINITE = "dl4j_nonfinite_steps_total"
_LOSS_SCALE = "dl4j_loss_scale"
_LR_SCALE = "dl4j_stability_lr_scale"
_BACKOFFS = "dl4j_divergence_backoffs_total"
_REWINDS = "dl4j_divergence_rewinds_total"
_POISONED = "dl4j_poisoned_replica_windows_total"


def policy_of(conf) -> Optional[TrainingStability]:
    """The configuration's stability policy (a config carries it as a
    dict), or None."""
    p = getattr(conf, "stability", None)
    if p is None or isinstance(p, TrainingStability):
        return p
    return TrainingStability.from_dict(p)


# ---------------------------------------------------------------------------
# device half: inside the train step (no host syncs)
# ---------------------------------------------------------------------------

def initial_state(policy, device=None) -> Dict[str, torch.Tensor]:
    """Fresh stability state: four float32 scalars on ``device``."""
    scale = policy.loss_scale if policy.loss_scaling != "none" else 1.0

    def scalar(v):
        return torch.full((), float(v), dtype=torch.float32, device=device)

    return {"loss_scale": scalar(scale), "growth_streak": scalar(0.0),
            "lr_scale": scalar(1.0), "nonfinite_total": scalar(0.0)}


def ensure_state(net) -> None:
    """Give a net whose configuration sets a policy its state subtree
    (nets made before the policy was set, nets loaded without it)."""
    policy = policy_of(net.conf)
    if policy is not None and STATE_KEY not in net.updater_state:
        net.updater_state[STATE_KEY] = initial_state(policy, net.device)


def split_state(upd_state):
    """(stability subtree, the rest of the updater state): the rest is
    what ``updaters.update`` understands."""
    return upd_state[STATE_KEY], upd.inner_state(upd_state)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


def _map(fn, *trees):
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, tuple):
        return tuple(_map(fn, *(t[i] for t in trees)) for i in range(len(t0)))
    return None if t0 is None else fn(*trees)


def all_finite(loss, grads) -> torch.Tensor:
    """0-d bool: the loss and every gradient are finite.  One sum a leaf:
    a NaN or an infinity makes its sum non-finite (infinities of both
    signs give NaN), so ``isfinite`` of the loss plus the sums is the
    verdict."""
    total = loss.detach().float()
    for g in _leaves(grads):
        total = total + g.sum(dtype=torch.float32)
    return torch.isfinite(total)


def select(flag, new_tree, old_tree):
    """Per leaf ``where(flag, new, old)``."""
    return _map(lambda n, o: torch.where(flag, n, o), new_tree, old_tree)


def next_state(policy, stab, finite) -> Dict[str, torch.Tensor]:
    """The stability state after one step's verdict (dynamic scale grown
    or halved, the non-finite counter), as the reference's float32
    arithmetic."""
    fin = finite.float()
    scale = stab["loss_scale"]
    streak = stab["growth_streak"]
    if policy.loss_scaling == "dynamic":
        streak = torch.where(finite, streak + 1.0, torch.zeros_like(streak))
        grow = streak >= policy.loss_scale_growth_interval
        scale = torch.where(
            finite & grow,
            torch.clamp(scale * policy.loss_scale_factor,
                        max=policy.loss_scale_max),
            scale)
        streak = torch.where(grow, torch.zeros_like(streak), streak)
        scale = torch.where(
            finite, scale,
            torch.clamp(scale / policy.loss_scale_factor,
                        min=policy.loss_scale_min))
    return {"loss_scale": scale, "growth_streak": streak,
            "lr_scale": stab["lr_scale"],
            "nonfinite_total": stab["nonfinite_total"] + (1.0 - fin)}


def unscale(loss, grads, loss_scale):
    """``grads`` of the loss times ``loss_scale`` back to the loss's own,
    and the verdict (0-d bool): the loss and every gradient finite."""
    inv = 1.0 / loss_scale
    grads = _map(lambda g: g * inv, grads)
    return grads, all_finite(loss, grads)


def fold_verdict(policy, finite, lr_scale, updates, new_state, old_state):
    """The verdict folded into an update: under ``skip_nonfinite`` a
    non-finite step's updates are exactly 0 and its updater state stays
    ``old_state``; the updates are scaled by ``lr_scale`` either way.
    Returns ``(updates, new_state)``."""
    if not policy.skip_nonfinite:
        return _map(lambda u: u * lr_scale, updates), new_state
    scale = torch.where(finite, lr_scale, torch.zeros_like(lr_scale))
    updates = _map(
        lambda u: torch.where(finite, u, torch.zeros_like(u)) * scale,
        updates)
    return updates, select(finite, new_state, old_state)


def guarded_update_(net, policy, loss, grads, train, new_net_state,
                    scalars, carries=None, new_carries=None, extra_ok=None,
                    cfg=None):
    """The guarded tail of a train step, in place: unscale the gradients
    (``grads`` of the loss times the scale), take the verdict, run the
    updater, fold the skip into the update, and write params, updater
    state, layer state, TBPTT carries and the stability state — every
    choice made before its write.  ``extra_ok`` (0-d bool) vetoes the
    step besides the verdict (the sync master's all-rows-poisoned
    batch); ``cfg`` overrides the updater configuration.  Returns the
    verdict (0-d bool)."""
    from deeplearning4j_tpu_torch.models.common import (
        advance_carries_, copy_tree_,
    )
    from deeplearning4j_tpu_torch.optimize import updaters as upd

    stab, inner = split_state(net.updater_state)
    grads, finite = unscale(loss, grads, stab["loss_scale"])
    if extra_ok is not None:
        finite = finite & extra_ok
    updates, new_inner = upd.update(cfg or net.conf.updater, grads, inner,
                                    net.iteration, params=train,
                                    scalars=scalars)
    updates, new_inner = fold_verdict(policy, finite, stab["lr_scale"],
                                      updates, new_inner, inner)
    if policy.skip_nonfinite:
        new_net_state = {k: (select(finite, v, net.net_state[k])
                             if k in net.net_state else v)
                         for k, v in new_net_state.items()}
        if new_carries is not None:
            new_carries = {k: _map(
                lambda n: torch.where(finite, n, torch.zeros_like(n)), v)
                for k, v in new_carries.items()}
    new_stab = next_state(policy, stab, finite)
    upd.apply_updates_(net.params, updates)
    copy_tree_(net.updater_state, new_inner)
    copy_tree_(net.net_state, new_net_state)
    for k, v in new_stab.items():
        stab[k].copy_(v)
    if carries is not None:
        advance_carries_(carries, new_carries)
    return finite


def finite_rows(x, y) -> torch.Tensor:
    """``[B]`` float mask: 1 where every floating element of the
    example's features and labels is finite (integer ids pass)."""
    ok = None
    for leaf in _leaves(x) + _leaves(y):
        if not leaf.is_floating_point():
            continue
        lo = torch.isfinite(leaf).reshape(leaf.shape[0], -1).all(dim=1)
        ok = lo if ok is None else ok & lo
    if ok is None:
        first = _leaves(x)[0]
        return torch.ones((first.shape[0],), dtype=torch.float32,
                          device=first.device)
    return ok.float()


def zero_nonfinite_rows(tree, row_ok):
    """Poisoned rows of every floating leaf replaced by zeros before the
    forward: NaN activations poison the backward even under a zero
    cotangent."""
    def clean(leaf):
        if not leaf.is_floating_point():
            return leaf
        m = row_ok.reshape((leaf.shape[0],) + (1,) * (leaf.ndim - 1))
        return torch.where(m > 0, leaf, torch.zeros_like(leaf))

    return _map(clean, tree)


def slot_poison_flags(row_ok, n_slots: int) -> torch.Tensor:
    """``[K]`` flags: 1 where any row of the slot's contiguous block
    ``[k*B/K, (k+1)*B/K)`` is poisoned."""
    return 1.0 - row_ok.reshape(n_slots, -1).min(dim=1).values


def apply_lr_backoff_(upd_state, policy) -> None:
    """Scale the device LR multiplier by the backoff factor, in place
    (a captured step reads the same tensor)."""
    upd_state[STATE_KEY]["lr_scale"].mul_(policy.lr_backoff)


def _scalar(t) -> float:
    return float(t.reshape(-1)[0]) if torch.is_tensor(t) else float(t)


# ---------------------------------------------------------------------------
# host half: boundary harvest, divergence sentinel, escalation
# ---------------------------------------------------------------------------

class StabilityRuntime:
    """Per-fit host-side driver (one per facade).

    The fit loops call ``poll_net`` once per batch boundary; every call
    but each ``policy.check_every``-th is a no-op, and that one reads the
    device scalars (non-finite counter, loss scale, LR multiplier) and
    the loss, publishes metrics and runs the divergence sentinel.
    Escalations: ``"backoff"`` scales the device LR multiplier by
    ``policy.lr_backoff``; ``"rewind"`` restores the newest checkpoint
    committed while the run was healthy, then backs off."""

    def __init__(self, component: str, policy, *, worker_ids=None,
                 registry=None):
        self.component = component
        self.policy = policy
        self.worker_ids = [str(w) for w in (worker_ids or [])]
        if registry is None:
            from deeplearning4j_tpu_torch.observability import get_registry
            registry = get_registry()
        self._m_nonfinite = registry.counter(
            _NONFINITE, "Training steps whose loss or gradients were "
            "non-finite — the device-side guard made them no-ops "
            "(params/updater/net state unchanged); harvested from the "
            "device counter at window boundaries",
            labels=("component",))
        self._m_scale = registry.gauge(
            _LOSS_SCALE, "Current dynamic loss scale of the stability "
            "engine (1 when loss scaling is off)", labels=("component",))
        self._m_lr_scale = registry.gauge(
            _LR_SCALE, "Divergence-sentinel LR backoff multiplier applied "
            "device-side to every update (1 until the first backoff "
            "escalation)", labels=("component",))
        self._m_backoffs = registry.counter(
            _BACKOFFS, "Divergence-sentinel LR-backoff escalations "
            "(sustained non-finite streak or finite loss spike)",
            labels=("component",))
        self._m_rewinds = registry.counter(
            _REWINDS, "Divergence-sentinel auto-rewinds to the last good "
            "checkpoint (params/updater/RNG/iteration restored; read by "
            "the max_divergence_rewinds health rule)",
            labels=("component",))
        self._m_poisoned = registry.counter(
            _POISONED, "Averaging windows in which the named replica's "
            "gradients were non-finite and it was weighted out of the "
            "window average", labels=("component", "worker"))
        self._harvested_poison: Dict[str, float] = {}
        # device accumulators the masters feed through accumulate()
        self._nf_acc = None
        self._poison_acc = None
        self._calls = 0
        self._checks = 0
        self._harvested_nonfinite = 0.0
        self._lr_scale_host = 1.0
        self._baseline = collections.deque(maxlen=16)
        self._spike_strikes = 0
        self._level = 0
        self._cooldown_until = -1
        self._last_good_step: Optional[int] = None

    def baseline_from(self, stab_state) -> None:
        """Anchor the harvest on an existing device counter: a restored
        ``nonfinite_total`` is history, not fresh evidence (one scalar
        sync, at fit entry or after a rewind)."""
        if stab_state is None or self._nf_acc is not None:
            return
        self._harvested_nonfinite = _scalar(stab_state["nonfinite_total"])

    def accumulate(self, nonfinite_count=None, poison_flags=None) -> None:
        """Fold one window's device verdicts into the runtime's device
        accumulators (adds only; read at the next check).  The sync
        master's counter lives in its stability state, so it passes only
        ``poison_flags``."""
        with torch.no_grad():
            if nonfinite_count is not None:
                self._nf_acc = (nonfinite_count.clone() if self._nf_acc
                                is None else self._nf_acc + nonfinite_count)
            if poison_flags is not None:
                self._poison_acc = (
                    poison_flags.clone() if self._poison_acc is None
                    else self._poison_acc + poison_flags)

    def poll_master(self, *, step: int, losses=None, stab_state=None,
                    elastic=None, can_rewind: bool = True) -> Optional[str]:
        """A master's boundary duty (reference ``poll_master``): every
        ``check_every`` calls, harvest the accumulators (or the stability
        state), publish per-replica poison verdicts, run the sentinel.
        Returns None, ``"backoff"`` or ``"rewind"``; the caller applies
        it to its live trees.  Without a checkpoint to rewind to a
        rewind is a further backoff."""
        self._calls += 1
        if self._calls % self.policy.check_every:
            return None
        nonfinite_total = self._harvested_nonfinite
        if self._nf_acc is not None:
            nonfinite_total = _scalar(self._nf_acc)
        elif stab_state is not None:
            nonfinite_total = _scalar(stab_state["nonfinite_total"])
        scale = 1.0
        if stab_state is not None:
            scale = _scalar(stab_state["loss_scale"])
            self._lr_scale_host = _scalar(stab_state["lr_scale"])
        self._publish(nonfinite_total, scale)
        self._harvest_poison(step, elastic)
        loss = None
        if losses is not None:
            arr = (losses.detach().double().cpu().numpy()
                   if torch.is_tensor(losses) else np.asarray(losses,
                                                              np.float64))
            # poisoned replicas report NaN losses: judge the healthy ones
            loss = (float(np.nanmean(arr)) if np.isfinite(arr).any()
                    else float("nan"))
        action = self._verdict(step, loss,
                               nonfinite_total - self._harvested_nonfinite)
        self._harvested_nonfinite = nonfinite_total
        if action == "rewind" and not can_rewind:
            action = "backoff"
        if action == "backoff":
            self._record_backoff(step)
        return action

    def _harvest_poison(self, step: int, elastic) -> None:
        if self._poison_acc is None or not self.worker_ids:
            return
        from deeplearning4j_tpu_torch.observability import (
            get_flight_recorder,
        )

        counts = self._poison_acc.double().cpu().numpy().reshape(-1)
        for k, worker in enumerate(self.worker_ids):
            total = float(counts[k]) if k < len(counts) else 0.0
            prev = self._harvested_poison.get(worker, 0.0)
            # only a count that advanced is evidence: a readmitted
            # replica is not evicted again on its old total
            if total <= prev:
                continue
            self._m_poisoned.inc(total - prev, component=self.component,
                                 worker=worker)
            get_flight_recorder().record(
                "replica_poisoned", component=self.component,
                worker=worker, windows=int(total), step=int(step))
            self._harvested_poison[worker] = total
            if (elastic is not None
                    and total >= self.policy.poison_evict_after):
                elastic.report_poisoned(worker, step)

    # ----------------------------------------------------------- polling
    def poll_net(self, net, res=None) -> Optional[str]:
        """Facade boundary duty: harvest and sentinel every
        ``check_every`` calls; applies a backoff or rewind to the facade
        in place.  Returns the action taken."""
        self._calls += 1
        if self._calls % self.policy.check_every:
            return None
        stab = net.updater_state.get(STATE_KEY)
        if stab is None:
            return None
        # the engine's only host syncs: a few scalars, once a check
        nonfinite_total = _scalar(stab["nonfinite_total"])
        self._lr_scale_host = _scalar(stab["lr_scale"])
        loss = net.score_value
        self._publish(nonfinite_total, _scalar(stab["loss_scale"]))
        action = self._verdict(int(net.iteration), loss,
                               nonfinite_total - self._harvested_nonfinite)
        self._harvested_nonfinite = nonfinite_total
        if action == "backoff":
            apply_lr_backoff_(net.updater_state, self.policy)
            self._record_backoff(int(net.iteration))
        elif action == "rewind":
            cm = res.cm if res is not None else None
            if cm is None or self.rewind(net, cm) is None:
                # nothing to rewind to: a further backoff is what is left
                apply_lr_backoff_(net.updater_state, self.policy)
                self._record_backoff(int(net.iteration))
                action = "backoff"
        return action

    def flush(self, net=None, stab_state=None) -> None:
        """Final harvest at fit exit: publish what the device counter
        gathered since the last check (no verdict)."""
        if stab_state is None and net is not None:
            stab_state = net.updater_state.get(STATE_KEY)
        nonfinite_total = (_scalar(self._nf_acc) if self._nf_acc is not None
                           else None)
        scale = 1.0
        if stab_state is not None:
            if nonfinite_total is None:
                nonfinite_total = _scalar(stab_state["nonfinite_total"])
            scale = _scalar(stab_state["loss_scale"])
            self._lr_scale_host = _scalar(stab_state["lr_scale"])
        if nonfinite_total is None:
            return
        self._publish(nonfinite_total, scale)
        self._harvested_nonfinite = nonfinite_total
        self._harvest_poison(int(getattr(net, "iteration", 0) or 0), None)

    # ------------------------------------------------------ sentinel core
    def _publish(self, nonfinite_total: float, loss_scale: float) -> None:
        delta = nonfinite_total - self._harvested_nonfinite
        if delta > 0:
            self._m_nonfinite.inc(delta, component=self.component)
            from deeplearning4j_tpu_torch.observability import (
                get_flight_recorder,
            )
            get_flight_recorder().record(
                "nonfinite_steps", component=self.component,
                count=int(delta), total=int(nonfinite_total))
        self._m_scale.set(loss_scale, component=self.component)
        self._m_lr_scale.set(self._lr_scale_host, component=self.component)

    def _verdict(self, step: int, loss: Optional[float],
                 nf_delta: float) -> Optional[str]:
        """Escalation decision for one check window."""
        self._checks += 1
        sustained_nf = nf_delta >= self.policy.nonfinite_streak
        spike = False
        healthy_loss = (loss is not None and math.isfinite(loss))
        if healthy_loss:
            base = (sorted(self._baseline)[len(self._baseline) // 2]
                    if self._baseline else None)
            if (base is not None
                    and loss > self.policy.spike_factor * abs(base) + 1e-6):
                self._spike_strikes += 1
                spike = self._spike_strikes >= self.policy.spike_patience
            else:
                self._spike_strikes = 0
                self._baseline.append(loss)
        if not (sustained_nf or spike):
            if nf_delta == 0 and (loss is None or healthy_loss) \
                    and self._spike_strikes == 0:
                self._last_good_step = step
                self._level = 0
            return None
        if self._checks <= self._cooldown_until:
            return None
        self._level += 1
        return "backoff" if self._level == 1 else "rewind"

    def _record_backoff(self, step: int) -> None:
        from deeplearning4j_tpu_torch.observability import (
            get_flight_recorder,
        )

        self._lr_scale_host *= self.policy.lr_backoff
        self._m_backoffs.inc(component=self.component)
        self._m_lr_scale.set(self._lr_scale_host, component=self.component)
        get_flight_recorder().record(
            "divergence_backoff", component=self.component, step=int(step),
            lr_scale=self._lr_scale_host)
        self._cooldown_until = self._checks + 1

    # ------------------------------------------------------------ rewind
    def rewind(self, net, cm, *, mesh=None) -> Optional[int]:
        """Restore the newest checkpoint committed while the run was
        still healthy (else the oldest one kept), back off the LR, and
        re-arm the sentinel.  Returns the restored step, or None when
        nothing was restorable."""
        from deeplearning4j_tpu_torch.observability import (
            get_flight_recorder,
        )

        from_step = int(getattr(net, "iteration", 0))
        steps = cm.all_steps()
        good = [s for s in steps
                if self._last_good_step is None or s <= self._last_good_step]
        candidates = [max(good)] if good else []
        candidates += [s for s in sorted(steps) if s not in candidates]
        restored = None
        for target in candidates:
            try:
                cm.restore(net, step=target, mesh=mesh)
                restored = target
                break
            except (FileNotFoundError, OSError):
                continue
        if restored is None:
            get_flight_recorder().record(
                "divergence_rewind_unavailable", component=self.component,
                step=from_step)
            return None
        ensure_state(net)
        apply_lr_backoff_(net.updater_state, self.policy)
        # the restored counter is older than the last harvest
        self.baseline_from(net.updater_state.get(STATE_KEY))
        self._lr_scale_host *= self.policy.lr_backoff
        self._m_rewinds.inc(component=self.component)
        self._m_lr_scale.set(self._lr_scale_host, component=self.component)
        get_flight_recorder().record(
            "divergence_rewind", component=self.component,
            from_step=from_step, to_step=int(net.iteration))
        self._level = 0
        self._spike_strikes = 0
        self._cooldown_until = self._checks + self.policy.rewind_cooldown_checks
        self._baseline.clear()
        return restored
