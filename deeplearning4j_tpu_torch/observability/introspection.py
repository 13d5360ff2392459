"""Training introspection: device-side per-layer gradient/update/
activation statistics, harvested once per reporting interval.

The reference system's headline observability feature was the web
training UI fed by ``StatsListener``/``StatsStorage`` (deeplearning4j-ui):
per-layer weight, gradient, update and activation distributions — the
diagnostics practitioners use to catch vanishing/exploding gradients,
dead units, and mistuned learning rates *before* a run is wasted.  The
stability engine only reacts once values go non-finite; gradual
degradation was invisible.  This module is the "see inside the model"
tier, rebuilt for the captured train step:

- **device-side collection** (used INSIDE every train step, so inside
  its captured CUDA graph on the card): per-layer gradient norm, update
  norm (computed from the ``params - new_params`` delta, so it reflects
  exactly what the updater + stability guard applied), param norm, and
  — via the facades' loss functions — activation mean/std/fraction-zero.
  Collection is a pass of its own beside the update (it reads the
  gradients, a copy of the pre-update parameters and the updated ones;
  the update is computed as without it, so the parameters are bit for
  bit those of the same net without the policy).  The results live in a
  reserved ``__introspect__`` subtree of the updater state (the
  ``__stability__`` pattern), one flat float32 vector written in place
  by the step, and checkpoint with the Adam moments.  Zero host syncs
  on non-report steps, no capture after the first step;
- **harvest** (host half): ``StatsListener`` copies the subtree to the
  host ONCE per reporting interval (between two replays) and fans it
  out into extended ``StatsReport`` fields, the ``dl4j_layer_*`` metric
  families, and the ``AnomalyMonitor``;
- **anomaly rules**: ``AnomalyMonitor`` checks each harvested report
  against the update:param-ratio band, the dead-unit fraction cap, and
  the cross-layer gradient-norm spread, emitting ONE rate-limited
  warning + ``introspection_anomaly`` flight event naming the offending
  layer.  The same thresholds are queryable as ``HealthRule`` kinds
  (``update_ratio_band`` / ``max_dead_fraction`` /
  ``max_gradient_norm_ratio``) against the published gauges, so
  ``GET /health`` sees them too.

Metric families (docs/observability.md): ``dl4j_layer_gradient_norm``,
``dl4j_layer_update_norm``, ``dl4j_layer_update_ratio``,
``dl4j_layer_dead_fraction``.

Port of ``deeplearning4j_tpu/observability/introspection.py``: the
device half in torch (``models/common.sgd_step`` calls it), the host
half copied.  A ``ParallelWrapper`` leaves the per-replica ``[K, N]``
stack as ``net._introspect_live``, which ``harvest`` reads replica by
replica (its master branch).
"""

from __future__ import annotations

import dataclasses
import logging
import math
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

# Reserved subtree of the updater-state pytree.  Living inside updater
# state means the per-layer stat vectors are stacked per replica by
# ParallelWrapper, replicated by the sync master, donated with the step,
# and checkpointed/restored by CheckpointManager without extra plumbing.
STATE_KEY = "__introspect__"

_GRAD = "dl4j_layer_gradient_norm"
_UPD = "dl4j_layer_update_norm"
_RATIO = "dl4j_layer_update_ratio"
_DEAD = "dl4j_layer_dead_fraction"

logger = logging.getLogger("deeplearning4j_tpu_torch.observability")


# ---------------------------------------------------------------------------
# plan: the per-net layer inventory both halves agree on
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class IntrospectPlan:
    """Ordered layer-name inventory for one net: ``grad_names`` index the
    ``[L]`` gradient/update/param-norm vectors, ``act_names`` the ``[A]``
    activation-summary vectors (empty when activation collection is
    off).  Built identically in the step and at harvest time
    (StatsListener), so vector slot k always means the same layer."""

    grad_names: Tuple[str, ...]
    act_names: Tuple[str, ...]
    policy: Any

    @property
    def collect_acts(self) -> bool:
        return bool(self.act_names)


def policy_of(conf):
    """The configuration's introspection policy (a config carries it as
    a dict), or None."""
    from deeplearning4j_tpu_torch.nn.conf import TrainingIntrospection

    p = getattr(conf, "introspection", None)
    if p is None or isinstance(p, TrainingIntrospection):
        return p
    return TrainingIntrospection.from_dict(p)


def plan_for(net) -> Optional[IntrospectPlan]:
    """The net's IntrospectPlan, or None when ``conf.introspection`` is
    unset.  Works for both facades (ComputationGraph is detected by its
    ``conf.nodes``)."""
    policy = policy_of(net.conf)
    if policy is None:
        return None
    nodes = getattr(net.conf, "nodes", None)
    if nodes is not None:  # ComputationGraph
        grad = tuple(n.name for n in nodes
                     if n.layer is not None and n.layer.has_params())
        acts = tuple(n.name for n in nodes if n.layer is not None)
    else:                  # MultiLayerNetwork
        grad = tuple(l.name for l in net.layers if l.has_params())
        acts = tuple(l.name for l in net.layers)
    if not policy.collect_activations:
        acts = ()
    return IntrospectPlan(grad_names=grad, act_names=acts, policy=policy)


# ---------------------------------------------------------------------------
# device half: called INSIDE the train step (no host syncs anywhere)
# ---------------------------------------------------------------------------

def _layout(plan: IntrospectPlan) -> Dict[str, slice]:
    """Slice layout of the packed state vector: ONE flat ``[N]`` tensor
    (iteration, then the per-layer vectors), written in place by the
    step and copied to the host in one piece."""
    L, A = len(plan.grad_names), len(plan.act_names)
    off = {"iteration": slice(0, 1),
           "grad_norm": slice(1, 1 + L),
           "update_norm": slice(1 + L, 1 + 2 * L),
           "param_norm": slice(1 + 2 * L, 1 + 3 * L)}
    base = 1 + 3 * L
    if A:
        off["act_mean"] = slice(base, base + A)
        off["act_std"] = slice(base + A, base + 2 * A)
        off["act_zero"] = slice(base + 2 * A, base + 3 * A)
    off["__size__"] = slice(0, base + 3 * A)
    return off


def initial_state(plan: IntrospectPlan, device=None) -> Dict[str, torch.Tensor]:
    """Fresh device-side introspection state (``iteration`` -1 marks 'no
    step collected yet')."""
    n = _layout(plan)["__size__"].stop
    v = torch.zeros((n,), dtype=torch.float32, device=device)
    v[0] = -1.0
    return {"packed": v}


def ensure_state(net) -> None:
    """Make sure an introspection-enabled net carries the state subtree
    (nets initialized before the policy was set, deserialized nets); a
    subtree of another plan's size (a restored zip of another
    configuration) is replaced."""
    plan = plan_for(net)
    if plan is None:
        return
    cur = net.updater_state.get(STATE_KEY)
    n = _layout(plan)["__size__"].stop
    if (not isinstance(cur, dict) or not torch.is_tensor(cur.get("packed"))
            or tuple(cur["packed"].shape) != (n,)):
        net.updater_state[STATE_KEY] = initial_state(plan, net.device)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


def _layer_norms(names, trees, device) -> torch.Tensor:
    """``[L]``: each named subtree's L2 norm over all its leaves, in
    float32 — one multi-tensor norm over every leaf (no squared copy of
    any leaf), then the leaves' squares summed a layer."""
    leaves = [_leaves(trees.get(n, {})) for n in names]
    flat = [t if t.dtype == torch.float32 else t.float()
            for group in leaves for t in group]
    norms = iter(torch._foreach_norm(flat) if flat else [])
    out = []
    for group in leaves:
        sq = [next(norms).square() for _ in group]
        out.append(torch.sqrt(torch.stack(sq).sum()) if sq else
                   torch.zeros((), dtype=torch.float32, device=device))
    return torch.stack(out)


def act_summary(named_acts: Sequence[Tuple[str, torch.Tensor]],
                dead_eps: float = 0.0, processes: bool = False
                ) -> Dict[str, torch.Tensor]:
    """Per-layer activation summaries, stacked in input order: mean,
    std, and fraction-"dead" (``|a| <= dead_eps``; exact zeros for the
    ReLU dying-unit case).  Called in the step right after the forward,
    on the detached activations (moment form: sum, sum of squares and
    the zero count).  With ``processes`` (the sync master across
    processes, where each rank's forward holds only its own rows of the
    global batch) the partial sums and counts are summed over the
    processes in rank order before the moments are formed, so every
    rank reports the global batch's numbers."""
    parts, counts = [], []
    for _, a in named_acts:
        a = a.detach()
        n = a.numel()
        # one read each, in float32, no upcast copy of the activation
        s1 = a.sum(dtype=torch.float32)
        s2 = torch.linalg.vector_norm(a, dtype=torch.float32).square()
        if dead_eps == 0:
            z = (n - torch.count_nonzero(a)).float()
        else:
            z = (a.abs() <= dead_eps).sum(dtype=torch.float32)
        parts.append(torch.stack([s1, s2, z]))
        counts.append(n)
    sums = torch.stack(parts)
    if processes:
        from deeplearning4j_tpu_torch.backend import mesh as mesh_mod

        # the rows split evenly over the processes (the batch is padded
        # to the data axis), so the global count is W times the local
        sums = mesh_mod.process_sum(sums, "statistics")
        counts = [n * mesh_mod.process_count() for n in counts]
    means, stds, zeros = [], [], []
    for (s1, s2, z), n in zip(sums.unbind(0), counts):
        mean = s1 / n
        var = torch.clamp(s2 / n - mean.square(), min=0.0)
        means.append(mean)
        stds.append(torch.sqrt(var))
        zeros.append(z / n)
    return {"act_mean": torch.stack(means), "act_std": torch.stack(stds),
            "act_zero": torch.stack(zeros)}


def collect(plan: IntrospectPlan, *, grads, params, new_params, iteration,
            act_stats=None, grad_scale=None) -> Dict[str, torch.Tensor]:
    """One step's refreshed introspection state: per-layer gradient norm
    (``grad_scale`` unscales loss-scaled gradients — norms are
    positively homogeneous, so scaling after the sqrt is exact), update
    norm from the ``params - new_params`` delta (``params`` a copy taken
    before the in-place update: it reflects exactly what was applied,
    including LR overrides, stability masks and backoffs), and the
    pre-update param norm the update:param ratio divides by.
    ``iteration`` is the step's device scalar."""
    device = iteration.device
    names = plan.grad_names
    grad_norm = _layer_norms(names, grads, device)
    param_norm = _layer_norms(names, params, device)
    delta = {}
    for name in names:
        old = [o.float() for o in _leaves(params[name])]
        delta[name] = torch._foreach_sub(
            old, [n.float() for n in _leaves(new_params[name])])
    update_norm = _layer_norms(names, delta, device)
    if grad_scale is not None:
        grad_norm = grad_norm * grad_scale
    parts = [iteration.float().reshape((1,)), grad_norm, update_norm,
             param_norm]
    if plan.act_names:
        if act_stats is None:
            raise ValueError(
                "plan collects activations but no act_stats were passed")
        parts += [act_stats["act_mean"], act_stats["act_std"],
                  act_stats["act_zero"]]
    return {"packed": torch.cat(parts)}


def attach_(upd_state, plan, **kw) -> None:
    """Write the refreshed ``__introspect__`` vector (``collect``'s
    arguments) into the net's state tensor in place, so a captured step
    writes where the harvest reads."""
    if plan is not None:
        upd_state[STATE_KEY]["packed"].copy_(collect(plan, **kw)["packed"])


# ---------------------------------------------------------------------------
# host half: harvest, metrics, anomaly rules
# ---------------------------------------------------------------------------

def latest(model):
    """The most recent device-side introspection state for this model:
    the masters stamp ``_introspect_live`` per step/window (their live
    state never touches ``model.updater_state`` mid-fit; the wrapper's
    stamp is the stacked ``[K, L]`` per-replica view), the facades'
    ``updater_state`` is always current."""
    live = getattr(model, "_introspect_live", None)
    if live is not None:
        return live
    return model.updater_state.get(STATE_KEY)


def harvest(state, plan: IntrospectPlan) -> Optional[Dict[str, Any]]:
    """Fan a device-side state out into per-layer host dicts with ONE
    batched device->host transfer.  A stacked ``[K, L]`` state (the
    wrapper's per-replica view) yields ``per_replica`` lists next to the
    healthy-mean scalars."""
    if state is None or plan is None:
        return None
    packed = state["packed"]
    if torch.is_tensor(packed):
        packed = packed.detach().cpu().numpy()   # the report's one copy
    packed = np.asarray(packed)
    lay = _layout(plan)
    if packed.shape[-1] != lay["__size__"].stop:
        return None   # state from a different plan shape (stale stamp)
    stacked = packed.ndim == 2
    replicas = int(packed.shape[0]) if stacked else None
    host = {k: (packed[:, sl] if stacked else packed[sl])
            for k, sl in lay.items() if k != "__size__"}
    host["iteration"] = host["iteration"][..., 0]

    def split(vec, i):
        col = vec[:, i] if stacked else None
        val = float(vec[i]) if not stacked else _finite_mean(col)
        return val, col

    def entry(vec, i, key):
        val, col = split(vec, i)
        out = {key: val}
        if col is not None:
            out["per_replica"] = [float(v) for v in col]
        return out

    gradient_stats, update_stats = {}, {}
    for i, name in enumerate(plan.grad_names):
        gradient_stats[name] = entry(host["grad_norm"], i, "norm")
        e = entry(host["update_norm"], i, "norm")
        p, _ = split(host["param_norm"], i)
        e["param_norm"] = p
        e["ratio"] = (e["norm"] / p if p and math.isfinite(p) and p > 0
                      else float("nan"))
        update_stats[name] = e
    activation_stats = {}
    for i, name in enumerate(plan.act_names):
        activation_stats[name] = {
            "mean": split(host["act_mean"], i)[0],
            "std": split(host["act_std"], i)[0],
            "zero_fraction": split(host["act_zero"], i)[0],
        }
        if stacked:
            activation_stats[name]["per_replica_zero_fraction"] = [
                float(v) for v in host["act_zero"][:, i]]
    it = host["iteration"]
    return {
        "iteration": int(it.max()) if stacked else int(it),
        "replicas": replicas,
        "gradient_stats": gradient_stats,
        "update_stats": update_stats,
        "activation_stats": activation_stats,
    }


def _finite_mean(col) -> float:
    vals = col[np.isfinite(col)]
    return float(vals.mean()) if vals.size else float("nan")


def harvest_model(model) -> Optional[Dict[str, Any]]:
    """``harvest(latest(model), plan_for(model))`` — the StatsListener
    entry point; None when introspection is off or nothing collected."""
    plan = plan_for(model)
    if plan is None:
        return None
    h = harvest(latest(model), plan)
    if h is not None and h["iteration"] < 0:
        return None   # state allocated but no step collected yet
    return h


def publish_metrics(harvested: Dict[str, Any], registry=None) -> None:
    """Mirror a harvested report into the ``dl4j_layer_*`` gauge
    families (healthy-mean values; the per-replica detail stays in the
    StatsReport).  The health-rule kinds ``update_ratio_band`` /
    ``max_dead_fraction`` / ``max_gradient_norm_ratio`` read these."""
    if registry is None:
        from deeplearning4j_tpu_torch.observability import get_registry
        registry = get_registry()
    g_grad = registry.gauge(
        _GRAD, "Per-layer L2 gradient norm of the most recent introspected "
        "train step (device-computed; unscaled when loss scaling is on)",
        labels=("layer",))
    g_upd = registry.gauge(
        _UPD, "Per-layer L2 norm of the parameter update actually applied "
        "by the most recent introspected train step", labels=("layer",))
    g_ratio = registry.gauge(
        _RATIO, "Per-layer update:param norm ratio of the most recent "
        "introspected step (~1e-3 is the classic healthy band; read by "
        "the update_ratio_band health rule)", labels=("layer",))
    g_dead = registry.gauge(
        _DEAD, "Per-layer fraction of activations at (or within dead_eps "
        "of) zero in the most recent introspected step — dead-unit "
        "detection; read by the max_dead_fraction health rule",
        labels=("layer",))
    for layer, e in harvested["gradient_stats"].items():
        if math.isfinite(e["norm"]):
            g_grad.set(e["norm"], layer=layer)
    for layer, e in harvested["update_stats"].items():
        if math.isfinite(e["norm"]):
            g_upd.set(e["norm"], layer=layer)
        if math.isfinite(e["ratio"]):
            g_ratio.set(e["ratio"], layer=layer)
    for layer, e in harvested["activation_stats"].items():
        if math.isfinite(e["zero_fraction"]):
            g_dead.set(e["zero_fraction"], layer=layer)


class AnomalyMonitor:
    """Per-report anomaly rules over harvested introspection stats.

    Three checks, mirroring the ``HealthRule`` kinds so the live warning
    and the ``/health`` verdict agree:

    - ``update_ratio_band`` — a layer's update:param ratio outside
      ``[band_low, band_high]`` (too low: the layer is frozen /
      vanishing; too high: the LR is about to bounce the weights);
    - ``max_dead_fraction`` — a layer's activation zero-fraction above
      the cap (dying-ReLU detection);
    - ``max_gradient_norm_ratio`` — the max:min spread of per-layer
      gradient norms above the cap (vanishing/exploding across depth).

    Each violation emits ONE rate-limited warning + an
    ``introspection_anomaly`` flight event naming the offending layer;
    ``check`` returns every violation for programmatic use."""

    def __init__(self, component: str = "training",
                 band_low: float = 1e-7, band_high: float = 1.0,
                 max_dead_fraction: float = 0.95,
                 max_gradient_norm_ratio: float = 1e6,
                 min_iteration: int = 1, warn_interval_s: float = 30.0,
                 warn=None):
        if band_low > band_high:
            raise ValueError(f"band_low {band_low} > band_high {band_high}")
        self.component = component
        self.band_low = float(band_low)
        self.band_high = float(band_high)
        self.max_dead_fraction = float(max_dead_fraction)
        self.max_gradient_norm_ratio = float(max_gradient_norm_ratio)
        # the very first updates out of a fresh init are legitimately
        # out-of-band (zero Adam moments, warmup); give them grace
        self.min_iteration = int(min_iteration)
        self.warn_interval_s = float(warn_interval_s)
        self.warn = warn or logger.warning
        self._lock = threading.Lock()
        self._last_warn: Dict[Tuple[str, str], float] = {}

    def check(self, harvested: Dict[str, Any],
              iteration: Optional[int] = None) -> List[Dict[str, Any]]:
        if harvested is None:
            return []
        it = harvested.get("iteration", iteration) or 0
        if it < self.min_iteration:
            return []
        violations: List[Dict[str, Any]] = []
        for layer, e in harvested["update_stats"].items():
            r = e.get("ratio")
            if r is None or not math.isfinite(r) or r == 0.0:
                continue   # skipped/no-op step: no evidence either way
            if not (self.band_low <= r <= self.band_high):
                violations.append({
                    "rule": "update_ratio_band", "layer": layer,
                    "value": r,
                    "limit": (self.band_low, self.band_high)})
        for layer, e in harvested["activation_stats"].items():
            z = e.get("zero_fraction")
            if z is not None and math.isfinite(z) \
                    and z > self.max_dead_fraction:
                violations.append({
                    "rule": "max_dead_fraction", "layer": layer,
                    "value": z, "limit": self.max_dead_fraction})
        norms = {l: e["norm"] for l, e in harvested["gradient_stats"].items()
                 if math.isfinite(e["norm"]) and e["norm"] > 0}
        if len(norms) >= 2:
            lo_l = min(norms, key=norms.get)
            hi_l = max(norms, key=norms.get)
            ratio = norms[hi_l] / norms[lo_l]
            if ratio > self.max_gradient_norm_ratio:
                violations.append({
                    "rule": "max_gradient_norm_ratio", "layer": lo_l,
                    "value": ratio, "limit": self.max_gradient_norm_ratio,
                    "detail": f"max {hi_l}={norms[hi_l]:.3g} vs "
                              f"min {lo_l}={norms[lo_l]:.3g}"})
        for v in violations:
            self._emit(v, it)
        return violations

    def _emit(self, v: Dict[str, Any], iteration: int) -> None:
        key = (v["rule"], v["layer"])
        now = time.monotonic()
        with self._lock:
            if now - self._last_warn.get(key, -math.inf) \
                    < self.warn_interval_s:
                return
            self._last_warn[key] = now
        from deeplearning4j_tpu_torch.observability import get_flight_recorder
        get_flight_recorder().record(
            "introspection_anomaly", component=self.component,
            rule=v["rule"], layer=v["layer"], value=float(v["value"]),
            iteration=int(iteration))
        self.warn(
            f"introspection anomaly in {self.component}: {v['rule']} on "
            f"layer '{v['layer']}' (value {v['value']:.4g}, limit "
            f"{v['limit']}{', ' + v['detail'] if 'detail' in v else ''}) "
            f"at iteration {iteration}")
