"""Updaters — counterpart of ``deeplearning4j_tpu/optimize/updaters.py``.

Plain functions over the nested parameter dicts ({layer: {param: tensor}},
deeper for composite layers): learning-rate and momentum schedules,
per-layer gradient normalization, ``init_state`` and ``update`` for SGD,
no-op, Nesterov momentum, AdaGrad, RMSProp, AdaDelta, Adam and AdamW, and
``apply_updates``.  ``update`` returns (updates to subtract, new state) as
the reference does; the train step then subtracts the updates from the
parameters in place (``apply_updates_``) and copies the new state into
the old state's tensors.  Schedules are evaluated on the host from the
integer iteration (``step_scalars``: the learning rate of each layer,
the momentum, Adam's bias corrections); ``update`` reads them from the
dict it is given, whose values may be Python floats or 0-d device
tensors that the host rewrites before each replay of a captured step.
The reference's ``as_optax`` has no counterpart.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Dict, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.conf import UpdaterConfig


# ---------------------------------------------------------------------------
# learning-rate / momentum schedules (reference LearningRatePolicy)
# ---------------------------------------------------------------------------

def schedule_value(base: float, policy: str, cfg: UpdaterConfig, iteration,
                   schedule: Optional[Dict[int, float]] = None) -> float:
    it = float(iteration)
    if policy == "none":
        return float(base)
    if policy == "exponential":
        return base * cfg.lr_policy_decay_rate ** it
    if policy == "inverse":
        return base / (1.0 + cfg.lr_policy_decay_rate * it) ** cfg.lr_policy_power
    if policy == "step":
        return base * cfg.lr_policy_decay_rate ** math.floor(
            it / cfg.lr_policy_steps)
    if policy == "poly":
        frac = min(max(it / max(cfg.lr_policy_steps, 1.0), 0.0), 1.0)
        return base * (1.0 - frac) ** cfg.lr_policy_power
    if policy == "sigmoid":
        return base / (1.0 + math.exp(-cfg.lr_policy_decay_rate
                                      * (it - cfg.lr_policy_steps)))
    if policy == "warmup_cosine":
        # linear warmup over lr_policy_warmup_steps, then cosine decay to
        # base * lr_policy_min_fraction at lr_policy_steps
        warm = max(cfg.lr_policy_warmup_steps, 1.0)
        total = max(cfg.lr_policy_steps, warm + 1.0)
        warm_frac = min(it / warm, 1.0)
        prog = min(max((it - warm) / (total - warm), 0.0), 1.0)
        floor = cfg.lr_policy_min_fraction
        cos = floor + (1.0 - floor) * 0.5 * (1.0 + math.cos(math.pi * prog))
        return base * warm_frac * cos
    if policy == "schedule":
        # piecewise constant: the value switches at each breakpoint
        val = float(base)
        for step_i in sorted(schedule or {}):
            if it >= step_i:
                val = float(schedule[step_i])
        return val
    raise ValueError(f"Unknown lr policy '{policy}'")


def current_lr(cfg: UpdaterConfig, iteration,
               override: Optional[float] = None) -> float:
    base = override if override is not None else cfg.learning_rate
    return schedule_value(base, cfg.lr_policy, cfg, iteration,
                          cfg.lr_schedule)


def current_momentum(cfg: UpdaterConfig, iteration) -> float:
    if cfg.momentum_schedule:
        return schedule_value(cfg.momentum, "schedule", cfg, iteration,
                              cfg.momentum_schedule)
    return float(cfg.momentum)


# ---------------------------------------------------------------------------
# gradient normalization (reference GradientNormalization)
# ---------------------------------------------------------------------------

def _norm(g: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(g.reshape(-1))


def _global_norm(grads: Dict) -> torch.Tensor:
    return torch.sqrt(sum((g * g).sum() for g in grads.values()))


_PER_LAYER = ("renormalize_l2_per_layer", "clip_l2_per_layer")
_PER_PARAM = ("renormalize_l2_per_param_type", "clip_l2_per_param_type")


def layer_norms(cfg: UpdaterConfig, layer_grads: Dict) -> Dict:
    """The L2 norms the configured normalization of ONE layer's flat
    gradient dict divides or clips by: ``{None: the layer's}`` for the
    per-layer kinds, ``{key: the leaf's}`` for the per-parameter ones,
    else ``{}``."""
    kind = cfg.gradient_normalization
    if kind in _PER_LAYER:
        return {None: _global_norm(layer_grads)}
    if kind in _PER_PARAM:
        return {k: _norm(g) for k, g in layer_grads.items()}
    return {}


def normalize_gradients(cfg: UpdaterConfig, layer_grads: Dict,
                        norms: Optional[Dict] = None):
    """The configured normalization of ONE layer's flat gradient dict;
    ``norms`` (``layer_norms``' form) in place of its own when the dict
    holds blocks of the layer's leaves (``given_norms``)."""
    kind = cfg.gradient_normalization
    t = cfg.gradient_normalization_threshold
    if kind == "none":
        return layer_grads
    if kind == "clip_element_wise_absolute_value":
        return {k: g.clamp(-t, t) for k, g in layer_grads.items()}
    if kind not in _PER_LAYER + _PER_PARAM:
        raise ValueError(f"Unknown gradient normalization '{kind}'")
    if norms is None:
        norms = layer_norms(cfg, layer_grads)
    out = {}
    for k, g in layer_grads.items():
        norm = norms[None] if kind in _PER_LAYER else norms[k]
        if kind.startswith("renormalize"):
            out[k] = g / (norm + 1e-12)
        else:
            out[k] = g * torch.where(norm > t, t / (norm + 1e-12),
                                     torch.ones_like(norm))
    return out


class _GivenNorms(threading.local):
    norms: Optional[Dict] = None


_given = _GivenNorms()


@contextlib.contextmanager
def given_norms(norms: Optional[Dict]):
    """Inside the block ``update`` normalizes layer ``name``'s gradient by
    ``norms[name]`` (``layer_norms``' form, filled in before the update
    runs) instead of by its own: the ZeRO sync master across processes
    updates blocks of each leaf, normalized by the whole leaves' norms.
    ``None`` changes nothing."""
    prev = _given.norms
    _given.norms = norms
    try:
        yield
    finally:
        _given.norms = prev


# ---------------------------------------------------------------------------
# per-updater state + step rules
# ---------------------------------------------------------------------------

def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    return torch.zeros_like(tree)


def state_slots(cfg: UpdaterConfig):
    """The names of the updater's per-parameter state trees."""
    name = cfg.name
    if name in ("sgd", "none", "noop"):
        return ()
    if name == "nesterovs":
        return ("v",)
    if name == "adagrad":
        return ("h",)
    if name == "rmsprop":
        return ("ms",)
    if name == "adadelta":
        return ("msg", "msdx")
    if name in ("adam", "adamw"):
        return ("m", "v")
    raise ValueError(f"Unknown updater '{cfg.name}'")


# updater-state subtrees that no updater owns: the stability guard's
# scalars (``resilience.stability``) and the introspection and numerics
# vectors (``observability.introspection``, ``observability.numerics``)
RESERVED_KEYS = ("__stability__", "__introspect__", "__numerics__")


def inner_state(state):
    """The updater state without its reserved subtrees: what ``update``
    understands."""
    return {k: v for k, v in state.items() if k not in RESERVED_KEYS}


def init_state(cfg: UpdaterConfig, params):
    """Per-leaf optimizer state (reference updater stateViewArray)."""
    return {slot: _zeros_like(params) for slot in state_slots(cfg)}


def _flat(d, prefix=()):
    """A layer's (possibly nested) param dict as {tuple path: leaf}."""
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _unflat(flat):
    out = {}
    for path, v in flat.items():
        cur = out
        for k in path[:-1]:
            cur = cur.setdefault(k, {})
        cur[path[-1]] = v
    return out


def normalize_tree(cfg: UpdaterConfig, grads):
    """Per-layer gradient normalization of a whole gradient tree — the
    walk ``update`` performs internally."""
    if cfg.gradient_normalization == "none":
        return grads
    return {lname: _unflat(normalize_gradients(cfg, _flat(lgrads)))
            for lname, lgrads in grads.items()}


def _bias_correction(beta: float, t: float) -> float:
    """1 - beta**t in float32, as the reference computes it: for
    beta2 = 0.999 the float32 cancellation shifts the first steps' Adam
    updates by about 1e-5 relative, and the port follows the reference."""
    return float(np.float32(1.0) - np.float32(beta) ** np.float32(t))


def step_scalars(cfg: UpdaterConfig, iteration, layers,
                 lr_overrides: Optional[Dict[str, float]] = None
                 ) -> Dict[object, float]:
    """The step's host floats, by name, as ``update`` reads them: the
    momentum ``"mu"``, Adam's bias corrections ``"bc1"`` and ``"bc2"``
    (``_bias_correction``'s float32 arithmetic) and, for each layer name
    in ``layers``, its learning rate ``("lr", layer)`` (schedule and
    override applied) and, under adamw, ``("lr_wd", layer)``, the
    learning rate times the weight decay."""
    lr_overrides = lr_overrides or {}
    t = float(iteration) + 1.0
    out: Dict[object, float] = {
        "mu": current_momentum(cfg, iteration),
        "bc1": _bias_correction(cfg.adam_beta1, t),
        "bc2": _bias_correction(cfg.adam_beta2, t)}
    for lname in layers:
        lr = current_lr(cfg, iteration, lr_overrides.get(lname))
        out[("lr", lname)] = lr
        if cfg.name == "adamw" and cfg.weight_decay:
            out[("lr_wd", lname)] = lr * cfg.weight_decay
    return out


def update(cfg: UpdaterConfig, grads, state, iteration,
           lr_overrides: Optional[Dict[str, float]] = None, params=None,
           scalars: Optional[Dict] = None):
    """(updates to SUBTRACT from the params, new updater state).

    ``grads``/``params`` are {layer name: {param name: tensor}}, nested
    further for composite layers; gradient normalization is per layer;
    ``lr_overrides`` maps layer name -> learning rate.  ``scalars`` is
    ``step_scalars``'s dict (floats or 0-d tensors); when None it is
    computed here from ``iteration`` and ``lr_overrides``."""
    name = cfg.name
    if name == "adamw" and params is None:
        raise ValueError(
            "adamw applies decoupled weight decay to the parameters; pass "
            "params= to updaters.update()")
    s = (step_scalars(cfg, iteration, grads, lr_overrides)
         if scalars is None else scalars)
    mu = s["mu"]
    new_state = {k: {} for k in state}
    updates = {}
    for lname, lgrads in grads.items():
        lgrads = normalize_gradients(
            cfg, _flat(lgrads),
            None if _given.norms is None else _given.norms[lname])
        lparams = _flat(params[lname]) if params is not None else {}
        lstate = {k: _flat(state[k].get(lname, {})) for k in state}
        lr = s[("lr", lname)]
        lup = {}
        lns = {k: {} for k in state}
        for pname, g in lgrads.items():
            if name == "sgd":
                u = lr * g
            elif name in ("none", "noop"):
                u = g
            elif name == "nesterovs":
                v = mu * lstate["v"][pname] - lr * g
                # params += mu * v_new - lr * g, i.e. subtract its negative
                u = -(mu * v - lr * g)
                lns["v"][pname] = v
            elif name == "adagrad":
                h = lstate["h"][pname] + g * g
                u = lr * g / (torch.sqrt(h) + cfg.epsilon)
                lns["h"][pname] = h
            elif name == "rmsprop":
                ms = (cfg.rmsprop_decay * lstate["ms"][pname]
                      + (1 - cfg.rmsprop_decay) * g * g)
                u = lr * g / torch.sqrt(ms + cfg.epsilon)
                lns["ms"][pname] = ms
            elif name == "adadelta":
                msg = cfg.rho * lstate["msg"][pname] + (1 - cfg.rho) * g * g
                msdx_prev = lstate["msdx"][pname]
                dx = torch.sqrt((msdx_prev + cfg.epsilon)
                                / (msg + cfg.epsilon)) * g
                lns["msg"][pname] = msg
                lns["msdx"][pname] = (cfg.rho * msdx_prev
                                      + (1 - cfg.rho) * dx * dx)
                u = dx  # adadelta has no learning rate
            elif name in ("adam", "adamw"):
                m = (cfg.adam_beta1 * lstate["m"][pname]
                     + (1 - cfg.adam_beta1) * g)
                v = (cfg.adam_beta2 * lstate["v"][pname]
                     + (1 - cfg.adam_beta2) * g * g)
                mhat = m / s["bc1"]
                vhat = v / s["bc2"]
                u = lr * mhat / (torch.sqrt(vhat) + cfg.epsilon)
                if name == "adamw" and cfg.weight_decay:
                    # decoupled decay acts on the parameter directly
                    u = u + s[("lr_wd", lname)] * lparams[pname]
                lns["m"][pname] = m
                lns["v"][pname] = v
            else:
                raise ValueError(f"Unknown updater '{name}'")
            lup[pname] = u
        updates[lname] = _unflat(lup)
        for k, flat in lns.items():
            if flat:
                new_state[k][lname] = _unflat(flat)
    return updates, new_state


def apply_updates(params, updates):
    """params - updates, as new tensors."""
    if isinstance(params, dict):
        return {k: apply_updates(params[k], updates[k]) if k in updates
                else params[k] for k in params}
    return params - updates


@torch.no_grad()
def apply_updates_(params, updates) -> None:
    """params -= updates, in place: the port keeps one copy of the f32
    parameters on the card instead of allocating a new one each step."""
    for k, u in updates.items():
        if isinstance(u, dict):
            apply_updates_(params[k], u)
        else:
            params[k].sub_(u.to(params[k].dtype))
