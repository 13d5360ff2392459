"""Numerics observability: the precision ledger.

Fused kernels and narrow (bf16/fp8) mixed precision both stall on the
same blind spot: the repo cannot *measure* its numerics.
This module is the measurement substrate — per-layer dynamic-range
statistics (max-abs, exponent histogram, fraction of values that would
underflow or overflow each candidate narrow format) for gradients,
updater moments, and activations, computed INSIDE the train step of
both facades (on the card: inside its captured CUDA graph) using the
introspection pattern:

- **device-side collection**: a reduction pass per leaf beside the
  update packs everything into ONE flat ``[N]`` float32 vector carried
  in a reserved ``__numerics__`` subtree of the updater state, written
  in place, and checkpointed with the Adam moments.  Zero host syncs on
  non-report steps, no capture after warm-up, and the update is
  computed as without the ledger (bit-identical parameters).  With
  ``interval > 1`` the host picks one of two programs from the
  iteration it knows (the reference branched with ``lax.cond``; a CUDA
  graph cannot): the collecting one, or the skipping one, which leaves
  the previous snapshot in place;
- **harvest** (host half): ONE device-to-host copy per reporting
  interval fans the vector out into per-(component, layer) entries with
  a **safety verdict** per candidate format — ``format_precision_ledger``
  renders the operator view and the
  ``dl4j_layer_overflow_risk{component,layer,dtype}`` gauges mirror it;
- **loss-scale telemetry joins the ledger**: the step's live
  ``__stability__`` loss scale is stamped into the packed vector, so a
  harvested report always shows which scale the gradient statistics
  were measured under (gradient stats are unscaled exactly, like the
  introspection norms);
- ``kv_page_ledger``: per-page dynamic-range stats over the generation
  engine's ``PagedKVCache`` pools — the int8-KV quantization-readiness
  evidence for an int8 KV cache.

Candidate formats and what "risky" means (docs/observability.md
"Numerics" has the full definitions):

- **overflow**: fraction of values with ``|x|`` above the format's max
  finite value — any nonzero fraction is an instant red flag;
- **underflow**: fraction of NONZERO values below the format's min
  normal — they flush to zero (or denormals) when narrowed;
- **absorption**: fraction of nonzero values more than the format's
  mantissa width below the tensor's max exponent — at the tensor's own
  scale these contribute nothing to an accumulation in that format.
  This is the bf16 failure mode: bf16 shares f32's exponent range, so
  it almost never over/underflows — it *absorbs*.  A gradient spike
  (``FaultInjector.poison_gradients(mode="spike")``) raises the max
  exponent by ~13 bits and flips the verdict, which is exactly the
  drill ``tests/test_numerics.py`` runs.

Metric families (docs/observability.md): ``dl4j_layer_overflow_risk``,
``dl4j_layer_max_abs``.

Port of ``deeplearning4j_tpu/observability/numerics.py``: the device half
in torch (``models/common.sgd_step`` calls it), the host half copied.
The exponent of a value is read exactly (``torch.frexp``), not through
a rounded ``log2``.
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

# Reserved subtree of the updater-state pytree (the ``__stability__`` /
# ``__introspect__`` pattern: stacked per replica, replicated by the
# sync master, donated, checkpointed without extra plumbing).
STATE_KEY = "__numerics__"

_RISK = "dl4j_layer_overflow_risk"
_MAXABS = "dl4j_layer_max_abs"

logger = logging.getLogger("deeplearning4j_tpu_torch.observability")

# Candidate narrow formats, in packed-vector order.  (name, min normal,
# max finite).  int8 is the per-page-scale variant the paged KV cache
# would use: scale = max_abs / 127, so a value quantizes to zero when
# |x| < max_abs / 254 — its "min normal" is relative to the tensor's
# own max, folded into the stats pass instead of a static threshold.
FORMATS: Tuple[Tuple[str, float, float], ...] = (
    ("bfloat16", 2.0 ** -126, 3.3895313892515355e38),
    ("float16", 2.0 ** -14, 65504.0),
    ("float8_e4m3", 2.0 ** -6, 448.0),
    ("int8", float("nan"), float("nan")),   # relative; see above
)
FORMAT_NAMES = tuple(f[0] for f in FORMATS)

# Effective mantissa bits per format (implicit bit included; int8 with a
# sign bit and 7 magnitude bits).  Values more than this many powers of
# two below a tensor's max are absorbed when accumulated at the
# tensor's scale in that format.
MANTISSA_BITS = {"bfloat16": 8, "float16": 11, "float8_e4m3": 4,
                 "int8": 7}

# Exponent histogram: one bin per power of two, floor(log2|x|) clipped
# into [HIST_LO, HIST_LO + HIST_BINS).  [-40, 24) covers every value a
# healthy f32 training run produces; the under/overflow fractions pin
# the extremes exactly, the histogram is for shape (and spike drills).
HIST_LO = -40
HIST_BINS = 64

# per-entry stat block: max_abs, 4 underflow fracs, 4 overflow fracs,
# then the exponent histogram
ENTRY = 1 + 2 * len(FORMATS) + HIST_BINS

# Default per-entry sample budget for the fraction/histogram pass (the
# expensive part of collection — ~40ns/element on CPU): a deterministic
# stride sample of this many values per (component, layer).  max-abs is
# ALWAYS an exact full pass, so the hard red flags (overflow = max_abs
# past the format's max finite, and the absorption cutoff derived from
# the max exponent) never depend on the sample; only the fraction
# magnitudes carry the ~1/sqrt(n) sampling error.  Policy knob:
# ``TrainingNumerics(sample=0)`` forces exact full-pass fractions.
DEFAULT_SAMPLE = 1024


# ---------------------------------------------------------------------------
# plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NumericsPlan:
    """Ordered layer-name inventory for one net's precision ledger:
    ``grad_names`` index the gradient and updater-moment entry blocks,
    ``act_names`` the activation block (empty when activation collection
    is off).  Built identically in the step and at harvest time, so
    entry slot k always means the same layer."""

    grad_names: Tuple[str, ...]
    act_names: Tuple[str, ...]
    policy: Any

    @property
    def collect_acts(self) -> bool:
        return bool(self.act_names)


def policy_of(conf):
    """The configuration's numerics policy (a config carries it as a
    dict), or None."""
    from deeplearning4j_tpu_torch.nn.conf import TrainingNumerics

    p = getattr(conf, "numerics", None)
    if p is None or isinstance(p, TrainingNumerics):
        return p
    return TrainingNumerics.from_dict(p)


def plan_for(net) -> Optional[NumericsPlan]:
    """The net's NumericsPlan, or None when ``conf.numerics`` is unset.
    Works for both facades (ComputationGraph detected by ``conf.nodes``)."""
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
    return NumericsPlan(grad_names=grad, act_names=acts, policy=policy)


def wants_acts(iplan, nplan, now=None) -> bool:
    """Whether the step must hand its layers' activations to the
    engines: introspection summarises them every step, the ledger on
    its collecting steps (``now`` is not False)."""
    return ((iplan is not None and iplan.collect_acts)
            or (nplan is not None and nplan.collect_acts
                and now is not False))


# ---------------------------------------------------------------------------
# device half
# ---------------------------------------------------------------------------

def _layout(plan: NumericsPlan) -> Dict[str, slice]:
    """Slice layout of the packed state vector: iteration, the live
    loss scale (NaN when the stability engine is off — the resilience
    telemetry joining the ledger), then one ENTRY-sized stat block per
    (component, layer): gradients, updater moments, activations."""
    L, A = len(plan.grad_names), len(plan.act_names)
    off = {"iteration": slice(0, 1), "loss_scale": slice(1, 2)}
    base = 2
    off["grad"] = slice(base, base + L * ENTRY)
    off["moment"] = slice(base + L * ENTRY, base + 2 * L * ENTRY)
    base = base + 2 * L * ENTRY
    off["act"] = slice(base, base + A * ENTRY)
    off["__size__"] = slice(0, base + A * ENTRY)
    return off


def initial_state(plan: NumericsPlan, device=None) -> Dict[str, torch.Tensor]:
    """Fresh device-side ledger state (``iteration`` -1 marks 'no step
    collected yet')."""
    n = _layout(plan)["__size__"].stop
    v = torch.zeros((n,), dtype=torch.float32, device=device)
    v[0] = -1.0
    return {"packed": v}


def ensure_state(net) -> None:
    """Make sure a numerics-enabled net carries the state subtree (nets
    initialized before the policy was set, deserialized nets); a subtree
    of another plan's size is replaced."""
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


def _flat_leaves(tree, scale=None):
    leaves = [torch.as_tensor(l).detach().float().reshape(-1)
              for l in _leaves(tree)]
    leaves = [l for l in leaves if l.numel()]
    if scale is not None:
        leaves = [l * scale for l in leaves]
    return leaves


def _max_abs(leaves) -> torch.Tensor:
    max_abs = leaves[0].abs().max()
    for l in leaves[1:]:
        max_abs = torch.maximum(max_abs, l.abs().max())
    return max_abs


def _stride(total: int, sample: int) -> int:
    """One GLOBAL stride: every sampled value represents the same
    element count, so plain sampled-count ratios are unbiased."""
    return -(-total // sample) if sample and total > sample else 1


def _counts(stat_leaves, max_abs) -> torch.Tensor:
    """The sampled values' counts, int64: per-format underflow and
    overflow, then the exponent histogram."""
    a = torch.cat([l.abs() for l in stat_leaves])
    nz = a > 0
    int8_lo = max_abs / 254.0   # int8 per-page scale: zero below max/254
    under, over = [], []
    for name, lo, hi in FORMATS:
        if name == "int8":
            under.append((nz & (a < int8_lo)).sum())
            over.append(torch.zeros((), dtype=torch.int64, device=a.device))
        else:
            under.append((nz & (a < lo)).sum())
            over.append((a > hi).sum())
    # floor(log2 |x|) exactly: frexp's x = m * 2**e with m in [0.5, 1)
    _, e = torch.frexp(torch.where(nz, a, torch.ones_like(a)))
    idx = torch.clamp(e.long() - 1 - HIST_LO, 0, HIST_BINS - 1)
    # an infinity lands in the top bin (the reference's clipped log2)
    idx = torch.where(torch.isinf(a), torch.full_like(idx, HIST_BINS - 1),
                      idx)
    idx = torch.where(nz, idx, torch.full_like(idx, HIST_BINS))
    hist = torch.zeros((HIST_BINS + 1,), dtype=torch.int64, device=a.device)
    hist.scatter_add_(0, idx, torch.ones_like(idx))
    return torch.cat([torch.stack(under), torch.stack(over),
                      hist[:HIST_BINS]])


def _pack(max_abs, counts, n: float) -> torch.Tensor:
    """An ``[ENTRY]`` block from the max-abs, the counts and the sampled
    count ``n``."""
    nf = len(FORMATS)
    # count x (1 / n) in float32, as the reference's compiled division
    inv_n = torch.tensor(1.0 / n, dtype=torch.float32).item()
    return torch.cat([max_abs.reshape((1,)),
                      counts[:2 * nf].float() * inv_n,
                      counts[2 * nf:].float()])


def _entry_stats(tree, scale=None, sample=DEFAULT_SAMPLE,
                 device=None) -> torch.Tensor:
    """One (component, layer) stat block ``[ENTRY]`` over every leaf of
    a subtree: exact max-abs (full pass), then per-format
    underflow/overflow fractions and the exponent histogram over a
    deterministic stride sample of ~``sample`` values (``sample=0`` =
    exact; see ``DEFAULT_SAMPLE``).  ``scale`` (the 1/loss_scale
    gradient unscale) multiplies values BEFORE the threshold
    comparisons — fractions do not commute with scaling, unlike the
    norms introspection collects.  Counts are exact integers; the
    exponent is ``frexp``'s."""
    leaves = _flat_leaves(tree, scale)
    if not leaves:
        return torch.zeros((ENTRY,), dtype=torch.float32, device=device)
    max_abs = _max_abs(leaves)
    stride = _stride(sum(l.numel() for l in leaves), sample)
    stat_leaves = [l[::stride] for l in leaves] if stride > 1 else leaves
    n = float(sum(l.numel() for l in stat_leaves))
    return _pack(max_abs, _counts(stat_leaves, max_abs), n)


def _entries_across(trees, sample) -> torch.Tensor:
    """``_entry_stats`` of each of ``trees`` as the reference computes it
    on the global batch, from this process's rows (the sync master
    across processes): each leaf's global tensor is the processes'
    leaves in rank order, so rank r's leaf starts at global offset
    ``r * n``, and its stride sample takes the local positions ``(-r*n)
    mod stride, ...`` of the one global sample.  The max-abs is the max
    over the processes before the counts (int8's threshold reads it);
    the counts and the sampled count are summed in rank order, and only
    then divided.  ``[len(trees), ENTRY]``."""
    from deeplearning4j_tpu_torch.backend import mesh as mesh_mod

    W, r = mesh_mod.process_count(), mesh_mod.process_index()
    per = [_flat_leaves(t) for t in trees]
    dev = next((l.device for ls in per for l in ls), None)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    max_abs = mesh_mod.process_all_gather(torch.stack(
        [_max_abs(ls) if ls else zero for ls in per]), "statistics").amax(0)
    rows, ns = [], []
    for ls, mx in zip(per, max_abs.unbind(0)):
        stride = _stride(W * sum(l.numel() for l in ls), sample)
        stat = [l[(-r * l.numel()) % stride::stride] for l in ls]
        stat = [l for l in stat if l.numel()]
        # the global sample's size: the multiples of the stride in each
        # leaf's global length
        ns.append(sum(-(-W * l.numel() // stride) for l in ls))
        rows.append(_counts(stat, mx) if stat else torch.zeros(
            (2 * len(FORMATS) + HIST_BINS,), dtype=torch.int64, device=dev))
    # summed as float64 (exact below 2**53): every backend's gather
    # carries it, on the card too
    total = mesh_mod.process_sum(torch.stack(rows).double(), "statistics")
    return torch.stack([
        _pack(mx, row, float(n)) if n
        else torch.zeros((ENTRY,), dtype=torch.float32, device=dev)
        for n, mx, row in zip(ns, max_abs.unbind(0), total.unbind(0))])


def _sample_of(policy) -> int:
    return int(getattr(policy, "sample", DEFAULT_SAMPLE)
               if policy is not None else DEFAULT_SAMPLE)


def _interval_of(policy) -> int:
    return int(getattr(policy, "interval", 1) or 1) if policy is not None else 1


def collect_now(plan, iteration: int):
    """The host's collect-this-step flag for interval-gated collection,
    or None when the ledger collects every step (``interval <= 1``).
    The step is one of two programs by this flag (both captured once):
    the collecting one, and the skipping one, which leaves the previous
    snapshot in place."""
    if plan is None:
        return None
    interval = _interval_of(plan.policy)
    if interval <= 1:
        return None
    return int(iteration) % interval == 0


def act_ranges(named_acts: Sequence[Tuple[str, torch.Tensor]],
               policy=None, processes: bool = False
               ) -> Dict[str, torch.Tensor]:
    """Per-layer activation range stats, stacked in input order to
    ``[A, ENTRY]`` — called in the step right after the forward, on the
    detached activations.  With ``processes`` (each rank holding its own
    rows of the global batch) the global batch's stats, the same on
    every rank (``_entries_across``)."""
    sample = _sample_of(policy)
    if processes:
        return {"num_act": _entries_across(
            [a.detach() for _, a in named_acts], sample)}
    return {"num_act": torch.stack(
        [_entry_stats(a.detach(), sample=sample) for _, a in named_acts])}


def _moments_of(upd_tree, name):
    """Every updater-moment leaf of one layer across the slot-keyed
    updater state (``{"m": {layer: ...}, "v": {layer: ...}}``); empty
    for moment-free updaters (SGD)."""
    if not isinstance(upd_tree, dict):
        return []
    return [tree[name] for k, tree in upd_tree.items()
            if not k.startswith("__") and isinstance(tree, dict)
            and name in tree]


def collect(plan: NumericsPlan, *, grads, upd_tree, iteration,
            act_stats=None, grad_scale=None) -> Dict[str, torch.Tensor]:
    """One step's refreshed ledger state.  ``grads`` are the step's raw
    gradients (loss-scaled under the stability engine — ``grad_scale``
    unscales them elementwise before the threshold stats), ``upd_tree``
    the NEW updater state whose moment leaves are measured,
    ``act_stats["num_act"]`` the activation block from ``act_ranges``
    and ``iteration`` the step's device scalar."""
    sample = _sample_of(plan.policy)
    dev = iteration.device
    parts = [iteration.float().reshape((1,)),
             ((1.0 / grad_scale).float().reshape((1,))
              if grad_scale is not None
              else torch.full((1,), float("nan"), dtype=torch.float32,
                              device=dev))]
    for name in plan.grad_names:
        parts.append(_entry_stats(grads.get(name, {}), scale=grad_scale,
                                  sample=sample, device=dev))
    for name in plan.grad_names:
        parts.append(_entry_stats(_moments_of(upd_tree, name),
                                  sample=sample, device=dev))
    if plan.act_names:
        if act_stats is None or "num_act" not in act_stats:
            raise ValueError(
                "plan collects activations but no num_act stats were "
                "passed (the step must hand over its activations)")
        parts.append(act_stats["num_act"].reshape(-1))
    return {"packed": torch.cat(parts)}


def attach_(upd_state, plan, *, now=None, **kw) -> None:
    """Write the refreshed ``__numerics__`` vector (``collect``'s
    arguments; moments read from ``upd_state`` itself, after the update,
    so the ledger reflects what the checkpoint would carry) into the
    net's state tensor in place.  A skipping step (``now`` False) writes
    nothing: the previous snapshot stays."""
    if plan is None or now is False:
        return
    upd_state[STATE_KEY]["packed"].copy_(
        collect(plan, upd_tree=upd_state, **kw)["packed"])


# ---------------------------------------------------------------------------
# host half: harvest, verdicts, metrics, ledger
# ---------------------------------------------------------------------------

def latest(model):
    """The most recent device-side ledger state: the masters stamp
    ``_numerics_live`` per step/window (the wrapper's stamp is the
    stacked ``[K, N]`` per-replica view); the facades' ``updater_state``
    is always current."""
    live = getattr(model, "_numerics_live", None)
    if live is not None:
        return live
    return model.updater_state.get(STATE_KEY)


def _entry_host(block: np.ndarray) -> Dict[str, Any]:
    """One host-side entry dict from an ``[ENTRY]`` (or stacked
    ``[K, ENTRY]``) stat block.  Stacked states merge conservatively:
    max-abs takes the max over replicas, fractions the finite mean,
    histograms the sum."""
    if block.ndim == 2:
        max_abs = float(np.nanmax(block[:, 0]))
        fr = np.nanmean(block[:, 1:1 + 2 * len(FORMATS)], axis=0)
        hist = np.nansum(block[:, 1 + 2 * len(FORMATS):], axis=0)
    else:
        max_abs = float(block[0])
        fr = block[1:1 + 2 * len(FORMATS)]
        hist = block[1 + 2 * len(FORMATS):]
    nf = len(FORMATS)
    return {
        "max_abs": max_abs,
        "underflow": {name: float(fr[i])
                      for i, name in enumerate(FORMAT_NAMES)},
        "overflow": {name: float(fr[nf + i])
                     for i, name in enumerate(FORMAT_NAMES)},
        "exponent_histogram": [float(c) for c in hist],
    }


def absorption_fraction(entry: Dict[str, Any], dtype: str) -> float:
    """Fraction of nonzero values more than ``MANTISSA_BITS[dtype]``
    powers of two below the entry's max exponent, read off the exponent
    histogram — values absorbed when accumulated at the tensor's scale
    in ``dtype``.  0.0 for empty/all-zero entries."""
    total = sum(entry["exponent_histogram"])
    if not math.isfinite(entry["max_abs"]):
        return 1.0   # a non-finite block: nothing of it is representable
    if total <= 0 or entry["max_abs"] <= 0:
        return 0.0
    max_exp = math.floor(math.log2(entry["max_abs"]))
    cut = max_exp - MANTISSA_BITS[dtype]   # exponents < cut are absorbed
    hi_bin = min(max(cut - HIST_LO, 0), HIST_BINS)
    return float(sum(entry["exponent_histogram"][:hi_bin]) / total)


_MAX_FINITE = {name: hi for name, _lo, hi in FORMATS}


def overflow_hard(entry: Dict[str, Any], dtype: str) -> bool:
    """The EXACT overflow red flag: the entry's (full-pass) max-abs
    exceeds the format's max finite value, or is itself not finite (a
    NaN max-abs; the reference passes it and then fails on its
    logarithm).  Authoritative even when the sampled overflow fraction
    missed the offending elements."""
    hi = _MAX_FINITE[dtype]
    m = entry["max_abs"]
    return math.isfinite(hi) and (not math.isfinite(m) or m > hi)


def verdicts(entry: Dict[str, Any], policy=None) -> Dict[str, bool]:
    """Per-format safety verdict for one entry: safe iff nothing
    overflows (sampled fraction OR the exact max-abs flag), and neither
    the underflow nor the absorption fraction exceeds the policy
    threshold (default 0.5 — 'narrowing this tensor keeps at least half
    its nonzero information')."""
    thresh = getattr(policy, "absorb_threshold", 0.5) if policy else 0.5
    out = {}
    for name in FORMAT_NAMES:
        risky = (entry["overflow"][name] > 0.0
                 or overflow_hard(entry, name)
                 or entry["underflow"][name] > thresh
                 or absorption_fraction(entry, name) > thresh)
        out[name] = not risky
    return out


def risk_score(entry: Dict[str, Any], dtype: str) -> float:
    """The scalar the ``dl4j_layer_overflow_risk`` gauge publishes: the
    worst of the overflow, underflow and absorption fractions for one
    (component, layer, dtype) — 0.0 is perfectly representable, 1.0 is
    total loss.  A hard overflow (max-abs past the format's max finite)
    is 1.0 outright: the narrowed tensor would carry infs."""
    if overflow_hard(entry, dtype):
        return 1.0
    return max(entry["overflow"][dtype], entry["underflow"][dtype],
               absorption_fraction(entry, dtype))


def harvest(state, plan: NumericsPlan) -> Optional[Dict[str, Any]]:
    """Fan a device-side ledger state out into host dicts with ONE
    batched device->host transfer.  A stacked ``[K, N]`` state (the
    wrapper's per-replica view) merges per ``_entry_host``."""
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
    policy = plan.policy

    def entries(key, names):
        sl = lay[key]
        blocks = packed[..., sl]
        out = {}
        for i, name in enumerate(names):
            b = blocks[..., i * ENTRY:(i + 1) * ENTRY]
            e = _entry_host(b)
            e["verdicts"] = verdicts(e, policy)
            out[name] = e
        return out

    it = packed[..., 0]
    ls = packed[..., 1]
    ls_val = float(np.nanmax(ls)) if stacked else float(ls)
    return {
        "iteration": int(it.max()) if stacked else int(it),
        "replicas": int(packed.shape[0]) if stacked else None,
        "loss_scale": ls_val if math.isfinite(ls_val) else None,
        "gradients": entries("grad", plan.grad_names),
        "moments": entries("moment", plan.grad_names),
        "activations": entries("act", plan.act_names),
    }


def harvest_model(model) -> Optional[Dict[str, Any]]:
    """``harvest(latest(model), plan_for(model))`` — the StatsListener /
    UI entry point; None when the ledger is off or nothing collected."""
    plan = plan_for(model)
    if plan is None:
        return None
    h = harvest(latest(model), plan)
    if h is not None and h["iteration"] < 0:
        return None   # state allocated but no step collected yet
    return h


_COMPONENTS = (("gradients", "grad"), ("moments", "moment"),
               ("activations", "act"))


def publish_metrics(harvested: Dict[str, Any], registry=None) -> None:
    """Mirror a harvested ledger into the gauge families.  Risk is
    published per (component, layer, dtype); max-abs per (component,
    layer) — the raw dynamic-range headline the risk derives from."""
    if registry is None:
        from deeplearning4j_tpu_torch.observability import get_registry
        registry = get_registry()
    g_risk = registry.gauge(
        _RISK, "Per-layer fraction of values at risk (overflow, "
        "underflow-to-zero, or mantissa absorption — the worst of the "
        "three) if this component were narrowed to the labeled dtype; "
        "from the most recent precision-ledger harvest "
        "(docs/observability.md \"Numerics\")",
        labels=("component", "layer", "dtype"))
    g_max = registry.gauge(
        _MAXABS, "Per-layer max-abs value of the most recent "
        "precision-ledger harvest (dynamic-range headline the "
        "overflow-risk verdicts derive from)",
        labels=("component", "layer"))
    for comp, short in _COMPONENTS:
        for layer, e in harvested[comp].items():
            if math.isfinite(e["max_abs"]):
                g_max.set(e["max_abs"], component=short, layer=layer)
            for dtype in FORMAT_NAMES:
                r = risk_score(e, dtype)
                if math.isfinite(r):
                    g_risk.set(r, component=short, layer=layer,
                               dtype=dtype)


def format_precision_ledger(harvested: Dict[str, Any]) -> str:
    """Operator view of one harvested ledger: a fixed-width table of
    per-(component, layer) max-abs and per-format safety verdicts."""
    if not harvested:
        return "precision ledger: nothing collected yet"
    lines = [f"precision ledger @ iteration {harvested['iteration']}"
             + (f" (replicas={harvested['replicas']})"
                if harvested.get("replicas") else "")
             + (f" loss_scale={harvested['loss_scale']:g}"
                if harvested.get("loss_scale") else "")]
    hdr = (f"  {'component':<10} {'layer':<28} {'max_abs':>12} "
           + " ".join(f"{n:>12}" for n in FORMAT_NAMES))
    lines.append(hdr)
    for comp, short in _COMPONENTS:
        for layer, e in harvested[comp].items():
            cells = []
            for dtype in FORMAT_NAMES:
                ok = e["verdicts"][dtype]
                cells.append(f"{'ok' if ok else 'RISK':>7} "
                             f"{risk_score(e, dtype):.2f}")
            lines.append(f"  {short:<10} {layer:<28} {e['max_abs']:>12.4g} "
                         + " ".join(f"{c:>12}" for c in cells))
    return "\n".join(lines)


class NumericsMonitor:
    """Per-report anomaly rules over harvested ledger stats: a layer
    whose bf16 safety verdict goes risky (on any component) emits ONE
    rate-limited warning + a ``numerics_anomaly`` flight event naming
    the layer, component and offending format — the alarm the
    ``poison_gradients(mode="spike")`` drill asserts fires."""

    def __init__(self, component: str = "training",
                 watch_formats: Sequence[str] = ("bfloat16",),
                 min_iteration: int = 1, warn_interval_s: float = 30.0,
                 warn=None):
        self.component = component
        self.watch_formats = tuple(watch_formats)
        self.min_iteration = int(min_iteration)
        self.warn_interval_s = float(warn_interval_s)
        self.warn = warn or logger.warning
        self._lock = threading.Lock()
        self._last_warn: Dict[Tuple[str, str, str], float] = {}

    def check(self, harvested: Optional[Dict[str, Any]],
              iteration: Optional[int] = None) -> List[Dict[str, Any]]:
        if harvested is None:
            return []
        it = harvested.get("iteration", iteration) or 0
        if it < self.min_iteration:
            return []
        violations: List[Dict[str, Any]] = []
        for comp, short in _COMPONENTS:
            for layer, e in harvested[comp].items():
                for dtype in self.watch_formats:
                    if not e["verdicts"].get(dtype, True):
                        violations.append({
                            "rule": "format_safety", "layer": layer,
                            "component": short, "dtype": dtype,
                            "value": risk_score(e, dtype),
                            "max_abs": e["max_abs"]})
        for v in violations:
            self._emit(v, it)
        return violations

    def _emit(self, v: Dict[str, Any], iteration: int) -> None:
        key = (v["layer"], v["component"], v["dtype"])
        now = time.monotonic()
        with self._lock:
            if now - self._last_warn.get(key, -math.inf) \
                    < self.warn_interval_s:
                return
            self._last_warn[key] = now
        from deeplearning4j_tpu_torch.observability import get_flight_recorder
        get_flight_recorder().record(
            "numerics_anomaly", component=self.component,
            rule=v["rule"], layer=v["layer"],
            tensor_component=v["component"], dtype=v["dtype"],
            value=float(v["value"]), iteration=int(iteration))
        self.warn(
            f"numerics anomaly in {self.component}: {v['component']} of "
            f"layer '{v['layer']}' is not {v['dtype']}-safe "
            f"(risk {v['value']:.3f}, max_abs {v['max_abs']:.4g}) "
            f"at iteration {iteration}")


# ---------------------------------------------------------------------------
# paged-KV-cache page ledger (generation engine)
# ---------------------------------------------------------------------------

def _host(arr) -> np.ndarray:
    """A pool leaf as a float32 host array."""
    if torch.is_tensor(arr):
        return arr.detach().float().cpu().numpy()
    return np.asarray(arr, np.float32)


def kv_page_ledger(pools: Dict[str, Any], page_size: int,
                   allocated: Optional[Sequence[int]] = None
                   ) -> Dict[str, Any]:
    """Per-page dynamic-range stats over the generation engine's paged
    KV pools — the int8-quantization-readiness evidence (per-page scale = page max_abs / 127; a page is 'int8-ready'
    when at most half its nonzero values would quantize to zero).

    ``pools``: ``{layer: {"pk": [P, page_size, Hkv, D], "pv": ...}}``
    (the engine's live pools; nested sub-layer dicts are walked and
    joined with ``/``, and a flat ``[P*page_size, ...]`` leading axis
    also works).  ``allocated``: page ids to report (defaults to every
    non-trash page).  ONE device_get per pool leaf; host-side numpy
    reductions after that — this is an operator/report surface, never
    called inside the decode loop."""
    def _leaf_pools(tree, prefix=""):
        # {"layer_1": {"sub1": {"pk": arr, "pv": arr}}} ->
        #   ("layer_1/sub1", {"pk": arr, "pv": arr})
        if all(not isinstance(v, dict) for v in tree.values()):
            yield prefix, tree
            return
        for key, sub in tree.items():
            name = f"{prefix}/{key}" if prefix else str(key)
            yield from _leaf_pools(sub, name)

    out: Dict[str, Any] = {}
    for layer, pool in _leaf_pools(pools):
        layer_entry: Dict[str, Any] = {}
        for leaf_name, arr in pool.items():
            a = np.abs(_host(arr))
            if a.ndim >= 2 and a.shape[1] == page_size:
                total = a.shape[0]            # [P, page_size, ...]
            else:                             # flat [P*page_size, ...]
                total = a.shape[0] // page_size
                a = a[:total * page_size].reshape(
                    (total, page_size) + a.shape[1:])
            pages = (list(allocated) if allocated is not None
                     else list(range(1, total)))   # page 0 = TRASH
            per = a.reshape(total, page_size, -1)
            max_abs, under, nonzero = [], [], []
            for p in pages:
                page = per[p]
                m = float(page.max()) if page.size else 0.0
                nz = page > 0
                n_nz = int(nz.sum())
                u = (float(((page < m / 254.0) & nz).sum()) / n_nz
                     if n_nz else 0.0)
                max_abs.append(m)
                under.append(u)
                nonzero.append(n_nz)
            ready = [u <= 0.5 for u in under]
            layer_entry[leaf_name] = {
                "pages": pages,
                "page_max_abs": max_abs,
                "int8_underflow": under,
                "nonzero_counts": nonzero,
                "int8_ready_fraction": (
                    sum(ready) / len(ready) if ready else 1.0),
            }
        out[layer] = layer_entry
    return out
