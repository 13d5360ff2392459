"""Recompile detection — counterpart of
``deeplearning4j_tpu/observability/recompile.py``, re-derived for torch.

The reference fingerprints the *abstract* signature of a jitted
function's inputs (pytree structure + shape/dtype/sharding per leaf) and
counts each new one as an XLA compile.  The port's counterpart of a
compiled program is a captured CUDA graph: on the card a new signature
is a capture, and a capture of a signature already seen (a graph the
LRU of ``models/capture.py`` dropped and must capture again) is one too.
So ``RecompileDetector.check`` takes ``captured=``: the caller says
whether the call captured a graph, and the detector counts exactly
those; where nothing is captured (the CPU, or an eager program)
``captured=None`` keeps the reference's rule, one compile per new
signature.  "Zero steady-state compiles" then reads as zero captures.

Each count lands in ``dl4j_compiles_total{fn}`` and a ``compile`` flight
record; an unplanned one after the first also in
``dl4j_recompiles_total{fn}``, a warning with the old→new delta and a
``recompile`` flight record, e.g.::

    recompile #2 of serving.default: args[0]: f32[8,4] -> f32[16,4]

``fingerprint`` flattens tensors, ndarrays and scalars to (shape, dtype,
device) without ``jax.tree_util``.

``instrument(fn, name, graphs=)`` wraps a callable whose calls may
capture (the facades' train steps, ``models/common.py``): ``graphs()``
gives the ``models.capture.StepGraphs`` the call runs through (None
where it runs eagerly), and its ``captures``/``replays`` counters before
and after the call say whether it captured, which ``check`` gets as
``captured=``.  While a ``StepProfiler`` with cost analysis is
installed, a signature without a cost is counted on that call — its
first eager run, the genuine step, under ``helpers.cost.StepCost`` (a
capture of it is not counted again) — and every call hands the
signature's cost to the profiler (``note_dispatch``), as the reference's
``_InstrumentedJit`` does with XLA's cost analysis.  A call that only
replayed a graph captured before the profiler was installed ran no body
to count (no step runs twice to be measured): its signature stays
without a cost, so its next capture counts it, and a warning and one
``profile_cost_unavailable`` flight record say that its steps report no
flops or MFU until then.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

from deeplearning4j_tpu_torch.helpers.cost import StepCost
from deeplearning4j_tpu_torch.observability import profiling

logger = logging.getLogger("deeplearning4j_tpu_torch.observability")

_COMPILES = "dl4j_compiles_total"
_RECOMPILES = "dl4j_recompiles_total"


def _leaf_sig(leaf: Any) -> Tuple:
    """Signature of one leaf: (shape, dtype, device) for a tensor or an
    array, the type name for anything else (a Python scalar, a string)."""
    shape = getattr(leaf, "shape", None)
    if shape is None:
        return (type(leaf).__name__,)
    dtype = str(getattr(leaf, "dtype", None)).replace("torch.", "")
    device = getattr(leaf, "device", None)
    return (tuple(int(d) for d in shape), dtype,
            None if device is None else str(device))


def _fmt_leaf_sig(sig: Tuple) -> str:
    if len(sig) == 1:
        return sig[0]
    shape, dtype, device = sig
    short = {"float32": "f32", "float64": "f64", "bfloat16": "bf16",
             "float16": "f16", "int32": "i32", "int64": "i64",
             "bool": "b1", "uint32": "u32"}.get(dtype, dtype)
    s = f"{short}[{','.join(str(d) for d in shape)}]"
    if device not in (None, "cpu"):
        s += f"@{device}"
    return s


def _flatten(tree: Any, path: str, out: List[Tuple[str, Any]]):
    """Leaves of nested tuples, lists and dicts (keys sorted) with their
    paths, in order; the structure as a hashable value."""
    if isinstance(tree, dict):
        keys = sorted(tree, key=repr)
        return ("dict", tuple(
            (repr(k), _flatten(tree[k], f"{path}[{k!r}]", out))
            for k in keys))
    if isinstance(tree, (tuple, list)):
        return (type(tree).__name__, tuple(
            _flatten(v, f"{path}[{i}]", out) for i, v in enumerate(tree)))
    if tree is None:
        return None
    out.append((path, tree))
    return "*"


def fingerprint(args: Tuple, kwargs: Dict) -> Tuple:
    """Hashable signature of a call's inputs: (structure, leaf sigs)."""
    leaves: List[Tuple[str, Any]] = []
    treedef = _flatten((args, kwargs), "", leaves)
    return (treedef, tuple(_leaf_sig(l) for _, l in leaves))


def _fmt_signature(sig: Tuple, max_leaves: int = 12) -> str:
    """Readable one-line form of a fingerprint's leaf signatures
    (``f32[128,784], f32[128,10], …``) for flight-recorder records."""
    _treedef, leaves = sig
    parts = [_fmt_leaf_sig(s) for s in leaves[:max_leaves]]
    if len(leaves) > max_leaves:
        parts.append(f"… {len(leaves) - max_leaves} more")
    return ", ".join(parts)


def _leaf_paths(args: Tuple, kwargs: Dict) -> List[str]:
    """Human-readable path per leaf, same order as ``fingerprint``."""
    leaves: List[Tuple[str, Any]] = []
    _flatten((args, kwargs), "", leaves)
    out = []
    for label, _ in leaves:
        if label.startswith("[0]"):
            label = "args" + label[3:]
        elif label.startswith("[1]"):
            label = "kwargs" + label[3:]
        out.append(label)
    return out


class RecompileDetector:
    """Tracks the input signatures of one program family and counts its
    compiles (on the card: its graph captures)."""

    def __init__(self, name: str, registry=None,
                 warn: Optional[Callable[[str], None]] = None):
        from deeplearning4j_tpu_torch.observability.metrics import (
            get_registry,
        )

        self.name = name
        self.warn = warn or logger.warning
        self._lock = threading.Lock()
        self._seen: Dict[Tuple, int] = {}   # signature -> compile ordinal
        self._last: Optional[Tuple] = None
        self._cost_by_sig: Dict[Tuple, Dict] = {}
        self.last_cost: Optional[Dict] = None
        self.compile_count = 0
        self.recompile_count = 0  # unplanned compiles after the first
        reg = registry if registry is not None else get_registry()
        self._m_compiles = compile_counter(name, reg)
        self._m_recompiles = reg.counter(
            _RECOMPILES, "Signature changes after the first compile "
            "(shape/dtype/sharding churn)", labels=("fn",)
        ).labels(fn=name)

    def has_cost(self, args: Any, kwargs: Dict) -> bool:
        """Whether this signature's cost is known."""
        sig = fingerprint(args, kwargs)
        with self._lock:
            return sig in self._cost_by_sig

    def check(self, args: Any, kwargs: Dict, expected: bool = False,
              captured: Optional[bool] = None,
              cost: Optional[Dict] = None) -> bool:
        """Record this call's signature; returns True when the call
        compiled.  ``captured`` says whether it captured a graph (then
        that alone decides, a known signature captured again included);
        ``None`` (nothing is captured on this path) counts a compile for
        each new signature, the reference's rule.  ``expected=True`` marks
        a planned compile (warm-up sweeping its shapes): it counts in
        ``dl4j_compiles_total`` but neither warns nor counts as a
        recompile.  ``cost`` (the profiler seam): this call's counted
        cost (``helpers.cost.StepCost.as_dict``), kept for the signature
        and exposed as ``last_cost`` for every later call with it; an
        unexpected recompile's flight record then carries the new
        signature's flops and bytes and their delta against the evicted
        one."""
        sig = fingerprint(args, kwargs)
        with self._lock:
            known = sig in self._seen
            compiled = (not known) if captured is None else bool(captured)
            prev, self._last = self._last, sig
            if cost is not None:
                self._cost_by_sig[sig] = cost
            self.last_cost = self._cost_by_sig.get(sig)
            if not compiled:
                return False
            self.compile_count += 1
            ordinal = self.compile_count
            self._seen.setdefault(sig, ordinal)
            self._m_compiles.inc()
        from deeplearning4j_tpu_torch.observability.flightrecorder import (
            get_flight_recorder,
        )

        get_flight_recorder().record(
            "compile", fn=self.name, ordinal=ordinal,
            expected=bool(expected))
        if prev is not None and not expected:
            with self._lock:
                self.recompile_count += 1
            self._m_recompiles.inc()
            self.warn(self._delta_message(prev, sig, args, kwargs, known,
                                          ordinal))
            self._record_recompile_event(prev, sig, ordinal)
        return True

    def _record_recompile_event(self, prev: Tuple, new: Tuple,
                                ordinal: int) -> None:
        """The recompile's flight record: the new signature, the evicted
        one, and where both have a counted cost, their flops and bytes
        and the delta."""
        from deeplearning4j_tpu_torch.observability.flightrecorder import (
            get_flight_recorder,
        )

        ev: Dict[str, Any] = {
            "fn": self.name, "ordinal": ordinal,
            "signature": _fmt_signature(new),
            "evicted_signature": _fmt_signature(prev),
        }
        with self._lock:
            cost = self._cost_by_sig.get(new)
            prev_cost = self._cost_by_sig.get(prev)
        if cost:
            ev["flops"] = cost.get("flops")
            ev["bytes_accessed"] = cost.get("bytes_accessed")
        if prev_cost:
            ev["evicted_flops"] = prev_cost.get("flops")
            ev["evicted_bytes_accessed"] = prev_cost.get("bytes_accessed")
        if cost and prev_cost:
            ev["flops_delta"] = ((cost.get("flops") or 0.0)
                                 - (prev_cost.get("flops") or 0.0))
            ev["bytes_delta"] = ((cost.get("bytes_accessed") or 0.0)
                                 - (prev_cost.get("bytes_accessed") or 0.0))
        get_flight_recorder().record("recompile", **ev)

    def _delta_message(self, old: Tuple, new: Tuple, args, kwargs,
                       known: bool, ordinal: int) -> str:
        if known:
            delta = (f"signature {_fmt_signature(new)} captured again "
                     f"(its graph was dropped from the graph cache)")
        else:
            old_def, old_leaves = old
            new_def, new_leaves = new
            parts: List[str] = []
            if old_def != new_def:
                parts.append("structure changed")
            if len(old_leaves) == len(new_leaves):
                paths = _leaf_paths(args, kwargs)
                for i, (o, n) in enumerate(zip(old_leaves, new_leaves)):
                    if o != n:
                        parts.append(f"{paths[i]}: {_fmt_leaf_sig(o)} -> "
                                     f"{_fmt_leaf_sig(n)}")
            else:  # e.g. a mask appearing mid-run (None -> tensor)
                parts.append(f"leaf count {len(old_leaves)} -> "
                             f"{len(new_leaves)}")
            delta = "; ".join(parts[:8]) or "signature changed"
            if len(parts) > 8:
                delta += f"; … {len(parts) - 8} more"
        return (f"recompile #{ordinal} of {self.name}: {delta} (each one "
                f"costs a graph capture; pad/bucket inputs to stable "
                f"shapes to avoid this)")


class _Instrumented:
    """Transparent wrapper of a callable whose calls may capture (module
    docstring): ``__call__`` runs ``fn`` (under a ``StepCost`` when the
    installed profiler wants this signature's cost), then the detector
    with the call's ``captured=`` and cost, then the profiler's
    ``note_dispatch``; anything else delegates to ``fn``.  ``argnums``
    restricts the fingerprint to those positional args (the data)."""

    __slots__ = ("_fn", "detector", "_argnums", "_graphs", "_uncounted")

    def __init__(self, fn: Callable, detector: RecompileDetector,
                 argnums: Optional[Tuple[int, ...]] = None,
                 graphs: Optional[Callable[[], Any]] = None):
        self._fn = fn
        self.detector = detector
        self._argnums = argnums
        self._graphs = graphs
        self._uncounted: set = set()   # signatures warned of, no cost

    def __call__(self, *args, **kwargs):
        prof = profiling.active_profiler()
        sel = (args if self._argnums is None else
               {i: args[i] for i in self._argnums if i < len(args)})
        counter = None
        if (prof is not None and prof.cost_analysis
                and not self.detector.has_cost(sel, kwargs)):
            counter = StepCost()
        graphs = self._graphs() if self._graphs is not None else None
        if graphs is not None:
            before = (graphs.captures, graphs.replays)
        if counter is None:
            out = self._fn(*args, **kwargs)
        else:
            with counter:
                out = self._fn(*args, **kwargs)
        captured = replayed = None
        if graphs is not None:
            captured = graphs.captures > before[0]
            replayed = not captured and graphs.replays > before[1]
        cost = None
        if counter is not None:
            if replayed:
                self._cost_unavailable(sel, kwargs)
            else:
                cost = counter.as_dict()
        self.detector.check(sel, kwargs, captured=captured, cost=cost)
        if prof is not None:
            prof.note_dispatch(self.detector.name, self.detector.last_cost)
        return out

    def _cost_unavailable(self, args: Any, kwargs: Dict) -> None:
        """Once a signature: its graph was captured before the profiler
        was installed, so its replays ran no body to count."""
        from deeplearning4j_tpu_torch.observability.flightrecorder import (
            get_flight_recorder,
        )

        sig = fingerprint(args, kwargs)
        if sig in self._uncounted:
            return
        self._uncounted.add(sig)
        name = self.detector.name
        self.detector.warn(
            f"{name}: no step cost for {_fmt_signature(sig)}: its graph "
            f"was captured before the step profiler was installed, so its "
            f"steps report no flops or MFU until it is captured again")
        get_flight_recorder().record(
            "profile_cost_unavailable", fn=name,
            signature=_fmt_signature(sig),
            reason="captured before the profiler was installed")

    def __getattr__(self, item):
        return getattr(self._fn, item)

    def __repr__(self):
        return f"Instrumented({self.detector.name})"


def instrument(fn: Callable, name: str, registry=None,
               warn: Optional[Callable[[str], None]] = None,
               argnums: Optional[Tuple[int, ...]] = None,
               graphs: Optional[Callable[[], Any]] = None) -> _Instrumented:
    """Wrap a callable whose calls may capture with a RecompileDetector
    (module docstring).  ``argnums``: fingerprint only these positional
    args.  ``graphs()``: the ``StepGraphs`` whose counters say whether a
    call captured or replayed, or None where calls run eagerly (no
    ``graphs``: never captured, the reference's one compile per new
    signature)."""
    return _Instrumented(fn, RecompileDetector(name, registry, warn),
                         None if argnums is None else tuple(argnums),
                         graphs)


def compile_counter(fn_name: str, registry=None):
    """The shared ``dl4j_compiles_total{fn=}`` child for callers outside
    the detector — ONE owner for the family declaration, so label sets
    can never diverge."""
    from deeplearning4j_tpu_torch.observability.metrics import get_registry

    reg = registry if registry is not None else get_registry()
    return reg.counter(
        _COMPILES, "Distinct abstract input signatures (≈ XLA "
        "compilations) per jitted function", labels=("fn",)).labels(
        fn=fn_name)
