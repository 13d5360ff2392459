"""Memory and collective observability: the sharding ledger — the port's
counterpart of ``deeplearning4j_tpu/observability/shardstats.py``.

- **The sharding ledger** (``sharding_ledger`` / ``record_ledger``): walk
  params / updater / net-state trees with their actual layouts over a
  slot mesh (``backend.mesh``: a ``Sharded`` leaf holds one block a
  slot; a plain tensor is one copy) and report the bytes a slot holds,
  the replication factor per tree and subtree, and a projected-ZeRO
  column (bytes a slot would hold if the tree were scattered over the
  data axis) -> ``dl4j_sharded_bytes{component,tree}`` /
  ``dl4j_replication_factor{component,tree}`` and ``format_ledger``.
  It reads shape and dtype only: never a buffer, never a sync.
- **Per-program accounting** (``program_analysis``): there is no HLO to
  read, so the census is what the slot collectives
  (``backend.mesh.psum`` & co) recorded while a program's body ran once
  — its op, payload bytes and group size — kept per program signature
  by the masters' ``recompile.instrument`` seam (``record_program``),
  with the bytes the captured graph's pool took (``torch.cuda``'s
  allocator counters around the capture).  Under a mesh that spans
  processes the census also carries each collective's cross-process
  half: ``process_count``, ``process_bytes`` (what this rank sent) and
  ``process_seconds`` (measured host time), which ``record_program``
  sums beside the slot bytes.
- **A comm roofline**: ``LINK_BANDWIDTH`` turns censused bytes into
  estimated seconds per step.  On one card the slots share its memory
  and no collective crosses a link: the bytes are a census of what a
  mesh of cards would move, and the seconds a projection over the
  card's NVLink figure, never a measurement.
"""

from __future__ import annotations

import logging
import math
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.backend.mesh import Sharded

_PROGRAM_MEMORY = "dl4j_program_memory_bytes"
_COLL_BYTES = "dl4j_step_collective_bytes"
_COLL_TOTAL = "dl4j_step_collectives_total"
_SHARDED_BYTES = "dl4j_sharded_bytes"
_REPLICATION = "dl4j_replication_factor"

# Per-device interconnect bandwidth, bytes/s, all links combined —
# data-sheet figures.  "gpu": NVIDIA H100 SXM5, NVLink 4, 900 GB/s
# (NVIDIA H100 Tensor Core GPU data sheet); the TPU rows are the
# reference's.  Every consumer labels the derived seconds as estimates.
LINK_BANDWIDTH = {
    "gpu": 900e9,
    "TPU v6": 448e9,
    "TPU v5p": 600e9,
    "TPU v5": 200e9,
    "TPU v4": 300e9,
    "TPU v3": 112e9,
    "TPU v2": 62e9,
}

# ESTIMATE (the reference's): on the CPU a slot collective is a memcpy
# through DRAM, order of 10 GB/s.
CPU_LINK_BANDWIDTH_ESTIMATE = 10e9

COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter",
                  "collective-permute", "all-to-all")


def link_bandwidth_for(device=None) -> Tuple[float, str]:
    """(link bandwidth bytes/s, source) for a ``torch.device`` (default:
    the card, else the CPU).  source: ``"table"`` (the data sheet's
    NVLink figure for a card) or ``"cpu-estimate"``."""
    dev = torch.device(device) if device is not None else torch.device(
        "cuda" if torch.cuda.is_available() else "cpu")
    if dev.type == "cuda":
        return LINK_BANDWIDTH["gpu"], "table"
    return CPU_LINK_BANDWIDTH_ESTIMATE, "cpu-estimate"


def ring_wire_bytes(op: str, payload_bytes: float,
                    group_size: Optional[int]) -> float:
    """Bytes through each device's link for one collective, ring
    algorithm: all-reduce ``2(g-1)/g`` of the payload, all-gather and
    reduce-scatter half that, a permute or all-to-all the payload."""
    g = group_size or 0
    if g < 2:
        return float(payload_bytes)
    if op == "all-reduce":
        return 2.0 * (g - 1) / g * payload_bytes
    if op in ("all-gather", "reduce-scatter"):
        return (g - 1) / g * payload_bytes
    return float(payload_bytes)


def attribute_mesh_axes(census: Dict[str, Dict[str, Any]],
                        axis_sizes: Dict[str, int]) -> Dict[str, List[str]]:
    """An op whose group size equals the size of exactly one mesh axis is
    attributed to that axis."""
    out: Dict[str, List[str]] = {}
    for op, entry in census.items():
        axes: List[str] = []
        for g in entry.get("group_sizes", ()):
            named = [a for a, s in axis_sizes.items() if s == g]
            if len(named) == 1 and named[0] not in axes:
                axes.append(named[0])
        out[op] = axes
    return out


# ----------------------------------------------------------- program census
_prog_lock = threading.Lock()
_programs: Dict[str, Dict[Any, Dict[str, Any]]] = {}


def record_program(fn: str, signature, census: Dict[str, Dict[str, Any]],
                   *, pool_bytes: Optional[int] = None, device=None,
                   registry=None) -> Dict[str, Any]:
    """Keep one program's census (``backend.mesh.census`` of one run of
    its body) and graph-pool bytes under ``fn`` and its signature, and
    mirror them into the collective and program-memory families."""
    from deeplearning4j_tpu_torch.observability.metrics import get_registry

    bw, source = link_bandwidth_for(device)
    wire = sum(ring_wire_bytes(op, e["bytes"] / max(e["count"], 1),
                               max(e["group_sizes"] or [0])) * e["count"]
               for op, e in census.items())
    entry = {
        "collectives": {op: dict(e) for op, e in census.items()},
        "collective_bytes": float(sum(e["bytes"] for e in census.values())),
        "collective_count": int(sum(e["count"] for e in census.values())),
        "wire_bytes_estimate": float(wire),
        "comm_seconds_estimate": float(wire / bw) if bw else None,
        "link_bandwidth": bw, "link_source": source,
        "one_device": True,
    }
    # a mesh that spans processes: each collective's cross-process half
    # (backend.mesh.process_all_gather), beside the slot bytes above
    crossed = {k: sum(e.get(k, 0) for e in census.values())
               for k in ("process_count", "process_bytes",
                         "process_seconds")}
    if crossed["process_count"]:
        entry.update(crossed)
        entry["one_device"] = False
    if pool_bytes is not None:
        entry["memory"] = {"graph_pool": int(pool_bytes)}
    with _prog_lock:
        sigs = _programs.setdefault(str(fn), {})
        sigs.pop(signature, None)    # the latest recorded comes last
        sigs[signature] = entry
    reg = registry if registry is not None else get_registry()
    b = reg.counter(_COLL_BYTES, "Collective payload bytes of a slot "
                    "program's census, per function and op (recorded once "
                    "a signature: on one card a census, not link traffic)",
                    labels=("fn", "op"))
    c = reg.counter(_COLL_TOTAL, "Collectives of a slot program's census, "
                    "per function and op", labels=("fn", "op"))
    for op, e in census.items():
        b.inc(e["bytes"], fn=fn, op=op)
        c.inc(e["count"], fn=fn, op=op)
    if pool_bytes is not None:
        reg.gauge(_PROGRAM_MEMORY, "Bytes a captured program's graph pool "
                  "took at its capture", labels=("fn", "kind")).set(
            pool_bytes, fn=fn, kind="graph_pool")
    return entry


def program_analysis(fn: str, signature=None) -> Dict[str, Any]:
    """The census of ``fn``'s program at ``signature`` (default: the
    latest recorded), or ``{}``."""
    with _prog_lock:
        sigs = _programs.get(str(fn)) or {}
        if not sigs:
            return {}
        if signature is None:
            return dict(list(sigs.values())[-1])
        return dict(sigs.get(signature) or {})


def latest_programs() -> Dict[str, Dict[str, Any]]:
    """The latest census of every function (``GET /memory``'s
    ``programs``)."""
    with _prog_lock:
        return {fn: dict(list(s.values())[-1])
                for fn, s in _programs.items() if s}


# ------------------------------------------------------------------ ledger
# The updater-state subtrees ZeRO keeps replicated (stacked per replica in
# the wrapper): the stability guard's scalars, the introspection and the
# numerics vectors (``updaters.RESERVED_KEYS``).
RESERVED_REPLICATED_SUBTREES = ("__stability__", "__introspect__",
                                "__numerics__")


def zero_shardable(shape, k: int) -> bool:
    """Whether a leaf of ``shape`` takes part in ZeRO over a ``k``-way
    data axis: its leading dimension exists and divides evenly.  The one
    owner of the predicate: the ledger's projection and
    ``parallel.zero``'s layout both call it."""
    shape = tuple(shape)
    return (k > 1 and len(shape) >= 1 and shape[0] > 0
            and shape[0] % k == 0)


def _items(tree, top=None):
    """(top-level key, leaf) of a nested-dict tree."""
    if isinstance(tree, dict):
        for key, v in tree.items():
            yield from _items(v, key if top is None else top)
    elif tree is not None:
        yield top, tree


def _leaf_accounting(leaf) -> Optional[Dict[str, Any]]:
    """Shape and dtype metadata of one leaf; None for non-arrays."""
    if isinstance(leaf, Sharded):
        itemsize = leaf.local.element_size()
        glob = math.prod(leaf.shape) * itemsize
        per = leaf.slot_bytes()
        n = leaf.mesh.size
        return {"global": glob, "per_device": per, "devices": n,
                "stored": per * n}
    shape = getattr(leaf, "shape", None)
    dtype = getattr(leaf, "dtype", None)
    if shape is None or dtype is None:
        return None
    if torch.is_tensor(leaf):
        itemsize = leaf.element_size()
    else:
        try:
            itemsize = np.dtype(dtype).itemsize
        except TypeError:
            return None
    glob = int(math.prod(tuple(shape)) * itemsize)
    return {"global": glob, "per_device": glob, "devices": 1,
            "stored": glob}


def _projected_zero_bytes(tree, k: int, reserved: bool = False) -> int:
    total = 0
    for top, leaf in _items(tree):
        acc = _leaf_accounting(leaf)
        if acc is None:
            continue
        shape = leaf.shape
        if (reserved or top in RESERVED_REPLICATED_SUBTREES
                or not zero_shardable(shape, k)):
            total += acc["global"]
        else:
            total += -(-acc["global"] // k)
    return total


def _tree_row(tree, logical_tree=None, data_axis_size: Optional[int] = None,
              reserved: bool = False) -> Dict[str, Any]:
    """One ledger row (reference ``_tree_row``): ``logical_tree`` is the
    single-model tree when ``tree`` is a stacked replica view."""
    glob = per_dev = stored = 0
    ndev = 1
    for _top, leaf in _items(tree):
        acc = _leaf_accounting(leaf)
        if acc is None:
            continue
        glob += acc["global"]
        per_dev += acc["per_device"]
        stored += acc["stored"]
        ndev = max(ndev, acc["devices"])
    logical = glob
    if logical_tree is not None:
        logical = sum(a["global"] for _t, leaf in _items(logical_tree)
                      if (a := _leaf_accounting(leaf)) is not None)
    row: Dict[str, Any] = {
        "logical_bytes": logical, "global_bytes": glob,
        "per_device_bytes": per_dev, "stored_bytes": stored,
        "devices": ndev,
        "replication_factor": (round(stored / logical, 4) if logical
                               else 1.0),
    }
    k = data_axis_size or ndev
    if logical and k > 1:
        projected = _projected_zero_bytes(
            logical_tree if logical_tree is not None else tree, k,
            reserved=reserved)
        row["zero_projected_per_device_bytes"] = projected
        row["zero_savings_per_device_bytes"] = per_dev - projected
    return row


def sharding_ledger(trees: Dict[str, Any],
                    logical_trees: Optional[Dict[str, Any]] = None,
                    data_axis_size: Optional[int] = None,
                    subtree_depth: int = 1) -> Dict[str, Any]:
    """The ledger over named trees: a row a tree and one for each of its
    top-level subtrees (layer or updater slot)."""
    logical_trees = logical_trees or {}
    out: Dict[str, Any] = {"trees": {}, "data_axis_size": data_axis_size}
    total = {"logical_bytes": 0, "per_device_bytes": 0, "stored_bytes": 0}
    for name, tree in trees.items():
        if tree is None:
            continue
        logical = logical_trees.get(name)
        row = _tree_row(tree, logical, data_axis_size)
        if subtree_depth > 0 and isinstance(tree, dict):
            subs = {}
            for key, sub in tree.items():
                sub_logical = (logical.get(key)
                               if isinstance(logical, dict) else None)
                subs[str(key)] = _tree_row(
                    sub, sub_logical, data_axis_size,
                    reserved=key in RESERVED_REPLICATED_SUBTREES)
            if subs:
                row["subtrees"] = subs
        out["trees"][name] = row
        for f in total:
            total[f] += row[f]
    total["replication_factor"] = (
        round(total["stored_bytes"] / total["logical_bytes"], 4)
        if total["logical_bytes"] else 1.0)
    out["total"] = total
    return out


def format_ledger(ledger: Dict[str, Any], component: str = "") -> str:
    """The human-readable ledger (the reference's layout)."""
    def mb(b):
        return f"{b / 1e6:10.3f}"

    lines = [f"sharding ledger{' — ' + component if component else ''}"
             + (f" (data axis: {ledger.get('data_axis_size')})"
                if ledger.get("data_axis_size") else ""),
             f"{'tree':<28} {'logical MB':>10} {'per-dev MB':>10} "
             f"{'repl':>6} {'ZeRO MB':>10}"]

    def line(name, row):
        zero = row.get("zero_projected_per_device_bytes")
        return (f"{name} {mb(row['logical_bytes'])} "
                f"{mb(row['per_device_bytes'])} "
                f"{row['replication_factor']:>6.2f} "
                f"{mb(zero) if zero is not None else '        —'}")

    for name, row in ledger.get("trees", {}).items():
        lines.append(line(f"{name:<28}", row))
        for sub, srow in (row.get("subtrees") or {}).items():
            lines.append(line(f"  {sub:<26}", srow))
    t = ledger.get("total")
    if t:
        lines.append(
            f"{'TOTAL':<28} {mb(t['logical_bytes'])} "
            f"{mb(t['per_device_bytes'])} {t['replication_factor']:>6.2f}")
    return "\n".join(lines)


_ledger_lock = threading.Lock()
_ledgers: Dict[str, Dict[str, Any]] = {}


def record_ledger(component: str, trees: Dict[str, Any],
                  logical_trees: Optional[Dict[str, Any]] = None,
                  data_axis_size: Optional[int] = None, registry=None,
                  notes: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Compute the ledger, mirror its rows into the gauges, keep it for
    ``latest_ledgers()`` (flight reports, ``GET /memory``) and record a
    ``sharding_ledger`` flight event.  Metadata only, at fit entry.
    Best-effort, as the reference's: a failure logs and returns ``{}``."""
    try:
        return _record_ledger(component, trees, logical_trees,
                              data_axis_size, registry, notes)
    except Exception:
        logging.getLogger("deeplearning4j_tpu_torch.observability").debug(
            "sharding ledger for %s failed", component, exc_info=True)
        return {}


def _record_ledger(component, trees, logical_trees, data_axis_size,
                   registry, notes=None) -> Dict[str, Any]:
    from deeplearning4j_tpu_torch.observability.flightrecorder import (
        get_flight_recorder,
    )
    from deeplearning4j_tpu_torch.observability.metrics import get_registry

    ledger = sharding_ledger(trees, logical_trees, data_axis_size)
    ledger["component"] = str(component)
    if notes:
        ledger["notes"] = dict(notes)
    reg = registry if registry is not None else get_registry()
    g_bytes = reg.gauge(
        _SHARDED_BYTES, "Per-slot bytes of a tracked tree under its "
        "layout over the slot mesh (ledger row)",
        labels=("component", "tree"))
    g_repl = reg.gauge(
        _REPLICATION, "Replication factor of a tracked tree: bytes stored "
        "over all slots / bytes of one logical copy (K for K-replica "
        "data parallelism, about 1 under update_sharding='zero')",
        labels=("component", "tree"))
    for name, row in ledger["trees"].items():
        g_bytes.set(row["per_device_bytes"], component=component, tree=name)
        g_repl.set(row["replication_factor"], component=component,
                   tree=name)
    with _ledger_lock:
        _ledgers[str(component)] = ledger
    get_flight_recorder().record(
        "sharding_ledger", component=component,
        data_axis_size=data_axis_size,
        total_per_device_bytes=ledger["total"]["per_device_bytes"],
        replication_factor=ledger["total"]["replication_factor"])
    return ledger


def latest_ledgers() -> Dict[str, Dict[str, Any]]:
    """The newest ledger per component."""
    with _ledger_lock:
        return dict(_ledgers)


def clear_ledgers() -> None:
    """Test isolation: the ledgers and the program censuses."""
    with _ledger_lock:
        _ledgers.clear()
    with _prog_lock:
        _programs.clear()
