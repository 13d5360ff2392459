"""Checkpoint directories — the port's counterpart of
``deeplearning4j_tpu/parallel/checkpoint.py``.

The files keep the reference's layout (``format_version`` 1): one
``shards-<process>.npz`` holding every saved piece under
``"p<proc>/<path>@<i>"``, one ``manifest-<process>.json`` recording each
leaf's global shape, dtype, ``PartitionSpec`` and the slices its pieces
cover (and the saving mesh's axis names and shape), and
``checkpoint.json`` with the iteration.  So a step directory the JAX
package wrote restores here, and one written here restores there.  Leaf
paths are the trees' keys joined by ``/`` under ``params/``,
``updater_state/`` and ``net_state/``.

The key stream: a threefry key means nothing in torch, so the port
records its own stream's position under ``torch_key_state`` (the root
generator's state, base64) beside the reference's ``rng_key``; a
restore sets it, and a JAX checkpoint's ``rng_key`` is left unread.

Save is two halves, as in the reference: ``snapshot_trees`` copies every
leaf to host memory on the training thread (the port's step writes its
tensors in place, so a snapshot that held them would be overwritten by
the next step), and ``write_snapshot`` writes the host copy, safe off
that thread.  ``restore_checkpoint`` with a net writes the saved values
INTO the net's existing tensors (a captured step graph holds their
addresses and replays on the restored values); only a leaf the net
lacks, or one of another shape, is placed as a new tensor, and a leaf
the checkpoint lacks is dropped — either replaces the tree, and the
net's captured programs are then captured again (``models/capture.py``).

**Sharded leaves** (``backend.mesh.Sharded``: a ZeRO wrapper's
``state_trees()``, a restored mesh tree) are saved piece by piece, each
distinct slot block once, with their spec.  With ``mesh=`` a restore
places every leaf on that slot mesh with its saved spec fitted to it
(``fit_spec``: an axis the target lacks, or one that no longer divides,
degrades to replication) and never assembles a whole leaf on the host:
each target block is put together from the saved pieces it intersects,
each npz member read once (reference ``:299-481``).  Where the saver had
as many slots as the target and the fitted spec differs, the saved
pieces load in the saved layout and one device-side reshard
(``_reshard_on_device``) lays them out.  With a net and a mesh the
values go into the net's tensors.  A directory the JAX package wrote
from any mesh restores onto any slot mesh, and the reverse.
"""

from __future__ import annotations

import base64
import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

MANIFEST = "manifest-{proc}.json"
SHARDS = "shards-{proc}.npz"
META = "checkpoint.json"
KEY_STATE = "torch_key_state"


# --------------------------------------------------------------- tree <-> flat
def _flatten(tree, prefix=""):
    """Flatten nested dicts to {path: leaf}; path segments joined by '/'."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        p = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, p + "/"))
        else:
            out[p] = v
    return out


def _unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path, v in flat.items():
        cur = out
        keys = path.split("/")
        for k in keys[:-1]:
            cur = cur.setdefault(k, {})
        cur[keys[-1]] = v
    return out


def _spec_to_json(spec) -> list:
    out = []
    for e in tuple(spec):
        if e is None:
            out.append(None)
        elif isinstance(e, (tuple, list)):
            out.append(list(e))
        else:
            out.append(str(e))
    return out


def _np_dtype(leaf) -> str:
    """The numpy type a leaf is saved in (bfloat16 widened to float32)."""
    if torch.is_tensor(leaf):
        dt = torch.float32 if leaf.dtype == torch.bfloat16 else leaf.dtype
        return str(torch.empty((), dtype=dt).numpy().dtype)
    return str(np.asarray(leaf).dtype)


def _host(leaf) -> np.ndarray:
    """A leaf copied to host memory (``.cpu()`` waits for the copy;
    bfloat16, which numpy lacks, is widened to float32)."""
    if torch.is_tensor(leaf):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


# ------------------------------------------------------------------------ save
def snapshot_trees(net, *, trees: Optional[Dict[str, Any]] = None,
                   mesh=None) -> Dict[str, Any]:
    """Host-side snapshot of the facade's params / updater state / net
    state (or explicit ``trees``, whose leaves may be ``Sharded``) plus
    the iteration and the key stream's position: the device-to-host
    half of a save, run on the training thread at a step boundary.  A
    ``Sharded`` leaf is saved a distinct block at a time with its spec;
    ``mesh`` (the slot mesh of the save) is recorded in the manifest and
    must be every sharded leaf's.  What it returns is plain host data,
    safe to hand to a writer thread.

    On a ``mesh`` that spans processes (``backend/mesh.py``) each
    process snapshots the blocks of its own slots, a block every process
    holds (a replicated leaf) only process 0, under process-qualified
    keys, and only process 0 the meta, with ``"processes"`` the group's
    size: the reference's multi-process layout."""
    from deeplearning4j_tpu_torch.backend.mesh import Sharded

    xp = mesh is not None and mesh.spans_processes
    proc = mesh.process_index if xp else 0
    trees = trees if trees is not None else {
        "params": net.params,
        "updater_state": net.updater_state,
        "net_state": net.net_state,
    }
    manifest: Dict[str, Any] = {"leaves": {}}
    arrays: Dict[str, np.ndarray] = {}
    if mesh is not None:
        manifest["mesh"] = {"axis_names": list(mesh.axis_names),
                            "shape": [int(mesh.shape[a])
                                      for a in mesh.axis_names]}
    for tname, tree in trees.items():
        for path, leaf in _flatten(tree, f"{tname}/").items():
            if isinstance(leaf, Sharded):
                if mesh is not None and leaf.mesh.shape != mesh.shape:
                    raise ValueError(
                        f"{path} is laid over {leaf.mesh.shape}, the save's "
                        f"mesh is {mesh.shape}")
                manifest.setdefault("mesh", {
                    "axis_names": list(leaf.mesh.axis_names),
                    "shape": [int(leaf.mesh.shape[a])
                              for a in leaf.mesh.axis_names]})
                entry = {"shape": list(leaf.shape),
                         "dtype": _np_dtype(leaf.local),
                         "spec": _spec_to_json(leaf.spec), "shards": []}
                for i, (ranges, block) in enumerate(leaf.blocks()):
                    owner = leaf.owner(ranges)
                    if (owner if owner is not None else 0) != proc:
                        continue
                    key = f"p{proc}/{path}@{i}"
                    arrays[key] = _host(block)
                    entry["shards"].append(
                        {"key": key, "index": [list(r) for r in ranges]})
                manifest["leaves"][path] = entry
                continue
            shape = list(np.shape(leaf))
            entry = {"shape": shape, "dtype": _np_dtype(leaf), "spec": [],
                     "shards": []}
            if proc == 0:
                # a leaf every process holds: process 0's copy
                key = f"p{proc}/{path}@0"
                arrays[key] = _host(leaf)
                entry["shards"].append(
                    {"key": key, "index": [[0, d] for d in shape]})
            manifest["leaves"][path] = entry
    iteration = int(getattr(net, "iteration", 0))
    meta = None
    if proc == 0:
        meta = {"format_version": 1, "iteration": iteration,
                "processes": mesh.process_count if xp else 1}
        keys = getattr(net, "_keys", None)
        if keys is not None:
            meta[KEY_STATE] = base64.b64encode(
                keys.get_state().numpy().tobytes()).decode("ascii")
    return {"proc": proc, "manifest": manifest, "arrays": arrays,
            "meta": meta, "iteration": iteration}


def write_snapshot(directory: str, snapshot: Dict[str, Any], *,
                   fsync: bool = False, on_file=None) -> int:
    """File half of a save: write a ``snapshot_trees`` result into
    ``directory`` (shards first, then manifest, then meta — the order a
    torn write is cheapest to detect in).  Pure host IO, safe off the
    training thread.  ``on_file(path)`` fires after each file lands
    (the ``FaultInjector`` crash-mid-save hook); with ``fsync`` every file
    is flushed to disk before the call returns — the atomic-commit rename
    in ``resilience.CheckpointManager`` relies on that ordering.  Returns
    the bytes written."""
    os.makedirs(directory, exist_ok=True)
    proc = snapshot["proc"]
    total = 0

    def _land(path, write_fn, mode):
        nonlocal total
        with open(path, mode) as f:
            write_fn(f)
            if fsync:
                f.flush()
                os.fsync(f.fileno())
        total += os.path.getsize(path)
        if on_file is not None:
            on_file(path)

    _land(os.path.join(directory, SHARDS.format(proc=proc)),
          lambda f: np.savez(f, **snapshot["arrays"]), "wb")
    _land(os.path.join(directory, MANIFEST.format(proc=proc)),
          lambda f: json.dump(snapshot["manifest"], f), "w")
    if snapshot["meta"] is not None:
        _land(os.path.join(directory, META),
              lambda f: json.dump(snapshot["meta"], f), "w")
    return total


def save_checkpoint(directory: str, net, *,
                    trees: Optional[Dict[str, Any]] = None,
                    mesh=None) -> None:
    """Write the facade's trees (or ``trees``, ``Sharded`` leaves saved
    piece by piece over ``mesh``) plus iteration and key stream straight
    into ``directory``.  A crash mid-save leaves a torn checkpoint there;
    production runs save through ``resilience.CheckpointManager``, which
    stages the same files in ``step-N.tmp/`` and commits them
    atomically.  On a mesh that spans processes every process calls it:
    each writes its shards and manifest, and after a barrier process 0
    writes the meta, so a reader that finds ``checkpoint.json`` finds
    every process's files."""
    from deeplearning4j_tpu_torch.backend.mesh import process_barrier

    snapshot = snapshot_trees(net, trees=trees, mesh=mesh)
    write_snapshot(directory, {**snapshot, "meta": None})
    if mesh is not None and mesh.spans_processes:
        process_barrier()
    if snapshot["meta"] is not None:
        with open(os.path.join(directory, META), "w") as f:
            json.dump(snapshot["meta"], f)
    from deeplearning4j_tpu_torch.observability import get_flight_recorder

    get_flight_recorder().record(
        "checkpoint", directory=str(directory), process=snapshot["proc"],
        iteration=snapshot["iteration"])


# --------------------------------------------------------------------- restore
def _saved_shards(entry, shard_files):
    """Every saved piece of a leaf present in the loaded npz files, as
    ``(ranges, npz, key)`` with ``ranges`` the global [start, stop) per
    dim."""
    out = []
    for s in entry["shards"]:
        for npz in shard_files:
            if s["key"] in npz:
                out.append((tuple((int(a), int(b)) for a, b in s["index"]),
                            npz, s["key"]))
                break
    return out


def _assemble_slice(entry, shard_files, ranges, member_cache=None
                    ) -> np.ndarray:
    """One hyperrectangle ``ranges`` of a leaf from the saved pieces that
    intersect it: the host holds the slice, never the whole leaf.
    ``member_cache`` (one dict a leaf) keeps the last npz member loaded,
    so target blocks visited in order read each member once."""
    def load(npz, key):
        if member_cache is None:
            return npz[key]
        ck = (id(npz), key)
        if member_cache.get("key") != ck:
            member_cache["key"] = ck
            member_cache["val"] = npz[key]
        return member_cache["val"]

    dtype = np.dtype(entry["dtype"])
    pieces = _saved_shards(entry, shard_files)
    if not entry["shape"]:
        for _rg, npz, key in pieces:
            return np.asarray(load(npz, key)).astype(dtype)
        raise ValueError(
            f"checkpoint incomplete: leaf {entry} missing shard data "
            f"(multi-host checkpoint restored without shared storage?)")
    shape = tuple(b - a for a, b in ranges)
    out = np.zeros(shape, dtype)
    filled = np.zeros(shape, bool)
    for rg, npz, key in pieces:
        inter = [(max(a, c), min(b, d)) for (a, b), (c, d) in zip(ranges, rg)]
        if any(lo >= hi for lo, hi in inter):
            continue
        dst = tuple(slice(lo - a, hi - a)
                    for (lo, hi), (a, _b) in zip(inter, ranges))
        src = tuple(slice(lo - c, hi - c)
                    for (lo, hi), (c, _d) in zip(inter, rg))
        out[dst] = load(npz, key)[src]
        filled[dst] = True
    if not bool(filled.all()):
        raise ValueError(
            f"checkpoint incomplete: leaf {entry} missing shard data "
            f"(multi-host checkpoint restored without shared storage?)")
    return out


def _build_sharded(entry, shard_files, mesh, spec):
    """A leaf laid over ``mesh`` by ``spec``, each distinct block
    assembled from the pieces it intersects and moved to the device."""
    from deeplearning4j_tpu_torch.backend.mesh import Sharded

    shape = tuple(int(d) for d in entry["shape"])
    probe = Sharded(torch.empty(0), spec, mesh, shape)
    cache: Dict[str, Any] = {}
    blocks = []
    ks = probe.splits()
    bs = probe.block_shape
    lead = [d for d, k in enumerate(ks) if k > 1]
    for idx in np.ndindex(*[ks[d] for d in lead]):
        pos = dict(zip(lead, idx))
        ranges = tuple((pos.get(d, 0) * b, (pos.get(d, 0) + 1) * b)
                       for d, b in enumerate(bs))
        blocks.append(torch.from_numpy(np.ascontiguousarray(
            _assemble_slice(entry, shard_files, ranges, cache))).to(
                mesh.device))
    local = torch.stack(blocks).reshape([ks[d] for d in lead] + list(bs)) \
        if lead else blocks[0]
    return Sharded(local, spec, mesh, shape)


def _source_mesh(man_mesh, mesh):
    """The saver's slot layout over the target's device when the two
    have as many slots, else None."""
    from deeplearning4j_tpu_torch.backend.mesh import Mesh

    if not man_mesh:
        return None
    shape = tuple(int(s) for s in man_mesh.get("shape", ()))
    if not shape or int(np.prod(shape)) != mesh.size:
        return None
    return Mesh(np.full(shape, mesh.device, dtype=object),
                tuple(man_mesh["axis_names"]))


def _reshard_on_device(src, spec, mesh):
    """A leaf loaded in the saved layout laid out by ``spec`` on the
    target mesh, on the device (the host never sees the whole leaf)."""
    from deeplearning4j_tpu_torch.backend.mesh import Sharded

    return Sharded.from_full(src.full(), spec, mesh)


def _place_leaf(entry, shard_files, mesh, man_mesh=None):
    """One leaf onto ``mesh`` without a whole-leaf host assembly."""
    from deeplearning4j_tpu_torch.backend.mesh import P, fit_spec

    shape = tuple(int(d) for d in entry["shape"])
    saved = P(*[tuple(e) if isinstance(e, list) else e
                for e in entry["spec"]])
    target = fit_spec(saved, mesh, shape)
    src_mesh = _source_mesh(man_mesh, mesh)
    if src_mesh is not None and shape:
        from deeplearning4j_tpu_torch.backend.mesh import Sharded

        src_spec = fit_spec(saved, src_mesh, shape)

        def splits(spec, m):
            return Sharded(torch.empty(0), spec, m, shape).splits()

        if tuple(src_spec) == tuple(saved) and (
                splits(src_spec, src_mesh) != splits(target, mesh)):
            loaded = _build_sharded(entry, shard_files, src_mesh, src_spec)
            return _reshard_on_device(loaded, target, mesh)
    return _build_sharded(entry, shard_files, mesh, target)


def _assemble(entry, shard_files) -> np.ndarray:
    """A whole leaf from the saved pieces that cover it: the explicit
    gather-to-host path (no mesh); the resharded restore never calls
    it."""
    return _assemble_slice(entry, shard_files,
                           tuple((0, int(d)) for d in entry["shape"]))


def _write_into(live, saved: Dict[str, Any], device):
    """``saved`` (nested dicts of numpy arrays) as the new tree: every
    leaf that ``live`` holds at the same path and shape is written into
    that tensor in place (its dtype kept); any other leaf becomes a new
    tensor on ``device``."""
    out = {}
    for k, v in saved.items():
        cur = live.get(k) if isinstance(live, dict) else None
        if isinstance(v, dict):
            out[k] = _write_into(cur if isinstance(cur, dict) else {}, v,
                                 device)
            continue
        src = (v.detach() if torch.is_tensor(v)
               else torch.from_numpy(np.array(v, order="C")))
        if torch.is_tensor(cur) and tuple(cur.shape) == tuple(src.shape):
            with torch.no_grad():
                cur.copy_(src)
            out[k] = cur
        else:
            out[k] = src.to(device)
    for k, v in (live.items() if isinstance(live, dict) else ()):
        # a subtree without leaves (a layer with no params) has nothing
        # saved: it stays, so the tree keeps every layer
        if k not in out and isinstance(v, dict) and not _flatten(v):
            out[k] = v
    return out


def read_checkpoint(directory: str, mesh=None
                    ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(every leaf as nested dicts under ``params``, ``updater_state``
    and ``net_state``, the meta) of a step directory: numpy arrays, or
    with ``mesh`` ``Sharded`` leaves on that slot mesh."""
    manifests = []
    shard_files = []
    for fn in sorted(os.listdir(directory)):
        if fn.startswith("manifest-"):
            with open(os.path.join(directory, fn)) as f:
                manifests.append(json.load(f))
        elif fn.startswith("shards-"):
            shard_files.append(np.load(os.path.join(directory, fn)))
    if not manifests:
        raise FileNotFoundError(f"no checkpoint manifests in {directory}")
    merged: Dict[str, Any] = {}
    for man in manifests:
        for path, entry in man["leaves"].items():
            if path not in merged:
                merged[path] = {k: entry[k] for k in ("shape", "dtype",
                                                      "spec")}
                merged[path]["shards"] = list(entry["shards"])
            else:
                have = {s["key"] for s in merged[path]["shards"]}
                merged[path]["shards"] += [s for s in entry["shards"]
                                           if s["key"] not in have]
    man_mesh = next((m["mesh"] for m in manifests if m.get("mesh")), None)
    try:
        leaves = {path: (_place_leaf(entry, shard_files, mesh, man_mesh)
                         if mesh is not None
                         else _assemble(entry, shard_files))
                  for path, entry in merged.items()}
    finally:
        for npz in shard_files:
            npz.close()
    with open(os.path.join(directory, META)) as f:
        meta = json.load(f)
    return _unflatten(leaves), meta


def _whole(tree, sharded_type):
    """``Sharded`` leaves put back together on their device."""
    if isinstance(tree, dict):
        return {k: _whole(v, sharded_type) for k, v in tree.items()}
    return tree.full() if isinstance(tree, sharded_type) else tree


def restore_checkpoint(directory: str, net=None, *, mesh=None):
    """(params, updater_state, net_state, iteration) of a step directory.
    With ``net`` given, restores in place: the values written into its
    existing tensors (module docstring), the iteration and the key
    stream's position set; the returned trees are then the net's.
    Without a net the trees hold numpy arrays, or with ``mesh`` leaves
    laid over that slot mesh (``Sharded``), resharded from whatever mesh
    saved them."""
    full, meta = read_checkpoint(directory, mesh)
    if mesh is not None and net is not None:
        from deeplearning4j_tpu_torch.backend.mesh import Sharded

        full = {k: _whole(v, Sharded) for k, v in full.items()}
    params = full.get("params", {})
    upd = full.get("updater_state", {})
    ns = full.get("net_state", {})
    iteration = int(meta.get("iteration", 0))
    if net is not None:
        dev = net.device
        net.params = _write_into(net.params, params, dev)
        net.updater_state = _write_into(net.updater_state, upd, dev)
        net.net_state = _write_into(net.net_state, ns, dev)
        net.iteration = iteration
        keys = getattr(net, "_keys", None)
        if KEY_STATE in meta and keys is not None:
            keys.set_state(torch.from_numpy(np.frombuffer(
                base64.b64decode(meta[KEY_STATE]), np.uint8).copy()))
        params, upd, ns = net.params, net.updater_state, net.net_state
    return params, upd, ns, iteration
