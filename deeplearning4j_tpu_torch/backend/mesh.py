"""Slot meshes — the port's counterpart of the mesh functions of
``deeplearning4j_tpu/backend/device.py`` (``default_mesh``,
``slice_mesh``, ``replicated``, ``data_sharded``) and of the collectives
the reference's masters call inside ``shard_map``.

The reference lays a ``jax.sharding.Mesh`` over devices: on the CPU tier
eight virtual devices (``tests/conftest.py``), on a TPU slice the chips.
The port's mesh is an array of **slots** in one process.  Each slot names
a ``torch.device``, and slots may share one: on the card
``default_mesh(data=4, devices=["cuda"] * 4)`` is four slots of
``cuda:0``, in the tests four slots of the CPU.  A tensor sharded over
an axis of slots carries that axis as a leading dimension (a replica
stack ``[K, ...]``, a ZeRO leaf ``[K, n/K, ...]``, a sequence shard
``[S, B, T/S, ...]``), and a collective over slots is a tensor operation
on that dimension (``psum``, ``pmean``, ``all_gather``, ``psum_scatter``,
``all_to_all``, ``ppermute``), run inside the captured step.  Each one
adds its op, payload bytes and group size to the process's collective
census (``census``), which ``observability.shardstats`` reads per
program.

A mesh whose slots span several devices or processes raises
``NotImplementedError`` (ROADMAP A10, meshes across processes and
GPUs).  It is never folded onto one device.

``Sharded`` is a leaf laid over a mesh by a ``PartitionSpec`` (``P``):
what the sharded checkpoint saves piece by piece and the sharding ledger
reads.  It holds the slot blocks stacked, ``[s_0, ..., s_k, *block]``
over the sharded dimensions in order, one block per distinct piece (the
copies along unsharded axes are the same tensor).
"""

from __future__ import annotations

import math
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.backend.device import resolve_device

AXIS_DATA = "data"
AXIS_MODEL = "model"
AXIS_SEQ = "seq"
AXES = (AXIS_DATA, AXIS_MODEL, AXIS_SEQ)

_ACROSS = ("a mesh across several devices or processes is not ported yet "
           "(ROADMAP A10, meshes across processes and GPUs, with "
           "initialize_distributed and A12's provision/cluster.py)")


class P(tuple):
    """A ``PartitionSpec``: per tensor dimension, None, a mesh axis name
    or a tuple of them."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"P{tuple(self)!r}"



class Mesh:
    """Named axes over an array of slots (``devices``: an object array of
    ``torch.device``, one per slot).  ``shape`` maps axis name to size,
    as the reference's ``Mesh.shape``."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.empty(np.shape(devices), dtype=object)
        flat = [torch.device(d) for d in np.asarray(devices,
                                                    dtype=object).reshape(-1)]
        for i, d in enumerate(flat):
            arr.reshape(-1)[i] = d
        if arr.ndim != len(axis_names):
            raise ValueError(f"{arr.ndim}-d slot array for axes "
                             f"{tuple(axis_names)}")
        if len({str(d) for d in flat}) > 1:
            raise NotImplementedError(
                f"slots on {sorted({str(d) for d in flat})}: " + _ACROSS)
        self.devices = arr
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, arr.shape))
        self.device = flat[0]

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_size(self, names) -> int:
        """Product of the sizes of ``names`` (None: 1)."""
        return math.prod(self.shape[n] for n in _names(names))

    def __repr__(self):
        return f"Mesh({self.shape}, device={self.device})"


def _names(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def local_devices() -> List[torch.device]:
    """The cards of this process, or the CPU where there is none."""
    if torch.cuda.is_available():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def device_count() -> int:
    return len(local_devices())


def default_mesh(n_devices: Optional[int] = None, *,
                 data: Optional[int] = None, model: int = 1, seq: int = 1,
                 devices: Optional[Sequence] = None) -> Mesh:
    """A slot mesh with axes ('data', 'model', 'seq') (reference
    ``default_mesh``: by default every slot goes to the data axis).
    ``devices`` names each slot's device (repeats allowed); without it
    the mesh has ``n_devices`` slots (default: ``data * model * seq``,
    else the card count) of the default device (``cuda``; raises without
    a GPU)."""
    if devices is None:
        n = n_devices or ((data * model * seq) if data else device_count())
        devices = [resolve_device(None)] * n
    else:
        devices = list(devices)[:n_devices] if n_devices else list(devices)
    n = len(devices)
    if data is None:
        if n % (model * seq) != 0:
            raise ValueError(
                f"{n} devices not divisible by model*seq={model * seq}")
        data = n // (model * seq)
    if data * model * seq != n:
        raise ValueError(f"mesh {data}x{model}x{seq} != {n} devices")
    arr = np.empty(n, dtype=object)
    for i, d in enumerate(devices):
        arr[i] = torch.device(d)
    return Mesh(arr.reshape(data, model, seq), AXES)


def slice_mesh(n_slices: Optional[int] = None, *, model: int = 1,
               seq: int = 1, devices: Optional[Sequence] = None) -> Mesh:
    """Multi-slice mesh (reference ``slice_mesh``): slots grouped
    slice-contiguously along the data axis, model/seq groups inside a
    slice."""
    if devices is None:
        devices = local_devices()
    ordered, per_slice = _group_by_slice(devices, n_slices)
    if per_slice % (model * seq) != 0:
        raise ValueError(
            f"model*seq={model * seq} must divide the {per_slice} "
            "devices of each slice (TP/SP collectives must stay on "
            "ICI — a model/seq group cannot straddle DCN)")
    return default_mesh(devices=ordered, model=model, seq=seq)


def _group_by_slice(devices: Sequence, n_slices: Optional[int]):
    """Order devices slice-contiguously; returns (ordered, per_slice).
    Devices that carry ``slice_index`` regroup by it; without it on every
    device they split into ``n_slices`` equal contiguous groups.  A mix
    raises: the reference put the devices without the attribute into a
    slice −1 of their own without a word."""
    has_attr = [getattr(d, "slice_index", None) for d in devices]
    if all(si is None for si in has_attr):
        k = n_slices or 1
        if len(devices) % k != 0:
            raise ValueError(
                f"{len(devices)} devices (no slice_index attribute — "
                f"virtual slicing) are not divisible into n_slices={k} "
                "equal groups")
        return list(devices), len(devices) // k
    missing = [i for i, si in enumerate(has_attr) if si is None]
    if missing:
        raise ValueError(
            f"devices {missing} have no slice_index while the others do: "
            "a device's slice cannot be guessed")
    groups: dict = {}
    for d, si in zip(devices, has_attr):
        groups.setdefault(si, []).append(d)
    if n_slices is not None and len(groups) != n_slices:
        raise ValueError(
            f"n_slices={n_slices} but the platform reports "
            f"{len(groups)} slice(s) (slice_index values: "
            f"{sorted(groups)})")
    sizes = {len(g) for g in groups.values()}
    if len(sizes) != 1:
        raise ValueError("unequal devices per slice: "
                         f"{[len(groups[s]) for s in sorted(groups)]}")
    ordered: list = []
    for si in sorted(groups):
        ordered.extend(groups[si])
    return ordered, sizes.pop()


class SlotSharding:
    """A mesh and a spec (the reference's ``NamedSharding``)."""

    def __init__(self, mesh: Mesh, spec: P):
        self.mesh, self.spec = mesh, P(*spec)

    def __repr__(self):
        return f"SlotSharding({self.mesh.shape}, {self.spec!r})"


def replicated(mesh: Mesh) -> SlotSharding:
    return SlotSharding(mesh, P())


def data_sharded(mesh: Mesh) -> SlotSharding:
    """Shard the leading (batch) dim over the data axis."""
    return SlotSharding(mesh, P(AXIS_DATA))


# ------------------------------------------------------------- sharded leaves
def fit_spec(spec, mesh: Mesh, shape) -> P:
    """``spec`` adapted to ``mesh`` and ``shape`` (reference ``_fit_spec``):
    a dimension keeps its axes only when each exists on the mesh and
    their product divides the dimension; otherwise it is replicated."""
    parts = []
    for d in range(len(shape)):
        e = spec[d] if d < len(spec) else None
        names = _names(e)
        if names and all(n in mesh.shape for n in names):
            sz = mesh.axis_size(names)
            if sz and shape[d] % sz == 0:
                parts.append(tuple(e) if isinstance(e, list) else e)
                continue
        parts.append(None)
    while parts and parts[-1] is None:
        parts.pop()
    return P(*parts)


class Sharded:
    """A leaf of global ``shape`` laid over ``mesh`` by ``spec``;
    ``local`` holds its distinct blocks stacked, ``[s_d for each sharded
    dim d] + block shape``."""

    def __init__(self, local: torch.Tensor, spec, mesh: Mesh, shape):
        self.local, self.spec, self.mesh = local, P(*spec), mesh
        self.shape = tuple(int(s) for s in shape)

    def splits(self) -> List[int]:
        """Pieces along each dimension."""
        return [self.mesh.axis_size(self.spec[d] if d < len(self.spec)
                                    else None)
                for d in range(len(self.shape))]

    @property
    def block_shape(self) -> Tuple[int, ...]:
        return tuple(s // k for s, k in zip(self.shape, self.splits()))

    @staticmethod
    def from_full(t: torch.Tensor, spec, mesh: Mesh) -> "Sharded":
        """``t`` laid out by ``spec`` (a copy of its blocks)."""
        spec = fit_spec(spec, mesh, t.shape)
        out = Sharded(t, spec, mesh, t.shape)
        ks = out.splits()
        shp, perm_lead, perm_blk = [], [], []
        for d, (s, k) in enumerate(zip(t.shape, ks)):
            shp += [k, s // k]
        lead = [2 * d for d, k in enumerate(ks) if k > 1]
        one = [2 * d for d, k in enumerate(ks) if k == 1]
        blk = [2 * d + 1 for d in range(len(ks))]
        x = t.reshape(shp).permute(lead + blk + one)
        out.local = x.reshape([ks[d // 2] for d in lead]
                              + list(out.block_shape)).contiguous()
        return out

    def full(self) -> torch.Tensor:
        """The global tensor (the blocks put back in place)."""
        ks = self.splits()
        lead = [k for k in ks if k > 1]
        x = self.local.reshape(lead + list(self.block_shape))
        n_lead = len(lead)
        order, li = [], 0
        for d, k in enumerate(ks):
            if k > 1:
                order += [li, n_lead + d]
                li += 1
            else:
                order += [n_lead + d]
        return x.permute(order).reshape(self.shape)

    def blocks(self) -> Iterable[Tuple[Tuple[Tuple[int, int], ...],
                                       torch.Tensor]]:
        """Every distinct block with its global [start, stop) per dim."""
        ks = self.splits()
        lead = [d for d, k in enumerate(ks) if k > 1]
        bs = self.block_shape
        x = self.local.reshape([ks[d] for d in lead] + list(bs))
        for idx in np.ndindex(*[ks[d] for d in lead]):
            pos = dict(zip(lead, idx))
            ranges = tuple((pos.get(d, 0) * b, (pos.get(d, 0) + 1) * b)
                           for d, b in enumerate(bs))
            yield ranges, x[idx] if idx else x

    def slot_bytes(self) -> int:
        """Bytes each slot holds: one block."""
        return math.prod(self.block_shape) * self.local.element_size()

    def __repr__(self):
        return (f"Sharded(shape={self.shape}, spec={self.spec!r}, "
                f"local={tuple(self.local.shape)})")


def replica_stack(t: torch.Tensor, mesh: Mesh, axis: str = AXIS_DATA
                  ) -> Sharded:
    """A ``[K, ...]`` replica stack as a leaf sharded over ``axis`` (each
    slot holds its replica), for the ledger and the checkpoint."""
    return Sharded(t, P(axis), mesh, t.shape)


# --------------------------------------------------------------- collectives
class _Census(threading.local):
    counts: Optional[Dict[str, Dict[str, float]]] = None


_census = _Census()
_lock = threading.Lock()
_totals: Dict[str, Dict[str, float]] = {}


def note(op: str, t: torch.Tensor, group: int) -> None:
    """Record one collective of ``op`` over ``group`` slots with ``t`` as
    its payload (for a collective computed as a view, without a call
    below)."""
    nbytes = float(t.numel() * t.element_size())
    with _lock:
        _add(_totals, op, 1, nbytes, [group])
    if _census.counts is not None:
        _add(_census.counts, op, 1, nbytes, [group])


def _add(book, op, count, nbytes, groups):
    e = book.setdefault(op, {"count": 0, "bytes": 0.0, "group_sizes": []})
    e["count"] += count
    e["bytes"] += nbytes
    for g in groups:
        if g not in e["group_sizes"]:
            e["group_sizes"].append(g)


class census:
    """Collect the collectives run inside the block (this thread):
    ``with census() as c: ...``; ``c.counts`` is {op: {count, bytes,
    group_sizes}}, the reference's HLO census form.  An enclosing census
    also receives them."""

    def __enter__(self):
        self._prev = _census.counts
        self.counts = _census.counts = {}
        return self

    def __exit__(self, *exc):
        _census.counts = self._prev
        if self._prev is not None:
            for op, e in self.counts.items():
                _add(self._prev, op, e["count"], e["bytes"],
                     e["group_sizes"])
        return False


def collective_totals() -> Dict[str, Dict[str, float]]:
    """Every collective this process ran (at capture on the card, on
    every call eagerly), by op."""
    with _lock:
        return {k: dict(v) for k, v in _totals.items()}


def psum(x: torch.Tensor, dim: int = 0, keepdim: bool = False):
    """Sum over the slot dimension ``dim`` (``lax.psum``)."""
    note("all-reduce", x, x.shape[dim])
    return x.sum(dim, keepdim=keepdim)


def pmean(x: torch.Tensor, dim: int = 0, keepdim: bool = False):
    note("all-reduce", x, x.shape[dim])
    return x.mean(dim, keepdim=keepdim)


def all_gather(x: torch.Tensor, tiled: bool = True) -> torch.Tensor:
    """Slot blocks ``[K, n/K, ...]`` -> the whole ``[n, ...]`` (tiled; a
    view) or every slot's copy of the stack (``tiled=False``: the stack
    itself, which each slot reads)."""
    note("all-gather", x, x.shape[0])
    return x.reshape((-1,) + tuple(x.shape[2:])) if tiled else x


def psum_scatter(x: torch.Tensor) -> torch.Tensor:
    """Per-slot contributions ``[K, n, ...]`` -> summed slot blocks
    ``[K, n/K, ...]`` (``lax.psum_scatter``, tiled)."""
    k = x.shape[0]
    note("reduce-scatter", x, k)
    s = x.sum(0)
    return s.reshape((k, s.shape[0] // k) + tuple(s.shape[1:]))


def all_to_all(x: torch.Tensor, split_dim: int, concat_dim: int
               ) -> torch.Tensor:
    """``[K, ...]`` slot stack: each slot splits ``split_dim`` (of its
    block, so ``x``'s dim ``split_dim``) into K pieces and sends piece j
    to slot j, which concatenates what it receives along ``concat_dim``
    in slot order (``lax.all_to_all``, tiled)."""
    k = x.shape[0]
    note("all-to-all", x, k)
    shp = list(x.shape)
    pieces = x.reshape(shp[:split_dim] + [k, shp[split_dim] // k]
                       + shp[split_dim + 1:])
    # pieces: [K_src, ..., K_dst, piece, ...]; move K_dst to the front
    # and K_src next to the concat dimension
    pieces = pieces.movedim(split_dim, 0)          # [K_dst, K_src, ...]
    c = concat_dim
    pieces = pieces.movedim(1, c)                  # K_src before concat
    shp2 = list(pieces.shape)
    return pieces.reshape(shp2[:c] + [shp2[c] * shp2[c + 1]]
                          + shp2[c + 2:])


def ppermute(x: torch.Tensor, shift: int = 1) -> torch.Tensor:
    """Slot j's block to slot j + shift (mod K) (``lax.ppermute`` with
    the ring permutation)."""
    note("collective-permute", x, x.shape[0])
    return torch.roll(x, shifts=shift, dims=0)
