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

**Across processes.**  The port runs one process per card, the PyTorch
idiom, joined into a ``torch.distributed`` process group by
``parallel.initialize_distributed``.  A mesh made while a group is up
spans its W processes: the data axis's K slots are laid out process by
process (the reference's ``slice_mesh`` rule with a process in the place
of a slice), so process r holds the global data slots ``r*K/W ...
(r+1)*K/W - 1`` on its own device, and the model and seq axes stay
inside a process.  ``Mesh.shape`` stays global; ``local_shape`` is the
process's own.  A collective then has a second, cross-process half
(``process_all_gather``, ``process_sum``): the W per-process partials
are all-gathered into ``[W, ...]`` and summed over that dimension in
rank order, so every rank holds the same bits whichever layout asked.
A replica stack's cross-process half is ``process_gather_slots``: each
process's ``[K/W, ...]`` slots gathered into the global ``[K, ...]`` in
slot order, which the slot collective then reduces as in one process
(``ParallelWrapper``'s average, its ZeRO window's gradients and
blocks), so two processes of two slots give the one-process four-slot
bits.  Only ``all_gather`` is needed from the backend (gloo for CPU
tensors and, through host memory in its own CUDA path, the card's; NCCL
for the card's).  Each cross-process collective adds its bytes and
seconds to the census beside the slot bytes (``process_bytes``,
``process_count``) and to ``process_totals(kind)``: the step's data
(``"exchange"``), the training statistics' reductions
(``"statistics"``) and host-side agreement (``"agreement"``) apart.

Under a mesh that spans processes the sync master, ``ParallelWrapper``
(replicated at any averaging frequency, and ZeRO),
``ParameterAveragingTrainingMaster`` and ``elastic=`` on each of them
run, with the introspection policy, the numerics ledger,
``checkpoint_manager=`` and ``retry_policy=``; so do
``DistributedWord2Vec`` and ``DistributedGlove``.  What still raises
names its ROADMAP item (``across_processes``): the model and seq axes
(A14b).

Host-side agreement (whether to stop, which checkpoint to resume, a
step fault seen on one rank, a checkpoint's commit barriers) goes over
gloo groups of its own (``host_group``), so it never needs a device
tensor and never shares a group with the training thread's exchange:
``process_any``, ``process_agree`` (rank 0's value), ``process_codes``
and ``check_agreement`` (a digest equal on every rank, or a raise).
Their time is counted apart from the exchange's
(``process_totals("agreement")``), whichever thread ran them.

A mesh in one process whose slots name several devices raises
``NotImplementedError`` (ROADMAP A10): its counterpart in the port is
one process per card through ``initialize_distributed``.  It is never
folded onto one device.

``Sharded`` is a leaf laid over a mesh by a ``PartitionSpec`` (``P``):
what the sharded checkpoint saves piece by piece and the sharding ledger
reads.  It holds the slot blocks stacked, ``[s_0, ..., s_k, *block]``
over the sharded dimensions in order, one block per distinct piece (the
copies along unsharded axes are the same tensor).
"""

from __future__ import annotations

import math
import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.backend.device import resolve_device

AXIS_DATA = "data"
AXIS_MODEL = "model"
AXIS_SEQ = "seq"
AXES = (AXIS_DATA, AXIS_MODEL, AXIS_SEQ)

_ACROSS = ("a mesh in one process over several devices is not ported "
           "(ROADMAP A10, meshes across processes and GPUs: the port runs "
           "one process per card, joined by "
           "parallel.initialize_distributed, the PyTorch idiom)")


# ------------------------------------------------------------- processes
def _dist():
    import torch.distributed as dist

    return dist


# what still raises under a mesh that spans processes (ROADMAP A14)
A14B = "ROADMAP A14b: the model and seq axes across processes"


def across_processes(what: str, item: str, mesh=None) -> None:
    """Raise ``NotImplementedError`` naming ``item`` when ``mesh`` (or,
    without one, this process) spans a process group: ``what`` would
    otherwise train only this process's replicas without a word."""
    spans = mesh.spans_processes if mesh is not None else processes_up()
    if spans:
        raise NotImplementedError(
            f"{what} across processes is not ported yet ({item})")


def processes_up() -> bool:
    """A ``torch.distributed`` process group is up in this process
    (``parallel.initialize_distributed``)."""
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return _dist().get_world_size() if processes_up() else 1


def process_index() -> int:
    return _dist().get_rank() if processes_up() else 0


def process_backend() -> Optional[str]:
    return str(_dist().get_backend()) if processes_up() else None


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
    as the reference's ``Mesh.shape``.  ``processes`` (W, from the
    process group: ``default_mesh`` passes it while one is up) makes the
    mesh span W processes along its data axis (module docstring): this
    process holds the data slots ``local_slots`` of ``shape``'s, and its
    own slots must name one device."""

    def __init__(self, devices, axis_names: Sequence[str],
                 processes: Optional[int] = None):
        arr = np.empty(np.shape(devices), dtype=object)
        flat = [torch.device(d) for d in np.asarray(devices,
                                                    dtype=object).reshape(-1)]
        for i, d in enumerate(flat):
            arr.reshape(-1)[i] = d
        if arr.ndim != len(axis_names):
            raise ValueError(f"{arr.ndim}-d slot array for axes "
                             f"{tuple(axis_names)}")
        self.devices = arr
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, arr.shape))
        self.spans_processes = processes is not None
        self.process_count = int(processes or 1)
        self.process_index = process_index() if self.spans_processes else 0
        k = self.shape.get(AXIS_DATA, 1)
        if k % self.process_count:
            raise ValueError(
                f"a data axis of {k} slots does not divide over "
                f"{self.process_count} processes")
        per = k // self.process_count
        lo = self.process_index * per
        self.local_slots = range(lo, lo + per)
        self.local_shape = dict(self.shape)
        if AXIS_DATA in self.shape:
            self.local_shape[AXIS_DATA] = per
            d = self.axis_names.index(AXIS_DATA)
            mine = [torch.device(x) for x in np.take(
                arr, list(self.local_slots), axis=d).reshape(-1)]
        else:
            mine = flat
        if len({str(d) for d in mine}) > 1:
            raise NotImplementedError(
                f"slots on {sorted({str(d) for d in mine})}: " + _ACROSS)
        self.device = mine[0]

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_size(self, names) -> int:
        """Product of the sizes of ``names`` (None: 1)."""
        return math.prod(self.shape[n] for n in _names(names))

    def __repr__(self):
        span = (f", processes={self.process_count}, "
                f"process_index={self.process_index}"
                if self.spans_processes else "")
        return f"Mesh({self.shape}, device={self.device}{span})"


def _names(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def local_devices() -> List[torch.device]:
    """The cards of this process, or the CPU where there is none; under a
    process group, the process's own card (one process a card)."""
    if processes_up() and torch.cuda.is_available():
        return [resolve_device(None)]
    if torch.cuda.is_available():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def device_count() -> int:
    """Every process's devices: under a process group one a process."""
    return process_count() if processes_up() else len(local_devices())


def default_mesh(n_devices: Optional[int] = None, *,
                 data: Optional[int] = None, model: int = 1, seq: int = 1,
                 devices: Optional[Sequence] = None) -> Mesh:
    """A slot mesh with axes ('data', 'model', 'seq') (reference
    ``default_mesh``: by default every slot goes to the data axis).
    ``devices`` names each slot's device (repeats allowed); without it
    the mesh has ``n_devices`` slots (default: ``data * model * seq``,
    else the card count) of the default device (``cuda``; raises without
    a GPU).  While a process group is up the slots are global: the mesh
    spans the group's processes, ``devices`` naming every slot (module
    docstring)."""
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
    return Mesh(arr.reshape(data, model, seq), AXES,
                processes=process_count() if processes_up() else None)


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

    def owner(self, ranges) -> Optional[int]:
        """The process that holds the block at ``ranges`` (``blocks()``'s)
        on a mesh that spans processes: the one whose data slots it lies
        in; None where every process holds it (no dimension sharded over
        the data axis, or a mesh in one process)."""
        if not self.mesh.spans_processes:
            return None
        bs = self.block_shape
        for d, e in enumerate(self.spec):
            names = _names(e)
            if AXIS_DATA not in names:
                continue
            idx = ranges[d][0] // bs[d]
            after = names[names.index(AXIS_DATA) + 1:]
            coord = (idx // self.mesh.axis_size(after)) \
                % self.mesh.shape[AXIS_DATA]
            return coord // self.mesh.local_shape[AXIS_DATA]
        return None

    def slot_bytes(self) -> int:
        """Bytes each slot holds: one block."""
        return math.prod(self.block_shape) * self.local.element_size()

    def __repr__(self):
        return (f"Sharded(shape={self.shape}, spec={self.spec!r}, "
                f"local={tuple(self.local.shape)})")


def replica_stack(t: torch.Tensor, mesh: Mesh, axis: str = AXIS_DATA
                  ) -> Sharded:
    """A ``[K, ...]`` replica stack as a leaf sharded over ``axis`` (each
    slot holds its replica), for the ledger: on a mesh that spans
    processes ``t`` holds this process's slots, and the leaf's shape is
    the global stack's."""
    shape = (mesh.shape[axis],) + tuple(t.shape[1:])
    return Sharded(t, P(axis), mesh, shape)


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


_PROCESS_KEYS = ("process_count", "process_bytes", "process_seconds")


def _add(book, op, count, nbytes, groups, extra=None):
    e = book.setdefault(op, {"count": 0, "bytes": 0.0, "group_sizes": []})
    e["count"] += count
    e["bytes"] += nbytes
    for g in groups:
        if g not in e["group_sizes"]:
            e["group_sizes"].append(g)
    for k, v in (extra or {}).items():
        e[k] = e.get(k, 0) + v


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
                     e["group_sizes"],
                     {k: e[k] for k in _PROCESS_KEYS if k in e})
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


# ------------------------------------------------- across processes
# the cross-process collectives by kind: "exchange" the step's data
# (gradients, parameters, slot stacks, NLP deltas, gathered outputs),
# "statistics" the training statistics' reductions (op "statistics"),
# "agreement" host-side agreement and commit barriers (a host group's,
# on whichever thread)
_PROCESS_KINDS = ("exchange", "statistics", "agreement")
_process_totals: Dict[str, Dict[str, float]] = {
    k: {"count": 0, "bytes": 0.0, "seconds": 0.0} for k in _PROCESS_KINDS}


def process_totals(kind: str = "exchange") -> Dict[str, float]:
    """The cross-process collectives of ``kind`` this process ran:
    count, bytes it sent, and host seconds (on NCCL the seconds to
    enqueue; gloo's calls return when done).  ``"exchange"`` (the
    default) leaves out the statistics' reductions and the host-side
    agreements, so a step's exchange time is its data's alone."""
    with _lock:
        return dict(_process_totals[kind])


def _note_process(op: str, nbytes: float, secs: float,
                  kind: str) -> None:
    extra = {"process_count": 1, "process_bytes": nbytes,
             "process_seconds": secs}
    with _lock:
        _add(_totals, op, 0, 0.0, [], extra)
        book = _process_totals[kind]
        for k, v in (("count", 1), ("bytes", nbytes), ("seconds", secs)):
            book[k] += v
    if _census.counts is not None:
        _add(_census.counts, op, 0, 0.0, [], extra)


# carried as their bytes: every backend takes uint8 (gloo builds refuse
# some 16-bit types: "Invalid scalar type")
_AS_BYTES = (torch.bfloat16, torch.float16, torch.bool)
# gloo carries a collective over one TCP connection a peer, and one
# connection's rate bounds it (about 0.35 GB/s over loopback in a
# sandbox); a large gather is split over process groups of its own,
# whose connections carry their chunks at once (four carried 256 MiB
# about three times faster than one)
GLOO_STREAMS = 4
GLOO_CHUNK_MIN = 4 << 20        # bytes: smaller payloads go in one piece
_streams: Dict[str, object] = {}


def _gloo_streams(nbytes: int) -> List[Optional[object]]:
    """The process groups a gloo gather of ``nbytes`` goes over (None:
    the default group), made on first use on every rank alike (every
    rank gathers the same sizes in the same order)."""
    n = min(GLOO_STREAMS, nbytes // GLOO_CHUNK_MIN)
    if process_backend() != "gloo" or n < 2:
        return [None]
    dist = _dist()
    if _streams.get("world") is not dist.group.WORLD:
        ranks = list(range(dist.get_world_size()))
        _streams["groups"] = [dist.new_group(ranks, backend="gloo")
                              for _ in range(GLOO_STREAMS)]
        _streams["world"] = dist.group.WORLD
    return _streams["groups"][:n]


_hosts: Dict[str, object] = {}


def host_group(name: str):
    """A gloo process group of its own, ``name``'s, for host-side
    protocol: made on first use, which every rank reaches at the same
    point of its run and on one thread (``dist.new_group`` is a
    collective of the world), kept while the world is the same.  A
    group serves one thread: the training thread's agreements
    (``"agree"``) and a checkpoint writer's barriers (its own) never
    share one, so neither can interleave with the other or with the
    exchange on the default group."""
    dist = _dist()
    if _hosts.get("world") is not dist.group.WORLD:
        _hosts.clear()
        _hosts["world"] = dist.group.WORLD
    g = _hosts.get(name)
    if g is None:
        g = _hosts[name] = dist.new_group(
            list(range(dist.get_world_size())), backend="gloo")
    return g


def process_all_gather(t: torch.Tensor, op: str = "all-gather",
                       group=None) -> torch.Tensor:
    """``t`` of every process, stacked in rank order: ``[W, *t.shape]``
    on ``t``'s device (``t`` itself, unsqueezed, without a process
    group).  Every rank receives the same tensor.  Not differentiable
    (``process_gather_rows`` is).  ``op`` names the collective this
    gather carries in the census; ``group`` (a ``host_group``) carries a
    host tensor over gloo whatever the default backend."""
    if not processes_up():
        return t.unsqueeze(0)
    dist = _dist()
    world = dist.get_world_size()
    t0 = time.perf_counter()
    src = t.detach().contiguous()
    as_bytes = src.dtype in _AS_BYTES
    if as_bytes:
        src = src.reshape(-1).view(torch.uint8)
    if group is not None:
        src = src.cpu()
    elif process_backend() == "nccl" and not src.is_cuda:
        src = src.to(resolve_device(None))    # NCCL carries the card's
    out = torch.empty((world,) + tuple(src.shape), dtype=src.dtype,
                      device=src.device)
    groups = ([group] if group is not None
              else _gloo_streams(src.numel() * src.element_size()))
    if len(groups) == 1:
        dist.all_gather(list(out.unbind(0)), src, group=groups[0])
    else:
        flat, rows = src.reshape(-1), out.view(world, -1)
        works = [dist.all_gather(list(o.unbind(0)), c, group=g,
                                 async_op=True)
                 for c, o, g in zip(flat.chunk(len(groups)),
                                    rows.chunk(len(groups), dim=1),
                                    groups)]
        for w in works:
            w.wait()
    if out.device != t.device:
        out = out.to(t.device)
    if as_bytes:
        out = out.view(t.dtype).reshape((world,) + tuple(t.shape))
    _note_process(op, float(t.numel() * t.element_size()),
                  time.perf_counter() - t0,
                  "agreement" if group is not None else
                  "statistics" if op == "statistics" else "exchange")
    return out


def process_sum(t: torch.Tensor, op: str = "all-reduce") -> torch.Tensor:
    """The sum of ``t`` over the processes, in rank order: the same bits
    on every rank (``t`` itself without a process group)."""
    if not processes_up():
        return t
    return process_all_gather(t, op).sum(0)


def process_sum_many(tensors: Sequence[torch.Tensor],
                     op: str = "all-reduce") -> List[torch.Tensor]:
    """``process_sum`` of each tensor, as one collective a dtype."""
    if not processes_up():
        return list(tensors)
    return [g.sum(0) for g in process_all_gather_many(tensors, op)]


def process_all_gather_many(tensors: Sequence[torch.Tensor],
                            op: str = "all-gather") -> List[torch.Tensor]:
    """``process_all_gather`` of each tensor (``[W, *shape]``), as one
    collective a dtype (the tensors flattened into one buffer)."""
    if not processes_up():
        return [t.unsqueeze(0) for t in tensors]
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    by_type: Dict[Tuple[torch.dtype, torch.device], List[int]] = {}
    for i, t in enumerate(tensors):
        by_type.setdefault((t.dtype, t.device), []).append(i)
    for idx in by_type.values():
        flat = torch.cat([tensors[i].detach().reshape(-1) for i in idx])
        got = process_all_gather(flat, op)
        off = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = got[:, off:off + n].reshape(
                (got.shape[0],) + tuple(tensors[i].shape))
            off += n
    return out


def process_gather_slots(t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """This process's slots of a stack (``[K/W, ...]`` along ``dim``)
    and every other process's, in global slot order: ``[K, ...]`` (``t``
    itself without a process group).  The same bits on every rank."""
    return process_gather_slots_many([t], dim)[0]


def process_gather_slots_many(tensors: Sequence[torch.Tensor],
                              dim: int = 0, op: str = "all-gather"
                              ) -> List[torch.Tensor]:
    """``process_gather_slots`` of each tensor, as one collective a
    dtype."""
    if not processes_up():
        return list(tensors)
    out = []
    for t, got in zip(tensors, process_all_gather_many(tensors, op)):
        # [W, ..., K/W, ...] -> [..., W, K/W, ...] -> [..., K, ...]
        got = got.movedim(0, dim)
        shp = list(t.shape)
        shp[dim] *= got.shape[dim]
        out.append(got.reshape(shp))
    return out


def process_barrier() -> None:
    """Every process reaches this point before any goes on (a one-word
    all-gather, so that it needs nothing but ``all_gather``)."""
    if processes_up():
        dev = resolve_device(None) if process_backend() == "nccl" \
            else torch.device("cpu")
        process_all_gather(torch.zeros((1,), device=dev), "barrier")


# ------------------------------------------------- host-side agreement
def process_codes(codes: Sequence[int], group=None) -> np.ndarray:
    """Every rank's ``codes`` (a few integers), ``[W, len(codes)]`` in
    rank order, over ``group`` (default: the training thread's
    ``host_group("agree")``); ``[1, n]`` without a process group."""
    t = torch.as_tensor(np.asarray(codes, np.int64).reshape(-1))
    if not processes_up():
        return t.numpy()[None]
    g = group if group is not None else host_group("agree")
    return process_all_gather(t, "agreement", g).numpy()


def process_any(flag: bool, group=None) -> bool:
    """Whether ``flag`` holds on any rank: every rank gets the same
    answer."""
    return bool(process_codes([int(bool(flag))], group).any())


def process_agree(value: int, group=None) -> int:
    """Rank 0's ``value`` on every rank (what one rank decided from what
    only it may have seen: a directory listing, a clock)."""
    return int(process_codes([int(value)], group)[0, 0])


def check_agreement(what: str, digest: bytes, group=None) -> None:
    """Raise ``ValueError`` unless ``digest`` (a hash of what every rank
    must hold alike: a vocabulary, initial tables) is the same on every
    rank; a no-op without a process group."""
    if not processes_up():
        return
    mine = np.frombuffer(digest, np.uint8).astype(np.int64)
    got = process_codes(mine, group)
    bad = [r for r in range(got.shape[0]) if not (got[r] == got[0]).all()]
    if bad:
        raise ValueError(
            f"{what} differs across processes: ranks {bad} differ from "
            f"rank 0 (digest {bytes(got[0].astype(np.uint8)).hex()[:16]}; "
            f"this rank's {digest.hex()[:16]})")


class _GatherRows(torch.autograd.Function):
    """Every process's rows in rank order.  What reads them ends in
    ``own_rows``, whose backward hands every process the whole gradient,
    so this backward keeps the process's own rows of it."""

    @staticmethod
    def forward(ctx, x):
        ctx.rows = x.shape[0]
        got = process_all_gather(x)
        return got.reshape((-1,) + tuple(x.shape[1:]))

    @staticmethod
    def backward(ctx, g):
        r, n = process_index(), ctx.rows
        return g[r * n:(r + 1) * n]


class _OwnRows(torch.autograd.Function):
    """This process's rows; the backward all-gathers every process's
    gradient rows, so that what ran on the gathered rows runs its
    backward on the whole gradient, the same bits in every process."""

    @staticmethod
    def forward(ctx, y):
        n = y.shape[0] // process_count()
        r = process_index()
        return y[r * n:(r + 1) * n]

    @staticmethod
    def backward(ctx, g):
        got = process_all_gather(g.contiguous())
        return got.reshape((-1,) + tuple(g.shape[1:]))


class _Once(torch.autograd.Function):
    """A parameter that every process uses on the gathered rows: each
    takes its whole gradient, so process 0's counts and the others'
    are 0 (the exchange's sum is then process 0's, bit for bit)."""

    @staticmethod
    def forward(ctx, p):
        return p.view_as(p)

    @staticmethod
    def backward(ctx, g):
        return g if process_index() == 0 else torch.zeros_like(g)


def process_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """``x``'s rows of every process, in rank order (so in global slot
    order), differentiable with ``own_rows``; ``x`` itself without a
    process group."""
    if not processes_up():
        return x
    return _GatherRows.apply(x)


def own_rows(x: torch.Tensor) -> torch.Tensor:
    """This process's block of the rows of ``x`` (the inverse of
    ``process_gather_rows``): rows ``[r*n/W, (r+1)*n/W)``."""
    if not processes_up():
        return x
    return _OwnRows.apply(x)


def counted_once(p: torch.Tensor) -> torch.Tensor:
    """``p`` whose gradient process 0 alone contributes (a parameter read
    on the gathered rows, between ``process_gather_rows`` and
    ``own_rows``)."""
    if not processes_up() or not torch.is_tensor(p):
        return p
    return _Once.apply(p)
