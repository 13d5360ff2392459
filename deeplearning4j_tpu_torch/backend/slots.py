"""The slots a master's step puts in force for the layers it runs.

A slot master (``parallel/training_master.py``) runs one forward over
the global batch.  Two kinds of slots shape what the layers do there:

- **Data slots** (``data_slots(k)``): the batch's rows are the k data
  slots' row blocks side by side, slot i holding rows ``[i*B/k,
  (i+1)*B/k)``.  A layer that reads the rows of the whole batch at once
  (BatchNorm's batch statistics, the MoE layer's routing) reads them
  gathered, as the reference's one global program does; the gather is a
  view, recorded as an ``all-gather`` over the k slots
  (``gather_rows``).  Under a mesh that spans processes
  (``data_slots(k, processes=True)``) each process holds only its own
  slots' rows: ``gather_rows`` all-gathers every process's rows in rank
  order, the layer keeps its own rows of what it computed (``own_rows``,
  whose backward all-gathers the gradient's rows, so that the layer's
  backward runs on the whole batch's gradient in every process, the
  single net's computation bit for bit; ``gather_rows``' backward then
  keeps the process's rows), its parameters' gradients count once
  (``coupled_params``: process 0's), a dropout mask is the global batch's mask's rows of
  the process (``row_offset``), the loss divides by the global batch's
  count (``process_denominator``) and the regularization term is
  counted once, by process 0 (``once``).
- **Model slots** (``model_slots(tp)``): a parameter that the tensor
  parallel spec shards is held as a ``[tp, ...]`` stack of its slots'
  blocks (a view of the net's own tensor).  A layer that meets such a
  stack computes on the blocks with the collectives of the Megatron
  layout between them (``linear``, ``column``, ``row``,
  ``vocab_parallel_mcxent``).  A product whose output a slot owns alone
  (a column-parallel one: a dense or embedding layer's column blocks,
  attention's head groups, a conv layer's output channels, an expert's
  FFN) runs as one product over the slots' blocks side by side, as the
  data slots' rows lie side by side: an activation sharded over the
  model slots on its feature axis is held in its natural layout (slot
  k's block is features ``[k*n/tp, (k+1)*n/tp)``), so the elementwise
  layers between a column- and a row-parallel layer run on it
  unchanged.  The products that need the slots' sum are written out on
  the slot dimension: a row-parallel product's ``[tp, ...]`` partials
  psum'd, the vocab-parallel loss's max and sums, the MoE combine.  A
  layer with no sharded forward (``Layer.slot_aware()`` false) gets its
  stacked leaves gathered whole and its sharded input gathered
  (``layer_in``), each a recorded ``all-gather``.

  Which activations are column-sharded: inside one layer's forward, a
  flag that the products set and clear in the order the layer runs them
  (a layer is one chain); between layers, the tensor itself, tagged by
  ``layer_out`` and read by the next consumer (``is_sharded``), so a
  graph's branches each carry their own.

Outside a master's step both are 1 and every function here is the
identity, so a net outside a master runs as it always did.
"""

from __future__ import annotations

import contextlib
import threading
import weakref
from typing import Optional, Sequence

import torch

from deeplearning4j_tpu_torch.backend import mesh as mesh_mod

# activations that read every feature of a row: after a column-parallel
# layer they gather first
_ROW_WISE = ("softmax", "logsoftmax", "log_softmax")


class _Slots(threading.local):
    rows: int = 1
    procs: bool = False        # the data slots span the group's processes
    tp: int = 1
    sharded: bool = False      # the running layer's activation so far


_ctx = _Slots()

# the column-sharded activations that left a layer: id -> weak reference
_tagged: dict = {}


def _tag(t):
    i = id(t)
    _tagged[i] = weakref.ref(t, lambda _r, i=i: _tagged.pop(i, None))
    return t


def is_sharded(t) -> bool:
    """``t`` is an activation that left a layer column-sharded over the
    model slots (and that no consumer has gathered yet)."""
    r = _tagged.get(id(t))
    return r is not None and r() is t


def same_layout(src, t):
    """``t``, computed elementwise from ``src`` (a cast), in ``src``'s
    layout."""
    return _tag(t) if is_sharded(src) else t


@contextlib.contextmanager
def data_slots(k: int, processes: bool = False):
    """Inside the block the batch's rows are ``k`` data slots' blocks;
    with ``processes`` the slots span the process group's processes and
    the rows here are this process's slots' (module docstring)."""
    prev = (_ctx.rows, _ctx.procs)
    _ctx.rows, _ctx.procs = int(k), bool(processes)
    try:
        yield
    finally:
        _ctx.rows, _ctx.procs = prev


def spans_processes() -> bool:
    return _ctx.procs


@contextlib.contextmanager
def model_slots(tp: int):
    """Inside the block stacked leaves are ``tp`` model slots' blocks."""
    prev = (_ctx.tp, _ctx.sharded)
    _ctx.tp, _ctx.sharded = int(tp), False
    try:
        yield
    finally:
        _ctx.tp, _ctx.sharded = prev


def tp() -> int:
    return _ctx.tp


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """``x``'s rows, all the data slots' blocks, for a layer that couples
    the rows of the batch: in one process the blocks lie side by side
    already, so this is ``x`` itself, recorded as the all-gather it
    stands for; across processes every process's rows, in rank order
    (``backend.mesh.process_gather_rows``).  The layer hands back its
    own rows of what it computed from them (``own_rows``)."""
    if _ctx.procs:
        x = mesh_mod.process_gather_rows(x)
    if _ctx.rows > 1:
        mesh_mod.note("all-gather", x, _ctx.rows)
    return x


def own_rows(y: torch.Tensor) -> torch.Tensor:
    """This process's rows of ``y``, computed from ``gather_rows``' rows
    (``y`` itself in one process)."""
    return mesh_mod.own_rows(y) if _ctx.procs else y


def coupled_params(params):
    """A coupling layer's parameters, read on the gathered rows: across
    processes each one's gradient counted once (process 0's; every
    process computes the whole of it), else ``params`` itself."""
    if not _ctx.procs:
        return params
    if isinstance(params, dict):
        return {k: coupled_params(v) for k, v in params.items()}
    return mesh_mod.counted_once(params)


def row_offset(shape) -> int:
    """Elements before this process's rows in a draw over the global
    batch's rows, for a tensor of ``shape`` holding the process's rows
    (0 in one process): a dropout mask drawn from this offset is the
    global mask's rows that the process holds."""
    if not _ctx.procs:
        return 0
    n = 1
    for d in shape:
        n *= int(d)
    return mesh_mod.process_index() * n


def process_denominator(count: torch.Tensor) -> torch.Tensor:
    """A loss's count (the mask's sum) over the global batch: summed over
    the processes (``count`` itself in one process)."""
    return mesh_mod.process_sum(count) if _ctx.procs else count


def process_share() -> int:
    """The processes a mean over the batch's rows is shared by: the
    global batch's rows are this many times the process's (1 in one
    process)."""
    return mesh_mod.process_count() if _ctx.procs else 1


def once(term):
    """A term of the loss that every process computes whole (the
    regularization), counted once over the processes: process 0's, 0 on
    the others (``term`` itself in one process)."""
    if not _ctx.procs or mesh_mod.process_index() == 0:
        return term
    return torch.zeros_like(term) if torch.is_tensor(term) else 0.0


# ------------------------------------------------------------ model slots
def sharded_dim(w, logical: Sequence[int]) -> Optional[int]:
    """The dimension of the logical ``[*logical]`` leaf that ``w`` holds
    sharded as a ``[tp, ...]`` stack, or None (a whole leaf)."""
    n = _ctx.tp
    if n == 1 or not torch.is_tensor(w) or w.ndim != len(logical) + 1 \
            or w.shape[0] != n:
        return None
    blk = tuple(w.shape[1:])
    for d, (a, b) in enumerate(zip(blk, logical)):
        if a * n == b and all(x == y for i, (x, y) in
                              enumerate(zip(blk, logical)) if i != d):
            return d
    return None


def full_leaf(w, logical: Sequence[int]):
    """A stacked leaf gathered whole (a recorded all-gather); any other
    leaf as it is."""
    d = sharded_dim(w, logical)
    if d is None:
        return w
    mesh_mod.note("all-gather", w, _ctx.tp)
    return w.movedim(0, d).reshape(tuple(logical))


def gather_act(h):
    """An activation read whole: where a layer left it column-sharded,
    recorded as the all-gather of its blocks (held side by side already),
    once; its later consumers read it whole."""
    if torch.is_tensor(h) and is_sharded(h):
        mesh_mod.note("all-gather", h, _ctx.tp)
        _tagged.pop(id(h), None)
        _ctx.sharded = False
    return h


def _promote(x, w):
    """x and w in their common type, as ``jnp``'s products promote."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    return x, w


def matmul(x, w):
    x, w = _promote(x, w)
    return x @ w


def blocks_side_by_side(w, d: int):
    """A ``[tp, ...]`` stack of blocks split from dimension ``d`` laid
    back side by side: the whole leaf (a view, where the stack is the
    view of one)."""
    return w.movedim(0, d).reshape(w.shape[1:d + 1] + (w.shape[0]
                                                       * w.shape[d + 1],)
                                   + w.shape[d + 2:])


def column(x, w):
    """A column-parallel product: ``x`` [..., n_in] against the slots'
    ``[tp, n_in, n/tp]`` blocks.  Each slot's output block reads only its
    own weight block, so the slots' products run as one product over
    the blocks side by side, landing in the ``[..., n]`` column-sharded
    layout (no copy)."""
    _ctx.sharded = True
    return _tag(matmul(x, blocks_side_by_side(w, 1)))


def row(x, w):
    """A row-parallel product: each slot's block of ``x``'s features
    (``[..., n_in]``, whole or column-sharded) against its ``[n_in/tp,
    n_out]`` block of ``w``, the ``[tp, ..., n_out]`` partial products
    psum'd over the slots."""
    n = w.shape[0]
    lead = tuple(x.shape[:-1])
    xs = x.reshape(-1, n, x.shape[-1] // n).transpose(0, 1)
    _ctx.sharded = False
    xs, w = _promote(xs, w)
    return mesh_mod.psum(torch.bmm(xs, w)).reshape(lead + (w.shape[-1],))


def linear(x, w, n_in: int, n_out: int):
    """``x @ W`` for a layer's ``W`` [n_in, n_out], whole or held column-
    or row-parallel over the model slots (the bias is the caller's:
    added blockwise by its natural layout, or once after the row
    product's psum)."""
    d = sharded_dim(w, (n_in, n_out))
    if d == 1:
        return column(x, w)
    if d == 0:
        return row(x, w)
    return matmul(gather_act(x), w)


def mark_sharded(w):
    """``w``, the slots' weight blocks side by side, whose product lays
    the running layer's output out column-sharded (a conv layer's output
    channels, an embedding's feature blocks)."""
    _ctx.sharded = True
    return w


psum = mesh_mod.psum


def before_activation(name: str, z):
    """A row-wise activation of the running layer's column-sharded
    activation reads every feature: it gathers first."""
    if name in _ROW_WISE and _ctx.sharded:
        mesh_mod.note("all-gather", z, _ctx.tp)
        _ctx.sharded = False
    return z


def _gather_tree(params, shapes):
    out = {}
    for k, v in params.items():
        s = shapes.get(k)
        if isinstance(v, dict):
            out[k] = _gather_tree(v, s if isinstance(s, dict) else {})
        else:
            out[k] = full_leaf(v, s) if s is not None else v
    return out


def layer_in(layer, params, h):
    """What ``layer`` reads under the model slots: a layer with no
    sharded forward (``layer.slot_aware()`` false) gets its stacked
    leaves gathered whole; a column-sharded input is gathered unless the
    layer reads it as the slots' blocks (``layer.slot_reads_blocks``).
    Starts the layer's flag from its input.  The identity outside the
    model slots."""
    if _ctx.tp == 1:
        return params, h
    if not layer.slot_aware() and params:
        params = _gather_tree(params, layer.param_shapes())
    if layer.slot_reads_blocks(params):
        _ctx.sharded = is_sharded(h)
    else:
        h = gather_act(h)
        _ctx.sharded = False
    return params, h


def layer_out(h):
    """The running layer's output ``h``, tagged where it leaves the layer
    column-sharded."""
    if _ctx.tp > 1 and _ctx.sharded and torch.is_tensor(h):
        _tag(h)
    return h


def vocab_parallel_mcxent(labels, pre):
    """Softmax cross-entropy per example over column-sharded logits
    ``pre`` [..., V] (the slots' vocab blocks side by side): each slot's
    max, sum of exponentials and label term over its block, combined by
    a max and two psums over the slots; equal to the whole softmax's
    ``-sum(labels * log_softmax(pre))``."""
    n = _ctx.tp
    zs = pre.reshape(tuple(pre.shape[:-1]) + (n, pre.shape[-1] // n))
    ls = labels.reshape(zs.shape)
    m_loc = zs.detach().amax(dim=-1)                       # [..., tp]
    mesh_mod.note("all-reduce", m_loc.movedim(-1, 0), n)   # pmax
    m = m_loc.amax(dim=-1, keepdim=True)
    se = mesh_mod.psum(torch.exp(zs - m[..., None]).sum(-1).movedim(-1, 0))
    lz = mesh_mod.psum((ls * zs).sum(-1).movedim(-1, 0))
    lsum = ls.sum(dim=(-2, -1))
    return (m[..., 0] + torch.log(se)) * lsum - lz
