"""Tensor and expert parallelism over the slot mesh's model axis — the
port's counterpart of ``deeplearning4j_tpu/parallel/model_parallel.py``.

``tensor_parallel_spec`` lays every parameter out by the reference's
rules (Megatron's alternating column/row splits for dense chains,
attention's head groups, conv kernels by output channel, MoE experts by
the expert axis).  The reference's ``TensorParallelTrainingMaster`` is
the data-parallel step with its parameters placed by those specs and the
collectives left to GSPMD.  The port writes them out: each leaf the spec
shards reaches the forward as a ``[tp, ...]`` stack of its model slots'
blocks, a view of the net's own tensor (so its gradient, and the
update, land in the net's weights in place: nothing to write back), and
the sync master's step runs with ``backend.slots.model_slots(tp)`` in
force, where each layer with a sharded forward computes on its slots'
blocks with the Megatron collectives between them (``backend/slots.py``; ``DenseLayer``,
``OutputLayer``/``RnnOutputLayer`` with a vocab-parallel softmax
cross-entropy, ``EmbeddingLayer``, ``SelfAttentionLayer``,
``ResidualBlock``, ``ConvolutionLayer``, ``MoELayer``).  Any other layer
gets its sharded leaves all-gathered at use.  The updater acts on the
whole leaves: its arithmetic is per element, and a per-layer norm sums
every slot's squares, as GSPMD's reads whole leaves.

Composes dp x tp on one mesh: ``default_mesh(data=2, model=2)`` trains
2-way data-parallel with every sharded parameter split across 2 slots.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from deeplearning4j_tpu_torch.backend import mesh as mesh_mod
from deeplearning4j_tpu_torch.backend import slots
from deeplearning4j_tpu_torch.backend.mesh import AXIS_MODEL, P, Sharded
from deeplearning4j_tpu_torch.observability import shardstats
from deeplearning4j_tpu_torch.parallel import zero as zero_mod
from deeplearning4j_tpu_torch.parallel.training_master import (
    SyncTrainingMaster,
)


def tensor_parallel_spec(params: Dict[str, Dict[str, Any]], tp: int,
                         axis: str = AXIS_MODEL) -> Dict[str, Dict[str, Any]]:
    """Per-parameter ``P`` specs, recursive over nested param trees
    (composite layers nest sublayer dicts), by the reference's rules
    (``model_parallel.py:27-85``):

      - attention groups ({Wq, Wk, Wv, Wo} siblings): Wq/Wk/Wv
        column-parallel (head groups), Wo row-parallel;
      - other 2-D ``W*`` leaves: column-parallel ``P(None, axis)`` and
        row-parallel ``P(axis, None)`` alternating in traversal order,
        the parity snapped to even after an attention group;
      - 4-D conv kernels [kh, kw, cin, cout]: cout;
      - 3-D expert tensors [E, ...]: the expert axis;
      - biases, vectors and anything ``tp`` does not divide: replicated.
    """
    parity = [0]

    def leaf_spec(pname, arr, attn, par):
        shape = tuple(getattr(arr, "shape", ()))
        nd = len(shape)
        if nd == 2 and pname.startswith("W"):
            if attn:
                if pname in ("Wq", "Wk", "Wv") and shape[1] % tp == 0:
                    return P(None, axis), True
                if pname == "Wo" and shape[0] % tp == 0:
                    return P(axis, None), True
                return P(), True
            if par % 2 == 0 and shape[1] % tp == 0:
                return P(None, axis), True
            if par % 2 == 1 and shape[0] % tp == 0:
                return P(axis, None), True
            return P(), True
        if nd == 4 and shape[-1] % tp == 0:
            return P(None, None, None, axis), True
        if nd == 3 and shape[0] % tp == 0:
            return P(axis, None, None), True
        return P(), False

    def walk(tree):
        out = {}
        attn = {"Wq", "Wk", "Wv", "Wo"} <= set(tree.keys())
        saw = False
        for pname, v in tree.items():
            if isinstance(v, dict):
                out[pname] = walk(v)
            else:
                spec, matrix = leaf_spec(pname, v, attn, parity[0])
                out[pname] = spec
                saw = saw or (matrix and not attn)
        if attn:
            parity[0] = (parity[0] // 2 + 1) * 2
        elif saw:
            parity[0] += 1
        return out

    return {lname: walk(lparams) for lname, lparams in params.items()}


def _sharded_dim(spec, axis: str) -> Optional[int]:
    for d, e in enumerate(spec):
        if e == axis:
            return d
    return None


def slot_view(t, spec, tp: int, axis: str = AXIS_MODEL):
    """``t`` as its model slots' ``[tp, ...]`` stack (a view), or ``t``
    when ``spec`` shards nothing."""
    d = _sharded_dim(spec, axis)
    if d is None or tp == 1:
        return t
    shape = tuple(t.shape)
    return t.view(shape[:d] + (tp, shape[d] // tp) + shape[d + 1:]) \
        .movedim(d, 0)


def _zip(fn, tree, specs):
    """``fn(leaf, spec)`` over ``tree``; a subtree ``specs`` lacks (the
    updater state's layers are the trainable ones) maps by P()."""
    if isinstance(tree, dict):
        return {k: _zip(fn, v, specs.get(k, {}) if isinstance(specs, dict)
                        else {}) for k, v in tree.items()}
    return fn(tree, specs if isinstance(specs, P) else P())


class TensorParallelTrainingMaster(SyncTrainingMaster):
    """A ``SyncTrainingMaster`` whose parameters live sharded over the
    model axis (module docstring): the data axis splits the batch's rows,
    the model axis every sharded parameter."""

    def __init__(self, mesh=None, **kw):
        if kw.get("update_sharding", zero_mod.REPLICATED) == zero_mod.ZERO:
            raise ValueError(
                "update_sharding='zero' composes only with the base "
                "data-parallel param layout (replicated); "
                "TensorParallelTrainingMaster overrides it")
        mesh = mesh or mesh_mod.default_mesh()
        # the sync master's cross-process path is not this layout's
        mesh_mod.across_processes(
            "TensorParallelTrainingMaster (tensor and expert parallelism)",
            mesh_mod.A14B, mesh)
        super().__init__(mesh=mesh, **kw)
        if AXIS_MODEL not in self.mesh.shape:
            raise ValueError("mesh needs a model axis (default_mesh(model=N))")
        self.tp = self.mesh.shape[AXIS_MODEL]
        self._specs = None

    def _model_slots(self):
        return slots.model_slots(self.tp)

    def _specs_of(self, net):
        if self._specs is None or self._specs[0] is not net.params:
            self._specs = (net.params,
                           tensor_parallel_spec(net.params, self.tp))
        return self._specs[1]

    def _full(self, params):
        """The step's leaves as the layers read them: each sharded leaf
        as its model slots' ``[tp, ...]`` stack, a view, so its gradient
        and its update land in the net's own tensor, whole (the updater
        is per element, and a per-layer norm reads every slot's
        squares)."""
        return _zip(lambda t, spec: slot_view(t, spec, self.tp), params,
                    self._specs_of(self.net_))

    def _ledger_trees(self, net):
        """Params and inner updater slots by their model-axis specs (each
        slot holds one block), the rest replicated."""
        mesh = self.mesh
        specs = self._specs_of(net)

        def laid(t, spec):
            if _sharded_dim(spec, AXIS_MODEL) is None or self.tp == 1:
                return Sharded(t, P(), mesh, t.shape)
            return Sharded(slot_view(t, spec, self.tp), spec, mesh, t.shape)

        rep = lambda a: Sharded(a, P(), mesh, a.shape)  # noqa: E731
        return {"params": _zip(laid, net.params, specs),
                "updater_state": {
                    slot: (_zip(laid, tree, {}) if slot in
                           shardstats.RESERVED_REPLICATED_SUBTREES
                           else _zip(laid, tree, specs))
                    for slot, tree in net.updater_state.items()},
                "net_state": _zip(lambda a, _: rep(a), net.net_state, {})}
