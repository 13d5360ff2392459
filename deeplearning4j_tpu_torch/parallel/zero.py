"""ZeRO-style cross-replica sharding of the weight update — the port's
counterpart of ``deeplearning4j_tpu/parallel/zero.py`` (arXiv
2004.13336: reduce-scatter the gradients, let each replica update only
its 1/K shard of the parameters and optimizer state, all-gather the
parameters for the next forward).

Over a slot mesh (``backend.mesh``) a ZeRO leaf of shape ``[n, ...]``
is laid out ``[K, n/K, ...]``: slot k's block is ``leaf[k]``, and the
persistent state holds one copy in all instead of one a replica.  A leaf
whose leading dimension does not divide by K, and the reserved
``__stability__`` / ``__introspect__`` / ``__numerics__`` subtrees, stay
replicated (``shardstats.zero_shardable``, the one owner of the
predicate, so the ledger's projection and this layout are held to each
other).

The tree collectives are the slot collectives of ``backend.mesh``:
``all_gather_tree`` (blocks -> whole leaves: a view on one device),
``reduce_scatter_tree`` (per-slot contributions ``[K, n, ...]`` -> summed
blocks) and ``all_to_all_tree`` (every replica's whole gradient -> each
owner's ``[K(replica), n/K, ...]`` pieces; the wrapper needs each
replica's own gradient per shard, because it averages per-replica Adam
updates, which are nonlinear in them), and the introspection packing of
a ZeRO window (``pack_introspection``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from deeplearning4j_tpu_torch.backend import mesh as mesh_mod
from deeplearning4j_tpu_torch.backend.mesh import AXIS_DATA, P, Sharded
from deeplearning4j_tpu_torch.observability.shardstats import (
    RESERVED_REPLICATED_SUBTREES, zero_shardable,
)

REPLICATED = "replicated"
ZERO = "zero"
MODES = (REPLICATED, ZERO)

AXIS = AXIS_DATA


def validate_mode(update_sharding: str, mesh) -> str:
    """An ``update_sharding=`` argument checked against the mesh (the
    reference's rules: ZeRO needs a pure data-parallel mesh of at least
    two slots)."""
    if update_sharding not in MODES:
        raise ValueError(
            f"update_sharding must be one of {MODES}, "
            f"got {update_sharding!r}")
    if update_sharding == ZERO:
        extra = mesh.axis_size(tuple(a for a in (mesh_mod.AXIS_MODEL,
                                                 mesh_mod.AXIS_SEQ)
                                     if a in mesh.shape))
        if extra != 1:
            raise ValueError(
                "update_sharding='zero' needs a pure data-parallel mesh "
                f"(model*seq axes must be 1, got {extra})")
        if mesh.shape[AXIS] < 2:
            raise ValueError(
                "update_sharding='zero' needs a data axis of at least 2 "
                f"devices (got {mesh.shape[AXIS]}) — on one device there "
                "is nothing to shard")
    return update_sharding


def no_norm(cfg):
    """``cfg`` with gradient normalization off: the ZeRO paths normalize
    each replica's whole gradient before it is scattered, so the sharded
    elementwise updater must not normalize again on shard norms."""
    if cfg.gradient_normalization == "none":
        return cfg
    return dataclasses.replace(cfg, gradient_normalization="none")


def _map(fn, *trees):
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in t0}
    return fn(*trees)


class ZeroLayout:
    """Per-leaf ZeRO decisions over the mesh's data axis."""

    def __init__(self, mesh, k: Optional[int] = None):
        self.mesh = mesh
        self.k = int(k if k is not None else mesh.shape[AXIS])

    def shardable(self, leaf) -> bool:
        return zero_shardable(getattr(leaf, "shape", ()), self.k)

    def mask(self, tree):
        """Which leaves shard, from the whole (logical) shapes."""
        return _map(self.shardable, tree)

    def block(self, leaf: torch.Tensor) -> torch.Tensor:
        """A whole leaf in its layout: ``[K, n/K, ...]`` blocks (a copy)
        or the leaf itself (replicated)."""
        if not self.shardable(leaf):
            return leaf.clone()
        return leaf.reshape((self.k, leaf.shape[0] // self.k)
                            + tuple(leaf.shape[1:])).clone()

    def place(self, tree):
        """A whole tree laid out (copies)."""
        return _map(self.block, tree)

    def place_updater(self, upd_state, reserved_place=None):
        """An updater-state tree laid out: the inner slots take the ZeRO
        layout, the reserved subtrees ``reserved_place(subtree)`` (the
        wrapper stacks them a replica) or a copy."""
        out = {}
        for slot, tree in upd_state.items():
            if slot in RESERVED_REPLICATED_SUBTREES:
                out[slot] = (reserved_place(tree) if reserved_place
                             else _map(torch.clone, tree))
            else:
                out[slot] = self.place(tree)
        return out

    def as_sharded(self, laid, logical):
        """``laid`` (this layout's tensors) as ``Sharded`` leaves of the
        ``logical`` tree's shapes, for the ledger and the checkpoint."""
        def one(t, ref):
            if self.shardable(ref):
                return Sharded(t, P(AXIS), self.mesh, ref.shape)
            return Sharded(t, P(), self.mesh, ref.shape)

        return _map(one, laid, logical)

    def notes(self) -> Dict[str, Any]:
        """The ledger's record of this layout."""
        return {"update_sharding": ZERO, "data_axis_size": self.k,
                "reserved_subtrees": {
                    k: "replicated" for k in RESERVED_REPLICATED_SUBTREES}}


# ------------------------------------------------------- tree collectives
def all_gather_tree(blocks, mask):
    """Blocks -> whole leaves (the pre-forward gather); replicated
    leaves pass through."""
    return _map(lambda m, b: mesh_mod.all_gather(b) if m else b, mask,
                blocks)


def reduce_scatter_tree(stacked, k: int):
    """Per-slot contributions ``[K, n, ...]`` -> summed blocks
    ``[K, n/K, ...]``; a leaf that does not divide is summed whole
    (all-reduce) and stays replicated."""
    def rs(leaf):
        if zero_shardable(leaf.shape[1:], k):
            return mesh_mod.psum_scatter(leaf)
        return mesh_mod.psum(leaf)

    return _map(rs, stacked)


def all_to_all_tree(stacked, k: int):
    """Every replica's whole gradient, stacked ``[K(replica), n, ...]``
    -> each owner's pieces: a shardable leaf comes back ``[K(owner),
    K(replica), n/K, ...]``, the owner's block of every replica's
    gradient; a leaf that does not divide is gathered whole to every
    slot (``[K(replica), n, ...]``, which each slot reads)."""
    def a2a(leaf):
        if zero_shardable(leaf.shape[1:], k):
            # replica r's rows split into K owners' pieces; owner j
            # receives piece j of every replica, in replica order: on one
            # device a view of the stack, [K(owner), K(replica), n/K, ...]
            mesh_mod.note("all-to-all", leaf, k)
            return leaf.reshape((k, k, leaf.shape[1] // k)
                                + tuple(leaf.shape[2:])).transpose(0, 1)
        return mesh_mod.all_gather(leaf, tiled=False)

    return _map(a2a, stacked)


# --------------------------------------------------- introspection packing
def _sq_sum(tree) -> torch.Tensor:
    total = None
    for t in _leaves(tree):
        s = t.float().pow(2).sum()
        total = s if total is None else total + s
    return total if total is not None else torch.zeros(())


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [] if tree is None else [tree]


def tree_norms(plan, tree) -> torch.Tensor:
    """Per-layer L2 norms ``[L]`` in ``plan.grad_names`` order; over the
    blocks of a sharded tree they are the whole layer's."""
    return torch.stack([torch.sqrt(_sq_sum(tree.get(name, {})))
                        for name in plan.grad_names])


def update_delta_norms(plan, old_params, new_params) -> torch.Tensor:
    """Per-layer L2 norms of ``old - new`` (the applied update)."""
    return torch.stack([
        torch.sqrt(_sq_sum(_map(lambda o, n: o.float() - n.float(),
                                old_params[name], new_params[name])))
        for name in plan.grad_names])


def pack_introspection(plan, iteration, grad_norms_k, update_norm,
                       param_norm, act_stats_k=None):
    """The stacked ``[K, N]`` ``__introspect__`` vector of a ZeRO window
    (reference ``pack_introspection``): per-replica gradient norms, the
    shared update and parameter norms, per-replica activation stats."""
    K = grad_norms_k.shape[0]
    it = torch.as_tensor(iteration, dtype=torch.float32,
                         device=grad_norms_k.device).reshape(1, 1)
    parts = [it.expand(K, 1), grad_norms_k,
             update_norm[None, :].expand_as(grad_norms_k),
             param_norm[None, :].expand_as(grad_norms_k)]
    if plan.act_names:
        if act_stats_k is None:
            raise ValueError(
                "plan collects activations but no act_stats were passed")
        parts += [act_stats_k["act_mean"], act_stats_k["act_std"],
                  act_stats_k["act_zero"]]
    return {"packed": torch.cat(parts, dim=1)}
