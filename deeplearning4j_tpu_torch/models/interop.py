"""Weights, layer state and updater state carried across from the JAX
package.

``params_from_numpy(conf, tree)`` builds the port's network from the
reference's parameter pytree as numpy arrays — what
``jax.device_get(net.params)`` returns, or a ``coefficients.npz`` read
back into nested dicts; ``graph_params_from_numpy`` does the same for a
``GraphConfiguration``.  ``net_state_from_numpy`` reads the layers'
state (BatchNorm's running stats, ``netState.npz``) and
``updater_state_from_numpy(net, tree)`` the updater's trees
(``updaterState.npz``), for either facade.  Names and layouts are the
same on both sides (``[n_in, n_out]`` kernels used as ``x @ W``, HWIO
conv kernels), so nothing is transposed; every name and shape is
checked.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.backend.device import DeviceLike, resolve_device
from deeplearning4j_tpu_torch.models.sequential import MultiLayerNetwork
from deeplearning4j_tpu_torch.observability import introspection, numerics
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.optimize import updaters as upd

# of the updater state's reserved subtrees (``updaters.RESERVED_KEYS``)
# the stability guard's is carried across, and the introspection and
# numerics vectors where the configuration sets their policy
STABILITY_KEY = "__stability__"
_OBSERVED = {introspection.STATE_KEY: "introspection",
             numerics.STATE_KEY: "numerics"}


def _convert(want: Mapping[str, Any], got: Mapping[str, Any], path: str,
             device: torch.device):
    if set(want) != set(got):
        raise ValueError(f"{path}: expected params {sorted(want)}, got "
                         f"{sorted(got)}")
    out = {}
    for name, shape in want.items():
        where = f"{path}/{name}"
        if isinstance(shape, dict):
            out[name] = _convert(shape, got[name], where, device)
            continue
        a = np.asarray(got[name])
        if tuple(a.shape) != tuple(shape):
            raise ValueError(f"{where}: expected shape {tuple(shape)}, got "
                             f"{tuple(a.shape)}")
        out[name] = torch.tensor(a, dtype=torch.float32, device=device)
    return out


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape)


def updater_state_from_numpy(net, tree: Mapping[str, Any]) -> dict:
    """The updater state of ``tree`` ({slot: {layer: {param: array}}}) as
    float32 tensors on ``net.device``, checked against ``net``'s updater
    and trainable params.  The stability guard's scalars
    (``__stability__``: loss scale, growth streak, LR multiplier,
    non-finite count) come across as float32 scalars; the introspection
    and numerics vectors (``packed``) where the net's configuration sets
    that policy, else they are skipped."""
    slots = upd.state_slots(net.conf.updater)
    got = upd.inner_state(tree)
    if set(got) != set(slots):
        raise ValueError(f"updater '{net.conf.updater.name}' keeps state "
                         f"{sorted(slots)}, got {sorted(got)}")
    want = _shapes(net._trainable(net.params))
    out = {slot: _convert(want, got[slot], slot, net.device)
           for slot in slots}
    stab = tree.get(STABILITY_KEY)
    if stab:
        out[STABILITY_KEY] = {
            k: torch.tensor(np.asarray(v), dtype=torch.float32,
                            device=net.device).reshape(())
            for k, v in stab.items()}
    for key, policy in _OBSERVED.items():
        sub = tree.get(key)
        if (isinstance(sub, Mapping) and "packed" in sub
                and getattr(net.conf, policy, None) is not None):
            out[key] = {"packed": torch.tensor(
                np.asarray(sub["packed"]), dtype=torch.float32,
                device=net.device)}
    return out


def net_state_from_numpy(layers, tree: Optional[Mapping[str, Any]],
                         device: torch.device) -> dict:
    """The state of the stateful ``layers`` from ``tree`` ({layer name:
    {state name: array}}) as float32 tensors on ``device``; every
    stateful layer must be there, with its names and shapes, and no
    other.  ``tree=None`` gives each layer its initial state."""
    want = {layer.name: _shapes(layer.init_state()) for layer in layers
            if layer.init_state()}
    if tree is None:
        return {layer.name: layer.init_state(device) for layer in layers
                if layer.name in want}
    if set(tree) != set(want):
        raise ValueError(f"net state: expected layers {sorted(want)}, got "
                         f"{sorted(tree)}")
    return {name: _convert(shapes, tree[name], name, device)
            for name, shapes in want.items()}


def _place(net, layers, tree, net_state, dev):
    net.params = {
        layer.name: _convert(
            layer.param_shapes() if layer.has_params() else {},
            tree.get(layer.name, {}), layer.name, dev)
        for layer in layers}
    net.net_state = net_state_from_numpy(layers, net_state, dev)
    net.device = dev
    net.updater_state = upd.init_state(net.conf.updater,
                                       net._trainable(net.params))
    return net


def params_from_numpy(conf: MultiLayerConfiguration,
                      tree: Mapping[str, Any],
                      device: DeviceLike = None,
                      net_state: Optional[Mapping[str, Any]] = None
                      ) -> MultiLayerNetwork:
    """The port's network for ``conf`` holding the weights of ``tree``
    ({layer name: {param name: array}}, nested for composite layers) and
    the layer state of ``net_state`` as float32 tensors on ``device``."""
    return _place(MultiLayerNetwork(conf), conf.layers, tree, net_state,
                  resolve_device(device))


def graph_params_from_numpy(conf, params: Mapping[str, Any],
                            net_state: Optional[Mapping[str, Any]] = None,
                            device: DeviceLike = None):
    """The port's ``ComputationGraph`` for ``conf`` (a
    ``GraphConfiguration``) holding the weights of ``params`` ({node
    name: {param name: array}}; vertices and parameterless layers may be
    absent or empty) and the layer state of ``net_state``."""
    from deeplearning4j_tpu_torch.models.graph import ComputationGraph

    net = ComputationGraph(conf)
    extra = set(params) - {n.name for n in conf.nodes}
    if extra:
        raise ValueError(f"params for unknown nodes {sorted(extra)}")
    for n in conf.nodes:
        if n.layer is None and params.get(n.name):
            raise ValueError(f"vertex {n.name} has no params, got "
                             f"{sorted(params[n.name])}")
    _place(net, net.layers, params, net_state, resolve_device(device))
    net.params = {n.name: net.params.get(n.name, {}) for n in conf.nodes}
    return net


def stacked_from_numpy(tree: Mapping[str, Any], device: DeviceLike = None):
    """A JAX ``ParallelWrapper``'s stacked replica tree (``[K, ...]``
    leaves as numpy arrays, ``jax.device_get`` of its staged trees) as
    the port's stacked float32 tensors on ``device``: the same layout,
    the wrapper's ``[K, ...]`` stacks."""
    dev = resolve_device(device)

    def one(v):
        if isinstance(v, Mapping):
            return {k: one(x) for k, x in v.items()}
        return torch.tensor(np.asarray(v), dtype=torch.float32, device=dev)

    return one(tree)


def zero_blocks_from_numpy(tree: Mapping[str, Any], k: int,
                           device: DeviceLike = None):
    """A ZeRO layout's leaves (each the whole array, as ``np.asarray`` of
    a JAX leaf sharded ``P('data')`` gives it) as the port's ``[K, n/K,
    ...]`` blocks on ``device``; a leaf whose leading dimension does not
    divide by ``k`` stays whole (replicated), as both layouts keep it."""
    from deeplearning4j_tpu_torch.observability.shardstats import (
        zero_shardable,
    )

    dev = resolve_device(device)

    def one(v):
        if isinstance(v, Mapping):
            return {n: one(x) for n, x in v.items()}
        a = np.asarray(v, dtype=np.float32)
        if zero_shardable(a.shape, k):
            a = a.reshape((k, a.shape[0] // k) + a.shape[1:])
        return torch.tensor(a, device=dev)

    return one(tree)
