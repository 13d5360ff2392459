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
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.optimize import updaters as upd

# updater-state subtrees of the reference's training engines (stability
# guard, introspection, numerics ledger); read and ignored until those
# engines are ported
RESERVED_STATE_KEYS = ("__stability__", "__introspect__", "__numerics__")


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
    and trainable params.  The reserved subtrees are skipped."""
    slots = upd.state_slots(net.conf.updater)
    got = {k: v for k, v in tree.items() if k not in RESERVED_STATE_KEYS}
    if set(got) != set(slots):
        raise ValueError(f"updater '{net.conf.updater.name}' keeps state "
                         f"{sorted(slots)}, got {sorted(got)}")
    want = _shapes(net._trainable(net.params))
    return {slot: _convert(want, got[slot], slot, net.device)
            for slot in slots}


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
