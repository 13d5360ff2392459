"""Weights and updater state carried across from the JAX package.

``params_from_numpy(conf, tree)`` builds the port's network from the
reference's parameter pytree as numpy arrays — what
``jax.device_get(net.params)`` returns, or a ``coefficients.npz`` read
back into nested dicts.  ``updater_state_from_numpy(net, tree)`` does the
same for the updater's trees (``updaterState.npz``).  Names and layouts
are the same on both sides (``[n_in, n_out]`` kernels used as ``x @ W``),
so nothing is transposed; every name and shape is checked.
"""

from __future__ import annotations

from typing import Any, Mapping

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


def updater_state_from_numpy(net: MultiLayerNetwork,
                             tree: Mapping[str, Any]) -> dict:
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


def params_from_numpy(conf: MultiLayerConfiguration,
                      tree: Mapping[str, Any],
                      device: DeviceLike = None) -> MultiLayerNetwork:
    """The port's network for ``conf`` holding the weights of ``tree``
    ({layer name: {param name: array}}, nested for composite layers) as
    float32 tensors on ``device``."""
    dev = resolve_device(device)
    net = MultiLayerNetwork(conf)
    net.params = {
        layer.name: _convert(
            layer.param_shapes() if layer.has_params() else {},
            tree.get(layer.name, {}), layer.name, dev)
        for layer in conf.layers}
    net.device = dev
    net.updater_state = upd.init_state(conf.updater,
                                       net._trainable(net.params))
    return net
