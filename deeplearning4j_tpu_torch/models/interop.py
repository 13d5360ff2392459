"""Weights carried across from the JAX package.

``params_from_numpy(conf, tree)`` builds the port's network from the
reference's parameter pytree as numpy arrays — what
``jax.device_get(net.params)`` returns, or a ``coefficients.npz`` read
back into nested dicts.  Names and layouts are the same on both sides
(``[n_in, n_out]`` kernels used as ``x @ W``), so nothing is transposed;
every name and shape is checked against the config.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from deeplearning4j_tpu_torch.backend.device import DeviceLike, resolve_device
from deeplearning4j_tpu_torch.models.sequential import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration


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
    return net
