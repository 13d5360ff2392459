"""MultiLayerNetwork — counterpart of ``deeplearning4j_tpu/models/sequential.py``.

Ported: ``init``, the forward with carries (``_forward``) and ``output``.
Params live in a nested dict ``{layer name: {param name: tensor}}`` with
the reference's names and layouts, on ``self.device``.  With a
``compute_dtype`` the forward runs in that dtype on a cast copy of the
float32 params, as the reference's mixed-precision policy does.
``fit``, ``score`` and ``rnn_time_step`` come with later slices.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.backend.device import (
    DeviceLike, compute_dtype, resolve_device,
)
from deeplearning4j_tpu_torch.backend.rng import KeyStream
from deeplearning4j_tpu_torch.nn import activations
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.layers.base import Layer
from deeplearning4j_tpu_torch.nn.layers.dense import OutputLayer


def cast_tree(tree, dtype: torch.dtype):
    """Cast every floating tensor of a nested dict to ``dtype`` (a tensor
    already in ``dtype`` is returned as it is, not copied)."""
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype) for k, v in tree.items()}
    if torch.is_tensor(tree) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


class MultiLayerNetwork:
    def __init__(self, conf: MultiLayerConfiguration):
        self.conf = conf
        self.layers: Tuple[Layer, ...] = conf.layers
        self.params: Dict[str, Dict[str, Any]] = {}
        self.device: Optional[torch.device] = None
        self._keys = KeyStream(conf.seed)

    def init(self, device: DeviceLike = None,
             dtype=torch.float32) -> "MultiLayerNetwork":
        """Seeded parameters on ``device`` (``cuda`` unless told
        otherwise)."""
        dev = resolve_device(device)
        self.params = {
            layer.name: (layer.init(self._keys.next(), dtype, dev)
                         if layer.has_params() else {})
            for layer in self.layers}
        self.device = dev
        return self

    def compute_params(self):
        """The params as the forward uses them: cast to the compute dtype
        (the same tensors when there is none)."""
        return cast_tree(self.params, compute_dtype(self.conf.compute_dtype))

    def _forward(self, params, x, *, carries=None):
        """Forward through every layer; the output layer stops at its
        pre-activation.  Carry-capable layers (attention, residual
        blocks) take their carry from ``carries`` by layer name.
        Returns (pre_output, new_carries)."""
        cd = self.conf.compute_dtype
        if cd is not None:
            dt = compute_dtype(cd)
            params = cast_tree(params, dt)
            x = cast_tree(x, dt)
        new_carries = {}
        h = x
        for layer in self.layers:
            p = params[layer.name]
            if hasattr(layer, "apply_with_carry"):
                h, nc = layer.apply_with_carry(
                    p, h, (carries or {}).get(layer.name))
                new_carries[layer.name] = nc
            elif isinstance(layer, OutputLayer):
                h = layer.pre_output(p, h)
            else:
                h = layer.apply(p, h)
        return h, new_carries

    def output(self, x) -> torch.Tensor:
        """Inference forward; float32 at the API boundary."""
        x = torch.as_tensor(x, device=self.device)
        pre, _ = self._forward(self.params, x)
        return activations.get(self.layers[-1].activation)(pre.float())
