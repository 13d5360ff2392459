"""LayerNorm — counterpart of ``deeplearning4j_tpu/nn/layers/normalization.py``
(``LayerNorm`` only; BatchNorm and LRN come with the conv-zoo slice)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn import activations
from deeplearning4j_tpu_torch.nn.layers.base import Layer, register_layer


@register_layer
@dataclasses.dataclass(frozen=True)
class LayerNorm(Layer):
    """Per-example normalization over the trailing feature axis:
    ``gamma * (x - mean) / sqrt(var + eps) + beta`` with the biased
    variance, as the reference."""

    n_in: Optional[int] = None
    eps: float = 1e-5
    activation: str = "identity"

    def param_shapes(self):
        return {"gamma": (self.n_in,), "beta": (self.n_in,)}

    def init(self, gen, dtype=torch.float32, device=None):
        return {"gamma": torch.ones((self.n_in,), dtype=dtype, device=device),
                "beta": torch.zeros((self.n_in,), dtype=dtype, device=device)}

    def apply(self, params, x):
        y = F.layer_norm(x, (x.shape[-1],), params["gamma"], params["beta"],
                         self.eps)
        return activations.get(self.activation)(y)
