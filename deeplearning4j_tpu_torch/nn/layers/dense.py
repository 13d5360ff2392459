"""Dense, Output and Embedding layers — counterpart of
``deeplearning4j_tpu/nn/layers/dense.py`` (params ``W`` [n_in, n_out], ``b``)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from deeplearning4j_tpu_torch.nn import activations, initializers
from deeplearning4j_tpu_torch.nn.layers.base import Layer, register_layer


@register_layer
@dataclasses.dataclass(frozen=True)
class DenseLayer(Layer):
    n_in: Optional[int] = None
    n_out: Optional[int] = None

    def param_shapes(self):
        return {"W": (self.n_in, self.n_out), "b": (self.n_out,)}

    def init(self, gen, dtype=torch.float32, device=None):
        w = initializers.init(self.weight_init, gen, (self.n_in, self.n_out),
                              dtype, device)
        b = torch.full((self.n_out,), self.bias_init, dtype=dtype,
                       device=device)
        return {"W": w, "b": b}

    def apply(self, params, x):
        return activations.get(self.activation)(self.pre_output(params, x))

    def pre_output(self, params, x):
        return x @ params["W"] + params["b"]


@register_layer
@dataclasses.dataclass(frozen=True)
class OutputLayer(DenseLayer):
    """Dense + loss head.  Inference stops at ``pre_output``; the network
    applies ``activation`` at its API boundary.  ``loss`` is kept for
    the config round-trip (scoring arrives with the training slice)."""

    loss: str = "mcxent"
    activation: str = "softmax"


@register_layer
@dataclasses.dataclass(frozen=True)
class EmbeddingLayer(Layer):
    """Index lookup: ``W[ids] + b``.  ``collapse_column`` (reference
    default True) reads a [..., 1] input as a column of indices;
    sequence models turn it off so a length-1 sequence keeps its time
    axis.  Configs written before the key existed read back True."""

    n_in: Optional[int] = None   # vocab size
    n_out: Optional[int] = None
    activation: str = "identity"
    collapse_column: bool = True

    param_shapes = DenseLayer.param_shapes
    init = DenseLayer.init

    def apply(self, params, x):
        idx = x.to(torch.int64)
        if self.collapse_column and idx.ndim >= 2 and idx.shape[-1] == 1:
            idx = idx[..., 0]
        z = params["W"][idx] + params["b"]
        return activations.get(self.activation)(z)
