"""Dense, Output, Activation, Dropout and Embedding layers — counterpart of
``deeplearning4j_tpu/nn/layers/dense.py`` (params ``W`` [n_in, n_out], ``b``).

``x @ W`` promotes x and W to a common type first, as ``jnp`` does: a
float32 activation meets bfloat16 weights where a float32 BatchNorm
inference output (running stats are float32) feeds the head."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from deeplearning4j_tpu_torch.backend import slots
from deeplearning4j_tpu_torch.nn import activations, initializers, losses
from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import Layer, register_layer


_matmul = slots.matmul


@register_layer
@dataclasses.dataclass(frozen=True)
class DenseLayer(Layer):
    n_in: Optional[int] = None
    n_out: Optional[int] = None
    _SUPPORTS_DROP_CONNECT = True  # apply() masks W via maybe_drop_connect
    _SLOT_AWARE = True

    def slot_aware(self) -> bool:
        # DropConnect draws its mask at the whole weight's shape
        return not (self.drop_connect and self.dropout > 0.0)

    def slot_reads_blocks(self, params) -> bool:
        # a row-parallel product reads its input's feature blocks
        return slots.sharded_dim(params.get("W"),
                                 (self.n_in, self.n_out)) == 0

    def setup(self, input_type: InputType) -> "DenseLayer":
        if self.n_in is None:
            return dataclasses.replace(self, n_in=input_type.flat_size())
        return self

    def output_type(self, input_type: InputType) -> InputType:
        if input_type.kind == "rnn":
            return InputType.recurrent(self.n_out, input_type.timesteps)
        return InputType.feed_forward(self.n_out)

    def param_shapes(self):
        return {"W": (self.n_in, self.n_out), "b": (self.n_out,)}

    def init(self, gen, dtype=torch.float32, device=None):
        w = initializers.init(
            self.weight_init, gen, (self.n_in, self.n_out), dtype, device,
            distribution=initializers.distribution_from_dict(self.dist))
        b = torch.full((self.n_out,), self.bias_init, dtype=dtype,
                       device=device)
        return {"W": w, "b": b}

    def apply(self, params, x, *, train=False, rng=None):
        x = self.maybe_dropout(x, train=train, rng=rng)
        w = self.maybe_drop_connect(params["W"], train=train, rng=rng)
        z = slots.linear(x, w, self.n_in, self.n_out) + params["b"]
        return activations.get(self.activation)(
            slots.before_activation(self.activation, z))

    def pre_output(self, params, x):
        """``x @ W + b``; under the model slots W may be held column- or
        row-parallel (``backend.slots.linear``)."""
        return slots.linear(x, params["W"], self.n_in, self.n_out) \
            + params["b"]


@register_layer
@dataclasses.dataclass(frozen=True)
class OutputLayer(DenseLayer):
    """Dense + loss head.  The network stops at ``pre_output`` and scores
    it with ``loss`` (a name in ``nn/losses.py``) in float32, or applies
    ``activation`` at its inference boundary."""

    loss: str = "mcxent"
    activation: str = "softmax"

    def validate(self) -> None:
        super().validate()
        losses.get(self.loss)
        if self.loss == "mcxent" and self.activation == "sigmoid":
            import warnings

            # mcxent lacks the (1-y)log(1-p) term: with independent sigmoid
            # outputs it is minimised by saturating every unit to 1
            warnings.warn(
                "OutputLayer: loss 'mcxent' with activation 'sigmoid' "
                "degenerates (all outputs ->1). Use activation='softmax' "
                "for classification or loss='xent' for multi-label.",
                stacklevel=2)

    def score(self, params, x, labels, mask=None):
        pre = self.pre_output(params, x)
        return losses.score(self.loss, labels, pre, self.activation, mask)


@register_layer
@dataclasses.dataclass(frozen=True)
class ActivationLayer(Layer):
    """Activation alone (reference ``nn/conf/layers/ActivationLayer``)."""

    _SLOT_ELEMENTWISE = True

    def output_type(self, input_type: InputType) -> InputType:
        return input_type

    def has_params(self) -> bool:
        return False

    def param_shapes(self):
        return {}

    def init(self, gen, dtype=torch.float32, device=None):
        return {}

    def apply(self, params, x, *, train=False, rng=None):
        return activations.get(self.activation)(
            slots.before_activation(self.activation, x))


@register_layer
@dataclasses.dataclass(frozen=True)
class DropoutLayer(Layer):
    """Dropout alone (reference ``DropoutLayer``): ``maybe_dropout`` on its
    input at train time, the identity at inference."""

    _SLOT_ELEMENTWISE = True

    def output_type(self, input_type: InputType) -> InputType:
        return input_type

    def has_params(self) -> bool:
        return False

    def param_shapes(self):
        return {}

    def init(self, gen, dtype=torch.float32, device=None):
        return {}

    def apply(self, params, x, *, train=False, rng=None):
        return self.maybe_dropout(x, train=train, rng=rng)


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
    _SLOT_AWARE = True

    param_shapes = DenseLayer.param_shapes
    init = DenseLayer.init

    def apply(self, params, x, *, train=False, rng=None):
        idx = x.to(torch.int64)
        if self.collapse_column and idx.ndim >= 2 and idx.shape[-1] == 1:
            idx = idx[..., 0]
        w = params["W"]
        d = slots.sharded_dim(w, (self.n_in, self.n_out))
        if d == 1:
            # each model slot looks its feature block up, the blocks side
            # by side
            z = slots.mark_sharded(slots.blocks_side_by_side(w, 1)[idx]) \
                + params["b"]
        elif d == 0:
            # each slot holds a vocab block: its ids' rows, zeros for the
            # others' ids, psum'd
            n, vb = w.shape[0], w.shape[1]
            local = idx[None] - vb * torch.arange(
                n, device=idx.device).reshape((n,) + (1,) * idx.ndim)
            hit = (local >= 0) & (local < vb)
            rows = w[torch.arange(n, device=idx.device).reshape(
                (n,) + (1,) * idx.ndim), local.clamp(0, vb - 1)]
            z = slots.psum(rows * hit[..., None].to(rows.dtype)) \
                + params["b"]
        else:
            z = w[idx] + params["b"]
        return activations.get(self.activation)(z)
