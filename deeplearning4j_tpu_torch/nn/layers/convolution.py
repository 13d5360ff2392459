"""Convolution and pooling layers — counterpart of
``deeplearning4j_tpu/nn/layers/convolution.py``.

Activations stay NHWC and conv kernels HWIO, as in the reference, so
weights carry across untransposed.  The convolution is one
``F.conv2d`` on the permuted views: an NHWC tensor seen as NCHW is
channels_last in memory, so cuDNN runs its NHWC kernels on it and the
output, permuted back, is NHWC again with no layout copy.  Pooling is
``F.max_pool2d``/``F.avg_pool2d`` on the same views.  Convolutions and
pooling were XLA in the reference; here they are cuDNN, and no
hand-written kernel is asked for them.

Padding follows the reference: explicit (ph, pw), max pooling pads with
-inf, average pooling divides by kh·kw with the padding counted, sum
pooling is the average times kh·kw.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.backend import slots
from deeplearning4j_tpu_torch.nn import activations, initializers
from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import Layer, register_layer


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (list, tuple)):
        return (int(v[0]), int(v[1]))
    return (int(v), int(v))


def _out_size(size, k, s, p):
    return (size + 2 * p - k) // s + 1


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


class _Windowed:
    """kernel_size / stride / padding normalised to pairs (lists from
    JSON become tuples, so a config equals its round trip)."""

    def __post_init__(self):
        for f in ("kernel_size", "stride", "padding"):
            object.__setattr__(self, f, _pair(getattr(self, f)))

    def _spatial_out(self, input_type: InputType):
        (kh, kw), (sh, sw), (ph, pw) = self.kernel_size, self.stride, \
            self.padding
        return (_out_size(input_type.height, kh, sh, ph),
                _out_size(input_type.width, kw, sw, pw))


@register_layer
@dataclasses.dataclass(frozen=True)
class ConvolutionLayer(_Windowed, Layer):
    n_in: Optional[int] = None    # input channels (inferred)
    n_out: Optional[int] = None   # output channels
    kernel_size: Tuple[int, int] = (5, 5)
    stride: Tuple[int, int] = (1, 1)
    padding: Tuple[int, int] = (0, 0)
    activation: str = "identity"
    weight_init: str = "xavier"
    _SLOT_AWARE = True

    def setup(self, input_type: InputType) -> "ConvolutionLayer":
        if self.n_in is None:
            if input_type.kind not in ("cnn", "cnn_flat"):
                raise ValueError(
                    f"ConvolutionLayer expects CNN input, got {input_type}")
            return dataclasses.replace(self, n_in=input_type.channels)
        return self

    def output_type(self, input_type: InputType) -> InputType:
        h, w = self._spatial_out(input_type)
        if h <= 0 or w <= 0:
            raise ValueError(
                f"Conv output size {h}x{w} invalid for input "
                f"{input_type.height}x{input_type.width} kernel "
                f"{self.kernel_size} stride {self.stride} pad {self.padding}")
        return InputType.convolutional(h, w, self.n_out)

    def param_shapes(self):
        kh, kw = self.kernel_size
        return {"W": (kh, kw, self.n_in, self.n_out), "b": (self.n_out,)}

    def init(self, gen, dtype=torch.float32, device=None):
        w = initializers.init(
            self.weight_init, gen, self.param_shapes()["W"], dtype, device,
            distribution=initializers.distribution_from_dict(self.dist))
        b = torch.full((self.n_out,), self.bias_init, dtype=dtype,
                       device=device)
        return {"W": w, "b": b}

    def apply(self, params, x, *, train=False, rng=None):
        x = self.maybe_dropout(x, train=train, rng=rng)
        w = params["W"]
        if slots.sharded_dim(w, self.param_shapes()["W"]) == 3:
            # each model slot's output-channel block, the blocks side by
            # side on the channel axis
            w = slots.mark_sharded(slots.blocks_side_by_side(w, 3))
        z = F.conv2d(_nchw(x.to(w.dtype)), w.permute(3, 2, 0, 1),
                     params["b"], stride=self.stride, padding=self.padding)
        return activations.get(self.activation)(_nhwc(z))


@register_layer
@dataclasses.dataclass(frozen=True)
class SubsamplingLayer(_Windowed, Layer):
    """Pooling (reference ``SubsamplingLayer.java``: MAX/AVG/SUM)."""

    pooling_type: str = "max"  # max | avg | sum
    kernel_size: Tuple[int, int] = (2, 2)
    stride: Tuple[int, int] = (2, 2)
    padding: Tuple[int, int] = (0, 0)
    activation: str = "identity"

    def has_params(self) -> bool:
        return False

    def param_shapes(self):
        return {}

    def init(self, gen, dtype=torch.float32, device=None):
        return {}

    def output_type(self, input_type: InputType) -> InputType:
        h, w = self._spatial_out(input_type)
        return InputType.convolutional(h, w, input_type.channels)

    def apply(self, params, x, *, train=False, rng=None):
        k, s, p = self.kernel_size, self.stride, self.padding
        pt = self.pooling_type.lower()
        if pt not in ("max", "avg", "mean", "sum"):
            raise ValueError(f"Unknown pooling type {self.pooling_type}")
        v = _nchw(x)
        if 2 * p[0] > k[0] or 2 * p[1] > k[1]:
            # wider than half a window: PyTorch's pooling refuses it, so
            # pad explicitly with what the reference pads with
            fill = float("-inf") if pt == "max" else 0.0
            v = F.pad(v, (p[1], p[1], p[0], p[0]), value=fill)
            p = (0, 0)
        if pt == "max":
            y = F.max_pool2d(v, k, s, p)
        else:
            y = F.avg_pool2d(v, k, s, p, count_include_pad=True)
            if pt == "sum":
                y = y * float(k[0] * k[1])
        return _nhwc(y)


@register_layer
@dataclasses.dataclass(frozen=True)
class GlobalPoolingLayer(Layer):
    """Global spatial (or temporal) pooling: [B,H,W,C] -> [B,C] or
    [B,T,F] -> [B,F]; with a [B,T] mask a rank-3 input pools over the
    unmasked steps only."""

    pooling_type: str = "avg"  # avg | max | sum
    _TAKES_MASK = True

    def has_params(self) -> bool:
        return False

    def param_shapes(self):
        return {}

    def init(self, gen, dtype=torch.float32, device=None):
        return {}

    def output_type(self, input_type: InputType) -> InputType:
        if input_type.kind == "cnn":
            return InputType.feed_forward(input_type.channels)
        return InputType.feed_forward(input_type.size)

    def apply(self, params, x, *, train=False, rng=None, mask=None):
        axes = tuple(range(1, x.ndim - 1))
        pt = self.pooling_type.lower()
        if mask is not None and x.ndim == 3:
            m = mask[..., None].to(x.dtype)
            if pt in ("avg", "mean"):
                return (x * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0)
            if pt == "max":
                neg = torch.full((), float("-inf"), dtype=x.dtype,
                                 device=x.device)
                return torch.where(m > 0, x, neg).amax(dim=1)
            if pt == "sum":
                return (x * m).sum(dim=1)
        if pt in ("avg", "mean"):
            return x.mean(dim=axes)
        if pt == "max":
            return x.amax(dim=axes)
        if pt == "sum":
            return x.sum(dim=axes)
        raise ValueError(f"Unknown pooling type {self.pooling_type}")
