"""Input preprocessors — counterpart of
``deeplearning4j_tpu/nn/preprocessors.py``.

Shape adapters that ``ListBuilder.build`` inserts between layers (or a
user sets with ``input_preprocessor``) and ``MultiLayerNetwork`` applies
before layer ``i``.  Each is a reshape of the leading axes, so its
backward is autograd's; layouts are the reference's (feed-forward
``[B, F]``, recurrent ``[B, T, F]``, convolutional NHWC ``[B, H, W, C]``).
``preproc_from_dict`` reads the reference's JSON dicts and ``to_dict``
writes them back.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Type

from deeplearning4j_tpu_torch.nn.inputs import InputType

_PREPROC_REGISTRY: Dict[str, Type["Preprocessor"]] = {}


def register_preproc(cls):
    _PREPROC_REGISTRY[cls.__name__] = cls
    return cls


def preproc_from_dict(d) -> "Preprocessor":
    d = dict(d)
    type_name = d.pop("type")
    cls = _PREPROC_REGISTRY.get(type_name)
    if cls is None:
        raise ValueError(f"Unknown preprocessor type '{type_name}'; "
                         f"registered: {sorted(_PREPROC_REGISTRY)}")
    return cls(**d)


@dataclasses.dataclass(frozen=True)
class Preprocessor:
    def __call__(self, x):
        raise NotImplementedError

    def output_type(self, input_type: InputType) -> InputType:
        raise NotImplementedError

    def to_dict(self):
        d = dataclasses.asdict(self)
        d["type"] = type(self).__name__
        return d


@register_preproc
@dataclasses.dataclass(frozen=True)
class CnnToFeedForward(Preprocessor):
    """[B, H, W, C] -> [B, H*W*C]."""

    def __call__(self, x):
        return x.reshape(x.shape[0], -1)

    def output_type(self, t: InputType) -> InputType:
        return InputType.feed_forward(t.flat_size())


@register_preproc
@dataclasses.dataclass(frozen=True)
class FeedForwardToCnn(Preprocessor):
    """[B, H*W*C] -> [B, H, W, C]."""

    height: int = 0
    width: int = 0
    channels: int = 1

    def __call__(self, x):
        return x.reshape(x.shape[0], self.height, self.width, self.channels)

    def output_type(self, t: InputType) -> InputType:
        return InputType.convolutional(self.height, self.width, self.channels)


@register_preproc
@dataclasses.dataclass(frozen=True)
class FeedForwardToRnn(Preprocessor):
    """[B, F] -> [B, 1, F]; a rank-3 input passes through."""

    def __call__(self, x):
        return x if x.ndim == 3 else x[:, None, :]

    def output_type(self, t: InputType) -> InputType:
        return InputType.recurrent(t.flat_size(), t.timesteps)


@register_preproc
@dataclasses.dataclass(frozen=True)
class RnnToFeedForward(Preprocessor):
    """[B, T, F] -> [B*T, F]."""

    def __call__(self, x):
        return x.reshape(-1, x.shape[-1])

    def output_type(self, t: InputType) -> InputType:
        return InputType.feed_forward(t.size)


@register_preproc
@dataclasses.dataclass(frozen=True)
class CnnToRnn(Preprocessor):
    """[B, H, W, C] -> [B, 1, H*W*C]."""

    def __call__(self, x):
        return x.reshape(x.shape[0], 1, -1)

    def output_type(self, t: InputType) -> InputType:
        return InputType.recurrent(t.flat_size(), 1)


@register_preproc
@dataclasses.dataclass(frozen=True)
class RnnToCnn(Preprocessor):
    """[B, T, H*W*C] -> [B*T, H, W, C]."""

    height: int = 0
    width: int = 0
    channels: int = 1

    def __call__(self, x):
        return x.reshape(-1, self.height, self.width, self.channels)

    def output_type(self, t: InputType) -> InputType:
        return InputType.convolutional(self.height, self.width, self.channels)


def auto_preprocessor(prev: InputType, layer) -> Optional[Preprocessor]:
    """The adapter between ``prev`` (the previous layer's output type) and
    what ``layer`` takes, or None: the reference's decision table
    (``auto_preprocessor`` in the JAX package).  Shape-preserving layers
    take whatever came before."""
    from deeplearning4j_tpu_torch.nn.layers.convolution import (
        ConvolutionLayer, SubsamplingLayer,
    )
    from deeplearning4j_tpu_torch.nn.layers.dense import (
        ActivationLayer, DropoutLayer,
    )
    from deeplearning4j_tpu_torch.nn.layers.normalization import (
        BatchNormalization, LocalResponseNormalization,
    )
    from deeplearning4j_tpu_torch.nn.layers.recurrent import (
        GravesBidirectionalLSTM, GravesLSTM, RnnOutputLayer,
    )

    if isinstance(layer, (BatchNormalization, LocalResponseNormalization,
                          ActivationLayer, DropoutLayer)):
        return None
    if isinstance(layer, (ConvolutionLayer, SubsamplingLayer)):
        if prev.kind == "cnn":
            return None
        if prev.kind == "cnn_flat":
            return FeedForwardToCnn(prev.height, prev.width, prev.channels)
        raise ValueError(f"Cannot feed {prev} into convolutional layer; use "
                         f"InputType.convolutional_flat for image vectors")
    if isinstance(layer, (GravesLSTM, GravesBidirectionalLSTM,
                          RnnOutputLayer)):
        if prev.kind == "rnn":
            return None
        if prev.kind in ("ff", "cnn_flat"):
            return FeedForwardToRnn()
        if prev.kind == "cnn":
            return CnnToRnn()
    if prev.kind == "cnn":
        return CnnToFeedForward()
    return None
