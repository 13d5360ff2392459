"""Graph vertices — counterpart of ``deeplearning4j_tpu/models/vertices.py``.

A vertex is a function of its input activations; its backward is
autograd.  All of the reference's vertices: ``ElementWiseVertex`` (add,
subtract, product, average, max), ``MergeVertex``, ``SubsetVertex``,
``ScaleVertex``, ``LastTimeStepVertex`` (which reads the features mask:
``_TAKES_MASK``), ``DuplicateToTimeSeriesVertex`` and
``PreprocessorVertex``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Type

import torch

from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.nn.preprocessors import preproc_from_dict

_VERTEX_REGISTRY: Dict[str, Type["GraphVertex"]] = {}


def register_vertex(cls):
    _VERTEX_REGISTRY[cls.__name__] = cls
    return cls


def vertex_from_dict(d: Dict[str, Any]) -> "GraphVertex":
    d = dict(d)
    type_name = d.pop("type")
    cls = _VERTEX_REGISTRY.get(type_name)
    if cls is None:
        raise ValueError(f"Unknown vertex type '{type_name}'; registered: "
                         f"{sorted(_VERTEX_REGISTRY)}")
    return cls.from_dict(d)


@dataclasses.dataclass(frozen=True)
class GraphVertex:
    _TAKES_MASK = False        # apply() takes the features ``mask``

    def apply(self, inputs: List[torch.Tensor]) -> torch.Tensor:
        raise NotImplementedError

    def output_type(self, input_types: List[InputType]) -> InputType:
        raise NotImplementedError

    def to_dict(self):
        d = dataclasses.asdict(self)
        d["type"] = type(self).__name__
        return d

    @classmethod
    def from_dict(cls, d):
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


@register_vertex
@dataclasses.dataclass(frozen=True)
class ElementWiseVertex(GraphVertex):
    """Pointwise combine: add | subtract | product | average | max ('add'
    is the residual connection of ResNet)."""

    op: str = "add"

    def apply(self, inputs):
        op = self.op.lower()
        if op == "add":
            out = inputs[0]
            for x in inputs[1:]:
                out = out + x
            return out
        if op == "subtract":
            return inputs[0] - inputs[1]
        if op in ("product", "mul"):
            out = inputs[0]
            for x in inputs[1:]:
                out = out * x
            return out
        if op in ("average", "avg"):
            return sum(inputs) / len(inputs)
        if op == "max":
            out = inputs[0]
            for x in inputs[1:]:
                out = torch.maximum(out, x)
            return out
        raise ValueError(f"Unknown elementwise op {self.op}")

    def output_type(self, input_types):
        return input_types[0]


@register_vertex
@dataclasses.dataclass(frozen=True)
class MergeVertex(GraphVertex):
    """Concatenate along the feature/channel axis."""

    def apply(self, inputs):
        return torch.cat(inputs, dim=-1)

    def output_type(self, input_types):
        t0 = input_types[0]
        if t0.kind == "cnn":
            return InputType.convolutional(
                t0.height, t0.width, sum(t.channels for t in input_types))
        if t0.kind == "rnn":
            return InputType.recurrent(sum(t.size for t in input_types),
                                       t0.timesteps)
        return InputType.feed_forward(sum(t.flat_size() for t in input_types))


@register_vertex
@dataclasses.dataclass(frozen=True)
class SubsetVertex(GraphVertex):
    """Feature range [index_from, index_to], both ends included."""

    index_from: int = 0
    index_to: int = 0

    def apply(self, inputs):
        return inputs[0][..., self.index_from:self.index_to + 1]

    def output_type(self, input_types):
        n = self.index_to - self.index_from + 1
        t = input_types[0]
        if t.kind == "rnn":
            return InputType.recurrent(n, t.timesteps)
        if t.kind == "cnn":
            return InputType.convolutional(t.height, t.width, n)
        return InputType.feed_forward(n)


@register_vertex
@dataclasses.dataclass(frozen=True)
class ScaleVertex(GraphVertex):
    factor: float = 1.0

    def apply(self, inputs):
        return inputs[0] * self.factor

    def output_type(self, input_types):
        return input_types[0]


@register_vertex
@dataclasses.dataclass(frozen=True)
class LastTimeStepVertex(GraphVertex):
    """[B, T, F] -> [B, F] at each example's last unmasked step (reference
    ``rnn/LastTimeStepVertex.java``): with a mask [B, T], the step at
    sum(mask) - 1 (clamped at 0), else the last."""

    _TAKES_MASK = True

    def apply(self, inputs, mask=None):
        x = inputs[0]
        if mask is None:
            return x[:, -1]
        idx = (mask.sum(dim=1).to(torch.int32) - 1).clamp_min(0)
        return x[torch.arange(x.shape[0], device=x.device),
                 idx.to(torch.int64)]

    def output_type(self, input_types):
        return InputType.feed_forward(input_types[0].size)


@register_vertex
@dataclasses.dataclass(frozen=True)
class DuplicateToTimeSeriesVertex(GraphVertex):
    """[B, F] -> [B, T, F], the features repeated at every timestep
    (reference ``rnn/DuplicateToTimeSeriesVertex.java``); T is
    ``timesteps``, or when unset the time axis of the second input."""

    timesteps: Optional[int] = None

    def apply(self, inputs):
        x = inputs[0]
        t = self.timesteps
        if t is None and len(inputs) > 1:
            t = inputs[1].shape[1]
        return x[:, None, :].expand(x.shape[0], t, x.shape[-1])

    def output_type(self, input_types):
        return InputType.recurrent(input_types[0].flat_size(),
                                   self.timesteps)


@register_vertex
@dataclasses.dataclass(frozen=True)
class PreprocessorVertex(GraphVertex):
    """An input preprocessor as a vertex of its own; ``preprocessor`` is
    its serialized dict (the reference's field)."""

    preprocessor: Optional[dict] = None

    def _proc(self):
        return preproc_from_dict(self.preprocessor)

    def apply(self, inputs):
        return self._proc()(inputs[0])

    def output_type(self, input_types):
        return self._proc().output_type(input_types[0])
