"""Layer base — counterpart of ``deeplearning4j_tpu/nn/layers/base.py``.

A layer is a frozen config dataclass with the reference's field names,
so configs round-trip through the same JSON, plus plain functions on
tensors:

  - ``param_shapes()`` -> {name: shape} (nested for composites), the
    layout of the reference's parameter pytree (``[n_in, n_out]``
    kernels used as ``x @ W``), so weights carry across without
    transposes;
  - ``init(gen, dtype, device)`` -> parameter dict of tensors;
  - ``apply(params, x)`` -> y (inference forward).

Parameters live in the model's nested dict, not in the layer.  Each
class registers under its reference type name (``register_layer``) so
``layer_from_dict`` reads the reference's layer dicts.  Only inference
is ported so far: ``train``/``rng`` and dropout arrive with the
training slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Type

import torch

_LAYER_REGISTRY: Dict[str, Type["Layer"]] = {}


def register_layer(cls: Type["Layer"]) -> Type["Layer"]:
    """Class decorator: register a layer type for JSON round-trip."""
    _LAYER_REGISTRY[cls.__name__] = cls
    return cls


def layer_from_dict(d: Dict[str, Any]) -> "Layer":
    d = dict(d)
    type_name = d.pop("type")
    cls = _LAYER_REGISTRY.get(type_name)
    if cls is None:
        raise ValueError(f"Unknown layer type '{type_name}'; registered: "
                         f"{sorted(_LAYER_REGISTRY)}")
    return cls.from_dict(d)


@dataclasses.dataclass(frozen=True)
class Layer:
    """Base layer config (the reference's shared fields)."""

    name: Optional[str] = None
    activation: str = "sigmoid"
    weight_init: str = "xavier"
    dist: Optional[dict] = None
    dropout: float = 0.0
    drop_connect: bool = False
    l1: float = 0.0
    l2: float = 0.0
    learning_rate: Optional[float] = None
    bias_init: float = 0.0

    def validate(self) -> None:
        """Fail fast at build time on unknown activation / weight-init names."""
        from deeplearning4j_tpu_torch.nn import activations, initializers

        activations.get(self.activation)
        initializers.check(self.weight_init)

    def param_shapes(self) -> Dict[str, Any]:
        raise NotImplementedError

    def init(self, gen: torch.Generator, dtype=torch.float32,
             device=None) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def has_params(self) -> bool:
        return True

    def apply(self, params, x):
        raise NotImplementedError

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["type"] = type(self).__name__
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Layer":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})

    def with_name(self, name: str) -> "Layer":
        return dataclasses.replace(self, name=name)
