"""Layer base — counterpart of ``deeplearning4j_tpu/nn/layers/base.py``.

A layer is a frozen config dataclass with the reference's field names,
so configs round-trip through the same JSON, plus plain functions on
tensors:

  - ``param_shapes()`` -> {name: shape} (nested for composites), the
    layout of the reference's parameter pytree (``[n_in, n_out]``
    kernels used as ``x @ W``), so weights carry across without
    transposes;
  - ``init(gen, dtype, device)`` -> parameter dict of tensors;
  - ``apply(params, x, *, train=False, rng=None)`` -> y; at train time
    ``rng`` is the layer's key (a ``torch.Generator`` or a device key,
    see ``backend/rng.py``) for its input dropout;
  - ``init_state(device)`` -> the layer's non-trainable state ({} for
    most layers; BatchNorm's running mean and var).  A stateful layer
    also has ``apply_with_state(params, state, x, *, train, rng)`` ->
    (y, new_state), which the facades call in place of ``apply`` (the
    reference's ``apply`` takes and returns the state of every layer);
  - ``setup(input_type)`` / ``output_type(input_type)``: the size
    inference a graph's ``set_input_types`` runs.

Parameters live in the model's nested dict, not in the layer; gradients
come from autograd through ``apply``.  Each class registers under its
reference type name (``register_layer``) so ``layer_from_dict`` reads
the reference's layer dicts.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Type

import torch

from deeplearning4j_tpu_torch.backend import rng as rng_mod
from deeplearning4j_tpu_torch.nn.inputs import InputType

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
    _SUPPORTS_DROP_CONNECT = False     # Dense/Output layers mask W
    _TAKES_MASK = False                # apply() takes a padding ``mask``

    def validate(self) -> None:
        """Fail fast at build time on unknown activation / weight-init
        names, and on drop_connect where the layer never masks W (input
        dropout is off under drop_connect, so all dropout would vanish)."""
        from deeplearning4j_tpu_torch.nn import activations, initializers

        activations.get(self.activation)
        initializers.check(self.weight_init)
        if self.drop_connect and not self._SUPPORTS_DROP_CONNECT:
            raise ValueError(
                f"{type(self).__name__} does not support drop_connect "
                "(weight masking is implemented for Dense/Output layers); "
                "use plain dropout here")

    def setup(self, input_type: InputType) -> "Layer":
        """A completed copy with sizes inferred from ``input_type``."""
        return self

    def output_type(self, input_type: InputType) -> InputType:
        raise NotImplementedError(
            f"{type(self).__name__} has no shape inference in the port yet")

    def param_shapes(self) -> Dict[str, Any]:
        raise NotImplementedError

    def init(self, gen: torch.Generator, dtype=torch.float32,
             device=None) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def init_state(self, device=None) -> Dict[str, torch.Tensor]:
        return {}

    def has_params(self) -> bool:
        return True

    def apply(self, params, x, *, train=False, rng=None):
        raise NotImplementedError

    def maybe_dropout(self, x, *, train, rng):
        """Input dropout with inverted scaling at train time (reference
        ``util/Dropout.java`` applyDropout).  Under ``drop_connect`` the
        rate applies to the weights instead, so this is a no-op."""
        if not train or self.dropout <= 0.0 or self.drop_connect:
            return x
        if rng is None:
            raise ValueError(
                f"Layer {self.name}: dropout requires an rng key at train "
                "time")
        keep = 1.0 - self.dropout
        mask = rng_mod.bernoulli(rng, keep, x.shape, x.device)
        return torch.where(mask, x / keep, torch.zeros_like(x))

    def maybe_drop_connect(self, w, *, train, rng):
        """DropConnect: a Bernoulli mask on the weight matrix at train
        time, with inverted scaling (reference ``Dropout.java:24-36``)."""
        if not train or not self.drop_connect or self.dropout <= 0.0:
            return w
        if rng is None:
            raise ValueError(
                f"Layer {self.name}: drop_connect requires an rng key at "
                "train time")
        keep = 1.0 - self.dropout
        mask = rng_mod.bernoulli(rng, keep, w.shape, w.device)
        return torch.where(mask, w / keep, torch.zeros_like(w))

    def reg_score(self, params):
        """L1/L2 penalty on the weights only (reference calcL1/calcL2):
        biases, LayerNorm and BatchNorm parameters are exempt.  A layer
        with neither gives the float 0.0 (no device tensor to add)."""
        total = 0.0
        if (self.l1 == 0.0 and self.l2 == 0.0) or not params:
            return total
        for pname, p in params.items():
            if pname in ("b", "beta", "gamma", "mean", "var"):
                continue
            if self.l1:
                total = total + self.l1 * p.abs().sum()
            if self.l2:
                total = total + 0.5 * self.l2 * (p * p).sum()
        return total

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
