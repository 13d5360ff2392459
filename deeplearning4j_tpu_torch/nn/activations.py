"""Activations — counterpart of ``deeplearning4j_tpu/nn/activations.py``:
every activation of the reference under its lowercase string name, with
the reference's constants (``leakyrelu``'s slope 0.01, ``hardsigmoid``
as ``clip(0.2x + 0.5, 0, 1)``, ``gelu``'s tanh approximation, as
``jax.nn.gelu`` computes it by default), and ``register`` for new
names."""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F


def identity(x):
    return x


def leakyrelu(x, alpha: float = 0.01):
    return F.leaky_relu(x, negative_slope=alpha)


def hardtanh(x):
    return torch.clamp(x, -1.0, 1.0)


def hardsigmoid(x):
    return torch.clamp(0.2 * x + 0.5, 0.0, 1.0)


def cube(x):
    return x ** 3


def rationaltanh(x):
    # the reference's "rationaltanh": 1.7159 * tanh(2x/3)
    return 1.7159 * torch.tanh(2.0 * x / 3.0)


def gelu(x):
    return F.gelu(x, approximate="tanh")


_REGISTRY: Dict[str, Callable] = {
    "identity": identity,
    "linear": identity,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "relu": torch.relu,
    "leakyrelu": leakyrelu,
    "elu": F.elu,
    "softplus": F.softplus,
    "softsign": F.softsign,
    "hardtanh": hardtanh,
    "hardsigmoid": hardsigmoid,
    "cube": cube,
    "rationaltanh": rationaltanh,
    "softmax": lambda x: torch.softmax(x, dim=-1),
    "gelu": gelu,
    "swish": F.silu,
}


def get(name: str) -> Callable:
    try:
        return _REGISTRY[name.lower()]
    except KeyError:
        raise ValueError(
            f"Unknown activation '{name}'. Known: {sorted(_REGISTRY)}") from None


def register(name: str, fn: Callable) -> None:
    _REGISTRY[name.lower()] = fn
