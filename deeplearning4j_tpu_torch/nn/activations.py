"""Activations — the subset of ``deeplearning4j_tpu/nn/activations.py`` the
ported layers use, under the same string names."""

from __future__ import annotations

from typing import Callable, Dict

import torch


def identity(x):
    return x


_REGISTRY: Dict[str, Callable] = {
    "identity": identity,
    "linear": identity,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "relu": torch.relu,
    "softmax": lambda x: torch.softmax(x, dim=-1),
}


def get(name: str) -> Callable:
    try:
        return _REGISTRY[name.lower()]
    except KeyError:
        raise ValueError(
            f"Unknown activation '{name}'. Known: {sorted(_REGISTRY)}") from None
