"""Weight init — counterpart of ``deeplearning4j_tpu/nn/initializers.py``:
the reference's twelve schemes under the same names and fan conventions
(a dense [n_in, n_out] kernel has fan_in = n_in, fan_out = n_out; a conv
kernel HWIO [kh, kw, in_ch, out_ch] has fan_in = in_ch·kh·kw and
fan_out = out_ch·kh·kw; a caller may pass its own, as the LSTM does),
and the custom distributions of ``weight_init="distribution"``.

Draws come from an explicit CPU ``torch.Generator`` and then move to the
target device, so a seed gives the same weights on every device.  They
are not the reference's threefry draws: parity goes through weights
carried across (``models/interop.py``)."""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

KNOWN = frozenset({
    "zero", "ones", "uniform", "xavier", "xavier_uniform", "xavier_fan_in",
    "xavier_legacy", "relu", "relu_uniform", "sigmoid_uniform", "normal",
    "distribution",
})


def check(name: str) -> None:
    if name.lower() not in KNOWN:
        raise ValueError(f"Unknown weight init '{name}'. Known: {sorted(KNOWN)}")


def fans(shape: Sequence[int]) -> Tuple[int, int]:
    """(fan_in, fan_out) of a kernel, the reference's ``_fans`` rule."""
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = math.prod(shape[:-2])
    return shape[-2] * receptive, shape[-1] * receptive


def _normal(gen, shape, std):
    return std * torch.randn(shape, generator=gen, dtype=torch.float32)


def _uniform(gen, shape, a, b=None):
    """U(a, b), or U(-a, a) when ``b`` is None."""
    lo, hi = (-a, a) if b is None else (a, b)
    return torch.empty(shape, dtype=torch.float32).uniform_(lo, hi,
                                                            generator=gen)


def _scale(name: str, fi: int, fo: int) -> Tuple[str, float]:
    """(the draw, its scale) of a scheme: the normal's std or the
    uniform's bound, the reference's formulas."""
    return {
        "uniform": ("uniform", 1.0 / math.sqrt(fi)),
        "xavier": ("normal", math.sqrt(2.0 / (fi + fo))),
        "xavier_uniform": ("uniform", math.sqrt(6.0 / (fi + fo))),
        "xavier_fan_in": ("normal", math.sqrt(1.0 / fi)),
        "xavier_legacy": ("normal", math.sqrt(1.0 / (fi + fo))),
        "relu": ("normal", math.sqrt(2.0 / fi)),
        "relu_uniform": ("uniform", math.sqrt(6.0 / fi)),
        "sigmoid_uniform": ("uniform", 4.0 * math.sqrt(6.0 / (fi + fo))),
        "normal": ("normal", 1.0 / math.sqrt(fi)),
    }[name]


def init(name: str, gen: torch.Generator, shape: Sequence[int],
         dtype=torch.float32, device=None, *, fan_in: Optional[int] = None,
         fan_out: Optional[int] = None, distribution=None) -> torch.Tensor:
    """Materialise a weight tensor using the named scheme; ``fan_in`` and
    ``fan_out`` replace the ones of ``shape`` when both are given."""
    check(name)
    name = name.lower()
    shape = tuple(shape)
    if name == "zero":
        return torch.zeros(shape, dtype=dtype, device=device)
    if name == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if name == "distribution":
        if distribution is None:
            raise ValueError(
                "WeightInit 'distribution' requires a distribution spec")
        w = distribution.sample(gen, shape)
    else:
        fi, fo = ((fan_in, fan_out) if fan_in is not None
                  and fan_out is not None else fans(shape))
        kind, s = _scale(name, fi, fo)
        w = _normal(gen, shape, s) if kind == "normal" else \
            _uniform(gen, shape, s)
    return w.to(device=device, dtype=dtype)


class NormalDistribution:
    """Custom-distribution spec (reference ``nn/conf/distribution/``)."""

    def __init__(self, mean: float = 0.0, std: float = 1.0):
        self.mean, self.std = mean, std

    def sample(self, gen, shape):
        return self.mean + _normal(gen, shape, self.std)

    def to_dict(self):
        return {"type": "normal", "mean": self.mean, "std": self.std}


class UniformDistribution:
    def __init__(self, lower: float = -1.0, upper: float = 1.0):
        self.lower, self.upper = lower, upper

    def sample(self, gen, shape):
        return _uniform(gen, shape, self.lower, self.upper)

    def to_dict(self):
        return {"type": "uniform", "lower": self.lower, "upper": self.upper}


def distribution_from_dict(d):
    if d is None:
        return None
    t = d["type"]
    if t == "normal":
        return NormalDistribution(d["mean"], d["std"])
    if t == "uniform":
        return UniformDistribution(d["lower"], d["upper"])
    raise ValueError(f"Unknown distribution type {t}")
