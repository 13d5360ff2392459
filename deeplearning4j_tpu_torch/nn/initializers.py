"""Weight init — the subset of ``deeplearning4j_tpu/nn/initializers.py`` the
ported layers use, under the same names and fan conventions: a dense
[n_in, n_out] kernel has fan_in = n_in, fan_out = n_out; a conv kernel
HWIO [kh, kw, in_ch, out_ch] has fan_in = in_ch·kh·kw and fan_out =
out_ch·kh·kw.

Draws come from an explicit CPU ``torch.Generator`` and then move to the
target device, so a seed gives the same weights on every device.  They
are not the reference's threefry draws: parity goes through weights
carried across (``models/interop.py``)."""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

KNOWN = frozenset({"zero", "ones", "xavier", "relu"})


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


def init(name: str, gen: torch.Generator, shape: Sequence[int],
         dtype=torch.float32, device=None) -> torch.Tensor:
    """Materialise a weight tensor using the named scheme."""
    check(name)
    name = name.lower()
    shape = tuple(shape)
    if name == "zero":
        return torch.zeros(shape, dtype=dtype, device=device)
    if name == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    fi, fo = fans(shape)
    if name == "xavier":
        # reference XAVIER: gaussian, var = 2/(fan_in+fan_out)
        std = math.sqrt(2.0 / (fi + fo))
    else:
        # reference RELU (He): gaussian, var = 2/fan_in
        std = math.sqrt(2.0 / fi)
    w = std * torch.randn(shape, generator=gen, dtype=torch.float32)
    return w.to(device=device, dtype=dtype)
