"""Seeded random streams — counterpart of ``deeplearning4j_tpu/backend/rng.py``.

The JAX ``KeyStream`` splits threefry keys; here each ``next()`` hands
out a fresh ``torch.Generator`` seeded from a root generator.  Weights are
drawn on the CPU and moved to the target device, so the same seed gives
the same weights on ``cpu`` and ``cuda``.

A generator handed out here is used as a JAX key is: it is split into
children (``split``, as ``jax.random.split(rng, n)``) or it seeds one draw
(``bernoulli``), and it is never advanced.  A draw builds a generator on
the tensor's device from the key's seed, so dropout masks are drawn on
the card, and drawing twice from one key gives the same mask — which
keeps a recomputed forward (``remat``) exact.

JAX's streams cannot be reproduced in torch: parity with the reference
goes through weights carried across (``models/interop.py``) and explicit
masks, never seeds.
"""

from __future__ import annotations

from typing import List

import torch

_SEED_MAX = 2 ** 63 - 1
_MASK64 = 2 ** 64 - 1


class KeyStream:
    """Stateful splitter over a root generator — host-side use only."""

    def __init__(self, seed: int = 0):
        self._gen = torch.Generator().manual_seed(int(seed))

    def next(self) -> torch.Generator:
        sub = int(torch.randint(0, _SEED_MAX, (1,), generator=self._gen))
        return torch.Generator().manual_seed(sub)


def _mix(seed: int, i: int) -> int:
    """splitmix64 of (seed, i), cut to 63 bits: child seeds that are
    deterministic and unrelated to each other."""
    z = (seed + (i + 1) * 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) & _SEED_MAX


def split(key: torch.Generator, n: int) -> List[torch.Generator]:
    """``n`` child keys of ``key`` (``jax.random.split(key, n)``); the
    same key always gives the same children."""
    base = key.initial_seed()
    return [torch.Generator().manual_seed(_mix(base, i)) for i in range(n)]


def bernoulli(key: torch.Generator, p: float, shape,
              device) -> torch.Tensor:
    """Boolean mask of ``shape``, True with probability ``p``, drawn on
    ``device`` from ``key``'s seed (``jax.random.bernoulli``)."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(key.initial_seed())
    return torch.rand(tuple(shape), generator=gen, device=device) < p
