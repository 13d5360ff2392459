"""Seeded random streams — counterpart of ``deeplearning4j_tpu/backend/rng.py``.

The JAX ``KeyStream`` splits threefry keys; here each ``next()`` hands
out a fresh ``torch.Generator`` seeded from a root generator.  Weights are
drawn on the CPU and moved to the target device, so the same seed gives
the same weights on ``cpu`` and ``cuda``.

A key is used as a JAX key is: it is split into children (``split``, as
``jax.random.split(rng, n)``) or it seeds one draw (``bernoulli``), and
it is never advanced.  A key is either a ``torch.Generator`` (its
``initial_seed()``) or a **device key**: an int64 0-d tensor holding the
seed on the device (``device_key``).  A train step captured in a CUDA
graph reads its key from a static device key that the host rewrites
before each replay, so the graph draws new masks every step.

Splits and masks are counter-based functions of (seed, index): the
splitmix64 finalizer in wrapping int64 arithmetic, evaluated in Python
for a generator's children and in int64 tensor ops for a device key's
and for every mask element.  So a generator and a device key with one
seed split into the same children and draw the same mask, on the CPU
and on the card, and drawing twice from one key gives the same mask —
which keeps a recomputed forward (``remat``) exact.

JAX's streams cannot be reproduced in torch: parity with the reference
goes through weights carried across (``models/interop.py``) and explicit
masks, never seeds.
"""

from __future__ import annotations

import math
from typing import List, Union

import torch

_SEED_MAX = 2 ** 63 - 1
_MASK64 = 2 ** 64 - 1
_GOLDEN = 0x9E3779B97F4A7C15
_M1 = 0xBF58476D1CE4E5B9
_M2 = 0x94D049BB133111EB
_MASK_SALT = 0x6A09E667F3BCC909   # a mask's stream is apart from splits'
_MASK_BITS = 24                   # a mask element's uniform: 24 bits

Key = Union[torch.Generator, torch.Tensor]


class KeyStream:
    """Stateful splitter over a root generator — host-side use only."""

    def __init__(self, seed: int = 0):
        self._gen = torch.Generator().manual_seed(int(seed))

    def next(self) -> torch.Generator:
        sub = int(torch.randint(0, _SEED_MAX, (1,), generator=self._gen))
        return torch.Generator().manual_seed(sub)


def _signed(v: int) -> int:
    """A 64-bit pattern as the int64 that holds it."""
    v &= _MASK64
    return v - 2 ** 64 if v >= 2 ** 63 else v


def _finalize(z: int) -> int:
    """splitmix64's output function on a Python int (64 bits)."""
    z &= _MASK64
    z = ((z ^ (z >> 30)) * _M1) & _MASK64
    z = ((z ^ (z >> 27)) * _M2) & _MASK64
    return z ^ (z >> 31)


def _srl(z: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns (torch's ``>>`` is
    arithmetic)."""
    return (z >> k) & ((1 << (64 - k)) - 1)


def _finalize_t(z: torch.Tensor) -> torch.Tensor:
    """``_finalize`` on int64 tensors: the same bits, wrapping."""
    z = (z ^ _srl(z, 30)) * _signed(_M1)
    z = (z ^ _srl(z, 27)) * _signed(_M2)
    return z ^ _srl(z, 31)


def _mix(seed: int, i: int) -> int:
    """splitmix64 of (seed, i), cut to 63 bits: child seeds that are
    deterministic and unrelated to each other."""
    return _finalize(seed + (i + 1) * _GOLDEN) & _SEED_MAX


def device_key(seed: int, device) -> torch.Tensor:
    """A device key: ``seed`` as an int64 0-d tensor on ``device``."""
    return torch.tensor(int(seed), dtype=torch.int64, device=device)


def seed_of(key: torch.Generator) -> int:
    """The seed a host key hands to a device key."""
    return key.initial_seed()


def split(key: Key, n: int) -> List[Key]:
    """``n`` child keys of ``key`` (``jax.random.split(key, n)``); the
    same key always gives the same children.  A device key's children
    are 0-d views of one [n] tensor (no host sync)."""
    if torch.is_tensor(key):
        idx = torch.arange(1, n + 1, dtype=torch.int64, device=key.device)
        kids = _finalize_t(key + idx * _signed(_GOLDEN)) & _SEED_MAX
        return list(kids.unbind(0))
    base = key.initial_seed()
    return [torch.Generator().manual_seed(_mix(base, i)) for i in range(n)]


def bernoulli(key: Key, p: float, shape, device) -> torch.Tensor:
    """Boolean mask of ``shape``, True with probability ``p``, drawn on
    ``device`` from ``key``'s seed (``jax.random.bernoulli``): element i
    is True when the top 24 bits of splitmix64 of (the key's mask seed,
    i) fall below ``p`` · 2^24."""
    device = torch.device(device)
    shape = tuple(shape)
    n = math.prod(shape)
    if torch.is_tensor(key):
        base = _finalize_t(key.to(device) ^ _signed(_MASK_SALT))
    else:
        base = _signed(_finalize(key.initial_seed() ^ _MASK_SALT))
    idx = torch.arange(1, n + 1, dtype=torch.int64, device=device)
    bits = _srl(_finalize_t(idx * _signed(_GOLDEN) + base), 64 - _MASK_BITS)
    return (bits < math.ceil(p * 2 ** _MASK_BITS)).reshape(shape)
