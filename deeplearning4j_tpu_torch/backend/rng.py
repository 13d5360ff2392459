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

Splits, masks, draws against a tensor of probabilities
(``bernoulli_probs``) and normal noise (``normal``) are counter-based
functions of (seed, index): the
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
_NORMAL_SALT = 0xBB67AE8584CAA73B  # and a normal draw's from both
_MASK_BITS = 24                   # a mask element's uniform: 24 bits

Key = Union[torch.Generator, torch.Tensor]


class KeyStream:
    """Stateful splitter over a root generator — host-side use only."""

    def __init__(self, seed: int = 0):
        self._gen = torch.Generator().manual_seed(int(seed))

    def next(self) -> torch.Generator:
        sub = int(torch.randint(0, _SEED_MAX, (1,), generator=self._gen))
        return torch.Generator().manual_seed(sub)

    def get_state(self) -> torch.Tensor:
        """The stream's position (the root generator's state, a CPU byte
        tensor): ``set_state`` of it replays the same keys from here."""
        return self._gen.get_state()

    def set_state(self, state: torch.Tensor) -> None:
        self._gen.set_state(state)


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


def bernoulli(key: Key, p: float, shape, device, offset: int = 0
              ) -> torch.Tensor:
    """Boolean mask of ``shape``, True with probability ``p``, drawn on
    ``device`` from ``key``'s seed (``jax.random.bernoulli``): element i
    is True when the top 24 bits of splitmix64 of (the key's mask seed,
    i) fall below ``p`` · 2^24.  ``offset`` starts the elements there:
    the elements ``offset ...`` of a larger draw (a process's rows of the
    global batch's mask)."""
    shape = tuple(shape)
    n = math.prod(shape)
    return (_bits(key, _MASK_SALT, n, torch.device(device), offset)
            < math.ceil(p * 2 ** _MASK_BITS)).reshape(shape)


def _bits(key: Key, salt: int, n: int, device, offset: int = 0
          ) -> torch.Tensor:
    """The top 24 bits of splitmix64 of (the key's seed salted by
    ``salt``, i) for i in offset+1..offset+n, as int64 on ``device``."""
    if torch.is_tensor(key):
        base = _finalize_t(key.to(device) ^ _signed(salt))
    else:
        base = _signed(_finalize(key.initial_seed() ^ salt))
    idx = torch.arange(offset + 1, offset + n + 1, dtype=torch.int64,
                       device=device)
    return _srl(_finalize_t(idx * _signed(_GOLDEN) + base), 64 - _MASK_BITS)


def uniform(key: Key, shape, device) -> torch.Tensor:
    """float32 uniforms in [0, 1) of ``shape``: element i is the mask
    stream's 24 bits over 2^24 (exact in float32), so
    ``bernoulli_probs`` draws ``uniform(key) < probs``."""
    shape = tuple(shape)
    bits = _bits(key, _MASK_SALT, math.prod(shape), torch.device(device))
    return (bits.float() * (1.0 / 2 ** _MASK_BITS)).reshape(shape)


def bernoulli_probs(key: Key, probs: torch.Tensor) -> torch.Tensor:
    """Samples of ``probs``' type and shape, 1 where ``uniform(key)`` falls
    below the element's probability (``jax.random.bernoulli(key, probs)``
    cast to the probabilities' type); nothing flows back to ``probs``."""
    u = uniform(key, probs.shape, probs.device)
    return (u < probs.detach().float()).to(probs.dtype)


def normal(key: Key, shape, device, dtype=torch.float32) -> torch.Tensor:
    """Standard normal noise of ``shape`` (``jax.random.normal``) by
    Box-Muller: element i takes the 24-bit uniforms 2i and 2i + 1 of the
    key's normal stream, each shifted into (0, 1) as (bits + 0.5) / 2^24
    so that the logarithm never sees 0."""
    shape = tuple(shape)
    n = math.prod(shape)
    bits = _bits(key, _NORMAL_SALT, 2 * n, torch.device(device))
    u = (bits.float() + 0.5) * (1.0 / 2 ** _MASK_BITS)
    u1, u2 = u[0::2], u[1::2]
    z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * u2)
    return z.reshape(shape).to(dtype)
