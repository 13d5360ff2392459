"""Seeded random streams — counterpart of ``deeplearning4j_tpu/backend/rng.py``.

The JAX ``KeyStream`` splits threefry keys; here each ``next()`` hands
out a fresh CPU ``torch.Generator`` seeded from a root generator.  The
draws happen on the CPU and the results move to the target device, so
the same seed gives the same weights on ``cpu`` and ``cuda``.  JAX's
streams cannot be reproduced in torch: parity with the reference goes
through weights carried across (``models/interop.py``), never seeds.
"""

from __future__ import annotations

import torch

_SEED_MAX = 2 ** 63 - 1


class KeyStream:
    """Stateful splitter over a root generator — host-side use only."""

    def __init__(self, seed: int = 0):
        self._gen = torch.Generator().manual_seed(int(seed))

    def next(self) -> torch.Generator:
        sub = int(torch.randint(0, _SEED_MAX, (1,), generator=self._gen))
        return torch.Generator().manual_seed(sub)
