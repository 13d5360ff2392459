"""Shape buckets — ``_pow2_buckets`` copied from ``deeplearning4j_tpu/serving/buckets.py``."""

from __future__ import annotations

from typing import Tuple


def _pow2_buckets(max_value: int) -> Tuple[int, ...]:
    """1, 2, 4, … up to ``max_value`` (``max_value`` always included, so a
    non-power-of-two cap still gets a full-budget bucket)."""
    out = []
    b = 1
    while b < max_value:
        out.append(b)
        b *= 2
    out.append(max_value)
    return tuple(out)
