"""Shape bucketing policy for the serving engine.

Copied from ``deeplearning4j_tpu/serving/buckets.py`` (framework-free).  On the
card a shape is a captured CUDA graph where the reference's is an XLA
executable: the same closed set, warmed at startup.

XLA compiles one executable per abstract input shape, so a serving path
that forwards raw ragged request batches retraces constantly — and one
that pads everything to a single ``max_batch`` (the old
``InferenceServer`` behaviour) makes a 1-row request pay the FLOPs and
HBM traffic of a full tile.  The middle ground is a small CLOSED set of
shapes: batch-size buckets in powers of two up to ``max_batch`` (and,
for recurrent/attention models, optional sequence-length buckets on the
time axis).  Every dispatched forward pass is padded UP to the nearest
bucket, so

- a request never pays more than 2x its own padding FLOPs, and
- the compiler only ever sees ``len(buckets)`` (x ``len(seq_buckets)``)
  signatures, all of which AOT warmup can precompile at startup.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple


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


class BucketPolicy:
    """The closed shape set the engine is allowed to hand the compiler.

    ``batch_buckets`` — allowed row counts, ascending; defaults to powers
    of two up to ``max_batch``.  Passing ``batch_buckets=(max_batch,)``
    reproduces the legacy fixed-shape path (everything padded to one
    size) — the serving bench uses exactly that as its comparison arm.

    ``seq_buckets`` — optional allowed lengths for the TIME axis (axis 1
    of a rank>=3 input).  Inputs are zero-padded up to the nearest
    bucket; callers serving recurrent models whose semantics depend on
    exact sequence length should pass feature masks or disable this.
    """

    def __init__(self, max_batch: int = 32,
                 batch_buckets: Optional[Sequence[int]] = None,
                 seq_buckets: Optional[Sequence[int]] = None):
        if max_batch < 1:
            raise ValueError(f"max_batch={max_batch} must be >= 1")
        self.max_batch = int(max_batch)
        if batch_buckets is None:
            self.batch_buckets = _pow2_buckets(self.max_batch)
        else:
            bb = tuple(sorted(int(b) for b in batch_buckets))
            if not bb or bb[0] < 1:
                raise ValueError(f"bad batch_buckets {batch_buckets}")
            if bb[-1] != self.max_batch:
                raise ValueError(
                    f"largest batch bucket {bb[-1]} must equal "
                    f"max_batch {self.max_batch}")
            self.batch_buckets = bb
        self.seq_buckets = (None if seq_buckets is None
                            else tuple(sorted(int(s) for s in seq_buckets)))

    # ------------------------------------------------------------- lookups
    def bucket_rows(self, rows: int) -> int:
        """Smallest batch bucket >= rows (rows above ``max_batch`` are the
        batcher's problem — it chunks before asking)."""
        for b in self.batch_buckets:
            if rows <= b:
                return b
        return self.batch_buckets[-1]

    def bucket_seq(self, length: int) -> int:
        """Smallest sequence bucket >= length; lengths beyond the largest
        bucket pass through unpadded (one extra signature, no truncation)."""
        if self.seq_buckets is None:
            return length
        for s in self.seq_buckets:
            if length <= s:
                return s
        return length

    # -------------------------------------------------------------- warmup
    def warmup_shapes(self, row_shape: Sequence[int]) -> list:
        """Every full input shape AOT warmup must precompile for a model
        whose single example row has shape ``row_shape`` (no batch dim).
        With seq buckets a rank>=2 row's leading (time) axis is swept
        over every bucket; a rank-1 (dense) row has no time axis — the
        same rule ``predict`` applies (it only seq-buckets rank>=3
        inputs), so warmup and serve-time shape sets always match."""
        row_shape = tuple(int(d) for d in row_shape)
        shapes = []
        if self.seq_buckets is not None and len(row_shape) >= 2:
            for s in self.seq_buckets:
                for b in self.batch_buckets:
                    shapes.append((b, s) + row_shape[1:])
        else:
            for b in self.batch_buckets:
                shapes.append((b,) + row_shape)
        return shapes

    def __repr__(self):
        return (f"BucketPolicy(batch={list(self.batch_buckets)}, "
                f"seq={list(self.seq_buckets) if self.seq_buckets else None})")
