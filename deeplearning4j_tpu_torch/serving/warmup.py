"""AOT warmup: precompile every bucket shape before a version serves.

Copied from ``deeplearning4j_tpu/serving/warmup.py``.  On the card each
bucket's ``output`` is captured here, once, as a CUDA graph
(``models/capture.py``), and the version's detector counts the capture.

A capture (the reference: an XLA compile) costs far more than a replay;
one triggered by live traffic is a latency spike AND it stalls every
other request sharing the dispatch thread.  Because the
bucket policy closes the shape set, the whole set can be compiled at
startup (and during a hot-swap, on the INCOMING version while the old
one still serves) — steady-state serving then triggers exactly zero
compiles, which ``dl4j_compiles_total{fn="serving.<name>"}`` proves.

Each warmup shape is driven through the version's RecompileDetector with
the SAME fingerprint the engine uses at serve time, so a serve-time
signature is new only if warmup never saw it.
"""

from __future__ import annotations

import contextlib
import logging
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.models import capture as cap

logger = logging.getLogger("deeplearning4j_tpu_torch.serving")


class NoWarmupShapeError(ValueError):
    """Warmup is impossible because no example row shape is known — the
    engine downgrades THIS to a warning (first traffic compiles on
    demand); any other warmup failure is a genuinely broken model and
    must abort the deploy instead of activating it."""


def infer_row_shape(model) -> Optional[Tuple[int, ...]]:
    """Best-effort single-row feature shape from the model config (dense
    first layer -> ``(n_in,)``); None when it cannot be derived (conv /
    graph inputs) — the caller must then provide an example row."""
    layers = getattr(model, "layers", None)
    if layers:
        n_in = getattr(layers[0], "n_in", None)
        if isinstance(n_in, int) and n_in > 0:
            return (n_in,)
    return None


def warmup_version(mv, policy, row_shape: Optional[Sequence[int]] = None,
                   dtype=np.float32, metrics=None) -> int:
    """Run one forward pass per bucket shape through ``mv``'s detector
    and model; returns the number of shapes compiled.  Raises
    ``NoWarmupShapeError`` when no row shape is known (explicit beats a
    silently cold cache); model failures propagate as-is."""
    if row_shape is None:
        row_shape = (tuple(mv.example.shape) if mv.example is not None
                     else infer_row_shape(mv.model))
    if row_shape is None:
        raise NoWarmupShapeError(
            f"cannot warm up {mv.key}: no example row provided and the "
            f"input shape is not derivable from the model config — pass "
            f"example= when registering/deploying the model")
    shapes = policy.warmup_shapes(row_shape)
    timer = (metrics.warmup_seconds.time() if metrics is not None
             else contextlib.nullcontext())
    with timer:
        for shape in shapes:
            forward(mv, np.zeros(shape, dtype), expected=True)
    if metrics is not None:
        metrics.warmup_shapes.set(len(shapes), model=mv.name)
    logger.info("warmed %s: %d bucket shapes precompiled (%s)",
                mv.key, len(shapes), [s[0] for s in shapes])
    return len(shapes)


def _host(out):
    """A model's output as host arrays (a list for several outputs)."""
    if isinstance(out, (list, tuple)):
        return [_host(o) for o in out]
    if torch.is_tensor(out):
        return out.detach().cpu().numpy()
    return np.asarray(out)


def forward(mv, x: np.ndarray, expected: bool = False):
    """``mv.model.output(x)`` on the host, through ``mv``'s detector.  On
    the card the call is a captured graph's replay, or its capture when
    the net holds no graph for ``x``'s shape: that capture is the compile
    the detector counts (a bucket set larger than the net's graph cache
    shows as captures on every pass of its LRU).  Where nothing is
    captured, a new signature is the compile."""
    model = mv.model
    graphs = (cap.step_graphs(model)
              if hasattr(model, "device") and cap.captures(model) else None)
    before = graphs.captures if graphs is not None else 0
    out = _host(model.output(x))
    mv.detector.check((x,), {}, expected=expected,
                      captured=(None if graphs is None
                                else graphs.captures > before))
    return out
