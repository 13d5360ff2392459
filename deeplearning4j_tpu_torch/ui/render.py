"""Weight/activation rendering — grids + PNG export, dependency-free.

Reference: ``deeplearning4j-ui/.../weights/ConvolutionalIterationListener.java``
(renders per-channel conv activations as an image grid each N iterations)
and the render utils under ``deeplearning4j-core/.../plot``.  PNG encoding
is a minimal grayscale writer (zlib + struct), so no imaging dependency.

Port: a copy of ``deeplearning4j_tpu/ui/render.py`` with its imports
rewritten.  ``ConvolutionalIterationListener`` runs after a step's
replay: ``feed_forward`` is an eager forward outside autograd on the
net's parameters (no capture, no program of the net's graph cache, no
slot of its pinned ring), and the probe's activation is copied to the
host.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.optimize.listeners import IterationListener


def _host(a) -> np.ndarray:
    return a.detach().float().cpu().numpy() if torch.is_tensor(a) \
        else np.asarray(a)


def normalize01(arr: np.ndarray) -> np.ndarray:
    arr = np.asarray(arr, np.float32)
    lo, hi = float(arr.min()), float(arr.max())
    if hi - lo < 1e-12:
        return np.zeros_like(arr)
    return (arr - lo) / (hi - lo)


def activation_grid(activations: np.ndarray, pad: int = 1,
                    channels_last: bool = True) -> np.ndarray:
    """Channel maps -> one [rows*H, cols*W] grid, each channel normalized
    independently (reference grid rendering).  Layout is explicit
    (channels_last: [H, W, C]; else [C, H, W]) — shape-based guessing is
    ambiguous when C and H/W are close."""
    a = np.asarray(activations)
    if a.ndim != 3:
        raise ValueError(f"expected 3-D channel maps, got shape {a.shape}")
    if not channels_last:  # [C, H, W] -> [H, W, C]
        a = np.transpose(a, (1, 2, 0))
    h, w, c = a.shape
    cols = int(np.ceil(np.sqrt(c)))
    rows = int(np.ceil(c / cols))
    grid = np.zeros((rows * (h + pad) - pad, cols * (w + pad) - pad),
                    np.float32)
    for i in range(c):
        r, col = divmod(i, cols)
        grid[r * (h + pad):r * (h + pad) + h,
             col * (w + pad):col * (w + pad) + w] = normalize01(a[:, :, i])
    return grid


def write_png(path, image01: np.ndarray) -> None:
    """Write a [H, W] float array in [0,1] as an 8-bit grayscale PNG."""
    img = np.clip(np.asarray(image01, np.float32), 0, 1)
    if img.ndim != 2:
        raise ValueError(f"expected 2-D image, got shape {img.shape}")
    data = (img * 255).astype(np.uint8)
    h, w = data.shape
    raw = b"".join(b"\x00" + data[r].tobytes() for r in range(h))

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload)))

    png = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(raw))
           + chunk(b"IEND", b""))
    Path(path).write_bytes(png)


class ConvolutionalIterationListener(IterationListener):
    """Every `frequency` iterations, renders the first conv-shaped
    activation of a probe input to a PNG grid in `out_dir`.
    ≙ ``ConvolutionalIterationListener.java``."""

    def __init__(self, probe_input: np.ndarray, out_dir,
                 frequency: int = 10, layer_index: Optional[int] = None):
        self.probe = np.asarray(probe_input)
        self.out_dir = Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.frequency = max(frequency, 1)
        self.layer_index = layer_index
        self.rendered = []

    def iteration_done(self, model, iteration: int) -> None:
        if iteration % self.frequency != 0:
            return
        acts = model.feed_forward(self.probe[:1])
        if isinstance(acts, dict):  # ComputationGraph: name -> activation
            # drop input vertices so index semantics match the MLN list
            # (acts is seeded with the raw inputs, which are also rank-4)
            inputs = set(getattr(model.conf, "inputs", ()))
            acts = [a for name, a in acts.items() if name not in inputs]
        chosen = None
        for i, a in enumerate(acts):
            if self.layer_index is not None:
                if i == self.layer_index:
                    if a.ndim == 4:
                        chosen = a
                    break  # non-conv selection: skip silently, don't kill fit
            elif a.ndim == 4:  # [b, h, w, c]
                chosen = a
                break
        if chosen is None:
            return
        # the one activation rendered is copied to the host
        grid = activation_grid(_host(chosen[0]))
        path = self.out_dir / f"activations_iter{iteration}.png"
        write_png(path, grid)
        self.rendered.append(path)
