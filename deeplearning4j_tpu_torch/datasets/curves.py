"""Curves dataset — synthetic parametric curve images for pretraining tests.

Reference: ``deeplearning4j-core/.../datasets/fetchers/CurvesDataFetcher.java``
(downloads a fixed curves dataset used by the deep-autoencoder examples).
The dataset is inherently synthetic; here it is generated deterministically:
each example renders a random smooth parametric curve (random low-order
Fourier coefficients) onto a 28x28 canvas.  Unsupervised: labels == features
(autoencoder reconstruction targets), exactly how the reference uses it.

Port: a copy of ``deeplearning4j_tpu/datasets/curves.py`` with its imports
rewritten.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterator import ListDataSetIterator

SIDE = 28


def _render_curve(rng: np.random.RandomState) -> np.ndarray:
    t = np.linspace(0, 2 * np.pi, 200)
    x = np.zeros_like(t)
    y = np.zeros_like(t)
    for k in range(1, 4):
        x = x + rng.randn() / k * np.cos(k * t) + rng.randn() / k * np.sin(k * t)
        y = y + rng.randn() / k * np.cos(k * t) + rng.randn() / k * np.sin(k * t)
    # normalize into the canvas with a margin
    x = (x - x.min()) / max(np.ptp(x), 1e-6) * (SIDE - 5) + 2
    y = (y - y.min()) / max(np.ptp(y), 1e-6) * (SIDE - 5) + 2
    img = np.zeros((SIDE, SIDE), np.float32)
    img[y.astype(int), x.astype(int)] = 1.0
    return img


def curves(n: int = 1024, seed: int = 123) -> Tuple[np.ndarray, np.ndarray]:
    rng = np.random.RandomState(seed)
    feats = np.stack([_render_curve(rng).reshape(-1) for _ in range(n)])
    return feats, feats.copy()


class CurvesDataSetIterator(ListDataSetIterator):
    def __init__(self, batch_size: int, num_examples: int = 1024,
                 seed: int = 123, drop_last: bool = False):
        feats, labels = curves(num_examples, seed)
        super().__init__(DataSet(feats, labels), batch_size,
                         drop_last=drop_last)
