"""MNIST fetcher + iterator.

Reference: ``deeplearning4j-core/.../datasets/fetchers/MnistDataFetcher.java:40-84``
(downloads then parses the IDX binary files) + ``MnistManager``/
``MnistImageFile``.  This environment has no network egress, so the fetcher:
 1. parses standard IDX files from ``DL4J_TPU_MNIST_DIR`` (or
    ``~/.deeplearning4j_tpu/mnist``) when the user has them;
 2. otherwise generates a *deterministic synthetic* MNIST-shaped dataset
    (procedurally rendered digit glyphs + noise, stable across runs) so
    tests and benchmarks are hermetic.  Synthetic mode is flagged on the
    iterator (``is_synthetic``), with a warning.

Port: a copy of ``deeplearning4j_tpu/datasets/mnist.py``; the IDX files
are decoded by the port's native parser (``native.parse_idx_images``,
``parse_idx_labels``: multithreaded, the same float32 values as the
reference's numpy decode).
"""

from __future__ import annotations

import gzip
import logging
import os
import struct
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_log = logging.getLogger(__name__)

from deeplearning4j_tpu_torch import native
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterator import ListDataSetIterator

# 5x7 bitmap glyphs for digits 0-9 (classic font), used for synthetic mode.
_GLYPHS = {
    0: ["01110", "10001", "10011", "10101", "11001", "10001", "01110"],
    1: ["00100", "01100", "00100", "00100", "00100", "00100", "01110"],
    2: ["01110", "10001", "00001", "00010", "00100", "01000", "11111"],
    3: ["11111", "00010", "00100", "00010", "00001", "10001", "01110"],
    4: ["00010", "00110", "01010", "10010", "11111", "00010", "00010"],
    5: ["11111", "10000", "11110", "00001", "00001", "10001", "01110"],
    6: ["00110", "01000", "10000", "11110", "10001", "10001", "01110"],
    7: ["11111", "00001", "00010", "00100", "01000", "01000", "01000"],
    8: ["01110", "10001", "10001", "01110", "10001", "10001", "01110"],
    9: ["01110", "10001", "10001", "01111", "00001", "00010", "01100"],
}


def write_idx(path: Path, array: np.ndarray) -> None:
    """Write ``array`` as an IDX (ubyte) file — the MNIST binary layout the
    reference downloads and parses (``deeplearning4j-core/.../base/
    MnistFetcher.java:35``, binary readers ``datasets/mnist/
    MnistManager.java`` + ``MnistImageFile/MnistLabelFile``): 2 zero bytes,
    dtype code 0x08 (unsigned byte), ndim, big-endian uint32 dims, raw
    data.  A ``.gz`` suffix gzips the stream (as the reference's fetcher
    stores them).  This is the hermetic inverse of the fetcher's parse — it lets
    tests and offline rigs exercise the REAL parse branch
    (``is_synthetic=False``) without network egress."""
    path = Path(path)
    array = np.ascontiguousarray(array, np.uint8)
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "wb") as f:
        f.write(struct.pack(">HBB", 0, 0x08, array.ndim))
        f.write(struct.pack(">" + "I" * array.ndim, *array.shape))
        f.write(array.tobytes())


def _idx_bytes(path: Path) -> bytes:
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rb") as f:
        return f.read()


def _find_idx_files(root: Path, train: bool) -> Optional[Tuple[Path, Path]]:
    img_names = (
        ["train-images-idx3-ubyte", "train-images.idx3-ubyte"]
        if train
        else ["t10k-images-idx3-ubyte", "t10k-images.idx3-ubyte"]
    )
    lbl_names = (
        ["train-labels-idx1-ubyte", "train-labels.idx1-ubyte"]
        if train
        else ["t10k-labels-idx1-ubyte", "t10k-labels.idx1-ubyte"]
    )
    for img in img_names:
        for suffix in ("", ".gz"):
            ip = root / (img + suffix)
            if ip.exists():
                for lbl in lbl_names:
                    lp = root / (lbl + suffix)
                    if lp.exists():
                        return ip, lp
    return None


def _synthetic_mnist(n: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic MNIST-shaped data: scaled/shifted digit glyphs + noise."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 10, n)
    imgs = np.zeros((n, 28, 28), np.float32)
    glyphs = {}
    for d, rows in _GLYPHS.items():
        g = np.array([[float(c) for c in r] for r in rows], np.float32)
        # upscale 5x7 -> 15x21
        glyphs[d] = np.kron(g, np.ones((3, 3), np.float32))
    for i, d in enumerate(labels):
        g = glyphs[d]
        oy = rng.randint(0, 28 - g.shape[0])
        ox = rng.randint(0, 28 - g.shape[1])
        img = np.zeros((28, 28), np.float32)
        img[oy : oy + g.shape[0], ox : ox + g.shape[1]] = g
        img += rng.rand(28, 28).astype(np.float32) * 0.15
        imgs[i] = np.clip(img, 0, 1)
    return imgs, labels


class MnistDataFetcher:
    NUM_EXAMPLES_TRAIN = 60000
    NUM_EXAMPLES_TEST = 10000

    def __init__(self, train: bool = True, data_dir: Optional[str] = None,
                 num_examples: Optional[int] = None, seed: int = 123,
                 allow_synthetic: bool = True):
        root = Path(data_dir or os.environ.get(
            "DL4J_TPU_MNIST_DIR", Path.home() / ".deeplearning4j_tpu" / "mnist"
        ))
        found = _find_idx_files(root, train) if root.exists() else None
        self.is_synthetic = found is None
        onehot = None
        if found is not None:
            images = native.parse_idx_images(_idx_bytes(found[0]))
            onehot = native.parse_idx_labels(_idx_bytes(found[1]), 10)
        else:
            if not allow_synthetic:
                raise FileNotFoundError(
                    f"MNIST IDX files not found under {root}; set DL4J_TPU_MNIST_DIR"
                )
            _log.warning(
                "MNIST IDX files not found under %s — using deterministic "
                "SYNTHETIC digit glyphs (is_synthetic=True). Point "
                "DL4J_TPU_MNIST_DIR at real IDX files, or pass "
                "allow_synthetic=False to fail instead.", root)
            n = num_examples or (2048 if train else 512)
            images, labels = _synthetic_mnist(n, seed if train else seed + 1)
        if onehot is None:
            onehot = np.eye(10, dtype=np.float32)[labels]
        if num_examples is not None:
            images, onehot = images[:num_examples], onehot[:num_examples]
        self.features = images.reshape(len(images), 784)
        self.labels = onehot

    def dataset(self) -> DataSet:
        return DataSet(self.features, self.labels)


class MnistDataSetIterator(ListDataSetIterator):
    """Reference ``MnistDataSetIterator``: batched MNIST with one-hot labels,
    features scaled to [0,1], flat 784 vectors (use
    ``InputType.convolutional_flat(28,28,1)`` for conv nets)."""

    def __init__(self, batch_size: int, num_examples: Optional[int] = None,
                 train: bool = True, seed: int = 123, data_dir: Optional[str] = None,
                 drop_last: bool = False):
        fetcher = MnistDataFetcher(train=train, data_dir=data_dir,
                                   num_examples=num_examples, seed=seed)
        self.is_synthetic = fetcher.is_synthetic
        super().__init__(fetcher.dataset(), batch_size, drop_last=drop_last)
