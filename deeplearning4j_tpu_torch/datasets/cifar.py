"""CIFAR-10 fetcher + iterator.

Reference: ``deeplearning4j-core/.../datasets/iterator/impl/CifarDataSetIterator.java``
(+ ``CifarLoader``): downloads the CIFAR-10 binary archive and parses the
``data_batch_N.bin`` record format (1 label byte + 3072 RGB bytes per
record).  No network egress here, so:
 1. parse real binary batches from ``DL4J_TPU_CIFAR_DIR`` (or
    ``~/.deeplearning4j_tpu/cifar10``) when present;
 2. otherwise generate a deterministic synthetic CIFAR-shaped dataset
    (class-colored geometric patterns + noise), flagged ``is_synthetic``.

Features come out flat [n, 3072] in CHW order like the reference loader;
use ``InputType.convolutional_flat(32, 32, 3)`` for conv nets.

Port: a copy of ``deeplearning4j_tpu/datasets/cifar.py`` with its imports
rewritten.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_log = logging.getLogger(__name__)

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterator import ListDataSetIterator

NUM_CLASSES = 10
RECORD_BYTES = 1 + 3072

_TRAIN_FILES = [f"data_batch_{i}.bin" for i in range(1, 6)]
_TEST_FILES = ["test_batch.bin"]


def _parse_batch_file(path: Path) -> Tuple[np.ndarray, np.ndarray]:
    raw = np.frombuffer(path.read_bytes(), np.uint8)
    n = len(raw) // RECORD_BYTES
    recs = raw[: n * RECORD_BYTES].reshape(n, RECORD_BYTES)
    labels = recs[:, 0].astype(np.int64)
    images = recs[:, 1:].astype(np.float32) / 255.0  # CHW flat, like CifarLoader
    return images, labels


def write_cifar_batch(path, images_u8: np.ndarray, labels: np.ndarray) -> None:
    """Format inverse of ``_parse_batch_file`` — writes the CIFAR-10 binary
    batch record layout (1 label byte + 3072 CHW RGB bytes per record) so
    the REAL parse branch can be exercised hermetically (no egress; the
    same ``write_idx`` trick tests/test_mnist_idx.py uses)."""
    images_u8 = np.asarray(images_u8, np.uint8).reshape(len(images_u8), 3072)
    labels = np.asarray(labels, np.uint8).reshape(-1, 1)
    if len(images_u8) != len(labels):
        raise ValueError(f"{len(images_u8)} images vs {len(labels)} labels")
    Path(path).write_bytes(
        np.concatenate([labels, images_u8], axis=1).tobytes())


def _find_dir(data_dir: Optional[str]) -> Path:
    return Path(data_dir or os.environ.get(
        "DL4J_TPU_CIFAR_DIR", Path.home() / ".deeplearning4j_tpu" / "cifar10"))


def _synthetic_cifar(n: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """Class-dependent color gradients + per-class frequency patterns."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, NUM_CLASSES, n)
    yy, xx = np.meshgrid(np.linspace(0, 1, 32), np.linspace(0, 1, 32),
                         indexing="ij")
    imgs = np.zeros((n, 3, 32, 32), np.float32)
    for i, c in enumerate(labels):
        phase = 2 * np.pi * c / NUM_CLASSES
        base = 0.5 + 0.5 * np.sin(2 * np.pi * (c + 1) * (xx + yy) / 4 + phase)
        imgs[i, 0] = base * (0.3 + 0.07 * c)
        imgs[i, 1] = (1 - base) * (1.0 - 0.05 * c)
        imgs[i, 2] = 0.5 + 0.5 * np.cos(2 * np.pi * (c + 1) * (xx - yy) / 4)
        imgs[i] += rng.rand(3, 32, 32).astype(np.float32) * 0.1
    return np.clip(imgs, 0, 1).reshape(n, 3072), labels


class CifarDataFetcher:
    def __init__(self, train: bool = True, data_dir: Optional[str] = None,
                 num_examples: Optional[int] = None, seed: int = 123,
                 allow_synthetic: bool = True):
        root = _find_dir(data_dir)
        names = _TRAIN_FILES if train else _TEST_FILES
        files = [root / f for f in names if (root / f).exists()]
        # also accept the extracted cifar-10-batches-bin subdir layout
        sub = root / "cifar-10-batches-bin"
        if not files and sub.exists():
            files = [sub / f for f in names if (sub / f).exists()]
        self.is_synthetic = not files
        if files:
            parts = [_parse_batch_file(f) for f in files]
            images = np.concatenate([p[0] for p in parts])
            labels = np.concatenate([p[1] for p in parts])
        else:
            if not allow_synthetic:
                raise FileNotFoundError(
                    f"CIFAR-10 binaries not found under {root}; set "
                    "DL4J_TPU_CIFAR_DIR")
            _log.warning(
                "CIFAR-10 binaries not found under %s — using SYNTHETIC "
                "class-colored patterns (is_synthetic=True). Point "
                "DL4J_TPU_CIFAR_DIR at the real batches, or pass "
                "allow_synthetic=False to fail instead.", root)
            n = num_examples or (2048 if train else 512)
            images, labels = _synthetic_cifar(n, seed if train else seed + 1)
        if num_examples is not None:
            images, labels = images[:num_examples], labels[:num_examples]
        self.features = images
        self.labels = np.eye(NUM_CLASSES, dtype=np.float32)[labels]

    def dataset(self) -> DataSet:
        return DataSet(self.features, self.labels)


class CifarDataSetIterator(ListDataSetIterator):
    def __init__(self, batch_size: int, num_examples: Optional[int] = None,
                 train: bool = True, seed: int = 123,
                 data_dir: Optional[str] = None, drop_last: bool = False):
        fetcher = CifarDataFetcher(train=train, data_dir=data_dir,
                                   num_examples=num_examples, seed=seed)
        self.is_synthetic = fetcher.is_synthetic
        super().__init__(fetcher.dataset(), batch_size, drop_last=drop_last)
