"""LFW (Labeled Faces in the Wild) fetcher + iterator.

Reference: ``deeplearning4j-core/.../datasets/fetchers/LFWDataFetcher.java``
+ ``iterator/impl/LFWDataSetIterator.java`` (downloads the LFW archive, one
directory per person, images resized to a fixed shape, person index as the
class label).  No egress here, so:
 1. parse the reference's on-disk layout — one DIRECTORY per person under
    ``DL4J_TPU_LFW_DIR``, containing P5 PGM images (parsed natively, no
    image library), sorted person-directory index as the class label,
    nearest-neighbour resize to ``SIDE`` x ``SIDE`` — when present;
 2. else load pre-extracted ``faces.npy``/``labels.npy`` arrays;
 3. otherwise generate deterministic synthetic face-shaped images
    (elliptical head + class-dependent feature geometry), flagged
    ``is_synthetic``.

Port: a copy of ``deeplearning4j_tpu/datasets/lfw.py`` with its imports
rewritten, and one repair: a PGM header that ends in ``\r\n`` (as a
Windows tool writes it) reads the same pixels as one ending in ``\n``;
the reference skips one byte after maxval and shifts every pixel.
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

SIDE = 40


def read_pgm(path) -> np.ndarray:
    """Parse a binary (P5) PGM image to a uint8 [H, W] array — native
    parse of a real image format, no image library (the reference decodes
    its jpgs through ImageLoader; PGM keeps the branch hermetic)."""
    raw = Path(path).read_bytes()
    fields, pos = [], 0
    while len(fields) < 4:  # magic, width, height, maxval
        if pos >= len(raw):
            raise ValueError(f"{path}: truncated PGM header")
        if raw[pos:pos + 1] == b"#":          # comment to end of line
            pos = raw.index(b"\n", pos) + 1
            continue
        if raw[pos:pos + 1].isspace():
            pos += 1
            continue
        end = pos
        while end < len(raw) and not raw[end:end + 1].isspace():
            end += 1
        fields.append(raw[pos:end])
        pos = end
    if fields[0] != b"P5":
        raise ValueError(f"{path}: not a binary P5 PGM (magic {fields[0]!r})")
    w, h, maxval = int(fields[1]), int(fields[2]), int(fields[3])
    if maxval > 255:
        raise ValueError(f"{path}: 16-bit PGM unsupported (maxval {maxval})")
    # one whitespace byte ends the header, or "\r\n"; a lone "\r"
    # followed by a pixel of value 10 is told apart by the byte count
    if not raw[pos:pos + 1].isspace():
        raise ValueError(f"{path}: no whitespace after the PGM maxval")
    pos += 2 if (raw[pos:pos + 2] == b"\r\n"
                 and len(raw) - pos - 2 >= w * h) else 1
    if len(raw) - pos < w * h:
        raise ValueError(f"{path}: truncated PGM data ({len(raw) - pos} of "
                         f"{w * h} bytes)")
    img = np.frombuffer(raw, np.uint8, count=w * h, offset=pos)
    return img.reshape(h, w)


def write_pgm(path, img_u8: np.ndarray) -> None:
    """Format inverse of ``read_pgm`` (binary P5) for hermetic fixtures."""
    img_u8 = np.asarray(img_u8, np.uint8)
    h, w = img_u8.shape
    Path(path).write_bytes(b"P5\n%d %d\n255\n" % (w, h) + img_u8.tobytes())


def _resize_nearest(img: np.ndarray, side: int) -> np.ndarray:
    h, w = img.shape
    ys = (np.arange(side) * h // side).clip(0, h - 1)
    xs = (np.arange(side) * w // side).clip(0, w - 1)
    return img[np.ix_(ys, xs)]


def _load_person_dirs(root: Path) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """The reference's archive layout: ``root/<person>/*.pgm``, label =
    sorted person index (LFWDataFetcher labels by directory)."""
    people = sorted(p for p in root.iterdir() if p.is_dir()
                    and any(p.glob("*.pgm")))
    if not people:
        return None
    feats, labels = [], []
    for idx, person in enumerate(people):
        for img_path in sorted(person.glob("*.pgm")):
            img = _resize_nearest(read_pgm(img_path), SIDE)
            feats.append(img.astype(np.float32).reshape(-1) / 255.0)
            labels.append(idx)
    return np.stack(feats), np.asarray(labels, np.int64)


def _synthetic_faces(n: int, num_classes: int, seed: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, num_classes, n)
    yy, xx = np.meshgrid(np.arange(SIDE), np.arange(SIDE), indexing="ij")
    imgs = np.zeros((n, SIDE, SIDE), np.float32)
    for i, c in enumerate(labels):
        cy, cx = SIDE / 2 + rng.randn(), SIDE / 2 + rng.randn()
        ry = SIDE * (0.32 + 0.015 * (c % 5))
        rx = SIDE * (0.25 + 0.012 * (c % 7))
        head = (((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2) < 1.0
        img = head.astype(np.float32) * 0.6
        eye_dy, eye_dx = SIDE * 0.12, SIDE * (0.10 + 0.01 * (c % 3))
        for sx in (-1, 1):
            ey, ex = int(cy - eye_dy), int(cx + sx * eye_dx)
            img[ey - 1:ey + 2, ex - 1:ex + 2] = 1.0
        mw = int(SIDE * (0.06 + 0.01 * (c % 4)))
        my = int(cy + SIDE * 0.15)
        img[my, int(cx) - mw:int(cx) + mw + 1] = 1.0
        img += rng.rand(SIDE, SIDE).astype(np.float32) * 0.1
        imgs[i] = np.clip(img, 0, 1)
    return imgs.reshape(n, SIDE * SIDE), labels


class LFWDataFetcher:
    def __init__(self, num_examples: Optional[int] = None,
                 num_classes: int = 10, data_dir: Optional[str] = None,
                 seed: int = 123, allow_synthetic: bool = True):
        root = Path(data_dir or os.environ.get(
            "DL4J_TPU_LFW_DIR", Path.home() / ".deeplearning4j_tpu" / "lfw"))
        feats = labels = None
        if root.is_dir():
            loaded = _load_person_dirs(root)
            if loaded is not None:
                feats, labels = loaded
                num_classes = int(labels.max()) + 1
        if feats is None and (root / "faces.npy").exists() \
                and (root / "labels.npy").exists():
            feats = np.load(root / "faces.npy").astype(np.float32)
            labels = np.load(root / "labels.npy").astype(np.int64)
            feats = feats.reshape(len(feats), -1)
            num_classes = int(labels.max()) + 1
        self.is_synthetic = feats is None
        if feats is None:
            if not allow_synthetic:
                raise FileNotFoundError(
                    f"LFW arrays not found under {root}; set DL4J_TPU_LFW_DIR")
            _log.warning(
                "LFW arrays not found under %s — using SYNTHETIC faces "
                "(is_synthetic=True). Point DL4J_TPU_LFW_DIR at real data, "
                "or pass allow_synthetic=False to fail instead.", root)
            n = num_examples or 1024
            feats, labels = _synthetic_faces(n, num_classes, seed)
        if num_examples is not None:
            feats, labels = feats[:num_examples], labels[:num_examples]
        self.num_classes = num_classes
        self.features = feats
        self.labels = np.eye(num_classes, dtype=np.float32)[labels]

    def dataset(self) -> DataSet:
        return DataSet(self.features, self.labels)


class LFWDataSetIterator(ListDataSetIterator):
    def __init__(self, batch_size: int, num_examples: Optional[int] = None,
                 num_classes: int = 10, seed: int = 123,
                 data_dir: Optional[str] = None, drop_last: bool = False):
        fetcher = LFWDataFetcher(num_examples=num_examples,
                                 num_classes=num_classes, data_dir=data_dir,
                                 seed=seed)
        self.is_synthetic = fetcher.is_synthetic
        self.num_classes = fetcher.num_classes
        super().__init__(fetcher.dataset(), batch_size, drop_last=drop_last)
