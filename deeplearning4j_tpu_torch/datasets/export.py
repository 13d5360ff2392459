"""Batch-and-export DataSet files + a file-backed iterator.

Reference: ``spark/data/BatchAndExportDataSetsFunction.java`` (re-batch an
RDD of DataSets and persist each minibatch as a file) and the portable
path/stream iterators (``spark/iterator/*.java``) that train directly from
those files on executors.  The binary container is the native C++ format
(``deeplearning4j_tpu_torch/native``: 'D4JT' header + f32 payloads), so
export and re-read round-trip through native IO; a file either package
writes is byte-equal to the other's.

Port: a copy of ``deeplearning4j_tpu/datasets/export.py`` with its imports
rewritten.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Union

import numpy as np

from deeplearning4j_tpu_torch import native
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterator import DataSetIterator


def export_datasets(iterator: DataSetIterator, out_dir: Union[str, Path],
                    prefix: str = "dataset") -> List[Path]:
    """Persist every minibatch of `iterator` as `<prefix>_<i>.bin`.

    Masks (e.g. the synthesized labels mask on a zero-padded final batch)
    round-trip through an `<name>.masks.npz` sidecar so padded rows stay
    invalid after re-read."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    paths = []
    iterator.reset()
    i = 0
    while iterator.has_next():
        ds = iterator.next()
        p = out / f"{prefix}_{i:05d}.bin"  # zero-padded so glob-sort == order
        native.write_dataset(p, ds.features, ds.labels)
        if ds.features_mask is not None or ds.labels_mask is not None:
            masks = {}
            if ds.features_mask is not None:
                masks["features_mask"] = ds.features_mask
            if ds.labels_mask is not None:
                masks["labels_mask"] = ds.labels_mask
            np.savez(p.with_suffix(".masks.npz"), **masks)
        paths.append(p)
        i += 1
    return paths


class FileDataSetIterator(DataSetIterator):
    """Iterates exported minibatch files in name order; shapes are restored
    flat ([batch, -1]) which matches the framework's layer input contract."""

    def __init__(self, directory: Union[str, Path], pattern: str = "*.bin"):
        self._paths = sorted(Path(directory).glob(pattern))
        if not self._paths:
            raise FileNotFoundError(f"no {pattern} files in {directory}")
        self._pos = 0

    def has_next(self):
        return self._pos < len(self._paths)

    def next(self) -> DataSet:
        path = self._paths[self._pos]
        feat, lab = native.read_dataset(path)
        self._pos += 1
        if lab is None:
            lab = np.zeros((len(feat), 0), np.float32)
        fmask = lmask = None
        sidecar = path.with_suffix(".masks.npz")
        if sidecar.exists():
            with np.load(sidecar) as z:
                fmask = z.get("features_mask")
                lmask = z.get("labels_mask")
        return DataSet(feat, lab, fmask, lmask)

    def reset(self):
        self._pos = 0

    def batch(self):
        n, _, _ = native.dataset_header(self._paths[0])
        return n
