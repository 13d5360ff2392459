"""DataSet container — features + labels (+ masks), host-side numpy.

Reference: ND4J ``DataSet`` (features/labels/featuresMask/labelsMask) used
throughout ``deeplearning4j-nn/.../datasets``.  Host arrays stay numpy;
they reach the device once a step, staged into the step's static
buffers.  Static-shape discipline: ``pad_batch`` pads the last short
minibatch so the captured step is not captured again.

Port: a copy of ``deeplearning4j_tpu/datasets/dataset.py`` with its imports
rewritten to the port.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class DataSet:
    features: np.ndarray
    labels: np.ndarray
    features_mask: Optional[np.ndarray] = None
    labels_mask: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return self.features.shape[0]

    def num_examples(self) -> int:
        return len(self)

    def split_test_and_train(self, n_train: int, rng: Optional[np.random.RandomState] = None
                             ) -> Tuple["DataSet", "DataSet"]:
        idx = np.arange(len(self))
        if rng is not None:
            rng.shuffle(idx)
        tr, te = idx[:n_train], idx[n_train:]
        return self.subset(tr), self.subset(te)

    def subset(self, idx) -> "DataSet":
        return DataSet(
            self.features[idx],
            self.labels[idx],
            None if self.features_mask is None else self.features_mask[idx],
            None if self.labels_mask is None else self.labels_mask[idx],
        )

    def shuffle(self, rng: np.random.RandomState) -> "DataSet":
        idx = np.arange(len(self))
        rng.shuffle(idx)
        return self.subset(idx)

    def batch_by(self, batch_size: int, drop_last: bool = False) -> List["DataSet"]:
        out = []
        for i in range(0, len(self), batch_size):
            b = self.subset(slice(i, i + batch_size))
            if len(b) < batch_size:
                if drop_last:
                    continue
                b = b.pad_batch(batch_size)
            out.append(b)
        return out

    def pad_batch(self, batch_size: int) -> "DataSet":
        """Pad to a fixed batch size with zero rows + zero label-mask so the
        padded rows contribute nothing to masked losses, keeping shapes
        static for the captured step."""
        n = len(self)
        if n == batch_size:
            return self
        pad = batch_size - n

        def _pad(a):
            if a is None:
                return None
            return np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)], 0)

        fm = self.features_mask
        lm = self.labels_mask
        if lm is None and self.labels.ndim >= 2:
            # synthesize a labels mask marking real rows
            shape = (batch_size,) if self.labels.ndim == 2 else (batch_size, self.labels.shape[1])
            lm = np.zeros(shape, np.float32)
            lm[:n] = 1.0
            return DataSet(_pad(self.features), _pad(self.labels), _pad(fm), lm)
        return DataSet(_pad(self.features), _pad(self.labels), _pad(fm), _pad(lm))

    def as_tuple(self):
        return (self.features, self.labels, self.features_mask, self.labels_mask)

    @staticmethod
    def merge(datasets: List["DataSet"]) -> "DataSet":
        return DataSet(
            np.concatenate([d.features for d in datasets], 0),
            np.concatenate([d.labels for d in datasets], 0),
            None if datasets[0].features_mask is None
            else np.concatenate([d.features_mask for d in datasets], 0),
            None if datasets[0].labels_mask is None
            else np.concatenate([d.labels_mask for d in datasets], 0),
        )
