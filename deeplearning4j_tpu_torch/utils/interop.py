"""Framework interop — the MLLib bridge analog; counterpart of
``deeplearning4j_tpu/utils/interop.py`` over the port's ``DataSet``.

Reference: ``spark/dl4j-spark/.../util/MLLibUtil.java`` (MLLib Vector/Matrix
<-> INDArray, LabeledPoint <-> DataSet).  The ecosystem neighbour here is
torch rather than Spark MLLib: tensors and TensorDatasets convert
both ways, plus the labeled-point style (features, label-class) pairs the
reference converts for classifier training.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

import numpy as np
import torch
import torch.utils.data as tud

from deeplearning4j_tpu_torch.datasets.dataset import DataSet


def to_torch(arr):
    """numpy array -> torch tensor (CPU, shares memory when possible)."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(arr)))


def from_torch(tensor) -> np.ndarray:
    """torch tensor (on any device) -> numpy array."""
    return tensor.detach().cpu().numpy()


def dataset_to_torch(ds: DataSet):
    """DataSet -> torch.utils.data.TensorDataset(features, labels)."""
    return tud.TensorDataset(to_torch(ds.features), to_torch(ds.labels))


def dataset_from_torch(tensor_dataset) -> DataSet:
    """torch TensorDataset (features, labels) -> DataSet."""
    feats, labels = tensor_dataset.tensors[:2]
    return DataSet(from_torch(feats).astype(np.float32),
                   from_torch(labels).astype(np.float32))


def labeled_points_to_dataset(points: Iterable[Tuple[Sequence[float], int]],
                              num_classes: int) -> DataSet:
    """[(features, class_index)] -> DataSet with one-hot labels.
    ≙ ``MLLibUtil.fromLabeledPoint``."""
    feats: List[np.ndarray] = []
    labels: List[int] = []
    for f, c in points:
        feats.append(np.asarray(f, np.float32))
        labels.append(int(c))
    return DataSet(np.stack(feats),
                   np.eye(num_classes, dtype=np.float32)[labels])


def dataset_to_labeled_points(ds: DataSet) -> List[Tuple[np.ndarray, int]]:
    """DataSet -> [(features, argmax class)].  ≙ ``MLLibUtil.toLabeledPoint``."""
    return [(ds.features[i], int(ds.labels[i].argmax()))
            for i in range(len(ds))]
