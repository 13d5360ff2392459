"""Datasets (counterpart of ``deeplearning4j_tpu.datasets``).

Ported: ``DataSet`` and the iterators (``iterator.py``: list, iterator
re-batching, multiple epochs, sampling, the async prefetch; the native
batcher raises until the port builds it).  The multi-dataset and the
mnist/iris/cifar/lfw/curves/datavec/export readers come with ROADMAP A8.
"""

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterator import (
    AsyncDataSetIterator,
    DataSetIterator,
    IteratorDataSetIterator,
    ListDataSetIterator,
    MultipleEpochsIterator,
    NativeBatchDataSetIterator,
    SamplingDataSetIterator,
)

__all__ = ["DataSet", "AsyncDataSetIterator", "DataSetIterator",
           "IteratorDataSetIterator", "ListDataSetIterator",
           "MultipleEpochsIterator", "NativeBatchDataSetIterator",
           "SamplingDataSetIterator"]
