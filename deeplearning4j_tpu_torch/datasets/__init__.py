"""Datasets (counterpart of ``deeplearning4j_tpu.datasets``).

``DataSet`` and ``MultiDataSet``; the iterators (list, iterator
re-batching, multiple epochs, sampling, the async prefetch, and
``NativeBatchDataSetIterator`` over the port's own native batcher,
``deeplearning4j_tpu_torch/native``); the multi-dataset and record-reader
iterators (``multidataset.py``, ``datavec.py``: CSV through the native
parser); the exported ``D4JT`` batch files (``export.py``); and the
mnist, iris, cifar, lfw and curves readers.  Every iterator hands out
numpy arrays: a batch reaches the card in the training step.
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
from deeplearning4j_tpu_torch.datasets.multidataset import (
    AsyncMultiDataSetIterator,
    ListMultiDataSetIterator,
    MultiDataSet,
    MultiDataSetIterator,
    RecordReaderMultiDataSetIterator,
)
from deeplearning4j_tpu_torch.datasets.mnist import MnistDataSetIterator
from deeplearning4j_tpu_torch.datasets.iris import IrisDataSetIterator
from deeplearning4j_tpu_torch.datasets.cifar import CifarDataSetIterator
from deeplearning4j_tpu_torch.datasets.curves import CurvesDataSetIterator
from deeplearning4j_tpu_torch.datasets.lfw import LFWDataSetIterator
from deeplearning4j_tpu_torch.datasets.export import (
    FileDataSetIterator, export_datasets,
)
from deeplearning4j_tpu_torch.datasets import datavec

__all__ = ["DataSet", "AsyncDataSetIterator", "DataSetIterator",
           "IteratorDataSetIterator", "ListDataSetIterator",
           "MultipleEpochsIterator", "NativeBatchDataSetIterator",
           "SamplingDataSetIterator", "AsyncMultiDataSetIterator",
           "ListMultiDataSetIterator", "MultiDataSet",
           "MultiDataSetIterator", "RecordReaderMultiDataSetIterator",
           "MnistDataSetIterator", "IrisDataSetIterator",
           "CifarDataSetIterator", "CurvesDataSetIterator",
           "LFWDataSetIterator", "FileDataSetIterator", "export_datasets",
           "datavec"]
