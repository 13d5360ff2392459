"""Datasets (counterpart of ``deeplearning4j_tpu.datasets``).

Ported: ``DataSet``.  The iterators (async prefetch included), the
multi-dataset and the mnist/iris/cifar/lfw/curves/datavec/export
readers come with ROADMAP A8.
"""

from deeplearning4j_tpu_torch.datasets.dataset import DataSet

__all__ = ["DataSet"]
