"""Utilities (counterpart of ``deeplearning4j_tpu.utils``)."""

from deeplearning4j_tpu_torch.utils.interop import (
    to_torch, from_torch, dataset_to_torch, dataset_from_torch,
    labeled_points_to_dataset, dataset_to_labeled_points,
)
from deeplearning4j_tpu_torch.utils.viterbi import Viterbi, viterbi_decode
from deeplearning4j_tpu_torch.utils.sampling import sample_sequence
