"""Evaluation (counterpart of ``deeplearning4j_tpu.evaluation``): numpy
classification and regression metrics."""

from deeplearning4j_tpu_torch.evaluation.evaluation import Evaluation, ConfusionMatrix
from deeplearning4j_tpu_torch.evaluation.regression import RegressionEvaluation
