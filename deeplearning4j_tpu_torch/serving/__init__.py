"""Production serving subsystem (counterpart of ``deeplearning4j_tpu.serving``):
shape-bucketed dynamic batching, warm-up (on the card: one captured
graph per bucket), model registry with zero-drop hot-swap, and admission
control.  The HTTP front end over it is ``streaming.InferenceServer``.
"""

from deeplearning4j_tpu_torch.serving.admission import (
    AdmissionController, DeadlineExceededError, ModelNotFoundError,
    QueueFullError, Request, ServingError, ShuttingDownError,
)
from deeplearning4j_tpu_torch.serving.batcher import DynamicBatcher
from deeplearning4j_tpu_torch.serving.buckets import BucketPolicy
from deeplearning4j_tpu_torch.serving.engine import (
    DEFAULT_MODEL, ServingEngine,
)
from deeplearning4j_tpu_torch.serving.registry import (
    ModelRegistry, ModelVersion, load_version_from_checkpoint,
)
from deeplearning4j_tpu_torch.serving.warmup import (
    NoWarmupShapeError, infer_row_shape, warmup_version,
)

__all__ = [
    "AdmissionController", "BucketPolicy", "DEFAULT_MODEL",
    "DeadlineExceededError", "DynamicBatcher", "ModelNotFoundError",
    "ModelRegistry", "ModelVersion", "NoWarmupShapeError",
    "QueueFullError", "Request", "ServingError", "ShuttingDownError",
    "infer_row_shape", "load_version_from_checkpoint",
    "warmup_version",
]
