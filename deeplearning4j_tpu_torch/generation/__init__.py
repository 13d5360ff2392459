"""Continuous-batching generation (counterpart of ``deeplearning4j_tpu.generation``)."""

from deeplearning4j_tpu_torch.generation.engine import GenerationEngine
from deeplearning4j_tpu_torch.generation.paged_cache import (
    PagedKVCache, PageExhaustedError,
)
from deeplearning4j_tpu_torch.generation.scheduler import (
    DecodeScheduler, GenerationRequest,
)

__all__ = ["DecodeScheduler", "GenerationEngine", "GenerationRequest",
           "PagedKVCache", "PageExhaustedError"]
