"""Continuous-batching generation (counterpart of ``deeplearning4j_tpu.generation``):
requests join and leave a RUNNING decode batch at every step, KV state
lives in fixed-size pages addressed through int32 block tables (on the
card every program a captured CUDA graph: zero steady-state captures),
identical prompt prefixes share refcounted pages, the optional
persistent radix-tree prefix cache keeps prompt pages alive across
requests (pinning, host-tier offload, cache-aware admission), and the
serving model hot-swaps between decode steps with zero dropped streams.
"""

from deeplearning4j_tpu_torch.generation.engine import (
    DEFAULT_MODEL, GenerationEngine,
)
from deeplearning4j_tpu_torch.generation.paged_cache import (
    PagedKVCache, PageExhaustedError,
)
from deeplearning4j_tpu_torch.generation.prefix_cache import (
    PrefixCache, PrefixCacheConfig, StalePrefixError,
)
from deeplearning4j_tpu_torch.generation.programs import (
    GenerationPrograms, seed_paged_pools,
)
from deeplearning4j_tpu_torch.generation.scheduler import (
    DecodeScheduler, GenerationRequest,
)

__all__ = ["DEFAULT_MODEL", "DecodeScheduler", "GenerationEngine",
           "GenerationPrograms", "GenerationRequest", "PagedKVCache",
           "PageExhaustedError", "PrefixCache", "PrefixCacheConfig",
           "StalePrefixError", "seed_paged_pools"]
