"""Parallel training (counterpart of ``deeplearning4j_tpu.parallel``),
over the slot mesh of ``backend.mesh``.

Ported: ``ParallelWrapper`` (with ZeRO and elastic eviction), the
``SyncTrainingMaster`` and ``ParameterAveragingTrainingMaster``,
``DistributedNetwork``, sequence parallelism (ring and Ulysses
attention, ``SequenceParallelTrainingMaster``) and the checkpoint's
sharded save and resharded restore, tensor and expert parallelism
(``model_parallel.py``: ``TensorParallelTrainingMaster``,
``tensor_parallel_spec``) and pipeline parallelism (``pipeline.py``:
``PipelineParallelTrainingMaster``, ``split_stages``).  Meshes across
processes or devices raise ``NotImplementedError`` (ROADMAP A10, meshes
across processes and GPUs).
"""

from deeplearning4j_tpu_torch.parallel.checkpoint import (
    restore_checkpoint, save_checkpoint, snapshot_trees, write_snapshot,
)
from deeplearning4j_tpu_torch.parallel.data_parallel import ParallelWrapper
from deeplearning4j_tpu_torch.parallel.elastic import (
    ElasticConfig, ElasticController,
)
from deeplearning4j_tpu_torch.parallel.model_parallel import (
    TensorParallelTrainingMaster, tensor_parallel_spec,
)
from deeplearning4j_tpu_torch.parallel.pipeline import (
    PipelineParallelTrainingMaster, find_periodic_run,
    measure_bubble_fraction, split_stages,
)
from deeplearning4j_tpu_torch.parallel.sequence_parallel import (
    SequenceParallelTrainingMaster, ring_attention, ring_self_attention,
    ulysses_attention,
)
from deeplearning4j_tpu_torch.parallel.training_master import (
    DistributedNetwork, ParameterAveragingTrainingMaster,
    SyncTrainingMaster, TrainingMaster, initialize_distributed,
)

__all__ = [
    "DistributedNetwork", "ElasticConfig", "ElasticController",
    "ParallelWrapper", "ParameterAveragingTrainingMaster",
    "PipelineParallelTrainingMaster", "SequenceParallelTrainingMaster",
    "SyncTrainingMaster", "TensorParallelTrainingMaster", "TrainingMaster",
    "find_periodic_run", "initialize_distributed",
    "measure_bubble_fraction", "restore_checkpoint", "ring_attention",
    "ring_self_attention", "save_checkpoint", "snapshot_trees",
    "split_stages", "tensor_parallel_spec", "ulysses_attention",
    "write_snapshot",
]
