"""Parallel training (counterpart of ``deeplearning4j_tpu.parallel``),
over the slot mesh of ``backend.mesh``.

Ported: ``ParallelWrapper`` (with ZeRO and elastic eviction), the
``SyncTrainingMaster`` and ``ParameterAveragingTrainingMaster``,
``DistributedNetwork``, sequence parallelism (ring and Ulysses
attention, ``SequenceParallelTrainingMaster``) and the checkpoint's
sharded save and resharded restore.  ``pipeline.py``,
``model_parallel.py`` and meshes across processes or devices come with
ROADMAP A10's next slice: ``TensorParallelTrainingMaster``,
``PipelineParallelTrainingMaster`` and ``split_stages`` raise
``NotImplementedError`` until then.
"""

from deeplearning4j_tpu_torch.parallel.checkpoint import (
    restore_checkpoint, save_checkpoint, snapshot_trees, write_snapshot,
)
from deeplearning4j_tpu_torch.parallel.data_parallel import ParallelWrapper
from deeplearning4j_tpu_torch.parallel.elastic import (
    ElasticConfig, ElasticController,
)
from deeplearning4j_tpu_torch.parallel.sequence_parallel import (
    SequenceParallelTrainingMaster, ring_attention, ring_self_attention,
    ulysses_attention,
)
from deeplearning4j_tpu_torch.parallel.training_master import (
    DistributedNetwork, ParameterAveragingTrainingMaster,
    PipelineParallelTrainingMaster, SyncTrainingMaster,
    TensorParallelTrainingMaster, TrainingMaster, initialize_distributed,
    split_stages, tensor_parallel_spec,
)

__all__ = [
    "DistributedNetwork", "ElasticConfig", "ElasticController",
    "ParallelWrapper", "ParameterAveragingTrainingMaster",
    "PipelineParallelTrainingMaster", "SequenceParallelTrainingMaster",
    "SyncTrainingMaster", "TensorParallelTrainingMaster", "TrainingMaster",
    "initialize_distributed", "restore_checkpoint", "ring_attention",
    "ring_self_attention", "save_checkpoint", "snapshot_trees",
    "split_stages", "tensor_parallel_spec", "ulysses_attention",
    "write_snapshot",
]
