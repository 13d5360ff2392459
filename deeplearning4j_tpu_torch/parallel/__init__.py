"""Parallel training (counterpart of ``deeplearning4j_tpu.parallel``),
over the slot mesh of ``backend.mesh``.

Ported: ``ParallelWrapper`` (with ZeRO and elastic eviction), the
``SyncTrainingMaster`` and ``ParameterAveragingTrainingMaster``,
``DistributedNetwork``, sequence parallelism (ring and Ulysses
attention, ``SequenceParallelTrainingMaster``) and the checkpoint's
sharded save and resharded restore, tensor and expert parallelism
(``model_parallel.py``: ``TensorParallelTrainingMaster``,
``tensor_parallel_spec``) and pipeline parallelism (``pipeline.py``:
``PipelineParallelTrainingMaster``, ``split_stages``).

Across processes (one a card, ``initialize_distributed`` over
``torch.distributed``; ``provision`` launches them): the sync master,
replicated and ZeRO (with gradient normalization), ``ParallelWrapper``
(replicated at any averaging frequency, and ZeRO),
``ParameterAveragingTrainingMaster``, ``elastic=`` on each of them,
``DistributedNetwork`` and the sharded checkpoint (each process its own
slots' blocks), the introspection policy and the numerics ledger on
the sync master and the wrapper, and ``checkpoint_manager=`` and
``retry_policy=`` on both (a commit is every process's shards staged,
a barrier, process 0's rename, a barrier; ``resilience/
checkpoint_manager.py``); every rank ends each step or window holding
the same bits.  Only the model and seq axes (ROADMAP A14b) raise there.
A mesh in one process over several devices raises (A10: its
counterpart is one process a card).
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
    shutdown_distributed,
)

__all__ = [
    "DistributedNetwork", "ElasticConfig", "ElasticController",
    "ParallelWrapper", "ParameterAveragingTrainingMaster",
    "PipelineParallelTrainingMaster", "SequenceParallelTrainingMaster",
    "SyncTrainingMaster", "TensorParallelTrainingMaster", "TrainingMaster",
    "find_periodic_run", "initialize_distributed",
    "measure_bubble_fraction", "restore_checkpoint", "ring_attention",
    "ring_self_attention", "save_checkpoint", "shutdown_distributed",
    "snapshot_trees", "split_stages", "tensor_parallel_spec", "ulysses_attention",
    "write_snapshot",
]
