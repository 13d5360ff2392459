"""Parallel training (counterpart of ``deeplearning4j_tpu.parallel``).

Ported: the single-process half of ``checkpoint.py``.  The masters
(``ParallelWrapper``, the training masters, ZeRO, elastic, pipeline,
model and sequence parallelism), the sharded save and the resharded
restore come with ROADMAP A10.
"""

from deeplearning4j_tpu_torch.parallel.checkpoint import (
    restore_checkpoint, save_checkpoint, snapshot_trees, write_snapshot,
)

__all__ = ["restore_checkpoint", "save_checkpoint", "snapshot_trees",
           "write_snapshot"]
