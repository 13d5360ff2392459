"""Continuous online learning: stream -> windowed incremental fit ->
checkpointed candidates -> SLO-gated promotion with canary, zero-drop
hot-swap, post-swap watch, and automatic rollback.

The production loop the rest of the stack provides the pieces for
(streaming pub/sub, resilience, serving, health SLOs) — one pipeline
that ingests live traffic, learns from it, and redeploys itself
continuously, with every stage hardened against its real failure mode.
See docs/online.md.

Port of ``deeplearning4j_tpu/online/``: the same state machine over the
port's ``ServingEngine``, ``CheckpointManager``, ``RetryPolicy``,
``health``, pubsub and serde; the trainer's windows run the captured
``fit`` on the card.
"""

from deeplearning4j_tpu_torch.online.consumer import StreamConsumer
from deeplearning4j_tpu_torch.online.pipeline import OnlineLearningPipeline
from deeplearning4j_tpu_torch.online.promotion import (
    CANARY_REJECTED, PROMOTED, REJECTED, ROLLBACK_FAILED, ROLLED_BACK,
    PromotionManager, PromotionResult, default_gate_rules,
    default_watch_rules,
)

__all__ = [
    "CANARY_REJECTED", "PROMOTED", "REJECTED", "ROLLBACK_FAILED",
    "ROLLED_BACK", "OnlineLearningPipeline", "PromotionManager",
    "PromotionResult", "StreamConsumer", "default_gate_rules",
    "default_watch_rules",
]
