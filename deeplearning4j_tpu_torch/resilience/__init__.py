"""Resilience (counterpart of ``deeplearning4j_tpu.resilience``):
checkpointing, preemption, retry, fault injection and the stability
engine, for one process.

- ``CheckpointManager`` — async snapshots with atomic commit (tmp ->
  fsync -> rename + COMMIT manifest), keep-N + archival retention, and
  torn-snapshot-proof ``latest()`` discovery;
- ``PreemptionHandler`` — SIGTERM/SIGINT -> priority checkpoint -> clean
  fit-loop stop at the next step boundary;
- ``RetryPolicy`` — exponential-backoff-with-jitter step retry with
  transient/fatal classification;
- ``FaultInjector`` — the seeded chaos harness (fail a step, crash the
  checkpoint writer between files, corrupt a committed snapshot, poison
  a batch);
- ``FitResilience`` — the per-fit-call driver both facades embed
  (auto-resume + skip, per-step retry scope with the key stream set
  back, boundary save/stop duties);
- ``stability`` — the in-step non-finite guard and loss scaling (inside
  the captured step) and the divergence sentinel.

The data-parallel masters (``parallel/``) call the injector's worker
hooks and the stability engine's master helpers.
"""

from deeplearning4j_tpu_torch.resilience.checkpoint_manager import (
    CheckpointError, CheckpointManager,
)
from deeplearning4j_tpu_torch.resilience.faults import (
    FaultInjector, InjectedFault, TransientInjectedFault,
    get_fault_injector, inject_faults, set_fault_injector,
)
from deeplearning4j_tpu_torch.resilience.integration import (
    FitResilience, PeerStepFault, StepStateLost, TransientPeerStepFault,
)
from deeplearning4j_tpu_torch.resilience.preemption import (
    PreemptionHandler, get_preemption_handler, preemption_requested,
)
from deeplearning4j_tpu_torch.resilience.retry import (
    RetryPolicy, TransientError, is_transient,
)
from deeplearning4j_tpu_torch.resilience.stability import StabilityRuntime

__all__ = [
    "StabilityRuntime",
    "CheckpointError", "CheckpointManager",
    "FaultInjector", "InjectedFault", "TransientInjectedFault",
    "get_fault_injector", "inject_faults", "set_fault_injector",
    "FitResilience", "PeerStepFault", "StepStateLost",
    "TransientPeerStepFault",
    "PreemptionHandler", "get_preemption_handler", "preemption_requested",
    "RetryPolicy", "TransientError", "is_transient",
]
