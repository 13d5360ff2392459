"""Serving-fleet control plane: router, replicas, supervisor, rollout.

Lazy re-exports (PEP 562) so importing one corner does not pay for the
rest — ``fleet.placement`` in particular stays stdlib-only for the CI
placement-policy gate.

Port of ``deeplearning4j_tpu/fleet/``: the control plane is copied, and
the replicas serve the port's ``GenerationEngine`` behind its
``InferenceServer`` (``replica_main``).
"""

_EXPORTS = {
    "ShadowIndex": "placement",
    "ReplicaView": "placement",
    "placement_selftest": "placement",
    "FleetRouter": "router",
    "FleetRequest": "router",
    "NoLiveReplicaError": "router",
    "InProcessReplica": "replica",
    "HTTPReplica": "replica",
    "ReplicaError": "replica",
    "ReplicaSupervisor": "supervisor",
    "ReplicaProcess": "supervisor",
    "free_port": "supervisor",
    "FleetRollout": "rollout",
    "FleetRolloutResult": "rollout",
    "FleetFrontend": "frontend",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f"{__name__}.{mod}"), name)
