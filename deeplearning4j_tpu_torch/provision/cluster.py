"""Cluster provisioning — the port's counterpart of
``deeplearning4j_tpu/provision/cluster.py`` (the deeplearning4j-aws
analog: ``Ec2BoxCreator.java`` creates boxes, ``HostProvisioner.java``
uploads and runs over ssh, ``ClusterSetup.java`` wires the hosts into a
training cluster).

The boxes are GPU hosts: ``gcloud compute instances`` with
``accelerators_per_host`` cards of ``accelerator_type`` each.  As in the
reference, provisioning emits the command lines and the bootstrap
script every host runs (nothing here reaches a cloud; the operator or a
CI layer runs them).  The runtime half, ``bootstrap_distributed``, is
what each training process calls at startup: it brings up a
``torch.distributed`` process group (``parallel.initialize_distributed``:
NCCL between cards, one process a card) from an explicit triple or from
the launcher's environment, after which a mesh spans every process.
The reference's pod slice with its eight chips a host becomes torchrun
on each host, one process per card.

    python -m deeplearning4j_tpu_torch.provision.cluster --bootstrap -- CMD

checks the launch environment (an incomplete ``DL4J_TPU_*`` triple
raises) and runs ``CMD`` with the triple also given in torchrun's names,
so ``CMD`` (which calls ``bootstrap_distributed()``) joins the group;
without ``CMD`` it joins the group itself and prints the summary.
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import Dict, List, Optional

ENV_COORDINATOR = "DL4J_TPU_COORDINATOR"
ENV_NUM_PROCS = "DL4J_TPU_NUM_PROCS"
ENV_PROC_ID = "DL4J_TPU_PROC_ID"
MASTER_PORT = 29500


@dataclasses.dataclass
class ClusterSpec:
    """The ``Ec2BoxCreator`` knobs, restated for GPU hosts."""

    name: str = "dl4j-gpu-cluster"
    machine_type: str = "a3-highgpu-8g"
    accelerator_type: str = "nvidia-h100-80gb"
    accelerators_per_host: int = 8
    num_hosts: int = 1
    image_family: str = "pytorch-latest-gpu"
    image_project: str = "deeplearning-platform-release"
    zone: str = "us-central1-a"
    project: Optional[str] = None

    @property
    def num_workers(self) -> int:
        """Hosts (the reference's workers: one VM each)."""
        return self.num_hosts

    @property
    def num_processes(self) -> int:
        """Training processes: one a card."""
        return self.num_hosts * self.accelerators_per_host

    def host(self, worker: int) -> str:
        return f"{self.name}-{worker}"

    def hosts(self) -> List[str]:
        return [self.host(i) for i in range(self.num_hosts)]

    def _project(self) -> List[str]:
        return [f"--project={self.project}"] if self.project else []

    def create_command(self) -> List[str]:
        """The gcloud line that creates every host (box creation)."""
        return (["gcloud", "compute", "instances", "create", *self.hosts(),
                 f"--machine-type={self.machine_type}",
                 f"--accelerator=type={self.accelerator_type},"
                 f"count={self.accelerators_per_host}",
                 f"--image-family={self.image_family}",
                 f"--image-project={self.image_project}",
                 "--maintenance-policy=TERMINATE",
                 f"--zone={self.zone}"] + self._project())

    def ssh_command(self, worker: int, remote_cmd: str) -> List[str]:
        return (["gcloud", "compute", "ssh", self.host(worker),
                 f"--zone={self.zone}"] + self._project()
                + ["--command", remote_cmd])


class HostProvisioner:
    """Per-host provisioning steps (upload and run), as command lines
    (``HostProvisioner.java``'s scp and exec)."""

    def __init__(self, spec: ClusterSpec):
        self.spec = spec

    def upload_command(self, local_path: str, worker: int = 0,
                       remote_path: str = "~/") -> List[str]:
        return (["gcloud", "compute", "scp", str(local_path),
                 f"{self.spec.host(worker)}:{remote_path}",
                 f"--zone={self.spec.zone}"] + self.spec._project())

    def upload_to_all(self, local_path: str,
                      remote_path: str = "~/") -> List[List[str]]:
        return [self.upload_command(local_path, w, remote_path)
                for w in range(self.spec.num_hosts)]

    def run_on_all(self, remote_cmd: str) -> List[List[str]]:
        """``remote_cmd`` on every host, with the host's index as its
        last argument."""
        return [self.spec.ssh_command(w, f"{remote_cmd} {w}")
                for w in range(self.spec.num_hosts)]


class ClusterSetup:
    """Wires the hosts into a training cluster: the bootstrap script every
    host runs and the launch commands (``ClusterSetup.java`` and the
    reference's ``DistributedDeepLearningTrainer`` bootstrap)."""

    def __init__(self, spec: ClusterSpec, train_module: str = "train"):
        self.spec = spec
        self.train_module = train_module

    def bootstrap_script(self) -> str:
        s = self.spec
        return (
            "#!/usr/bin/env bash\n"
            "# dl4j GPU host bootstrap: runs on every host, its index as $1.\n"
            "# torchrun starts one process per card and exports WORLD_SIZE,\n"
            "# RANK, LOCAL_RANK, MASTER_ADDR and MASTER_PORT; each process's\n"
            "# bootstrap_distributed() brings up torch.distributed (NCCL).\n"
            "set -euo pipefail\n"
            "HOST_INDEX=\"${1:?the host's index}\"\n"
            f"torchrun --nnodes={s.num_hosts} "
            f"--nproc-per-node={s.accelerators_per_host} "
            "--node-rank=\"$HOST_INDEX\" "
            f"--master-addr={s.host(0)} --master-port={MASTER_PORT} "
            "-m deeplearning4j_tpu_torch.provision.cluster --bootstrap "
            f"-- python -m {self.train_module}\n"
        )

    def write_bootstrap(self, directory) -> Path:
        p = Path(directory) / "bootstrap.sh"
        p.write_text(self.bootstrap_script())
        p.chmod(0o755)
        return p

    def launch_commands(self) -> List[List[str]]:
        """Everything needed to go from nothing to a training cluster."""
        prov = HostProvisioner(self.spec)
        return ([self.spec.create_command()]
                + prov.upload_to_all("bootstrap.sh")
                + prov.run_on_all("bash ~/bootstrap.sh"))


def _triple(coordinator, num_processes, process_id, env=None):
    """The explicit triple from the arguments or the environment ``env``
    (default: this process's); an incomplete one raises (a config error,
    not a silent single-process run)."""
    env = os.environ if env is None else env
    coordinator = coordinator or env.get(ENV_COORDINATOR)
    num_processes = num_processes if num_processes is not None else (
        int(env[ENV_NUM_PROCS]) if ENV_NUM_PROCS in env else None)
    process_id = process_id if process_id is not None else (
        int(env[ENV_PROC_ID]) if ENV_PROC_ID in env else None)
    explicit = [coordinator, num_processes, process_id]
    if any(v is not None for v in explicit) and any(
            v is None for v in explicit):
        missing = [n for n, v in zip(
            ("coordinator", "num_processes", "process_id"), explicit)
            if v is None]
        raise ValueError(
            "explicit distributed init needs coordinator, num_processes "
            f"AND process_id; missing: {missing} (set the "
            f"{ENV_COORDINATOR}/{ENV_NUM_PROCS}/{ENV_PROC_ID} "
            "env vars or pass them)")
    return explicit


def bootstrap_distributed(coordinator: Optional[str] = None,
                          num_processes: Optional[int] = None,
                          process_id: Optional[int] = None, *,
                          backend: Optional[str] = None) -> dict:
    """Bring up ``torch.distributed`` from explicit arguments, the
    environment (``DL4J_TPU_COORDINATOR`` / ``DL4J_TPU_NUM_PROCS`` /
    ``DL4J_TPU_PROC_ID``) or a launcher's (torchrun's ``WORLD_SIZE``,
    ``RANK``, ``MASTER_ADDR``, ``MASTER_PORT``).  Returns a summary dict;
    a no-op for a genuinely single-process launch.  ``backend`` as in
    ``initialize_distributed`` (default: NCCL with a card, else gloo)."""
    from deeplearning4j_tpu_torch.backend import mesh as mesh_mod
    from deeplearning4j_tpu_torch.parallel.training_master import (
        initialize_distributed, launched,
    )

    explicit = _triple(coordinator, num_processes, process_id)
    if explicit[0] is not None:
        initialize_distributed(*explicit, backend=backend)
    else:
        # a launcher's metadata, the reference's pod metadata
        if not launched():
            return {"distributed": False, "processes": 1, "process_id": 0}
        initialize_distributed(backend=backend)
    return {"distributed": True,
            "processes": mesh_mod.process_count(),
            "process_id": mesh_mod.process_index()}


def launch_env(env: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """``env`` (default: this process's) with an explicit ``DL4J_TPU_*``
    triple also given in torchrun's names, for a command that joins the
    group through ``bootstrap_distributed()`` or torchrun's own
    ``env://``; an incomplete triple raises."""
    env = dict(os.environ if env is None else env)
    coordinator, n, pid = _triple(None, None, None, env)
    if coordinator is not None:
        host, _, port = coordinator.rpartition(":")
        env.update(MASTER_ADDR=host, MASTER_PORT=port, WORLD_SIZE=str(n),
                   RANK=str(pid))
    return env


def main(argv: Optional[List[str]] = None) -> int:
    import subprocess
    import sys

    args = list(sys.argv[1:] if argv is None else argv)
    if not args or args[0] != "--bootstrap":
        print(__doc__)
        return 2
    rest = args[1:]
    if rest and rest[0] == "--":
        rest = rest[1:]
    if rest:
        return subprocess.call(rest, env=launch_env())
    print(json.dumps(bootstrap_distributed()))
    return 0


if __name__ == "__main__":  # pragma: no cover - host-side entry
    raise SystemExit(main())
