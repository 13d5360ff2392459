"""``provision/`` in the port: ``bootstrap_distributed`` against the JAX
package's (its no-op and its error for an incomplete triple), the env
triple and torchrun's environment bringing up a two-process gloo group,
and the GPU hosts' command lines and bootstrap script (which differ from
the reference's TPU pod by design, so they are held to the port's own
expectations)."""

import os
import stat
import subprocess
import sys

import pytest

from deeplearning4j_tpu_torch import provision
from deeplearning4j_tpu_torch.provision import cluster
from tests import _torch_distributed_child as xchild

_ENVS = ("DL4J_TPU_COORDINATOR", "DL4J_TPU_NUM_PROCS", "DL4J_TPU_PROC_ID",
         "WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT",
         "TPU_WORKER_HOSTNAMES")


@pytest.fixture
def clean_env(monkeypatch):
    for k in _ENVS:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


def test_single_process_bootstrap_is_the_reference_no_op(clean_env):
    from deeplearning4j_tpu.provision import (
        bootstrap_distributed as jbootstrap,
    )

    got = provision.bootstrap_distributed()
    assert got == jbootstrap() == {"distributed": False, "processes": 1,
                                   "process_id": 0}


@pytest.mark.parametrize("given", [
    {"DL4J_TPU_COORDINATOR": "10.0.0.1:1234"},
    {"DL4J_TPU_NUM_PROCS": "2", "DL4J_TPU_PROC_ID": "1"},
    {"DL4J_TPU_PROC_ID": "0"}])
def test_an_incomplete_triple_raises_as_the_reference(clean_env, given):
    from deeplearning4j_tpu.provision import (
        bootstrap_distributed as jbootstrap,
    )

    for k, v in given.items():
        clean_env.setenv(k, v)
    with pytest.raises(ValueError) as port:
        provision.bootstrap_distributed()
    with pytest.raises(ValueError) as ref:
        jbootstrap()
    assert str(port.value) == str(ref.value)
    assert "missing" in str(port.value)


@pytest.mark.parametrize("launch", ["triple", "torchrun"])
def test_the_launch_environment_brings_up_a_group(launch):
    env = ({"DL4J_TPU_COORDINATOR": "127.0.0.1:{port}",
            "DL4J_TPU_NUM_PROCS": "2", "DL4J_TPU_PROC_ID": "{rank}"}
           if launch == "triple" else
           {"WORLD_SIZE": "2", "RANK": "{rank}", "MASTER_ADDR": "127.0.0.1",
            "MASTER_PORT": "{port}"})
    ranks = xchild.spawn([{"name": "group", "kind": "group"}], env=env,
                         init="bootstrap")
    for r, res in enumerate(ranks):
        assert res["summary"] == {"distributed": True, "processes": 2,
                                  "process_id": r}
        typed = res["group"].pop("typed")
        assert res["group"] == {"world": 2, "rank": r, "backend": "gloo",
                                "sum": 3.0}
        # 16-bit floats and booleans gathered as their bytes
        for dt, got in typed.items():
            want = [[[v] * 3] * 2 for v in ((0.5, 1.5) if dt != "torch.bool"
                                            else (1.0, 1.0))]
            assert got == want, dt
        assert res["jax_loaded"] is False


def test_cluster_spec_counts_hosts_and_cards():
    spec = cluster.ClusterSpec(name="c", num_hosts=3,
                               accelerators_per_host=8, project="p")
    assert spec.num_workers == 3 and spec.num_processes == 24
    create = spec.create_command()
    assert create[:4] == ["gcloud", "compute", "instances", "create"]
    assert create[4:7] == ["c-0", "c-1", "c-2"]
    assert "--accelerator=type=nvidia-h100-80gb,count=8" in create
    assert "--project=p" in create
    ssh = spec.ssh_command(2, "nvidia-smi")
    assert ssh[:4] == ["gcloud", "compute", "ssh", "c-2"]
    assert ssh[-2:] == ["--command", "nvidia-smi"]


def test_setup_script_and_launch_commands(tmp_path):
    spec = cluster.ClusterSpec(name="c", num_hosts=2,
                               accelerators_per_host=4)
    setup = provision.ClusterSetup(spec, train_module="my.train")
    script = setup.bootstrap_script()
    assert script.startswith("#!/usr/bin/env bash\n")
    assert "torch.distributed" in script
    assert ("torchrun --nnodes=2 --nproc-per-node=4 "
            '--node-rank="$HOST_INDEX" --master-addr=c-0 '
            "--master-port=29500 -m deeplearning4j_tpu_torch.provision."
            "cluster --bootstrap -- python -m my.train") in script
    path = setup.write_bootstrap(tmp_path)
    assert path.read_text() == script
    assert path.stat().st_mode & stat.S_IXUSR
    cmds = setup.launch_commands()
    assert len(cmds) == 1 + 2 * spec.num_hosts
    assert cmds[0] == spec.create_command()
    prov = provision.HostProvisioner(spec)
    assert cmds[1:3] == prov.upload_to_all("bootstrap.sh")
    assert cmds[1][:4] == ["gcloud", "compute", "scp", "bootstrap.sh"]
    assert cmds[3][-1] == "bash ~/bootstrap.sh 0"
    assert cmds[4][-1] == "bash ~/bootstrap.sh 1"


def test_bootstrap_entry_hands_the_triple_to_the_command(clean_env):
    """``python -m ...cluster --bootstrap -- CMD`` runs CMD with the
    triple also in torchrun's names; an incomplete triple fails."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, DL4J_TPU_COORDINATOR="10.0.0.7:4321",
               DL4J_TPU_NUM_PROCS="4", DL4J_TPU_PROC_ID="3")
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    show = ("import os; print(*(os.environ[k] for k in ('MASTER_ADDR', "
            "'MASTER_PORT', 'WORLD_SIZE', 'RANK')))")
    out = subprocess.run(
        [sys.executable, "-m", "deeplearning4j_tpu_torch.provision.cluster",
         "--bootstrap", "--", sys.executable, "-c", show],
        env=env, cwd=root, capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["10.0.0.7", "4321", "4", "3"]
    env.pop("DL4J_TPU_PROC_ID")
    with pytest.raises(ValueError, match="process_id"):
        cluster.launch_env(env)
