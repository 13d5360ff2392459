"""The child side of the port's multi-process tests: what each process of
a ``torch.distributed`` group runs, and the parent's spawner.

Nothing here imports JAX: the children are spawned fresh (the ``spawn``
context), import this module, join a gloo group through the test's
``TCPStore`` (``TORCHELASTIC_USE_AGENT_STORE``: the parent serves the
rendezvous on a port of its own choosing, so two test workers never
race for one), run their jobs on the CPU and hand back numpy results.
Each job is a dict with a ``kind`` (a function below) and its inputs:
nets travel as the configuration's JSON and numpy weights.
"""

from __future__ import annotations

import os
import queue
import sys
import time
import traceback

import numpy as np
import torch

DEADLINE_S = 120.0


class Group:
    """``world`` children running ``jobs`` in one gloo group, started at
    once; ``wait()`` returns each rank's results ({job name: result}).
    A child that fails, or passes ``deadline`` (counted from the start),
    fails the wait, and every child is killed."""

    def __init__(self, jobs, world: int = 2, deadline: float = DEADLINE_S,
                 env=None, init="explicit", backend=None):
        import multiprocessing as mp

        import torch.distributed as dist

        ctx = mp.get_context("spawn")
        self.world = world
        self.deadline = deadline
        self.store = dist.TCPStore("127.0.0.1", 0, is_master=True,
                                   wait_for_workers=False)
        self.q = ctx.Queue()
        self.procs = [ctx.Process(
            target=child, args=(r, world, self.store.port, jobs, self.q,
                                env or {}, init, backend), daemon=True)
            for r in range(world)]
        for p in self.procs:
            p.start()
        self.end = time.monotonic() + deadline
        self.out = None

    def wait(self):
        if self.out is not None:
            return self.out
        out, errors = {}, []
        try:
            while len(out) + len(errors) < self.world:
                left = self.end - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"children passed their {self.deadline} s deadline "
                        f"({len(out)} of {self.world} done)")
                try:
                    rank, err, res = self.q.get(timeout=min(left, 1.0))
                except queue.Empty:
                    if any(p.exitcode not in (None, 0) for p in self.procs):
                        raise RuntimeError(
                            "a child died: exit codes "
                            f"{[p.exitcode for p in self.procs]}")
                    continue
                if err is not None:
                    errors.append(f"rank {rank}:\n{err}")
                else:
                    out[rank] = res
            if errors:
                raise RuntimeError("\n".join(errors))
        finally:
            for p in self.procs:
                p.join(timeout=max(0.0, min(10.0,
                                            self.end - time.monotonic())))
                if p.is_alive():
                    p.kill()
                    p.join()
            self.store = None
        self.out = [out[r] for r in range(self.world)]
        return self.out


def spawn(jobs, **kw):
    """``Group(jobs, **kw).wait()``."""
    return Group(jobs, **kw).wait()


def child(rank, world, port, jobs, q, env, init, backend=None):
    os.environ["TORCHELASTIC_USE_AGENT_STORE"] = "True"
    os.environ.update({k: str(v).format(rank=rank, port=port)
                       for k, v in env.items()})
    torch.set_num_threads(2)
    from deeplearning4j_tpu_torch.parallel import training_master as tm

    try:
        if init == "explicit":
            tm.initialize_distributed(f"127.0.0.1:{port}", world, rank,
                                      backend=backend, timeout=60)
        elif init == "bootstrap":
            from deeplearning4j_tpu_torch.provision import (
                bootstrap_distributed,
            )

            summary = bootstrap_distributed()
        res = {}
        for job in jobs:
            res[job["name"]] = JOBS[job["kind"]](job)
        if init == "bootstrap":
            res["summary"] = summary
        res["jax_loaded"] = "jax" in sys.modules
        q.put((rank, None, res))
    except BaseException:
        q.put((rank, traceback.format_exc(), None))
        raise
    finally:
        tm.shutdown_distributed()


# ------------------------------------------------------------------ jobs
def _net(job):
    from deeplearning4j_tpu_torch.models.interop import params_from_numpy
    from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration

    return params_from_numpy(MultiLayerConfiguration.from_json(job["conf"]),
                             job["params"], device="cpu")


def _mesh(k=4):
    from deeplearning4j_tpu_torch.backend import mesh as mesh_mod

    return mesh_mod.default_mesh(data=k, devices=["cpu"] * k)


def _vec(net):
    return np.asarray(net.params_to_vector(), np.float32).copy()


def _state(net):
    return {k: {n: t.detach().cpu().numpy().copy() for n, t in v.items()}
            for k, v in net.net_state.items()}


def fit(job):
    """The sync master over ``job["k"]`` slots (default 4) across the
    processes: the params after the fit, the layer state, the master's
    exchange statistics and, with ``save``, a sharded checkpoint."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.datasets.iterator import (
        ListDataSetIterator,
    )
    from deeplearning4j_tpu_torch.parallel import (
        DistributedNetwork, SyncTrainingMaster, save_checkpoint,
    )
    from deeplearning4j_tpu_torch.resilience import (
        FaultInjector, inject_faults,
    )

    net = _net(job)
    mesh = _mesh(job.get("k", 4))
    master = SyncTrainingMaster(mesh=mesh,
                                update_sharding=job.get("mode", "replicated"))
    ds = DataSet(job["x"], job["y"], labels_mask=job.get("lm"))
    it = ListDataSetIterator(ds, job["batch"])
    p0 = _vec(net)
    steps = []
    inj = None
    if job.get("poison"):
        inj = FaultInjector(seed=3).poison_gradients(**job["poison"])
    for _ in range(job.get("epochs", 1)):
        if inj is not None:
            with inject_faults(inj):
                DistributedNetwork(net, master).fit(it)
        else:
            DistributedNetwork(net, master).fit(it)
        steps.append(_vec(net))
    out = {"params": _vec(net), "p0": p0, "per_epoch": steps,
           "net_state": _state(net), "iteration": net.iteration,
           "stats": {k: v for k, v in master.training_stats().items()
                     if k.startswith("exchange")}}
    if inj is not None:
        out["poisoned"] = [e["kind"] for e in inj.injected]
    from deeplearning4j_tpu_torch.resilience import stability

    if stability.policy_of(net.conf) is not None:
        out["stab"] = {k: float(v) for k, v in net.updater_state[
            stability.STATE_KEY].items()}
    if job.get("save"):
        save_checkpoint(job["save"], net, trees=master.state_trees(net),
                        mesh=mesh)
    return out


def evaluate(job):
    """``DistributedNetwork.evaluate`` and ``score`` across the processes,
    with the outputs that ``evaluate`` counted."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.datasets.iterator import (
        ListDataSetIterator,
    )
    from deeplearning4j_tpu_torch.evaluation import Evaluation
    from deeplearning4j_tpu_torch.parallel import (
        DistributedNetwork, SyncTrainingMaster,
    )

    class Kept(Evaluation):
        def __init__(self):
            super().__init__()
            self.outputs = []

        def eval(self, labels, predictions, mask=None, metadata=None):
            self.outputs.append(np.asarray(predictions).copy())
            return super().eval(labels, predictions, mask=mask,
                                metadata=metadata)

    net = _net(job)
    d = DistributedNetwork(net, SyncTrainingMaster(mesh=_mesh()))
    ev = d.evaluate(ListDataSetIterator(DataSet(job["x"], job["y"]), 16),
                    Kept())
    return {"confusion": np.asarray(ev.confusion.matrix).copy(),
            "outputs": np.concatenate(ev.outputs),
            "score": d.score(DataSet(job["x"], job["y"]))}


def restore(job):
    """A step directory restored into the net over the 2-process mesh."""
    from deeplearning4j_tpu_torch.parallel import restore_checkpoint

    net = _net(job)
    restore_checkpoint(job["dir"], net, mesh=_mesh())
    return {"params": _vec(net), "iteration": net.iteration,
            "updater_state": {k: {n: {m: t.detach().numpy().copy()
                                      for m, t in lv.items()}
                                  for n, lv in v.items()}
                              for k, v in net.updater_state.items()
                              if k != "__stability__"}}


def guards(job):
    """Every A14 guard under the 2-process mesh, and a data axis that does
    not divide over the processes: {case: the error's type and text}."""
    from deeplearning4j_tpu_torch.backend import mesh as mesh_mod
    from deeplearning4j_tpu_torch.nlp import distributed as nd
    from deeplearning4j_tpu_torch.parallel import (
        ParallelWrapper, ParameterAveragingTrainingMaster,
        PipelineParallelTrainingMaster, SequenceParallelTrainingMaster,
        SyncTrainingMaster, TensorParallelTrainingMaster,
    )
    from deeplearning4j_tpu_torch.resilience import CheckpointManager

    net = _net(job)
    mesh = _mesh()
    cases = {
        "ParallelWrapper": lambda: ParallelWrapper(net, workers=4,
                                                   mesh=mesh),
        "ParameterAveraging": lambda: ParameterAveragingTrainingMaster(
            mesh=mesh),
        "elastic": lambda: SyncTrainingMaster(mesh=mesh, elastic=True),
        "TensorParallel": lambda: TensorParallelTrainingMaster(
            mesh=mesh_mod.default_mesh(data=2, model=2,
                                       devices=["cpu"] * 4)),
        "Pipeline": lambda: PipelineParallelTrainingMaster(
            n_stages=2, devices=["cpu"] * 2),
        "SequenceParallel": lambda: SequenceParallelTrainingMaster(
            mesh=mesh_mod.default_mesh(data=2, seq=2, devices=["cpu"] * 4)),
        "DistributedWord2Vec": lambda: nd.DistributedWord2Vec(
            None, None, mesh=mesh),
        "DistributedGlove": lambda: nd.DistributedGlove(mesh=mesh),
        "CheckpointManager": lambda: CheckpointManager(
            job["dir"], async_save=False).save(net),
        "resilient fit": lambda: SyncTrainingMaster(
            mesh=mesh, checkpoint_manager=object()),
        "introspection": lambda: SyncTrainingMaster(
            mesh=mesh).execute_training(net, []),
        "three slots": lambda: mesh_mod.default_mesh(data=3,
                                                     devices=["cpu"] * 3),
    }
    out = {}
    for name, make in cases.items():
        try:
            make()
            out[name] = ("none", "")
        except Exception as e:  # the case's own error, reported back
            out[name] = (type(e).__name__, str(e))
    return out


def group(job):
    """What the group holds: its size, this rank, the backend and the sum
    of every rank's ``rank + 1`` through the mesh's collective."""
    from deeplearning4j_tpu_torch.backend import mesh as mesh_mod

    r = mesh_mod.process_index()
    typed = {str(dt): mesh_mod.process_all_gather(
        torch.full((2, 3), r + 0.5).to(dt)).float().tolist()
        for dt in (torch.bfloat16, torch.float16, torch.bool)}
    return {"world": mesh_mod.process_count(), "rank": r,
            "backend": mesh_mod.process_backend(),
            "sum": float(mesh_mod.process_sum(torch.tensor(r + 1.0))),
            "typed": typed}


def cuda_gather(job):
    """The mesh's cross-process all-gather of tensors on the card and of
    the same tensors on the CPU, and the bytes the census counted."""
    from deeplearning4j_tpu_torch.backend import mesh as mesh_mod

    r = mesh_mod.process_index()
    g = torch.Generator().manual_seed(100 + r)
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        host = torch.randn(3, 5, generator=g).to(dt)
        card = mesh_mod.process_all_gather(host.cuda())
        cpu = mesh_mod.process_all_gather(host)
        out[str(dt)] = (card.device.type, bool(torch.equal(card.cpu(), cpu)),
                        cpu.float().numpy())
    out["bytes"] = mesh_mod.process_totals()["bytes"]
    return out


def nccl_psum(job):
    """A world of one over NCCL: the slot psum of a ``[K, n]`` stack, then
    its cross-process sum, against the slot psum alone."""
    from deeplearning4j_tpu_torch.backend import mesh as mesh_mod

    g = torch.Generator().manual_seed(7)
    stack = torch.randn(4, 4096, generator=g).cuda()
    local = mesh_mod.psum(stack)
    return {"equal": bool(torch.equal(mesh_mod.process_sum(local), local)),
            "backend": mesh_mod.process_backend()}


JOBS = {"fit": fit, "evaluate": evaluate, "restore": restore,
        "guards": guards, "group": group, "cuda_gather": cuda_gather,
        "nccl_psum": nccl_psum}
