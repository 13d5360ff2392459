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

import contextlib
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
                             job["params"], device=job.get("device", "cpu"))


def _mesh(k=4, device="cpu"):
    from deeplearning4j_tpu_torch.backend import mesh as mesh_mod

    return mesh_mod.default_mesh(data=k, devices=[device] * k)


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

    from deeplearning4j_tpu_torch.parallel import ElasticConfig

    net = _net(job)
    mesh = _mesh(job.get("k", 4), job.get("device", "cpu"))
    master = SyncTrainingMaster(
        mesh=mesh, update_sharding=job.get("mode", "replicated"),
        elastic=(ElasticConfig(**job["elastic"]) if job.get("elastic")
                 is not None else False))
    rec = _Recorded(master.elastic) if master.elastic is not None else None
    ds = DataSet(job["x"], job["y"], labels_mask=job.get("lm"))
    it = ListDataSetIterator(ds, job["batch"])
    p0 = _vec(net)
    steps = []
    inj = _injector(job)
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
                     if k.startswith("exchange")},
           "observed": _observed(net.updater_state)}
    if inj is not None:
        out["poisoned"] = [e["kind"] for e in inj.injected]
    if rec is not None:
        out.update(masks=rec.masks, stalls=master.elastic.barrier_stalls,
                   summary=master.elastic.summary())
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
    """Every A14 path under the 2-process mesh, built and run small (the
    A14b masters still raise), and a data axis that does not divide over
    the processes: {case: the error's type and text, or ("none", "")}."""
    from deeplearning4j_tpu_torch.backend import mesh as mesh_mod
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.parallel import (
        DistributedNetwork, ParallelWrapper, ParameterAveragingTrainingMaster,
        PipelineParallelTrainingMaster, SequenceParallelTrainingMaster,
        SyncTrainingMaster, TensorParallelTrainingMaster,
    )
    from deeplearning4j_tpu_torch.resilience import (
        CheckpointManager, RetryPolicy,
    )

    net = _net(job)
    mesh = _mesh()
    x = np.zeros((8, 8), np.float32)
    y = np.eye(4, dtype=np.float32)[np.arange(8) % 4]

    def frames():
        return iter([DataSet(x[i:i + 2], y[i:i + 2]) for i in range(0, 8, 2)])

    def manager(name):
        return CheckpointManager(f"{job['dir']}/{name}", async_save=False,
                                 save_every_steps=1)

    def wrapper_fit(**kw):
        ParallelWrapper(net, workers=4, mesh=mesh, **kw).fit(frames())

    def with_numerics():
        import dataclasses

        from deeplearning4j_tpu_torch.nn.conf import TrainingNumerics

        conf = dataclasses.replace(net.conf, introspection=None,
                                   numerics=TrainingNumerics().to_dict())
        saved, net.conf = net.conf, conf
        try:
            wrapper_fit()
        finally:
            net.conf = saved

    def sync_fit(**kw):
        DistributedNetwork(net, SyncTrainingMaster(mesh=mesh, **kw)).fit(
            iter([DataSet(x, y)]))

    def nlp(cls):
        from deeplearning4j_tpu_torch.nlp import distributed as nd
        from deeplearning4j_tpu_torch.nlp.documents import (
            CollectionSentenceIterator,
        )

        text = ["the cat sat on the mat", "the dog sat on the log"] * 4
        if cls == "glove":
            nd.DistributedGlove(sentence_iterator=CollectionSentenceIterator(
                text), layer_size=8, window=2, epochs=1, batch_size=8,
                mesh=mesh).fit()
        else:
            (nd.DistributedWord2Vec.Builder().iterate(text).layer_size(8)
             .window_size(2).batch_size(8).epochs(1).seed(1).mesh(mesh)
             .build().fit())

    cases = {
        "wrapper introspection": wrapper_fit,
        "wrapper numerics": with_numerics,
        "wrapper checkpoint_manager": lambda: wrapper_fit(
            checkpoint_manager=manager("wrapper")),
        "wrapper retry_policy": lambda: wrapper_fit(
            retry_policy=RetryPolicy(max_retries=1)),
        "built": lambda: (ParallelWrapper(net, workers=4, mesh=mesh),
                          ParameterAveragingTrainingMaster(mesh=mesh),
                          SyncTrainingMaster(mesh=mesh, elastic=True)),
        "TensorParallel": lambda: TensorParallelTrainingMaster(
            mesh=mesh_mod.default_mesh(data=2, model=2,
                                       devices=["cpu"] * 4)),
        "Pipeline": lambda: PipelineParallelTrainingMaster(
            n_stages=2, devices=["cpu"] * 2),
        "SequenceParallel": lambda: SequenceParallelTrainingMaster(
            mesh=mesh_mod.default_mesh(data=2, seq=2, devices=["cpu"] * 4)),
        "DistributedWord2Vec": lambda: nlp("word2vec"),
        "DistributedGlove": lambda: nlp("glove"),
        "CheckpointManager": lambda: (
            manager("explicit").save(net),
            manager("explicit").resume(_net(job), mesh=mesh)),
        "resilient fit": lambda: sync_fit(
            checkpoint_manager=manager("sync"),
            retry_policy=RetryPolicy(max_retries=1)),
        "introspection": sync_fit,
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


def streams(job):
    """A gather large enough to go over the mesh's gloo streams, float32
    and bfloat16: whether each equals the plain stack of every rank's
    tensor, and how many streams it took."""
    from deeplearning4j_tpu_torch.backend import mesh as mesh_mod

    r, w = mesh_mod.process_index(), mesh_mod.process_count()
    out = {}
    for dt, n in ((torch.float32, (3 << 20) + 5), (torch.bfloat16, 6 << 20)):
        mine = (torch.arange(n, dtype=torch.float32) % 251 + r).to(dt)
        got = mesh_mod.process_all_gather(mine)
        want = torch.stack([(torch.arange(n, dtype=torch.float32) % 251
                             + k).to(dt) for k in range(w)])
        out[str(dt)] = (bool(torch.equal(got, want)), len(
            mesh_mod._gloo_streams(mine.numel() * mine.element_size())))
    return out


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


def _observed(tree):
    """The ``__introspect__`` and ``__numerics__`` vectors of an updater
    state (or of a wrapper's live stacks), as numpy."""
    return {k: tree[k]["packed"].detach().cpu().numpy().copy()
            for k in ("__introspect__", "__numerics__")
            if tree.get(k) is not None}


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy().copy()


def _injector(job):
    """A ``FaultInjector`` armed with ``job["faults"]`` ([method, kwargs]
    pairs), or None."""
    from deeplearning4j_tpu_torch.resilience import FaultInjector

    if not job.get("faults"):
        return None
    inj = FaultInjector(seed=job.get("fault_seed", 3))
    for method, kw in job["faults"]:
        getattr(inj, method)(**kw)
    return inj


def _batches(job):
    """``job``'s data as the wrapper reads it: an iterator of DataSets
    (the window assembler) or a ``ListDataSetIterator`` (native slabs)."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.datasets.iterator import (
        ListDataSetIterator,
    )

    x, y, b = job["x"], job["y"], job["batch"]
    if job.get("source", "iter") == "list":
        return ListDataSetIterator(DataSet(x, y), b)
    return iter([DataSet(x[i:i + b], y[i:i + b])
                 for i in range(0, len(x), b)])


class _Recorded:
    """An elastic controller's masks, one a window, as ``begin_window``
    returned them."""

    def __init__(self, ctl):
        self.masks = []
        begin = ctl.begin_window

        def rec(step):
            m = begin(step)
            self.masks.append((int(step), [float(v) for v in m]))
            return m

        ctl.begin_window = rec


def _flight(since, kinds=("elastic_eviction", "elastic_readmission",
                          "replica_poisoned")):
    from deeplearning4j_tpu_torch.observability import get_flight_recorder

    return [(e.kind, dict(e.attrs)) for e in
            get_flight_recorder().events()[since:] if e.kind in kinds]


class _ReplayGraph:
    """A captured graph's stand-in on the CPU: ``replay`` reruns the body
    and writes its tensors into the capture's outputs."""

    def __init__(self, fn, out):
        self.fn, self.out = fn, out

    def replay(self):
        from deeplearning4j_tpu_torch.models.common import tree_leaves

        for dst, src in zip(tree_leaves(self.out), tree_leaves(self.fn())):
            if dst is not src:
                dst.copy_(src)


@contextlib.contextmanager
def _emulated_capture(holder):
    """The card's capture calls replaced on the CPU for the programs of
    ``holder()`` (the wrapper's staged trees): the warm-up runs the body,
    the capture records it without its effects (the state and the
    programs' static inputs restored after one run), a replay reruns it,
    the pinned staging is a plain copy."""
    from deeplearning4j_tpu_torch.models import capture
    from deeplearning4j_tpu_torch.models.common import tree_leaves

    def fake_capture(fn, pool=None):
        h = holder()
        held = capture.state_leaves(h) + [
            t for p in h._step_graphs.programs.values()
            for t in tree_leaves(p.statics)]
        saved = [t.clone() for t in held]
        out = fn()
        for t, v in zip(held, saved):
            t.copy_(v)
        return _ReplayGraph(fn, out), out

    def put(self, dst, src, name):
        src = capture.host_or_device(src)
        if src is not dst:
            dst.copy_(src)

    patches = [(capture, "captures", lambda n: n is holder()),
               (capture, "warm_on_side_stream", lambda fn, device: fn()),
               (capture, "capture_graph", fake_capture),
               (capture.StepGraphs, "_pool", lambda self: None),
               (capture.StepGraphs, "put", put)]
    saved = [(o, n, getattr(o, n)) for o, n, _ in patches]
    for o, n, v in patches:
        setattr(o, n, v)
    try:
        yield
    finally:
        for o, n, v in saved:
            setattr(o, n, v)


def wrapper(job):
    """``ParallelWrapper`` (or, with ``epochs``, the
    ``ParameterAveragingTrainingMaster`` over ``DistributedNetwork``) over
    4 slots across the processes: every leaf after the fit, the elastic
    masks a window, the stalls and the flight events; ``save`` writes
    ``state_trees()`` as a sharded checkpoint; ``listener_rank`` gives
    that rank alone a listener, whose iterations are returned."""
    from deeplearning4j_tpu_torch.backend import mesh as mesh_mod
    from deeplearning4j_tpu_torch.observability import get_flight_recorder
    from deeplearning4j_tpu_torch.parallel import (
        DistributedNetwork, ElasticConfig, ParallelWrapper,
        ParameterAveragingTrainingMaster, save_checkpoint,
    )
    from deeplearning4j_tpu_torch.resilience import inject_faults

    net = _net(job)
    mesh = _mesh(device=job.get("device", "cpu"))
    since = len(get_flight_recorder().events())
    elastic = (ElasticConfig(**job["elastic"]) if job.get("elastic")
               is not None else False)
    kw = dict(averaging_frequency=job.get("freq", 1),
              average_updaters=job.get("avg", True), mesh=mesh,
              elastic=elastic, update_sharding=job.get("mode",
                                                       "replicated"))
    if job.get("epochs"):
        runner = ParameterAveragingTrainingMaster(workers=4, **kw)
    else:
        runner = ParallelWrapper(net, workers=4, **kw)
    rec = _Recorded(runner.elastic) if runner.elastic is not None else None
    heard = None
    if job.get("listener_rank") == mesh_mod.process_index():
        heard = _Heard()
        net.listeners = list(net.listeners) + [heard]
    if job.get("evict") is not None:
        runner.elastic.evict(job["evict"], "manual", step=0)
    inj = _injector(job)
    fits = job.get("fits", [{}])
    for i, one in enumerate(fits):
        if inj is not None and one.get("clear_delay") is not None:
            inj.clear_worker_delay(one["clear_delay"])

        def run():
            if job.get("epochs"):
                DistributedNetwork(net, runner).fit(_batches(job),
                                                    epochs=job["epochs"])
            else:
                runner.fit(_batches(job))

        with contextlib.ExitStack() as stack:
            if inj is not None:
                stack.enter_context(inject_faults(inj))
            if job.get("emulate_capture"):
                stack.enter_context(_emulated_capture(
                    lambda: runner._staged))
            run()
    out = {"params": _vec(net), "iteration": net.iteration,
           "updater_state": _np_tree({k: v for k, v in
                                      net.updater_state.items()}),
           "net_state": _state(net), "score": float(net.score_value),
           "events": _flight(since),
           "live": _observed({k: getattr(net, f"_{n}_live", None)
                              for k, n in (("__introspect__", "introspect"),
                                           ("__numerics__", "numerics"))})}
    if heard is not None:
        out["heard"] = heard.iterations
    if rec is not None:
        ctl = runner.elastic
        out.update(masks=rec.masks, stalls=ctl.barrier_stalls,
                   stall_s=ctl.barrier_stall_seconds,
                   evicted=list(ctl.evicted_workers))
    if job.get("save"):
        save_checkpoint(job["save"], net, trees=runner.state_trees(),
                        mesh=mesh)
    staged = getattr(runner, "_staged", None)
    if staged is not None and getattr(staged, "_step_graphs", None):
        g = staged._step_graphs
        out["graphs"] = {"captures": g.captures, "replays": g.replays,
                         "programs": [k[0] for k in g.programs]}
    return out


class _Heard:
    """A listener that records the iterations it was told of."""

    def __init__(self):
        self.iterations = []

    def iteration_done(self, model, iteration):
        self.iterations.append(int(iteration))


class _Preempt:
    """A listener that raises this rank's preemption notice once the net
    reaches ``at`` (on the training thread, so at a known step)."""

    def __init__(self, handler, at):
        self.handler, self.at = handler, at

    def iteration_done(self, model, iteration):
        if iteration == self.at and not self.handler.stop_requested:
            self.handler.trigger()


def resilient(job):
    """A resilient fit across the processes (``job["master"]``: the sync
    master or ``ParallelWrapper``, 4 slots, ``job["mode"]``), through
    ``CheckpointManager(save_every_steps=2)`` in ``job["dir"]`` and a
    ``RetryPolicy``: (1) an unfaulted run; (2) a fatal fault on every
    rank at ``fatal_at`` (both raise); (3) a fresh net resumes from the
    last commit, a retryable fault on rank 1 alone at ``retry_at`` and a
    preemption notice on rank 1 alone at ``preempt_at`` (rank 0 has no
    handler): every rank stops there with a commit; (4) a fresh net
    resumes and finishes, committing every step; (5) a fatal fault on rank 1 alone at step 1,
    without a manager: every rank raises, and how soon."""
    from deeplearning4j_tpu_torch.backend import mesh as mesh_mod
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.parallel import (
        DistributedNetwork, ParallelWrapper, SyncTrainingMaster,
    )
    from deeplearning4j_tpu_torch.resilience import (
        CheckpointManager, FaultInjector, PreemptionHandler, RetryPolicy,
        inject_faults,
    )

    rank = mesh_mod.process_index()
    mesh = _mesh(device=job.get("device", "cpu"))
    x, y, b = job["x"], job["y"], job["batch"]
    mode = job.get("mode", "replicated")

    def fit(net, cm=None, rp=None, inj=None):
        batches = [DataSet(x[i:i + b], y[i:i + b])
                   for i in range(0, len(x), b)]
        if job["master"] == "sync":
            run = DistributedNetwork(net, SyncTrainingMaster(
                mesh=mesh, update_sharding=mode, checkpoint_manager=cm,
                retry_policy=rp)).fit
        else:
            run = ParallelWrapper(net, workers=4, mesh=mesh,
                                  update_sharding=mode,
                                  checkpoint_manager=cm,
                                  retry_policy=rp).fit
        with contextlib.ExitStack() as stack:
            if inj is not None:
                stack.enter_context(inject_faults(inj))
            run(iter(batches))

    def manager(every=2):
        return CheckpointManager(job["dir"], keep=10, save_every_steps=every,
                                 async_save=job.get("async", True))

    def policy():
        return RetryPolicy(max_retries=2, base_delay_s=0.0, jitter=0.0)

    out = {}
    net = _net(job)
    fit(net)
    out["unfaulted"] = _vec(net)
    out["iterations"] = [net.iteration]
    # (2) a fatal fault on every rank
    net, cm = _net(job), manager()
    try:
        fit(net, cm, policy(), FaultInjector().fail_at_step(
            job["fatal_at"], transient=False))
        out["fatal"] = "none"
    except Exception as e:
        out["fatal"] = type(e).__name__
    cm.wait_idle()
    out["iterations"].append(net.iteration)
    out["steps_after_fatal"] = cm.all_steps()
    cm.close()
    # (3) resumed; a retryable fault and a preemption notice on rank 1
    net, cm, rp = _net(job), manager(), policy()
    inj = FaultInjector()
    handler = None
    if rank == 1:
        inj.fail_at_step(job["retry_at"], transient=True)
        handler = PreemptionHandler(cm)
        handler.install()
        net.listeners = list(net.listeners) + [
            _Preempt(handler, job["preempt_at"])]
    try:
        fit(net, cm, rp, inj)
    finally:
        if handler is not None:
            handler.uninstall()
    cm.wait_idle()
    out["iterations"].append(net.iteration)
    out["retries"] = rp.retries
    out["injected"] = [e["kind"] for e in inj.injected]
    out["latest"] = cm.latest_step()
    out["trigger"] = cm.read_commit(cm.latest())["trigger"]
    cm.close()
    # (4) resumed to the end, committing every step; the training
    # thread's agreements counted
    net, cm = _net(job), manager(every=1)
    with mesh_mod.census() as seen:
        fit(net, cm, policy())
    out["agreements"] = seen.counts["agreement"]["process_count"]
    cm.wait_idle()
    out["iterations"].append(net.iteration)
    out["resumed"] = _vec(net)
    out["steps"] = cm.all_steps()
    cm.close()
    # (5) a fatal fault on rank 1 alone
    net = _net(job)
    inj = FaultInjector()
    if rank == 1:
        inj.fail_at_step(1, transient=False)
    t0 = time.monotonic()
    try:
        fit(net, rp=policy(), inj=inj)
        out["lone_fatal"] = ("none", 0.0)
    except Exception as e:
        out["lone_fatal"] = (type(e).__name__, time.monotonic() - t0)
    out["lone_iteration"] = net.iteration
    return out


@contextlib.contextmanager
def _numpy_negatives(on):
    """Every model's negatives from one numpy stream of seed 0 (the same
    on every rank, and what the JAX side is fed)."""
    from deeplearning4j_tpu_torch.nlp import lookup

    if not on:
        yield
        return
    stream = np.random.RandomState(0)

    def draw(self, key, shape):
        return torch.as_tensor(stream.randint(0, len(self.cache), shape)
                               .astype(np.int32)).to(self.device)

    saved = lookup.InMemoryLookupTable.sample_negatives
    lookup.InMemoryLookupTable.sample_negatives = draw
    try:
        yield
    finally:
        lookup.InMemoryLookupTable.sample_negatives = saved


def _sentences(job):
    """The job's corpus; ``differ_on`` names a rank that drops its first
    sentence (a vocabulary that differs there)."""
    from deeplearning4j_tpu_torch.backend import mesh as mesh_mod

    s = list(job["sentences"])
    return s[1:] if job.get("differ_on") == mesh_mod.process_index() else s


def nlp_fit(job):
    """``DistributedWord2Vec`` (``job["w2v"]``: the Builder's settings)
    or ``DistributedGlove`` (``job["glove"]``) over 4 slots across the
    processes (or in one process): the tables, the summed loss and the
    vocabulary's size, or the error an agreement check raised."""
    from deeplearning4j_tpu_torch.nlp import distributed as nd
    from deeplearning4j_tpu_torch.nlp.documents import (
        CollectionSentenceIterator,
    )

    mesh = _mesh(device=job.get("device", "cpu"))
    with _numpy_negatives(job.get("numpy_negatives")):
        if "glove" in job:
            model = nd.DistributedGlove(
                sentence_iterator=CollectionSentenceIterator(
                    _sentences(job)), mesh=mesh, **job["glove"])
        else:
            b = nd.DistributedWord2Vec.Builder().iterate(_sentences(job))
            for k, v in job["w2v"].items():
                getattr(b, k)(v)
            model = b.mesh(mesh).build()
        try:
            model.fit()
        except ValueError as e:
            return {"error": str(e)}
    lk = model.lookup
    tables = {k: getattr(lk, k) for k in ("syn0", "syn1", "syn1neg")}
    if "glove" in job:
        tables = {f"state{i}": t for i, t in enumerate(model._state)}
        tables["syn0"] = lk.syn0
    return {"tables": {k: t.detach().cpu().numpy().copy()
                       for k, t in tables.items() if t is not None},
            "cum_loss": model.cum_loss, "vocab": len(model.vocab),
            "captures": model.programs.counts()["captures"]}


def commit(job):
    """The sync master over 4 slots across the processes committing
    every step for ``job["first"]`` batches (``CheckpointManager`` in
    ``job["dir"]``), then a fresh net resumed from that commit for the
    rest, against an unfaulted fit: both params and the commits."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.parallel import (
        DistributedNetwork, SyncTrainingMaster,
    )
    from deeplearning4j_tpu_torch.resilience import CheckpointManager

    mesh = _mesh(device=job.get("device", "cpu"))
    x, y, b = job["x"], job["y"], job["batch"]
    batches = [DataSet(x[i:i + b], y[i:i + b]) for i in range(0, len(x), b)]

    def fit(part, cm=None):
        net = _net(job)
        DistributedNetwork(net, SyncTrainingMaster(
            mesh=mesh, checkpoint_manager=cm)).fit(iter(part))
        if cm is not None:
            cm.wait_idle()
        return net

    want = _vec(fit(batches))
    cm = CheckpointManager(job["dir"], keep=10, save_every_steps=1)
    fit(batches[:job["first"]], cm)
    saved = cm.all_steps()
    cm.close()
    cm = CheckpointManager(job["dir"], keep=10, save_every_steps=1)
    net = fit(batches, cm)
    out = {"want": want, "got": _vec(net), "iteration": net.iteration,
           "saved": saved, "steps": cm.all_steps()}
    cm.close()
    return out


JOBS = {"fit": fit, "evaluate": evaluate, "restore": restore,
        "guards": guards, "group": group, "cuda_gather": cuda_gather,
        "nccl_psum": nccl_psum, "wrapper": wrapper, "streams": streams,
        "resilient": resilient, "nlp_fit": nlp_fit, "commit": commit}
