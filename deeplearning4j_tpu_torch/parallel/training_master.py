"""Distributed training masters — the port's counterpart of
``deeplearning4j_tpu/parallel/training_master.py``.

- ``SyncTrainingMaster``: synchronous data parallelism over the slot
  mesh's data axis.  The global batch's rows are the K data slots'
  contiguous row blocks side by side, and the step is one forward and
  one backward over all of them under ``backend.slots.data_slots(K)``:
  the reference's one global program (``training_master.py:245``), so
  the layers that couple the rows of a batch, BatchNorm's statistics and
  the MoE layer's routing, read the global batch, gathered across the
  slots (``gather_rows``; on the card the BatchNorm kernels run on the
  gathered rows).  The psum of the slots' gradients is the reduction
  over their rows inside each weight gradient, recorded in the census as
  each leaf's all-reduce of the K slots' contributions.  Then one update,
  with the introspection policy's and the numerics ledger's statistics
  from the global gradient and the global batch's activations, as the
  single net's step (``common.sgd_step``).  Under
  ``update_sharding="zero"`` the params and the inner updater slots are
  ``[K, n/K, ...]`` views of the net's tensors, all-gathered for the
  forward; the gradient arrives in blocks (the reduce-scatter) and the
  update runs on the blocks.  The ledger's ``__numerics__`` subtree is
  carried through a ZeRO step unchanged, as the reference's docstring
  says.  The step is one captured graph on the card.
- ``ParameterAveragingTrainingMaster``: a ``ParallelWrapper`` an epoch
  around one persistent elastic controller (per-replica statistics, as
  the reference's).
- ``DistributedNetwork``: a net and a master; ``fit``, ``evaluate``
  (each batch padded to a multiple of the data axis) and ``score``.

``TensorParallelTrainingMaster`` is in ``model_parallel.py``,
``PipelineParallelTrainingMaster`` in ``pipeline.py``.

**Across processes.**  ``initialize_distributed`` (the reference's
signature; ``jax.distributed.initialize`` there) brings up a
``torch.distributed`` process group: one process a card, NCCL between
cards, gloo on the CPU.  A mesh made after it spans the processes
(``backend/mesh.py``): process r holds the data slots ``r*K/W ...``.
The sync master and ``DistributedNetwork`` then run with the reference's
semantics, every process reading the same global batch and keeping its
own rows (the reference ``device_put``s the whole batch onto the
data-sharded layout): the loss divides by the global batch's count, the
coupling layers gather every process's rows (``slots.gather_rows``), a
dropout mask is the global mask's rows, the gradients (and the loss) are
summed over the processes in rank order, so every rank and either layout
hold the same bits, and the stability guard's verdict folds the summed
gradient.  Under ZeRO a process holds and updates the updater-state
blocks of its own slots (the net's updater-state tensors keep the other
processes' blocks as they were: the sharded checkpoint saves each block
from its owner), and the updated parameter blocks are all-gathered into
every process's tensors.  That step runs eagerly (a
gloo collective cannot be captured in a CUDA graph; a captured step over
NCCL is ROADMAP A14d); its kernels launch on the card as ever.

Under ZeRO with gradient normalization each leaf's norm is the whole
summed gradient's, which the exchange hands every rank
(``updaters.given_norms``), never a process's own blocks'.  With
``elastic=`` every rank weights out the evicted slots' rows with the
same mask: its verdicts come from the injector's plan and from the
slots' step times, each measured by the process that owns the slot and
gathered in rank order, and the masks are checked equal at each step.
``ParameterAveragingTrainingMaster`` is a ``ParallelWrapper`` an epoch
there too (``data_parallel.py``).

The introspection policy and the numerics ledger run across processes
with the reference's semantics: the gradient, update and parameter
norms come from the summed gradient and the whole parameters every rank
holds after the exchange (under ZeRO after the updated blocks are
gathered), and the activations' statistics from every process's rows,
their partial sums (and the ledger's max-abs, stride-sampled counts and
histogram, the global batch's sample) reduced across the processes
before they are divided (``common.sgd_step``'s exchange).  Under ZeRO
the ledger's subtree is carried through unchanged, as in one process.
``checkpoint_manager=`` and ``retry_policy=`` run through
``FitResilience(mesh=)``, whose decisions every rank shares (resume
step, skipped batches; a save, a preemption notice and a step fault in
one agreement a step, ``FitResilience.boundary``), and a commit is
every process's shards behind barriers around process 0's rename
(``resilience/checkpoint_manager.py``).  What still raises across
processes, naming its ROADMAP item: the model and seq axes (A14b).
"""

from __future__ import annotations

import collections
import contextlib
import datetime
import functools
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.backend import device as device_mod
from deeplearning4j_tpu_torch.backend import mesh as mesh_mod
from deeplearning4j_tpu_torch.backend import rng as rng_mod
from deeplearning4j_tpu_torch.backend import slots
from deeplearning4j_tpu_torch.backend.mesh import AXIS_DATA, P, Sharded
from deeplearning4j_tpu_torch.models import capture as cap
from deeplearning4j_tpu_torch.models import common
from deeplearning4j_tpu_torch.observability import (
    PhaseTimers, WorkerTelemetry, crash_dump, introspection, numerics,
    shardstats,
)
from deeplearning4j_tpu_torch.observability.flightrecorder import step_guard
from deeplearning4j_tpu_torch.observability.recompile import instrument
from deeplearning4j_tpu_torch.optimize import updaters as upd
from deeplearning4j_tpu_torch.parallel import zero as zero_mod
from deeplearning4j_tpu_torch.parallel.data_parallel import (
    _Staged, _tmap, loss_of,
)
from deeplearning4j_tpu_torch.parallel.elastic import (
    ElasticConfig, ElasticController, check_mask, gather_worker_rows,
)
from deeplearning4j_tpu_torch.resilience import stability

DEFAULT_TIMEOUT_S = 600.0
_LAUNCHER = ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT")


def launched() -> bool:
    """A launcher (torchrun) put this process in a world of more than one:
    ``WORLD_SIZE`` > 1 with ``RANK``, ``MASTER_ADDR`` and
    ``MASTER_PORT``."""
    env = os.environ
    return all(k in env for k in _LAUNCHER) and int(env["WORLD_SIZE"]) > 1


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *,
                           backend: Optional[str] = None,
                           timeout: float = DEFAULT_TIMEOUT_S) -> None:
    """Multi-process bring-up (reference: ``jax.distributed.initialize``):
    this process joins a ``torch.distributed`` process group, after which
    a mesh spans every process (module docstring).

    The group comes from the explicit triple (``coordinator_address``
    ``host:port``, whose process 0 serves the rendezvous) or, with no
    arguments, from a launcher's environment (torchrun's ``WORLD_SIZE``,
    ``RANK``, ``MASTER_ADDR``, ``MASTER_PORT``); with neither it is a
    no-op, since one process needs no group.  An explicit world of one is
    a real group.  ``backend`` defaults to ``nccl`` where the process has
    a card (``cuda:{LOCAL_RANK % device_count}``, its device from then on)
    and ``gloo`` on the CPU.  A rank that does not arrive fails the call
    within ``timeout`` seconds.  A second call in one process raises."""
    explicit = (coordinator_address, num_processes, process_id)
    if all(v is None for v in explicit):
        if not launched():
            return
        init_method = "env://"
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    elif any(v is None for v in explicit):
        missing = [n for n, v in zip(
            ("coordinator_address", "num_processes", "process_id"),
            explicit) if v is None]
        raise ValueError(f"initialize_distributed needs coordinator_address, "
                         f"num_processes AND process_id; missing: {missing}")
    else:
        init_method = f"tcp://{coordinator_address}"
        world, rank = int(num_processes), int(process_id)
    if mesh_mod.processes_up():
        raise RuntimeError(
            "initialize_distributed: this process already joined a process "
            f"group (rank {mesh_mod.process_index()} of "
            f"{mesh_mod.process_count()})")
    import torch.distributed as dist

    card = None
    if torch.cuda.is_available():
        local = int(os.environ.get("LOCAL_RANK", rank))
        card = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(card)
    backend = backend or ("nccl" if card is not None else "gloo")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout))
    device_mod.set_process_device(card)


def shutdown_distributed() -> None:
    """Leave the process group (a no-op without one)."""
    if mesh_mod.processes_up():
        import torch.distributed as dist

        dist.destroy_process_group()
    device_mod.set_process_device(None)


class PhaseStats(PhaseTimers):
    """Phase-timed distributed training stats (reference ``PhaseStats``):
    ``phase()`` / ``steps`` / ``as_dict()``, mirrored into
    ``dl4j_phase_seconds{component, phase}``."""

    def __init__(self, enabled: bool = True,
                 component: str = "training_master"):
        super().__init__(component, enabled=enabled)


class TrainingMaster:
    """Strategy SPI (reference ``TrainingMaster.java:27``)."""

    def execute_training(self, net, iterator) -> None:
        raise NotImplementedError

    def training_stats(self) -> Dict[str, Any]:
        return {}


class SyncTrainingMaster(TrainingMaster):
    """Per-step synchronous data parallelism over the slot mesh (module
    docstring).  Without ``mesh`` the mesh is the default one (one slot a
    card)."""

    def __init__(self, mesh=None, batch_size: Optional[int] = None,
                 prefetch_size: int = 2, collect_stats: bool = False,
                 checkpoint_manager=None, retry_policy=None, elastic=False,
                 update_sharding: str = zero_mod.REPLICATED):
        self.mesh = mesh or mesh_mod.default_mesh()
        self.batch_size = batch_size
        self.prefetch_size = prefetch_size
        self.collect_stats = collect_stats
        self.update_sharding = zero_mod.validate_mode(update_sharding,
                                                      self.mesh)
        self._zero_layout = (zero_mod.ZeroLayout(self.mesh)
                             if self.update_sharding == zero_mod.ZERO
                             else None)
        # the global data axis (the census's groups, the slot names, the
        # batch's padding) and this process's own slots of it
        self.K = self.mesh.shape[AXIS_DATA]
        self.K_local = self.mesh.local_shape[AXIS_DATA]
        self._slots = [f"d{k}" for k in range(self.K)]
        self._elastic: Optional[ElasticController] = None
        if elastic is not False and elastic is not None:
            ecfg = elastic if isinstance(elastic, ElasticConfig) \
                else ElasticConfig()
            self.collect_stats = True
            self._elastic = ElasticController("sync_master", self._slots,
                                              config=ecfg)
        self.checkpoint_manager = checkpoint_manager
        self.retry_policy = retry_policy
        self._stats: Dict[str, Any] = {
            "steps": 0, "step_time_ms": collections.deque(maxlen=1024)}
        if self.mesh.spans_processes:
            self._stats.update(exchange_seconds=0.0, exchange_bytes=0.0,
                               exchange_count=0)
        self._phases = PhaseStats(enabled=collect_stats,
                                  component="sync_master")
        self._workers: Optional[WorkerTelemetry] = None
        self._step = None
        self._holder = None
        self._stab_rt = None

    @property
    def elastic(self) -> Optional[ElasticController]:
        return self._elastic

    def _evicted_labels_mask(self, ds, emask, K: int):
        """The labels mask with the evicted slots' rows zeroed."""
        B = len(ds)
        rw = np.repeat(np.asarray(emask, np.float32), B // K)
        lm = ds.labels_mask
        if lm is None:
            return rw.reshape((B,) + (1,) * (np.ndim(ds.labels) - 2))
        lm = np.asarray(lm)
        return lm * rw.reshape((B,) + (1,) * (lm.ndim - 1))

    # ------------------------------------------------------------- build
    def _stage(self, net):
        """What the step reads and writes: the net itself (replicated),
        or a holder whose params and inner updater slots are
        ``[K, n/K, ...]`` views of the net's tensors (ZeRO)."""
        if self._zero_layout is None:
            return net
        h = self._holder
        leaves = cap.state_leaves(net)
        if h is not None and h._of is net and all(
                a is b for a, b in zip(h._bases, leaves)) and \
                len(h._bases) == len(leaves):
            return h
        lay = self._zero_layout
        self._pmask = lay.mask(net.params)

        def view(t):
            return (t.view((lay.k, t.shape[0] // lay.k) + tuple(t.shape[1:]))
                    if lay.shardable(t) else t)

        params = _tmap(view, net.params)
        ustate = {slot: (tree if slot in
                         shardstats.RESERVED_REPLICATED_SUBTREES
                         else _tmap(view, tree))
                  for slot, tree in net.updater_state.items()}
        h = _Staged(net, params, ustate, net.net_state)
        h._of, h._bases = net, leaves
        h.iteration = net.iteration
        h._local = None
        if self.mesh.spans_processes:
            # this process's blocks: what its update reads and writes
            sl = self.mesh.local_slots

            def mine(t):
                return (view(t)[sl.start:sl.stop] if lay.shardable(t)
                        else t)

            h._local = _Staged(net, _tmap(mine, net.params), {
                slot: (tree if slot in
                       shardstats.RESERVED_REPLICATED_SUBTREES
                       else _tmap(mine, tree))
                for slot, tree in net.updater_state.items()},
                net.net_state)
        self._holder = h
        return h

    def _full(self, params):
        """The params tree the forward reads, from the step's leaves."""
        if self._zero_layout is not None:
            return zero_mod.all_gather_tree(params, self._pmask)
        return params

    def _model_slots(self):
        return contextlib.nullcontext()

    def _exchange(self, h, norms, grads, loss, extra_ok):
        """The cross-process half of the step (``_ProcessExchange``): the
        gradients and the loss summed over the processes in rank order,
        one collective; under ZeRO the process's own blocks of them, for
        the holder of its blocks, with the guard's verdict folded over
        the whole summed gradient (so that every rank, and either layout,
        takes the same branch), and with gradient normalization
        (``norms``, a dict) each layer's norms from the whole summed
        gradient, unscaled as the update unscales it.  Returns what the
        update reads and what the statistics read (the whole holder, its
        trainable params and the summed gradient)."""
        train = common.trainable(h.params)
        leaves = common.tree_leaves(grads)
        summed = mesh_mod.process_sum_many(leaves + [loss])
        grads, loss = common._tree_like(train, summed[:-1]), summed[-1]
        seen = (h, train, grads)
        hl = h._local if self._zero_layout is not None else None
        if hl is None:
            return (h, train, grads, loss, extra_ok), seen
        whole = grads
        if extra_ok is not None:
            stab = h.updater_state[stability.STATE_KEY]
            whole, fin = stability.unscale(loss, grads, stab["loss_scale"])
            extra_ok = extra_ok & fin
        if norms is not None:
            cfg = h.conf.updater
            for lname, lg in whole.items():
                norms[lname] = upd.layer_norms(cfg, upd._flat(lg))
        hl.iteration = h.iteration
        local = common.trainable(hl.params)
        sl = self.mesh.local_slots
        mine = [g[sl.start:sl.stop] if l.shape != p.shape else g
                for g, p, l in zip(common.tree_leaves(grads),
                                   common.tree_leaves(train),
                                   common.tree_leaves(local))]
        return (hl, local, common._tree_like(local, mine), loss,
                extra_ok), seen

    def _gather_blocks(self, h) -> None:
        """ZeRO across processes: every process's updated parameter blocks
        into every process's whole tensors (one all-gather a dtype)."""
        pairs = [(f, l) for f, l in zip(
            common.tree_leaves(common.trainable(h.params)),
            common.tree_leaves(common.trainable(h._local.params)))
            if f.shape != l.shape]
        got = mesh_mod.process_all_gather_many([l for _, l in pairs])
        with torch.no_grad():
            for (f, _), g in zip(pairs, got):
                f.copy_(g.reshape(f.shape))

    def _body(self, x, y, fm, lm, key, scalars, numerics_now=None):
        """One synchronous step over the K slots (module docstring); across
        processes over this process's slots' rows.  Returns the global
        loss and, under a stability policy, the ``[K]`` slot poison
        flags."""
        net, K = self.net_, self.K
        h = self._stage(net)
        xp = self.mesh.spans_processes
        policy = stability.policy_of(net.conf)
        row_ok = extra_ok = None
        if policy is not None:
            row_ok = stability.finite_rows(x, y)
            x = stability.zero_nonfinite_rows(x, row_ok)
            y = stability.zero_nonfinite_rows(y, row_ok)
            lm = lm * row_ok.reshape((row_ok.shape[0],)
                                     + (1,) * (lm.ndim - 1))
            kept = row_ok.sum()
            extra_ok = (mesh_mod.process_sum(kept) if xp else kept) > 0

        def loss_fn(params, collect=None):
            return loss_of(net, self._full(params), h.net_state, x, y, key,
                           fm, lm, collect=collect)

        norms = ({} if xp and self._zero_layout is not None
                 and net.conf.updater.gradient_normalization != "none"
                 else None)
        with slots.data_slots(K, processes=xp), self._model_slots(), \
                upd.given_norms(norms):
            loss = common.sgd_step(
                h, loss_fn, scalars, numerics_now=numerics_now,
                extra_ok=extra_ok,
                exchange=_ProcessExchange(self, h, norms) if xp else None)
        # the K slots' gradient contributions, summed (a reduce-scatter
        # into ZeRO's blocks), and their weighted losses
        op = "reduce-scatter" if self._zero_layout is not None \
            else "all-reduce"
        for p in common.tree_leaves(common.trainable(h.params)):
            mesh_mod.note(op, p.expand((K,) + tuple(p.shape)), K)
        mesh_mod.note("all-reduce", loss.expand(K), K)
        if policy is not None:
            flags = stability.slot_poison_flags(row_ok, self.K_local)
            if xp:
                flags = mesh_mod.process_all_gather(flags).reshape(K)
            return loss, flags
        return loss

    def _dispatch(self, x, y, fm, lm, net):
        self.net_ = net
        h = self._stage(net)
        h.iteration = net.iteration
        seed = rng_mod.seed_of(net._keys.next())
        vals = common._step_scalars(net, net.iteration)
        iplan, nplan = common.observed_plans(net)
        if h is not net:
            # the holder's policies: the ledger is carried through a
            # ZeRO step unchanged
            h._observed = (net.conf, iplan,
                           None if self._zero_layout is not None else nplan)
            nplan = h._observed[2]
        body, variant = self._body, None
        if iplan is not None or nplan is not None:
            vals["iteration"] = float(net.iteration)
            now = numerics.collect_now(nplan, net.iteration)
            if now is not None:
                # interval-gated ledger: a collecting and a skipping step
                body = functools.partial(self._body, numerics_now=now)
                variant = ("numerics", now)
        dtype = common._scalar_dtype(net)
        inputs = {"x": x, "y": y, "fm": fm, "lm": lm}
        # across processes the step runs eagerly: a gloo collective cannot
        # be captured in a CUDA graph (ROADMAP A14d)
        if not self.mesh.spans_processes and cap.captures(h):
            graphs = cap.step_graphs(h)
            inputs = common.tree_map(cap.host_or_device, inputs)
            # a master of another kind or mesh on the same net is
            # another program
            kind = (f"sync:{type(self).__name__}:"
                    f"{sorted(self.mesh.shape.items())}")
            prog = graphs.program(kind, body, inputs, len(vals), dtype,
                                  variant=variant)
            prog.scalar_names = list(vals)
            graphs.stage(prog, inputs, seed, list(vals.values()))
            with mesh_mod.census() as c:
                fresh = prog.graph is None
                out = graphs.run(prog)
            if fresh:
                self._record(prog.cache_key, c.counts, 2)
            return out
        dev = net.device
        sc = torch.tensor(list(vals.values()), dtype=dtype, device=dev)
        with mesh_mod.census() as c:
            out = body(**{k: (None if v is None else
                              common._on(v, dev) if isinstance(v, dict)
                              else torch.as_tensor(v, device=dev))
                          for k, v in inputs.items()},
                       key=rng_mod.device_key(seed, dev),
                       scalars=dict(zip(vals, sc.unbind(0))))
        sig = cap.signature(common.tree_map(cap.host_or_device, inputs))
        if variant is not None:
            sig += (variant,)
        if sig not in self._seen:
            self._seen.add(sig)
            self._record(sig, c.counts, 1)
        return out

    def _record(self, sig, counts, runs) -> None:
        counts = {op: {"count": e["count"] // runs,
                       "bytes": e["bytes"] / runs,
                       "group_sizes": e["group_sizes"]}
                  for op, e in counts.items()}
        shardstats.record_program(f"{type(self).__name__}.step", sig,
                                  counts, device=self.mesh.device)

    def state_trees(self, net):
        """The net's trees as ``Sharded`` leaves over the mesh (ZeRO's
        blocks sharded over the data axis, the rest replicated): what
        ``save_checkpoint(dir, net, trees=, mesh=)`` writes piece by
        piece, each process its own slots' blocks across processes."""
        return self._ledger_trees(net)

    def _ledger_trees(self, net):
        mesh = self.mesh
        if self._zero_layout is None:
            rep = lambda a: Sharded(a, P(), mesh, a.shape)  # noqa: E731
            return {"params": _tmap(rep, net.params),
                    "updater_state": _tmap(rep, net.updater_state),
                    "net_state": _tmap(rep, net.net_state)}
        h, lay = self._stage(net), self._zero_layout
        rep = lambda a: Sharded(a, P(), mesh, a.shape)  # noqa: E731
        ustate = {slot: (_tmap(rep, tree) if slot in
                         shardstats.RESERVED_REPLICATED_SUBTREES
                         else lay.as_sharded(tree, net.updater_state[slot]))
                  for slot, tree in h.updater_state.items()}
        return {"params": lay.as_sharded(h.params, net.params),
                "updater_state": ustate,
                "net_state": _tmap(rep, net.net_state)}

    # --------------------------------------------------------------- fit
    def execute_training(self, net, iterator):
        from deeplearning4j_tpu_torch.datasets.iterator import (
            AsyncDataSetIterator, DataSetIterator,
        )
        from deeplearning4j_tpu_torch.resilience import (
            FitResilience, get_fault_injector, preemption_requested,
        )
        from deeplearning4j_tpu_torch.resilience.preemption import (
            preemption_watched,
        )

        if net.device != self.mesh.device:
            raise ValueError(f"the mesh's slots are on {self.mesh.device}, "
                             f"the net on {net.device}")
        common.check_trainable(net)
        xp = self.mesh.spans_processes
        res = None
        if self.checkpoint_manager is not None or self.retry_policy \
                is not None:
            res = FitResilience("sync_master", self.checkpoint_manager,
                                self.retry_policy, net=net, mesh=self.mesh,
                                trees=lambda: self.state_trees(net))
        # without resilience, across processes, a preemption check is a
        # gather: made only when a rank holds a handler
        watch = res is None and preemption_watched(self.mesh)
        if isinstance(iterator, DataSetIterator) and \
                iterator.async_supported():
            iterator = AsyncDataSetIterator(iterator, self.prefetch_size)
        policy = stability.policy_of(net.conf)
        if policy is not None:
            stability.ensure_state(net)
            created = self._stab_rt is None
            if created:
                self._stab_rt = stability.StabilityRuntime(
                    "sync_master", policy, worker_ids=self._slots)
            if created or (res is not None and res.resumed_from is not None):
                self._stab_rt.baseline_from(
                    net.updater_state.get(stability.STATE_KEY))
        stab_rt = self._stab_rt
        if getattr(net.conf, "introspection", None) is not None:
            introspection.ensure_state(net)
        if getattr(net.conf, "numerics", None) is not None:
            numerics.ensure_state(net)
        if self._step is None:
            self._seen = set()
            self._step = instrument(
                self._dispatch, f"{type(self).__name__}.step",
                argnums=(0, 1, 2, 3),
                graphs=lambda: (cap.step_graphs(self._stage(self.net_))
                                if cap.captures(self._stage(self.net_))
                                else None))
        self.net_ = net
        K = self.K
        shardstats.record_ledger(
            "sync_master", self._ledger_trees(net), data_axis_size=K,
            notes=(self._zero_layout.notes()
                   if self._zero_layout is not None else None))
        always_mask = (self._elastic is not None or stab_rt is not None
                       or self._zero_layout is not None)
        it = iter(iterator)
        while True:
            with self._phases.phase("fetch"):
                ds = next(it, None)
            if ds is None:
                if res is not None:
                    # the save due after the last step
                    _, trigger = res.boundary(net.iteration, last=True)
                    if trigger is not None:
                        res.save(net, trigger)
                break
            if res is not None and res.skip_batch():
                continue
            if res is not None:
                # one agreement a step: the stop, the save due after the
                # previous step, this step's fault
                stop, trigger = res.boundary(net.iteration)
                if trigger is not None:
                    res.save(net, trigger)
                if stop:
                    res.on_preempt(net)
                    break
            elif watch and preemption_requested(self.mesh):
                break
            n_real = len(ds)
            if len(ds) % K:
                ds = ds.pad_batch(((len(ds) + K - 1) // K) * K)
            # across processes every process reads the global batch and
            # keeps its own slots' rows
            own = (_process_rows(len(ds), self.mesh) if xp else None)
            emask = None
            step0 = net.iteration
            if self._elastic is not None:
                emask = self._elastic.begin_window(step0)
                if xp:
                    check_mask(emask, "SyncTrainingMaster")
                if emask.min() >= 1.0:
                    emask = None
            feats = ds.features
            inj = get_fault_injector()
            if inj is not None and inj.has_poison():
                feats = inj.poison_rows(self._slots, step0, feats, K)
            t0 = time.perf_counter()
            if not always_mask:
                lm = ds.labels_mask
            elif emask is not None:
                lm = self._evicted_labels_mask(ds, emask, K)
            elif ds.labels_mask is not None:
                lm = ds.labels_mask
            else:
                # one program: the mask is always an array, so an
                # eviction or a poisoned row changes values, not shapes
                lm = np.ones((len(ds),) + (1,) * (np.ndim(ds.labels) - 2),
                             np.float32)
            labels, fmask = ds.labels, ds.features_mask
            if own is not None:
                feats, labels, fmask, lm = (
                    _rows(a, own) for a in (feats, labels, fmask, lm))
                ex0 = mesh_mod.process_totals()
            with step_guard("sync_step", component="sync_master",
                            iteration=net.iteration):
                with self._phases.phase("dispatch"):
                    def call(feats=feats, labels=labels, fmask=fmask,
                             lm=lm):
                        return self._step(feats, labels, fmask, lm, net)

                    out = (res.step(call, net.iteration, net=net)
                           if res is not None else call())
                    if stab_rt is not None:
                        loss, slot_poison = out
                        stab_rt.accumulate(poison_flags=slot_poison)
                    else:
                        loss = out
            net.score_value = loss.clone()
            net.iteration += 1
            if own is not None:
                ex1 = mesh_mod.process_totals()
                for k, e in (("exchange_seconds", "seconds"),
                             ("exchange_bytes", "bytes"),
                             ("exchange_count", "count")):
                    self._stats[k] += ex1[e] - ex0[e]
            if stab_rt is not None:
                action = stab_rt.poll_master(
                    step=net.iteration, losses=loss,
                    stab_state=net.updater_state[stability.STATE_KEY],
                    elastic=self._elastic,
                    can_rewind=res is not None and res.cm is not None)
                if action == "backoff":
                    stability.apply_lr_backoff_(net.updater_state, policy)
                elif action == "rewind":
                    stab_rt.rewind(net, res.cm, mesh=self.mesh)
            if self.collect_stats:
                if self._workers is None:
                    self._workers = (
                        self._elastic.cfg.make_worker_telemetry(
                            "sync_master") if self._elastic is not None
                        else WorkerTelemetry("sync_master"))
                    if self._elastic is not None:
                        self._elastic.attach_detector(
                            self._workers.detector)
                with self._phases.phase("device_sync"):
                    if loss.is_cuda:
                        torch.cuda.current_stream(loss.device).synchronize()
                step_s = time.perf_counter() - t0
                self._stats["step_time_ms"].append(step_s * 1e3)
                per_dev = max(1, len(ds) // K)
                # each slot's time measured by the process that owns it
                # (across processes gathered, so every rank's detector
                # takes the same inputs)
                sl = self.mesh.local_slots
                times = gather_worker_rows([
                    [step_s + (inj.worker_delay(w) if inj is not None
                               else 0.0)]
                    for w in self._slots[sl.start:sl.stop]])
                for worker, (w_s,) in zip(self._slots, times):
                    self._workers.observe(worker, float(w_s), batch=per_dev)
            if self._elastic is not None:
                self._elastic.window_barrier(step0)
            self._stats["steps"] += 1
            self._phases.steps += 1
            common.notify_listeners(net, n_real)
        if stab_rt is not None:
            stab_rt.flush(net)

    def training_stats(self):
        out = dict(self._stats)
        out["step_time_ms"] = list(out["step_time_ms"])
        out.update(self._phases.as_dict())
        if self._workers is not None:
            out["cluster"] = self._workers.cluster_view()
        if self._elastic is not None:
            out["elastic"] = self._elastic.summary()
        return out


class _ProcessExchange:
    """``common.sgd_step``'s ``exchange`` for the sync master across
    processes (``SyncTrainingMaster._exchange``); after the call
    ``watched`` holds what the statistics read, and ``finish()`` gathers
    ZeRO's updated parameter blocks into every rank before they read
    the updated parameters."""

    def __init__(self, master, h, norms):
        self.master, self.h, self.norms = master, h, norms
        self.watched = None

    def __call__(self, grads, loss, extra_ok):
        out, self.watched = self.master._exchange(self.h, self.norms, grads,
                                                  loss, extra_ok)
        return out

    def finish(self) -> None:
        if self.master._zero_layout is not None:
            self.master._gather_blocks(self.h)


def _process_rows(n: int, mesh) -> slice:
    """This process's rows of a global batch of ``n`` rows: its data
    slots' contiguous blocks."""
    per = n // mesh.process_count
    return slice(mesh.process_index * per, (mesh.process_index + 1) * per)


def _rows(a, sl: slice):
    """Rows ``sl`` of a batch leaf (arrays, tensors, dicts or lists of
    them; None stays None)."""
    if a is None:
        return None
    if isinstance(a, dict):
        return {k: _rows(v, sl) for k, v in a.items()}
    if isinstance(a, (list, tuple)):
        return type(a)(_rows(v, sl) for v in a)
    return a[sl]


class ParameterAveragingTrainingMaster(TrainingMaster):
    """Reference-semantics parameter averaging (reference
    ``ParameterAveragingTrainingMaster``): a ``ParallelWrapper`` an epoch
    around one persistent elastic controller."""

    def __init__(self, workers: Optional[int] = None, batch_size: int = 32,
                 averaging_frequency: int = 5, average_updaters: bool = True,
                 prefetch_size: int = 2, repartition: str = "always",
                 mesh=None, collect_stats: bool = False, elastic=False,
                 update_sharding: str = zero_mod.REPLICATED):
        self.mesh = mesh
        self.workers = workers or (mesh.shape[AXIS_DATA] if mesh is not None
                                   else None)
        self.batch_size = batch_size
        self.averaging_frequency = averaging_frequency
        self.average_updaters = average_updaters
        self.prefetch_size = prefetch_size
        self.collect_stats = collect_stats
        if mesh is not None:
            zero_mod.validate_mode(update_sharding, mesh)
        elif update_sharding not in zero_mod.MODES:
            raise ValueError(f"update_sharding must be one of "
                             f"{zero_mod.MODES}, got {update_sharding!r}")
        self.update_sharding = update_sharding
        if (update_sharding == zero_mod.ZERO
                and self.averaging_frequency != 1):
            raise ValueError(
                "update_sharding='zero' requires averaging_frequency=1 "
                f"(got {self.averaging_frequency}): local-SGD windows "
                "need full per-replica updater state between averages")
        self._elastic: Optional[ElasticController] = None
        if elastic is not False and elastic is not None:
            if self.workers is None:
                raise ValueError("elastic= needs workers= or mesh=")
            ecfg = elastic if isinstance(elastic, ElasticConfig) \
                else ElasticConfig()
            self._elastic = ElasticController(
                "parallel_wrapper", [str(k) for k in range(self.workers)],
                config=ecfg)
        self._stats: Dict[str, Any] = {"windows": 0}
        self._phases = PhaseStats(component="param_avg_master")

    @property
    def elastic(self) -> Optional[ElasticController]:
        return self._elastic

    def execute_training(self, net, iterator):
        from deeplearning4j_tpu_torch.parallel.data_parallel import (
            ParallelWrapper,
        )

        pw = ParallelWrapper(
            net, workers=self.workers, prefetch_size=self.prefetch_size,
            averaging_frequency=self.averaging_frequency,
            average_updaters=self.average_updaters, mesh=self.mesh,
            elastic=self._elastic if self._elastic is not None else False,
            update_sharding=self.update_sharding)
        with self._phases.phase("fit"):
            pw.fit(iterator)
        self._stats["windows"] += 1
        self._phases.steps += pw.iteration

    def training_stats(self):
        out = dict(self._stats)
        out.update(self._phases.as_dict())
        if self._elastic is not None:
            out["elastic"] = self._elastic.summary()
        return out


class DistributedNetwork:
    """A net and a master (reference ``DistributedNetwork``)."""

    def __init__(self, net, training_master: TrainingMaster):
        self.net = net
        self.master = training_master

    def fit(self, iterator, epochs: int = 1):
        try:
            for _ in range(epochs):
                if hasattr(iterator, "reset"):
                    iterator.reset()
                self.master.execute_training(self.net, iterator)
        except Exception as e:
            crash_dump("fit_exception",
                       master=type(self.master).__name__, error=repr(e))
            raise
        return self.net

    def evaluate(self, iterator, evaluation=None):
        """Each batch padded to a multiple of the master's data axis and
        run through ``output`` (the slots share the device, so one
        forward covers their blocks); the metrics accumulate on the
        host.  Across processes each process runs its own rows inside
        the mesh's data slots (a layer that couples the rows, the MoE
        router, reads the global batch's, as the reference's one
        program) and the outputs are all-gathered in rank order, so
        every rank counts the whole batch and returns the same
        metrics."""
        from deeplearning4j_tpu_torch.evaluation import Evaluation

        ev = evaluation or Evaluation()
        mesh = getattr(self.master, "mesh", None)
        pad_to = mesh.shape[AXIS_DATA] if mesh is not None else 1
        xp = mesh is not None and mesh.spans_processes
        for ds in iterator:
            n = len(ds)
            run = (ds.pad_batch(((n + pad_to - 1) // pad_to) * pad_to)
                   if n % pad_to else ds)
            feats, fmask = run.features, run.features_mask
            if not xp:
                out = self.net.output(feats, fmask=fmask).detach()
            else:
                own = _process_rows(len(run), mesh)
                with slots.data_slots(pad_to, processes=True):
                    out = self.net.output(_rows(feats, own),
                                          fmask=_rows(fmask, own)).detach()
                out = mesh_mod.process_all_gather(out).reshape(
                    (-1,) + tuple(out.shape[1:]))
            ev.eval(ds.labels, out.cpu().numpy()[:n],
                    mask=ds.labels_mask)
        return ev

    def score(self, dataset):
        """The loss of ``dataset``; across processes the global batch's,
        each process scoring its own rows."""
        mesh = getattr(self.master, "mesh", None)
        if (mesh is None or not mesh.spans_processes
                or len(dataset) % mesh.process_count):
            return self.net.score(dataset.features, dataset.labels)
        own = _process_rows(len(dataset), mesh)
        with slots.data_slots(mesh.shape[AXIS_DATA], processes=True):
            part = self.net.score(_rows(dataset.features, own),
                                  _rows(dataset.labels, own))
        return float(mesh_mod.process_sum(
            torch.tensor(part, dtype=torch.float64)))

    def training_stats(self):
        return self.master.training_stats()
