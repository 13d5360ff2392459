"""Single-host data parallelism: ``ParallelWrapper`` — the port's
counterpart of ``deeplearning4j_tpu/parallel/data_parallel.py``.

The K replicas live on a slot mesh (``backend.mesh``): their params,
updater state and layer state are stacked ``[K, ...]`` tensors on the
mesh's device.  A window trains ``averaging_frequency`` (F) minibatches
per replica, then averages params, layer state and (with
``average_updaters``) updater state over the replicas with the ``[K]``
weights, and broadcasts the average back into every slot — the
reference's ``fit_window`` (``data_parallel.py:331-397``).

The reference vmaps one replica's step over the stack.  The port's
kernels are ``ctypes`` launches inside ``autograd.Function``s with no
batching rule, so the replica step is a loop over the K slots: replica
k's params and updater state are views into the stacks (``stack[k]``,
detached leaves), and ``common.sgd_step`` on them writes the gradient
step straight into the stack, which the average then reads in place.
On the card the whole window — F × K steps and the average — is ONE
captured graph (``models/capture.py``), its inputs (the window's
minibatches, the ``[K]`` weights, the key and the F steps' updater
scalars) static tensors the host rewrites, so an eviction, a poisoned
replica or a padded tail's weights replay the same graph.  The graph's
pool reuses one replica's activations for the next, so a capture holds
about one replica's activations beside the stacked state.

Per-replica dropout keys are the window key's children, child
``f*K + k`` for replica k at minibatch f (the reference folds in the
slot index).  The ``__introspect__`` and ``__numerics__`` subtrees stay
per replica and are not averaged (``:381-393``).

``update_sharding="zero"`` (``_build_zero``): params and the updater's
moments are laid out ``[K, n/K, ...]`` (``parallel/zero.py``), one copy
in all.  Each replica runs its forward and backward on the gathered
params, its whole gradient normalized; an all-to-all hands every
owner its block of each replica's gradient; each replica's elementwise
update against the shared moments is averaged with the weights, and the
average applied to the blocks: the replicated window's
average-of-updates exactly.  F must be 1 and the updaters averaged, as
in the reference.  Introspection packs each replica's gradient norms
and activation stats beside the shared update and parameter norms
(``zero.pack_introspection``); the numerics ledger's vector is carried
through unchanged, as the reference's (``:412-417``).

Windows come from ``native.Batcher`` (in-memory 2-D unmasked data,
whole ``[F*K*B]`` slabs, ``_native_windows``) or from the
``_WindowAssembler`` thread; a ragged tail's pad-filled replicas are
weighted out (``_pad_weights``).  With ``elastic=`` an evicted replica
gets weight 0 and its slot the average (the readmission's catch-up).

**Across processes** (a mesh made after ``initialize_distributed``,
``backend/mesh.py``): process r holds the global slots ``r*K/W ...
(r+1)*K/W - 1``, its stacks ``[K/W, ...]``.  Every process reads the
same global window and keeps its own slots; replica k's dropout key is
child ``f*K + k`` with k global.  The average gathers every process's
slot values into the global ``[K, ...]`` stack in slot order
(``mesh.process_gather_slots``) and reduces it with the one-process
formula, so two processes of two slots equal the one-process four-slot
wrapper bit for bit, and every rank ends each window holding the same
bits.  The stability guard's finite flags, the window's losses and its
non-finite count are gathered before use, so every rank weights out the
same replicas.  On the card the local part, the F x K/W replica steps,
is one captured graph with no collective inside; the exchange and the
average run eagerly between replays (a gloo collective cannot be
captured: ROADMAP A14d).  The ZeRO window runs eagerly across processes:
each process holds every parameter block, updates the parameter and
moment blocks of its own slots from every replica's gradient (gathered
across processes), and the updated blocks are gathered into every rank.
Each replica's window time is measured by the process that owns it and
gathered, so every rank's elastic controller takes the same verdicts.
The ``__introspect__`` and ``__numerics__`` stacks stay per replica: each
process computes its own slots' rows, and the harvest's ``[K, N]`` view
(``net._introspect_live``, ``net._numerics_live``) is every process's
rows gathered in slot order after each window, so two processes of two
slots equal one of four bit for bit; the facade's subtree is global slot
0's on every rank.  ``checkpoint_manager=`` and ``retry_policy=`` run
through ``FitResilience(mesh=)`` (``training_master.py``), a save being
each process's part of ``state_trees()``.
"""

from __future__ import annotations

import copy
import functools
import queue
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.backend import mesh as mesh_mod
from deeplearning4j_tpu_torch.backend import rng as rng_mod
from deeplearning4j_tpu_torch.backend.mesh import AXIS_DATA, P, Sharded
from deeplearning4j_tpu_torch.models import capture as cap
from deeplearning4j_tpu_torch.models import common
from deeplearning4j_tpu_torch.observability import (
    PhaseTimers, WorkerTelemetry, get_registry, introspection, numerics,
    shardstats,
)
from deeplearning4j_tpu_torch.observability.flightrecorder import step_guard
from deeplearning4j_tpu_torch.observability.recompile import instrument
from deeplearning4j_tpu_torch.optimize import updaters as upd
from deeplearning4j_tpu_torch.parallel import zero as zero_mod
from deeplearning4j_tpu_torch.parallel.elastic import (
    ElasticConfig, ElasticController, check_mask, gather_worker_rows,
)
from deeplearning4j_tpu_torch.resilience import stability

_SENTINEL = object()
_HELD = (introspection.STATE_KEY, numerics.STATE_KEY)


def loss_of(net, params, net_state, x, y, key, fm, lm, collect=None):
    """(loss, new layer state) of either facade at ``params`` in train
    mode; with a list as ``collect`` each layer's (name, activation) is
    appended to it."""
    from deeplearning4j_tpu_torch.models.graph import ComputationGraph

    if isinstance(net, ComputationGraph):
        return net._loss_fn(params, net_state, x, y, key, fm, lm,
                            train=True, collect=collect)
    return net._loss_fn(params, x, y, key, fm, lm, train=True,
                        net_state=net_state, collect=collect)


def _tmap(fn, *trees):
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _tmap(fn, *(t[k] for t in trees)) for k in t0}
    return fn(*trees)


def _stack(tree, k: int):
    return _tmap(lambda a: a.detach().unsqueeze(0).repeat(
        (k,) + (1,) * a.ndim).contiguous(), tree)


def _rk(vec, a):
    return vec.reshape((a.shape[0],) + (1,) * (a.ndim - 1)).to(a.dtype)


def _wmean(stack: torch.Tensor, w: torch.Tensor, wsum) -> torch.Tensor:
    """Weighted mean over the slot dim (kept as a dim of 1)."""
    return (mesh_mod.psum(stack * _rk(w, stack), keepdim=True)
            / wsum).to(stack.dtype)


def _slots_of(a, sl: slice):
    """A window leaf's slots ``sl`` (its dim 1: ``[F, K, ...]``), through
    dicts and lists; None stays None."""
    if a is None:
        return None
    if isinstance(a, dict):
        return {k: _slots_of(v, sl) for k, v in a.items()}
    if isinstance(a, (list, tuple)):
        return type(a)(_slots_of(v, sl) for v in a)
    return a[:, sl]


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _nest(path, leaf):
    """``leaf`` under ``path`` in nested dicts."""
    for k in reversed(path):
        leaf = {k: leaf}
    return leaf


def _fill_(dst, src) -> None:
    """``src``'s values into the same-structured ``dst`` in place."""
    for k, v in src.items():
        if isinstance(v, dict):
            _fill_(dst[k], v)
        else:
            dst[k].copy_(v)


def _same_shapes(a, b) -> bool:
    if isinstance(a, dict) or isinstance(b, dict):
        return (isinstance(a, dict) and isinstance(b, dict)
                and set(a) == set(b)
                and all(_same_shapes(a[k], b[k]) for k in a))
    return tuple(a.shape) == tuple(b.shape) and a.dtype == b.dtype


class _WindowAssembler:
    """Background window assembly (reference ``_WindowAssembler``): a
    producer thread groups minibatches into stacked ``[F, K, B, ...]``
    host arrays while the card runs the previous window; a producer
    error re-raises on the consumer side."""

    def __init__(self, iterator, K: int, F: int, stack_fn, prefetch: int = 2):
        self._queue: "queue.Queue" = queue.Queue(maxsize=max(1, prefetch))
        self._error: Optional[BaseException] = None
        self._stop = threading.Event()

        def put(item) -> bool:
            while not self._stop.is_set():
                try:
                    self._queue.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def run():
            try:
                window = []
                for ds in iterator:
                    window.append(ds)
                    if len(window) == K * F:
                        if not put(stack_fn(window, K * F)):
                            return
                        window = []
                if window and not self._stop.is_set():
                    # the tail's full frames first: a whole-tail weight
                    # would also drop those replicas' real minibatches
                    n_full = (len(window) // K) * K
                    if n_full and not put(stack_fn(window[:n_full], n_full)):
                        return
                    window = window[n_full:]
                if window and not self._stop.is_set():
                    # a partial frame: the tail minibatch repeated into
                    # the empty slots, which the weights leave out
                    n_real = len(window)
                    while len(window) % K:
                        window.append(window[-1])
                    put(stack_fn(window, n_real))
            except BaseException as e:
                self._error = e
            finally:
                put(_SENTINEL)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            if not self._thread.is_alive():
                self._thread = None

    def __iter__(self):
        try:
            while True:
                item = self._queue.get()
                if item is _SENTINEL:
                    if self._error is not None:
                        err, self._error = self._error, None
                        raise RuntimeError("window assembly failed") from err
                    return
                yield item
        finally:
            self.close()


class _Timer:
    """The local part of a window across processes, timed by CUDA events
    on the card (read after the window's losses), by the host clock
    elsewhere."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self._t = None

    def start(self):
        if self.cuda:
            self._t = [torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True)]
            self._t[0].record()
        else:
            self._t = [time.perf_counter(), None]

    def stop(self):
        if self.cuda:
            self._t[1].record()
        else:
            self._t[1] = time.perf_counter()

    def seconds(self) -> float:
        if self.cuda:
            self._t[1].synchronize()
            return self._t[0].elapsed_time(self._t[1]) / 1e3
        return self._t[1] - self._t[0]


class _Staged:
    """The wrapper's live trees on the mesh's device, as a captured
    program sees a net: ``models.capture.StepGraphs`` captures and
    replays the window through it."""

    def __init__(self, net, params, updater_state, net_state):
        self.conf = net.conf
        self.device = net.device
        self.params, self.updater_state = params, updater_state
        self.net_state = net_state
        self._graph_cache: Dict[Any, Any] = {}
        self._capture = getattr(net, "_capture", True)


class ParallelWrapper:
    """Data-parallel trainer over a slot mesh (reference builder
    surface)::

        pw = ParallelWrapper(net, workers=4, averaging_frequency=3)
        pw.fit(iterator)

    Without ``mesh`` the mesh is ``workers`` slots of the net's device
    (while a process group is up, slots over every process).
    """

    def __init__(self, net, workers: Optional[int] = None,
                 prefetch_size: int = 2, averaging_frequency: int = 1,
                 average_updaters: bool = True, mesh=None,
                 collect_worker_stats: bool = False,
                 checkpoint_manager=None, retry_policy=None, elastic=False,
                 update_sharding: str = zero_mod.REPLICATED):
        self.net = net
        self.checkpoint_manager = checkpoint_manager
        self.retry_policy = retry_policy
        if mesh is None:
            k = workers or mesh_mod.device_count()
            mesh = mesh_mod.default_mesh(data=k, devices=[net.device] * k)
        if mesh.device != net.device:
            raise ValueError(f"the mesh's slots are on {mesh.device}, the "
                             f"net on {net.device}")
        self.mesh = mesh
        self.workers = workers or mesh.shape[AXIS_DATA]
        if self.workers != mesh.shape[AXIS_DATA]:
            raise ValueError(
                f"workers={self.workers} must equal the mesh data-axis size "
                f"{mesh.shape[AXIS_DATA]}")
        # this process's replicas: the global slots [lo, lo + K_local)
        self._xp = mesh.spans_processes
        self._k_local = mesh.local_shape[AXIS_DATA]
        self._lo = mesh.local_slots.start
        self.prefetch_size = prefetch_size
        self.averaging_frequency = max(1, averaging_frequency)
        self.average_updaters = average_updaters
        self.iteration = 0
        self._phases = PhaseTimers("parallel_wrapper")
        self.collect_worker_stats = collect_worker_stats
        self._workers: Optional[WorkerTelemetry] = None
        self._elastic: Optional[ElasticController] = None
        self._ones_w: Optional[np.ndarray] = None
        self._stab_rt = None
        self._staged: Optional[_Staged] = None
        self._step_fn = None
        self._pool_bytes: Optional[int] = None
        self._local_timer: Optional[_Timer] = None
        self.update_sharding = zero_mod.validate_mode(update_sharding, mesh)
        self._zero_layout: Optional[zero_mod.ZeroLayout] = None
        if self.update_sharding == zero_mod.ZERO:
            if self.averaging_frequency != 1:
                raise ValueError(
                    "update_sharding='zero' requires averaging_frequency"
                    f"=1 (got {self.averaging_frequency}): local-SGD "
                    "windows need full per-replica updater state between "
                    "averages")
            if not self.average_updaters:
                raise ValueError(
                    "update_sharding='zero' requires average_updaters="
                    "True: un-averaged updater state is per-replica and "
                    "cannot be sharded")
            self._zero_layout = zero_mod.ZeroLayout(mesh, self.workers)
        if isinstance(elastic, ElasticController):
            if elastic.K != self.workers:
                raise ValueError(
                    f"elastic controller tracks {elastic.K} workers, "
                    f"wrapper has {self.workers}")
            self.collect_worker_stats = True
            self._elastic = elastic
        elif elastic is not False and elastic is not None:
            cfg = elastic if isinstance(elastic, ElasticConfig) \
                else ElasticConfig()
            self.collect_worker_stats = True
            self._elastic = ElasticController(
                "parallel_wrapper", [str(k) for k in range(self.workers)],
                config=cfg)

    @property
    def elastic(self) -> Optional[ElasticController]:
        return self._elastic

    # ---------------------------------------------------------- the window
    def _replica(self, staged: _Staged, k: int):
        """Replica ``k`` as a net: the facade's layers and configuration
        over views into slot k of the stacks."""
        view = copy.copy(self.net)
        view.params = _tmap(lambda a: a[k].detach(), staged.params)
        view.updater_state = _tmap(lambda a: a[k].detach(),
                                   staged.updater_state)
        view.net_state = _tmap(lambda a: a[k].detach(), staged.net_state)
        return view

    def _window_body(self, xs, ys, fms, lms, weights, key, scalars,
                     numerics_now=None):
        """F minibatches per replica, then the weighted average
        (reference ``fit_window``).  Returns the ``[F, K]`` losses and,
        under a stability policy, the ``[K]`` poison flags and the
        window's non-finite step count."""
        losses, fins = self._window_steps(xs, ys, fms, lms, key, scalars,
                                          numerics_now)
        return self._window_average(losses, fins, weights)

    def _window_steps(self, xs, ys, fms, lms, key, scalars,
                      numerics_now=None):
        """The F minibatches of this process's replicas (all K in one
        process): their ``[F, K_local]`` losses and, under a stability
        policy, their ``[F, K_local]`` finite flags (else None).  Replica
        k's key at minibatch f is the window key's child ``f*K + k``, k
        its global slot."""
        staged, K, lo = self._staged, self.workers, self._lo
        F = xs.shape[0]
        keys = rng_mod.split(key, F * K)
        views = [self._replica(staged, k) for k in range(self._k_local)]
        losses, fins = [], []
        for f in range(F):
            sc = {n: v for (ff, n), v in scalars.items() if ff == f}
            row_l, row_f = [], []
            for k, view in enumerate(views):
                stab = view.updater_state.get(stability.STATE_KEY)
                before = (None if stab is None
                          else stab["nonfinite_total"].clone())
                loss = view._train_body(
                    xs[f, k], ys[f, k], None if fms is None else fms[f, k],
                    None if lms is None else lms[f, k],
                    keys[f * K + lo + k], sc, numerics_now=numerics_now)
                row_l.append(loss.float())
                if before is not None:
                    row_f.append((stab["nonfinite_total"] == before).float())
            losses.append(torch.stack(row_l))
            if row_f:
                fins.append(torch.stack(row_f))
        return torch.stack(losses), (torch.stack(fins) if fins else None)

    def _window_average(self, losses, fins, weights):
        """The weighted average of params, layer state and (with
        ``average_updaters``) updater state over the K replicas, written
        into every slot; across processes over the global stacks,
        gathered in slot order (module docstring).  Returns what
        ``_window_body`` returns."""
        staged = self._staged
        policy = stability.policy_of(self.net.conf)
        with torch.no_grad():
            if self._xp:
                losses = mesh_mod.process_gather_slots(losses, dim=1)
                if fins is not None:
                    fins = mesh_mod.process_gather_slots(fins, dim=1)
            if policy is not None:
                win_finite = fins.min(dim=0).values
                w_eff = weights * win_finite
                weights = torch.where(w_eff.sum() > 0, w_eff, weights)
            leaves = (common.tree_leaves(staged.params)
                      + common.tree_leaves(staged.net_state))
            if self.average_updaters:
                for slot, tree in staged.updater_state.items():
                    if slot not in _HELD:
                        leaves += common.tree_leaves(tree)
            self._average_(leaves, weights, weights.sum())
            if policy is not None:
                return losses, 1.0 - win_finite, (1.0 - fins).sum()
            return losses

    def _zero_body(self, xs, ys, fms, lms, weights, key, scalars,
                   numerics_now=None):
        """The ZeRO window (reference ``_build_zero``, F = 1).  Across
        processes each process runs its own replicas, gathers every
        replica's gradient, updates the blocks of its own slots and
        gathers the updated parameter blocks into every rank."""
        staged, K, net = self._staged, self.workers, self.net
        xp, lo, kl = self._xp, self._lo, self._k_local
        own = slice(lo, lo + kl)
        cfg = net.conf.updater
        cfg_sh = zero_mod.no_norm(cfg)
        policy = stability.policy_of(net.conf)
        sc = {n: v for (_f, n), v in scalars.items()}
        keys = rng_mod.split(key, K)
        p_sh = staged.params
        full = zero_mod.all_gather_tree(p_sh, self._pmask)
        ns_k = staged.net_state
        inner_sh = upd.inner_state(staged.updater_state)
        stab_k = staged.updater_state.get(stability.STATE_KEY)
        plan = common.observed_plans(net)[0]
        acts = [] if plan is not None and plan.collect_acts else None
        gnorms, act_k = [], []
        # every replica's whole gradient, written into one [K, ...] stack
        # a leaf as its backward ends (one copy of the K gradients)
        stacked, losses, fins, new_ns = None, [], [], []
        for k in range(kl):
            params = _tmap(lambda a: a.detach(), full)
            train = common.trainable(params)
            leaves = common.tree_leaves(train)
            for p in leaves:
                p.requires_grad_(True)
            loss, ns = loss_of(
                net, params, _tmap(lambda a: a[k], ns_k), xs[0, k],
                ys[0, k], keys[lo + k], None if fms is None else fms[0, k],
                None if lms is None else lms[0, k], collect=acts)
            if acts:
                act_k.append(introspection.act_summary(
                    acts, dead_eps=plan.policy.dead_eps))
                acts.clear()
            scale = (None if policy is None
                     else stab_k["loss_scale"][k])
            target = loss if scale is None else loss * scale
            g = torch.autograd.grad(target, leaves, allow_unused=True)
            g = common._tree_like(train, [torch.zeros_like(p) if gi is None
                                          else gi for p, gi in
                                          zip(leaves, g)])
            with torch.no_grad():
                if scale is not None:
                    g, fin = stability.unscale(loss.detach(), g, scale)
                    fins.append(fin)
                if plan is not None:
                    # each replica's own unscaled gradient, before the
                    # normalisation (replicated mode's measure)
                    gnorms.append(zero_mod.tree_norms(plan, g))
                g = upd.normalize_tree(cfg, g)
                if stacked is None:
                    stacked = _tmap(lambda a: a.new_empty((kl,) + a.shape),
                                    g)
                _tmap(lambda dst, a: dst[k].copy_(a), stacked, g)
            del g
            losses.append(loss.detach().float())
            new_ns.append(ns)
        with torch.no_grad():
            fin_f = (torch.stack(fins).float() if fins
                     else torch.ones(kl, device=weights.device))
            losses = torch.stack(losses)
            stab_all = stab_k
            if xp:
                # every replica's gradient, finite flag, loss and guard
                # state, in global slot order
                paths = common.tree_paths(stacked)
                got = mesh_mod.process_gather_slots_many(
                    [a for _, a in paths] + [fin_f, losses])
                stacked = common._tree_like(stacked, got[:len(paths)])
                fin_f, losses = got[len(paths)], got[len(paths) + 1]
                if stab_k is not None:
                    stab_all = dict(zip(
                        stab_k, mesh_mod.process_gather_slots_many(
                            list(stab_k.values()))))
            g_all = zero_mod.all_to_all_tree(stacked, K)
            w = weights
            if policy is not None:
                w_eff = weights * fin_f
                w = torch.where(w_eff.sum() > 0, w_eff, weights)
            wsum = w.sum()
            old_p = (common.tree_clone(common.trainable(p_sh))
                     if plan is not None else None)
            # a leaf at a time: every replica's updated block and moments
            # stacked [K, ...] (the leaf's size K times, never the tree's)
            # and averaged as the replicated window averages its stacks,
            # so the two layouts give the same values; across processes
            # the blocks of this process's slots alone
            mask = common.trainable(self._pmask)
            gathered = []
            for path, p in common.tree_paths(common.trainable(p_sh)):
                blocked = _at(mask, path)
                mine = own if (xp and blocked) else slice(None)
                p = p[mine]
                # across processes the moments hold this process's blocks
                olds = {slot: _at(tree, path)
                        for slot, tree in inner_sh.items()}
                news_p, news_s = [], {slot: [] for slot in olds}
                for r in range(K):
                    g = _at(g_all, path)
                    g = g[mine, r] if blocked else g[r]
                    u, st = upd.update(
                        cfg_sh, _nest(path, g),
                        {slot: _nest(path, o) for slot, o in olds.items()},
                        net.iteration, params=_nest(path, p), scalars=sc)
                    u = _at(u, path)
                    st = {slot: _at(t, path) for slot, t in st.items()}
                    if policy is not None:
                        u, st = stability.fold_verdict(
                            policy, fin_f[r] > 0, stab_all["lr_scale"][r],
                            u, st, olds)
                    news_p.append(p - u.to(p.dtype))
                    for slot, t in st.items():
                        news_s[slot].append(t)
                p.copy_(_wmean(torch.stack(news_p), w, wsum)[0])
                for slot, ts in news_s.items():
                    olds[slot].copy_(_wmean(torch.stack(ts), w, wsum)[0])
                if xp and blocked:
                    gathered.append((_at(p_sh, path), p))
            if gathered:
                # the updated blocks of every process into every rank
                got = mesh_mod.process_gather_slots_many(
                    [b for _, b in gathered])
                for (whole, _), g in zip(gathered, got):
                    whole.copy_(g)
            if plan is not None:
                # the update is shared, so its and the params' norms are
                # one [L] broadcast to every replica's row
                acts_k = ({n: torch.stack([a[n] for a in act_k])
                           for n in act_k[0]} if act_k else None)
                staged.updater_state[introspection.STATE_KEY][
                    "packed"].copy_(zero_mod.pack_introspection(
                        plan, sc["iteration"], torch.stack(gnorms),
                        zero_mod.update_delta_norms(
                            plan, old_p, common.trainable(p_sh)),
                        zero_mod.tree_norms(plan, old_p), acts_k)["packed"])
            fin_own = fin_f[own] if xp else fin_f
            if new_ns and new_ns[0]:
                stacked = _tmap(lambda *a: torch.stack(a), *new_ns)
                if policy is not None and policy.skip_nonfinite:
                    stacked = _tmap(lambda n, o: torch.where(
                        _rk(fin_own, n) > 0, n, o), stacked, ns_k)
                common.copy_tree_(ns_k, stacked)
                self._average_(common.tree_leaves(ns_k), w, wsum)
            out = losses[None]
            if policy is not None:
                for r in range(kl):
                    one = {n: v[r] for n, v in stab_k.items()}
                    new = stability.next_state(policy, one, fin_own[r] > 0)
                    for n, v in new.items():
                        stab_k[n][r].copy_(v)
                self._average_(list(stab_k.values()), w, wsum)
                return out, 1.0 - fin_f, (1.0 - fin_f).sum()
            return out

    def _average_(self, stacks, w, wsum) -> None:
        """Each ``[K_local, ...]`` stack's weighted mean over the K
        replicas (gathered across processes first), written into every
        local slot."""
        got = (mesh_mod.process_gather_slots_many(stacks) if self._xp
               else stacks)
        for a, g in zip(stacks, got):
            a.copy_(_wmean(g, w, wsum).expand_as(a))

    # ---------------------------------------------------------- staging
    def _stage(self, net):
        """The facade's trees onto the mesh: stacked ``[K, ...]``
        replicas, or the ZeRO layout (params and inner updater slots in
        blocks, the reserved subtrees and layer state stacked).  A second
        fit of the same structure writes into the tensors of the first,
        so its captured window replays.  Across processes the stacks
        hold this process's K/W slots; under ZeRO every process holds
        every parameter block (the forward reads them all) and the
        moment blocks of its own slots."""
        K = self._k_local
        if self._zero_layout is not None:
            lay = self._zero_layout
            self._pmask = lay.mask(net.params)
            params = lay.place(net.params)
            upd_state = lay.place_updater(
                net.updater_state, reserved_place=lambda t: _stack(t, K))
            if self._xp:
                own = slice(self._lo, self._lo + K)
                reserved = shardstats.RESERVED_REPLICATED_SUBTREES
                upd_state = {
                    slot: (tree if slot in reserved else _tmap(
                        lambda t, m: t[own].clone() if m else t, tree,
                        self._pmask))
                    for slot, tree in upd_state.items()}
        else:
            params = _stack(net.params, K)
            upd_state = _stack(net.updater_state, K)
        ns = _stack(net.net_state, K)
        st = self._staged
        if (st is not None and _same_shapes(st.params, params)
                and _same_shapes(st.updater_state, upd_state)
                and _same_shapes(st.net_state, ns)):
            with torch.no_grad():
                _fill_(st.params, params)
                _fill_(st.updater_state, upd_state)
                _fill_(st.net_state, ns)
            st.conf = net.conf
        else:
            self._staged = _Staged(net, params, upd_state, ns)
            self._step_fn = None

    def _slot0(self, tree):
        """``tree``'s stacks as seen at global slot 0: the stacks
        themselves, or across processes with un-averaged updaters (per
        replica there) rank 0's first slot, gathered (each leaf
        ``[1, ...]``)."""
        if not self._xp or self.average_updaters or tree is None:
            return tree
        paths = common.tree_paths(tree)
        got = mesh_mod.process_all_gather_many([a[:1] for _, a in paths])
        return common._tree_like(tree, [g[0] for g in got])

    def _fold_back(self, net, it, last_losses) -> None:
        """The averaged state into the facade's own tensors (slot 0 of
        the stacks, or the ZeRO blocks put together).  Un-averaged
        updater state is global slot 0's on every rank: across processes
        it is gathered (``_slot0``), so every rank folds back at the same
        points; the per-replica statistics' rows come from the window's
        gathered views (``_held``), and stay as they are before a fit's
        first window."""
        st = self._staged

        def put(dst, src, whole):
            for k, v in src.items():
                if isinstance(v, dict):
                    put(dst.setdefault(k, {}), v, whole)
                    continue
                val = v.reshape(dst[k].shape) if whole(k) else v[0]
                if k in dst:
                    dst[k].copy_(val)
                else:
                    dst[k] = val.clone()

        # the per-replica subtrees are global slot 0's on every rank
        ustate = dict(st.updater_state)
        if self._xp:
            for k in _HELD:
                if k in ustate:
                    live = self._held.get(k)
                    if live is None:
                        del ustate[k]
                    else:
                        ustate[k] = _tmap(lambda a: a[:1], live)
        with torch.no_grad():
            if self._zero_layout is not None:
                put(net.params, st.params, lambda _k: True)
                for slot, tree in ustate.items():
                    if (self._xp and slot not in
                            shardstats.RESERVED_REPLICATED_SUBTREES):
                        self._put_own_blocks(net.updater_state[slot], tree)
                        continue
                    put(net.updater_state.setdefault(slot, {}), tree,
                        lambda _k, s=slot:
                        s not in shardstats.RESERVED_REPLICATED_SUBTREES)
            else:
                put(net.params, st.params, lambda _k: False)
                put(net.updater_state, self._slot0(ustate),
                    lambda _k: False)
            put(net.net_state, st.net_state, lambda _k: False)
        if last_losses is not None:
            net.score_value = last_losses[-1].mean().clone()
        net.iteration = it

    def _put_own_blocks(self, dst, src) -> None:
        """A ZeRO updater slot's blocks of this process's slots (``src``)
        into the facade's whole tensors (``dst``): the other processes'
        blocks stay as they were, as under the sync master; the sharded
        checkpoint saves each block from its owner."""
        lo, kl, k = self._lo, self._k_local, self.workers
        for (path, d), (_, v) in zip(common.tree_paths(dst),
                                     common.tree_paths(src)):
            if v.shape == d.shape:
                d.copy_(v)
            else:
                d.view((k, d.shape[0] // k) + tuple(d.shape[1:]))[
                    lo:lo + kl].copy_(v)

    def state_trees(self) -> Dict[str, Any]:
        """The live trees as ``Sharded`` leaves over the mesh, as the
        reference's facade holds them after a fit: replicated mode the
        averaged single-model trees (slot 0), ZeRO mode params and inner
        updater slots in their blocks — what ``save_checkpoint(...,
        trees=, mesh=)`` writes piece by piece (across processes each
        process the blocks of its own slots, process 0 the rest, its
        slot 0 being the global slot 0)."""
        st, mesh, net = self._staged, self.mesh, self.net
        rep = lambda a: Sharded(a[0], P(), mesh, a.shape[1:])  # noqa: E731
        if self._zero_layout is None:
            return {"params": _tmap(rep, st.params),
                    "updater_state": _tmap(rep, st.updater_state),
                    "net_state": _tmap(rep, st.net_state)}
        lay = self._zero_layout
        ustate = {}
        for slot, tree in st.updater_state.items():
            if slot in shardstats.RESERVED_REPLICATED_SUBTREES:
                ustate[slot] = _tmap(rep, tree)
            elif self._xp:
                # the facade's tensors, this process's blocks folded back
                whole = net.updater_state[slot]
                ustate[slot] = lay.as_sharded(lay.place(whole), whole)
            else:
                ustate[slot] = lay.as_sharded(tree, net.updater_state[slot])
        return {"params": lay.as_sharded(st.params, net.params),
                "updater_state": ustate,
                "net_state": _tmap(rep, st.net_state)}

    def _ledger_trees(self):
        st, mesh = self._staged, self.mesh
        stack = lambda a: mesh_mod.replica_stack(a, mesh)  # noqa: E731
        if self._zero_layout is None:
            return {"params": _tmap(stack, st.params),
                    "updater_state": _tmap(stack, st.updater_state),
                    "net_state": _tmap(stack, st.net_state)}
        lay, net = self._zero_layout, self.net
        ustate = {}
        for slot, tree in st.updater_state.items():
            ustate[slot] = (_tmap(stack, tree)
                            if slot in shardstats.RESERVED_REPLICATED_SUBTREES
                            else lay.as_sharded(tree,
                                                net.updater_state[slot]))
        return {"params": lay.as_sharded(st.params, net.params),
                "updater_state": ustate,
                "net_state": _tmap(stack, st.net_state)}

    # --------------------------------------------------------- dispatch
    def _scalars(self, it: int, F: int):
        """The F steps' updater scalars, named (f, name), and the
        numerics ledger's collect flag (a host choice: one program each
        way, as the facades' step)."""
        net = self.net
        names, vals, nows = [], [], set()
        iplan, nplan = common.observed_plans(net)
        for f in range(F):
            v = common._step_scalars(net, it + f)
            if iplan is not None or nplan is not None:
                v["iteration"] = float(it + f)
                nows.add(numerics.collect_now(nplan, it + f))
            for n, x in v.items():
                names.append((f, n))
                vals.append(x)
        if len(nows) > 1:
            raise ValueError("a numerics ledger with an interval needs "
                             "averaging_frequency=1 in the wrapper")
        return names, vals, (nows.pop() if nows else None)

    def _dispatch(self, xs, ys, fms, lms, weights, it: int):
        net, st = self.net, self._staged
        F = int(np.shape(xs)[0])
        names, vals, now = self._scalars(it, F)
        seed = rng_mod.seed_of(net._keys.next())
        dtype = common._scalar_dtype(net)
        if self._xp:
            return self._dispatch_across(xs, ys, fms, lms, weights, names,
                                         vals, seed, dtype, now)
        body = (self._zero_body if self._zero_layout is not None
                else self._window_body)
        variant = None
        if now is not None:
            body = functools.partial(body, numerics_now=now)
            variant = ("numerics", now)
        inputs = {"xs": xs, "ys": ys, "fms": fms, "lms": lms,
                  "weights": np.asarray(weights, np.float32)}
        if cap.captures(st):
            graphs = cap.step_graphs(st)
            inputs = common.tree_map(cap.host_or_device, inputs)
            prog = graphs.program("window", body, inputs, len(vals), dtype,
                                  variant=variant)
            prog.scalar_names = names
            graphs.stage(prog, inputs, seed, vals)
            if prog.graph is not None:
                return graphs.run(prog)
            with mesh_mod.census() as c:
                out = graphs.run(prog)
            self._pool_bytes = prog.pool_bytes
            self._record_program(prog.cache_key, c.counts, halve=True)
            return out
        dev = net.device
        sc = torch.tensor(vals, dtype=dtype, device=dev)
        with mesh_mod.census() as c:
            out = body(**common._on({k: v for k, v in inputs.items()
                                     if v is not None}, dev),
                       **{k: None for k, v in inputs.items() if v is None},
                       key=rng_mod.device_key(seed, dev),
                       scalars=dict(zip(names, sc.unbind(0))))
        key = cap.signature(common.tree_map(cap.host_or_device, inputs))
        if key not in self._census_seen:
            self._census_seen.add(key)
            self._record_program(key, c.counts)
        return out

    def _dispatch_across(self, xs, ys, fms, lms, weights, names, vals,
                         seed, dtype, now=None):
        """A window across processes (module docstring): this process's
        replica steps, captured on the card (the ZeRO window eagerly; the
        numerics ledger's collecting and skipping windows are two
        programs), timed for the worker telemetry, then the exchange and
        the average eagerly."""
        net, st = self.net, self._staged
        dev = net.device
        inputs = {"xs": xs, "ys": ys, "fms": fms, "lms": lms}
        w = torch.as_tensor(np.asarray(weights, np.float32), device=dev)
        timer = _Timer(dev)
        steps, zero_body, variant = self._window_steps, self._zero_body, None
        if now is not None:
            steps = functools.partial(steps, numerics_now=now)
            zero_body = functools.partial(zero_body, numerics_now=now)
            variant = ("numerics", now)
        with mesh_mod.census() as c:
            if self._zero_layout is None and cap.captures(st):
                graphs = cap.step_graphs(st)
                staged_in = common.tree_map(cap.host_or_device, inputs)
                prog = graphs.program("window_local", steps, staged_in,
                                      len(vals), dtype, variant=variant)
                prog.scalar_names = names
                graphs.stage(prog, staged_in, seed, vals)
                fresh = prog.graph is None
                timer.start()
                losses, fins = graphs.run(prog)
                timer.stop()
                if fresh:
                    self._pool_bytes = prog.pool_bytes
            else:
                sc = torch.tensor(vals, dtype=dtype, device=dev)
                args = dict(
                    common._on({k: v for k, v in inputs.items()
                                if v is not None}, dev),
                    **{k: None for k, v in inputs.items() if v is None},
                    key=rng_mod.device_key(seed, dev),
                    scalars=dict(zip(names, sc.unbind(0))))
                timer.start()
                if self._zero_layout is not None:
                    out = zero_body(weights=w, **args)
                else:
                    losses, fins = steps(**args)
                timer.stop()
            if self._zero_layout is None:
                out = self._window_average(losses, fins, w)
        self._local_timer = timer
        key = cap.signature(common.tree_map(cap.host_or_device, inputs))
        if key not in self._census_seen:
            self._census_seen.add(key)
            self._record_program(key, c.counts)
        return out

    def _record_program(self, sig, counts, halve=False) -> None:
        """Keep the census of one run of the window body: a first call on
        the card runs it twice (warm-up, capture)."""
        if halve:
            counts = {op: {"count": e["count"] // 2, "bytes": e["bytes"] / 2,
                           "group_sizes": e["group_sizes"]}
                      for op, e in counts.items()}
        shardstats.record_program(self._fn_name, sig, counts,
                                  pool_bytes=self._pool_bytes,
                                  device=self.net.device)

    @property
    def _fn_name(self) -> str:
        return ("ParallelWrapper.fit_window_zero"
                if self._zero_layout is not None
                else "ParallelWrapper.fit_window")

    def capture_pool_bytes(self) -> Optional[int]:
        """Device bytes the window's capture added to the net's graph
        pool (``Program.pool_bytes``: the capture's peak beyond what the
        pool held free), on the card; None elsewhere."""
        return self._pool_bytes

    # --------------------------------------------------------------- fit
    def fit(self, iterator):
        """Train over an iterator of DataSets (reference ``fit``): each
        window consumes ``workers * averaging_frequency`` minibatches."""
        from deeplearning4j_tpu_torch.datasets.iterator import (
            AsyncDataSetIterator, DataSetIterator, ListDataSetIterator,
        )
        from deeplearning4j_tpu_torch.resilience import (
            FitResilience, get_fault_injector, preemption_requested,
        )
        from deeplearning4j_tpu_torch.resilience.preemption import (
            preemption_watched,
        )

        net = self.net
        common.check_trainable(net)
        res = None
        if self.checkpoint_manager is not None or self.retry_policy \
                is not None:
            res = FitResilience("parallel_wrapper", self.checkpoint_manager,
                                self.retry_policy, net=net, mesh=self.mesh,
                                trees=self.state_trees)
        # without resilience, across processes, a preemption check is a
        # gather: made only when a rank holds a handler
        watch = res is None and preemption_watched(self.mesh)
        # a listener's fold-back may gather (``_slot0``): across processes
        # every rank folds back when any rank has a listener as the fit
        # begins
        fold_each = self._xp and mesh_mod.process_any(bool(net.listeners))
        self._held = {}
        K, F = self.workers, self.averaging_frequency
        policy = stability.policy_of(net.conf)
        if policy is not None:
            stability.ensure_state(net)
            if self._stab_rt is None:
                self._stab_rt = stability.StabilityRuntime(
                    "parallel_wrapper", policy,
                    worker_ids=[str(k) for k in range(K)])
        stab_rt = self._stab_rt
        introspect = getattr(net.conf, "introspection", None) is not None
        if introspect:
            introspection.ensure_state(net)
        numerics_on = getattr(net.conf, "numerics", None) is not None
        if numerics_on:
            numerics.ensure_state(net)
        self._stage(net)
        if self._step_fn is None:
            self._census_seen = set()
            self._step_fn = instrument(
                self._dispatch, self._fn_name, argnums=(0, 1, 2, 3),
                graphs=lambda: (cap.step_graphs(self._staged)
                                if cap.captures(self._staged) else None))
        shardstats.record_ledger(
            "parallel_wrapper", self._ledger_trees(),
            logical_trees={"params": net.params,
                           "updater_state": net.updater_state,
                           "net_state": net.net_state},
            data_axis_size=K,
            notes=(self._zero_layout.notes()
                   if self._zero_layout is not None else None))
        data = getattr(iterator, "_data", None)
        if (isinstance(iterator, ListDataSetIterator)
                and data.features_mask is None and data.labels_mask is None):
            windows = self._native_windows(iterator)
        else:
            if isinstance(iterator, DataSetIterator) and \
                    iterator.async_supported():
                iterator = AsyncDataSetIterator(iterator, self.prefetch_size)
            windows = _WindowAssembler(iterator, K, F, self._stack_window,
                                       prefetch=self.prefetch_size)
        get_registry().gauge(
            "dl4j_parallel_replicas",
            "Data-parallel replica count of the active ParallelWrapper",
        ).set(K)
        if self.collect_worker_stats and self._workers is None:
            self._workers = (self._elastic.cfg.make_worker_telemetry(
                "parallel_wrapper") if self._elastic is not None
                else WorkerTelemetry("parallel_wrapper"))
        if self._elastic is not None and self._workers is not None:
            self._elastic.attach_detector(self._workers.detector)
        it0 = it = net.iteration
        last_losses = None
        win_iter = iter(windows)
        while True:
            t_wait0 = time.perf_counter()
            with self._phases.phase("wait_window"):
                win = next(win_iter, None)
            wait_s = time.perf_counter() - t_wait0
            if win is None:
                if res is not None:
                    # the save due after the last window
                    _, trigger = res.boundary(it, last=True)
                    if trigger is not None:
                        self._fold_back(net, it, last_losses)
                        res.save(net, trigger)
                break
            xs, ys, fms, lms, n_batches, pad_w = win
            adv = n_batches // K
            if res is not None and res.skip_window(adv):
                continue
            if res is not None:
                # one agreement a window: the stop, the save due after
                # the previous window, this window's fault
                stop, trigger = res.boundary(it)
                if trigger is not None:
                    self._fold_back(net, it, last_losses)
                    res.save(net, trigger)
            else:
                stop = watch and preemption_requested(self.mesh)
            if stop:
                self._fold_back(net, it, last_losses)
                if res is not None:
                    res.on_preempt(net)
                if hasattr(windows, "close"):
                    windows.close()
                self.iteration = it - it0
                return net
            weights = self._window_weights(it, pad_w)
            inj = get_fault_injector()
            if inj is not None and inj.has_poison():
                ids = [str(k) for k in range(K)]
                ys = inj.poison_replica_labels(ids, it, xs, ys)
                xs = inj.poison_replica_slots(ids, it, xs)
            if self._xp:
                # every process read the global window: its own slots
                own = slice(self._lo, self._lo + self._k_local)
                xs, ys, fms, lms = (_slots_of(a, own)
                                    for a in (xs, ys, fms, lms))
            t_disp0 = time.perf_counter()
            with step_guard("parallel_window",
                            component="parallel_wrapper", iteration=it):
                with self._phases.phase("dispatch"):
                    def dispatch(xs=xs, ys=ys, fms=fms, lms=lms,
                                 weights=weights, it=it):
                        return self._step_fn(xs, ys, fms, lms, weights, it)

                    out = (res.step(dispatch, it, net=net) if res is not None
                           else dispatch())
                    if stab_rt is not None:
                        last_losses, poison_k, nf_ct = out
                        stab_rt.accumulate(nf_ct, poison_k)
                    else:
                        last_losses = out
                    last_losses = last_losses.clone()
                if self.collect_worker_stats:
                    self._publish_worker_stats(
                        last_losses, time.perf_counter() - t_disp0, wait_s,
                        xs)
            if self._elastic is not None:
                self._elastic.window_barrier(it)
            it += adv
            self._refresh_held(introspect, numerics_on)
            if stab_rt is not None:
                action = stab_rt.poll_master(
                    step=it, losses=last_losses, elastic=self._elastic,
                    stab_state=self._stab_state(),
                    can_rewind=res is not None and res.cm is not None)
                if action == "backoff":
                    stability.apply_lr_backoff_(self._staged.updater_state,
                                                policy)
                elif action == "rewind":
                    self._fold_back(net, it, last_losses)
                    if stab_rt.rewind(net, res.cm, mesh=self.mesh) \
                            is not None:
                        it = net.iteration
                        self._stage(net)
                        self._refresh_held(introspect, numerics_on)
            if fold_each or (net.listeners and not self._xp):
                self._fold_back(net, it, last_losses)
            if net.listeners:
                real = n_batches - (0 if pad_w is None
                                    else int((pad_w == 0.0).sum()))
                common.notify_listeners(
                    net, real * (int(np.shape(xs)[2])
                                 if np.ndim(xs) >= 3 else 1))
            self._phases.steps += 1
        self._fold_back(net, it, last_losses)
        if stab_rt is not None:
            stab_rt.flush(net, stab_state=self._stab_state())
        self.iteration = it - it0
        return net

    def _live(self, key):
        """A per-replica subtree's ``[K, N]`` stack, the harvest's view:
        the staged stack itself, or across processes every process's
        rows gathered in slot order (every rank the same)."""
        tree = self._staged.updater_state.get(key)
        if tree is None or not self._xp:
            return tree
        paths = common.tree_paths(tree)
        got = mesh_mod.process_gather_slots_many([a for _, a in paths],
                                                 op="statistics")
        return common._tree_like(tree, got)

    def _refresh_held(self, introspect: bool, numerics_on: bool) -> None:
        """The harvest's views after a window (or a rewind's restage),
        on every rank at the same point; across processes their global
        slot 0 rows are what ``_fold_back`` puts into the facade."""
        for on, key, attr in ((introspect, introspection.STATE_KEY,
                               "_introspect_live"),
                              (numerics_on, numerics.STATE_KEY,
                               "_numerics_live")):
            if on:
                live = self._live(key)
                setattr(self.net, attr, live)
                self._held[key] = live

    def _stab_state(self):
        """The guard's state the runtime reads: global slot 0's."""
        tree = self._staged.updater_state.get(stability.STATE_KEY)
        return self._slot0(tree)

    def _window_weights(self, it: int, pad_w):
        """The eviction mask times the tail's pad weights (reference
        ``_window_weights``); when every replica with real data is also
        evicted, the mask alone wins."""
        mask = None
        if self._elastic is not None:
            mask = self._elastic.begin_window(it)
            if self._xp:
                check_mask(mask, "ParallelWrapper")
            if mask.min() >= 1.0:
                mask = None
        if mask is None and pad_w is None:
            if self._ones_w is None or len(self._ones_w) != self.workers:
                self._ones_w = np.ones(self.workers, np.float32)
            return self._ones_w
        if mask is None:
            return pad_w
        if pad_w is None:
            return mask
        combined = mask * pad_w
        return combined if combined.sum() > 0 else mask

    def phase_stats(self):
        return self._phases.as_dict()

    # ------------------------------------------------ per-worker diagnosis
    def _worker_step_times(self, losses, dispatch_s: float
                           ) -> Dict[str, float]:
        """The window's wall time (dispatch plus a wait on its losses),
        attributed to every replica: on one card the replicas run in one
        graph, so their times are the cluster's (the reference's
        fallback when the losses are not sharded per device)."""
        t0 = time.perf_counter()
        if losses is not None and losses.is_cuda:
            torch.cuda.current_stream(losses.device).synchronize()
        total = dispatch_s + (time.perf_counter() - t0)
        return {str(k): total for k in range(self.workers)}

    def _publish_worker_stats(self, losses, dispatch_s: float,
                              wait_s: float, xs) -> None:
        """Each replica's window time (plus the injector's delay for it)
        into the worker telemetry.  Across processes a replica's time is
        its process's local part (``_Timer``), and the ``[K]`` times are
        gathered, so every rank observes the same."""
        from deeplearning4j_tpu_torch.resilience import get_fault_injector

        F = max(1, int(np.shape(xs)[0]))
        B = int(np.shape(xs)[2]) if np.ndim(xs) >= 3 else None
        inj = get_fault_injector()
        if self._xp:
            local = self._local_timer.seconds()
            ids = [str(self._lo + k) for k in range(self._k_local)]
            rows = gather_worker_rows(
                [(local + (inj.worker_delay(w) if inj is not None else 0.0),
                  wait_s) for w in ids])
            times = {str(k): t for k, (t, _) in enumerate(rows)}
            waits = {str(k): w for k, (_, w) in enumerate(rows)}
        else:
            times = self._worker_step_times(losses, dispatch_s)
            if inj is not None:
                times = {w: t + inj.worker_delay(w)
                         for w, t in times.items()}
            waits = {w: wait_s for w in times}
        for worker, t in times.items():
            self._workers.observe(
                worker, t / F, batch=B,
                phases={"wait_window": waits[worker] / F,
                        "dispatch": t / F})

    def cluster_stats(self) -> Dict[str, Any]:
        return self._workers.cluster_view() if self._workers else {}

    @property
    def straggler_detector(self):
        return self._workers.detector if self._workers else None

    # ------------------------------------------------------- host windows
    def _stack_window(self, window, n_real=None):
        """Pad and stack a window's minibatches to ``[F, K, B, ...]`` host
        arrays (on the assembler thread)."""
        K = self.workers
        F = len(window) // K
        max_b = max(len(w) for w in window)
        window = [w.pad_batch(max_b) if len(w) < max_b else w
                  for w in window]
        xs = np.stack([np.stack([np.asarray(w.features)
                                 for w in window[f * K:(f + 1) * K]])
                       for f in range(F)])
        ys = np.stack([np.stack([np.asarray(w.labels)
                                 for w in window[f * K:(f + 1) * K]])
                       for f in range(F)])
        fms = self._stack_masks([w.features_mask for w in window], K, F)
        lms = self._stack_masks([w.labels_mask for w in window], K, F)
        n_real = len(window) if n_real is None else n_real
        return xs, ys, fms, lms, len(window), \
            self._pad_weights(n_real, len(window))

    def _pad_weights(self, n_real: int, n_slots: int):
        """``[K]`` weights with 0 for the replicas whose last minibatch
        slot is padding, or None when the window is full."""
        if n_real >= n_slots:
            return None
        w = np.ones(self.workers, np.float32)
        for i in range(n_real, n_slots):
            w[i % self.workers] = 0.0
        return w

    def _native_windows(self, iterator):
        """Whole windows as single native gathers (reference
        ``_native_windows``): ``native.Batcher`` assembles a contiguous
        ``[F*K*B]`` slab per window; the ragged tail is a truncated
        window with a labels mask on its zero padding, its full frames
        first."""
        from deeplearning4j_tpu_torch import native

        K, F = self.workers, self.averaging_frequency
        B = iterator.batch()
        data = iterator._data
        n = len(data)
        if getattr(iterator, "_drop_last", False):
            n = (n // B) * B
            if n == 0:
                return
            data = data.subset(slice(0, n))
        fdtype = np.asarray(data.features).dtype
        slab = B * K * F
        batcher = native.Batcher(np.asarray(data.features),
                                 np.asarray(data.labels), slab,
                                 shuffle=False, seed=1, drop_last=False,
                                 queue_cap=max(1, self.prefetch_size))
        try:
            while True:
                out = batcher.next()
                if out is None:
                    return
                feat, lab, n_valid = out
                if feat.dtype != fdtype:
                    feat = feat.astype(fdtype)   # token ids: exact
                if n_valid == slab:
                    yield (feat.reshape((F, K, B) + feat.shape[1:]),
                           lab.reshape((F, K, B) + lab.shape[1:]),
                           None, None, F * K, None)
                    continue
                nb = -(-n_valid // B)
                f_full = nb // K
                mshape = ((nb * B,) if lab.ndim == 2
                          else (nb * B, lab.shape[1]))
                m = np.zeros(mshape, np.float32)
                m[:n_valid] = 1.0

                def part(lo_b, n_b, n_real_b):
                    rows = slice(lo_b * B, (lo_b + n_b) * B)
                    xs = feat[rows].reshape((n_b // K, K, B)
                                            + feat.shape[1:])
                    ys = lab[rows].reshape((n_b // K, K, B) + lab.shape[1:])
                    mp = np.zeros((n_b * B,) + m.shape[1:], np.float32)
                    avail = min(len(m) - lo_b * B, n_b * B)
                    if avail > 0:
                        mp[:avail] = m[lo_b * B:lo_b * B + avail]
                    lms = (None if mp.all() else
                           mp.reshape((n_b // K, K, B) + mp.shape[1:]))
                    return (xs, ys, None, lms, n_b,
                            self._pad_weights(n_real_b - lo_b, n_b))

                if f_full:
                    yield part(0, f_full * K, nb)
                if nb % K:
                    yield part(f_full * K, K, nb)
        finally:
            batcher.close()

    @staticmethod
    def _stack_masks(masks, K, F):
        if all(m is None for m in masks):
            return None
        shaped = [np.asarray(m) for m in masks if m is not None]
        template = np.ones_like(shaped[0])
        masks = [np.asarray(m) if m is not None else template for m in masks]
        return np.stack([np.stack(masks[f * K:(f + 1) * K])
                         for f in range(F)])
