"""The facades' compiled programs as captured CUDA graphs — the port's
counterpart of the reference's jitted train step (``_make_train_step``,
``sequential.py:316-319``; ``graph.py:598-603``) and its jitted
``output``.

A program is one fixed-shape call of a facade's device body: the train
step (forward, ``torch.autograd.grad``, the updater, the in-place
parameter update and the layer-state copy) or the inference forward.
Its inputs are static device tensors (features, labels, masks, a TBPTT
window's carries, the step's device key and its updater scalars); the
train body writes a window's new carries back into its static carries,
so the next window of the same length replays on them as they are, and
a window of another length (TBPTT's shorter last one, a program of its
own) has them copied in on the device; the host rewrites the rest
before each call, from pinned buffers (``PinnedRing``: ``fit`` does not
sync between steps) or by device-to-device copies.  The first call of a
new shape runs the body eagerly on a side stream — the genuine step —
and then captures it; later calls replay the graph.  ``fit_scanned``
replays the same step graph once a batch: capture already removes the
dispatch cost that the reference's ``lax.scan`` amortises.

Programs live in the net's one graph cache (``net._graph_cache``,
shared with ``generate``'s loops), an LRU that keeps
``GRAPH_CACHE_SIZE`` entries of each kind (train, output, decode), so
that inference at many shapes never evicts the train step.  A program
is keyed by what the reference's jit would retrace on (input shapes and
types, which masks are present, train or inference) and by whether the
kernels are on; the net's live graphs share one memory pool.  Before a
replay the program checks that the net's params, updater state and
layer state are still the tensors it captured, and the net's
configuration the same object; if not, it is captured again.
``captures`` and ``replays`` count them (the reference's recompile
detector), and each program's ``launches`` holds the kernel launches
its graph makes a replay (the wrappers' counts tick at capture, not on
replay).

A capture or a replay that fails raises; nothing falls back to eager.
A failed capture leaves the warm-up recorded as the step it was, and
its program out of the cache.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch import helpers
from deeplearning4j_tpu_torch.backend.device import (
    PinnedRing, capture_graph, warm_on_side_stream,
)
from deeplearning4j_tpu_torch.models import common

# captured programs of one kind kept on a net; the least recently used
# of that kind goes first
GRAPH_CACHE_SIZE = 8


def cached(net, key: tuple, make: Callable, fresh=None):
    """``net._graph_cache[key]``, made by ``make()`` when it is absent or
    ``fresh(entry)`` is false, and moved last (most recently used).  A
    new entry first evicts the least recently used of its kind
    (``key[0]``) when the kind already holds ``GRAPH_CACHE_SIZE``."""
    cache = net._graph_cache
    entry = cache.pop(key, None)
    if entry is not None and fresh is not None and not fresh(entry):
        entry = None
    if entry is None:
        same = [k for k in cache if k[0] == key[0]]
        for k in same[:max(0, len(same) - GRAPH_CACHE_SIZE + 1)]:
            del cache[k]
        entry = make()
    cache[key] = entry
    return entry


def host_or_device(a) -> torch.Tensor:
    """``a`` as a tensor where it lies (numpy arrays on the host), its
    type kept."""
    if torch.is_tensor(a):
        return a
    return torch.as_tensor(np.ascontiguousarray(a))


def signature(inputs: Dict[str, Any]) -> tuple:
    """What a captured program is specialised to: each input leaf's
    path, shape and type (a missing mask is absent)."""
    return tuple((path, tuple(t.shape), t.dtype)
                 for path, t in common.tree_paths(inputs))


def state_leaves(net) -> List[torch.Tensor]:
    """The tensors a captured program reads and writes in place: the
    leaves of params, updater state and layer state."""
    return (common.tree_leaves(net.params)
            + common.tree_leaves(net.updater_state)
            + common.tree_leaves(net.net_state))


def kernel_launches() -> Dict[str, int]:
    """Every kernel wrapper's launch count, by name."""
    return {n: c.launches for n, c in helpers.kernel_counts().items()}


class Program:
    """One fixed-shape call of a facade's device body: its static
    inputs, and once captured its graph, the static output the graph
    rewrites, the state tensors it was captured against and the kernel
    launches it holds."""

    def __init__(self, cache_key: tuple, body: Callable,
                 inputs: Dict[str, Any], device, n_scalars: int = 0,
                 scalar_dtype=torch.float32):
        self.cache_key = cache_key
        self.body = body
        self.statics = common.tree_map(
            lambda t: torch.empty(tuple(t.shape), dtype=t.dtype,
                                  device=device), inputs)
        self.key = torch.zeros((), dtype=torch.int64, device=device)
        self.scalars = torch.zeros((n_scalars,), dtype=scalar_dtype,
                                   device=device)
        self.scalar_names: Optional[list] = None
        self.graph = None
        self.out = None
        self.leaves: Optional[List[torch.Tensor]] = None
        self.conf = None
        self.launches: Dict[str, int] = {}

    def call(self):
        """The body on the static inputs."""
        views = (dict(zip(self.scalar_names, self.scalars.unbind(0)))
                 if self.scalar_names is not None else None)
        return self.body(**self.statics, key=self.key, scalars=views)

    def current(self, net) -> bool:
        """The net still holds the tensors and configuration this graph
        was captured against."""
        now = state_leaves(net)
        return (net.conf is self.conf and len(now) == len(self.leaves)
                and all(a is b for a, b in zip(now, self.leaves)))


class StepGraphs:
    """A net's captured programs (``net._step_graphs``): the staging ring
    and the capture and replay counts; the programs themselves are the
    ``Program`` entries of ``net._graph_cache``."""

    def __init__(self, net):
        self.net = net
        self.ring = PinnedRing()
        self.captures = 0
        self.replays = 0
        self._slot = None

    @property
    def programs(self) -> Dict[tuple, Program]:
        """The net's programs by cache key, least recently used first."""
        return {k: p for k, p in self.net._graph_cache.items()
                if isinstance(p, Program)}

    def program(self, kind: str, body: Callable, inputs: Dict[str, Any],
                n_scalars: int = 0, scalar_dtype=torch.float32) -> Program:
        """The cached program for ``kind`` at ``inputs``' signature (made,
        not yet captured, when there is none or the cached one is
        stale)."""
        net = self.net
        key = (kind, signature(inputs), helpers.enabled())
        return cached(
            net, key, lambda: Program(key, body, inputs, net.device,
                                      n_scalars, scalar_dtype),
            fresh=lambda p: p.graph is None or p.current(net))

    def run(self, prog: Program, done: Optional[Callable] = None):
        """One call of ``prog`` on its staged inputs: the first runs the
        body eagerly on the side stream and captures it, later ones
        replay the graph.  ``done(out)`` receives the call's output (for
        a replay, the graph's static output, which the next replay
        rewrites) as soon as the call is queued: for a first call before
        the capture, so that a capture that fails still records the
        step that ran.  A failed first call drops ``prog`` from the
        cache and raises.  Returns the output."""
        self._release()
        net = self.net
        if prog.graph is not None:
            prog.graph.replay()
            self.replays += 1
            out = prog.out
        else:
            try:
                out = warm_on_side_stream(prog.call, net.device)
                if done is not None:
                    done(out)
                    done = None
                before = kernel_launches()
                prog.graph, prog.out = capture_graph(prog.call, self._pool())
            except BaseException:
                net._graph_cache.pop(prog.cache_key, None)
                raise
            after = kernel_launches()
            prog.launches = {n: after[n] - before[n] for n in after
                             if after[n] != before[n]}
            prog.leaves = state_leaves(net)
            prog.conf = net.conf
            self.captures += 1
        if done is not None:
            done(out)
        return out

    def _pool(self):
        """The memory pool of the net's live graphs; a new one when none
        is left (a pool whose graphs were all dropped cannot be captured
        into again)."""
        for p in self.programs.values():
            if p.graph is not None:
                return p.graph.pool()
        return torch.cuda.graph_pool_handle()

    # ------------------------------------------------------------- staging
    def _release(self) -> None:
        """An event behind the copies queued from the current slot."""
        if self._slot is not None:
            self.ring.release(self._slot)
            self._slot = None

    def put(self, dst: torch.Tensor, src, name) -> None:
        """``src`` into the static ``dst``: nothing when ``src`` is ``dst``
        (a TBPTT window's carries, which the program's last replay left in
        its statics), a device-to-device copy from the card, else through
        the current slot's pinned buffer ``name``."""
        src = host_or_device(src)
        if src is dst:
            return
        if src.device.type == "cuda":
            dst.copy_(src)
            return
        if self._slot is None:
            self._slot = self.ring.acquire()
        buf = self.ring.buffer(self._slot, name, src.shape, src.dtype)
        buf.copy_(src)
        dst.copy_(buf, non_blocking=True)

    def stage(self, prog: Program, inputs: Dict[str, Any], key=None,
              scalars=None) -> None:
        """Inputs (structured as the program's), the step's key seed and
        scalar values into the program's static tensors."""
        for (path, src), (_, dst) in zip(common.tree_paths(inputs),
                                         common.tree_paths(prog.statics)):
            self.put(dst, src, path)
        if key is not None:
            self.put(prog.key, torch.tensor(int(key), dtype=torch.int64),
                     "key")
        if scalars is not None:
            self.put(prog.scalars,
                     torch.tensor(scalars, dtype=prog.scalars.dtype),
                     "scalars")

    def graph_launches(self) -> Dict[tuple, Dict[str, int]]:
        """Kernel launches each captured graph holds, by program key."""
        return {k: p.launches for k, p in self.programs.items()
                if p.graph is not None}


def step_graphs(net) -> StepGraphs:
    graphs = getattr(net, "_step_graphs", None)
    if graphs is None:
        graphs = net._step_graphs = StepGraphs(net)
    return graphs


def captures(net) -> bool:
    """Whether ``net``'s calls go through captured graphs: on the card,
    unless the internal switch ``net._capture`` is off."""
    return net.device is not None and net.device.type == "cuda" \
        and getattr(net, "_capture", True)
