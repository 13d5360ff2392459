"""Pipeline parallelism: GPipe microbatching over a ``pipe`` axis of
slots — the port's counterpart of
``deeplearning4j_tpu/parallel/pipeline.py``.

The stages are slots (``devices=`` names each one's device; slots may
repeat a device, ``["cuda"] * 4`` on the card, and a mesh across several
devices raises, ROADMAP A10).  Three paths, the reference's:

- **Compiled periodic**: a net with a periodic run of same-structure
  layers splits as prefix | S stages of ``blocks/S x period`` layers |
  suffix.  Block params are stacked ``[S, ...]`` over the pipe slots (a
  copy, written back after the fit and before a checkpoint save).  The
  M + S - 1 ticks of the GPipe schedule run in one step: at tick t each
  stage holding a microbatch (``0 <= t - s < M``) runs its blocks, the
  last stage scores its microbatch, and ``mesh.ppermute`` moves the
  stages' ``[S, ...]`` outputs one slot on.  The cells of the fill and
  drain that hold no microbatch are skipped (the slots share one card,
  so they would only compute zeros); ``bubble_fraction()`` stays the
  analytic ``(S-1)/(M+S-1)``, while ``measure_bubble_fraction`` on one
  card reads the fixed cost of a step beside the per-tick one.  Autograd
  differentiates through the whole schedule.  ``remat=True``
  recomputes each tick in the backward (``torch.utils.checkpoint``,
  non-reentrant, no RNG state: the pipeline refuses dropout).  One
  captured graph on the card.
- **Compiled heterogeneous**: any other net with a ``score()`` tail,
  split by ``split_stages``.  Stage s's activations travel to stage s+1
  as a flat buffer padded to the largest boundary, ``[S, buf]`` over the
  slots.  With an elementwise updater (no per-layer learning rates, no
  gradient normalisation) each stage's params are one float32 row of a
  ``[S, Pmax]`` stack, its tree views into the row, and the updater's
  state rides the rows as one pseudo-layer (``_pipe``); a leaf of another
  type keeps the layout replicated and says so (the reference casts every
  leaf to float32 without a word).  Otherwise the params stay the net's
  own, replicated, with a note on stderr.  One captured graph.
- **Orchestrated**: eager per-stage forwards and autograd, the stages'
  params the net's own tensors.  ``schedule="gpipe"`` holds M
  microbatches' graphs, ``schedule="1f1b"`` at most S.

Scope, as the reference: sequential stateless nets (no BatchNorm state,
no masks, no TBPTT, no dropout).  Under a compute dtype the stages run in
it and the loss in float32, as ``MultiLayerNetwork``'s forward does.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from deeplearning4j_tpu_torch.backend import mesh as mesh_mod
from deeplearning4j_tpu_torch.backend import rng as rng_mod
from deeplearning4j_tpu_torch.backend.device import (
    compute_dtype, resolve_device,
)
from deeplearning4j_tpu_torch.backend.mesh import P, Sharded
from deeplearning4j_tpu_torch.models import capture as cap
from deeplearning4j_tpu_torch.models import common
from deeplearning4j_tpu_torch.nn import losses
from deeplearning4j_tpu_torch.nn.layers.dense import OutputLayer
from deeplearning4j_tpu_torch.observability import (
    PhaseTimers, WorkerTelemetry, get_flight_recorder, shardstats,
)
from deeplearning4j_tpu_torch.observability.flightrecorder import step_guard
from deeplearning4j_tpu_torch.optimize import updaters as upd
from deeplearning4j_tpu_torch.parallel.data_parallel import _Staged, _tmap
from deeplearning4j_tpu_torch.parallel.training_master import TrainingMaster

AXIS_PIPE = "pipe"


def split_stages(net, n_stages: int) -> List[List[int]]:
    """Layer indices in ``n_stages`` contiguous groups minimising the
    largest stage's parameter count (the linear-partition DP of the
    reference, ``pipeline.py:77``)."""
    counts = []
    for layer in net.layers:
        lp = net.params.get(layer.name, {})
        counts.append(sum(int(a.numel()) for a in common.tree_leaves(lp))
                      or 1)
    n = len(counts)
    n_stages = max(1, min(n_stages, n))
    prefix = np.concatenate([[0], np.cumsum(counts)])

    def seg(i, j):
        return prefix[j] - prefix[i]

    inf = float(prefix[-1]) + 1.0
    best = [[inf] * (n + 1) for _ in range(n_stages + 1)]
    cut = [[0] * (n + 1) for _ in range(n_stages + 1)]
    best[0][0] = 0.0
    for k in range(1, n_stages + 1):
        for j in range(k, n + 1):
            for i in range(k - 1, j):
                cost = max(best[k - 1][i], float(seg(i, j)))
                if cost < best[k][j]:
                    best[k][j] = cost
                    cut[k][j] = i
    bounds = [n]
    for k in range(n_stages, 0, -1):
        bounds.append(cut[k][bounds[-1]])
    bounds.reverse()
    return [list(range(bounds[k], bounds[k + 1])) for k in range(n_stages)]


def _layer_sig(layer) -> str:
    """A layer's configuration without its name: equal signatures are
    interchangeable stage material."""
    d = layer.to_dict()
    d.pop("name", None)
    return json.dumps(d, sort_keys=True)


def find_periodic_run(sigs: List[str], n_stages: int
                      ) -> Optional[Tuple[int, int, int]]:
    """The longest run ``layers[start : start + period * blocks]`` whose
    signatures repeat with ``period``, ``blocks`` a positive multiple of
    ``n_stages``: (start, period, blocks), or None."""
    n = len(sigs)
    best = None
    for period in range(1, n // 2 + 1):
        for start in range(0, n - 2 * period + 1):
            blocks = 1
            while (start + (blocks + 1) * period <= n and
                   sigs[start + blocks * period:
                        start + (blocks + 1) * period]
                   == sigs[start:start + period]):
                blocks += 1
            blocks -= blocks % n_stages
            if blocks >= n_stages and blocks >= 2:
                size = blocks * period
                if best is None or size > best[1] * best[2]:
                    best = (start, period, blocks)
    return best


def measure_bubble_fraction(make_net, make_batch, n_stages: int,
                            mb_size: int, m_small: int = 2,
                            m_large: int = 8, iters: int = 5,
                            devices: Optional[Sequence] = None,
                            mode: str = "auto") -> Dict[str, float]:
    """The pipeline bubble measured (``bubble_fraction`` is the analytic
    one): steady-state step times at two microbatch counts of one size,
    ``t(M) = (M + S - 1) tick + c``; the slope is the tick, and
    ``(t - M tick) / t`` the share of the step doing no microbatch's
    work.  ``make_net() -> net``, ``make_batch(n) -> DataSet``."""

    def run(m):
        net = make_net()
        master = PipelineParallelTrainingMaster(
            n_stages=n_stages, n_microbatches=m, devices=devices, mode=mode)
        ds = make_batch(m * mb_size)
        master.execute_training(net, [ds])        # build and capture
        float(net.score_value)
        t0 = time.perf_counter()
        master.execute_training(net, [ds] * iters)
        float(net.score_value)
        return (time.perf_counter() - t0) / iters, master

    t_small, _ = run(m_small)
    t_large, master = run(m_large)
    tick = (t_large - t_small) / (m_large - m_small)
    measured = (t_large - m_large * tick) / t_large if t_large > 0 else 0.0
    return {
        "n_stages": n_stages, "mode": master._mode,
        "m_small": m_small, "m_large": m_large,
        "t_small_ms": t_small * 1e3, "t_large_ms": t_large * 1e3,
        "tick_ms": tick * 1e3, "bubble_measured": measured,
        "bubble_analytic": master.bubble_fraction(),
    }


def _tensor(a) -> torch.Tensor:
    """A batch's array as a tensor (a tensor on the card stays there)."""
    return a if torch.is_tensor(a) else torch.as_tensor(np.asarray(a))


def _cast(tree, dt):
    return common.cast_tree(tree, dt) if dt is not None else tree


class PipelineParallelTrainingMaster(TrainingMaster):
    """GPipe over ``n_stages`` pipe slots (module docstring)."""

    def __init__(self, n_stages: Optional[int] = None,
                 n_microbatches: int = 4,
                 devices: Optional[Sequence] = None,
                 schedule: str = "gpipe",
                 mode: str = "auto",
                 remat: bool = False,
                 checkpoint_manager=None,
                 retry_policy=None):
        mesh_mod.across_processes("PipelineParallelTrainingMaster",
                                  mesh_mod.A14B)
        if schedule not in ("gpipe", "1f1b"):
            raise ValueError(f"schedule={schedule!r}: use 'gpipe' or '1f1b'")
        if mode not in ("auto", "compiled", "orchestrated"):
            raise ValueError(
                f"mode={mode!r}: use 'auto', 'compiled' or 'orchestrated'")
        if remat and mode == "orchestrated":
            raise ValueError(
                "remat applies only to the compiled schedules (it "
                "checkpoints the compiled tick); the orchestrated path "
                "holds per-microbatch graphs instead — use schedule='1f1b' "
                "there for the activation-memory win")
        if devices is None:
            devices = [resolve_device(None)] * (n_stages
                                                or mesh_mod.device_count())
        self.devices = [torch.device(d) for d in devices]
        self.n_stages = n_stages or len(self.devices)
        if self.n_stages > len(self.devices):
            raise ValueError(
                f"{self.n_stages} stages > {len(self.devices)} devices")
        self.n_microbatches = n_microbatches
        self.schedule = schedule
        self.mode = mode
        self.remat = remat
        self._built = False
        self._mode = None
        self._compiled_kind = None
        self._hetero_sharded = False
        self._flat_pmax = None
        self._phases = PhaseTimers("pipeline_master")
        self._workers: Optional[WorkerTelemetry] = None
        self.checkpoint_manager = checkpoint_manager
        self.retry_policy = retry_policy

    def _warn_fast_path_downgrade(self, reasons) -> None:
        """One warning and one flight event a master when the
        configuration knocks the net off the sharded fast path: every
        stage then holds the whole model."""
        if getattr(self, "_downgrade_warned", False):
            return
        self._downgrade_warned = True
        import warnings

        why = "; ".join(reasons)
        warnings.warn(
            f"pipeline master: sharded param fast path DISABLED by {why} — "
            "params are replicated on every stage slot (full-model memory "
            "per slot).  Use mode='orchestrated' for partitioned "
            "placement, or drop the non-elementwise updater options.",
            RuntimeWarning, stacklevel=3)
        get_flight_recorder().record(
            "pipeline_fast_path_downgrade", component="pipeline_master",
            reasons=reasons, n_stages=self.n_stages, mode=self.mode)

    def training_stats(self) -> Dict[str, Any]:
        """The phase timers (``dispatch`` on the compiled paths,
        ``stage{s}_fwd``/``stage{s}_bwd`` on the orchestrated one) and,
        orchestrated, the stages' cluster view."""
        out = self._phases.as_dict()
        if self._workers is not None:
            out["cluster"] = self._workers.cluster_view()
        return out

    def bubble_fraction(self) -> float:
        """Of the M + S - 1 ticks, S - 1 fill and drain: the same for
        GPipe and non-interleaved 1F1B."""
        s = self.n_stages
        return (s - 1) / (self.n_microbatches + s - 1)

    # ------------------------------------------------------------ validation
    def _validate(self, net):
        if net.conf.backprop_type == "truncated_bptt":
            raise ValueError("pipeline master does not support TBPTT")
        if not hasattr(net.layers[-1], "score"):
            raise ValueError(
                f"pipeline master needs the net to end in an output layer "
                f"with a score() (OutputLayer/RnnOutputLayer); got "
                f"'{net.layers[-1].name}' ({type(net.layers[-1]).__name__})")
        for layer in net.layers:
            if layer.init_state():
                raise ValueError(
                    f"pipeline master needs stateless layers; '{layer.name}' "
                    f"({type(layer).__name__}) carries state")
            if layer.dropout > 0:
                raise ValueError("pipeline master does not support dropout")

    def _mesh(self, s: int):
        return mesh_mod.Mesh(np.asarray(self.devices[:s], dtype=object),
                             (AXIS_PIPE,))

    def _build(self, net):
        self._validate(net)
        self._mode = "orchestrated"
        cfg = net.conf.updater
        lr_overrides = common.lr_overrides(net)
        if self.mode == "compiled" and self.n_stages < 2:
            raise ValueError("mode='compiled' needs n_stages >= 2 "
                             f"(got {self.n_stages})")
        self._cd = (compute_dtype(net.conf.compute_dtype)
                    if net.conf.compute_dtype is not None else None)
        if self.mode != "orchestrated" and self.n_stages > 1:
            norm = cfg.gradient_normalization not in (None, "none")
            elementwise = not lr_overrides and not norm
            if not elementwise:
                self._warn_fast_path_downgrade(
                    ([f"gradient_normalization="
                      f"{cfg.gradient_normalization!r}"] if norm else [])
                    + (["per-layer learning-rate overrides: "
                        + ", ".join(sorted(lr_overrides))]
                       if lr_overrides else []))
            if elementwise:
                run = find_periodic_run([_layer_sig(l) for l in net.layers],
                                        self.n_stages)
                if run is not None and \
                        run[0] + run[1] * run[2] < len(net.layers):
                    self._build_compiled(net, run)
                    self._built = True
                    return
            shard = elementwise
            odd = sorted({str(a.dtype) for a in
                          common.tree_leaves(net.params)
                          if a.dtype != torch.float32})
            if shard and odd:
                # the flat rows are float32: another type would be cast
                # into them, so the layout stays replicated, and says so
                shard = False
                self._warn_fast_path_downgrade(
                    [f"non-float32 params ({', '.join(odd)})"])
            if not shard and self.mode == "auto":
                print("pipeline note: auto mode compiled this non-periodic "
                      "net with REPLICATED params (per-layer lr overrides, "
                      "gradient normalization or non-float32 params "
                      "prevent the sharded flat layout); every slot holds "
                      "the full model — use mode='orchestrated' for "
                      "partitioned placement", file=sys.stderr)
            self._build_compiled_hetero(net, shard_params=shard)
            self._built = True
            return
        if self.remat:
            print("pipeline note: remat=True has no effect on the "
                  "orchestrated path (single-stage resolution); it applies "
                  "to the compiled schedules only", file=sys.stderr)
        self._mesh(self.n_stages)
        self.stages = split_stages(net, self.n_stages)
        self.stage_layers = [[net.layers[i] for i in s] for s in self.stages]
        self._lr_overrides = lr_overrides
        self._upd_cfg = cfg
        self._built = True

    # ------------------------------------------------------------ the layers
    def _run(self, net, idxs, tree, a):
        """Layers ``idxs`` of ``net`` on ``a`` (each after its input
        preprocessor), their params from ``tree`` by layer name."""
        pre = net.conf.preprocessors
        for gi in idxs:
            layer = net.layers[gi]
            if gi in pre:
                a = pre[gi](a)
            a = layer.apply(tree.get(layer.name, {}), a, train=True,
                            rng=None)
        return a

    def _head(self, net, gi, p, a, y):
        """The output layer ``gi``'s loss on ``a`` (after its
        preprocessor), in float32 under a compute dtype."""
        pre = net.conf.preprocessors
        if gi in pre:
            a = pre[gi](a)
        layer = net.layers[gi]
        out = layer.pre_output(p, a)
        if self._cd is not None:
            out = out.float()
        return losses.score(layer.loss, y.to(out.dtype), out,
                            layer.activation)

    def _reg(self, net, tree, names=None):
        r = 0.0
        for layer in net.layers:
            if layer.has_params() and layer.name in tree and (
                    names is None or layer.name in names):
                r = r + layer.reg_score(tree[layer.name])
        return r

    # ------------------------------------------------------ compiled periodic
    def _build_compiled(self, net, run):
        start, period, blocks = run
        S = self.n_stages
        per_stage = (blocks // S) * period
        idx = list(range(len(net.layers)))
        seg = idx[start:start + blocks * period]
        self._pfx = idx[:start]
        self._sfx = idx[start + blocks * period:]
        self._stage_groups = [seg[s * per_stage:(s + 1) * per_stage]
                              for s in range(S)]
        if not self._sfx or not isinstance(net.layers[self._sfx[-1]],
                                           OutputLayer):
            raise ValueError("pipeline suffix must end in an OutputLayer")
        self._pipe = self._mesh(S)
        self._upd_cfg = net.conf.updater
        self._mode = "compiled"
        self._compiled_kind = "periodic"
        self._compiled_steps = {}
        self._recorded = set()

    def _stack_tree(self, net, per_layer):
        """Facade tree -> the pipeline's: ``pfx/<name>``, ``blk/<j>``
        (stacked ``[S, ...]``), ``sfx/<name>``."""
        out = {}
        for gi in self._pfx:
            name = net.layers[gi].name
            if per_layer.get(name):
                out[f"pfx/{name}"] = per_layer[name]
        for j in range(len(self._stage_groups[0])):
            trees = [per_layer.get(net.layers[g[j]].name, {})
                     for g in self._stage_groups]
            if trees[0]:
                out[f"blk/{j}"] = _tmap(
                    lambda *xs: torch.stack(xs).contiguous(), *trees)
        for gi in self._sfx:
            name = net.layers[gi].name
            if per_layer.get(name):
                out[f"sfx/{name}"] = per_layer[name]
        return out

    def _unstack_into(self, net, tree, per_layer) -> None:
        """The pipeline's tree written back into the facade's tensors."""
        for k, v in tree.items():
            kind, _, tail = k.partition("/")
            if kind == "blk":
                j = int(tail)
                for s, g in enumerate(self._stage_groups):
                    common.copy_tree_(per_layer[net.layers[g[j]].name],
                                      _tmap(lambda a: a[s], v))

    def _periodic_loss(self, net, tree, xs, ys):
        """The GPipe schedule's mean microbatch loss (module docstring)."""
        S, M = self.n_stages, self.n_microbatches
        pfx = {net.layers[gi].name: tree[f"pfx/{net.layers[gi].name}"]
               for gi in self._pfx
               if f"pfx/{net.layers[gi].name}" in tree}
        sfx = {net.layers[gi].name: tree[f"sfx/{net.layers[gi].name}"]
               for gi in self._sfx
               if f"sfx/{net.layers[gi].name}" in tree}
        template = self._stage_groups[0]
        blks = [{net.layers[gi].name: _tmap(lambda a: a[s],
                                            tree[f"blk/{j}"])
                 for j, gi in enumerate(template) if f"blk/{j}" in tree}
                for s in range(S)]

        def tick(state, t):
            outs = []
            loss = None
            for s in range(S):
                m = t - s
                if not 0 <= m < M:
                    outs.append(None)
                    continue
                a = (self._run(net, self._pfx, pfx, xs[m]) if s == 0
                     else state[s])
                # stage s runs the template's layers with its own blocks
                outs.append(self._run(net, template, blks[s], a))
            m_out = t - (S - 1)
            if 0 <= m_out < M:
                last = self._run(net, self._sfx[:-1], sfx, outs[S - 1])
                loss = self._head(net, self._sfx[-1],
                                  sfx.get(net.layers[self._sfx[-1]].name, {}),
                                  last, ys[m_out])
            ref = next(o for o in outs if o is not None)
            stack = torch.stack([o if o is not None else torch.zeros_like(ref)
                                 for o in outs])
            return stack, (loss if loss is not None
                           else stack.new_zeros((), dtype=torch.float32))

        total = 0.0
        state = None
        for t in range(M + S - 1):
            if self.remat:
                outv, loss = checkpoint(tick, state, t, use_reentrant=False,
                                        preserve_rng_state=False)
            else:
                outv, loss = tick(state, t)
            if t >= S - 1:
                total = total + loss
            # each stage's output to the next stage's slot
            state = mesh_mod.ppermute(outv)
        return total / M

    # ------------------------------------------------- compiled heterogeneous
    def _build_compiled_hetero(self, net, shard_params: bool = False):
        self.stages = split_stages(net, self.n_stages)
        self.stage_layers = [[net.layers[i] for i in s] for s in self.stages]
        S = len(self.stages)
        self.n_stages = S
        self._pipe = self._mesh(S)
        self._upd_cfg = net.conf.updater
        self._lr_overrides = common.lr_overrides(net)
        self._mode = "compiled"
        self._compiled_kind = "hetero"
        self._hetero_sharded = shard_params
        if shard_params:
            self._flat_specs, self._flat_pmax = self._hetero_flat_spec(net)
        self._compiled_steps = {}
        self._recorded = set()

    def _hetero_flat_spec(self, net):
        """Each stage's leaves in (layer order, sorted path) order: (layer,
        path, shape, offset, size); returns (specs, Pmax)."""
        def leaves(d, prefix=()):
            out = []
            for k in sorted(d):
                v = d[k]
                if isinstance(v, dict):
                    out.extend(leaves(v, prefix + (k,)))
                else:
                    out.append((prefix + (k,), v))
            return out

        specs, sizes = [], []
        for ls in self.stage_layers:
            spec, off = [], 0
            for layer in ls:
                for path, a in leaves(net.params.get(layer.name, {}) or {}):
                    n = int(a.numel())
                    spec.append((layer.name, path, tuple(a.shape), off, n))
                    off += n
            specs.append(spec)
            sizes.append(off)
        return specs, max(max(sizes), 1)

    def _hetero_flatten(self, per_layer, missing_ok: bool = False):
        """Facade tree -> ``[S, Pmax]`` float32 rows (absent leaves are
        zeros with ``missing_ok``: a fresh updater state)."""
        dev = self.devices[0]
        rows = torch.zeros((len(self._flat_specs), self._flat_pmax),
                           dtype=torch.float32, device=dev)
        for s, spec in enumerate(self._flat_specs):
            for lname, path, shape, off, n in spec:
                node = per_layer.get(lname, {})
                for k in path:
                    node = node.get(k, {}) if isinstance(node, dict) else {}
                if isinstance(node, dict):
                    if not missing_ok:
                        raise KeyError(f"missing param {lname}/{path}")
                    continue
                rows[s, off:off + n] = node.detach().reshape(-1)
        return rows

    def _hetero_unflatten_into(self, rows, per_layer) -> None:
        """``[S, Pmax]`` rows written back into the facade tree's
        tensors."""
        for s, spec in enumerate(self._flat_specs):
            for lname, path, shape, off, n in spec:
                node = per_layer.get(lname)
                if node is None:
                    continue
                for k in path[:-1]:
                    node = node[k]
                node[path[-1]].copy_(rows[s, off:off + n].view(shape))

    def _hetero_stage_tree(self, s: int, flat):
        """Stage s's tree as views into its row ``flat``."""
        out: Dict[str, Any] = {}
        for lname, path, shape, off, n in self._flat_specs[s]:
            node = out.setdefault(lname, {})
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = flat[off:off + n].view(shape)
        return out

    def _stage_fwd(self, net, s, tree, a):
        """Stage s's layers; the last stage stops before its head."""
        S = len(self.stages)
        idxs = self.stages[s][:-1] if s == S - 1 else self.stages[s]
        return self._run(net, idxs, tree, a)

    def _hetero_loss(self, net, tree_for, xs, ys, bounds):
        """The GPipe schedule over the hetero stages: boundaries as a
        ``[S, buf]`` flat padded stack moved by ``ppermute``."""
        S, M = len(self.stages), self.n_microbatches
        bound, buf, bdt = bounds

        def tick(state, t):
            rows, loss = [], None
            for s in range(S):
                m = t - s
                if not 0 <= m < M:
                    rows.append(None)
                    continue
                tree = tree_for(s)
                if s == 0:
                    a = xs[m]
                else:
                    shape, dt = bound[s - 1]
                    n = int(np.prod(shape))
                    a = state[s][:n].view(shape).to(dt)
                a = self._stage_fwd(net, s, tree, a)
                if s == S - 1:
                    gi = self.stages[s][-1]
                    loss = self._head(net, gi,
                                      tree.get(net.layers[gi].name, {}),
                                      a, ys[m])
                    rows.append(None)
                else:
                    flat = a.reshape(-1).to(bdt)
                    rows.append(torch.nn.functional.pad(
                        flat, (0, buf - flat.shape[0])))
            zero = torch.zeros((buf,), dtype=bdt, device=xs.device)
            stack = torch.stack([r if r is not None else zero for r in rows])
            return stack, (loss if loss is not None
                           else stack.new_zeros((), dtype=torch.float32))

        total = 0.0
        state = None
        for t in range(M + S - 1):
            if self.remat:
                outv, loss = checkpoint(tick, state, t, use_reentrant=False,
                                        preserve_rng_state=False)
            else:
                outv, loss = tick(state, t)
            if t >= S - 1:
                total = total + loss
            state = mesh_mod.ppermute(outv)
        return total / M

    def _hetero_bounds(self, net, tree_for, xs):
        """The boundary activations' shapes and types (stage s's output,
        stage s+1's input), from one microbatch's forward, and the flat
        buffer's size and type."""
        S = len(self.stages)
        bound = []
        with torch.no_grad():
            a = xs[0]
            for s in range(S - 1):
                a = self._stage_fwd(net, s, tree_for(s), a)
                bound.append((tuple(a.shape), a.dtype))
        bdt = bound[0][1] if bound else torch.float32
        for _, dt in bound[1:]:
            bdt = torch.promote_types(bdt, dt)
        buf = max([int(np.prod(sh)) for sh, _ in bound] or [1])
        return bound, buf, bdt

    # -------------------------------------------------------- compiled steps
    def _compiled_state(self, net):
        """A holder of the step's trees, (params, updater state) in the
        path's layout, which the captured programs read: the master's
        own for the same net, refreshed from the net's tensors in place,
        else a new one."""
        tree, opt = self._laid_out(net)
        h = getattr(self, "_h", None)

        def layout(t):
            return [(p, tuple(a.shape)) for p, a in common.tree_paths(t)]

        if h is not None and h._of is net and \
                layout(h.params) == layout(tree):
            with torch.no_grad():
                if h.params is not tree:
                    common.copy_tree_(h.params, tree)
                if h.updater_state is not opt:
                    common.copy_tree_(h.updater_state, opt)
        else:
            h = self._h = _Staged(net, tree, opt, {})
            h._of = net
        h.iteration = net.iteration
        return h

    def _laid_out(self, net):
        """(params, inner updater state) in the path's layout."""
        if self._compiled_kind == "periodic":
            tree = self._stack_tree(net, net.params)
            opt = {slot: self._stack_tree(net, t)
                   for slot, t in upd.inner_state(net.updater_state).items()}
        elif self._hetero_sharded:
            tree = {"_pipe": {"w": self._hetero_flatten(net.params)}}
            opt = {slot: {"_pipe": {"w": self._hetero_flatten(
                t, missing_ok=True)}}
                for slot, t in upd.inner_state(net.updater_state).items()}
        else:
            tree = net.params
            opt = upd.inner_state(net.updater_state)
        return tree, opt

    def _fold_back(self, net, h) -> None:
        """The holder's trees written back into the net's tensors."""
        with torch.no_grad():
            if self._compiled_kind == "periodic":
                self._unstack_into(net, h.params, net.params)
                for slot, t in h.updater_state.items():
                    self._unstack_into(net, t, net.updater_state[slot])
            elif self._hetero_sharded:
                self._hetero_unflatten_into(h.params["_pipe"]["w"],
                                            net.params)
                for slot, t in h.updater_state.items():
                    self._hetero_unflatten_into(t["_pipe"]["w"],
                                                net.updater_state[slot])

    def _step_body(self, net, h, bounds=None):
        """The compiled step's device body: the schedule's loss plus the
        regularisation, autograd through both, the update in place."""
        cfg = self._upd_cfg

        def body(xs, ys, key, scalars):
            xs = _cast(xs, self._cd)
            train = common.trainable(h.params)
            leaves = common.tree_leaves(train)
            for p in leaves:
                p.requires_grad_(True)
            try:
                tree = _cast(train, self._cd)
                if self._compiled_kind == "periodic":
                    loss = self._periodic_loss(net, tree, xs, ys)
                    reg = self._reg_periodic(net, tree)
                elif self._hetero_sharded:
                    rows = tree["_pipe"]["w"]
                    trees = [self._hetero_stage_tree(s, rows[s])
                             for s in range(len(self.stages))]
                    loss = self._hetero_loss(net, trees.__getitem__, xs, ys,
                                             bounds)
                    reg = sum(self._reg(net, t) for t in trees)
                else:
                    loss = self._hetero_loss(net, lambda s: tree, xs, ys,
                                             bounds)
                    reg = self._reg(net, tree)
                total = loss + reg
                grads = torch.autograd.grad(total, leaves, allow_unused=True)
            finally:
                for p in leaves:
                    p.requires_grad_(False)
            with torch.no_grad():
                g = common._tree_like(train, [
                    torch.zeros_like(p) if gi is None else gi
                    for p, gi in zip(leaves, grads)])
                updates, new_us = upd.update(
                    cfg, g, h.updater_state, h.iteration, params=train,
                    scalars=scalars)
                upd.apply_updates_(h.params, updates)
                common.copy_tree_(h.updater_state, new_us)
            return total.detach()

        return body

    def _reg_periodic(self, net, tree):
        r = 0.0
        for k, v in tree.items():
            kind, _, tail = k.partition("/")
            if kind == "blk":
                layer = net.layers[self._stage_groups[0][int(tail)]]
                # the stacked blocks' penalty: each stage's, summed
                r = r + sum(layer.reg_score(_tmap(lambda a: a[s], v))
                            for s in range(self.n_stages))
            else:
                layer = next(l for l in net.layers if l.name == tail)
                r = r + layer.reg_score(v)
        return r

    def _ledger(self, h):
        pipe = self._pipe
        S = len(pipe.devices)

        def laid(name, t):
            split = (name.startswith("blk/") or name == "_pipe")
            return Sharded(t, P(AXIS_PIPE) if split else P(), pipe,
                           t.shape)

        def tree_of(t):
            return {k: _tmap(lambda a, k=k: laid(k, a), v)
                    for k, v in t.items()}

        shardstats.record_ledger(
            "pipeline_master",
            {"params": tree_of(h.params),
             "updater_state": {slot: tree_of(t)
                               for slot, t in h.updater_state.items()}},
            data_axis_size=S)

    def _execute_compiled(self, net, iterator, res=None):
        from deeplearning4j_tpu_torch.resilience import preemption_requested

        M = self.n_microbatches
        h = self._compiled_state(net)
        self._ledger(h)
        dt = common._scalar_dtype(net)
        stopped = False
        try:
            for ds in iterator:
                if res is not None and res.skip_batch():
                    continue
                if preemption_requested():
                    stopped = True
                    break
                if ds.features_mask is not None or \
                        ds.labels_mask is not None:
                    raise ValueError(
                        "pipeline master does not support masked batches")
                x, y = _tensor(ds.features), _tensor(ds.labels)
                if len(x) % M:
                    raise ValueError(f"batch {len(x)} not divisible by "
                                     f"{M} microbatches")
                xs = x.reshape((M, len(x) // M) + tuple(x.shape[1:]))
                ys = y.reshape((M, len(y) // M) + tuple(y.shape[1:]))
                key = (tuple(xs.shape), tuple(ys.shape))
                if key not in self._compiled_steps:
                    bounds = None
                    if self._compiled_kind == "hetero":
                        rows = (h.params["_pipe"]["w"]
                                if self._hetero_sharded else None)
                        tf = ((lambda s: _cast(net.params, self._cd))
                              if rows is None else
                              (lambda s: _cast(self._hetero_stage_tree(
                                  s, rows[s]), self._cd)))
                        bounds = self._hetero_bounds(
                            net, tf, _cast(xs.to(net.device), self._cd))
                    self._compiled_steps[key] = self._step_body(net, h,
                                                                bounds)
                body = self._compiled_steps[key]
                h.iteration = net.iteration
                vals = upd.step_scalars(self._upd_cfg, net.iteration,
                                        list(common.trainable(h.params)),
                                        self._lr_overrides_of())

                def dispatch(xs=xs, ys=ys, body=body, vals=vals, key=key):
                    inputs = {"xs": xs, "ys": ys}
                    fresh = key not in self._recorded
                    with mesh_mod.census() as c:
                        if cap.captures(h):
                            graphs = cap.step_graphs(h)
                            prog = graphs.program(
                                f"pipeline_{self._compiled_kind}", body,
                                inputs, len(vals), dt)
                            prog.scalar_names = list(vals)
                            graphs.stage(prog, inputs, 0,
                                         list(vals.values()))
                            runs = 2 if prog.graph is None else 0
                            out = graphs.run(prog)
                        else:
                            dev = net.device
                            sc = torch.tensor(list(vals.values()), dtype=dt,
                                              device=dev)
                            runs = 1
                            out = body(xs=xs.to(dev), ys=ys.to(dev),
                                       key=rng_mod.device_key(0, dev),
                                       scalars=dict(zip(vals,
                                                        sc.unbind(0))))
                    if fresh and runs:
                        # the step's ppermutes, once a program (a
                        # capture runs the body twice: warm-up, capture)
                        self._recorded.add(key)
                        shardstats.record_program(
                            "PipelineParallelTrainingMaster.step", key,
                            {op: {"count": e["count"] // runs,
                                  "bytes": e["bytes"] / runs,
                                  "group_sizes": e["group_sizes"]}
                             for op, e in c.counts.items()},
                            device=net.device)
                    return out

                with step_guard("pipeline_step", component="pipeline_master",
                                iteration=net.iteration):
                    with self._phases.phase("dispatch"):
                        loss = (res.step(dispatch, net.iteration, net=net)
                                if res is not None else dispatch())
                net.score_value = loss.clone()
                net.iteration += 1
                self._phases.steps += 1
                common.notify_listeners(net, len(x))
                if res is not None and res.cm is not None:
                    trigger = res.cm.due(net.iteration)
                    if trigger is not None:
                        self._fold_back(net, h)
                        res.cm.save(net, trigger=trigger)
        finally:
            self._fold_back(net, h)
        if stopped and res is not None:
            res.on_preempt(net)

    def _lr_overrides_of(self):
        if self._compiled_kind == "hetero" and not self._hetero_sharded:
            return self._lr_overrides
        return {}

    # ----------------------------------------------------------- orchestrated
    def _stage_params(self, net, s: int) -> Dict[str, Any]:
        names = [net.layers[i].name for i in self.stages[s]]
        return {n: net.params[n] for n in names if net.params.get(n)}

    def _execute_orchestrated(self, net, iterator, res):
        from deeplearning4j_tpu_torch.resilience import preemption_requested

        S = len(self.stages)
        stage_params = [self._stage_params(net, s) for s in range(S)]
        inner = upd.inner_state(net.updater_state)
        stage_upd = [{slot: {n: tree[n] for n in stage_params[s]
                             if n in tree}
                      for slot, tree in inner.items()} for s in range(S)]
        shardstats.record_ledger("pipeline_master", {
            **{f"params_stage{s}": stage_params[s] for s in range(S)},
            **{f"updater_state_stage{s}": stage_upd[s] for s in range(S)},
        })
        if self._workers is None:
            self._workers = WorkerTelemetry("pipeline_master")
        for ds in iterator:
            if res is not None and res.skip_batch():
                continue
            if preemption_requested():
                if res is not None:
                    res.on_preempt(net)
                return
            with step_guard("pipeline_step", component="pipeline_master",
                            iteration=net.iteration):
                def call(ds=ds):
                    return self._train_batch(net, ds, stage_params,
                                             stage_upd)

                loss = (res.step(call, net.iteration, net=net)
                        if res is not None else call())
            net.score_value = loss
            net.iteration += 1
            self._phases.steps += 1
            common.notify_listeners(net, len(ds))
            if res is not None and res.cm is not None:
                trigger = res.cm.due(net.iteration)
                if trigger is not None:
                    res.cm.save(net, trigger=trigger)

    def _train_batch(self, net, ds, stage_params, stage_upd):
        if ds.features_mask is not None or ds.labels_mask is not None:
            raise ValueError("pipeline master does not support masked "
                             "batches")
        phase_t0 = self._phases.totals()
        S, M = len(self.stages), self.n_microbatches
        dev = net.device
        x = _tensor(ds.features).to(dev)
        y = _tensor(ds.labels).to(dev)
        if len(x) % M:
            raise ValueError(f"batch {len(x)} not divisible by "
                             f"{M} microbatches")
        if self._cd is not None:
            x = x.to(self._cd)
        xs, ys = torch.chunk(x, M), torch.chunk(y, M)
        leaves = [common.tree_leaves(p) for p in stage_params]
        live = [[None] * S for _ in range(M)]   # (input, output) a stage
        losses_m = [None] * M
        grads = [None] * S

        def acc(s, g):
            grads[s] = list(g) if grads[s] is None else [
                a + b for a, b in zip(grads[s], g)]

        def forward(m):
            a = xs[m]
            for s in range(S):
                inp = a.detach().requires_grad_(s > 0 and
                                                a.is_floating_point())
                tree = _cast(stage_params[s], self._cd)
                with self._phases.phase(f"stage{s}_fwd"):
                    out = self._stage_fwd(net, s, tree, inp)
                    if s == S - 1:
                        gi = self.stages[s][-1]
                        out = self._head(net, gi,
                                         tree.get(net.layers[gi].name, {}),
                                         out, ys[m])
                live[m][s] = (inp, out)
                a = out
            losses_m[m] = live[m][S - 1][1].detach()

        def backward(m):
            ga = None
            for s in range(S - 1, -1, -1):
                inp, out = live[m][s]
                wrt = leaves[s] + ([inp] if s > 0 else [])
                if not wrt:
                    continue
                with self._phases.phase(f"stage{s}_bwd"):
                    if s == S - 1:
                        g = torch.autograd.grad(out / M, wrt,
                                                allow_unused=True)
                    else:
                        g = torch.autograd.grad(out, wrt, ga,
                                                allow_unused=True)
                g = [torch.zeros_like(p) if gi is None else gi
                     for p, gi in zip(wrt, g)]
                acc(s, g[:len(leaves[s])])
                ga = g[-1] if s > 0 else None
            live[m] = [None] * S            # the stashed graphs go

        for ls in leaves:
            for p in ls:
                p.requires_grad_(True)
        try:
            if self.schedule == "1f1b":
                for t in range(M + S - 1):
                    if t < M:
                        forward(t)
                    if t - (S - 1) >= 0:
                        backward(t - (S - 1))
            else:
                for m in range(M):
                    forward(m)
                for m in range(M):
                    backward(m)
            reg_vals = []
            for s in range(S):
                r = self._reg(net, stage_params[s])
                if torch.is_tensor(r) and r.requires_grad:
                    g = torch.autograd.grad(r, leaves[s], allow_unused=True)
                    acc(s, [torch.zeros_like(p) if gi is None else gi
                            for p, gi in zip(leaves[s], g)])
                    r = r.detach()
                reg_vals.append(r)
        finally:
            for ls in leaves:
                for p in ls:
                    p.requires_grad_(False)
        with torch.no_grad():
            for s in range(S):
                if not leaves[s]:
                    continue
                g = common._tree_like(stage_params[s], grads[s])
                updates, new_us = upd.update(
                    self._upd_cfg, g, stage_upd[s], net.iteration,
                    self._lr_overrides, params=stage_params[s])
                upd.apply_updates_(stage_params[s], updates)
                common.copy_tree_(stage_upd[s], new_us)
        t1 = self._phases.totals()
        for s in range(S):
            fwd = (t1.get(f"stage{s}_fwd", 0.0)
                   - phase_t0.get(f"stage{s}_fwd", 0.0))
            bwd = (t1.get(f"stage{s}_bwd", 0.0)
                   - phase_t0.get(f"stage{s}_bwd", 0.0))
            self._workers.observe(f"stage{s}", fwd + bwd,
                                  phases={"fwd": fwd, "bwd": bwd})
        return (sum(losses_m) / M + sum(reg_vals)).detach()

    # ---------------------------------------------------------------- train
    def execute_training(self, net, iterator):
        from deeplearning4j_tpu_torch.observability import (
            introspection, numerics,
        )
        from deeplearning4j_tpu_torch.resilience import FitResilience

        res = None
        if self.checkpoint_manager is not None or \
                self.retry_policy is not None:
            res = FitResilience("pipeline_master", self.checkpoint_manager,
                                self.retry_policy, net=net)
        # the layerless __introspect__ / __numerics__ subtrees cannot split
        # by stage: parked for the fit (stale over it), as the reference
        held = {k: net.updater_state.pop(k) for k in
                (introspection.STATE_KEY, numerics.STATE_KEY)
                if k in net.updater_state}
        try:
            if not self._built:
                self._build(net)
            if self._mode == "compiled":
                return self._execute_compiled(net, iterator, res)
            return self._execute_orchestrated(net, iterator, res)
        finally:
            net.updater_state.update(held)
