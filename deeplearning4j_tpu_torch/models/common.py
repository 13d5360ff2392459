"""What both facades share — counterpart of
``deeplearning4j_tpu/models/common.py``: nested-dict tree helpers, the
lazy ``score_value``, the flat parameter vector and ``clone``, the checks
before training, the train step split into its host part
(``train_step``: the step's key seed and updater scalars, then a
captured graph's replay on the card or the body eagerly) and its device
body (``sgd_step``: loss -> autograd -> updater -> in-place update ->
layer state copied in place), ``infer`` for ``output``, the
``fit_scanned`` windows, ``fit``'s batch loop with its resilience and
stability duties, its telemetry and its listeners (``fit_loop``),
TBPTT's window loop (``fit_tbptt``), the in-step introspection and
numerics collection (``StepWatch``), the stream caches and recurrent
carries of ``rnn_time_step`` and ``generate`` (seeding, the host-side
capacity check), the solver path of ``fit`` (``fit_solver``) and the
layerwise pretraining of AutoEncoder and RBM layers
(``pretrain_layer``)."""

from __future__ import annotations

import functools
import time

import numpy as np
import torch

from deeplearning4j_tpu_torch.backend import rng as rng_mod
from deeplearning4j_tpu_torch.backend.device import compute_dtype
from deeplearning4j_tpu_torch.models import capture as cap
from deeplearning4j_tpu_torch.nn.layers.attention import SelfAttentionLayer
from deeplearning4j_tpu_torch.nn.layers.autoencoder import RBM, AutoEncoder
from deeplearning4j_tpu_torch.optimize import updaters as upd
from deeplearning4j_tpu_torch.observability import introspection, numerics
from deeplearning4j_tpu_torch.observability.fitmetrics import fit_telemetry
from deeplearning4j_tpu_torch.observability import profiling
from deeplearning4j_tpu_torch.observability.flightrecorder import (
    crash_dump, step_guard,
)
from deeplearning4j_tpu_torch.observability.recompile import instrument
from deeplearning4j_tpu_torch.resilience import stability
from deeplearning4j_tpu_torch.resilience.faults import get_fault_injector
from deeplearning4j_tpu_torch.resilience.integration import FitResilience
from deeplearning4j_tpu_torch.resilience.preemption import (
    preemption_requested,
)


def cast_tree(tree, dtype: torch.dtype):
    """Cast every floating tensor of a nested dict to ``dtype`` (a tensor
    already in ``dtype`` is returned as it is, not copied)."""
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype) for k, v in tree.items()}
    if torch.is_tensor(tree) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


def tree_paths(tree, prefix=()):
    """(key path, leaf) of every leaf of nested dicts and tuples (an LSTM's
    (h, c) carry), in sorted-key order; a None leaf (an absent mask) is
    skipped."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree)
                for leaf in tree_paths(tree[k], prefix + (k,))]
    if isinstance(tree, tuple):
        return [leaf for i, v in enumerate(tree)
                for leaf in tree_paths(v, prefix + (i,))]
    return [] if tree is None else [(prefix, tree)]


def tree_leaves(tree):
    """The tensors of a nested dict, in sorted-key order."""
    return [leaf for _, leaf in tree_paths(tree)]


def tree_map(fn, tree):
    """``tree``'s shape with ``fn(leaf)`` at every leaf; None stays None."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(tree_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def _tree_like(template, leaves):
    """A nested dict shaped like ``template`` holding ``leaves`` (in
    ``tree_leaves`` order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)

    return build(template)


def trainable(params):
    """The layers that have parameters."""
    return {k: v for k, v in params.items() if v}


def tree_clone(tree):
    """A deep copy of a nested dict of tensors: each tensor cloned on its
    device, anything else kept as it is."""
    if isinstance(tree, dict):
        return {k: tree_clone(v) for k, v in tree.items()}
    if torch.is_tensor(tree):
        return tree.detach().clone()
    return tree


def initial_carries(named_layers, batch, cdtype, device):
    """{name: zero (h, c)} of every recurrent layer (one with an
    ``initial_carry``) in the model's compute dtype on ``device``: the
    state a sequence starts from (the reference's zero ``h0``/``c0``)."""
    dtype = compute_dtype(cdtype)
    return {name: layer.initial_carry(int(batch), dtype, device)
            for name, layer in named_layers
            if hasattr(layer, "initial_carry")}


def seed_stream_caches(named_layers, rnn_state, batch, cdtype, device):
    """The carries shared by both facades' ``rnn_time_step`` and
    ``generate``: for every (name, layer) with no carry in ``rnn_state``,
    a stream cache where it has an ``init_cache`` and zero (h, c) where
    it is recurrent, in the model's compute dtype on ``device`` (the
    zeros compute what the reference's absent first carry does).
    Returns the carries (maybe empty)."""
    named_layers = list(named_layers)
    dtype = compute_dtype(cdtype)
    carries = initial_carries(named_layers, batch, cdtype, device)
    carries.update(rnn_state or {})
    for name, layer in named_layers:
        if hasattr(layer, "init_cache") and name not in carries:
            cache = layer.init_cache(int(batch), dtype, device)
            if cache is not None:
                carries[name] = cache
    return carries


def advance_carries_(carries, new) -> None:
    """The forward's new carries into ``carries``, in place, so that a
    captured loop finds its state at fixed addresses: each recurrent
    (h, c) copied into the tensors held, a block's carries walked, a
    carry ``carries`` lacks inserted; stream caches are updated in place
    by their layers already."""
    for name, nc in new.items():
        old = carries.get(name)
        if nc is None or old is nc:
            continue
        if old is None:
            carries[name] = nc
        elif isinstance(nc, tuple):
            for dst, src in zip(old, nc):
                dst.copy_(src)
        else:
            advance_carries_(old, nc)


def check_cache_capacity(carries, t_new: int, pos: int | None = None) -> None:
    """Raise before the call when a streamed chunk would overflow any
    linear attention cache (the in-place write would fault; the
    reference's ``dynamic_update_slice`` would clamp and silently move
    keys).  ``pos`` is the facade's host-side stream position, which
    keeps the decode loop free of device-to-host syncs (every cache
    advances in lockstep with the streamed input)."""
    def walk(name, c):
        if not isinstance(c, dict):
            return
        if "pos" in c and "k" in c:
            if SelfAttentionLayer.cache_overflow(c, t_new, pos=pos):
                at = pos if pos is not None else int(c["pos"])
                raise ValueError(
                    f"rnn_time_step: streaming past the KV cache of "
                    f"'{name}' (pos={at} + {t_new} > "
                    f"max_cache={c['k'].shape[1]}); raise the layer's "
                    "max_cache or rnn_clear_previous_state()")
        else:
            for k, v in c.items():
                walk(f"{name}.{k}", v)

    for name, c in (carries or {}).items():
        walk(name, c)


class FlatParamsMixin:
    """``num_params``, the flat parameter vector and ``clone`` of a facade
    whose ``params`` is a nested dict (reference ``sequential.py:100-122``,
    ``graph.py:368-385``).  The vector's order is ``tree_leaves``'s, sorted
    keys at every level as in ``jax.tree_util.tree_leaves``, so a port
    vector and a JAX vector of the same weights are equal element for
    element."""

    def compute_params(self):
        """The params as the forward uses them: cast to the compute dtype
        (the same tensors when there is none)."""
        return cast_tree(self.params, compute_dtype(self.conf.compute_dtype))

    def num_params(self) -> int:
        # nested: composite layers (ResidualBlock) hold dicts of params
        return sum(p.numel() for p in tree_leaves(self.params))

    def params_to_vector(self) -> np.ndarray:
        """Every parameter, flattened into one float32 numpy vector."""
        leaves = tree_leaves(self.params)
        if not leaves:
            return np.zeros((0,), np.float32)
        return np.concatenate([p.detach().float().cpu().numpy().reshape(-1)
                               for p in leaves])

    def set_params_vector(self, vec) -> None:
        """Write ``vec`` (``params_to_vector``'s layout) into the params,
        in place: each leaf keeps its dtype and device."""
        vec = np.asarray(vec)
        leaves = tree_leaves(self.params)
        total = sum(p.numel() for p in leaves)
        if total != vec.size:
            raise ValueError(
                f"param vector size {vec.size} != model size {total}")
        flat = torch.from_numpy(np.ascontiguousarray(vec.reshape(-1)))
        off = 0
        with torch.no_grad():
            for p in leaves:
                n = p.numel()
                p.copy_(flat[off:off + n].reshape(p.shape))
                off += n

    def clone(self):
        """An independent copy on the same device: params, layer state
        and updater state deep-copied, the iteration count carried."""
        net = type(self)(self.conf)
        net.device = self.device
        net.params = tree_clone(self.params)
        net.net_state = tree_clone(self.net_state)
        net.updater_state = tree_clone(self.updater_state)
        net.iteration = self.iteration
        return net


class LazyScoreMixin:
    """``score_value``: the last step's loss.  The step keeps it on the
    device; the copy to the host (and its sync) happens on first read."""

    _score = None

    @property
    def score_value(self) -> float:
        s = self._score
        if s is None:
            return float("nan")
        if not isinstance(s, float):
            s = float(s)
            self._score = s
        return s

    @score_value.setter
    def score_value(self, value) -> None:
        self._score = value


def check_trainable(net) -> None:
    """Raise when the net has no parameters yet, and give the net the
    state subtrees its training policies keep (stability guard,
    introspection, numerics ledger)."""
    if net.device is None:
        raise RuntimeError("call init() (or load a model) before fit()")
    stability.ensure_state(net)
    introspection.ensure_state(net)
    numerics.ensure_state(net)


def observed_plans(net):
    """(introspection plan, numerics plan) of the net's configuration,
    each None when its policy is unset; kept on the net while its
    configuration object is the same."""
    cached = getattr(net, "_observed", None)
    if cached is None or cached[0] is not net.conf:
        cached = (net.conf, introspection.plan_for(net),
                  numerics.plan_for(net))
        net._observed = cached
    return cached[1], cached[2]


class StepWatch:
    """One step's introspection and numerics collection, a pass of its
    own beside the update (reference: ``introspection.attach`` and
    ``numerics.attach`` in the step cores): the layers' activations are
    summarised right after the forward, the gradients (loss-scaled under
    the guard, unscaled by ``1 / loss_scale`` read before the guard can
    change it) and a copy of the pre-update parameters are kept, and
    after the update the statistics are written into the
    ``__introspect__`` and ``__numerics__`` vectors in place.  Nothing of
    it enters the update, so the parameters are bit for bit those of the
    same net without the policies.  ``now`` is the numerics ledger's
    collect flag (None: every step; False: a skipping step).  With
    ``processes`` (a step whose forward holds this process's rows of the
    global batch) the activations' statistics are the global batch's,
    reduced across the processes."""

    def __init__(self, iplan, nplan, iteration, now, processes=False):
        self.iplan, self.nplan, self.now = iplan, nplan, now
        self.iteration = iteration
        self.processes = processes
        self.acts = ([] if numerics.wants_acts(iplan, nplan, now)
                     else None)
        self.act_stats = {}
        self.grads = self.old = self.scale = None

    @staticmethod
    def of(net, scalars, now=None, processes=False):
        """The step's watch, or None when neither policy is set."""
        iplan, nplan = observed_plans(net)
        if iplan is None and nplan is None:
            return None
        return StepWatch(iplan, nplan, scalars["iteration"], now, processes)

    def summarise(self) -> None:
        """Reduce the collected (name, activation) pairs to their stat
        vectors and drop the references."""
        if self.acts is None:
            return
        named, self.acts = self.acts, None
        with torch.no_grad():
            if self.iplan is not None and self.iplan.collect_acts:
                self.act_stats.update(introspection.act_summary(
                    named, dead_eps=self.iplan.policy.dead_eps,
                    processes=self.processes))
            if (self.nplan is not None and self.nplan.collect_acts
                    and self.now is not False):
                self.act_stats.update(numerics.act_ranges(
                    named, policy=self.nplan.policy,
                    processes=self.processes))

    def before_update(self, grads, train, stab) -> None:
        self.grads = grads
        if stab is not None:
            self.scale = 1.0 / stab["loss_scale"]
        if self.iplan is not None:
            self.old = tree_clone(train)

    def after_update(self, net) -> None:
        introspection.attach_(
            net.updater_state, self.iplan, grads=self.grads,
            params=self.old, new_params=trainable(net.params),
            iteration=self.iteration, act_stats=self.act_stats,
            grad_scale=self.scale)
        numerics.attach_(
            net.updater_state, self.nplan, now=self.now, grads=self.grads,
            iteration=self.iteration, act_stats=self.act_stats,
            grad_scale=self.scale)


def copy_tree_(dst, src) -> None:
    """Write ``src``'s tensors into ``dst``'s (same nested-dict shape) in
    place: a captured step reads and writes the tensors it captured.  A
    subtree or leaf that ``dst`` lacks is inserted."""
    for k, v in src.items():
        d = dst.get(k)
        if d is None:
            dst[k] = v
        elif isinstance(v, dict):
            copy_tree_(d, v)
        elif d is not v:
            d.copy_(v)


def lr_overrides(net):
    return {l.name: l.learning_rate for l in net.layers
            if l.learning_rate is not None}


def sgd_step(net, loss_of, scalars, carries=None,
             numerics_now=None, extra_ok=None, exchange=None
             ) -> torch.Tensor:
    """The device body of one step of ``net``: ``loss_of(params,
    collect) -> (loss, new_net_state)`` (``collect``: None, or a list the
    forward extends with each layer's (name, activation) for the
    introspection and numerics policies, ``StepWatch``), gradients of
    the trainable leaves, the
    updater (``scalars``: ``updaters.step_scalars``' values as 0-d
    tensors), the update subtracted in place, and the new updater and
    layer state copied into the old tensors.  With ``carries`` (a TBPTT
    window's {layer: (h, c)}), ``loss_of`` also returns the new carries,
    which are written into ``carries``' tensors once the gradients are
    taken: the backward pass reads the old ones, which autograd saved.
    Under ``conf.stability`` the loss is scaled before the gradients and
    the tail is the guard's (``resilience/stability.py``
    ``guarded_update_``: a non-finite step writes nothing but the
    stability state).  Returns the loss as a device scalar (no host
    sync).  ``extra_ok`` (0-d bool) vetoes a guarded step besides the
    verdict (the sync master's all-rows-poisoned batch).  ``exchange``
    (the sync master across processes) takes ``(grads, loss, extra_ok)``
    once the gradients are taken and returns ``(net, trainable params,
    grads, loss, extra_ok)`` for the update: the processes' sums, and
    under ZeRO the holder of the process's own blocks.  Its ``watched``
    is then the ``(net, trainable params, grads)`` the introspection and
    numerics policies read (the whole trees, the summed gradient), its
    ``finish()`` runs after the update and before they read the updated
    parameters (ZeRO's gather of every process's blocks), and the
    activations' statistics are reduced across the processes."""
    policy = stability.policy_of(net.conf)
    stab = net.updater_state.get(stability.STATE_KEY) if policy else None
    watch = StepWatch.of(net, scalars, numerics_now,
                         processes=exchange is not None)
    train = trainable(net.params)
    leaves = tree_leaves(train)
    for p in leaves:
        p.requires_grad_(True)
    try:
        out = loss_of(net.params,
                      None if watch is None else watch.acts)
        loss, new_state = out[0], out[1]
        if watch is not None:
            watch.summarise()
        target = loss if stab is None else loss * stab["loss_scale"]
        grads = torch.autograd.grad(target, leaves, allow_unused=True)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    grads = _tree_like(train, [torch.zeros_like(p) if g is None else g
                               for p, g in zip(leaves, grads)])
    if exchange is not None:
        net, train, grads, loss, extra_ok = exchange(grads, loss.detach(),
                                                     extra_ok)
    seen = exchange.watched if exchange is not None else (net, train, grads)
    with torch.no_grad():
        if watch is not None:
            watch.before_update(seen[2], seen[1], stab)
        if stab is not None:
            stability.guarded_update_(
                net, policy, loss.detach(), grads, train, new_state, scalars,
                carries, None if carries is None
                else {k: out[2][k] for k in carries}, extra_ok=extra_ok)
        else:
            updates, new_ustate = upd.update(
                net.conf.updater, grads, upd.inner_state(net.updater_state),
                net.iteration, params=train, scalars=scalars)
            upd.apply_updates_(net.params, updates)
            copy_tree_(net.updater_state, new_ustate)
            copy_tree_(net.net_state, new_state)
            if carries is not None:
                advance_carries_(carries, {k: out[2][k] for k in carries})
        if exchange is not None:
            exchange.finish()
        if watch is not None:
            watch.after_update(seen[0])
    return loss.detach()


def _scalar_dtype(net) -> torch.dtype:
    """float64 when the trainable params are, else float32."""
    leaves = tree_leaves(trainable(net.params))
    return (torch.float64 if leaves and leaves[0].dtype == torch.float64
            else torch.float32)


def _step_scalars(net, iteration):
    return upd.step_scalars(net.conf.updater, iteration,
                            list(trainable(net.params)), lr_overrides(net))


def _on(tree, device):
    return tree_map(lambda t: torch.as_tensor(t, device=device), tree)


def _poisoned(net, inputs):
    """``inputs`` with the features (``"x"`` or ``"inputs"``) poisoned
    on the host, before staging, when the fault injector holds a live
    poison rule for worker ``"0"`` at this iteration (the reference's
    single-device hook); the labels are left alone."""
    inj = get_fault_injector()
    if inj is None or not inj.has_poison():
        return inputs
    name = "x" if "x" in inputs else "inputs"
    x, _ = inj.poison_batch("0", net.iteration, inputs[name], None)
    return {**inputs, name: x}


def train_step(net, body, inputs):
    """The host part of one step: the step's key seed from the net's key
    stream and its updater scalars from ``net.iteration``, then
    ``body(**inputs, key=, scalars=)`` — through the net's captured graph
    on the card (the inputs staged into its static tensors), eagerly on
    the CPU or with ``net._capture`` off.  Records the step:
    ``score_value`` a copy of the loss on the device (a replay's static
    loss is rewritten by the next), ``iteration`` one further.  Returns
    what the body returned: the loss, or (loss, carries) for a TBPTT
    window, whose carries (a replay's: the program's static carries,
    rewritten in place) the next window starts from."""
    inputs = _poisoned(net, inputs)
    seed = rng_mod.seed_of(net._keys.next())
    vals = _step_scalars(net, net.iteration)
    dtype = _scalar_dtype(net)
    iplan, nplan = observed_plans(net)
    variant = None
    if iplan is not None or nplan is not None:
        # the statistics' iteration stamp, a device scalar like the rest
        vals["iteration"] = float(net.iteration)
        now = numerics.collect_now(nplan, net.iteration)
        if now is not None:
            # interval-gated ledger: a collecting and a skipping program
            body = functools.partial(body, numerics_now=now)
            variant = ("numerics", now)

    def record(out):
        loss = out[0] if isinstance(out, tuple) else out
        net.score_value = loss.clone()   # fetched lazily on read
        net.iteration += 1

    if cap.captures(net):
        graphs = cap.step_graphs(net)
        inputs = tree_map(cap.host_or_device, inputs)
        prog = graphs.program("train", body, inputs, len(vals), dtype,
                              variant=variant)
        prog.scalar_names = list(vals)
        graphs.stage(prog, inputs, seed, list(vals.values()))
        return graphs.run(prog, record)
    dev = net.device
    sc = torch.tensor(list(vals.values()), dtype=dtype, device=dev)
    out = body(**_on(inputs, dev), key=rng_mod.device_key(seed, dev),
               scalars=dict(zip(vals, sc.unbind(0))))
    record(out)
    return out


def instrumented_step(net, kind: str):
    """The net's train step (``train_step`` on its ``_train_body``)
    wrapped by ``recompile.instrument`` as ``"<facade>.<kind>"``: kind
    ``train_step`` for ``fit``, ``scanned_step`` for ``fit_scanned``
    (the reference's ``sequential.py:317,343``, ``graph.py:599,625``).
    Made at its first use, so its detector counts into the registry
    current then; on the card it counts captures, so it reads 1 after
    the warm-up however many steps follow: the net's ``StepGraphs``
    counters say whether a call captured or replayed."""
    steps = net.__dict__.setdefault("_instrumented", {})
    fn = steps.get(kind)
    if fn is None:
        fn = steps[kind] = instrument(
            lambda inputs: train_step(net, net._train_body, inputs),
            f"{type(net).__name__}.{kind}",
            graphs=lambda: (cap.step_graphs(net) if cap.captures(net)
                            else None))
    return fn


def notify_listeners(model, batch_size=None) -> None:
    """Fire ``iteration_done`` on the model's listeners, first wiring the
    actual minibatch size into any listener that wants it (reference
    ``models/common.py:39``).  Also mirrors it as
    ``model.last_batch_size``.  Runs on the host after the step's
    replay; nothing here reads the device."""
    if batch_size is not None:
        model.last_batch_size = int(batch_size)
    for lst in getattr(model, "listeners", ()):
        if batch_size is not None:
            setter = getattr(lst, "set_batch_size", None)
            if setter is not None:
                setter(int(batch_size))
        lst.iteration_done(model, model.iteration)


def batch_rows(x):
    """The batch size of a batch's features (an array, a tensor or a
    dict of them by input name), or None."""
    if isinstance(x, dict):
        x = next(iter(x.values()), None)
    shape = getattr(x, "shape", None)
    return int(shape[0]) if shape else None


def fit_tbptt(net, t_len: int, batch: int, window, run) -> None:
    """Truncated BPTT over one batch of ``t_len`` timesteps (reference
    ``doTruncatedBPTT``, ``sequential.py:620``, ``graph.py:907``): windows
    of ``conf.tbptt_fwd_length`` (the last one shorter where ``t_len``
    is not a multiple; the reference reads only the forward length), each
    one step and one ``iteration``, so learning-rate schedules and bias
    corrections count windows.  ``window(sl)`` gives the inputs of the
    time slice ``sl`` for the facade's step (``net._step``, which returns
    (loss, carries) for a window).  The first window starts from zero
    carries (the reference's ``h0``/``c0``), each later one from the
    carries the one before left, detached: its backward pass stops at
    the window's start.  ``run(fn)`` runs each window's step (the
    resilience scope, ``FitResilience.step``: a retry is a window's)."""
    length = net.conf.tbptt_fwd_length
    carries = initial_carries(net._named_layers(), batch,
                              net.conf.compute_dtype, net.device)
    for t0 in range(0, t_len, length):
        inputs = window(slice(t0, min(t0 + length, t_len)))

        def one(inputs=inputs, carries=carries):
            return net._step({**inputs, "carries": carries})

        carries = run(one)[1]


def solver(net) -> bool:
    """Whether ``net`` trains through a full-batch solver (LineGD, CG,
    L-BFGS: ``optimize/solvers.py``) rather than the SGD step."""
    return net.conf.optimization_algo != "stochastic_gradient_descent"


def fit_solver(net, loss_fn, inputs) -> None:
    """One batch of a solver fit (reference ``_fit_solver``,
    ``sequential.py:570-589``, ``graph.py:962``): ``conf.num_iterations``
    iterations of ``conf.optimization_algo`` over the full batch
    (``inputs``, by the names ``loss_fn(params, key, **inputs)``
    takes)."""
    from deeplearning4j_tpu_torch.optimize import solvers

    solvers.fit_model_with_solver(net, loss_fn, inputs,
                                  net.conf.optimization_algo,
                                  net.conf.num_iterations)


def pretrainable(layer) -> bool:
    return isinstance(layer, (AutoEncoder, RBM))


def pretrain_layer(net, name: str, layer, feed, batches,
                   epochs: int) -> None:
    """Layerwise pretraining of one AutoEncoder or RBM (reference
    ``sequential.py:772-809``, ``graph.py:1160-1197``): for ``epochs``
    passes over ``batches`` (each the features in the structure ``feed``
    takes), ``feed(**batch)`` gives the layer's input (the layers before
    it in test mode, outside autograd), and the layer's parameters take
    one plain step ``p - lr · grad`` of its ``pretrain_loss``, in place:
    ``lr`` the layer's learning rate, else the updater's; no updater
    state, regularization or listeners, as in the reference.  Each batch
    takes one key from the net's stream.  On the card a batch is a
    replay of the layer's captured program for the batch's signature:
    the features staged from the pinned ring, the key a device key the
    host rewrites."""
    lr = layer.learning_rate or net.conf.updater.learning_rate

    def body(key, scalars=None, **batch):
        h = feed(**batch)
        params = net.params[name]
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        try:
            loss = layer.pretrain_loss(params, h, key)
            grads = torch.autograd.grad(loss, leaves)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        with torch.no_grad():
            for p, g in zip(leaves, grads):
                p.sub_(g * lr)
        return loss.detach()

    graphs = cap.step_graphs(net) if cap.captures(net) else None
    for _ in range(epochs):
        for batch in batches:
            seed = rng_mod.seed_of(net._keys.next())
            if graphs is None:
                body(rng_mod.device_key(seed, net.device),
                     **_on(batch, net.device))
                continue
            staged = tree_map(cap.host_or_device, batch)
            prog = graphs.program("pretrain", body, staged, variant=name)
            graphs.stage(prog, staged, seed)
            graphs.run(prog)


def fit_loop(net, component: str, batches, *, epochs: int, unpack,
             batch_adv, fit_one, checkpoint_manager=None,
             retry_policy=None) -> None:
    """Both facades' ``fit`` over ``batches`` for ``epochs`` passes, with
    the reference's resilience and stability duties (``_fit_batches``,
    ``sequential.py:513-560``): with ``checkpoint_manager=`` the net
    resumes from its newest committed checkpoint ahead of it (written
    into its tensors in place) and the batches that checkpoint covers
    are skipped (``batch_adv(x)``: the iterations a batch advances);
    before each batch a preemption request commits a priority checkpoint
    and stops the fit cleanly; ``fit_one(x, y, fmask, lmask, run)`` runs
    the batch's SGD steps, each through ``run`` (the retry and fault scope
    with the key stream set back, or a plain call); after it the manager
    saves when a trigger is due, and the stability runtime polls every
    ``check_every`` batches.  Under a full-batch solver each batch is one
    solve (``net._fit_solver``) in that same scope instead.  Each step
    runs inside ``step_guard("fit_step")``
    (flight events, the watchdog, an installed ``StepProfiler``'s frame;
    the profiler also tracks the net for memory attribution), is timed
    on the host around its replay (``fit_telemetry``: ``last_step_seconds`` and
    ``last_samples_per_second`` stamped on the net, the score gauge
    holding the device loss, so no sync) and then the net's listeners
    run (``notify_listeners``).  An exception leaves a flight-recorder
    report (``crash_dump``); the stability runtime's final harvest runs
    in every case."""
    check_trainable(net)
    res = None
    if checkpoint_manager is not None or retry_policy is not None:
        res = FitResilience(component, checkpoint_manager, retry_policy,
                            net=net)
    policy = stability.policy_of(net.conf)
    rt = None
    if policy is not None:
        rt = getattr(net, "_stab_rt", None)
        created = rt is None
        if created:
            rt = net._stab_rt = stability.StabilityRuntime(component,
                                                           policy)
        if created or (res is not None and res.resumed_from is not None):
            # a restored nonfinite_total is history, not fresh evidence
            rt.baseline_from(net.updater_state.get(stability.STATE_KEY))

    prof = profiling.active_profiler()
    if prof is not None:
        prof.track_model(net, component)
    tel = fit_telemetry(component)
    rows = [None]

    def run(fn):
        t0 = time.perf_counter()
        with step_guard("fit_step", model=component,
                        iteration=net.iteration), tel.span(net.iteration):
            out = fn() if res is None else res.step(fn, net.iteration,
                                                    net=net)
        tel.record_step(time.perf_counter() - t0, rows[0], net._score,
                        model=net)
        notify_listeners(net, rows[0])
        return out

    def fit_batch(x, y, fm, lm):
        if solver(net):
            # one solve a batch, through the same scope as a step; the
            # solve advances the iteration once, after it ends
            run(lambda: net._fit_solver(x, y, fm, lm))
        else:
            fit_one(x, y, fm, lm, run)

    try:
        for _ in range(epochs):
            for batch in batches:
                x, y, fm, lm = unpack(batch)
                rows[0] = batch_rows(x)
                if res is not None and res.skip_window(
                        1 if solver(net) else batch_adv(x)):
                    continue
                if preemption_requested():
                    if res is not None:
                        res.on_preempt(net)
                    return
                fit_batch(x, y, fm, lm)
                if res is not None:
                    res.after_step(net)
                if rt is not None:
                    rt.poll_net(net, res)
    except Exception as e:
        crash_dump("fit_exception", model=component,
                   iteration=net.iteration, error=repr(e))
        raise
    finally:
        if rt is not None:
            rt.flush(net)


def infer(net, body, inputs):
    """``body(**inputs)`` at inference: a captured graph's replay on the
    card (a copy of its output to the caller), eagerly otherwise."""
    if cap.captures(net):
        graphs = cap.step_graphs(net)
        inputs = tree_map(cap.host_or_device, inputs)
        prog = graphs.program("output", body, inputs)
        graphs.stage(prog, inputs)
        out = graphs.run(prog)
        return ([o.clone() for o in out] if isinstance(out, list)
                else out.clone())
    with torch.no_grad():
        return body(**_on(inputs, net.device), key=None, scalars=None)


def check_scannable(net, scan_steps: int) -> None:
    """``fit_scanned``'s guards (reference ``sequential.py:356-368``)."""
    conf = net.conf
    if scan_steps < 1:
        raise ValueError(f"scan_steps={scan_steps} must be >= 1")
    if conf.optimization_algo != "stochastic_gradient_descent":
        raise ValueError("fit_scanned requires SGD optimization")
    if conf.backprop_type == "truncated_bptt":
        raise ValueError("fit_scanned does not support TBPTT")
    if conf.num_iterations != 1:
        # fit() repeats each batch num_iterations times; a window runs
        # each batch once
        raise ValueError("fit_scanned requires num_iterations == 1 "
                         f"(got {conf.num_iterations})")
    check_trainable(net)


def fit_scanned(net, batches, scan_steps: int, epochs: int, unpack,
                one_step) -> None:
    """Consecutive same-shape batches in windows of ``scan_steps``
    (reference ``fit_scanned``): ``unpack(batch) -> (inputs dict,
    fmask, lmask)``; a mask raises before its window runs, a shape change
    closes the window, and each batch of a window runs through
    ``one_step(inputs)``, the per-batch step (a replay of the captured
    step on the card): the same updates and key stream as ``fit``.  The
    telemetry and the listeners run once a window (reference
    ``_flush_window``)."""
    check_scannable(net, scan_steps)

    def shapes(inputs):
        return [(path, np.shape(t)) for path, t in tree_paths(inputs)]

    component = type(net).__name__
    prof = profiling.active_profiler()
    if prof is not None:
        prof.track_model(net, component)
    tel = fit_telemetry(component)

    def flush(window):
        if not window:
            return
        t0 = time.perf_counter()
        with step_guard("fit_window", model=component,
                        iteration=net.iteration, steps=len(window)), \
                tel.span(net.iteration):
            for inputs in window:
                one_step(inputs)
        rows = batch_rows(next(iter(window[0].values())))
        tel.record_step(time.perf_counter() - t0, rows, net._score,
                        steps=len(window), model=net)
        # listeners fire once per window, with the window's samples
        notify_listeners(net, None if rows is None else rows * len(window))
        window.clear()

    for _ in range(epochs):
        window = []
        for batch in batches:
            inputs, fm, lm = unpack(batch)
            if fm is not None or lm is not None:
                raise ValueError("fit_scanned does not support masks")
            if window and shapes(inputs) != shapes(window[0]):
                flush(window)
            window.append(inputs)
            if len(window) == scan_steps:
                flush(window)
        flush(window)


def unpack_batch(batch):
    """(features, labels, features mask, labels mask) of a (x, y) or
    (x, y, fmask, lmask) tuple or of a DataSet-like object."""
    if isinstance(batch, (tuple, list)):
        if len(batch) == 2:
            return batch[0], batch[1], None, None
        if len(batch) == 4:
            return tuple(batch)
    if hasattr(batch, "features"):
        return (batch.features, batch.labels,
                getattr(batch, "features_mask", None),
                getattr(batch, "labels_mask", None))
    raise ValueError(f"Cannot unpack batch of type {type(batch)}")
