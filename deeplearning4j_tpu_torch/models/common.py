"""What both facades share — counterpart of
``deeplearning4j_tpu/models/common.py``: nested-dict tree helpers, the
lazy ``score_value``, the flat parameter vector and ``clone``, the checks
before training, the train step split into its host part
(``train_step``: the step's key seed and updater scalars, then a
captured graph's replay on the card or the body eagerly) and its device
body (``sgd_step``: loss -> autograd -> updater -> in-place update ->
layer state copied in place), ``infer`` for ``output``, the
``fit_scanned`` windows, TBPTT's window loop (``fit_tbptt``), the stream
caches and recurrent carries of ``rnn_time_step`` and ``generate``
(seeding, the host-side capacity check) and the raise for what is not
ported yet."""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.backend import rng as rng_mod
from deeplearning4j_tpu_torch.backend.device import compute_dtype
from deeplearning4j_tpu_torch.models import capture as cap
from deeplearning4j_tpu_torch.nn.layers.attention import SelfAttentionLayer
from deeplearning4j_tpu_torch.optimize import updaters as upd


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


def not_ported(facade: str, what: str, where: str):
    raise NotImplementedError(f"{facade}.{what} is not ported yet ({where})")


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
    """Raise for what ``fit`` does not run yet in the port."""
    conf = net.conf
    for name, what in (("stability", "the stability guard and loss "
                        "scaling"),
                       ("introspection", "training introspection"),
                       ("numerics", "the numerics ledger")):
        if getattr(conf, name) is not None:
            raise NotImplementedError(
                f"conf.{name} is set: {what} is not ported yet (it comes "
                "with the resilience and observability slice, ROADMAP A9)")
    if conf.optimization_algo != "stochastic_gradient_descent":
        raise NotImplementedError(
            f"optimization_algo={conf.optimization_algo!r}: the full-batch "
            "solvers are not ported yet (ROADMAP A8)")
    if net.device is None:
        raise RuntimeError("call init() (or load a model) before fit()")


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


def sgd_step(net, loss_of, scalars, carries=None) -> torch.Tensor:
    """The device body of one step of ``net``: ``loss_of(params) ->
    (loss, new_net_state)``, gradients of the trainable leaves, the
    updater (``scalars``: ``updaters.step_scalars``' values as 0-d
    tensors), the update subtracted in place, and the new updater and
    layer state copied into the old tensors.  With ``carries`` (a TBPTT
    window's {layer: (h, c)}), ``loss_of`` also returns the new carries,
    which are written into ``carries``' tensors once the gradients are
    taken: the backward pass reads the old ones, which autograd saved.
    Returns the loss as a device scalar (no host sync)."""
    train = trainable(net.params)
    leaves = tree_leaves(train)
    for p in leaves:
        p.requires_grad_(True)
    try:
        out = loss_of(net.params)
        loss, new_state = out[0], out[1]
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    grads = _tree_like(train, [torch.zeros_like(p) if g is None else g
                               for p, g in zip(leaves, grads)])
    with torch.no_grad():
        updates, new_ustate = upd.update(
            net.conf.updater, grads, net.updater_state, net.iteration,
            params=train, scalars=scalars)
        upd.apply_updates_(net.params, updates)
        copy_tree_(net.updater_state, new_ustate)
        copy_tree_(net.net_state, new_state)
        if carries is not None:
            advance_carries_(carries, {k: out[2][k] for k in carries})
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
    seed = rng_mod.seed_of(net._keys.next())
    vals = _step_scalars(net, net.iteration)
    dtype = _scalar_dtype(net)

    def record(out):
        loss = out[0] if isinstance(out, tuple) else out
        net.score_value = loss.clone()   # fetched lazily on read
        net.iteration += 1

    if cap.captures(net):
        graphs = cap.step_graphs(net)
        inputs = tree_map(cap.host_or_device, inputs)
        prog = graphs.program("train", body, inputs, len(vals), dtype)
        prog.scalar_names = list(vals)
        graphs.stage(prog, inputs, seed, list(vals.values()))
        return graphs.run(prog, record)
    dev = net.device
    sc = torch.tensor(list(vals.values()), dtype=dtype, device=dev)
    out = body(**_on(inputs, dev), key=rng_mod.device_key(seed, dev),
               scalars=dict(zip(vals, sc.unbind(0))))
    record(out)
    return out


def fit_tbptt(net, t_len: int, batch: int, window) -> None:
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
    the window's start."""
    length = net.conf.tbptt_fwd_length
    carries = initial_carries(net._named_layers(), batch,
                              net.conf.compute_dtype, net.device)
    for t0 in range(0, t_len, length):
        inputs = window(slice(t0, min(t0 + length, t_len)))
        carries = net._step({**inputs, "carries": carries})[1]


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
    step on the card): the same updates and key stream as ``fit``."""
    check_scannable(net, scan_steps)

    def shapes(inputs):
        return [(path, np.shape(t)) for path, t in tree_paths(inputs)]

    def flush(window):
        for inputs in window:
            one_step(inputs)
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
