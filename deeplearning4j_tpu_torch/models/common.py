"""What both facades share — counterpart of
``deeplearning4j_tpu/models/common.py``: nested-dict tree helpers, the
lazy ``score_value``, the flat parameter vector and ``clone``, the checks
before training, the SGD step (loss -> autograd -> updater -> in-place
update -> new layer state) and the raise for what is not ported yet."""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.optimize import updaters as upd


def cast_tree(tree, dtype: torch.dtype):
    """Cast every floating tensor of a nested dict to ``dtype`` (a tensor
    already in ``dtype`` is returned as it is, not copied)."""
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype) for k, v in tree.items()}
    if torch.is_tensor(tree) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


def tree_leaves(tree):
    """The tensors of a nested dict, in sorted-key order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


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


class FlatParamsMixin:
    """``num_params``, the flat parameter vector and ``clone`` of a facade
    whose ``params`` is a nested dict (reference ``sequential.py:100-122``,
    ``graph.py:368-385``).  The vector's order is ``tree_leaves``'s, sorted
    keys at every level as in ``jax.tree_util.tree_leaves``, so a port
    vector and a JAX vector of the same weights are equal element for
    element."""

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
    if conf.backprop_type == "truncated_bptt":
        raise NotImplementedError(
            "truncated BPTT is not ported yet (the recurrent slice, "
            "ROADMAP A6)")
    if conf.optimization_algo != "stochastic_gradient_descent":
        raise NotImplementedError(
            f"optimization_algo={conf.optimization_algo!r}: the full-batch "
            "solvers are not ported yet (ROADMAP A8)")
    if net.device is None:
        raise RuntimeError("call init() (or load a model) before fit()")


def sgd_step(net, loss_of) -> torch.Tensor:
    """One step of ``net``: ``loss_of(params) -> (loss, new_net_state)``,
    gradients of the trainable leaves, the updater (with each layer's
    ``learning_rate`` override), the update applied in place, and the new
    layer state written back.  Returns the loss as a device scalar (no
    host sync)."""
    train = trainable(net.params)
    leaves = tree_leaves(train)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss, new_state = loss_of(net.params)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    grads = _tree_like(train, [torch.zeros_like(p) if g is None else g
                               for p, g in zip(leaves, grads)])
    lr_overrides = {l.name: l.learning_rate for l in net.layers
                    if l.learning_rate is not None}
    with torch.no_grad():
        updates, net.updater_state = upd.update(
            net.conf.updater, grads, net.updater_state, net.iteration,
            lr_overrides, params=train)
        upd.apply_updates_(net.params, updates)
    net.net_state = new_state
    return loss.detach()


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
