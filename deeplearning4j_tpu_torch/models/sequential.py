"""MultiLayerNetwork — counterpart of ``deeplearning4j_tpu/models/sequential.py``.

Ported: ``init``, the forward with carries (``_forward``), ``output``,
and training: ``_loss_fn`` (data loss + regularization), the train step
(loss -> autograd -> updater -> parameter update), ``fit`` over an
(X, y) pair or an iterable of batches, ``score`` and the lazy
``score_value``.  Params live in a nested dict
``{layer name: {param name: tensor}}`` with the reference's names and
layouts, on ``self.device``; ``updater_state`` holds the updater's trees
of the same shape.  With a ``compute_dtype`` the forward casts the
float32 params to that type inside the differentiated graph, so the
gradients land on the float32 params, and the loss runs in float32 — the
reference's mixed-precision policy.

Not ported yet (later slices): TBPTT, the full-batch solvers,
``fit_scanned``, ``checkpoint_manager``/``retry_policy``, listeners and
fit telemetry, and the stability, introspection and numerics engines.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.backend import rng as rng_mod
from deeplearning4j_tpu_torch.backend.device import (
    DeviceLike, compute_dtype, resolve_device,
)
from deeplearning4j_tpu_torch.backend.rng import KeyStream
from deeplearning4j_tpu_torch.nn import activations, losses
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.layers.base import Layer
from deeplearning4j_tpu_torch.nn.layers.dense import OutputLayer
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


class MultiLayerNetwork:
    def __init__(self, conf: MultiLayerConfiguration):
        self.conf = conf
        self.layers: Tuple[Layer, ...] = conf.layers
        self.params: Dict[str, Dict[str, Any]] = {}
        self.updater_state: Dict[str, Any] = {}
        self.device: Optional[torch.device] = None
        self.iteration = 0
        self._score = None
        self._keys = KeyStream(conf.seed)

    def init(self, device: DeviceLike = None,
             dtype=torch.float32) -> "MultiLayerNetwork":
        """Seeded parameters on ``device`` (``cuda`` unless told
        otherwise) and a zero updater state."""
        dev = resolve_device(device)
        self.params = {
            layer.name: (layer.init(self._keys.next(), dtype, dev)
                         if layer.has_params() else {})
            for layer in self.layers}
        self.device = dev
        self.updater_state = upd.init_state(self.conf.updater,
                                            self._trainable(self.params))
        return self

    @staticmethod
    def _trainable(params):
        return {k: v for k, v in params.items() if v}

    def compute_params(self):
        """The params as the forward uses them: cast to the compute dtype
        (the same tensors when there is none)."""
        return cast_tree(self.params, compute_dtype(self.conf.compute_dtype))

    # --------------------------------------------------------------- forward
    def _forward(self, params, x, *, train=False, rng=None, fmask=None,
                 carries=None):
        """Forward through every layer; the output layer stops at its
        pre-activation (after its input dropout).  Carry-capable layers
        (attention, residual blocks) take their carry from ``carries`` by
        layer name.  ``rng`` (the step's key) splits into one key per
        layer.  Returns (pre_output, new_carries)."""
        cd = self.conf.compute_dtype
        if cd is not None:
            # the cast sits inside the graph: grads reach the f32 params
            dt = compute_dtype(cd)
            params = cast_tree(params, dt)
            x = cast_tree(x, dt)
        n = len(self.layers)
        rngs = rng_mod.split(rng, n) if rng is not None else [None] * n
        new_carries = {}
        h = x
        for i, layer in enumerate(self.layers):
            p = params[layer.name]
            if hasattr(layer, "apply_with_carry"):
                h, nc = layer.apply_with_carry(
                    p, h, (carries or {}).get(layer.name), train=train,
                    rng=rngs[i], mask=fmask)
                new_carries[layer.name] = nc
            elif isinstance(layer, OutputLayer):
                h = layer.maybe_dropout(h, train=train, rng=rngs[i])
                h = layer.pre_output(p, h)
            else:
                h = layer.apply(p, h, train=train, rng=rngs[i])
        return h, new_carries

    def output(self, x) -> torch.Tensor:
        """Inference forward; float32 at the API boundary."""
        x = torch.as_tensor(x, device=self.device)
        with torch.no_grad():
            pre, _ = self._forward(self.params, x)
            return activations.get(self.layers[-1].activation)(pre.float())

    # ----------------------------------------------------------------- score
    def _loss_fn(self, params, x, y, rng=None, fmask=None, lmask=None, *,
                 train=True):
        """Data loss (float32 under a compute dtype) + regularization."""
        out_layer = self.layers[-1]
        if not isinstance(out_layer, OutputLayer):
            raise ValueError(
                "Last layer must be an OutputLayer/RnnOutputLayer for fit()")
        pre, _ = self._forward(params, x, train=train, rng=rng, fmask=fmask)
        if self.conf.compute_dtype is not None:
            pre = pre.float()
        data = losses.score(out_layer.loss, y.to(pre.dtype), pre,
                            out_layer.activation, lmask)
        reg = sum(layer.reg_score(params[layer.name])
                  for layer in self.layers if layer.has_params())
        return data + reg

    @property
    def score_value(self) -> float:
        """The last step's loss.  The step keeps it on the device; the
        copy to the host (and its sync) happens here, on first read."""
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

    def _as_device(self, a):
        return None if a is None else torch.as_tensor(a, device=self.device)

    def score(self, x=None, y=None, dataset=None, fmask=None,
              lmask=None) -> float:
        """Loss of (x, y) at inference (no dropout), as a float."""
        if dataset is not None:
            if hasattr(dataset, "features"):
                x, y = dataset.features, dataset.labels
                fmask = (fmask if fmask is not None
                         else getattr(dataset, "features_mask", None))
                lmask = (lmask if lmask is not None
                         else getattr(dataset, "labels_mask", None))
            else:
                x, y = dataset[0], dataset[1]
        with torch.no_grad():
            loss = self._loss_fn(
                self.params, self._as_device(x), self._as_device(y), None,
                self._as_device(fmask), self._as_device(lmask), train=False)
        return float(loss)

    # ------------------------------------------------------------ train step
    def _check_trainable(self) -> None:
        for name, what in (("stability", "the stability guard and loss "
                            "scaling"),
                           ("introspection", "training introspection"),
                           ("numerics", "the numerics ledger")):
            if getattr(self.conf, name) is not None:
                raise NotImplementedError(
                    f"conf.{name} is set: {what} is not ported yet (it comes "
                    "with the resilience and observability slice, ROADMAP "
                    "A9)")
        if self.conf.backprop_type == "truncated_bptt":
            raise NotImplementedError(
                "truncated BPTT is not ported yet (the recurrent slice, "
                "ROADMAP A6)")
        if self.conf.optimization_algo != "stochastic_gradient_descent":
            raise NotImplementedError(
                f"optimization_algo={self.conf.optimization_algo!r}: the "
                "full-batch solvers are not ported yet (ROADMAP A8)")
        if self.device is None:
            raise RuntimeError("call init() (or load a model) before fit()")

    def _train_step(self, x, y, rng, fmask, lmask) -> torch.Tensor:
        """One SGD step: loss -> grads -> updater -> in-place update.
        Returns the loss as a device scalar (no host sync)."""
        trainable = self._trainable(self.params)
        leaves = tree_leaves(trainable)
        for p in leaves:
            p.requires_grad_(True)
        try:
            loss = self._loss_fn(self.params, x, y, rng, fmask, lmask,
                                 train=True)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        grads = _tree_like(trainable, [
            torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, grads)])
        lr_overrides = {l.name: l.learning_rate for l in self.layers
                        if l.learning_rate is not None}
        with torch.no_grad():
            updates, self.updater_state = upd.update(
                self.conf.updater, grads, self.updater_state, self.iteration,
                lr_overrides, params=trainable)
            upd.apply_updates_(self.params, updates)
        return loss.detach()

    def _one_step(self, x, y, fmask, lmask) -> None:
        rng = self._keys.next()
        loss = self._train_step(
            self._as_device(x), self._as_device(y), rng,
            self._as_device(fmask), self._as_device(lmask))
        self.score_value = loss  # device scalar; fetched lazily on read
        self.iteration += 1

    @staticmethod
    def _unpack(batch):
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

    def fit(self, data, labels=None, *, fmask=None, lmask=None,
            epochs: int = 1) -> "MultiLayerNetwork":
        """Train on one (X, y) pair (``labels`` given) or on an iterable of
        (features, labels[, fmask, lmask]) batches for ``epochs`` passes;
        each batch is stepped ``conf.num_iterations`` times."""
        self._check_trainable()
        batches = ([(data, labels, fmask, lmask)] if labels is not None
                   else None)
        for _ in range(1 if batches is not None else epochs):
            for batch in (batches if batches is not None else data):
                x, y, fm, lm = self._unpack(batch)
                for _ in range(self.conf.num_iterations):
                    self._one_step(x, y, fm, lm)
        return self

    # ----------------------------------------------------------- checkpoints
    def save(self, path, save_updater: bool = True) -> None:
        from deeplearning4j_tpu_torch.models import serialization

        serialization.write_model(self, path, save_updater=save_updater)

    @staticmethod
    def load(path, device: DeviceLike = None) -> "MultiLayerNetwork":
        from deeplearning4j_tpu_torch.models import serialization

        return serialization.restore_multi_layer_network(path, device)
