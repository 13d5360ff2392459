"""MultiLayerNetwork — counterpart of ``deeplearning4j_tpu/models/sequential.py``.

Ported: ``init``, the forward with input preprocessors, carries and
layer state (``_forward``), ``output`` (with a features mask),
``feed_forward``, ``num_params``, the flat parameter vector
(``params_to_vector``/``set_params_vector``), ``clone``, and training:
``_loss_fn`` (data loss + regularization, and the new layer state), the
train step (loss -> autograd -> updater -> parameter update -> new
state), ``fit`` over an (X, y) pair or an iterable of batches, ``score``
and the lazy ``score_value``.  Params live in a nested dict
``{layer name: {param name: tensor}}`` with the reference's names and
layouts, on ``self.device``; ``updater_state`` holds the updater's trees
of the same shape, and ``net_state`` the float32 state of stateful layers
(BatchNorm's running mean and var), which a train step replaces.  With a ``compute_dtype`` the forward casts the
float32 params to that type inside the differentiated graph, so the
gradients land on the float32 params, and the loss runs in float32 — the
reference's mixed-precision policy.

Not ported yet (later slices): TBPTT, the full-batch solvers,
``checkpoint_manager``/``retry_policy``, fit telemetry, and the
stability, introspection and numerics engines; ``fit_scanned``,
``rnn_time_step``, ``pretrain``, ``set_listeners``, ``add_listener`` and
``evaluate`` raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.backend import rng as rng_mod
from deeplearning4j_tpu_torch.backend.device import (
    DeviceLike, compute_dtype, resolve_device,
)
from deeplearning4j_tpu_torch.backend.rng import KeyStream
from deeplearning4j_tpu_torch.models.common import (  # noqa: F401 (re-exported)
    FlatParamsMixin, LazyScoreMixin, _tree_like, cast_tree, check_trainable,
    not_ported, sgd_step, trainable, tree_leaves, unpack_batch,
)
from deeplearning4j_tpu_torch.nn import activations, losses
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.layers.base import Layer
from deeplearning4j_tpu_torch.nn.layers.dense import OutputLayer
from deeplearning4j_tpu_torch.optimize import updaters as upd


def init_net_state(layers, device, dtype):
    """{layer name: state} of the stateful layers, in ``dtype`` (the
    reference casts state to the init dtype)."""
    state = {}
    for layer in layers:
        st = layer.init_state(device)
        if st:
            state[layer.name] = cast_tree(st, dtype)
    return state


class MultiLayerNetwork(FlatParamsMixin, LazyScoreMixin):
    def __init__(self, conf: MultiLayerConfiguration):
        self.conf = conf
        self.layers: Tuple[Layer, ...] = conf.layers
        self.params: Dict[str, Dict[str, Any]] = {}
        self.net_state: Dict[str, Dict[str, torch.Tensor]] = {}
        self.updater_state: Dict[str, Any] = {}
        self.device: Optional[torch.device] = None
        self.iteration = 0
        self._keys = KeyStream(conf.seed)

    def init(self, device: DeviceLike = None,
             dtype=torch.float32) -> "MultiLayerNetwork":
        """Seeded parameters on ``device`` (``cuda`` unless told
        otherwise), the layers' initial state and a zero updater state."""
        dev = resolve_device(device)
        self.params = {
            layer.name: (layer.init(self._keys.next(), dtype, dev)
                         if layer.has_params() else {})
            for layer in self.layers}
        self.net_state = init_net_state(self.layers, dev, dtype)
        self.device = dev
        self.updater_state = upd.init_state(self.conf.updater,
                                            self._trainable(self.params))
        return self

    _trainable = staticmethod(trainable)

    def compute_params(self):
        """The params as the forward uses them: cast to the compute dtype
        (the same tensors when there is none)."""
        return cast_tree(self.params, compute_dtype(self.conf.compute_dtype))

    # --------------------------------------------------------------- forward
    def _forward(self, params, x, *, train=False, rng=None, fmask=None,
                 carries=None, net_state=None, collect=None):
        """Forward through every layer, each after its input preprocessor
        (``conf.preprocessors``); the output layer stops at its
        pre-activation (after its input dropout).  Carry-capable layers
        (attention, residual blocks) take their carry from ``carries`` by
        layer name; stateful layers (BatchNorm) their state from
        ``net_state`` (``self.net_state`` when None).  ``rng`` (the step's
        key) splits into one key per layer.  With a list as ``collect``,
        each layer's output is appended to it.  Returns (pre_output,
        new_carries, new_net_state)."""
        state = self.net_state if net_state is None else net_state
        cd = self.conf.compute_dtype
        if cd is not None:
            # the cast sits inside the graph: grads reach the f32 params;
            # the layer state stays float32, as in the reference
            dt = compute_dtype(cd)
            params = cast_tree(params, dt)
            x = cast_tree(x, dt)
        n = len(self.layers)
        rngs = rng_mod.split(rng, n) if rng is not None else [None] * n
        new_carries, new_state = {}, dict(state)
        h = x
        pre = self.conf.preprocessors
        for i, layer in enumerate(self.layers):
            if i in pre:
                h = pre[i](h)
            p = params[layer.name]
            if hasattr(layer, "apply_with_carry"):
                h, nc = layer.apply_with_carry(
                    p, h, (carries or {}).get(layer.name), train=train,
                    rng=rngs[i], mask=fmask)
                new_carries[layer.name] = nc
            elif isinstance(layer, OutputLayer):
                h = layer.maybe_dropout(h, train=train, rng=rngs[i])
                h = layer.pre_output(p, h)
            elif hasattr(layer, "apply_with_state"):
                h, new_state[layer.name] = layer.apply_with_state(
                    p, state.get(layer.name, {}), h, train=train,
                    rng=rngs[i])
            else:
                kw = {"mask": fmask} if layer._TAKES_MASK else {}
                h = layer.apply(p, h, train=train, rng=rngs[i], **kw)
            if collect is not None:
                collect.append(h)
        return h, new_carries, new_state

    def output(self, x, fmask=None) -> torch.Tensor:
        """Inference forward, masked by ``fmask`` where given; float32 at
        the API boundary."""
        x = torch.as_tensor(x, device=self.device)
        with torch.no_grad():
            pre, _, _ = self._forward(self.params, x,
                                      fmask=self._as_device(fmask))
            return activations.get(self.layers[-1].activation)(pre.float())

    def feed_forward(self, x, train: bool = False):
        """Every layer's activation, in order (the output layer's is its
        pre-activation, as in the reference); float32 at the API boundary
        under a compute dtype."""
        rng = self._keys.next() if train else None
        acts = []
        with torch.no_grad():
            self._forward(self.params, torch.as_tensor(x, device=self.device),
                          train=train, rng=rng, collect=acts)
        if self.conf.compute_dtype is not None:
            acts = [a.float() for a in acts]
        return acts

    # ----------------------------------------------------------------- score
    def _loss_fn(self, params, x, y, rng=None, fmask=None, lmask=None, *,
                 train=True, net_state=None):
        """(data loss (float32 under a compute dtype) + regularization,
        the new layer state)."""
        out_layer = self.layers[-1]
        if not isinstance(out_layer, OutputLayer):
            raise ValueError(
                "Last layer must be an OutputLayer/RnnOutputLayer for fit()")
        pre, _, new_state = self._forward(params, x, train=train, rng=rng,
                                          fmask=fmask, net_state=net_state)
        if self.conf.compute_dtype is not None:
            pre = pre.float()
        data = losses.score(out_layer.loss, y.to(pre.dtype), pre,
                            out_layer.activation, lmask)
        reg = sum(layer.reg_score(params[layer.name])
                  for layer in self.layers if layer.has_params())
        return data + reg, new_state

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
            loss, _ = self._loss_fn(
                self.params, self._as_device(x), self._as_device(y), None,
                self._as_device(fmask), self._as_device(lmask), train=False)
        return float(loss)

    # ------------------------------------------------------------ train step
    def _check_trainable(self) -> None:
        check_trainable(self)

    def _train_step(self, x, y, rng, fmask, lmask) -> torch.Tensor:
        """One SGD step (``common.sgd_step``); the loss as a device
        scalar."""
        return sgd_step(self, lambda params: self._loss_fn(
            params, x, y, rng, fmask, lmask, train=True))

    def _one_step(self, x, y, fmask, lmask) -> None:
        rng = self._keys.next()
        loss = self._train_step(
            self._as_device(x), self._as_device(y), rng,
            self._as_device(fmask), self._as_device(lmask))
        self.score_value = loss  # device scalar; fetched lazily on read
        self.iteration += 1

    _unpack = staticmethod(unpack_batch)

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

    # --------------------------------------------------------- not ported
    def fit_scanned(self, *args, **kwargs):
        not_ported("MultiLayerNetwork", "fit_scanned", "PyTorch runs "
                   "eagerly; CUDA-graph capture of the step is its "
                   "counterpart, ROADMAP A2 and C1")

    def rnn_time_step(self, *args, **kwargs):
        not_ported("MultiLayerNetwork", "rnn_time_step",
                   "the recurrent slice, ROADMAP A6")

    def pretrain(self, *args, **kwargs):
        not_ported("MultiLayerNetwork", "pretrain",
                   "AutoEncoder/RBM, ROADMAP A7")

    def set_listeners(self, *listeners):
        not_ported("MultiLayerNetwork", "set_listeners",
                   "listeners, ROADMAP A8")

    def add_listener(self, listener):
        not_ported("MultiLayerNetwork", "add_listener",
                   "listeners, ROADMAP A8")

    def evaluate(self, *args, **kwargs):
        not_ported("MultiLayerNetwork", "evaluate",
                   "evaluation/, ROADMAP A8")

    # ----------------------------------------------------------- checkpoints
    def save(self, path, save_updater: bool = True) -> None:
        from deeplearning4j_tpu_torch.models import serialization

        serialization.write_model(self, path, save_updater=save_updater)

    @staticmethod
    def load(path, device: DeviceLike = None) -> "MultiLayerNetwork":
        from deeplearning4j_tpu_torch.models import serialization

        return serialization.restore_multi_layer_network(path, device)
