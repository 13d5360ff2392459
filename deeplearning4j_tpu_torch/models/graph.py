"""ComputationGraph — counterpart of ``deeplearning4j_tpu/models/graph.py``.

The graph is data: input names, nodes (a layer or a vertex, with the
names of their inputs) and output names, with the reference's JSON.  The
forward is a fold over the topological order; backprop through the DAG
is autograd.  Params live in ``{node name: {param name: tensor}}``, the
state of stateful layers (BatchNorm's running stats, float32) in
``net_state``, on ``self.device``.

Ported: the configuration (JSON round-trip, ``topological_order`` with
its cycle error, ``validate``), ``GraphBuilder`` with size inference
from ``set_input_types``, ``init``, the forward (the compute-dtype cast
inside the graph, one key per node, output nodes stopping at their
pre-output), the loss (float32), the SGD train step with per-layer
learning rates, ``fit`` over a pair, an iterable or a dict of inputs
(with truncated BPTT: windows of every sequence input, label and mask,
the recurrent nodes' carries passed on detached), ``fit_scanned``
(windows of same-shape batches), ``output`` (on the
card ``fit``, ``fit_scanned`` and ``output`` replay captured CUDA
graphs, ``models/capture.py``), ``feed_forward``, ``score``, the lazy
``score_value``,
``num_params``, the flat parameter vector, ``clone``, YAML as well as
JSON, ``save``/``load``, and streaming inference over attention and
recurrent nodes (``rnn_time_step``, ``rnn_clear_previous_state``:
carries flow through the forward).  What else the reference's graph does raises
``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.backend import rng as rng_mod
from deeplearning4j_tpu_torch.backend.device import (
    DeviceLike, compute_dtype, resolve_device,
)
from deeplearning4j_tpu_torch.backend.rng import KeyStream
from deeplearning4j_tpu_torch.models import common
from deeplearning4j_tpu_torch.models.common import (
    FlatParamsMixin, LazyScoreMixin, cast_tree, check_cache_capacity,
    check_trainable, infer, not_ported, seed_stream_caches, sgd_step,
    train_step, trainable, unpack_batch,
)
from deeplearning4j_tpu_torch.models.sequential import init_net_state
from deeplearning4j_tpu_torch.models.vertices import (
    GraphVertex, vertex_from_dict,
)
from deeplearning4j_tpu_torch.nn import activations, losses
from deeplearning4j_tpu_torch.nn.conf import _COMPUTE_DTYPES, UpdaterConfig
from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import Layer, layer_from_dict
from deeplearning4j_tpu_torch.nn.layers.dense import (
    EmbeddingLayer, OutputLayer,
)
from deeplearning4j_tpu_torch.optimize import updaters as upd


@dataclasses.dataclass(frozen=True)
class GraphNode:
    name: str
    inputs: Tuple[str, ...]
    layer: Optional[Layer] = None          # layer vertex
    vertex: Optional[GraphVertex] = None   # function vertex

    def to_dict(self):
        return {"name": self.name, "inputs": list(self.inputs),
                "layer": self.layer.to_dict() if self.layer else None,
                "vertex": self.vertex.to_dict() if self.vertex else None}

    @staticmethod
    def from_dict(d):
        return GraphNode(
            name=d["name"], inputs=tuple(d["inputs"]),
            layer=layer_from_dict(d["layer"]) if d.get("layer") else None,
            vertex=(vertex_from_dict(d["vertex"]) if d.get("vertex")
                    else None))


@dataclasses.dataclass(frozen=True)
class GraphConfiguration:
    inputs: Tuple[str, ...]
    outputs: Tuple[str, ...]
    nodes: Tuple[GraphNode, ...]           # in insertion order
    updater: UpdaterConfig
    input_types: Optional[Dict[str, dict]] = None
    seed: int = 12345
    backprop_type: str = "standard"
    tbptt_fwd_length: int = 20
    tbptt_back_length: int = 20
    optimization_algo: str = "stochastic_gradient_descent"
    num_iterations: int = 1
    compute_dtype: Optional[str] = None
    # the reference's training policies, carried as plain dicts (their
    # engines come with ROADMAP A9)
    stability: Optional[dict] = None
    introspection: Optional[dict] = None
    numerics: Optional[dict] = None

    def __post_init__(self):
        if self.compute_dtype not in _COMPUTE_DTYPES:
            raise ValueError(
                f"unsupported compute_dtype '{self.compute_dtype}' "
                "(use 'bfloat16', 'float16', or None)")

    def topological_order(self) -> List[str]:
        """Kahn's algorithm over the DAG, in insertion order among
        ready nodes (the reference's order)."""
        indeg = {n.name: 0 for n in self.nodes}
        children: Dict[str, List[str]] = {
            name: [] for name in list(self.inputs)
            + [n.name for n in self.nodes]}
        for n in self.nodes:
            for inp in n.inputs:
                if inp not in children:
                    raise ValueError(f"Vertex '{n.name}' references unknown "
                                     f"input '{inp}'")
                children[inp].append(n.name)
                if inp not in self.inputs:
                    indeg[n.name] += 1
        order = []
        queue = [n.name for n in self.nodes if indeg[n.name] == 0]
        while queue:
            v = queue.pop(0)
            order.append(v)
            for c in children.get(v, []):
                indeg[c] -= 1
                if indeg[c] == 0:
                    queue.append(c)
        if len(order) != len(self.nodes):
            raise ValueError("Graph has a cycle")
        return order

    def validate(self):
        by_name = {n.name: n for n in self.nodes}
        for out in self.outputs:
            if out not in by_name:
                raise ValueError(f"Output '{out}' is not a vertex")
            node = by_name[out]
            if node.layer is None or not isinstance(node.layer, OutputLayer):
                raise ValueError(
                    f"Output '{out}' must be an OutputLayer/RnnOutputLayer "
                    f"(got {type(node.vertex or node.layer).__name__})")
        self.topological_order()

    def to_json(self) -> str:
        return json.dumps({
            "format_version": 1,
            "inputs": list(self.inputs),
            "outputs": list(self.outputs),
            "nodes": [n.to_dict() for n in self.nodes],
            "updater": self.updater.to_dict(),
            "input_types": self.input_types,
            "seed": self.seed,
            "backprop_type": self.backprop_type,
            "tbptt_fwd_length": self.tbptt_fwd_length,
            "tbptt_back_length": self.tbptt_back_length,
            "optimization_algo": self.optimization_algo,
            "num_iterations": self.num_iterations,
            "compute_dtype": self.compute_dtype,
            "stability": self.stability,
            "introspection": self.introspection,
            "numerics": self.numerics,
        }, indent=2)

    def to_yaml(self) -> str:
        """The JSON's content as YAML (reference ``graph.py:127``)."""
        import yaml

        return yaml.safe_dump(json.loads(self.to_json()), sort_keys=False)

    @staticmethod
    def from_yaml(s: str) -> "GraphConfiguration":
        import yaml

        return GraphConfiguration.from_json(json.dumps(yaml.safe_load(s)))

    @staticmethod
    def from_json(s: str) -> "GraphConfiguration":
        d = json.loads(s)
        return GraphConfiguration(
            inputs=tuple(d["inputs"]),
            outputs=tuple(d["outputs"]),
            nodes=tuple(GraphNode.from_dict(nd) for nd in d["nodes"]),
            updater=UpdaterConfig.from_dict(d["updater"]),
            input_types=d.get("input_types"),
            seed=d["seed"],
            backprop_type=d.get("backprop_type", "standard"),
            tbptt_fwd_length=d.get("tbptt_fwd_length", 20),
            tbptt_back_length=d.get("tbptt_back_length", 20),
            optimization_algo=d.get("optimization_algo",
                                    "stochastic_gradient_descent"),
            num_iterations=d.get("num_iterations", 1),
            compute_dtype=d.get("compute_dtype"),
            stability=d.get("stability"),
            introspection=d.get("introspection"),
            numerics=d.get("numerics"),
        )


class GraphBuilder:
    """Fluent DAG builder (``NeuralNetConfiguration.builder().graph()``)."""

    def __init__(self, parent):
        self._parent = parent
        self._inputs: List[str] = []
        self._outputs: List[str] = []
        self._nodes: List[GraphNode] = []
        self._input_types: Dict[str, InputType] = {}
        self._compute_dtype: Optional[str] = None
        self._backprop_type = "standard"
        self._tbptt_fwd = 20
        self._tbptt_back = 20

    def add_inputs(self, *names: str) -> "GraphBuilder":
        self._inputs.extend(names)
        return self

    def compute_dtype(self, dtype: str) -> "GraphBuilder":
        """Mixed precision: params and updater float32, the forward and
        backward in ``dtype``."""
        if dtype not in ("float32", "bfloat16", "float16"):
            raise ValueError(f"unsupported compute_dtype '{dtype}'")
        self._compute_dtype = None if dtype == "float32" else dtype
        return self

    def backprop_type(self, kind: str, fwd_length: int = 20,
                      back_length: int = 20) -> "GraphBuilder":
        if kind not in ("standard", "truncated_bptt"):
            raise ValueError(f"unknown backprop type '{kind}'")
        self._backprop_type = kind
        self._tbptt_fwd = fwd_length
        self._tbptt_back = back_length
        return self

    def set_input_types(self, **types: InputType) -> "GraphBuilder":
        self._input_types.update(types)
        return self

    def add_layer(self, name: str, layer: Layer,
                  *inputs: str) -> "GraphBuilder":
        self._nodes.append(GraphNode(name, tuple(inputs),
                                     layer=layer.with_name(name)))
        return self

    def add_vertex(self, name: str, vertex: GraphVertex,
                   *inputs: str) -> "GraphBuilder":
        self._nodes.append(GraphNode(name, tuple(inputs), vertex=vertex))
        return self

    def set_outputs(self, *names: str) -> "GraphBuilder":
        self._outputs = list(names)
        return self

    def build(self) -> GraphConfiguration:
        p = self._parent
        conf = GraphConfiguration(
            inputs=tuple(self._inputs),
            outputs=tuple(self._outputs),
            nodes=tuple(self._nodes),
            updater=p._updater,
            input_types=({k: v.to_dict() for k, v in
                          self._input_types.items()} or None),
            seed=p._seed,
            optimization_algo=p._optimization_algo,
            num_iterations=p._num_iterations,
            compute_dtype=self._compute_dtype,
            backprop_type=self._backprop_type,
            tbptt_fwd_length=self._tbptt_fwd,
            tbptt_back_length=self._tbptt_back,
            **p._policies(),
        )
        conf.validate()
        if self._input_types:
            conf = _infer_shapes(conf, self._input_types, p)
        else:
            conf = dataclasses.replace(conf, nodes=tuple(
                dataclasses.replace(n, layer=p._apply_global_defaults(n.layer))
                if n.layer is not None else n for n in conf.nodes))
        conf.validate()
        for n in conf.nodes:
            if n.layer is not None:
                n.layer.validate()
        return conf


def _infer_shapes(conf: GraphConfiguration, input_types: Dict[str, InputType],
                  parent) -> GraphConfiguration:
    """Complete every layer's sizes from the graph's input types, in
    topological order, with the builder's global defaults applied."""
    types: Dict[str, InputType] = dict(input_types)
    by_name = {n.name: n for n in conf.nodes}
    new_nodes: Dict[str, GraphNode] = {}
    for name in conf.topological_order():
        node = by_name[name]
        in_types = [types[i] for i in node.inputs]
        if node.layer is not None:
            layer = parent._apply_global_defaults(node.layer)
            layer = layer.setup(in_types[0])
            types[name] = layer.output_type(in_types[0])
            new_nodes[name] = dataclasses.replace(node, layer=layer)
        else:
            types[name] = node.vertex.output_type(in_types)
            new_nodes[name] = node
    return dataclasses.replace(
        conf, nodes=tuple(new_nodes[n.name] for n in conf.nodes))


class ComputationGraph(FlatParamsMixin, LazyScoreMixin):
    """DAG-network facade with ``MultiLayerNetwork``'s API surface."""

    def __init__(self, conf: GraphConfiguration):
        self.conf = conf
        self.nodes = {n.name: n for n in conf.nodes}
        self.topo = conf.topological_order()
        self.params: Dict[str, Dict[str, Any]] = {}
        self.net_state: Dict[str, Dict[str, torch.Tensor]] = {}
        self.updater_state: Dict[str, Any] = {}
        self.device: Optional[torch.device] = None
        self.iteration = 0
        self._keys = KeyStream(conf.seed)
        self.output_nodes = [self.nodes[o] for o in conf.outputs]
        self._rnn_state: Dict[str, Any] = {}
        self._stream_pos: Optional[int] = 0
        # the captured programs by the reference's jit key: generate's
        # decode loops, and the train and output steps of fit,
        # fit_scanned and output (models/capture.py)
        self._graph_cache: Dict[Any, Any] = {}
        self._graph_params = None     # the captured loops' parameters
        # the step programs' staging ring and counts; _capture=False
        # runs their bodies eagerly on the card (an internal switch for
        # comparing the two)
        self._step_graphs = None
        self._capture = True
        # graph input -> the embedding that reads it as token ids
        self._id_consumers = {
            inp: n.layer for n in conf.nodes
            if isinstance(n.layer, EmbeddingLayer) for inp in n.inputs}

    @property
    def layers(self):
        return tuple(n.layer for n in self.conf.nodes if n.layer is not None)

    def init(self, device: DeviceLike = None,
             dtype=torch.float32) -> "ComputationGraph":
        """Seeded parameters on ``device`` (``cuda`` unless told
        otherwise), one key per node in insertion order, the layers'
        initial state and a zero updater state."""
        dev = resolve_device(device)
        self.params = {
            n.name: (n.layer.init(self._keys.next(), dtype, dev)
                     if n.layer is not None and n.layer.has_params() else {})
            for n in self.conf.nodes}
        self.net_state = init_net_state(self.layers, dev, dtype)
        self.device = dev
        self.updater_state = upd.init_state(self.conf.updater,
                                            self._trainable(self.params))
        return self

    _trainable = staticmethod(trainable)

    # ------------------------------------------------------------- forward
    def _forward(self, params, net_state, inputs: Dict[str, torch.Tensor],
                 *, train=False, rng=None, fmask=None, carries=None):
        """Fold over the topological order.  Output-layer nodes stop at
        their pre-output (callers apply the loss or the activation).
        Carry-capable nodes (LSTMs, attention, residual blocks) take their
        carry from ``carries`` by node name; a vertex that reads the
        features mask (``LastTimeStepVertex``) gets ``fmask``.  Returns (activations by node name,
        new net state, new carries)."""
        acts: Dict[str, Any] = dict(inputs)
        new_state = dict(net_state)
        cd = self.conf.compute_dtype
        if cd is not None:
            # the cast sits inside the graph: grads reach the f32 params;
            # the layer state stays float32, as in the reference
            dt = compute_dtype(cd)
            params = cast_tree(params, dt)
            acts = cast_tree(acts, dt)
        n_nodes = len(self.topo)
        rngs = (rng_mod.split(rng, n_nodes) if rng is not None
                else [None] * n_nodes)
        out_names = set(self.conf.outputs)
        new_carries: Dict[str, Any] = {}
        for i, name in enumerate(self.topo):
            node = self.nodes[name]
            xs = [acts[inp] for inp in node.inputs]
            layer = node.layer
            if layer is None:
                kw = {"mask": fmask} if node.vertex._TAKES_MASK else {}
                acts[name] = node.vertex.apply(xs, **kw)
            elif isinstance(layer, OutputLayer) and name in out_names:
                h = layer.maybe_dropout(xs[0], train=train, rng=rngs[i])
                acts[name] = layer.pre_output(params[name], h)
            elif hasattr(layer, "apply_with_state"):
                acts[name], new_state[name] = layer.apply_with_state(
                    params[name], net_state.get(name, {}), xs[0],
                    train=train, rng=rngs[i])
            elif hasattr(layer, "apply_with_carry"):
                acts[name], new_carries[name] = layer.apply_with_carry(
                    params[name], xs[0], (carries or {}).get(name),
                    train=train, rng=rngs[i], mask=fmask)
            else:
                kw = {"mask": fmask} if layer._TAKES_MASK else {}
                acts[name] = layer.apply(params[name], xs[0], train=train,
                                         rng=rngs[i], **kw)
        return acts, new_state, new_carries

    def _loss_fn(self, params, net_state, inputs, labels, rng=None,
                 fmask=None, lmask=None, *, train=True, carries=None):
        """(sum over the outputs of each one's loss, in float32 under a
        compute dtype, + regularization; the new net state).  ``inputs``
        and ``labels`` are dicts by name, or single tensors for a graph
        with one input or one output.  With ``carries`` (a TBPTT
        window's {node: (h, c)}) the forward starts from them, and the new
        carries come third."""
        inputs = self._as_input_dict(inputs)
        labels = self._as_label_dict(labels)
        acts, new_state, new_carries = self._forward(
            params, net_state, inputs, train=train, rng=rng, fmask=fmask,
            carries=carries)
        total = 0.0
        for node in self.output_nodes:
            layer = node.layer
            lm = lmask.get(node.name) if isinstance(lmask, dict) else lmask
            pre = acts[node.name]
            if self.conf.compute_dtype is not None:
                pre = pre.float()
            total = total + losses.score(
                layer.loss, labels[node.name].to(pre.dtype), pre,
                layer.activation, lm)
        for n in self.conf.nodes:
            if n.layer is not None and n.layer.has_params():
                total = total + n.layer.reg_score(params[n.name])
        if carries is not None:
            return total, new_state, new_carries
        return total, new_state

    def _as_input_dict(self, inputs):
        if isinstance(inputs, dict):
            return inputs
        if len(self.conf.inputs) != 1:
            raise ValueError("Multi-input graph requires a dict of inputs")
        return {self.conf.inputs[0]: inputs}

    def _as_label_dict(self, labels):
        if isinstance(labels, dict):
            return labels
        if len(self.conf.outputs) != 1:
            raise ValueError("Multi-output graph requires a dict of labels")
        return {self.conf.outputs[0]: labels}

    def _on_device(self, tree):
        if tree is None:
            return None
        if isinstance(tree, dict):
            return {k: self._on_device(v) for k, v in tree.items()}
        return torch.as_tensor(tree, device=self.device)

    # ------------------------------------------------------------ inference
    def _output_body(self, inputs, fmask, key=None, scalars=None):
        with torch.no_grad():
            acts, _, _ = self._forward(self.params, self.net_state, inputs,
                                       fmask=fmask)
            outs = []
            for node in self.output_nodes:
                pre = acts[node.name]
                if self.conf.compute_dtype is not None:
                    pre = pre.float()
                outs.append(activations.get(node.layer.activation)(pre))
        return outs[0] if len(outs) == 1 else outs

    def output(self, inputs, fmask=None):
        """Inference forward; each output's activation, float32 under a
        compute dtype; a list for a graph with several outputs.  On the
        card a captured graph's replay."""
        return infer(self, self._output_body,
                     {"inputs": self._as_input_dict(inputs),
                      "fmask": fmask})

    def feed_forward(self, inputs, train: bool = False, fmask=None):
        """Every vertex's activation (the inputs too) as a dict by name;
        output vertices carry their post-activation values.  float32 at
        the API boundary under a compute dtype (reference ``graph.py:1029``).
        """
        inputs = self._on_device(self._as_input_dict(inputs))
        rng = self._keys.next() if train else None
        with torch.no_grad():
            acts, _, _ = self._forward(self.params, self.net_state, inputs,
                                       train=train, rng=rng,
                                       fmask=self._on_device(fmask))
        cd = self.conf.compute_dtype is not None
        out = {}
        for name, a in acts.items():
            if name in self.conf.outputs:
                a = activations.get(self.nodes[name].layer.activation)(
                    a.float() if cd else a)
            elif cd and torch.is_tensor(a) and a.is_floating_point():
                a = a.float()
            out[name] = a
        return out

    def score(self, inputs=None, labels=None, dataset=None, fmask=None,
              lmask=None) -> float:
        """Loss of (inputs, labels) at inference (no dropout, running
        stats), as a float."""
        if dataset is not None:
            if hasattr(dataset, "features"):
                inputs, labels = dataset.features, dataset.labels
                fmask = (fmask if fmask is not None
                         else getattr(dataset, "features_mask", None))
                lmask = (lmask if lmask is not None
                         else getattr(dataset, "labels_mask", None))
            else:
                inputs, labels = dataset[0], dataset[1]
        with torch.no_grad():
            loss, _ = self._loss_fn(
                self.params, self.net_state,
                self._on_device(self._as_input_dict(inputs)),
                self._on_device(self._as_label_dict(labels)), None,
                self._on_device(fmask), self._on_device(lmask), train=False)
        return float(loss)

    # ----------------------------------------------------------- train step
    def _train_body(self, inputs, labels, fmask, lmask, key, scalars,
                    carries=None):
        """The step's device body (``common.sgd_step``); a TBPTT window
        (``carries``) returns (loss, its carries, now the new ones)."""
        loss = sgd_step(self, lambda params: self._loss_fn(
            params, self.net_state, inputs, labels, key, fmask, lmask,
            train=True, carries=carries), scalars, carries)
        return loss if carries is None else (loss, carries)

    def _step(self, inputs):
        return train_step(self, self._train_body, inputs)

    def _one_step(self, x, y, fmask, lmask) -> None:
        self._step({"inputs": self._as_input_dict(x),
                    "labels": self._as_label_dict(y), "fmask": fmask,
                    "lmask": lmask})

    def _fit_one(self, x, y, fmask, lmask) -> None:
        """One batch: one step, or TBPTT's windows."""
        if self.conf.backprop_type == "truncated_bptt":
            self._fit_tbptt(x, y, fmask, lmask)
        else:
            self._one_step(x, y, fmask, lmask)

    def _batch_adv(self, x) -> int:
        """How many iterations one batch advances (reference
        ``graph.py:846``): one a TBPTT window of its longest sequence
        input under SGD TBPTT, else 1."""
        if (self.conf.optimization_algo == "stochastic_gradient_descent"
                and self.conf.backprop_type == "truncated_bptt"):
            temporal = [a.shape[1] for a in self._as_input_dict(x).values()
                        if a.ndim >= 3]
            if temporal:
                return -(-max(temporal) // self.conf.tbptt_fwd_length)
        return 1

    def _fit_tbptt(self, x, y, fmask, lmask) -> None:
        """Truncated BPTT over the DAG (reference ``graph.py:907``):
        ``common.fit_tbptt``'s windows of every input, label and mask
        along the time axis."""
        x, y = self._as_input_dict(x), self._as_label_dict(y)
        temporal = [a.shape[1] for a in x.values() if a.ndim >= 3]
        if not temporal:
            raise ValueError(
                "TBPTT requires at least one rank-3 [batch, time, features] "
                "input; use backprop_type='standard' for feed-forward "
                "graphs")
        common.fit_tbptt(
            self, int(max(temporal)), int(next(iter(x.values())).shape[0]),
            lambda sl: {"inputs": self._tbptt_slice_data(x, sl),
                        "labels": self._tbptt_slice_data(y, sl),
                        "fmask": self._tbptt_slice_mask(fmask, sl),
                        "lmask": self._tbptt_slice_mask(lmask, sl)})

    @staticmethod
    def _tbptt_slice_data(tree, sl):
        """The time slice of every sequence (rank 3 or more); rank-2
        features and one-hot labels are static and pass whole."""
        return common.tree_map(
            lambda a: a[:, sl] if a.ndim >= 3 else a, tree)

    @staticmethod
    def _tbptt_slice_mask(tree, sl):
        """Masks are [batch, time]: rank 2 is temporal here."""
        return common.tree_map(
            lambda a: a[:, sl] if a.ndim >= 2 else a, tree)

    def fit(self, data, labels=None, *, fmask=None,
            lmask=None) -> "ComputationGraph":
        """``fit(inputs, labels)`` (an array or a dict by input name, and
        an array or a dict by output name), or ``fit(iterable)`` of
        (x, y[, fmask, lmask]) tuples or DataSets; one SGD step per batch
        (one a window under TBPTT), as the reference."""
        check_trainable(self)
        if labels is not None:
            self._fit_one(data, labels, fmask, lmask)
            return self
        for batch in data:
            self._fit_one(*unpack_batch(batch))
        return self

    # ------------------------------------------------- streaming rnnTimeStep
    def rnn_clear_previous_state(self) -> None:
        self._rnn_state = {}
        self._stream_pos = 0

    def _id_consumer(self, input_name: str):
        """The embedding that reads this graph input as token ids, if
        any."""
        return self._id_consumers.get(input_name)

    def _named_layers(self):
        return [(n, self.nodes[n].layer) for n in self.topo
                if self.nodes[n].layer is not None]

    def rnn_time_step(self, inputs, fmask=None):
        """Stateful streaming inference (reference ``graph.py:1090``):
        feed one timestep or a few; attention nodes keep a KV cache and
        LSTM nodes their (h, c) between calls.  Id inputs (read by an embedding) follow
        ``MultiLayerNetwork.rnn_time_step``'s rules; a rank-2 feature
        input is one step.  Each output's activation, float32 under a
        compute dtype; a list for several outputs."""
        inputs = self._on_device(self._as_input_dict(inputs))
        squeeze = False
        expanded = {}
        for name, v in inputs.items():
            emb = self._id_consumer(name)
            if emb is not None:
                sq = v.ndim == 1 or (
                    emb.collapse_column and v.ndim == 2 and v.shape[1] == 1)
                if v.ndim == 1:
                    v = v[:, None]
                if v.ndim == 2 and emb.collapse_column:
                    v = v[..., None]
            else:
                sq = v.ndim == 2
                if sq:
                    v = v[:, None, :]
            squeeze = squeeze or sq
            expanded[name] = v
        first = next(iter(expanded.values()))
        if not self._rnn_state:
            self._stream_pos = 0
        carries = seed_stream_caches(
            self._named_layers(), self._rnn_state, first.shape[0],
            self.conf.compute_dtype, self.device)
        # the longest time axis bounds what any cache appends this call;
        # inputs of unequal lengths leave the host position unknown, and
        # the check then reads each cache's device position
        t_all = {int(v.shape[1]) for v in expanded.values() if v.ndim >= 2}
        t_new = max(t_all, default=1)
        if len(t_all) > 1:
            self._stream_pos = None
        check_cache_capacity(carries, t_new, pos=self._stream_pos)
        with torch.no_grad():
            acts, _, new_carries = self._forward(
                self.params, self.net_state, expanded,
                fmask=self._on_device(fmask), carries=carries or None)
            outs = []
            for node in self.output_nodes:
                o = activations.get(node.layer.activation)(
                    acts[node.name].float())
                outs.append(o[:, -1] if squeeze and o.ndim == 3 else o)
        self._rnn_state = new_carries
        if self._stream_pos is not None:
            self._stream_pos += t_new
        return outs[0] if len(outs) == 1 else outs

    def _unpack_multi(self, batch):
        """Positional features/labels lists of a MultiDataSet-like object
        -> (input dict, label dict, features mask, labels masks)
        (reference ``graph.py:822-844``)."""
        if len(batch.features) != len(self.conf.inputs):
            raise ValueError(
                f"MultiDataSet has {len(batch.features)} feature arrays, "
                f"graph declares {len(self.conf.inputs)} inputs")
        if len(batch.labels) != len(self.conf.outputs):
            raise ValueError(
                f"MultiDataSet has {len(batch.labels)} label arrays, graph "
                f"declares {len(self.conf.outputs)} outputs")
        fm = None
        if batch.features_masks is not None:
            present = [m for m in batch.features_masks if m is not None]
            if len(present) > 1:
                raise ValueError("at most one features mask is supported")
            fm = present[0] if present else None
        lm = None
        if batch.labels_masks is not None:
            lm = {n: m for n, m in zip(self.conf.outputs,
                                       batch.labels_masks)
                  if m is not None} or None
        return (dict(zip(self.conf.inputs, batch.features)),
                dict(zip(self.conf.outputs, batch.labels)), fm, lm)

    def fit_scanned(self, batches, scan_steps: int,
                    epochs: int = 1) -> "ComputationGraph":
        """Amortized training (reference ``fit_scanned``,
        ``graph.py:629-716``): consecutive same-shape batches (arrays or
        dicts by name, tuples, DataSet-like objects, or MultiDataSet-like
        objects with positional ``features``/``labels`` lists),
        ``scan_steps`` at a time, a shape change closing the window;
        each batch one replay of the captured step on the card.  The
        same per-batch updates and key stream as ``fit``; ``score_value``
        is the window's last loss.  SGD only; no masks, TBPTT or
        solvers."""
        def unpack(batch):
            if hasattr(batch, "features_masks"):
                x, y, fm, lm = self._unpack_multi(batch)
            elif hasattr(batch, "features"):
                x, y, fm, lm = (batch.features, batch.labels,
                                getattr(batch, "features_mask", None),
                                getattr(batch, "labels_mask", None))
            else:
                x, y = batch[0], batch[1]
                fm = batch[2] if len(batch) > 2 else None
                lm = batch[3] if len(batch) > 3 else None
            return ({"inputs": self._as_input_dict(x),
                     "labels": self._as_label_dict(y), "fmask": None,
                     "lmask": None}, fm, lm)

        common.fit_scanned(self, batches, scan_steps, epochs, unpack,
                           self._step)
        return self

    # --------------------------------------------------------- not ported
    def pretrain(self, *args, **kwargs):
        not_ported("ComputationGraph", "pretrain",
                   "AutoEncoder/RBM, ROADMAP A7")

    def set_listeners(self, *listeners):
        not_ported("ComputationGraph", "set_listeners",
                   "listeners, ROADMAP A8")

    def evaluate(self, *args, **kwargs):
        not_ported("ComputationGraph", "evaluate",
                   "evaluation/, ROADMAP A8")

    # ---------------------------------------------------------- checkpoints
    def save(self, path, save_updater: bool = True) -> None:
        from deeplearning4j_tpu_torch.models import serialization

        serialization.write_model(self, path, save_updater=save_updater)

    @staticmethod
    def load(path, device: DeviceLike = None) -> "ComputationGraph":
        from deeplearning4j_tpu_torch.models import serialization

        return serialization.restore_computation_graph(path, device)
