"""The port's ComputationGraph (``deeplearning4j_tpu_torch/models/graph.py``,
``vertices.py``, the graph half of ``serialization.py`` and ``interop.py``,
``zoo.resnet50``) against the JAX package.

Configs are built by both builders and compared as JSON; weights and
running stats are carried across (``graph_params_from_numpy``).  The tiny
ResNet of ``tests/test_graph.py`` (16x16x3, blocks (1, 1), 8 channels)
goes through ``output``, the loss, per-node gradients and three Nesterov
steps on both sides.  Tolerances (float32, XLA's and PyTorch's CPU
convolutions summing in different orders, compounded through BatchNorm
and three steps): outputs, losses, params and running stats at
``rtol=1e-4, atol=1e-5``; gradients to ``1e-4`` of each node's largest
magnitude; the committed ``graph.zip`` at ``rtol=1e-3, atol=1e-4``, its
own test's tolerance (``tests/test_regression.py``)."""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.models import vertices as jvertices
from deeplearning4j_tpu.models.graph import (
    ComputationGraph as JGraph, GraphConfiguration as JGraphConfiguration,
)
from deeplearning4j_tpu.models.sequential import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.models.serialization import (
    restore_computation_graph as jax_restore_graph,
)
from deeplearning4j_tpu.models.zoo import resnet50 as jax_resnet50
from deeplearning4j_tpu.nn.conf import (
    MultiLayerConfiguration as JMLConf, NeuralNetConfiguration as JNNC,
)
from deeplearning4j_tpu.nn.layers import (
    BatchNormalization as JBatchNorm, DenseLayer as JDense,
    OutputLayer as JOutput,
)
from deeplearning4j_tpu_torch.helpers import batch_norm as bn
from deeplearning4j_tpu_torch.models import serialization, vertices, zoo
from deeplearning4j_tpu_torch.models.common import tree_leaves
from deeplearning4j_tpu_torch.models.graph import (
    ComputationGraph, GraphConfiguration, GraphNode,
)
from deeplearning4j_tpu_torch.models.interop import (
    graph_params_from_numpy, net_state_from_numpy, params_from_numpy,
)
from deeplearning4j_tpu_torch.nn.conf import (
    MultiLayerConfiguration, NeuralNetConfiguration, UpdaterConfig,
)
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer

FIXTURES = Path(__file__).parent / "regression_fixtures"
RTOL, ATOL = 1e-4, 1e-5
TINY = dict(height=16, width=16, channels=3, n_classes=4, blocks=(1, 1),
            stem_stride=1, init_channels=8, updater="nesterovs", lr=0.1)


def _merge_graph(nnc, merge, dense, output):
    """test_graph.py's ``simple_graph``, for either package."""
    return (nnc.builder().seed(1).updater("sgd", learning_rate=0.5).graph()
            .add_inputs("in")
            .add_layer("d0", dense(n_in=4, n_out=8, activation="tanh"), "in")
            .add_layer("d1", dense(n_in=4, n_out=8, activation="relu"), "in")
            .add_vertex("merge", merge(), "d0", "d1")
            .add_layer("out", output(n_in=16, n_out=3, loss="mcxent",
                                     activation="softmax"), "merge")
            .set_outputs("out").build())


def _port_of(jnet):
    conf = GraphConfiguration.from_json(jnet.conf.to_json())
    return graph_params_from_numpy(conf, jax.device_get(jnet.params),
                                   jax.device_get(jnet.net_state),
                                   device="cpu")


def _batch(seed, n=2):
    rs = np.random.RandomState(seed)
    x = rs.rand(n, 16, 16, 3).astype(np.float32)
    return x, np.eye(4, dtype=np.float32)[rs.randint(0, 4, n)]


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


def _trees_close(port_tree, jax_tree):
    for name, sub in jax.device_get(jax_tree).items():
        for k, v in sub.items():
            _close(port_tree[name][k].numpy(), v, what=f"{name}/{k}")


# ------------------------------------------------------------ configuration
def test_builders_write_the_same_json():
    port = _merge_graph(NeuralNetConfiguration, vertices.MergeVertex,
                        DenseLayer, OutputLayer)
    ref = _merge_graph(JNNC, jvertices.MergeVertex, JDense, JOutput)
    assert json.loads(port.to_json()) == json.loads(ref.to_json())
    assert GraphConfiguration.from_json(port.to_json()) == port


def test_resnet50_config_matches_the_reference():
    """The full stage layout (3, 4, 6, 3) with narrow channels: the same
    JSON as the reference's builder (size inference included), 53
    BatchNorm layers, the same topological order and parameter count."""
    kw = dict(height=32, width=32, init_channels=4, n_classes=10)
    jnet = jax_resnet50(**kw)
    net = zoo.resnet50(device="cpu", **kw)
    assert json.loads(net.conf.to_json()) == json.loads(jnet.conf.to_json())
    assert sum(type(l).__name__ == "BatchNormalization"
               for l in net.layers) == 53
    assert net.topo == jnet.topo
    assert net.num_params() == jnet.num_params()
    assert set(net.net_state) == set(jnet.net_state)


def test_topological_order_and_cycle_error():
    jconf = _merge_graph(JNNC, jvertices.MergeVertex, JDense, JOutput)
    conf = GraphConfiguration.from_json(jconf.to_json())
    assert conf.topological_order() == jconf.topological_order()
    cyclic = GraphConfiguration(
        inputs=("in",), outputs=("a",), updater=UpdaterConfig(),
        nodes=(GraphNode("a", ("b",), layer=DenseLayer(n_in=2, n_out=2,
                                                       name="a")),
               GraphNode("b", ("a",), layer=DenseLayer(n_in=2, n_out=2,
                                                       name="b"))))
    with pytest.raises(ValueError, match="cycle"):
        cyclic.topological_order()
    with pytest.raises(ValueError, match="unknown input"):
        dataclasses.replace(cyclic, nodes=cyclic.nodes[:1]).topological_order()
    with pytest.raises(ValueError, match="must be an OutputLayer"):
        dataclasses.replace(cyclic, outputs=("merge",), nodes=(
            GraphNode("merge", ("in",),
                      vertex=vertices.MergeVertex()),)).validate()


VERTICES = {
    "add": (vertices.ElementWiseVertex(op="add"), 3),
    "subtract": (vertices.ElementWiseVertex(op="subtract"), 2),
    "product": (vertices.ElementWiseVertex(op="product"), 3),
    "average": (vertices.ElementWiseVertex(op="average"), 3),
    "max": (vertices.ElementWiseVertex(op="max"), 2),
    "merge": (vertices.MergeVertex(), 2),
    "subset": (vertices.SubsetVertex(index_from=1, index_to=3), 1),
    "scale": (vertices.ScaleVertex(factor=-2.5), 1),
}


@pytest.mark.parametrize("name", sorted(VERTICES))
def test_vertex_matches_jax(name):
    vertex, n = VERTICES[name]
    jv = jvertices.vertex_from_dict(vertex.to_dict())
    xs = [np.random.default_rng(i).standard_normal((2, 3, 3, 5)).astype(
        np.float32) for i in range(n)]
    got = vertex.apply([torch.from_numpy(x) for x in xs])
    _close(got.numpy(), jv.apply([jnp.asarray(x) for x in xs]), atol=1e-6)
    assert vertices.vertex_from_dict(vertex.to_dict()) == vertex
    from deeplearning4j_tpu.nn.inputs import InputType as JInputType
    from deeplearning4j_tpu_torch.nn.inputs import InputType

    types = [InputType.convolutional(3, 3, 5)] * n
    jtypes = [JInputType.convolutional(3, 3, 5)] * n
    assert (vertex.output_type(types).to_dict()
            == jv.output_type(jtypes).to_dict())


def test_unported_vertices_raise_clearly():
    """Every reference vertex is ported: the two recurrent ones (ROADMAP
    A6) read back from their dicts; an unknown name still raises."""
    for name in ("LastTimeStepVertex", "DuplicateToTimeSeriesVertex"):
        v = vertices.vertex_from_dict({"type": name})
        assert type(v).__name__ == name and v.to_dict()["type"] == name
    with pytest.raises(ValueError, match="Unknown vertex"):
        vertices.vertex_from_dict({"type": "NoSuchVertex"})


# ------------------------------------------------------------- tiny ResNet
def test_tiny_resnet_output_loss_and_gradients_match_jax():
    jnet = jax_resnet50(**TINY)
    net = _port_of(jnet)
    x, y = _batch(0)
    _close(net.output(x).numpy(), jnet.output(x))
    _close(net.score(x, y), float(jnet.score(x, y)))

    def jloss(p):
        loss, _ = jnet._loss_fn(p, jnet.net_state, jnp.asarray(x),
                                jnp.asarray(y), None)
        return loss

    jl, jg = jax.value_and_grad(jloss)(jnet.params)
    train = net._trainable(net.params)
    leaves = tree_leaves(train)
    for p in leaves:
        p.requires_grad_(True)
    before = bn.train_fwd_counts.plain_calls, bn.train_bwd_counts.plain_calls
    loss, new_state = net._loss_fn(net.params, net.net_state,
                                   torch.from_numpy(x), torch.from_numpy(y))
    grads = dict(zip(
        [f"{n}/{k}" for n in sorted(train) for k in sorted(train[n])],
        torch.autograd.grad(loss, leaves)))
    for p in leaves:
        p.requires_grad_(False)
    assert (bn.train_fwd_counts.plain_calls - before[0],
            bn.train_bwd_counts.plain_calls - before[1]) == (9, 9)
    _close(float(loss.detach()), float(jl))
    jg = jax.device_get(jg)
    for key, g in grads.items():
        node, k = key.split("/")
        want, got = np.asarray(jg[node][k]), g.numpy()
        if k == "b" and np.ndim(jg[node].get("W")) == 4:
            # a conv bias feeding a training-mode BatchNorm: the batch
            # mean removes it, so its true gradient is 0 and both sides
            # give float noise, held far below the node's weight gradient
            bound = 1e-4 * np.abs(np.asarray(jg[node]["W"])).max()
            assert max(np.abs(got).max(), np.abs(want).max()) <= bound, key
            continue
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= 1e-4 * scale, key
    assert set(new_state) == set(jnet.net_state)


def test_three_nesterov_steps_match_jax():
    jnet = jax_resnet50(**TINY)
    net = _port_of(jnet)
    x, y = _batch(1)
    for _ in range(3):
        jnet.fit(x, y)
        net.fit(x, y)
        _close(net.score_value, jnet.score_value)
    assert net.iteration == jnet.iteration == 3
    _trees_close(net.params, jnet.params)
    _trees_close(net.net_state, jnet.net_state)
    moved = net.net_state["stem_bn"]["var"]
    assert not torch.equal(moved, torch.ones_like(moved))
    _close(net.output(x).numpy(), jnet.output(x))


def test_fit_over_an_iterable_of_dict_batches_matches_jax():
    """The two-input fixture graph: ``fit`` over (dict, labels) tuples."""
    jnet = jax_restore_graph(FIXTURES / "graph.zip")
    net = serialization.restore_computation_graph(FIXTURES / "graph.zip",
                                                  device="cpu")
    rs = np.random.RandomState(2)
    batches = [({"a": rs.rand(4, 3).astype(np.float32),
                 "b": rs.rand(4, 2).astype(np.float32)},
                np.eye(2, dtype=np.float32)[rs.randint(0, 2, 4)])
               for _ in range(2)]
    jnet.fit(batches)
    net.fit(batches)
    assert net.iteration == jnet.iteration == 5
    _close(net.score_value, jnet.score_value)
    _trees_close(net.params, {k: v for k, v in jnet.params.items() if v})


def test_committed_graph_zip_matches_its_expected_output():
    cg = serialization.restore_computation_graph(FIXTURES / "graph.zip",
                                                 device="cpu")
    xa = np.load(FIXTURES / "graph_input_a.npy")
    xb = np.load(FIXTURES / "graph_input_b.npy")
    expected = np.load(FIXTURES / "graph_expected.npy")
    out = cg.output({"a": xa, "b": xb}).numpy()
    np.testing.assert_allclose(out, expected, rtol=1e-3, atol=1e-4)
    assert serialization.load_model(FIXTURES / "graph.zip",
                                    device="cpu").iteration == cg.iteration


def test_save_load_round_trip_keeps_net_state(tmp_path):
    net = zoo.resnet50(device="cpu", **TINY)
    x, y = _batch(3)
    net.fit(x, y)
    net.save(tmp_path / "g.zip")
    back = ComputationGraph.load(tmp_path / "g.zip", device="cpu")
    assert back.iteration == 1
    for a, b in zip(tree_leaves(net.net_state), tree_leaves(back.net_state)):
        assert torch.equal(a, b)
    assert torch.equal(net.output(x), back.output(x))
    net.fit(x, y)
    back.fit(x, y)
    for a, b in zip(tree_leaves(net.params), tree_leaves(back.params)):
        assert torch.equal(a, b)
    # the JAX package reads the port's zip, running stats included
    jnet = jax_restore_graph(tmp_path / "g.zip")
    _trees_close(ComputationGraph.load(tmp_path / "g.zip",
                                       device="cpu").net_state,
                 jnet.net_state)


def test_net_state_is_checked_on_the_way_in():
    net = zoo.resnet50(device="cpu", **TINY)
    state = {k: {s: v.numpy() for s, v in d.items()}
             for k, d in net.net_state.items()}
    state.pop("stem_bn")
    with pytest.raises(ValueError, match="net state"):
        net_state_from_numpy(net.layers, state, torch.device("cpu"))
    state = {k: {s: v.numpy() for s, v in d.items()}
             for k, d in net.net_state.items()}
    state["stem_bn"]["mean"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="stem_bn/mean"):
        net_state_from_numpy(net.layers, state, torch.device("cpu"))


# ------------------------------------------------- BatchNorm in a .list()
def test_batch_norm_in_a_multi_layer_network_matches_jax():
    jconf = (JNNC.builder().seed(5).updater("nesterovs", learning_rate=0.1)
             .list()
             .layer(JDense(n_in=4, n_out=6, activation="identity"))
             .layer(JBatchNorm(n_out=6, activation="relu"))
             .layer(JOutput(n_in=6, n_out=3)).build())
    jnet = JMLN(jconf).init()
    conf = MultiLayerConfiguration.from_json(jconf.to_json())
    net = params_from_numpy(conf, jax.device_get(jnet.params), device="cpu",
                            net_state=jax.device_get(jnet.net_state))
    rs = np.random.RandomState(4)
    x = rs.randn(8, 4).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, 8)]
    for _ in range(2):
        jnet.fit(x, y)
        net.fit(x, y)
        _close(net.score_value, jnet.score_value)
    _trees_close(net.net_state, jnet.net_state)
    _trees_close(net._trainable(net.params), jnet._trainable(jnet.params))
    _close(net.output(x).numpy(), jnet.output(x))
    assert JMLConf.from_json(conf.to_json()) == jconf


@pytest.mark.parametrize("shapes", [False, True], ids=["given", "inferred"])
def test_global_defaults_reach_layers_like_jax(shapes):
    """Builder globals land in the fields still at their class default,
    with or without size inference, as in the reference."""
    from deeplearning4j_tpu.nn.inputs import InputType as JInputType
    from deeplearning4j_tpu_torch.nn.inputs import InputType

    def build(nnc, dense, output, itype):
        g = (nnc.builder().activation("tanh").weight_init("relu")
             .regularization(True).l2(1e-3).dropout(0.25).graph()
             .add_inputs("in"))
        if shapes:
            g.set_input_types(**{"in": itype.feed_forward(3)})
        return (g.add_layer("d", dense(n_in=3, n_out=4), "in")
                .add_layer("e", dense(n_in=None if shapes else 4, n_out=4,
                                      activation="relu"), "d")
                .add_layer("out", output(n_in=4, n_out=2), "e")
                .set_outputs("out").build())

    port = build(NeuralNetConfiguration, DenseLayer, OutputLayer, InputType)
    ref = build(JNNC, JDense, JOutput, JInputType)
    assert json.loads(port.to_json()) == json.loads(ref.to_json())
    layers = {n.name: n.layer for n in port.nodes}
    assert layers["d"].activation == "tanh" and layers["d"].l2 == 1e-3
    assert layers["e"].activation == "relu" and layers["e"].n_in == 4


# ------------------------------------------------------------- not ported
def test_fit_scanned_trains_the_tiny_resnet_like_fit():
    """``fit_scanned`` (no longer a raise) on the tiny ResNet with
    Nesterov: params and BatchNorm running stats equal ``fit``'s over the
    same batches, a window of three.  Each batch of a window runs the
    per-batch step, so this holds the facade's windowing and bookkeeping,
    not a second update path."""
    a = zoo.resnet50(device="cpu", **TINY)
    b = zoo.resnet50(device="cpu", **TINY)
    batches = [_batch(30 + i) for i in range(3)]
    for x, y in batches:
        a.fit(x, y)
    b.fit_scanned(batches, scan_steps=3)
    assert b.iteration == a.iteration == 3
    for p, q in zip(tree_leaves(a.params) + tree_leaves(a.net_state),
                    tree_leaves(b.params) + tree_leaves(b.net_state)):
        np.testing.assert_allclose(q.numpy(), p.numpy(), rtol=1e-6,
                                   atol=1e-7)


def test_unported_parts_raise():
    net = zoo.resnet50(device="cpu", **TINY)
    for call in (lambda: net.pretrain([]), lambda: net.evaluate(None),
                 lambda: net.set_listeners()):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call()
    net.conf = dataclasses.replace(net.conf, stability={"on": True})
    x, y = _batch(5)
    with pytest.raises(NotImplementedError, match="stability"):
        net.fit(x, y)


def test_resnet50_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        zoo.resnet50(**TINY)
