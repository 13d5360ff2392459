"""AlexNet on the port's MultiLayerNetwork against the JAX package, with
what it brought: input preprocessors (``nn/preprocessors.py``, their
auto-insertion in ``ListBuilder.build`` and the ``preprocessors`` key of
the config JSON), ``DropoutLayer``, ``LocalResponseNormalization`` and
``PreprocessorVertex``; zoo ``lenet`` and the ``mlp``/``cnn`` fixtures
(ROADMAP A3's gates).

Weights are carried across with ``params_from_numpy``.  Tolerances
(float32, XLA's and PyTorch's CPU convolutions summing in different
orders, compounded over layers and three steps): outputs, losses and
params at ``rtol=1e-4, atol=1e-5``; gradients to ``1e-4`` of each
layer's largest magnitude; the committed fixtures at ``rtol=1e-3,
atol=1e-4``, their own test's tolerance (``tests/test_regression.py``)."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.models import vertices as jvertices
from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.models.graph import GraphConfiguration as JGraphConf
from deeplearning4j_tpu.models.serialization import (
    restore_multi_layer_network as jax_restore,
)
from deeplearning4j_tpu.nn import layers as jlayers
from deeplearning4j_tpu.nn import preprocessors as jpre
from deeplearning4j_tpu.nn.conf import (
    MultiLayerConfiguration as JMLConf, NeuralNetConfiguration as JNNC,
)
from deeplearning4j_tpu.nn.inputs import InputType as JInputType
from deeplearning4j_tpu_torch.models import serialization, vertices, zoo
from deeplearning4j_tpu_torch.models.common import tree_leaves
from deeplearning4j_tpu_torch.models.graph import GraphConfiguration
from deeplearning4j_tpu_torch.models.interop import (
    graph_params_from_numpy, params_from_numpy,
)
from deeplearning4j_tpu_torch.nn import layers, preprocessors
from deeplearning4j_tpu_torch.nn.conf import (
    MultiLayerConfiguration, NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.inputs import InputType

FIXTURES = Path(__file__).parent / "regression_fixtures"
RTOL, ATOL = 1e-4, 1e-5
SIDE = 67


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


def _port_of(jnet):
    conf = MultiLayerConfiguration.from_json(jnet.conf.to_json())
    return params_from_numpy(conf, jax.device_get(jnet.params),
                             device="cpu")


def _images(seed, n, side=SIDE, classes=5):
    rs = np.random.RandomState(seed)
    x = rs.rand(n, side, side, 3).astype(np.float32)
    return x, np.eye(classes, dtype=np.float32)[rs.randint(0, classes, n)]


def _narrow_alexnet(nnc, L, input_type, dropout=0.0):
    """AlexNet's shape at narrow widths: conv/LRN/pool twice, three
    convolutions, a pool, two dense layers each followed by a
    ``DropoutLayer``, and the head, on 67x67x3 (down to 1x1x12 before
    the dense layers)."""
    pool = dict(pooling_type="max", kernel_size=(3, 3), stride=(2, 2))
    conv = dict(kernel_size=(3, 3), stride=(1, 1), padding=(1, 1),
                activation="relu")
    return (nnc.builder().seed(7).updater("nesterovs", learning_rate=0.05)
            .regularization(True).l2(5e-4).list()
            .layer(L.ConvolutionLayer(n_out=8, kernel_size=(11, 11),
                                      stride=(4, 4), activation="relu",
                                      weight_init="relu"))
            .layer(L.LocalResponseNormalization(alpha=1e-2))
            .layer(L.SubsamplingLayer(**pool))
            .layer(L.ConvolutionLayer(n_out=12, kernel_size=(5, 5),
                                      stride=(1, 1), padding=(2, 2),
                                      activation="relu"))
            .layer(L.LocalResponseNormalization(alpha=1e-2, n=4))
            .layer(L.SubsamplingLayer(**pool))
            .layer(L.ConvolutionLayer(n_out=16, **conv))
            .layer(L.ConvolutionLayer(n_out=16, **conv))
            .layer(L.ConvolutionLayer(n_out=12, **conv))
            .layer(L.SubsamplingLayer(**pool))
            .layer(L.DenseLayer(n_out=32, activation="relu"))
            .layer(L.DropoutLayer(dropout=dropout))
            .layer(L.DenseLayer(n_out=32, activation="relu"))
            .layer(L.DropoutLayer(dropout=dropout))
            .layer(L.OutputLayer(n_out=5, loss="mcxent",
                                 activation="softmax"))
            .set_input_type(input_type.convolutional(SIDE, SIDE, 3))
            .build())


@pytest.fixture(scope="module")
def narrow():
    from deeplearning4j_tpu.models.sequential import MultiLayerNetwork

    return MultiLayerNetwork(_narrow_alexnet(JNNC, jlayers,
                                             JInputType)).init()


# ------------------------------------------------------------ configuration
def test_zoo_alexnet_json_matches_reference():
    for kw in ({}, {"compute_dtype": "bfloat16"}):
        port = zoo.alexnet(device="cpu", **kw)
        ref = jzoo.alexnet(**kw)
        assert port.conf.to_dict() == ref.conf.to_dict()
    pre = port.conf.preprocessors
    assert list(pre) == [10]
    assert isinstance(pre[10], preprocessors.CnnToFeedForward)
    # 50,844,008 parameters, on the CPU when asked
    assert sum(p.numel() for p in tree_leaves(port.params)) == 50844008
    assert port.params["layer_0"]["W"].device.type == "cpu"


def test_json_with_preprocessors_round_trips_both_ways():
    port = _narrow_alexnet(NeuralNetConfiguration, layers, InputType)
    ref = _narrow_alexnet(JNNC, jlayers, JInputType)
    assert port.to_dict() == ref.to_dict()
    assert JMLConf.from_json(port.to_json()).to_dict() == port.to_dict()
    back = MultiLayerConfiguration.from_json(ref.to_json())
    assert back == port and back.to_dict() == ref.to_dict()
    # a preprocessor set by hand replaces the one build would choose
    b = (NeuralNetConfiguration.builder().list()
         .layer(layers.DenseLayer(n_out=4, activation="relu"))
         .layer(layers.OutputLayer(n_out=2))
         .input_preprocessor(0, preprocessors.CnnToFeedForward())
         .set_input_type(InputType.convolutional(2, 3, 2)))
    conf = b.build()
    assert conf.layers[0].n_in == 12 and list(conf.preprocessors) == [0]


def test_preprocessors_match_the_reference():
    x = np.arange(2 * 3 * 4 * 5, dtype=np.float32).reshape(2, 3, 4, 5)
    flat = x.reshape(2, -1)
    seq = np.arange(2 * 3 * 4, dtype=np.float32).reshape(2, 3, 4)
    cases = [("CnnToFeedForward", {}, x), ("FeedForwardToCnn",
             dict(height=3, width=4, channels=5), flat),
             ("FeedForwardToRnn", {}, flat), ("RnnToFeedForward", {}, seq),
             ("CnnToRnn", {}, x), ("RnnToCnn",
                                   dict(height=1, width=2, channels=2), seq)]
    for name, kw, a in cases:
        d = {"type": name, **kw}
        p, jp = preprocessors.preproc_from_dict(d), jpre.preproc_from_dict(d)
        assert p.to_dict() == jp.to_dict()
        np.testing.assert_array_equal(p(torch.from_numpy(a)).numpy(),
                                      np.asarray(jp(jnp.asarray(a))))
    types = [(JInputType.convolutional(3, 4, 5),
              InputType.convolutional(3, 4, 5)),
             (JInputType.convolutional_flat(3, 4, 5),
              InputType.convolutional_flat(3, 4, 5)),
             (JInputType.feed_forward(7), InputType.feed_forward(7))]
    pairs = [(getattr(jlayers, name)(**kw), getattr(layers, name)(**kw))
             for name, kw in (("ConvolutionLayer", {"n_out": 2}),
                              ("DenseLayer", {"n_out": 2}),
                              ("LocalResponseNormalization", {}),
                              ("DropoutLayer", {}),
                              ("RnnOutputLayer", {"n_out": 2}))]
    for jl, pl in pairs:
        for jt, pt in types:
            try:
                want = jpre.auto_preprocessor(jt, jl)
            except ValueError:
                with pytest.raises(ValueError):
                    preprocessors.auto_preprocessor(pt, pl)
                continue
            got = preprocessors.auto_preprocessor(pt, pl)
            assert (got and got.to_dict()) == (want and want.to_dict())
    with pytest.raises(ValueError, match="Unknown preprocessor"):
        preprocessors.preproc_from_dict({"type": "NoSuchPreprocessor"})


# ------------------------------------------------------------ narrow AlexNet
def test_narrow_alexnet_output_loss_and_gradients_match_jax(narrow):
    net = _port_of(narrow)
    x, y = _images(0, 3)
    _close(net.output(x).numpy(), narrow.output(x))
    _close(net.score(x, y), float(narrow.score(x, y)))

    def jloss(p):
        loss, _ = narrow._loss_fn(p, narrow.net_state, jnp.asarray(x),
                                  jnp.asarray(y), None)
        return loss

    jl, jg = jax.value_and_grad(jloss)(narrow.params)
    train = net._trainable(net.params)
    leaves = tree_leaves(train)
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = net._loss_fn(net.params, torch.from_numpy(x),
                           torch.from_numpy(y))
    grads = torch.autograd.grad(loss, leaves)
    for p in leaves:
        p.requires_grad_(False)
    _close(float(loss.detach()), float(jl))
    keys = [(n, k) for n in sorted(train) for k in sorted(train[n])]
    jg = jax.device_get(jg)
    assert len(keys) == 16
    for (name, k), g in zip(keys, grads):
        want = np.asarray(jg[name][k])
        scale = np.abs(want).max()
        assert scale > 0 and np.abs(g.numpy() - want).max() <= 1e-4 * scale, \
            (name, k)


def test_narrow_alexnet_three_nesterov_steps_match_jax(narrow):
    from deeplearning4j_tpu.models.sequential import MultiLayerNetwork

    jnet = MultiLayerNetwork(narrow.conf).init()
    net = _port_of(jnet)
    x, y = _images(1, 4)
    for _ in range(3):
        jnet.fit(x, y)
        net.fit(x, y)
        _close(net.score_value, jnet.score_value)
    assert net.iteration == jnet.iteration == 3
    for name, sub in jax.device_get(jnet.params).items():
        for k, v in sub.items():
            _close(net.params[name][k].numpy(), v, what=f"{name}/{k}")
    _close(net.output(x).numpy(), jnet.output(x))


def test_zoo_alexnet_output_matches_jax_at_67():
    jnet = jzoo.alexnet(height=SIDE, width=SIDE)
    net = _port_of(jnet)
    x, _ = _images(2, 2, classes=1000)
    _close(net.output(x).numpy(), jnet.output(x))


def test_dropout_layer_draws_at_train_time_only(narrow):
    layer = layers.DropoutLayer(dropout=0.3, name="drop")
    x = torch.ones(400, 250)
    assert torch.equal(layer.apply({}, x), x)
    y = layer.apply({}, x, train=True, rng=torch.Generator().manual_seed(3))
    zero = (y == 0).float().mean().item()
    assert abs(zero - 0.3) < 0.01
    kept = y[y != 0]
    assert torch.allclose(kept, torch.full_like(kept, 1 / 0.7))
    # a net with dropout on infers as the same net with dropout off
    conf = _narrow_alexnet(NeuralNetConfiguration, layers, InputType,
                           dropout=0.5)
    tree = jax.device_get(narrow.params)
    on = params_from_numpy(conf, tree, device="cpu")
    off = _port_of(narrow)
    x, y = _images(3, 2)
    _close(on.output(x).numpy(), off.output(x).numpy(), rtol=0, atol=0)
    # and trains with masks drawn from its step key
    on.fit(x, y)
    assert np.isfinite(on.score_value)


# --------------------------------------------------- fixtures, LeNet, vertex
@pytest.mark.parametrize("name", ["mlp", "cnn"])
def test_committed_checkpoint_matches_expected(name):
    net = serialization.restore_multi_layer_network(FIXTURES / f"{name}.zip",
                                                    device="cpu")
    x = np.load(FIXTURES / f"{name}_input.npy")
    expected = np.load(FIXTURES / f"{name}_expected.npy")
    _close(net.output(x).numpy(), expected, rtol=1e-3, atol=1e-4)
    if name == "cnn":
        kinds = {i: type(p).__name__
                 for i, p in net.conf.preprocessors.items()}
        assert kinds == {0: "FeedForwardToCnn", 2: "CnnToFeedForward"}


@pytest.mark.parametrize("name", ["mlp", "cnn"])
def test_committed_checkpoint_resumes_as_jax_does(name):
    """The restored updater state carries the next step: one ``fit`` on
    both sides gives the same loss and params."""
    jnet = jax_restore(FIXTURES / f"{name}.zip")
    net = serialization.restore_multi_layer_network(FIXTURES / f"{name}.zip",
                                                    device="cpu")
    x = np.load(FIXTURES / f"{name}_input.npy")
    n_out = net.layers[-1].n_out
    y = np.eye(n_out, dtype=np.float32)[np.arange(len(x)) % n_out]
    jnet.fit(x, y)
    net.fit(x, y)
    _close(net.score_value, jnet.score_value)
    for lname, sub in jax.device_get(jnet.params).items():
        for k, v in sub.items():
            _close(net.params[lname][k].numpy(), v, what=f"{lname}/{k}")


def test_zoo_lenet_matches_jax():
    jnet = jzoo.lenet()
    port = zoo.lenet(device="cpu")
    assert port.conf.to_dict() == jnet.conf.to_dict()
    assert {i: type(p).__name__ for i, p in port.conf.preprocessors.items()} \
        == {0: "FeedForwardToCnn", 4: "CnnToFeedForward"}
    net = _port_of(jnet)
    x = np.random.default_rng(0).random((3, 784)).astype(np.float32)
    _close(net.output(x).numpy(), jnet.output(x))


def _vertex_graph(nnc, L, V, pre, it):
    return (nnc.builder().seed(3).updater("sgd", learning_rate=0.1).graph()
            .add_inputs("in")
            .set_input_types(**{"in": it.feed_forward(48)})
            .add_vertex("to_cnn", V.PreprocessorVertex(
                preprocessor=pre.FeedForwardToCnn(4, 4, 3).to_dict()), "in")
            .add_layer("conv", L.ConvolutionLayer(
                n_out=5, kernel_size=(3, 3), activation="relu"), "to_cnn")
            .add_layer("lrn", L.LocalResponseNormalization(alpha=1e-2),
                       "conv")
            .add_vertex("flat", V.PreprocessorVertex(
                preprocessor=pre.CnnToFeedForward().to_dict()), "lrn")
            .add_layer("out", L.OutputLayer(n_out=3, loss="mcxent",
                                            activation="softmax"), "flat")
            .set_outputs("out").build())


def test_preprocessor_vertex_graph_matches_jax():
    from deeplearning4j_tpu.models.graph import ComputationGraph as JGraph

    conf = _vertex_graph(NeuralNetConfiguration, layers, vertices,
                         preprocessors, InputType)
    jconf = _vertex_graph(JNNC, jlayers, jvertices, jpre, JInputType)
    assert json.loads(conf.to_json()) == json.loads(jconf.to_json())
    assert GraphConfiguration.from_json(jconf.to_json()).to_json() \
        == conf.to_json()
    assert JGraphConf.from_json(conf.to_json()).to_json() == jconf.to_json()
    jnet = JGraph(jconf).init()
    net = graph_params_from_numpy(conf, jax.device_get(jnet.params),
                                  device="cpu")
    x = np.random.default_rng(4).random((2, 48)).astype(np.float32)
    _close(net.output(x).numpy(), jnet.output(x))


def test_zip_with_lrn_dropout_and_preprocessors_round_trips(narrow, tmp_path):
    """A zip the reference writes for a net with parameterless layers
    (LRN, DropoutLayer, Subsampling) and a preprocessor loads in the
    port, and the port's zip of it loads in the reference."""
    from deeplearning4j_tpu.models.serialization import write_model

    write_model(narrow, tmp_path / "ref.zip")
    net = serialization.restore_multi_layer_network(tmp_path / "ref.zip",
                                                    device="cpu")
    assert net.conf.to_dict() == narrow.conf.to_dict()
    x, _ = _images(5, 2)
    _close(net.output(x).numpy(), narrow.output(x))
    net.save(tmp_path / "port.zip")
    back = jax_restore(tmp_path / "port.zip")
    _close(np.asarray(back.output(x)), narrow.output(x))
