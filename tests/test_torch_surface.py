"""The facades' public surface in the port against the JAX facades, on the
committed fixtures (``tests/regression_fixtures/``): ``output`` with a
features mask, ``feed_forward``, ``num_params``, the flat parameter
vector, ``clone``, the configurations' YAML, ``rnn_time_step``,
``fit_scanned`` against ``fit``, and the methods and configurations
that once raised naming a ROADMAP item (``pretrain``, the full-batch
solvers, the listeners, ``evaluate``) against the JAX facades.

Tolerances: outputs and activations at ``rtol=1e-4, atol=1e-5`` (float32,
the same weights, different summation orders); parameter vectors
exactly (the same float32 values in the same order)."""

from pathlib import Path

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.serialization import (
    restore_computation_graph as jax_restore_graph,
    restore_multi_layer_network as jax_restore,
)
from deeplearning4j_tpu_torch.models import serialization
from deeplearning4j_tpu_torch.models.common import tree_leaves
from deeplearning4j_tpu_torch.models.graph import GraphConfiguration
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration

FIXTURES = Path(__file__).parent / "regression_fixtures"
RTOL, ATOL = 1e-4, 1e-5
SEQUENTIAL = ("transformer", "mlp")


def _port(name):
    if name == "graph":
        return serialization.restore_computation_graph(
            FIXTURES / "graph.zip", device="cpu")
    return serialization.restore_multi_layer_network(
        FIXTURES / f"{name}.zip", device="cpu")


def _jax(name):
    if name == "graph":
        return jax_restore_graph(FIXTURES / "graph.zip")
    return jax_restore(FIXTURES / f"{name}.zip")


def _input(name):
    if name == "graph":
        return {k: np.load(FIXTURES / f"graph_input_{k}.npy")
                for k in ("a", "b")}
    return np.load(FIXTURES / f"{name}_input.npy")


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_output_takes_a_features_mask():
    """A padded batch through the char-LM: the masked forward matches the
    JAX facade's ``output(x, fmask=)`` and differs from the unmasked
    one."""
    x = _input("transformer")
    fmask = np.ones(x.shape, np.float32)
    fmask[1, 4:] = 0.0
    net, jnet = _port("transformer"), _jax("transformer")
    got = net.output(x, fmask=fmask)
    assert got.dtype == torch.float32
    _close(got.numpy(), jnet.output(x, fmask=fmask))
    assert not np.allclose(got.numpy(), net.output(x).numpy())


@pytest.mark.parametrize("name", SEQUENTIAL + ("graph",))
def test_params_vector_and_num_params_match_jax(name):
    net, jnet = _port(name), _jax(name)
    vec = net.params_to_vector()
    assert vec.dtype == np.float32 and vec.ndim == 1
    np.testing.assert_array_equal(vec, np.asarray(jnet.params_to_vector()))
    assert net.num_params() == jnet.num_params() == vec.size


@pytest.mark.parametrize("name", SEQUENTIAL + ("graph",))
def test_set_params_vector_round_trip_matches_jax(name):
    """The same new vector into both facades changes ``output`` alike;
    each leaf keeps its dtype and device; a vector of the wrong size
    raises with the reference's wording."""
    net, jnet = _port(name), _jax(name)
    vec = net.params_to_vector()
    new = (vec * 0.5 + np.random.default_rng(0).standard_normal(
        vec.size).astype(np.float32) * 0.01)
    before = [(p.dtype, p.device) for p in
              tree_leaves(net.params)]
    net.set_params_vector(new)
    jnet.set_params_vector(new)
    assert [(p.dtype, p.device) for p in
            tree_leaves(net.params)] == before
    np.testing.assert_array_equal(net.params_to_vector(), new)
    x = _input(name)
    _close(net.output(x).numpy(), jnet.output(x))
    with pytest.raises(ValueError, match=f"param vector size {vec.size - 1} "
                                         f"!= model size {vec.size}"):
        net.set_params_vector(new[:-1])


@pytest.mark.parametrize("name", SEQUENTIAL)
def test_sequential_feed_forward_matches_jax(name):
    net, jnet = _port(name), _jax(name)
    x = _input(name)
    acts = net.feed_forward(x)
    jacts = jnet.feed_forward(x)
    assert len(acts) == len(jacts) == len(net.layers)
    for a, j in zip(acts, jacts):
        assert a.dtype == torch.float32
        _close(a.numpy(), j)


def test_graph_feed_forward_matches_jax():
    """Every vertex by name, the output vertex after its activation."""
    net, jnet = _port("graph"), _jax("graph")
    x = _input("graph")
    acts = net.feed_forward(x)
    jacts = jnet.feed_forward(x)
    assert set(acts) == set(jacts)
    for name, j in jacts.items():
        _close(acts[name].numpy(), j)
    out = net.conf.outputs[0]
    _close(acts[out].numpy(), net.output(x).numpy())


@pytest.mark.parametrize("name", SEQUENTIAL + ("graph",))
def test_clone_is_independent_of_its_source(name):
    net = _port(name)
    x = _input(name)
    twin = net.clone()
    assert type(twin) is type(net) and twin.device == net.device
    assert twin.iteration == net.iteration
    np.testing.assert_array_equal(twin.params_to_vector(),
                                  net.params_to_vector())
    ref = net.output(x).numpy()
    twin.set_params_vector(twin.params_to_vector() * 0)
    np.testing.assert_array_equal(net.output(x).numpy(), ref)
    for a, b in zip(tree_leaves(twin.updater_state),
                    tree_leaves(net.updater_state)):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()


@pytest.mark.parametrize("name", SEQUENTIAL + ("graph",))
def test_yaml_round_trip_equals_the_json_config(name):
    conf = _port(name).conf
    cls = GraphConfiguration if name == "graph" else MultiLayerConfiguration
    back = cls.from_yaml(conf.to_yaml())
    assert back == conf
    assert back.to_json() == conf.to_json()
    # the JAX configuration reads the port's YAML to the same JSON
    assert _jax(name).conf.from_yaml(conf.to_yaml()).to_json() == \
        conf.to_json()


def _labels(name, net, x, seed=0):
    """One-hot labels shaped like the net's output for ``x``."""
    out = net.output(x)
    shape = tuple(out.shape)
    rs = np.random.default_rng(seed)
    y = np.eye(shape[-1], dtype=np.float32)[rs.integers(0, shape[-1],
                                                       shape[:-1])]
    return {"out": y} if name == "graph" else y


@pytest.mark.parametrize("name", SEQUENTIAL + ("graph",))
def test_fit_scanned_equals_fit_on_the_committed_zips(name):
    """``fit_scanned`` (no longer a raise) resumes each committed zip's
    Adam state like ``fit`` over the same batches: a window of two and
    a short tail.  Each batch of a window runs the per-batch step, so
    this holds the windowing and bookkeeping, not a second update
    path."""
    a, b = _port(name), _port(name)
    x = _input(name)
    batches = [(x, _labels(name, a, x, seed)) for seed in range(3)]
    for bx, by in batches:
        a.fit(bx, by)
    b.fit_scanned(batches, scan_steps=2)
    assert b.iteration == a.iteration == 6
    for p, q in zip(tree_leaves(a.params), tree_leaves(b.params)):
        np.testing.assert_allclose(q.numpy(), p.numpy(), rtol=1e-6,
                                   atol=1e-7)
    np.testing.assert_allclose(b.score_value, a.score_value, rtol=1e-6)


def _surface_call(net, jnet, name, method):
    """``method`` on the port's facade against the JAX facade's: the A8
    methods (ported with the online slice) and ``pretrain`` (A7, ported
    with the pretraining slice: on a net without AutoEncoder or RBM
    layers it leaves the parameters and the key stream as they are, as
    the reference's does)."""
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.optimize.listeners import (
        CollectScoresIterationListener,
    )

    if method in ("set_listeners", "add_listener"):
        lst = CollectScoresIterationListener()
        getattr(net, method)(lst)
        assert net.listeners == [lst]
        return
    x = _input(name)
    if method == "pretrain":
        keys = net._keys.get_state()
        assert net.pretrain([x], epochs=2) is net
        jnet.pretrain([x], epochs=2)
        np.testing.assert_array_equal(net.params_to_vector(),
                                      np.asarray(jnet.params_to_vector()))
        assert torch.equal(net._keys.get_state(), keys)
        _close(net.output(x).numpy(), jnet.output(x))
        return
    c = np.asarray(jnet.output(x)).shape[-1]
    y = np.eye(c, dtype=np.float32)[np.arange(4) % c]
    ev, jev = net.evaluate([DataSet(x, y)]), jnet.evaluate([JDataSet(x, y)])
    np.testing.assert_array_equal(ev.confusion.matrix, jev.confusion.matrix)


@pytest.mark.parametrize("method, item", [
    ("pretrain", "A7"), ("set_listeners", "A8"), ("add_listener", "A8"),
    ("evaluate", "A8")])
def test_unported_sequential_methods_name_their_item(method, item):
    """The methods these cases once pinned as raises are ported (A8 with
    the online slice, ``pretrain`` (A7) with the pretraining slice) and
    agree with the JAX facade."""
    _surface_call(_port("mlp"), _jax("mlp"), "mlp", method)


@pytest.mark.parametrize("method, item", [
    ("pretrain", "A7"), ("set_listeners", "A8"), ("evaluate", "A8")])
def test_unported_graph_methods_name_their_item(method, item):
    _surface_call(_port("graph"), _jax("graph"), "graph", method)


def test_rnn_time_step_streams_the_committed_transformer():
    """``rnn_time_step`` (no longer a raise) on the committed char-LM: a
    prompt chunk, then one id at a time, against the JAX facade."""
    net, jnet = _port("transformer"), _jax("transformer")
    ids = _input("transformer")[:, :6]
    for feed in (ids[:, :4], ids[:, 4], ids[:, 5]):
        _close(net.rnn_time_step(feed).numpy(), jnet.rnn_time_step(feed))


# ------------------------------------------------ the rest of the config DSL
def _recipes():
    """Builder calls (ROADMAP A13), each given the builder and its
    package's ``nn.conf`` and ``nn.initializers`` modules."""
    return {
        "learning_rate": lambda b, c, i: b.learning_rate(0.05),
        "momentum": lambda b, c, i: b.updater("nesterovs").momentum(0.8),
        "lr_policy": lambda b, c, i: b.lr_policy("exponential",
                                                 decay_rate=0.9),
        "lr_policy_warmup": lambda b, c, i: b.lr_policy(
            "warmup_cosine", warmup_steps=10, min_fraction=0.1, steps=50),
        "lr_schedule": lambda b, c, i: b.lr_schedule({0: 0.1, 5: 0.01}),
        "gradient_normalization": lambda b, c, i: b.gradient_normalization(
            "clip_l2_per_layer", 2.0),
        "training_stability": lambda b, c, i: b.training_stability(
            loss_scaling="dynamic", check_every=10),
        "training_stability_policy": lambda b, c, i: b.training_stability(
            c.TrainingStability(check_every=5), spike_factor=3.0),
        "training_stability_off": lambda b, c, i: b.training_stability(
            True).training_stability(False),
        "training_introspection": lambda b, c, i: b.training_introspection(
            dead_eps=0.1),
        "training_numerics": lambda b, c, i: b.training_numerics(
            c.TrainingNumerics(interval=5)),
        "optimization_algo": lambda b, c, i: b.optimization_algo("LBFGS"),
        "iterations": lambda b, c, i: b.iterations(3),
        "weight_init_distribution": lambda b, c, i: b.weight_init(
            "distribution", dist=i.NormalDistribution(0.0, 0.5)),
        "weight_init_dict": lambda b, c, i: b.weight_init(
            "distribution", dist={"type": "uniform", "lower": -0.1,
                                  "upper": 0.1}),
        "weight_init": lambda b, c, i: b.weight_init("xavier_uniform"),
        "activation": lambda b, c, i: b.activation("gelu"),
    }


def _built(pkg, recipe, graph):
    import importlib

    conf = importlib.import_module(f"{pkg}.nn.conf")
    inits = importlib.import_module(f"{pkg}.nn.initializers")
    layers = importlib.import_module(f"{pkg}.nn.layers")
    b = recipe(conf.NeuralNetConfiguration.builder().seed(3), conf, inits)
    dense = layers.DenseLayer(n_in=4, n_out=5)
    out = layers.OutputLayer(n_in=5, n_out=2, loss="mcxent",
                             activation="softmax")
    if graph:
        return (b.graph().add_inputs("in").add_layer("d", dense, "in")
                .add_layer("out", out, "d").set_outputs("out").build()
                .to_json())
    return b.list().layer(dense).layer(out).build().to_json()


@pytest.mark.parametrize("graph", [False, True])
@pytest.mark.parametrize("name", sorted(_recipes()))
def test_global_builder_calls_build_the_jax_json(name, graph):
    recipe = _recipes()[name]
    import json

    assert json.loads(_built("deeplearning4j_tpu_torch", recipe, graph)) \
        == json.loads(_built("deeplearning4j_tpu", recipe, graph))


@pytest.mark.parametrize("name", ["backprop_type", "pretrain", "backprop",
                                  "layer_index"])
def test_list_builder_calls_build_the_jax_json(name):
    import importlib
    import json

    def make(pkg):
        conf = importlib.import_module(f"{pkg}.nn.conf")
        layers = importlib.import_module(f"{pkg}.nn.layers")
        b = (conf.NeuralNetConfiguration.builder().list()
             .layer(layers.GravesLSTM(n_in=3, n_out=4), 0)
             .layer(layers.RnnOutputLayer(n_in=4, n_out=3)))
        if name == "backprop_type":
            b.backprop_type("truncated_bptt", 7, 5)
        elif name == "pretrain":
            b.pretrain(True)
        elif name == "backprop":
            b.backprop(False)
        return json.loads(b.build().to_json())

    assert make("deeplearning4j_tpu_torch") == make("deeplearning4j_tpu")


@pytest.mark.parametrize("call", [
    lambda b, L: b.training_stability(False, check_every=3),
    lambda b, L: b.training_numerics("yes"),
    lambda b, L: b.training_stability(loss_scaling="often"),
    lambda b, L: b.training_introspection(dead_eps=-1.0),
    lambda b, L: b.list().layer(L.DenseLayer(n_in=1, n_out=1), 3)])
def test_builder_refusals_match_jax(call):
    from deeplearning4j_tpu.nn import layers as jlayers
    from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
    from deeplearning4j_tpu_torch.nn import layers
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration

    with pytest.raises(ValueError) as err:
        call(NeuralNetConfiguration.builder(), layers)
    with pytest.raises(ValueError) as jerr:
        call(JNNC.builder(), jlayers)
    assert str(err.value) == str(jerr.value)


@pytest.mark.parametrize("what,item", [("stability", "A9"),
                                       ("numerics", "A9"),
                                       ("solver", "A8")])
def test_configs_of_unported_engines_build_and_fit_raises(what, item):
    """A config that sets a training policy or a full-batch solver
    builds (the JSON of the JAX builder, above) and its ``fit`` runs:
    the stability guard's and the numerics ledger's engines (A9) leave
    their state on the net, and the solver (A8, ported with the
    pretraining slice) gives the JAX facade's parameters on the same
    weights."""
    from deeplearning4j_tpu_torch.models.sequential import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import OutputLayer

    b = NeuralNetConfiguration.builder()
    if what == "stability":
        b.training_stability(loss_scaling="static")
    elif what == "numerics":
        b.training_numerics()
    else:
        b.optimization_algo("conjugate_gradient")
    conf = b.list().layer(OutputLayer(n_in=3, n_out=2)).build()
    net = MultiLayerNetwork(conf).init(device="cpu")
    if what == "stability":
        net.fit(np.zeros((2, 3), np.float32), np.eye(2, dtype=np.float32))
        assert float(net.updater_state["__stability__"]["loss_scale"]) \
            == 2.0 ** 15
        return
    if what == "numerics":
        # ported with the online slice (A9): the ledger collects
        net.fit(np.zeros((2, 3), np.float32), np.eye(2, dtype=np.float32))
        assert float(net.updater_state["__numerics__"]["packed"][0]) == 0.0
        return
    from deeplearning4j_tpu.models.sequential import (
        MultiLayerNetwork as JNet,
    )
    from deeplearning4j_tpu.nn.conf import MultiLayerConfiguration as JConf

    jnet = JNet(JConf.from_json(conf.to_json())).init()
    net.set_params_vector(np.asarray(jnet.params_to_vector()))
    x = np.arange(6, dtype=np.float32).reshape(2, 3) / 6.0
    y = np.eye(2, dtype=np.float32)
    net.fit(x, y)
    jnet.fit(x, y)
    assert net.iteration == jnet.iteration == 1
    np.testing.assert_allclose(net.params_to_vector(),
                               np.asarray(jnet.params_to_vector()),
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(net.score_value, jnet.score_value,
                               rtol=1e-3, atol=1e-4)


def test_dtype_policy_matches_jax(monkeypatch):
    import subprocess
    import sys

    from deeplearning4j_tpu.backend import device as jdev
    from deeplearning4j_tpu_torch.backend import device as dev

    assert sorted(dev._POLICIES) == sorted(jdev._POLICIES)
    for name, p in dev._POLICIES.items():
        jp = jdev._POLICIES[name]
        assert [str(getattr(p, f)).split(".")[-1] for f in
                ("param_dtype", "compute_dtype", "accum_dtype")] == \
            [np.dtype(getattr(jp, f)).name for f in
             ("param_dtype", "compute_dtype", "accum_dtype")]
    monkeypatch.setattr(dev, "_current_policy", dev.dtype_policy())
    policy = dev.set_dtype_policy("bfloat16")
    assert dev.dtype_policy() is policy
    x = {"a": torch.ones(2), "ids": torch.arange(3), "t": (torch.ones(1),)}
    cast = policy.cast_input(x)
    assert cast["a"].dtype == torch.bfloat16
    assert cast["ids"].dtype == torch.int64
    assert cast["t"][0].dtype == torch.bfloat16
    # the default comes from DL4J_TPU_DTYPE, read when the module loads
    out = subprocess.run(
        [sys.executable, "-c", "from deeplearning4j_tpu_torch.backend "
         "import device; print(device.dtype_policy().compute_dtype)"],
        env={**__import__("os").environ, "DL4J_TPU_DTYPE": "bfloat16"},
        capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "torch.bfloat16"
