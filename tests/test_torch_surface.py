"""The facades' public surface in the port against the JAX facades, on the
committed fixtures (``tests/regression_fixtures/``): ``output`` with a
features mask, ``feed_forward``, ``num_params``, the flat parameter
vector, ``clone``, the configurations' YAML, and the named raise of what
``MultiLayerNetwork`` does not port yet.

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


@pytest.mark.parametrize("method, item", [
    ("fit_scanned", "A2"), ("rnn_time_step", "A6"), ("pretrain", "A7"),
    ("set_listeners", "A8"), ("add_listener", "A8"), ("evaluate", "A8")])
def test_unported_sequential_methods_name_their_item(method, item):
    net = _port("mlp")
    with pytest.raises(NotImplementedError,
                       match=f"MultiLayerNetwork.{method} .*ROADMAP {item}"):
        getattr(net, method)(None)
