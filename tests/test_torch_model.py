"""Model-level parity of the port (``deeplearning4j_tpu_torch/models/``):
the committed transformer and GravesLSTM checkpoints, weights carried
across from a JAX network, the zoo's config JSON, and the port's own zip
round trip.

Tolerances: the committed fixtures at ``rtol=1e-3, atol=1e-4`` (those of
``tests/test_regression.py``); same-weights parity at ``atol=1e-5``
(float32, different summation orders)."""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from deeplearning4j_tpu.models.serialization import (
    restore_multi_layer_network as jax_restore,
)
from deeplearning4j_tpu.models.zoo import (
    graves_lstm_char_lm as jax_lstm_lm, transformer_char_lm as jax_lm,
)
from deeplearning4j_tpu_torch.models import serialization, zoo
from deeplearning4j_tpu_torch.models.interop import params_from_numpy
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration

FIXTURES = Path(__file__).parent / "regression_fixtures"
VOCAB = 29


@pytest.mark.parametrize("name", ["transformer", "transformer_v2", "lstm"])
def test_committed_checkpoint_matches_expected(name):
    net = serialization.restore_multi_layer_network(FIXTURES / f"{name}.zip",
                                                    device="cpu")
    x = np.load(FIXTURES / f"{name}_input.npy")
    expected = np.load(FIXTURES / f"{name}_expected.npy")
    out = net.output(x)
    assert out.device.type == "cpu" and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), expected, rtol=1e-3, atol=1e-4)


def test_lstm_zip_restores_rmsprop_state_and_resumes_as_jax():
    """``lstm.zip`` (GravesLSTM, RMSProp, three steps) restores its
    config, weights and RMSProp's ``ms`` on the port, and one more
    ``fit`` step lands where the JAX package's does."""
    path = FIXTURES / "lstm.zip"
    net = serialization.restore_multi_layer_network(path, device="cpu")
    jnet = jax_restore(path)
    assert net.iteration == jnet.iteration == 3
    ms = jax.device_get(jnet.updater_state["ms"])
    assert sorted(net.updater_state) == ["ms"]
    for layer, tree in ms.items():
        for k, v in tree.items():
            np.testing.assert_array_equal(
                net.updater_state["ms"][layer][k].numpy(), v)
    x = np.load(FIXTURES / "lstm_input.npy")
    y = np.eye(4, dtype=np.float32)[np.arange(12).reshape(2, 6) % 4]
    net.fit(x, y)
    jnet.fit(x, y)
    assert net.iteration == jnet.iteration == 4
    want = jax.device_get(jnet.params)
    for layer, tree in want.items():
        for k, v in tree.items():
            np.testing.assert_allclose(net.params[layer][k].numpy(), v,
                                       rtol=1e-4, atol=1e-5)


def test_zoo_lstm_config_json_matches_reference():
    kw = dict(vocab_size=VOCAB, hidden=16, tbptt=12)
    port = zoo.graves_lstm_char_lm(device="cpu", **kw)
    assert port.conf.to_dict() == jax_lstm_lm(**kw).conf.to_dict()
    assert port.conf.backprop_type == "truncated_bptt"
    assert port.conf.tbptt_fwd_length == 12
    assert port.conf.updater.name == "rmsprop"
    assert port.params["layer_0"]["W"].shape == (VOCAB, 64)


@pytest.fixture(scope="module")
def jax_net():
    return jax_lm(vocab_size=VOCAB, d_model=32, n_heads=4, n_kv_heads=2,
                  layers=2)


def _ids(seed, shape=(2, 9)):
    return np.random.default_rng(seed).integers(0, VOCAB, shape).astype(
        np.int32)


def _port_of(jnet):
    conf = MultiLayerConfiguration.from_json(jnet.conf.to_json())
    return params_from_numpy(conf, jax.device_get(jnet.params), device="cpu")


def test_params_from_numpy_same_logits(jax_net):
    x = _ids(0)
    ref = np.asarray(jax_net.output(x))
    out = _port_of(jax_net).output(x).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5)


def test_params_from_numpy_checks_names_and_shapes(jax_net):
    conf = MultiLayerConfiguration.from_json(jax_net.conf.to_json())
    tree = jax.device_get(jax_net.params)
    bad = {**tree, "layer_0": {**tree["layer_0"], "W": tree["layer_0"]["W"].T}}
    with pytest.raises(ValueError, match="layer_0/W"):
        params_from_numpy(conf, bad, device="cpu")
    missing = {**tree, "layer_1": {"sub0": tree["layer_1"]["sub0"]}}
    with pytest.raises(ValueError, match="layer_1"):
        params_from_numpy(conf, missing, device="cpu")


def test_zoo_config_json_matches_reference():
    kw = dict(vocab_size=VOCAB, d_model=32, n_heads=4, n_kv_heads=2,
              layers=2, compute_dtype="bfloat16")
    port = zoo.transformer_char_lm(device="cpu", **kw)
    assert port.conf.to_dict() == jax_lm(**kw).conf.to_dict()
    assert port.params["layer_0"]["W"].dtype == torch.float32
    # the seed fixes the port's weights, on every device
    again = zoo.transformer_char_lm(device="cpu", **kw)
    assert torch.equal(port.params["layer_1"]["sub1"]["Wq"],
                       again.params["layer_1"]["sub1"]["Wq"])


def test_port_zip_round_trip(jax_net, tmp_path):
    net = _port_of(jax_net)
    path = tmp_path / "port.zip"
    serialization.write_model(net, path)
    assert serialization.read_manifest(path)["model_type"] == "MultiLayerNetwork"
    back = serialization.restore_multi_layer_network(path, device="cpu")
    x = _ids(1)
    np.testing.assert_array_equal(back.output(x).numpy(), net.output(x).numpy())
    # the JAX package restores the port's zip to the same function
    np.testing.assert_allclose(np.asarray(jax_restore(path).output(x)),
                               back.output(x).numpy(), atol=1e-5)


@pytest.mark.parametrize("entry", ["zoo", "restore", "interop"])
def test_entry_points_refuse_the_cpu_unless_asked(entry, jax_net, monkeypatch):
    """With no GPU and no explicit device="cpu" every entry point raises
    instead of quietly running on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if entry == "zoo":
            zoo.transformer_char_lm(vocab_size=VOCAB, d_model=32, layers=1)
        elif entry == "restore":
            serialization.restore_multi_layer_network(
                FIXTURES / "transformer.zip")
        else:
            params_from_numpy(
                MultiLayerConfiguration.from_json(jax_net.conf.to_json()),
                jax.device_get(jax_net.params))
