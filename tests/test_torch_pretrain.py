"""Layerwise pretraining in the port: the AutoEncoder and RBM layers
against the JAX package on carried weights, the CD-k surrogate on a
given chain against ``jax.grad``, the sampler's moments, ``pretrain`` on
both facades against the JAX facades, the captured pretraining step
(the card's calls emulated) against the eager one, zoo ``dbn`` and a
JAX zip of it.

JAX's random streams cannot be matched in torch, so the Gibbs chain's
parity goes through chains given as numpy and through moments, never
through seeds.  Tolerances: layers at ``atol=1e-5``; nets at
``rtol=1e-3, atol=1e-4`` (float32, different summation orders)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.models.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.models.sequential import MultiLayerNetwork as JNet
from deeplearning4j_tpu.models.zoo import dbn as jax_dbn
from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JConf
from deeplearning4j_tpu_torch.backend import rng as rng_mod
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.models import serialization
from deeplearning4j_tpu_torch.models.common import tree_leaves
from deeplearning4j_tpu_torch.models.graph import GraphConfiguration
from deeplearning4j_tpu_torch.models.interop import (
    graph_params_from_numpy, params_from_numpy,
)
from deeplearning4j_tpu_torch.models.zoo import dbn
from deeplearning4j_tpu_torch.models.sequential import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.conf import (
    MultiLayerConfiguration, NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.layers import RBM, AutoEncoder, OutputLayer

ATOL = 1e-5
RTOL_NET, ATOL_NET = 1e-3, 1e-4


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _torch(tree):
    return {k: torch.tensor(np.asarray(v, np.float32)) for k, v in tree.items()}


def _rand(seed, *shape):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _close(got, want, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol)


# ----------------------------------------------------------------- layers
@pytest.mark.parametrize("activation", ["sigmoid", "tanh"])
def test_autoencoder_encode_decode_and_loss_match_jax(activation):
    j = jl.AutoEncoder(n_in=7, n_out=4, corruption_level=0.0,
                       activation=activation, name="ae")
    t = AutoEncoder(n_in=7, n_out=4, corruption_level=0.0,
                    activation=activation, name="ae")
    p = j.init(jax.random.key(3))
    p = {**p, "b": p["b"] + 0.1, "vb": p["vb"] - 0.2}
    pt = _torch(p)
    x = _rand(1, 5, 7)
    _close(t.encode(pt, torch.tensor(x)), j.encode(p, x))
    y = t.encode(pt, torch.tensor(x))
    _close(t.decode(pt, y), j.decode(p, jnp.asarray(y.numpy())))
    _close(t.apply(pt, torch.tensor(x)), j.apply(p, {}, x)[0])
    _close(t.pretrain_loss(pt, torch.tensor(x), None),
           j.pretrain_loss(p, x, jax.random.key(0)))


@pytest.mark.parametrize("visible", ["binary", "gaussian"])
@pytest.mark.parametrize("hidden", ["binary", "gaussian"])
def test_rbm_props_free_energy_and_reconstruction_match_jax(visible,
                                                             hidden):
    j = jl.RBM(n_in=6, n_out=5, visible_unit=visible, hidden_unit=hidden,
               name="rbm")
    t = RBM(n_in=6, n_out=5, visible_unit=visible, hidden_unit=hidden,
            name="rbm")
    p = j.init(jax.random.key(4))
    p = {**p, "b": p["b"] + 0.3, "vb": p["vb"] - 0.1}
    pt = _torch(p)
    v = _rand(2, 9, 6)
    h = _rand(3, 9, 5)
    _close(t.prop_up(pt, torch.tensor(v)), j.prop_up(p, v))
    _close(t.prop_down(pt, torch.tensor(h)), j.prop_down(p, h))
    _close(t.apply(pt, torch.tensor(v)), j.apply(p, {}, v)[0])
    _close(t._free_energy(pt, torch.tensor(v)), j._free_energy(p, v))
    _close(t.reconstruction_error(pt, torch.tensor(v)),
           j.reconstruction_error(p, v, jax.random.key(0)))


@pytest.mark.parametrize("visible", ["binary", "gaussian"])
def test_cd_surrogate_and_its_gradient_on_a_given_chain(visible):
    """``cd_loss`` over a chain (v0, vk) given as numpy against
    ``jnp.mean(_free_energy(v0) - _free_energy(vk))`` and its
    ``jax.grad``: the reference's surrogate with vk held constant."""
    j = jl.RBM(n_in=6, n_out=4, visible_unit=visible, name="rbm")
    t = RBM(n_in=6, n_out=4, visible_unit=visible, name="rbm")
    p = j.init(jax.random.key(5))
    v0 = _rand(6, 16, 6)
    vk = (_rand(7, 16, 6) > 0.5).astype(np.float32)
    if visible == "gaussian":
        vk = vk + np.random.RandomState(8).randn(16, 6).astype(np.float32)

    def jloss(pp):
        return jnp.mean(j._free_energy(pp, v0)
                        - j._free_energy(pp, jax.lax.stop_gradient(vk)))

    jl_val, jg = jax.value_and_grad(jloss)(p)
    pt = {k: v.requires_grad_(True) for k, v in _torch(p).items()}
    loss = t.cd_loss(pt, torch.tensor(v0), torch.tensor(vk))
    grads = torch.autograd.grad(loss, list(pt.values()))
    _close(loss.detach(), jl_val)
    for (name, _), g in zip(pt.items(), grads):
        _close(g, jg[name], rtol=1e-5)


def test_rbm_chain_is_outside_autograd_and_keyed():
    """The chain ``pretrain_loss`` builds is the ``gibbs_chain`` of the
    same key (the same draws from a generator and from a device key of
    its seed), and its gradient is the CD surrogate's on that chain."""
    t = RBM(n_in=6, n_out=4, k=2, visible_unit="gaussian", name="rbm")
    p = t.init(torch.Generator().manual_seed(1))
    v0 = torch.tensor(_rand(9, 8, 6))
    gen = torch.Generator().manual_seed(77)
    vk = t.gibbs_chain(p, v0, gen)
    assert not vk.requires_grad
    assert torch.equal(vk, t.gibbs_chain(p, v0, rng_mod.device_key(77,
                                                                   "cpu")))
    pg = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    ga = torch.autograd.grad(t.pretrain_loss(pg, v0, gen), list(pg.values()))
    gb = torch.autograd.grad(t.cd_loss(pg, v0, vk), list(pg.values()))
    for a, b in zip(ga, gb):
        assert torch.equal(a, b)


def test_bernoulli_probs_moments_and_key_parity():
    """Binary samples: the mean of each column within 4 sigma of its
    probability; a generator key and a device key of one seed draw the
    same samples; the draws are the uniforms below the probabilities."""
    n = 40000
    probs = torch.tensor([0.02, 0.3, 0.5, 0.77, 0.999]).repeat(n, 1)
    gen = torch.Generator().manual_seed(123)
    s = rng_mod.bernoulli_probs(gen, probs)
    assert s.dtype == probs.dtype and set(s.unique().tolist()) <= {0.0, 1.0}
    p = probs[0]
    sigma = torch.sqrt(p * (1 - p) / n)
    assert bool(((s.mean(0) - p).abs() <= 4 * sigma).all()), s.mean(0)
    assert torch.equal(s, rng_mod.bernoulli_probs(
        rng_mod.device_key(123, "cpu"), probs))
    u = rng_mod.uniform(gen, probs.shape, "cpu")
    assert torch.equal(s, (u < probs).float())
    assert not torch.equal(s, rng_mod.bernoulli_probs(
        torch.Generator().manual_seed(124), probs))


def test_normal_moments_and_key_parity():
    n = 200000
    gen = torch.Generator().manual_seed(5)
    z = rng_mod.normal(gen, (n,), "cpu")
    assert bool(torch.isfinite(z).all())
    assert abs(z.mean().item()) <= 4 / np.sqrt(n)
    assert abs(z.var().item() - 1.0) <= 4 * np.sqrt(2.0 / n)
    # the tails are there: Box-Muller from 24-bit uniforms reaches ~5.8
    assert z.abs().max().item() > 4.0
    assert torch.equal(z, rng_mod.normal(rng_mod.device_key(5, "cpu"), (n,),
                                         "cpu"))
    assert rng_mod.normal(gen, (3, 4), "cpu", torch.float64).dtype == \
        torch.float64


def test_gaussian_visible_sample_is_mean_plus_unit_noise():
    t = RBM(n_in=5, n_out=3, visible_unit="gaussian", name="rbm")
    probs = torch.tensor(_rand(2, 50000, 5))
    s = t._sample(torch.Generator().manual_seed(9), probs, "gaussian")
    noise = s - probs
    assert abs(noise.mean().item()) <= 4 / np.sqrt(noise.numel())
    assert abs(noise.var().item() - 1.0) <= 4 * np.sqrt(2.0 / noise.numel())


# ------------------------------------------------------------- pretrain
def _ae_pair(graph):
    b = JConf.builder().seed(11).updater("sgd", learning_rate=0.3)
    dense = jl.DenseLayer(n_in=6, n_out=5, activation="tanh")
    ae = jl.AutoEncoder(n_in=5, n_out=4, corruption_level=0.0,
                        activation="sigmoid")
    out = jl.OutputLayer(n_in=4, n_out=2, loss="mcxent",
                         activation="softmax")
    if graph:
        conf = (b.graph().add_inputs("in").add_layer("d", dense, "in")
                .add_layer("ae", ae, "d").add_layer("out", out, "ae")
                .set_outputs("out").build())
        jnet = JGraph(conf).init()
        net = graph_params_from_numpy(
            GraphConfiguration.from_json(conf.to_json()), _np(jnet.params),
            device="cpu")
    else:
        conf = b.list().layer(dense).layer(ae).layer(out).build()
        jnet = JNet(conf).init()
        net = params_from_numpy(
            MultiLayerConfiguration.from_json(conf.to_json()),
            _np(jnet.params), device="cpu")
    return jnet, net


@pytest.mark.parametrize("graph", [False, True])
def test_autoencoder_pretrain_equals_jax(graph):
    """An AutoEncoder with ``corruption_level=0`` (no draws) pretrained
    for 3 epochs over 3 batches through a dense layer on each facade
    equals the JAX facade's, parameter for parameter; the layers that do
    not pretrain keep their weights."""
    jnet, net = _ae_pair(graph)
    before = {k: [t.clone() for t in tree_leaves(v)]
              for k, v in net.params.items()}
    batches = [_rand(20 + i, 8, 6) for i in range(3)]
    jnet.pretrain(list(batches), epochs=3)
    net.pretrain(batches, epochs=3)
    want = _np(jnet.params)
    for name, tree in net.params.items():
        for pname, p in tree.items():
            _close(p, want[name][pname], atol=ATOL_NET, rtol=RTOL_NET)
    ae = "ae" if graph else "layer_1"
    assert not torch.equal(net.params[ae]["W"], before[ae][0])
    for name, leaves in before.items():
        if name != ae:
            assert all(torch.equal(a, b) for a, b in
                       zip(leaves, tree_leaves(net.params[name])))


def test_graph_pretrain_takes_each_batch_form():
    """A DataSet, a (features, labels) tuple, a dict by input name and a
    bare array are the same batch to ``ComputationGraph.pretrain``."""
    x = _rand(30, 8, 6)
    y = np.eye(2, dtype=np.float32)[np.arange(8) % 2]
    nets = [_ae_pair(True)[1] for _ in range(4)]
    for net, batch in zip(nets, [DataSet(x, y), (x, y), {"in": x}, x]):
        net.pretrain([batch], epochs=2)
    for other in nets[1:]:
        for a, b in zip(tree_leaves(nets[0].params),
                        tree_leaves(other.params)):
            assert torch.equal(a, b)


def test_dbn_pretrain_then_finetune():
    """The reference's ``test_zoo.py::test_dbn_pretrain_then_finetune`` on
    the port: layerwise CD-k changes RBM 0's weights, then supervised
    ``fit`` learns a separable toy problem."""
    net = dbn(n_in=12, hidden=(8, 6), n_classes=2, lr=0.05, device="cpu")
    rs = np.random.RandomState(0)
    x = rs.rand(32, 12).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[(x[:, 0] > 0.5).astype(int)]
    w_before = net.params["layer_0"]["W"].clone()
    net.pretrain([x], epochs=2)
    assert not torch.allclose(w_before, net.params["layer_0"]["W"]), \
        "pretrain did not touch RBM 0"
    net.fit(x, y)
    first_score = float(net.score_value)
    for _ in range(30):
        net.fit(x, y)
    assert np.isfinite(net.score_value)
    assert float(net.score_value) < first_score, "supervised fit did not learn"
    assert tuple(net.output(x).shape) == (32, 2)


def test_rbm_pretrain_lowers_reconstruction_error():
    """The reference's ``test_rbm_cd_reduces_reconstruction_error`` through
    the port's ``pretrain``: 100 CD-1 steps on binary data."""
    rs = np.random.RandomState(4)
    x = (rs.rand(64, 6) > 0.5).astype(np.float32)
    conf = (NeuralNetConfiguration.builder().seed(2)
            .updater("sgd", learning_rate=0.1).list()
            .layer(RBM(n_in=6, n_out=4, k=1))
            .layer(OutputLayer(n_in=4, n_out=2)).build())
    net = MultiLayerNetwork(conf).init(device="cpu")
    layer, p = net.layers[0], net.params["layer_0"]
    err0 = float(layer.reconstruction_error(p, torch.tensor(x)))
    net.pretrain([x] * 100)
    err1 = float(layer.reconstruction_error(p, torch.tensor(x)))
    assert err1 < err0


def test_dbn_config_matches_jax_and_its_zip_restores_exactly(tmp_path):
    """Zoo ``dbn`` builds the JAX builder's JSON and parameter count; a
    JAX zip of a pretrained DBN restores into the port exactly, and its
    output agrees."""
    import json

    kw = dict(n_in=12, hidden=(8, 6), n_classes=3)
    jnet = jax_dbn(**kw)
    net = dbn(device="cpu", **kw)
    assert json.loads(net.conf.to_json()) == json.loads(jnet.conf.to_json())
    assert net.num_params() == jnet.num_params()
    x = _rand(40, 10, 12)
    jnet.pretrain([x], epochs=1)
    path = tmp_path / "dbn.zip"
    jnet.save(str(path))
    back = serialization.restore_multi_layer_network(path, device="cpu")
    want = _np(jnet.params)
    for name, tree in back.params.items():
        for pname, p in tree.items():
            np.testing.assert_array_equal(p.numpy(), want[name][pname])
    _close(back.output(x), jnet.output(x), atol=ATOL_NET, rtol=RTOL_NET)


def test_captured_pretrain_equals_eager(monkeypatch):
    """The captured pretraining path (the card's calls emulated): one
    program a layer for the batch signature, captured once and replayed
    after, the key staged into its device key; its parameters equal the
    eager pretraining's bit for bit."""
    from tests.test_torch_tbptt import _emulate_capture

    kw = dict(n_in=12, hidden=(8, 6), n_classes=2, lr=0.05, device="cpu")
    net, eager = dbn(**kw), dbn(**kw)
    _emulate_capture(monkeypatch, net)
    batches = [_rand(50 + i, 16, 12) for i in range(3)]
    net.pretrain(batches, epochs=2)
    eager.pretrain(batches, epochs=2)
    for a, b in zip(tree_leaves(net.params), tree_leaves(eager.params)):
        assert torch.equal(a, b)
    graphs = net._step_graphs
    keys = sorted(k[-1] for k in graphs.programs if k[0] == "pretrain")
    assert keys == ["layer_0", "layer_1"]
    assert graphs.captures == 2 and graphs.replays == 2 * (2 * 3 - 1)
