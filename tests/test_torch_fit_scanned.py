"""``fit_scanned`` on both of the port's facades, the cases of the JAX
package's ``tests/test_scanned_fit.py`` ported: windows, short tails and
all-tail, dropout on one key stream, a shape change splitting the
window, LeNet, the guards, and the ``ComputationGraph`` with a
MultiDataSet-like object.  The oracle is the port's own ``fit`` over the
same batches from the same weights (carried across from the JAX nets,
``models/interop.py``), at ``rtol=1e-6, atol=1e-7``; and, for an Adam
net with a step learning-rate schedule and a Nesterov net with a
momentum schedule, the JAX package's ``fit_scanned`` on the same
weights, at ``test_three_adam_steps_match_jax``'s ``rtol=1e-4,
atol=1e-5`` (float32, different summation orders).  On every device
each batch of a port window runs the per-batch step (on the card a
replay of the one captured step graph, ``tests/test_torch_cuda.py``),
so the cases held against the port's ``fit`` check the windowing —
splits, tails, ``iteration`` and ``score_value`` — and the guards; the
update arithmetic is held against the JAX package's ``fit_scanned``."""

import dataclasses

import numpy as np
import pytest

import jax

from deeplearning4j_tpu.models.graph import ComputationGraph as JCG
from deeplearning4j_tpu.models.sequential import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.models.vertices import MergeVertex as JMerge
from deeplearning4j_tpu.models.zoo import lenet as jax_lenet
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.layers import (
    DenseLayer as JDense, OutputLayer as JOutput,
)
from deeplearning4j_tpu_torch.models.common import tree_leaves
from deeplearning4j_tpu_torch.models.graph import GraphConfiguration
from deeplearning4j_tpu_torch.models.interop import (
    graph_params_from_numpy, params_from_numpy,
)
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration

RTOL, ATOL = 1e-6, 1e-7
RTOL_JAX, ATOL_JAX = 1e-4, 1e-5


def _jmlp(seed=3, dropout=0.0, **updater):
    updater = updater or dict(name="adam", learning_rate=1e-2)
    name = updater.pop("name")
    b = (JNNC.builder().seed(seed).updater(name, **updater).list()
         .layer(JDense(n_in=12, n_out=16, activation="tanh",
                       dropout=dropout))
         .layer(JOutput(n_in=16, n_out=4)))
    return JMLN(b.build()).init()


def _port_of(jnet):
    conf = MultiLayerConfiguration.from_json(jnet.conf.to_json())
    return params_from_numpy(conf, jax.device_get(jnet.params),
                             device="cpu",
                             net_state=jax.device_get(jnet.net_state))


def _batches(n, batch=8, seed=0):
    rs = np.random.RandomState(seed)
    return [(rs.rand(batch, 12).astype(np.float32),
             np.eye(4, dtype=np.float32)[rs.randint(0, 4, batch)])
            for _ in range(n)]


def _same_params(a, b, rtol=RTOL, atol=ATOL):
    got, want = tree_leaves(a.params), tree_leaves(b.params)
    assert len(got) == len(want)
    for x, y in zip(got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=rtol,
                                   atol=atol)


def _per_batch_and_scanned(make, data, k):
    a, b = make(), make()
    for x, y in data:
        a.fit(x, y)
    b.fit_scanned(data, scan_steps=k)
    return a, b


@pytest.mark.parametrize("n_batches,k", [(8, 4), (7, 4), (3, 8)])
def test_scanned_matches_per_batch(n_batches, k):
    """Windows, short tails (7 % 4), and all-tail (3 < 8) all match the
    per-batch path; ``score_value`` is the last loss."""
    jnet = _jmlp()
    a, b = _per_batch_and_scanned(lambda: _port_of(jnet),
                                  _batches(n_batches), k)
    assert b.iteration == a.iteration == n_batches
    _same_params(b, a)
    np.testing.assert_allclose(b.score_value, a.score_value, rtol=RTOL,
                               atol=ATOL)


def test_scanned_dropout_same_rng_stream():
    """Dropout keys come from the same KeyStream in the same order, so
    even stochastic training matches."""
    jnet = _jmlp(dropout=0.3)
    a, b = _per_batch_and_scanned(lambda: _port_of(jnet), _batches(4, seed=1),
                                  4)
    _same_params(b, a)
    # and dropout is on: a net without it lands elsewhere
    c = _port_of(_jmlp())
    c.fit_scanned(_batches(4, seed=1), scan_steps=4)
    assert not np.allclose(tree_leaves(c.params)[0].numpy(),
                           tree_leaves(b.params)[0].numpy())


def test_scanned_shape_change_splits_window():
    data = _batches(4, batch=8) + _batches(4, batch=16, seed=2)
    jnet = _jmlp()
    a, b = _per_batch_and_scanned(lambda: _port_of(jnet), data, 4)
    assert b.iteration == 8
    assert np.isfinite(b.score_value)
    _same_params(b, a)


def test_scanned_lenet_smoke():
    rs = np.random.RandomState(0)
    data = [(rs.rand(16, 784).astype(np.float32),
             np.eye(10, dtype=np.float32)[rs.randint(0, 10, 16)])
            for _ in range(4)]
    jnet = jax_lenet()
    a, b = _per_batch_and_scanned(lambda: _port_of(jnet), data, 4)
    assert b.iteration == 4
    assert np.isfinite(b.score_value)
    _same_params(b, a)


def test_scanned_rejects_unsupported():
    net = _port_of(_jmlp())
    with pytest.raises(ValueError, match="scan_steps"):
        net.fit_scanned(_batches(2), scan_steps=0)
    for field, value, match in (
            ("optimization_algo", "lbfgs", "SGD"),
            ("backprop_type", "truncated_bptt", "TBPTT"),
            ("num_iterations", 2, "num_iterations")):
        bad = _port_of(_jmlp())
        bad.conf = dataclasses.replace(bad.conf, **{field: value})
        with pytest.raises(ValueError, match=match):
            bad.fit_scanned(_batches(2), scan_steps=2)
    x, y = _batches(1)[0]
    with pytest.raises(ValueError, match="masks"):
        net.fit_scanned([(x, y, None, np.ones(8, np.float32))],
                        scan_steps=1)
    assert net.iteration == 0


@pytest.mark.parametrize("name, updater", [
    ("adam_step_lr", dict(name="adam", learning_rate=1e-2, lr_policy="step",
                          lr_policy_decay_rate=0.5, lr_policy_steps=2.0)),
    ("nesterov_momentum_schedule",
     dict(name="nesterovs", learning_rate=0.1, momentum=0.9,
          momentum_schedule={3: 0.5}))])
def test_scanned_matches_jax_fit_scanned(name, updater):
    """The port's ``fit_scanned`` against the JAX package's on the same
    weights and batches: the schedules run on the host per step and
    reach the update as the same float32 values."""
    jnet = _jmlp(**dict(updater))
    net = _port_of(jnet)
    data = _batches(7, seed=6)
    jnet.fit_scanned(data, scan_steps=3)
    net.fit_scanned(data, scan_steps=3)
    assert net.iteration == jnet.iteration == 7
    _same_params(net, jnet, RTOL_JAX, ATOL_JAX)
    np.testing.assert_allclose(net.score_value, float(jnet.score_value),
                               rtol=RTOL_JAX, atol=ATOL_JAX)


# ------------------------------------------------------ ComputationGraph
def _jcg(seed=11):
    conf = (JNNC.builder().seed(seed)
            .updater("adam", learning_rate=1e-2).graph()
            .add_inputs("in")
            .add_layer("d0", JDense(n_in=12, n_out=8, activation="tanh"),
                       "in")
            .add_layer("d1", JDense(n_in=12, n_out=8, activation="relu"),
                       "in")
            .add_vertex("m", JMerge(), "d0", "d1")
            .add_layer("out", JOutput(n_in=16, n_out=4, loss="mcxent",
                                      activation="softmax"), "m")
            .set_outputs("out").build())
    return JCG(conf).init()


def _port_cg(jnet):
    conf = GraphConfiguration.from_json(jnet.conf.to_json())
    return graph_params_from_numpy(conf, jax.device_get(jnet.params),
                                   jax.device_get(jnet.net_state),
                                   device="cpu")


@pytest.mark.parametrize("n_batches,k", [(8, 4), (7, 4)])
def test_cg_scanned_matches_per_batch(n_batches, k):
    jnet = _jcg()
    a, b = _per_batch_and_scanned(lambda: _port_cg(jnet),
                                  _batches(n_batches, seed=4), k)
    assert b.iteration == a.iteration == n_batches
    _same_params(b, a)


@dataclasses.dataclass
class _MultiBatch:
    """Stands in for the reference's ``MultiDataSet`` (ROADMAP A8):
    positional feature and label lists."""
    features: list
    labels: list
    features_masks: list = None
    labels_masks: list = None


@dataclasses.dataclass
class _DataSet:
    features: object
    labels: object


def test_cg_scanned_multidataset_and_guards():
    data = _batches(4, seed=5)
    jnet = _jcg(seed=12)
    a, b = _port_cg(jnet), _port_cg(jnet)
    for x, y in data:
        a.fit(x, y)
    b.fit_scanned([_MultiBatch([x], [y]) for x, y in data], scan_steps=4)
    _same_params(b, a)
    # DataSet-like objects holding dicts, then dict tuples: the same
    c = _port_cg(jnet)
    c.fit_scanned([_DataSet({"in": x}, {"out": y}) for x, y in data[:2]]
                  + [({"in": x}, {"out": y}) for x, y in data[2:]],
                  scan_steps=2)
    _same_params(c, a)
    with pytest.raises(ValueError, match="scan_steps"):
        b.fit_scanned([_MultiBatch([x], [y]) for x, y in data],
                      scan_steps=0)
    with pytest.raises(ValueError, match="masks"):
        b.fit_scanned([_MultiBatch([x], [y], labels_masks=[
            np.ones(8, np.float32)]) for x, y in data], scan_steps=2)
    with pytest.raises(ValueError, match="feature arrays"):
        b.fit_scanned([_MultiBatch([x, x], [y]) for x, y in data],
                      scan_steps=2)


def test_cg_scanned_matches_jax_fit_scanned():
    jnet = _jcg(seed=13)
    net = _port_cg(jnet)
    data = _batches(6, seed=8)
    jnet.fit_scanned(data, scan_steps=4)
    net.fit_scanned(data, scan_steps=4)
    assert net.iteration == jnet.iteration == 6
    _same_params(net, jnet, RTOL_JAX, ATOL_JAX)
