"""Early stopping in the port (``earlystopping.py``): the reference's
fourteen cases of ``tests/test_earlystopping.py`` run on the port, each
trainer case beside the JAX trainer on the same initial weights with the
same termination reason, epochs, best epoch and best score, and the
early-stopping baseline fault of the reference (ROADMAP C2) repaired.

Tolerances: scores at ``rtol=1e-4, atol=1e-5`` (float32 steps on the same
weights, different summation orders)."""

import math

import numpy as np
import pytest

import jax

from deeplearning4j_tpu import earlystopping as jes
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.iterator import (
    ListDataSetIterator as JListIterator,
)
from deeplearning4j_tpu.models.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.models.sequential import MultiLayerNetwork as JNet
from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JConf
from deeplearning4j_tpu_torch import earlystopping as es
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.datasets.iterator import ListDataSetIterator
from deeplearning4j_tpu_torch.models.graph import GraphConfiguration
from deeplearning4j_tpu_torch.models.interop import (
    graph_params_from_numpy, params_from_numpy,
)
from deeplearning4j_tpu_torch.models.sequential import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.optimize import solvers

RTOL, ATOL = 1e-4, 1e-5
X = np.array([[0, 0], [0, 1], [1, 0], [1, 1]], np.float32)
Y = np.array([[1, 0], [0, 1], [0, 1], [1, 0]], np.float32)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def make_nets(lr=0.5, algo="stochastic_gradient_descent", iters=1):
    """The reference's ``make_net`` on the JAX facade, and the port's
    net on its initial weights."""
    conf = (JConf.builder().seed(7).updater("sgd", learning_rate=lr)
            .optimization_algo(algo).iterations(iters).list()
            .layer(jl.DenseLayer(n_in=2, n_out=8, activation="tanh",
                                 weight_init="xavier"))
            .layer(jl.OutputLayer(n_in=8, n_out=2, loss="mcxent",
                                  activation="softmax"))
            .build())
    jnet = JNet(conf).init()
    net = params_from_numpy(MultiLayerConfiguration.from_json(
        conf.to_json()), _np(jnet.params), device="cpu")
    return net, jnet


def graph_nets(b):
    conf = (b.graph().add_inputs("in")
            .add_layer("h", jl.DenseLayer(n_in=2, n_out=8,
                                          activation="tanh"), "in")
            .add_layer("out", jl.OutputLayer(n_in=8, n_out=2), "h")
            .set_outputs("out").build())
    jnet = JGraph(conf).init()
    net = graph_params_from_numpy(GraphConfiguration.from_json(
        conf.to_json()), _np(jnet.params), device="cpu")
    return net, jnet


def xor_iter(batch=4):
    return ListDataSetIterator(DataSet(X, Y), batch)


def jxor_iter(batch=4):
    return JListIterator(JDataSet(X, Y), batch)


def _run(net, jnet, build):
    """``build(es module, iterator factory)`` -> configuration, run on
    both trainers; the two results, checked to agree."""
    r = es.EarlyStoppingTrainer(build(es, xor_iter), net, xor_iter()).fit()
    jr = jes.EarlyStoppingTrainer(build(jes, jxor_iter), jnet,
                                  jxor_iter()).fit()
    assert r.termination_reason.value == jr.termination_reason.value
    assert r.total_epochs == jr.total_epochs
    assert r.best_model_epoch == jr.best_model_epoch
    np.testing.assert_allclose(r.best_model_score, jr.best_model_score,
                               rtol=RTOL, atol=ATOL)
    assert sorted(r.score_vs_epoch) == sorted(jr.score_vs_epoch)
    np.testing.assert_allclose(
        [r.score_vs_epoch[k] for k in sorted(r.score_vs_epoch)],
        [jr.score_vs_epoch[k] for k in sorted(jr.score_vs_epoch)],
        rtol=RTOL, atol=ATOL)
    return r


def test_max_epochs_termination():
    net, jnet = make_nets()

    def build(m, it):
        return (m.EarlyStoppingConfiguration.Builder()
                .epoch_termination_conditions(
                    m.MaxEpochsTerminationCondition(5))
                .score_calculator(m.DataSetLossCalculator(it()))
                .model_saver(m.InMemoryModelSaver()).build())

    result = _run(net, jnet, build)
    assert result.termination_reason == \
        es.TerminationReason.EPOCH_TERMINATION_CONDITION
    assert result.total_epochs == 5
    assert result.best_model is not None
    assert len(result.score_vs_epoch) == 5
    assert math.isclose(result.best_model_score,
                        min(result.score_vs_epoch.values()), rel_tol=1e-9)
    # the best model held in memory reproduces its score
    assert math.isclose(
        es.DataSetLossCalculator(xor_iter()).calculate_score(
            result.best_model), result.best_model_score, rel_tol=1e-6)


def test_score_improvement_patience_stops_on_plateau():
    net, jnet = make_nets(lr=0.0)      # lr 0: the score never improves

    def build(m, it):
        return (m.EarlyStoppingConfiguration.Builder()
                .epoch_termination_conditions(
                    m.ScoreImprovementEpochTerminationCondition(3),
                    m.MaxEpochsTerminationCondition(50))
                .score_calculator(m.DataSetLossCalculator(it())).build())

    result = _run(net, jnet, build)
    assert result.termination_reason == \
        es.TerminationReason.EPOCH_TERMINATION_CONDITION
    assert result.total_epochs <= 6


def test_max_score_iteration_termination():
    net, jnet = make_nets()

    def build(m, it):
        return (m.EarlyStoppingConfiguration.Builder()
                .iteration_termination_conditions(
                    m.MaxScoreIterationTerminationCondition(1e-9))
                .epoch_termination_conditions(
                    m.MaxEpochsTerminationCondition(50))
                .score_calculator(m.DataSetLossCalculator(it())).build())

    result = _run(net, jnet, build)
    assert result.termination_reason == \
        es.TerminationReason.ITERATION_TERMINATION_CONDITION


def test_invalid_score_guard():
    c = es.InvalidScoreIterationTerminationCondition()
    assert c.terminate(float("nan"))
    assert c.terminate(float("inf"))
    assert not c.terminate(1.0)


def test_invalid_score_baseline_is_taken_when_built(monkeypatch):
    """ROADMAP C2: the reference compares the process's non-finite step
    counter against 0 when ``initialize()`` never ran, so a guarded step
    that skipped earlier in the process ends a later run on a finite
    score.  The port's condition takes its baseline when it is built (and
    again at ``initialize()``): only steps counted after that end it."""
    from deeplearning4j_tpu import observability as jobs
    from deeplearning4j_tpu_torch import observability as obs

    for mod in (obs, jobs):
        # a registry of the test's own, the process's put back after it
        reg = mod.MetricsRegistry()
        monkeypatch.setattr(mod.metrics, "_global_registry", reg)
        reg.counter("dl4j_nonfinite_steps_total",
                    labels=("component",)).inc(component="earlier")
    c = es.InvalidScoreIterationTerminationCondition()
    jc = jes.InvalidScoreIterationTerminationCondition()
    assert not c.terminate(1.0)
    assert jc.terminate(1.0)           # the reference's fault
    obs.get_registry().counter(
        "dl4j_nonfinite_steps_total", labels=("component",)).inc(
        component="this run")
    assert c.terminate(1.0)
    c.initialize()
    assert not c.terminate(1.0)


def test_max_time_condition():
    c = es.MaxTimeIterationTerminationCondition(0.0)
    c.initialize()
    assert c.terminate(1.0)


def test_best_score_condition_and_local_saver(tmp_path):
    net, jnet = make_nets(lr=1.0)
    dirs = {es: tmp_path / "port", jes: tmp_path / "jax"}

    def build(m, it):
        saver = m.LocalFileModelSaver(
            str(dirs[m]), MultiLayerNetwork if m is es else JNet)
        return (m.EarlyStoppingConfiguration.Builder()
                .epoch_termination_conditions(
                    m.BestScoreEpochTerminationCondition(0.3),
                    m.MaxEpochsTerminationCondition(400))
                .score_calculator(m.DataSetLossCalculator(it()))
                .model_saver(saver).save_last_model().build())

    r = es.EarlyStoppingTrainer(build(es, xor_iter), net, xor_iter())
    result = r.fit()
    jr = jes.EarlyStoppingTrainer(build(jes, jxor_iter), jnet,
                                  jxor_iter()).fit()
    assert result.best_model_score < 0.31
    assert result.total_epochs == jr.total_epochs
    assert result.best_model_epoch == jr.best_model_epoch
    np.testing.assert_allclose(result.best_model_score, jr.best_model_score,
                               rtol=RTOL, atol=ATOL)
    saver = r.config.model_saver
    best, latest = saver.get_best_model(), saver.get_latest_model()
    assert best is not None and latest is not None
    assert best.device == net.device
    sc = es.DataSetLossCalculator(xor_iter()).calculate_score(best)
    assert math.isclose(sc, result.best_model_score, rel_tol=1e-5)


def quadratic(center):
    center = np.asarray(center, np.float64)

    def vg(x):
        d = x - center
        return float(np.dot(d, d)), 2.0 * d

    return vg


def test_lbfgs_minimizes_quadratic():
    x, fx = solvers.lbfgs(quadratic([1.0, -2.0, 3.0]), np.zeros(3), 50)
    assert fx < 1e-8
    np.testing.assert_allclose(x, [1.0, -2.0, 3.0], atol=1e-4)


def test_cg_minimizes_quadratic():
    _, fx = solvers.conjugate_gradient(quadratic([0.5, 0.5]), np.zeros(2),
                                       50)
    assert fx < 1e-8


def test_line_gd_minimizes_quadratic():
    _, fx = solvers.line_gradient_descent(quadratic([2.0]), np.zeros(1), 100)
    assert fx < 1e-6


def test_rosenbrock_lbfgs():
    def vg(x):
        a, b = 1.0, 100.0
        f = (a - x[0]) ** 2 + b * (x[1] - x[0] ** 2) ** 2
        g = np.array([-2 * (a - x[0]) - 4 * b * x[0] * (x[1] - x[0] ** 2),
                      2 * b * (x[1] - x[0] ** 2)])
        return float(f), g

    _, fx = solvers.lbfgs(vg, np.array([-1.2, 1.0]), 200)
    assert fx < 1e-6


@pytest.mark.parametrize("algo", ["lbfgs", "conjugate_gradient",
                                  "line_gradient_descent"])
def test_network_trains_with_solver(algo):
    """Two ``fit`` calls, each ``iters`` solver iterations on the full
    batch, lower the score, as the JAX facade's on the same weights."""
    net, jnet = make_nets(algo=algo, iters=30)
    s0 = net.score(X, Y)
    np.testing.assert_allclose(s0, float(jnet.score(X, Y)), rtol=RTOL)
    for _ in range(2):
        net.fit(X, Y)
        jnet.fit(X, Y)
    assert net.score(X, Y) < s0
    np.testing.assert_allclose(net.score(X, Y), float(jnet.score(X, Y)),
                               rtol=1e-3, atol=1e-4)


def test_lbfgs_solves_xor_fully():
    net, _ = make_nets(algo="lbfgs", iters=100)
    for _ in range(3):
        net.fit(X, Y)
    preds = net.output(X).numpy()
    assert (preds.argmax(-1) == Y.argmax(-1)).all()


def test_early_stopping_with_computation_graph():
    """The trainer is facade-generic: a ComputationGraph under Adam trains
    through the same loop, as the JAX graph on the same weights."""
    net, jnet = graph_nets(JConf.builder().seed(3).updater(
        "adam", learning_rate=0.1))

    def build(m, it):
        return (m.EarlyStoppingConfiguration.Builder()
                .epoch_termination_conditions(
                    m.MaxEpochsTerminationCondition(8))
                .score_calculator(m.DataSetLossCalculator(it()))
                .model_saver(m.InMemoryModelSaver()).build())

    result = _run(net, jnet, build)
    assert result.total_epochs == 8
    assert result.best_model is not None
    assert np.isfinite(result.best_model_score)
    scores = list(result.score_vs_epoch.values())
    assert scores[-1] < scores[0]


def test_computation_graph_trains_with_lbfgs():
    net, jnet = graph_nets(JConf.builder().seed(5)
                           .optimization_algo("lbfgs").iterations(50))
    s0 = net.score(X, Y)
    for _ in range(2):
        net.fit(X, Y)
        jnet.fit(X, Y)
    assert net.score(X, Y) < s0
    np.testing.assert_allclose(net.score(X, Y), float(jnet.score(X, Y)),
                               rtol=1e-3, atol=1e-4)


def test_distributed_early_stopping_on_a_slot_mesh():
    """``DistributedEarlyStoppingTrainer`` over a real ``DistributedNetwork``
    (the sync master on 4 CPU slots; reference
    ``tests/test_distributed_extras.py``): the same termination, epochs,
    best epoch and scores as the JAX trainer over 4 virtual devices."""
    from deeplearning4j_tpu import parallel as jpar
    from deeplearning4j_tpu.backend import device as jbackend
    from deeplearning4j_tpu_torch import parallel as tpar
    from deeplearning4j_tpu_torch.backend import mesh as tmesh

    net, jnet = make_nets(lr=0.5)
    rs = np.random.RandomState(0)
    x = rs.rand(64, 2).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[(x.sum(1) > 1).astype(int)]

    def build(mod, it, rows):
        return (mod.EarlyStoppingConfiguration.Builder()
                .epoch_termination_conditions(
                    mod.MaxEpochsTerminationCondition(3))
                .score_calculator(mod.DataSetLossCalculator(it(rows, 16)))
                .model_saver(mod.InMemoryModelSaver())
                .build())

    dist = tpar.DistributedNetwork(net, tpar.SyncTrainingMaster(
        mesh=tmesh.default_mesh(data=4, devices=["cpu"] * 4)))
    jdist = jpar.DistributedNetwork(jnet, jpar.SyncTrainingMaster(
        mesh=jbackend.default_mesh(data=4, devices=jax.devices()[:4])))
    r = es.DistributedEarlyStoppingTrainer(
        build(es, lambda n, b: ListDataSetIterator(DataSet(x[:n], y[:n]), b),
              32),
        dist, ListDataSetIterator(DataSet(x, y), 16)).fit()
    jr = jes.DistributedEarlyStoppingTrainer(
        build(jes, lambda n, b: JListIterator(JDataSet(x[:n], y[:n]), b), 32),
        jdist, JListIterator(JDataSet(x, y), 16)).fit()
    assert r.termination_reason.value == jr.termination_reason.value
    assert r.total_epochs == jr.total_epochs == 3
    assert r.best_model_epoch == jr.best_model_epoch
    assert r.best_model is not None
    np.testing.assert_allclose(
        [r.score_vs_epoch[k] for k in sorted(r.score_vs_epoch)],
        [jr.score_vs_epoch[k] for k in sorted(jr.score_vs_epoch)],
        rtol=RTOL, atol=ATOL)
