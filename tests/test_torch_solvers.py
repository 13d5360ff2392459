"""The full-batch solvers in the port (``optimize/solvers.py``): the
host-side solvers (copies of the reference's numpy code) against the
JAX package's on the quadratic and Rosenbrock cases, LineGD, CG and
L-BFGS through both facades' ``fit`` against the JAX facades on the
committed ``mlp`` and ``graph`` fixtures, the captured value/grad
program (the card's calls emulated) against the eager one, and the
solver path's bookkeeping (one iteration a batch, listeners once,
``fit_scanned``'s refusal).

Tolerances: the host solvers exactly (the same float64 numpy code on
the same values); nets after 5 solver iterations at ``rtol=1e-3,
atol=1e-4`` (float32 gradients, different summation orders, fed to
float64 line searches)."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from deeplearning4j_tpu.models.serialization import (
    restore_computation_graph as jax_restore_graph,
    restore_multi_layer_network as jax_restore,
)
from deeplearning4j_tpu.optimize import solvers as jsolvers
from deeplearning4j_tpu_torch.models import serialization
from deeplearning4j_tpu_torch.models.common import tree_leaves
from deeplearning4j_tpu_torch.optimize import solvers

FIXTURES = Path(__file__).parent / "regression_fixtures"
RTOL, ATOL = 1e-3, 1e-4
ALGOS = ["lbfgs", "conjugate_gradient", "line_gradient_descent"]


def quadratic(center):
    center = np.asarray(center, np.float64)

    def vg(x):
        d = x - center
        return float(np.dot(d, d)), 2.0 * d

    return vg


def rosenbrock(x):
    a, b = 1.0, 100.0
    f = (a - x[0]) ** 2 + b * (x[1] - x[0] ** 2) ** 2
    g = np.array([-2 * (a - x[0]) - 4 * b * x[0] * (x[1] - x[0] ** 2),
                  2 * b * (x[1] - x[0] ** 2)])
    return float(f), g


CASES = {
    "quadratic3": (quadratic([1.0, -2.0, 3.0]), np.zeros(3), 50),
    "quadratic2": (quadratic([0.5, 0.5]), np.zeros(2), 50),
    "quadratic1": (quadratic([2.0]), np.zeros(1), 100),
    "rosenbrock": (rosenbrock, np.array([-1.2, 1.0]), 200),
}


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_host_solvers_equal_the_reference(algo, case):
    vg, x0, iters = CASES[case]
    x, fx = solvers.solve(algo, vg, x0, iters)
    jx, jfx = jsolvers.solve(algo, vg, x0, iters)
    np.testing.assert_array_equal(x, jx)
    assert fx == jfx


def test_reference_solver_cases():
    """``tests/test_earlystopping.py``'s solver cases on the port's
    module: the quadratics and Rosenbrock minimised."""
    x, fx = solvers.lbfgs(quadratic([1.0, -2.0, 3.0]), np.zeros(3), 50)
    assert fx < 1e-8
    np.testing.assert_allclose(x, [1.0, -2.0, 3.0], atol=1e-4)
    assert solvers.conjugate_gradient(quadratic([0.5, 0.5]), np.zeros(2),
                                      50)[1] < 1e-8
    assert solvers.line_gradient_descent(quadratic([2.0]), np.zeros(1),
                                         100)[1] < 1e-6
    assert solvers.lbfgs(rosenbrock, np.array([-1.2, 1.0]), 200)[1] < 1e-6


def test_unknown_algorithm_names_the_known_ones():
    with pytest.raises(ValueError) as err:
        solvers.solve("newton", quadratic([1.0]), np.zeros(1), 3)
    with pytest.raises(ValueError) as jerr:
        jsolvers.solve("newton", quadratic([1.0]), np.zeros(1), 3)
    assert str(err.value) == str(jerr.value)


# ------------------------------------------------------- through fit
def _nets(name, algo, iters=5):
    if name == "graph":
        net = serialization.restore_computation_graph(
            FIXTURES / "graph.zip", device="cpu")
        jnet = jax_restore_graph(FIXTURES / "graph.zip")
    else:
        net = serialization.restore_multi_layer_network(
            FIXTURES / f"{name}.zip", device="cpu")
        jnet = jax_restore(FIXTURES / f"{name}.zip")
    for n in (net, jnet):
        n.conf = dataclasses.replace(n.conf, optimization_algo=algo,
                                     num_iterations=iters)
    return net, jnet


def _batch(name, seed=0):
    rs = np.random.default_rng(seed)
    if name == "graph":
        x = {k: np.load(FIXTURES / f"graph_input_{k}.npy")
             for k in ("a", "b")}
        n = len(x["a"])
        return x, {"out": np.eye(2, dtype=np.float32)[rs.integers(0, 2, n)]}
    x = np.load(FIXTURES / f"{name}_input.npy")
    return x, np.eye(3, dtype=np.float32)[rs.integers(0, 3, len(x))]


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("name", ["mlp", "graph"])
def test_fit_with_solver_matches_jax(name, algo):
    """Two batches, each one solve of 5 iterations, on each facade:
    parameters, score and iteration against the JAX facade's."""
    net, jnet = _nets(name, algo)
    it0 = net.iteration
    assert it0 == jnet.iteration
    for seed in range(2):
        x, y = _batch(name, seed)
        net.fit(x, y)
        jnet.fit(x, y)
        np.testing.assert_allclose(net.score_value, jnet.score_value,
                                   rtol=RTOL, atol=ATOL)
    assert net.iteration == jnet.iteration == it0 + 2
    for p, q in zip(tree_leaves(net.params),
                    jax.tree_util.tree_leaves(jnet.params)):
        np.testing.assert_allclose(p.numpy(), np.asarray(q), rtol=RTOL,
                                   atol=ATOL)


def test_solver_fit_notifies_listeners_once_a_batch():
    from deeplearning4j_tpu_torch.optimize.listeners import (
        CollectScoresIterationListener,
    )

    net, _ = _nets("mlp", "lbfgs")
    lst = CollectScoresIterationListener()
    net.set_listeners(lst)
    x, y = _batch("mlp")
    it0 = net.iteration
    net.fit([(x, y), (x, y), (x, y)])
    assert [i for i, _ in lst.scores] == [it0 + 1, it0 + 2, it0 + 3]
    assert lst.scores[-1][1] == net.score_value


def test_fit_scanned_refuses_a_solver():
    net, _ = _nets("mlp", "conjugate_gradient")
    x, y = _batch("mlp")
    with pytest.raises(ValueError, match="requires SGD"):
        net.fit_scanned([(x, y)], scan_steps=2)


@pytest.mark.parametrize("name", ["mlp", "graph"])
def test_captured_value_grad_equals_eager(monkeypatch, name):
    """The captured value/grad program (the card's calls emulated): one
    capture a signature across two solves (the batch staged once a
    solve, the vector before each evaluation), every evaluation a replay
    after it, and the fit bit for bit the eager one's."""
    from tests.test_torch_tbptt import _emulate_capture

    net, _ = _nets(name, "lbfgs")
    eager, _ = _nets(name, "lbfgs")
    _emulate_capture(monkeypatch, net)
    for seed in range(2):
        x, y = _batch(name, seed)
        net.fit(x, y)
        eager.fit(x, y)
        assert net.score_value == eager.score_value
    for a, b in zip(tree_leaves(net.params), tree_leaves(eager.params)):
        assert torch.equal(a, b)
    graphs = net._step_graphs
    assert [k[0] for k in graphs.programs] == ["solver"]
    assert graphs.captures == 1 and graphs.replays > 10
