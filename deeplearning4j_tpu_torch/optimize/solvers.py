"""Full-batch solvers — counterpart of
``deeplearning4j_tpu/optimize/solvers.py``: line search gradient
descent, conjugate gradient and L-BFGS, with the backtracking line
search they share (copied: numpy on the host, in float64), and
``fit_model_with_solver``, which runs one of them over a facade's
parameters as one flat vector.

Reference: ``optimize/Solver.java:41-74`` (dispatch on
OptimizationAlgorithm), ``optimize/solvers/BaseOptimizer.java:165``,
``BackTrackLineSearch.java``, ``ConjugateGradient.java``, ``LBFGS.java``,
``LineGradientDescent.java``.

The objective's value and gradient at a point are one call of a device
body over the flat vector (split back into the parameter tree as
views): on the card a captured CUDA graph per argument signature, the
reference's jitted ``vg``, whose static vector the host rewrites before
each replay; the loss and the gradient are copied to the host after it.
SGD itself does not live here: it is the facades' train step.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.backend import rng as rng_mod
from deeplearning4j_tpu_torch.models import capture as cap
from deeplearning4j_tpu_torch.models.common import (
    _tree_like, copy_tree_, tree_leaves, tree_map,
)


class BackTrackLineSearch:
    """Armijo backtracking. ≙ ``optimize/solvers/BackTrackLineSearch.java``.

    Returns the accepted step size along ``direction`` (0.0 if no step
    improves sufficiently).
    """

    def __init__(self, max_iterations: int = 20, c1: float = 1e-4,
                 shrink: float = 0.5, initial_step: float = 1.0,
                 max_step: float = 100.0):
        self.max_iterations = max_iterations
        self.c1 = c1
        self.shrink = shrink
        self.initial_step = initial_step
        self.max_step = max_step

    def optimize(self, f: Callable[[np.ndarray], float], x: np.ndarray,
                 fx: float, grad: np.ndarray, direction: np.ndarray) -> float:
        dg = float(np.dot(grad, direction))
        if dg >= 0:  # not a descent direction (reference ZeroDirection guard)
            return 0.0
        # clip overly long steps (reference stpmax logic)
        dnorm = float(np.linalg.norm(direction))
        step = min(self.initial_step, self.max_step / max(dnorm, 1e-12))
        for _ in range(self.max_iterations):
            trial = f(x + step * direction)
            if np.isfinite(trial) and trial <= fx + self.c1 * step * dg:
                return step
            step *= self.shrink
        return 0.0


ValueGrad = Callable[[np.ndarray], Tuple[float, np.ndarray]]


def line_gradient_descent(value_grad: ValueGrad, x0: np.ndarray,
                          iterations: int,
                          line_search: BackTrackLineSearch = None) -> Tuple[np.ndarray, float]:
    """Steepest descent with line search. ≙ ``LineGradientDescent.java``."""
    ls = line_search or BackTrackLineSearch()
    f = lambda v: value_grad(v)[0]
    x = np.asarray(x0, np.float64).copy()
    fx, g = value_grad(x)
    for _ in range(iterations):
        d = -g
        step = ls.optimize(f, x, fx, g, d)
        if step == 0.0:
            break
        x = x + step * d
        fx, g = value_grad(x)
    return x, fx


def conjugate_gradient(value_grad: ValueGrad, x0: np.ndarray,
                       iterations: int,
                       line_search: BackTrackLineSearch = None) -> Tuple[np.ndarray, float]:
    """Nonlinear CG, Polak-Ribière+ with automatic restart.
    ≙ ``ConjugateGradient.java``."""
    ls = line_search or BackTrackLineSearch()
    f = lambda v: value_grad(v)[0]
    x = np.asarray(x0, np.float64).copy()
    fx, g = value_grad(x)
    d = -g
    for _ in range(iterations):
        step = ls.optimize(f, x, fx, g, d)
        if step == 0.0:
            # restart along steepest descent once before giving up
            d = -g
            step = ls.optimize(f, x, fx, g, d)
            if step == 0.0:
                break
        x = x + step * d
        fx, g_new = value_grad(x)
        beta = float(np.dot(g_new, g_new - g) / max(np.dot(g, g), 1e-300))
        beta = max(beta, 0.0)  # PR+
        d = -g_new + beta * d
        g = g_new
    return x, fx


def lbfgs(value_grad: ValueGrad, x0: np.ndarray, iterations: int,
          memory: int = 10,
          line_search: BackTrackLineSearch = None) -> Tuple[np.ndarray, float]:
    """Limited-memory BFGS (two-loop recursion). ≙ ``LBFGS.java``."""
    ls = line_search or BackTrackLineSearch()
    f = lambda v: value_grad(v)[0]
    x = np.asarray(x0, np.float64).copy()
    fx, g = value_grad(x)
    s_hist: deque = deque(maxlen=memory)
    y_hist: deque = deque(maxlen=memory)
    for _ in range(iterations):
        # two-loop recursion for H·g
        q = g.copy()
        alphas = []
        for s, y in reversed(list(zip(s_hist, y_hist))):
            rho = 1.0 / max(float(np.dot(y, s)), 1e-300)
            a = rho * float(np.dot(s, q))
            alphas.append((a, rho, s, y))
            q -= a * y
        if y_hist:
            s, y = s_hist[-1], y_hist[-1]
            q *= float(np.dot(s, y)) / max(float(np.dot(y, y)), 1e-300)
        for a, rho, s, y in reversed(alphas):
            b = rho * float(np.dot(y, q))
            q += (a - b) * s
        d = -q
        step = ls.optimize(f, x, fx, g, d)
        if step == 0.0:
            d = -g
            step = ls.optimize(f, x, fx, g, d)
            if step == 0.0:
                break
        x_new = x + step * d
        fx, g_new = value_grad(x_new)
        s_vec, y_vec = x_new - x, g_new - g
        if float(np.dot(s_vec, y_vec)) > 1e-10:  # curvature condition
            s_hist.append(s_vec)
            y_hist.append(y_vec)
        x, g = x_new, g_new
    return x, fx


SOLVERS = {
    "line_gradient_descent": line_gradient_descent,
    "conjugate_gradient": conjugate_gradient,
    "lbfgs": lbfgs,
}


def solve(algo: str, value_grad: ValueGrad, x0: np.ndarray,
          iterations: int) -> Tuple[np.ndarray, float]:
    """Dispatch ≙ ``Solver.java:47-74``."""
    if algo not in SOLVERS:
        raise ValueError(f"Unknown optimization algorithm '{algo}' "
                         f"(known: {sorted(SOLVERS)} + stochastic_gradient_descent)")
    return SOLVERS[algo](value_grad, x0, iterations)


def _flat_views(vec: torch.Tensor, template):
    """The parameter tree of ``template`` as views of the flat ``vec``
    (``tree_leaves`` order, the flat parameter vector's)."""
    leaves, off = [], 0
    for p in tree_leaves(template):
        n = p.numel()
        leaves.append(vec[off:off + n].view(p.shape))
        off += n
    return _tree_like(template, leaves)


def fit_model_with_solver(model, loss_fn, inputs, algo: str,
                          iterations: int) -> None:
    """One full-batch solver 'fit' on a facade: ``iterations`` of the
    chosen solver over the flat parameter vector, then the parameters
    written back in place, the layer state (BatchNorm's running stats)
    refreshed at the accepted point, ``score_value`` set and
    ``iteration`` advanced by one.  Shared by both facades, as the
    reference's single ``Solver``; their ``fit`` loop
    (``common.fit_loop``) fires the listeners after it, as after an SGD
    step.

    ``loss_fn(params, key, **inputs) -> (loss, new net state)``; one key
    from the net's stream serves the whole solve.  On the card the value
    and gradient are a captured program per signature of ``inputs`` (and
    ``algo``, as the reference's jit key) in the net's graph cache: the
    batch is staged once, the vector before each evaluation."""
    leaves = tree_leaves(model.params)
    dtype, dev = leaves[0].dtype, model.device
    flat0 = torch.cat([p.detach().reshape(-1) for p in leaves])
    seed = rng_mod.seed_of(model._keys.next())

    def body(vec, key, scalars=None, **args):
        v = vec.detach().requires_grad_(True)
        loss, new_state = loss_fn(_flat_views(v, model.params), key, **args)
        g, = torch.autograd.grad(loss, v)
        return loss.detach(), g, tree_map(torch.Tensor.detach, new_state)

    if cap.captures(model):
        graphs = cap.step_graphs(model)
        staged = tree_map(cap.host_or_device, {**inputs, "vec": flat0})
        prog = graphs.program("solver", body, staged, variant=algo)
        graphs.stage(prog, staged, seed)

        def evaluate(vec):
            graphs.put(prog.statics["vec"], vec, ("vec",))
            return graphs.run(prog)
    else:
        args = tree_map(lambda t: torch.as_tensor(t, device=dev), inputs)
        key = rng_mod.device_key(seed, dev)

        def evaluate(vec):
            return body(vec.to(dev), key, **args)

    def value_grad(v):
        loss, g, _ = evaluate(torch.from_numpy(np.asarray(v)).to(dtype))
        return float(loss), g.to("cpu", torch.float64).numpy()

    xf, _ = solve(algo, value_grad, flat0.to("cpu", torch.float64).numpy(),
                  iterations)
    xf = torch.from_numpy(xf).to(dtype)
    loss, _, new_state = evaluate(xf)     # the state at the accepted point
    with torch.no_grad():
        for p, new in zip(leaves, tree_leaves(_flat_views(xf.to(dev),
                                                          model.params))):
            p.copy_(new)
        if new_state:
            copy_tree_(model.net_state, new_state)
    model.score_value = float(loss)
    model.iteration += 1
