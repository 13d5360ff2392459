"""t-SNE: exact (device) + Barnes-Hut (SpTree approximation) — counterpart
of ``deeplearning4j_tpu/clustering/tsne.py``.

Reference: ``deeplearning4j-core/.../plot/Tsne.java`` (exact gradient t-SNE
with momentum + gain adaptation) and ``plot/BarnesHutTsne.java:63,93,294``
(theta-approximated forces via SpTree, implemented as a ``Model``).

The input affinities are the reference's host numpy (the per-row beta
bisection), except that the pairwise squared distances are taken a
block of rows at a time: the reference's broadcast builds an
``[N, N, D]`` float64 temporary (39 GB at N 2500, D 784), and the
blocks give the same values bit for bit.

The exact optimisation runs on the device: one step is the reference's
``_tsne_step`` on tensors, updating ``y``, the velocities and the gains
in place.  On the card the first step runs eagerly (on the side stream)
and is captured as a CUDA graph that every later step replays: ``P``,
``y``, ``vel``, ``gains``, the learning rate and the momentum are its
static tensors, the host rewrites the momentum where the schedule
switches, and the switch to the un-exaggerated ``P`` is a copy into the
same buffer.  The KL divergence is read once, at the end.

The step's reductions (the sum of the Student-t numerators, the rows of
``(P - Q) * num``, the gradient's product, the mean of ``y``) accumulate
in float64 and round once to float32, so the card and the host give the
same float32 step wherever their elementwise operations agree (IEEE
adds, products and quotients do), and the trajectory sits as near the
exact one as float32 state allows.  The reference's float32 reductions
round several times, and the early iterations, where ``y`` grows from
1e-2 to about 3, amplify such rounding tenfold a step.  Barnes-Hut stays
host numpy over ``SpTree``, as in the reference.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.backend.device import (
    capture_graph, resolve_device, warm_on_side_stream,
)
from deeplearning4j_tpu_torch.clustering.trees import SpTree

# the blocks of the pairwise difference are kept under this size
BLOCK_BYTES = 64 << 20


# ---------------------------------------------------------------------------
# shared: P-matrix from perplexity (vectorised beta bisection)
# ---------------------------------------------------------------------------

def _p_conditional(dist2: np.ndarray, perplexity: float, tol: float = 1e-5,
                   max_tries: int = 50) -> np.ndarray:
    """Row-stochastic conditional affinities with per-row beta found by
    bisection so each row's entropy == log(perplexity)."""
    N = dist2.shape[0]
    target = np.log(perplexity)
    beta = np.ones(N)
    beta_min = np.full(N, -np.inf)
    beta_max = np.full(N, np.inf)
    mask = ~np.eye(N, dtype=bool)
    P = np.zeros((N, N))
    for _ in range(max_tries):
        expo = np.exp(-dist2 * beta[:, None])
        expo[~mask] = 0.0
        sums = np.maximum(expo.sum(1, keepdims=True), 1e-12)
        P = expo / sums
        # entropy per row
        H = -np.sum(np.where(P > 0, P * np.log(np.maximum(P, 1e-12)), 0.0), 1)
        diff = H - target
        done = np.abs(diff) < tol
        if done.all():
            break
        too_high = diff > 0  # entropy too high -> increase beta
        beta_min = np.where(too_high & ~done, beta, beta_min)
        beta_max = np.where(~too_high & ~done, beta, beta_max)
        beta = np.where(
            too_high & ~done,
            np.where(np.isinf(beta_max), beta * 2, (beta + beta_max) / 2),
            np.where(np.isinf(beta_min), beta / 2, (beta + beta_min) / 2))
    return P


def _sq_dists(x: np.ndarray) -> np.ndarray:
    """``((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)``, a block of rows
    at a time."""
    N, D = x.shape
    rows = max(1, BLOCK_BYTES // max(N * D * x.itemsize, 1))
    out = np.empty((N, N), x.dtype)
    for i in range(0, N, rows):
        out[i:i + rows] = ((x[i:i + rows, None, :] - x[None, :, :]) ** 2
                           ).sum(-1)
    return out


def _joint_p(x: np.ndarray, perplexity: float) -> np.ndarray:
    d2 = _sq_dists(x)
    P = _p_conditional(d2, perplexity)
    P = (P + P.T) / (2 * len(x))
    return np.maximum(P, 1e-12)


# ---------------------------------------------------------------------------
# exact t-SNE — the device step
# ---------------------------------------------------------------------------

def _sum(x: torch.Tensor, dim=None) -> torch.Tensor:
    """A sum (over ``dim``, else all of ``x``) accumulated in float64 and
    rounded once to ``x``'s type."""
    total = (x.sum(dtype=torch.float64) if dim is None
             else x.sum(dim, dtype=torch.float64))
    return total.to(x.dtype)


def _tsne_grad(P: torch.Tensor, y: torch.Tensor):
    """The exact gradient at ``y`` and the low-dimensional affinities Q."""
    N = y.shape[0]
    d2 = ((y[:, None, :] - y[None, :, :]) ** 2).sum(-1)
    num = 1.0 / (1.0 + d2)
    num = num * (1.0 - torch.eye(N, dtype=y.dtype, device=y.device))
    Q = torch.clamp(num / torch.clamp(_sum(num), min=1e-12), min=1e-12)
    PQ = (P - Q) * num                                   # [N,N]
    lap = torch.diag(_sum(PQ, 1)) - PQ
    grad = 4.0 * (lap.double() @ y.double()).to(y.dtype)   # [N,2]
    return grad, Q


def tsne_step_(P, y, vel, gains, lr, momentum) -> torch.Tensor:
    """The reference's ``_tsne_step`` with ``y``, ``vel`` and ``gains``
    updated in place (``lr`` and ``momentum`` float32 device scalars);
    returns the KL divergence at the step's start."""
    grad, Q = _tsne_grad(P, y)
    # gain adaptation (reference Tsne.java momentum/gain schedule)
    same_sign = torch.sign(grad) == torch.sign(vel)
    gains.copy_(torch.clamp(torch.where(same_sign, gains * 0.8, gains + 0.2),
                            min=0.01))
    vel.copy_(momentum * vel - lr * gains * grad)
    y.add_(vel)
    y.sub_(y.mean(0, keepdim=True, dtype=torch.float64).to(y.dtype))
    return _sum(P * torch.log(P / Q))


class Tsne:
    """Exact t-SNE. ≙ ``plot/Tsne.java`` builder knobs.  The optimisation
    runs on ``device`` (``cuda`` unless the caller names the CPU)."""

    def __init__(self, n_components: int = 2, perplexity: float = 30.0,
                 learning_rate: float = 200.0, n_iter: int = 500,
                 momentum: float = 0.5, final_momentum: float = 0.8,
                 switch_momentum_iteration: int = 100,
                 early_exaggeration: float = 4.0,
                 stop_lying_iteration: int = 100, seed: int = 12345,
                 device=None):
        self.n_components = n_components
        self.perplexity = perplexity
        self.learning_rate = learning_rate
        self.n_iter = n_iter
        self.momentum = momentum
        self.final_momentum = final_momentum
        self.switch_momentum_iteration = switch_momentum_iteration
        self.early_exaggeration = early_exaggeration
        self.stop_lying_iteration = stop_lying_iteration
        self.seed = seed
        self.device = resolve_device(device)
        self.kl_divergence_: Optional[float] = None
        self.captures = self.replays = 0

    def fit_transform(self, x) -> np.ndarray:
        x = np.asarray(x, np.float64)
        N = x.shape[0]
        return self.embed(_joint_p(x, min(self.perplexity, (N - 1) / 3.0)))

    def embed(self, P: np.ndarray) -> np.ndarray:
        """The optimisation from the joint affinities ``P`` ([N, N],
        float64): the embedding ``[N, n_components]``."""
        dev = self.device
        N = P.shape[0]
        plain = torch.as_tensor(np.asarray(P, np.float32)).to(dev)
        P_dev = torch.as_tensor(np.asarray(P * self.early_exaggeration,
                                           np.float32)).to(dev)
        rs = np.random.RandomState(self.seed)
        y = torch.as_tensor(
            rs.randn(N, self.n_components).astype(np.float32) * 1e-2).to(dev)
        vel = torch.zeros_like(y)
        gains = torch.ones_like(y)
        lr = torch.tensor(self.learning_rate, dtype=torch.float32, device=dev)
        mom = torch.zeros((), dtype=torch.float32, device=dev)
        kl = torch.full((), float("nan"), dtype=torch.float32, device=dev)

        def step():
            kl.copy_(tsne_step_(P_dev, y, vel, gains, lr, mom))

        # the internal switch ``_capture`` (on the card by default)
        captured = getattr(self, "_capture", dev.type == "cuda")
        graph = None
        for it in range(self.n_iter):
            if it == self.stop_lying_iteration:
                P_dev.copy_(plain)
            if it in (0, self.switch_momentum_iteration):
                mom.fill_(self.momentum if it < self.switch_momentum_iteration
                          else self.final_momentum)
            if graph is not None:
                graph.replay()
                self.replays += 1
            elif captured:
                warm_on_side_stream(step, dev)
                graph, _ = capture_graph(step)
                self.captures += 1
            else:
                step()
        self.kl_divergence_ = float(kl)
        return y.cpu().numpy()


class BarnesHutTsne(Tsne):
    """theta-approximated t-SNE via SpTree (O(N log N) repulsion).
    ≙ ``plot/BarnesHutTsne.java`` (theta default 0.5).  Host numpy, as
    the reference's: it takes no device."""

    def __init__(self, theta: float = 0.5, **kw):
        super().__init__(device="cpu", **kw)
        self.theta = theta

    def fit_transform(self, x) -> np.ndarray:
        x = np.asarray(x, np.float64)
        N = x.shape[0]
        P = _joint_p(x, min(self.perplexity, (N - 1) / 3.0))
        # sparse-ish edges: keep 3*perplexity strongest per row (reference
        # uses exact kNN input similarities)
        rs = np.random.RandomState(self.seed)
        y = rs.randn(N, self.n_components) * 1e-2
        vel = np.zeros_like(y)
        gains = np.ones_like(y)
        P_work = P * self.early_exaggeration
        for it in range(self.n_iter):
            if it == self.stop_lying_iteration:
                P_work = P
            mom = (self.momentum if it < self.switch_momentum_iteration
                   else self.final_momentum)
            grad = self._gradient(P_work, y)
            same_sign = np.sign(grad) == np.sign(vel)
            gains = np.maximum(np.where(same_sign, gains * 0.8, gains + 0.2), 0.01)
            vel = mom * vel - self.learning_rate * gains * grad
            y = y + vel
            y -= y.mean(0, keepdims=True)
        # final KL (exact, for reporting)
        d2 = ((y[:, None, :] - y[None, :, :]) ** 2).sum(-1)
        num = 1.0 / (1.0 + d2)
        np.fill_diagonal(num, 0.0)
        Q = np.maximum(num / num.sum(), 1e-12)
        self.kl_divergence_ = float(np.sum(P * np.log(P / Q)))
        return y

    def _gradient(self, P: np.ndarray, y: np.ndarray) -> np.ndarray:
        N = y.shape[0]
        tree = SpTree.build(y)
        # attractive forces (edge forces): exact over nonzero P
        d2 = ((y[:, None, :] - y[None, :, :]) ** 2).sum(-1)
        qnum = 1.0 / (1.0 + d2)
        np.fill_diagonal(qnum, 0.0)
        pos = ((P * qnum)[:, :, None] * (y[:, None, :] - y[None, :, :])).sum(1)
        # repulsive via Barnes-Hut
        neg = np.zeros_like(y)
        Z = 0.0
        for i in range(N):
            f = np.zeros(y.shape[1])
            Z += tree.compute_non_edge_forces(y[i], self.theta, f)
            neg[i] = f
        return 4.0 * (pos - neg / max(Z, 1e-12))
