"""K-means clustering — counterpart of
``deeplearning4j_tpu/clustering/kmeans.py``.

Reference: ``deeplearning4j-core/.../clustering/kmeans/KMeansClustering.java``
+ the strategy/condition framework (``clustering/algorithm/strategy``,
``condition/``: iteration cap + distribution-variation convergence).

The reference runs Lloyd's algorithm as one jitted ``lax.while_loop``.
Here each iteration is a few tensor operations on the device: the
``[N, K]`` squared distances in the reference's broadcast form, a block
of rows at a time (the whole ``[N, K, D]`` difference is 2.2 GB in
float32 at MNIST's 70000 x 784 and K 10), the argmin (the first minimum,
as ``jnp.argmin``), the one-hot segment sum as a product, and the
centroid shift, read on the host once an iteration: the loop stops
exactly where the reference's does (``it < max_iterations and shift >
tol``, the first iteration run before the test).

The k-means++ initialisation is the reference's host numpy, draw for
draw, except where the reference raises: once every point lies on a
chosen centre (fewer distinct points than k) its probabilities are all
zero and ``RandomState.choice`` refuses them; the port draws uniformly
among the points not yet chosen there.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.backend.device import resolve_device

# the distance blocks' [rows, K, D] difference is kept under this size
BLOCK_BYTES = 256 << 20


@dataclass
class Cluster:
    """≙ ``clustering/cluster/Cluster.java`` (center + member points)."""

    center: np.ndarray
    point_indices: List[int] = field(default_factory=list)


@dataclass
class ClusterSet:
    """≙ ``clustering/cluster/ClusterSet.java``."""

    centers: np.ndarray          # [K, D]
    assignments: np.ndarray      # [N]
    inertia: float

    @property
    def clusters(self) -> List[Cluster]:
        return [Cluster(self.centers[k],
                        list(np.nonzero(self.assignments == k)[0]))
                for k in range(len(self.centers))]

    def nearest_cluster(self, point) -> int:
        d = ((self.centers - np.asarray(point)[None, :]) ** 2).sum(1)
        return int(np.argmin(d))


def _distances(points: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """``((points[:, None, :] - centers[None]) ** 2).sum(-1)``, ``[N, K]``,
    a block of rows at a time."""
    N, D = points.shape
    K = centers.shape[0]
    rows = max(1, BLOCK_BYTES // max(K * D * points.element_size(), 1))
    out = torch.empty((N, K), dtype=points.dtype, device=points.device)
    for i in range(0, N, rows):
        diff = points[i:i + rows, None, :] - centers[None]
        out[i:i + rows] = diff.square_().sum(-1)
    return out


def _lloyd_step(points: torch.Tensor, centers: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One iteration (the reference's ``body``): (new centres, the
    assignments they came from, the largest squared centre shift).  A
    centre with no members stays where it was."""
    a = torch.argmin(_distances(points, centers), 1)
    onehot = F.one_hot(a, centers.shape[0]).to(points.dtype)         # [N,K]
    counts = onehot.sum(0)[:, None]                                  # [K,1]
    sums = onehot.T @ points                                         # [K,D]
    new = torch.where(counts > 0, sums / torch.clamp(counts, min=1.0),
                      centers)
    shift = torch.max(torch.sum((new - centers) ** 2, 1))
    return new, a, shift


def _lloyd(points, centers0, max_iterations: int, tol: float):
    """While the centroid shift > tol: assign, recompute.  Returns the
    centres, the final assignments, the inertia (device tensors) and the
    iterations run."""
    tol32 = float(np.float32(tol))     # the reference compares in float32
    centers, _, shift = _lloyd_step(points, centers0)
    it = 1
    while it < max_iterations and float(shift) > tol32:
        centers, _, shift = _lloyd_step(points, centers)
        it += 1
    d = _distances(points, centers)
    a = torch.argmin(d, 1)
    inertia = torch.gather(d, 1, a[:, None]).sum()
    return centers, a, inertia, it


def _init_centers(pts: np.ndarray, k: int, seed: int) -> List[int]:
    """The reference's k-means++ draw (host numpy, float32): the first
    centre uniform, each next one with probability proportional to its
    squared distance from the nearest chosen centre."""
    rs = np.random.RandomState(seed)
    N = len(pts)
    first = rs.randint(N)
    chosen = [first]
    d2 = ((pts - pts[first]) ** 2).sum(1)
    for _ in range(k - 1):
        total = d2.sum()
        if total > 0:
            nxt = rs.choice(N, p=d2 / max(total, 1e-12))
        else:       # every point on a chosen centre: the reference raises
            nxt = rs.choice(np.setdiff1d(np.arange(N), chosen))
        chosen.append(int(nxt))
        d2 = np.minimum(d2, ((pts - pts[nxt]) ** 2).sum(1))
    return chosen


class KMeansClustering:
    """≙ ``KMeansClustering.setup(k, maxIterations, distance)``.  The
    points live on ``device`` (``cuda`` unless the caller names the CPU)
    while Lloyd's iterations run."""

    def __init__(self, k: int, max_iterations: int = 100, tol: float = 1e-8,
                 seed: int = 12345, device=None):
        self.k = k
        self.max_iterations = max_iterations
        self.tol = tol
        self.seed = seed
        self.device = resolve_device(device)
        self.iterations_ = None

    def apply_to(self, points) -> ClusterSet:
        """Clusters ``points`` ([N, D], numpy or a tensor on any
        device)."""
        if torch.is_tensor(points):
            pts = points.detach().to(self.device, torch.float32)
            pts_np = pts.cpu().numpy()
        else:
            pts_np = np.asarray(points, np.float32)
            pts = torch.as_tensor(pts_np).to(self.device)
        N = pts_np.shape[0]
        if N < self.k:
            raise ValueError(f"k={self.k} > number of points {N}")
        chosen = _init_centers(pts_np, self.k, self.seed)
        centers0 = pts[torch.as_tensor(chosen, device=self.device)]
        centers, a, inertia, self.iterations_ = _lloyd(
            pts, centers0, self.max_iterations, self.tol)
        return ClusterSet(centers.cpu().numpy(), a.cpu().numpy(),
                          float(inertia))
