"""Space-partition trees: KD-tree, VP-tree, quad-tree, SP-tree — a copy
of ``deeplearning4j_tpu/clustering/trees.py``.

Reference: ``deeplearning4j-core/.../clustering/kdtree/KDTree.java``,
``clustering/vptree/VPTree.java``, ``clustering/quadtree/QuadTree.java``,
``clustering/sptree/SpTree.java`` (the Barnes-Hut cell tree with centers of
mass).

These are host-side index structures (pointer-chasing is CPU work; on
the device the bulk-distance path is a matmul — see
``wordvectors.words_nearest``), kept for capability parity and for
Barnes-Hut t-SNE.
"""

from __future__ import annotations

import heapq
from typing import List, Optional, Sequence, Tuple

import numpy as np


# ---------------------------------------------------------------- KD-tree

class _KDNode:
    __slots__ = ("idx", "dim", "left", "right")

    def __init__(self, idx, dim):
        self.idx = idx
        self.dim = dim
        self.left: Optional[_KDNode] = None
        self.right: Optional[_KDNode] = None


class KDTree:
    """Median-split k-d tree; insert/nn/knn. ≙ ``kdtree/KDTree.java``."""

    def __init__(self, points):
        self.points = np.asarray(points, np.float64)
        self.dims = self.points.shape[1]
        idxs = list(range(len(self.points)))
        self.root = self._build(idxs, 0)

    def _build(self, idxs: List[int], depth: int) -> Optional[_KDNode]:
        if not idxs:
            return None
        dim = depth % self.dims
        idxs.sort(key=lambda i: self.points[i, dim])
        mid = len(idxs) // 2
        node = _KDNode(idxs[mid], dim)
        node.left = self._build(idxs[:mid], depth + 1)
        node.right = self._build(idxs[mid + 1:], depth + 1)
        return node

    def nn(self, query) -> Tuple[int, float]:
        """Nearest neighbour: (index, distance)."""
        out = self.knn(query, 1)
        return out[0]

    def knn(self, query, k: int) -> List[Tuple[int, float]]:
        query = np.asarray(query, np.float64)
        heap: List[Tuple[float, int]] = []   # max-heap via negated dist

        def visit(node: Optional[_KDNode]):
            if node is None:
                return
            p = self.points[node.idx]
            d = float(np.linalg.norm(p - query))
            if len(heap) < k:
                heapq.heappush(heap, (-d, node.idx))
            elif d < -heap[0][0]:
                heapq.heapreplace(heap, (-d, node.idx))
            diff = query[node.dim] - p[node.dim]
            near, far = (node.left, node.right) if diff < 0 else (node.right, node.left)
            visit(near)
            if len(heap) < k or abs(diff) < -heap[0][0]:
                visit(far)

        visit(self.root)
        return sorted([( i, -nd) for nd, i in heap], key=lambda t: t[1])


# ---------------------------------------------------------------- VP-tree

class _VPNode:
    __slots__ = ("idx", "threshold", "inside", "outside")

    def __init__(self, idx):
        self.idx = idx
        self.threshold = 0.0
        self.inside: Optional[_VPNode] = None
        self.outside: Optional[_VPNode] = None


class VPTree:
    """Vantage-point tree (metric tree on euclidean distance).
    ≙ ``vptree/VPTree.java``."""

    def __init__(self, points, seed: int = 12345):
        self.points = np.asarray(points, np.float64)
        self._rs = np.random.RandomState(seed)
        self.root = self._build(list(range(len(self.points))))

    def _build(self, idxs: List[int]) -> Optional[_VPNode]:
        if not idxs:
            return None
        vp = idxs[self._rs.randint(len(idxs))]
        rest = [i for i in idxs if i != vp]
        node = _VPNode(vp)
        if not rest:
            return node
        dists = np.linalg.norm(self.points[rest] - self.points[vp], axis=1)
        median = float(np.median(dists))
        node.threshold = median
        inside = [i for i, d in zip(rest, dists) if d <= median]
        outside = [i for i, d in zip(rest, dists) if d > median]
        node.inside = self._build(inside)
        node.outside = self._build(outside)
        return node

    def knn(self, query, k: int) -> List[Tuple[int, float]]:
        query = np.asarray(query, np.float64)
        heap: List[Tuple[float, int]] = []

        def visit(node: Optional[_VPNode]):
            if node is None:
                return
            d = float(np.linalg.norm(self.points[node.idx] - query))
            if len(heap) < k:
                heapq.heappush(heap, (-d, node.idx))
            elif d < -heap[0][0]:
                heapq.heapreplace(heap, (-d, node.idx))
            tau = -heap[0][0] if len(heap) == k else np.inf
            if node.inside is None and node.outside is None:
                return
            if d < node.threshold:
                visit(node.inside)
                if d + tau >= node.threshold:
                    visit(node.outside)
            else:
                visit(node.outside)
                if d - tau <= node.threshold:
                    visit(node.inside)

        visit(self.root)
        return sorted([(i, -nd) for nd, i in heap], key=lambda t: t[1])


# --------------------------------------------------------------- quad-tree

class QuadTree:
    """2-D region quad-tree with per-cell center of mass.
    ≙ ``quadtree/QuadTree.java`` (the t-SNE 2-D special case)."""

    MAX_CAPACITY = 1

    def __init__(self, center_x, center_y, half_w, half_h):
        self.cx, self.cy = float(center_x), float(center_y)
        self.hw, self.hh = float(half_w), float(half_h)
        self.n_points = 0
        self.com = np.zeros(2)
        self.point: Optional[np.ndarray] = None
        self.children: Optional[List["QuadTree"]] = None

    @staticmethod
    def build(points) -> "QuadTree":
        pts = np.asarray(points, np.float64)
        lo, hi = pts.min(0), pts.max(0)
        c = (lo + hi) / 2
        half = max((hi - lo).max() / 2, 1e-9) * 1.001
        tree = QuadTree(c[0], c[1], half, half)
        for p in pts:
            tree.insert(p)
        return tree

    def contains(self, p) -> bool:
        return (abs(p[0] - self.cx) <= self.hw + 1e-12
                and abs(p[1] - self.cy) <= self.hh + 1e-12)

    def _subdivide(self):
        hw, hh = self.hw / 2, self.hh / 2
        self.children = [
            QuadTree(self.cx - hw, self.cy - hh, hw, hh),
            QuadTree(self.cx + hw, self.cy - hh, hw, hh),
            QuadTree(self.cx - hw, self.cy + hh, hw, hh),
            QuadTree(self.cx + hw, self.cy + hh, hw, hh),
        ]

    def insert(self, p) -> bool:
        p = np.asarray(p, np.float64)
        if not self.contains(p):
            return False
        self.com = (self.com * self.n_points + p) / (self.n_points + 1)
        self.n_points += 1
        if self.point is None and self.children is None:
            self.point = p
            return True
        # duplicate of the stored point: absorbed into the center of mass
        if self.point is not None and np.allclose(p, self.point):
            return True
        if self.children is None:
            self._subdivide()
            old = self.point
            self.point = None
            for ch in self.children:
                if ch.insert(old):
                    break
        for ch in self.children:
            if ch.insert(p):
                return True
        return False

    def depth(self) -> int:
        if self.children is None:
            return 1
        return 1 + max(ch.depth() for ch in self.children)


# ----------------------------------------------------------------- SP-tree

class SpTree:
    """k-d generalisation of the quad-tree (2^d children), with centers of
    mass — the Barnes-Hut acceleration structure.  ≙ ``sptree/SpTree.java``."""

    def __init__(self, center: np.ndarray, half: np.ndarray):
        self.center = np.asarray(center, np.float64)
        self.half = np.asarray(half, np.float64)
        self.d = len(self.center)
        self.n_points = 0
        self.com = np.zeros(self.d)
        self.point_idx: Optional[int] = None
        self.point: Optional[np.ndarray] = None
        self.children: Optional[List["SpTree"]] = None

    @staticmethod
    def build(points) -> "SpTree":
        pts = np.asarray(points, np.float64)
        lo, hi = pts.min(0), pts.max(0)
        c = (lo + hi) / 2
        half = np.maximum((hi - lo) / 2, 1e-9) * 1.001
        tree = SpTree(c, half)
        for i, p in enumerate(pts):
            tree.insert(p, i)
        return tree

    def contains(self, p) -> bool:
        return bool(np.all(np.abs(p - self.center) <= self.half + 1e-12))

    def _subdivide(self):
        self.children = []
        for mask in range(2 ** self.d):
            offset = np.array([(1 if (mask >> b) & 1 else -1)
                               for b in range(self.d)], np.float64)
            self.children.append(
                SpTree(self.center + offset * self.half / 2, self.half / 2))

    def insert(self, p, idx: int) -> bool:
        p = np.asarray(p, np.float64)
        if not self.contains(p):
            return False
        self.com = (self.com * self.n_points + p) / (self.n_points + 1)
        self.n_points += 1
        if self.point is None and self.children is None:
            self.point, self.point_idx = p, idx
            return True
        # duplicate of the stored point: absorbed into the center of mass
        # (≙ SpTree.java duplicate check — prevents infinite subdivision)
        if self.point is not None and np.allclose(p, self.point):
            return True
        if self.children is None:
            self._subdivide()
            old, old_idx = self.point, self.point_idx
            self.point = self.point_idx = None
            # identical duplicate points: keep in this cell's com only
            for ch in self.children:
                if ch.insert(old, old_idx):
                    break
        for ch in self.children:
            if ch.insert(p, idx):
                return True
        return False

    # Barnes-Hut accumulation of repulsive forces for t-SNE
    def compute_non_edge_forces(self, target: np.ndarray, theta: float,
                                neg_f: np.ndarray) -> float:
        """Adds this cell's contribution to ``neg_f``; returns its share of
        the normalisation sum Z.  ≙ ``SpTree.computeNonEdgeForces``."""
        if self.n_points == 0:
            return 0.0
        diff = target - self.com
        dist2 = float(diff @ diff)
        max_width = float(self.half.max() * 2)
        if self.children is None or (dist2 > 0 and
                                     max_width / np.sqrt(dist2) < theta):
            if self.n_points == 1 and dist2 == 0.0:
                return 0.0  # the target itself
            q = 1.0 / (1.0 + dist2)
            mult = self.n_points * q
            neg_f += mult * q * diff
            return mult
        z = 0.0
        for ch in self.children:
            z += ch.compute_non_edge_forces(target, theta, neg_f)
        return z
