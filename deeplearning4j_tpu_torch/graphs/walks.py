"""Random walks over graphs — a copy of
``deeplearning4j_tpu/graphs/walks.py``: the walks stay host numpy, so
that they match the reference's draw for draw.

Reference: ``graph/iterator/RandomWalkIterator.java`` (uniform next-hop,
walkLength steps, NoEdgeHandling SELF_LOOP_ON_DISCONNECTED default),
``WeightedRandomWalkIterator.java`` (edge-weight-proportional hops), and the
parallel iterator providers.

Batched: besides the iterator surface, ``generate_walks`` produces ALL
walks in one vectorised sweep — a [V, L] matrix built with numpy row-gathers
over the dense neighbor table (the batched analogue of the reference's
thread-parallel iterator providers; feeds straight into the batched
SequenceVectors steps).
"""

from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np

from deeplearning4j_tpu_torch.graphs.api import Graph, NoEdges


class RandomWalkIterator:
    """Uniform random walks, one per starting vertex (in order).
    ≙ ``RandomWalkIterator.java``."""

    def __init__(self, graph: Graph, walk_length: int, seed: int = 12345,
                 no_edge_handling: str = "self_loop"):
        self.graph = graph
        self.walk_length = walk_length
        self.seed = seed
        self.no_edge_handling = no_edge_handling
        self.reset()

    def reset(self) -> None:
        self._rs = np.random.RandomState(self.seed)
        self._pos = 0

    def has_next(self) -> bool:
        return self._pos < self.graph.num_vertices

    def next(self) -> List[int]:
        start = self._pos
        self._pos += 1
        return self._walk_from(start)

    def _next_hop(self, cur: int) -> int:
        nbrs = self.graph.neighbors(cur)
        if not nbrs:
            if self.no_edge_handling == "self_loop":
                return cur
            raise NoEdges(f"Vertex {cur} has no outgoing edges")
        return nbrs[self._rs.randint(len(nbrs))]

    def _walk_from(self, start: int) -> List[int]:
        walk = [start]
        cur = start
        for _ in range(self.walk_length):
            cur = self._next_hop(cur)
            walk.append(cur)
        return walk

    def __iter__(self) -> Iterator[List[int]]:
        self.reset()
        while self.has_next():
            yield self.next()


class WeightedRandomWalkIterator(RandomWalkIterator):
    """Next hop ∝ edge weight. ≙ ``WeightedRandomWalkIterator.java``."""

    def _next_hop(self, cur: int) -> int:
        edges = self.graph.edges_out(cur)
        if not edges:
            if self.no_edge_handling == "self_loop":
                return cur
            raise NoEdges(f"Vertex {cur} has no outgoing edges")
        w = np.array([e.weight for e in edges], np.float64)
        p = w / w.sum()
        return edges[self._rs.choice(len(edges), p=p)].dst


def generate_walks(graph: Graph, walk_length: int, walks_per_vertex: int = 1,
                   seed: int = 12345, weighted: bool = False) -> np.ndarray:
    """All walks at once: [V * walks_per_vertex, walk_length+1] int32.

    Vectorised over every active walk per step (gather next-hop candidates
    from the dense neighbor table, sample once per row) — the batched
    replacement for the reference's per-thread iterator providers
    (``iterator/parallel/RandomWalkGraphIteratorProvider.java``).
    """
    table, weights, deg = graph.neighbor_table()
    V = graph.num_vertices
    rs = np.random.RandomState(seed)
    starts = np.tile(np.arange(V, dtype=np.int32), walks_per_vertex)
    n = len(starts)
    walks = np.empty((n, walk_length + 1), np.int32)
    walks[:, 0] = starts
    cur = starts.copy()
    for t in range(1, walk_length + 1):
        d = deg[cur]                              # [n]
        if weighted:
            w = weights[cur]                      # [n, max_deg]
            valid = np.arange(w.shape[1])[None, :] < d[:, None]
            w = np.where(valid, w, 0.0)
            tot = w.sum(1, keepdims=True)
            safe_tot = np.maximum(tot, 1e-12)
            cdf = np.cumsum(w / safe_tot, axis=1)
            u = rs.rand(n, 1)
            choice = (u > cdf).sum(1)
            choice = np.minimum(choice, np.maximum(d - 1, 0))
        else:
            choice = (rs.rand(n) * np.maximum(d, 1)).astype(np.int64)
        nxt = table[cur, choice]
        # dead ends: self-loop (reference SELF_LOOP_ON_DISCONNECTED)
        cur = np.where(d > 0, nxt, cur).astype(np.int32)
        walks[:, t] = cur
    return walks
