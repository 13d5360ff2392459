"""Adjacency-list graph primitives — a copy of
``deeplearning4j_tpu/graphs/api.py`` (numpy only).

Reference: ``deeplearning4j-graph/.../graph/api/{IGraph,Vertex,Edge}.java``
and ``graph/graph/Graph.java`` (adjacency-list digraph with optional
undirected semantics, NoEdgeHandling for dead-end walks).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Generic, List, Optional, Sequence, TypeVar

import numpy as np

T = TypeVar("T")


@dataclass(frozen=True)
class Vertex(Generic[T]):
    """≙ ``api/Vertex.java`` — index + arbitrary value."""

    idx: int
    value: Any = None


@dataclass(frozen=True)
class Edge:
    """≙ ``api/Edge.java``."""

    src: int
    dst: int
    weight: float = 1.0
    directed: bool = False


class NoEdges(Exception):
    """≙ ``exception/NoEdgesException.java`` — walk hit a dead end with
    NoEdgeHandling.EXCEPTION_ON_DISCONNECTED."""


class Graph:
    """≙ ``graph/graph/Graph.java``."""

    def __init__(self, num_vertices: int, allow_multiple_edges: bool = True,
                 vertices: Optional[Sequence[Vertex]] = None):
        self.num_vertices = num_vertices
        self.allow_multiple_edges = allow_multiple_edges
        self._vertices = (list(vertices) if vertices is not None
                          else [Vertex(i) for i in range(num_vertices)])
        self._adj: List[List[Edge]] = [[] for _ in range(num_vertices)]

    # ------------------------------------------------------------- mutation
    def add_edge(self, src: int, dst: int, weight: float = 1.0,
                 directed: bool = False) -> None:
        if not (0 <= src < self.num_vertices and 0 <= dst < self.num_vertices):
            raise ValueError(f"Edge ({src},{dst}) out of range 0..{self.num_vertices - 1}")
        e = Edge(src, dst, weight, directed)
        if not self.allow_multiple_edges and any(
                x.dst == dst for x in self._adj[src]):
            return
        self._adj[src].append(e)
        if not directed and src != dst:
            self._adj[dst].append(Edge(dst, src, weight, directed))

    # -------------------------------------------------------------- queries
    def vertex(self, idx: int) -> Vertex:
        return self._vertices[idx]

    def vertices(self) -> List[Vertex]:
        return list(self._vertices)

    def edges_out(self, idx: int) -> List[Edge]:
        return list(self._adj[idx])

    def neighbors(self, idx: int) -> List[int]:
        return [e.dst for e in self._adj[idx]]

    def degree(self, idx: int) -> int:
        return len(self._adj[idx])

    def num_edges(self) -> int:
        return sum(len(a) for a in self._adj)

    # --------------------------------------- dense forms (device-friendly)
    def neighbor_table(self, pad: int = -1):
        """Dense [V, max_degree] neighbor indices + degree vector — the
        shape the random-walk sweep batches over."""
        V = self.num_vertices
        max_deg = max((len(a) for a in self._adj), default=1) or 1
        table = np.full((V, max_deg), pad, np.int32)
        weights = np.zeros((V, max_deg), np.float32)
        deg = np.zeros((V,), np.int32)
        for i, adj in enumerate(self._adj):
            deg[i] = len(adj)
            for j, e in enumerate(adj):
                table[i, j] = e.dst
                weights[i, j] = e.weight
        return table, weights, deg
