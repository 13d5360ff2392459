"""Graph file loaders — a copy of ``deeplearning4j_tpu/graphs/loaders.py``.

Reference: ``graph/data/GraphLoader.java`` +
``impl/{DelimitedEdgeLineProcessor,WeightedEdgeLineProcessor,
DelimitedVertexLoader}.java`` — delimited "src<sep>dst[<sep>weight]" edge
lists and "idx<sep>value" vertex files, comment lines skipped.
"""

from __future__ import annotations

from typing import List, Optional

from deeplearning4j_tpu_torch.graphs.api import Graph, Vertex


def _lines(path: str, skip_prefix: str):
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line or (skip_prefix and line.startswith(skip_prefix)):
                continue
            yield line


def load_delimited_edges(path: str, num_vertices: int, delimiter: str = ",",
                         directed: bool = False,
                         skip_prefix: str = "#") -> Graph:
    """≙ ``GraphLoader.loadUndirectedGraphEdgeListFile`` /
    DelimitedEdgeLineProcessor."""
    g = Graph(num_vertices)
    for line in _lines(path, skip_prefix):
        parts = line.split(delimiter)
        g.add_edge(int(parts[0]), int(parts[1]), directed=directed)
    return g


def load_weighted_edges(path: str, num_vertices: int, delimiter: str = ",",
                        directed: bool = False,
                        skip_prefix: str = "#") -> Graph:
    """≙ ``WeightedEdgeLineProcessor``: src,dst,weight."""
    g = Graph(num_vertices)
    for line in _lines(path, skip_prefix):
        parts = line.split(delimiter)
        g.add_edge(int(parts[0]), int(parts[1]), weight=float(parts[2]),
                   directed=directed)
    return g


def load_delimited_vertices(path: str, delimiter: str = ",",
                            skip_prefix: str = "#") -> List[Vertex]:
    """≙ ``DelimitedVertexLoader``: "idx<sep>value" per line."""
    out = []
    for line in _lines(path, skip_prefix):
        idx, _, value = line.partition(delimiter)
        out.append(Vertex(int(idx), value))
    return out
