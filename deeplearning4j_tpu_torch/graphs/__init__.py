"""Graph embeddings module (≙ deeplearning4j-graph) — counterpart of
``deeplearning4j_tpu/graphs``.

Graph API + loaders + random walks (host numpy, copies of the
reference's) + DeepWalk, whose training rides the port's SequenceVectors
engine (walks are sequences of vertex labels) on the card.
"""

from deeplearning4j_tpu_torch.graphs.api import Edge, Graph, Vertex
from deeplearning4j_tpu_torch.graphs.loaders import (
    load_delimited_edges,
    load_delimited_vertices,
    load_weighted_edges,
)
from deeplearning4j_tpu_torch.graphs.walks import (
    RandomWalkIterator,
    WeightedRandomWalkIterator,
    generate_walks,
)
from deeplearning4j_tpu_torch.graphs.deepwalk import DeepWalk

__all__ = [
    "Edge", "Graph", "Vertex", "load_delimited_edges",
    "load_delimited_vertices", "load_weighted_edges", "RandomWalkIterator",
    "WeightedRandomWalkIterator", "generate_walks", "DeepWalk",
]
