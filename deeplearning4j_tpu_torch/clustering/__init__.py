"""Clustering + space-partition trees + t-SNE (≙ deeplearning4j-core
``clustering/`` and ``plot/``) — counterpart of
``deeplearning4j_tpu/clustering``."""

from deeplearning4j_tpu_torch.clustering.kmeans import (
    Cluster, ClusterSet, KMeansClustering,
)
from deeplearning4j_tpu_torch.clustering.trees import (
    KDTree, QuadTree, SpTree, VPTree,
)
from deeplearning4j_tpu_torch.clustering.tsne import BarnesHutTsne, Tsne

__all__ = ["Cluster", "ClusterSet", "KMeansClustering", "KDTree", "QuadTree",
           "SpTree", "VPTree", "BarnesHutTsne", "Tsne"]
