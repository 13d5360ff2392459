"""DeepWalk: random-walk + skip-gram vertex embeddings — counterpart of
``deeplearning4j_tpu/graphs/deepwalk.py``.

Reference: ``graph/models/deepwalk/DeepWalk.java`` (Builder: vectorSize,
windowSize, learningRate, walkLength, walksPerVertex; fit(graph) generates
walks and trains skip-gram over them with a ``GraphHuffman`` tree +
``InMemoryGraphLookupTable``), ``models/GraphVectors.java`` query surface
(similarity, verticesNearest).

As in the reference package, the walks come from the host's vectorised
``generate_walks`` sweep and train through the port's SequenceVectors
engine (``nlp/sequencevectors.py``): hierarchical softmax over a Huffman
tree on vertex visit frequencies, each padded batch one captured program
on the card.  Every walk element becomes a ``VocabWord``, as in the
reference, so the vocabulary, the tree and the pair stream are the
reference's.  The queries read the device tables.  ``from_numpy`` takes
a trained model's vocabulary and matrices from the JAX package.
"""

from __future__ import annotations

from typing import List, Optional, Sequence as Seq, Tuple

import numpy as np

from deeplearning4j_tpu_torch.backend.device import resolve_device
from deeplearning4j_tpu_torch.graphs.api import Graph
from deeplearning4j_tpu_torch.graphs.walks import generate_walks
from deeplearning4j_tpu_torch.nlp.sequencevectors import (
    SequenceVectors, VectorsConfiguration,
)
from deeplearning4j_tpu_torch.nlp.serializer import lookup_from_numpy
from deeplearning4j_tpu_torch.nlp.vocab import Sequence, VocabCache, VocabWord
from deeplearning4j_tpu_torch.nlp.word2vec import StaticWord2Vec


class DeepWalk:
    def __init__(self, vector_size: int = 100, window_size: int = 5,
                 learning_rate: float = 0.025, walk_length: int = 40,
                 walks_per_vertex: int = 10, epochs: int = 1,
                 negative: int = 0, use_hierarchic_softmax: bool = True,
                 batch_size: int = 512, seed: int = 12345, device=None):
        """The matrices live on ``device``: ``cuda`` unless the caller
        names the CPU."""
        self.vector_size = vector_size
        self.window_size = window_size
        self.learning_rate = learning_rate
        self.walk_length = walk_length
        self.walks_per_vertex = walks_per_vertex
        self.epochs = epochs
        self.negative = negative
        self.use_hierarchic_softmax = use_hierarchic_softmax
        self.batch_size = batch_size
        self.seed = seed
        self.device = resolve_device(device)
        self._sv = None
        self.graph: Optional[Graph] = None

    # ---------------------------------------------------------------- fit
    def fit(self, graph: Graph, walks: Optional[np.ndarray] = None
            ) -> "DeepWalk":
        """Trains on ``graph``'s walks: ``generate_walks`` at the model's
        settings, or the ``[n, L]`` vertex array ``walks`` given."""
        self.graph = graph
        if walks is None:
            walks = generate_walks(graph, self.walk_length,
                                   self.walks_per_vertex, seed=self.seed)

        def sequences():
            for row in walks:
                seq = Sequence()
                for v in row:
                    seq.add_element(VocabWord(label=str(int(v))))
                yield seq

        cfg = VectorsConfiguration(
            layer_size=self.vector_size,
            window=self.window_size,
            learning_rate=self.learning_rate,
            negative=self.negative,
            use_hierarchic_softmax=self.use_hierarchic_softmax,
            min_word_frequency=1,
            epochs=self.epochs,
            batch_size=self.batch_size,
            seed=self.seed,
        )
        self._sv = SequenceVectors(cfg, sequences, device=self.device)
        self._sv._capture = getattr(self, "_capture", True)
        self._sv.fit()
        return self

    @classmethod
    def from_numpy(cls, graph: Optional[Graph],
                   vocab: Seq[Tuple[str, float]], syn0, syn1=None,
                   syn1neg=None, device=None, **config) -> "DeepWalk":
        """A query-ready DeepWalk from another package's trained model:
        ``vocab`` the (label, frequency) of each vertex in index order,
        ``syn0`` (and ``syn1``/``syn1neg`` where trained) its matrices;
        ``config`` the constructor's settings."""
        model = cls(device=device, **config)
        model.graph = graph
        cache = VocabCache()
        for i, (label, freq) in enumerate(vocab):
            cache.add_token(VocabWord(label=label,
                                      element_frequency=float(freq), index=i))
        cache._by_index = [cache.word_for(label) for label, _ in vocab]
        cache.total_word_count = float(sum(f for _, f in vocab))
        model._sv = StaticWord2Vec(cache, lookup_from_numpy(
            cache, syn0, syn1, syn1neg, device=model.device))
        return model

    # -------------------------------------------------- GraphVectors query
    @property
    def lookup(self):
        return self._sv.lookup

    @property
    def vocab(self):
        return self._sv.vocab

    @property
    def programs(self):
        """The last fit's step programs (captures and replays)."""
        return getattr(self._sv, "programs", None)

    @property
    def cum_loss(self) -> float:
        return self._sv.cum_loss

    def num_vertices(self) -> int:
        return self.graph.num_vertices if self.graph else 0

    def vertex_vector(self, idx: int) -> np.ndarray:
        return self._sv.get_word_vector(str(idx))

    def similarity(self, a: int, b: int) -> float:
        """≙ ``GraphVectorsImpl.similarity``."""
        return self._sv.similarity(str(a), str(b))

    def vertices_nearest(self, idx: int, top_n: int = 10) -> List[int]:
        return [int(w) for w in self._sv.words_nearest(str(idx), top_n=top_n)]
