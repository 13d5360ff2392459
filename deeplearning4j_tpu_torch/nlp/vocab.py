"""Vocabulary: elements, cache, constructor, Huffman coding.

Reference: ``models/word2vec/wordstore/`` — ``VocabWord`` (a
``SequenceElement`` with frequency/index/Huffman codes),
``inmemory/AbstractCache`` (the vocab cache), ``VocabConstructor``
(parallel corpus scan + min-frequency pruning), and
``models/word2vec/Huffman.java:34`` (tree build assigning codes/points).

Codes/points are materialised as dense padded numpy arrays
(``codes_matrix``) so the hierarchical-softmax path is one gather per batch
instead of per-word ragged walks.

The port's copy of ``deeplearning4j_tpu/nlp/vocab.py``: no framework,
so its outputs equal the reference's exactly.
"""

from __future__ import annotations

import hashlib
import heapq
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence as Seq

import numpy as np


@dataclass
class SequenceElement:
    """≙ ``sequencevectors/sequence/SequenceElement.java`` — the generic
    trainable element (word, graph vertex, document label...)."""

    label: str
    element_frequency: float = 1.0
    index: int = -1
    # Huffman coding (hierarchical softmax)
    codes: List[int] = field(default_factory=list)
    points: List[int] = field(default_factory=list)
    # ParagraphVectors marks label elements specially
    special: bool = False

    def increment_frequency(self, by: float = 1.0) -> None:
        self.element_frequency += by


class VocabWord(SequenceElement):
    """≙ ``models/word2vec/VocabWord.java``."""


@dataclass
class Sequence:
    """An ordered run of elements (sentence, walk, document).
    ≙ ``sequencevectors/sequence/Sequence.java``."""

    elements: List[SequenceElement] = field(default_factory=list)
    labels: List[SequenceElement] = field(default_factory=list)

    def add_element(self, el: SequenceElement) -> None:
        self.elements.append(el)

    def set_sequence_label(self, el: SequenceElement) -> None:
        self.labels = [el]

    @property
    def sequence_label(self) -> Optional[SequenceElement]:
        return self.labels[0] if self.labels else None


class VocabCache:
    """In-memory vocab. ≙ ``wordstore/inmemory/AbstractCache.java``."""

    def __init__(self):
        self._by_label: Dict[str, SequenceElement] = {}
        self._by_index: List[SequenceElement] = []
        self.total_word_count: float = 0.0

    # -- build
    def add_token(self, el: SequenceElement) -> SequenceElement:
        cur = self._by_label.get(el.label)
        if cur is None:
            self._by_label[el.label] = el
            return el
        cur.increment_frequency(el.element_frequency)
        return cur

    def finalize_vocab(self) -> None:
        """Assign indices by descending frequency (ties: label order) and
        recompute totals."""
        elements = sorted(self._by_label.values(),
                          key=lambda e: (-e.element_frequency, e.label))
        self._by_index = elements
        for i, el in enumerate(elements):
            el.index = i
        self.total_word_count = float(sum(e.element_frequency for e in elements
                                          if not e.special))

    # -- query
    def contains_word(self, label: str) -> bool:
        return label in self._by_label

    def word_for(self, label: str) -> Optional[SequenceElement]:
        return self._by_label.get(label)

    def element_at_index(self, idx: int) -> SequenceElement:
        return self._by_index[idx]

    def index_of(self, label: str) -> int:
        el = self._by_label.get(label)
        return -1 if el is None else el.index

    def word_frequency(self, label: str) -> float:
        el = self._by_label.get(label)
        return 0.0 if el is None else el.element_frequency

    def num_words(self) -> int:
        return len(self._by_label)

    def words(self) -> List[str]:
        return [e.label for e in self._by_index]

    def vocab_words(self) -> List[SequenceElement]:
        return list(self._by_index)

    def __len__(self) -> int:
        return len(self._by_label)


class VocabConstructor:
    """Corpus scan → counted, pruned, index-assigned vocab.
    ≙ ``wordstore/VocabConstructor.java`` (buildJointVocabulary).
    """

    def __init__(self, min_element_frequency: float = 1.0,
                 element_cls=VocabWord):
        self.min_element_frequency = min_element_frequency
        self.element_cls = element_cls

    def build_vocab(self, sequences: Iterable[Sequence],
                    cache: Optional[VocabCache] = None) -> VocabCache:
        cache = cache or VocabCache()
        n_sequences = 0
        for seq in sequences:
            n_sequences += 1
            for el in seq.elements:
                label = el.label if isinstance(el, SequenceElement) else str(el)
                cache.add_token(self.element_cls(label=label))
            for lab in seq.labels:
                held = cache.add_token(self.element_cls(label=lab.label, special=True))
                held.special = True
        # prune below min frequency (labels/special elements are kept)
        for label in [e.label for e in cache._by_label.values()
                      if not e.special and e.element_frequency < self.min_element_frequency]:
            del cache._by_label[label]
        cache.finalize_vocab()
        return cache


def build_huffman(cache: VocabCache) -> None:
    """Huffman-code the vocab in place: frequent words get short codes.
    ≙ ``models/word2vec/Huffman.java:34``.

    After this, each element has ``codes`` (bit path, 0/1) and ``points``
    (inner-node ids usable as rows of ``syn1``).
    """
    words = cache.vocab_words()
    V = len(words)
    if V == 0:
        return
    # heap of (freq, tiebreak, node_id); leaves are 0..V-1, inner V..2V-2
    heap = [(w.element_frequency, i, i) for i, w in enumerate(words)]
    heapq.heapify(heap)
    parent = {}
    binary = {}
    next_id = V
    while len(heap) > 1:
        f1, _, n1 = heapq.heappop(heap)
        f2, _, n2 = heapq.heappop(heap)
        parent[n1], parent[n2] = next_id, next_id
        binary[n1], binary[n2] = 0, 1
        heapq.heappush(heap, (f1 + f2, next_id, next_id))
        next_id += 1
    root = heap[0][2] if heap else None
    for i, w in enumerate(words):
        codes, points = [], []
        node = i
        while node != root and node in parent:
            codes.append(binary[node])
            points.append(parent[node] - V)  # inner-node row in syn1
            node = parent[node]
        codes.reverse()
        points.reverse()
        w.codes = codes
        w.points = points


def codes_matrix(cache: VocabCache):
    """Dense padded (codes, points, lengths) arrays for batched HS.
    Rows align with vocab indices.  Padding rows point at inner node 0 with
    length-masked contributions."""
    words = cache.vocab_words()
    V = len(words)
    L = max((len(w.codes) for w in words), default=1) or 1
    codes = np.zeros((V, L), np.float32)
    points = np.zeros((V, L), np.int32)
    lengths = np.zeros((V,), np.int32)
    for i, w in enumerate(words):
        n = len(w.codes)
        lengths[i] = n
        codes[i, :n] = w.codes
        points[i, :n] = w.points
    return codes, points, lengths


def digest(cache: VocabCache) -> bytes:
    """sha256 of the vocabulary as training reads it: every element's
    label, frequency, index, Huffman codes and points in index order,
    and the total word count (what every process of a distributed fit
    must hold alike)."""
    h = hashlib.sha256()
    for w in cache.vocab_words():
        h.update(repr((w.label, float(w.element_frequency), w.index,
                       w.special, list(w.codes), list(w.points))).encode())
    h.update(repr(float(cache.total_word_count)).encode())
    return h.digest()
