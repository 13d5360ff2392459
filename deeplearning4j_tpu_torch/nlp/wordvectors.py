"""WordVectors query surface — counterpart of
``deeplearning4j_tpu/nlp/wordvectors.py``: similarity, wordsNearest,
arithmetic.

Reference: ``models/embeddings/wordvectors/WordVectors.java`` and
``models/embeddings/reader/impl/BasicModelUtils.java`` (cosine
``wordsNearest``, ``wordsNearestSum``, similarity).

A nearest-neighbour query is one normalised matrix-vector product and
``torch.topk`` on the table's device.  Equal similarities go to the
lower index, as ``jax.lax.top_k`` breaks them: every row tied with the
k-th value is a candidate, and a stable sort keeps them in index order.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch


def _top_indices(sims: torch.Tensor, k: int) -> np.ndarray:
    """The ``k`` largest of ``sims`` by value, ties to the lower index."""
    if k <= 0:
        return np.empty(0, np.int64)
    kth = torch.topk(sims, k).values[-1]
    cand = torch.nonzero(sims >= kth).squeeze(1)          # index order
    order = torch.sort(sims[cand], descending=True, stable=True).indices
    return cand[order][:k].cpu().numpy()


class WordVectors:
    """Mixin over ``self.lookup`` (InMemoryLookupTable) + ``self.vocab``."""

    # subclasses provide: self.lookup, self.vocab

    def has_word(self, word: str) -> bool:
        return self.vocab.contains_word(word)

    def get_word_vector(self, word: str) -> Optional[np.ndarray]:
        return self.lookup.vector(word)

    def get_word_vector_matrix(self, words: Sequence[str]) -> np.ndarray:
        idx = [self.vocab.index_of(w) for w in words]
        if any(i < 0 for i in idx):
            missing = [w for w, i in zip(words, idx) if i < 0]
            raise KeyError(f"Words not in vocab: {missing}")
        syn0 = self.lookup.syn0
        return syn0[torch.as_tensor(idx, device=syn0.device)].cpu().numpy()

    def similarity(self, a: str, b: str) -> float:
        va, vb = self.get_word_vector(a), self.get_word_vector(b)
        if va is None or vb is None:
            return float("nan")
        denom = (np.linalg.norm(va) * np.linalg.norm(vb))
        if denom == 0:
            return 0.0
        return float(np.dot(va, vb) / denom)

    def _normed_syn0(self) -> torch.Tensor:
        syn0 = self.lookup.syn0
        return syn0 / torch.clamp(torch.linalg.norm(syn0, dim=1,
                                                    keepdim=True), min=1e-12)

    def _sims(self, qn: np.ndarray) -> torch.Tensor:
        syn0 = self.lookup.syn0
        return self._normed_syn0() @ torch.as_tensor(
            np.asarray(qn, np.float32), device=syn0.device)

    def words_nearest(self, positive, negative=(), top_n: int = 10) -> List[str]:
        """Cosine nearest words to (Σ positive − Σ negative); query words are
        excluded from the result (reference BasicModelUtils semantics).
        ``positive`` may be a single word, a list of words, or a raw vector."""
        exclude = set()
        if isinstance(positive, str):
            positive = [positive]
        if isinstance(positive, (list, tuple)) and positive and isinstance(positive[0], str):
            vecs = [self.get_word_vector(w) for w in positive]
            exclude.update(positive)
            if any(v is None for v in vecs):
                return []
            query = np.sum(vecs, axis=0)
        else:
            query = np.asarray(positive)
        for w in (negative if not isinstance(negative, str) else [negative]):
            v = self.get_word_vector(w)
            exclude.add(w)
            if v is not None:
                query = query - v
        qn = query / max(np.linalg.norm(query), 1e-12)
        sims = self._sims(qn)
        k = min(top_n + len(exclude), int(sims.shape[0]))
        out = []
        for i in _top_indices(sims, k):
            label = self.vocab.element_at_index(int(i)).label
            if label in exclude:
                continue
            out.append(label)
            if len(out) == top_n:
                break
        return out

    def words_nearest_sum(self, positive, negative=(), top_n: int = 10) -> List[str]:
        return self.words_nearest(positive, negative, top_n)

    def similar_words_in_vocab_to(self, word: str, accuracy: float) -> List[str]:
        v = self.get_word_vector(word)
        if v is None:
            return []
        qn = v / max(np.linalg.norm(v), 1e-12)
        sims = self._sims(qn).cpu().numpy()
        out = [self.vocab.element_at_index(i).label
               for i in np.nonzero(sims >= accuracy)[0]]
        return [w for w in out if w != word]
