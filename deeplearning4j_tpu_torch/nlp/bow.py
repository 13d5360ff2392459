"""Bag-of-words / TF-IDF vectorizers.

Reference: ``bagofwords/vectorizer/{BagOfWordsVectorizer,TfidfVectorizer}
.java`` (710 LoC) — fit a vocab over documents, then transform each document
into a count / tf-idf row.

The port's copy of ``deeplearning4j_tpu/nlp/bow.py``: no framework,
so its outputs equal the reference's exactly.
"""

from __future__ import annotations

import math
from typing import Iterable, List, Optional

import numpy as np

from deeplearning4j_tpu_torch.nlp.tokenization import DefaultTokenizerFactory, TokenizerFactory
from deeplearning4j_tpu_torch.nlp.vocab import Sequence, VocabCache, VocabConstructor, VocabWord


class BaseVectorizer:
    def __init__(self, tokenizer_factory: Optional[TokenizerFactory] = None,
                 min_word_frequency: int = 1,
                 stop_words: Iterable[str] = ()):
        self.tokenizer_factory = tokenizer_factory or DefaultTokenizerFactory()
        self.min_word_frequency = min_word_frequency
        self.stop_words = frozenset(stop_words)
        self.vocab: Optional[VocabCache] = None
        self.doc_count = 0
        self._doc_freq: Optional[np.ndarray] = None

    def _tokens(self, text: str) -> List[str]:
        return [t for t in self.tokenizer_factory.create(text).tokens()
                if t not in self.stop_words]

    def fit(self, documents: Iterable[str]) -> "BaseVectorizer":
        documents = list(documents)

        def seqs():
            for d in documents:
                seq = Sequence()
                for t in self._tokens(d):
                    seq.add_element(VocabWord(label=t))
                yield seq

        self.vocab = VocabConstructor(
            min_element_frequency=self.min_word_frequency).build_vocab(seqs())
        self.doc_count = len(documents)
        df = np.zeros(len(self.vocab), np.float64)
        for d in documents:
            seen = {self.vocab.index_of(t) for t in self._tokens(d)}
            for i in seen:
                if i >= 0:
                    df[i] += 1
        self._doc_freq = df
        return self

    def _counts(self, text: str) -> np.ndarray:
        row = np.zeros(len(self.vocab), np.float32)
        for t in self._tokens(text):
            i = self.vocab.index_of(t)
            if i >= 0:
                row[i] += 1.0
        return row

    def transform(self, document: str) -> np.ndarray:
        raise NotImplementedError

    def fit_transform(self, documents: Iterable[str]) -> np.ndarray:
        documents = list(documents)
        self.fit(documents)
        return np.stack([self.transform(d) for d in documents])

    def vocab_words(self) -> List[str]:
        return self.vocab.words()


class BagOfWordsVectorizer(BaseVectorizer):
    """Raw term counts. ≙ ``BagOfWordsVectorizer.java``."""

    def transform(self, document: str) -> np.ndarray:
        return self._counts(document)


class TfidfVectorizer(BaseVectorizer):
    """tf·idf with idf = log(N / df). ≙ ``TfidfVectorizer.java``."""

    def idf(self) -> np.ndarray:
        return np.log(np.maximum(self.doc_count, 1)
                      / np.maximum(self._doc_freq, 1.0)).astype(np.float32)

    def transform(self, document: str) -> np.ndarray:
        counts = self._counts(document)
        total = max(counts.sum(), 1.0)
        tf = counts / total
        return tf * self.idf()
