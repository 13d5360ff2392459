"""Word2Vec facade: tokenizer wiring over the SequenceVectors engine —
counterpart of ``deeplearning4j_tpu/nlp/word2vec.py``.

Reference: ``models/word2vec/Word2Vec.java`` (Builder: iterate/
tokenizerFactory/layerSize/windowSize/minWordFrequency/negativeSample/
learningRate/minLearningRate/epochs/iterations/seed/sampling/batchSize/
useHierarchicSoftmax) and ``models/word2vec/StaticWord2Vec.java``
(query-only table).  ``Builder.device`` names where the matrices live
(``cuda`` unless the caller names the CPU).
"""

from __future__ import annotations

from typing import Iterable, Optional


from deeplearning4j_tpu_torch.nlp.documents import CollectionSentenceIterator, SentenceIterator
from deeplearning4j_tpu_torch.nlp.sequencevectors import SequenceVectors, VectorsConfiguration
from deeplearning4j_tpu_torch.nlp.tokenization import DefaultTokenizerFactory, TokenizerFactory
from deeplearning4j_tpu_torch.nlp.vocab import Sequence, VocabWord
from deeplearning4j_tpu_torch.nlp.wordvectors import WordVectors


class Word2Vec(SequenceVectors):
    def __init__(self, config: VectorsConfiguration,
                 sentence_iterator: SentenceIterator,
                 tokenizer_factory: TokenizerFactory, device=None):
        self.sentence_iterator = sentence_iterator
        self.tokenizer_factory = tokenizer_factory
        super().__init__(config, self._sequences, device=device)

    def _sequences(self) -> Iterable[Sequence]:
        self.sentence_iterator.reset()
        while self.sentence_iterator.has_next():
            sentence = self.sentence_iterator.next_sentence()
            if not sentence:
                continue
            tokens = self.tokenizer_factory.create(sentence).tokens()
            if not tokens:
                continue
            seq = Sequence()
            for t in tokens:
                seq.add_element(VocabWord(label=t))
            yield seq

    class Builder:
        """≙ ``Word2Vec.Builder``."""

        def __init__(self):
            self._cfg = VectorsConfiguration()
            self._iterator: Optional[SentenceIterator] = None
            self._tokenizer: TokenizerFactory = DefaultTokenizerFactory()
            self._device = None

        def device(self, device) -> "Word2Vec.Builder":
            """Where the matrices live: ``cuda`` (the default) or ``cpu``."""
            self._device = device
            return self

        def iterate(self, iterator) -> "Word2Vec.Builder":
            if isinstance(iterator, (list, tuple)):
                iterator = CollectionSentenceIterator(iterator)
            self._iterator = iterator
            return self

        def tokenizer_factory(self, tf: TokenizerFactory) -> "Word2Vec.Builder":
            self._tokenizer = tf
            return self

        def layer_size(self, n: int):
            self._cfg.layer_size = n
            return self

        def window_size(self, n: int):
            self._cfg.window = n
            return self

        def min_word_frequency(self, n: int):
            self._cfg.min_word_frequency = n
            return self

        def negative_sample(self, n: int):
            self._cfg.negative = int(n)
            return self

        def use_hierarchic_softmax(self, b: bool):
            self._cfg.use_hierarchic_softmax = b
            return self

        def learning_rate(self, lr: float):
            self._cfg.learning_rate = lr
            return self

        def min_learning_rate(self, lr: float):
            self._cfg.min_learning_rate = lr
            return self

        def epochs(self, n: int):
            self._cfg.epochs = n
            return self

        def iterations(self, n: int):
            self._cfg.iterations = n
            return self

        def seed(self, s: int):
            self._cfg.seed = s
            return self

        def sampling(self, s: float):
            self._cfg.subsampling = s
            return self

        def batch_size(self, n: int):
            self._cfg.batch_size = n
            return self

        def elements_learning_algorithm(self, name: str):
            self._cfg.elements_algorithm = name.lower()
            return self

        def build(self) -> "Word2Vec":
            if self._iterator is None:
                raise ValueError("Word2Vec.Builder: iterate(...) is required")
            return Word2Vec(self._cfg, self._iterator, self._tokenizer,
                            device=self._device)


class StaticWord2Vec(WordVectors):
    """Query-only vectors (no training). ≙ ``StaticWord2Vec.java``."""

    def __init__(self, vocab, lookup):
        self.vocab = vocab
        self.lookup = lookup
