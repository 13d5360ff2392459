"""ParagraphVectors (doc2vec): label-aware documents over SequenceVectors —
counterpart of ``deeplearning4j_tpu/nlp/paragraphvectors.py``.

Reference: ``models/paragraphvectors/ParagraphVectors.java`` — labels are
special vocab elements trained alongside words via DBOW
(``learning/impl/sequence/DBOW.java``: label row predicts each word) or DM
(``DM.java``: label joins the averaged context), ``inferVector`` (train a
fresh vector against frozen weights), ``predict`` (nearest label).

``infer_vector`` runs its steps eagerly on the model's device (one text
at a time, of its own length) against the frozen output weights, which
its steps leave as they are (``update_out=False``) where the reference
updates a copy and drops it.
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.nlp import learning
from deeplearning4j_tpu_torch.nlp.documents import (
    LabelAwareIterator,
    LabelsSource,
    SimpleLabelAwareIterator,
)
from deeplearning4j_tpu_torch.nlp.sequencevectors import SequenceVectors, VectorsConfiguration
from deeplearning4j_tpu_torch.nlp.tokenization import DefaultTokenizerFactory, TokenizerFactory
from deeplearning4j_tpu_torch.nlp.vocab import Sequence, VocabWord


class ParagraphVectors(SequenceVectors):
    def __init__(self, config: VectorsConfiguration,
                 document_iterator: LabelAwareIterator,
                 tokenizer_factory: TokenizerFactory, device=None):
        self.document_iterator = document_iterator
        self.tokenizer_factory = tokenizer_factory
        self.labels_source = LabelsSource()
        config.train_sequences = True
        super().__init__(config, self._sequences, device=device)

    def _sequences(self) -> Iterable[Sequence]:
        self.document_iterator.reset()
        while self.document_iterator.has_next():
            doc = self.document_iterator.next_document()
            tokens = self.tokenizer_factory.create(doc.content).tokens()
            if not tokens:
                continue
            seq = Sequence()
            for t in tokens:
                seq.add_element(VocabWord(label=t))
            label = doc.label or self.labels_source.next_label()
            self.labels_source.store_label(label)
            seq.set_sequence_label(VocabWord(label=label, special=True))
            yield seq

    # ----------------------------------------------------------- inference
    def infer_vector(self, text: str, steps: int = 30,
                     learning_rate: float = 0.025) -> np.ndarray:
        """Train a fresh doc vector against frozen word weights.
        ≙ ``ParagraphVectors.inferVector``."""
        cfg = self.config
        tokens = self.tokenizer_factory.create(text).tokens()
        idx = np.array([self.vocab.index_of(t) for t in tokens], np.int64)
        idx = idx[idx >= 0].astype(np.int32)
        D = cfg.layer_size
        rs = np.random.RandomState(cfg.seed)
        init = (rs.rand(1, D).astype(np.float32) - 0.5) / D
        if len(idx) == 0:
            return init[0]
        lk = self.lookup
        dev = lk.device
        vec = torch.as_tensor(init).to(dev)
        n = len(idx)
        inputs = torch.zeros((n,), dtype=torch.int32, device=dev)  # row 0 of `vec`
        targets = torch.as_tensor(idx).to(dev)
        mask = torch.ones((n,), dtype=torch.float32, device=dev)
        # every step's lr and negative-sampling key go up in one copy each
        lrs = torch.as_tensor(np.array(
            [learning_rate * (1.0 - step / steps) + 1e-4
             for step in range(steps)], np.float32)).to(dev)
        if cfg.negative > 0:
            keys = torch.tensor([self._next_key() for _ in range(steps)],
                                dtype=torch.int64).to(dev)
        if cfg.use_hierarchic_softmax:
            pts, cds, code_mask = self._path(targets)
        for step in range(steps):
            lr = lrs[step]
            if cfg.negative > 0:
                negs = lk.sample_negatives(keys[step], (n, cfg.negative))
                learning.sg_ns_step(vec, lk.syn1neg, inputs, targets, negs,
                                    mask, lr, update_out=False)
            if cfg.use_hierarchic_softmax:
                learning.sg_hs_step(vec, lk.syn1, inputs, pts, cds, code_mask,
                                    mask, lr, update_out=False)
        return vec[0].cpu().numpy()

    def predict(self, text: str) -> Optional[str]:
        """Nearest label to the inferred document vector.
        ≙ ``ParagraphVectors.predict``."""
        v = self.infer_vector(text)
        labels = [l for l in self.labels_source.labels
                  if self.vocab.contains_word(l)]
        if not labels:
            return None
        mat = self.get_word_vector_matrix(labels)
        mat = mat / np.maximum(np.linalg.norm(mat, axis=1, keepdims=True), 1e-12)
        qn = v / max(np.linalg.norm(v), 1e-12)
        return labels[int(np.argmax(mat @ qn))]

    class Builder:
        """≙ ``ParagraphVectors.Builder``."""

        def __init__(self):
            self._cfg = VectorsConfiguration(train_sequences=True)
            self._iterator: Optional[LabelAwareIterator] = None
            self._tokenizer: TokenizerFactory = DefaultTokenizerFactory()
            self._device = None

        def device(self, device) -> "ParagraphVectors.Builder":
            """Where the matrices live: ``cuda`` (the default) or ``cpu``."""
            self._device = device
            return self

        def iterate(self, iterator) -> "ParagraphVectors.Builder":
            if isinstance(iterator, (list, tuple)):
                iterator = SimpleLabelAwareIterator(iterator)
            self._iterator = iterator
            return self

        def tokenizer_factory(self, tf):
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

        def epochs(self, n: int):
            self._cfg.epochs = n
            return self

        def seed(self, s: int):
            self._cfg.seed = s
            return self

        def batch_size(self, n: int):
            self._cfg.batch_size = n
            return self

        def sequence_learning_algorithm(self, name: str):
            self._cfg.sequence_algorithm = name.lower()
            return self

        def train_words_representation(self, b: bool):
            self._cfg.train_elements = b
            return self

        def build(self) -> "ParagraphVectors":
            if self._iterator is None:
                raise ValueError("ParagraphVectors.Builder: iterate(...) required")
            return ParagraphVectors(self._cfg, self._iterator, self._tokenizer,
                                    device=self._device)
