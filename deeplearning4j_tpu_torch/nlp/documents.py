"""Sentence / document iterators (the corpus-ingest layer).

Reference: ``deeplearning4j-nlp/.../text/sentenceiterator/`` —
``BasicLineIterator`` (file, one sentence per line), ``LineSentenceIterator``,
``CollectionSentenceIterator``, ``AggregatingSentenceIterator``,
``FileSentenceIterator`` (every file in a dir), label-aware variants
(``LabelAwareSentenceIterator``, ``documentiterator/LabelledDocument``,
``LabelAwareIterator``).

The port's copy of ``deeplearning4j_tpu/nlp/documents.py``: no framework,
so its outputs equal the reference's exactly.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Iterable, Iterator, List, Optional


class SentenceIterator:
    """≙ ``sentenceiterator/SentenceIterator.java`` — streaming corpus of
    sentences with reset; optional preprocessor applied per sentence."""

    def __init__(self):
        self.pre_processor = None

    def __iter__(self) -> Iterator[str]:
        self.reset()
        while self.has_next():
            yield self.next_sentence()

    def next_sentence(self) -> str:
        raise NotImplementedError

    def has_next(self) -> bool:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError

    def _apply(self, s: str) -> str:
        if self.pre_processor is not None:
            return self.pre_processor(s)
        return s


class CollectionSentenceIterator(SentenceIterator):
    """≙ ``CollectionSentenceIterator.java``."""

    def __init__(self, sentences: Iterable[str]):
        super().__init__()
        self._sentences = list(sentences)
        self._pos = 0

    def next_sentence(self) -> str:
        s = self._sentences[self._pos]
        self._pos += 1
        return self._apply(s)

    def has_next(self) -> bool:
        return self._pos < len(self._sentences)

    def reset(self) -> None:
        self._pos = 0


class BasicLineIterator(SentenceIterator):
    """One sentence per line from a file. ≙ ``BasicLineIterator.java``."""

    def __init__(self, path: str):
        super().__init__()
        self.path = path
        self._fh = None
        self._next: Optional[str] = None
        self.reset()

    def _advance(self):
        line = self._fh.readline()
        self._next = line.rstrip("\n") if line else None

    def next_sentence(self) -> str:
        s = self._next
        self._advance()
        return self._apply(s)

    def has_next(self) -> bool:
        return self._next is not None

    def reset(self) -> None:
        if self._fh is not None:
            self._fh.close()
        self._fh = open(self.path, "r", encoding="utf-8")
        self._advance()


class FileSentenceIterator(SentenceIterator):
    """Every line of every file under a directory.
    ≙ ``FileSentenceIterator.java``."""

    def __init__(self, root: str):
        super().__init__()
        self.root = root
        self.reset()

    def reset(self) -> None:
        paths = []
        if os.path.isdir(self.root):
            for dirpath, _, files in os.walk(self.root):
                for f in sorted(files):
                    paths.append(os.path.join(dirpath, f))
        else:
            paths = [self.root]
        self._lines: List[str] = []
        for p in paths:
            with open(p, "r", encoding="utf-8") as fh:
                self._lines.extend(line.rstrip("\n") for line in fh)
        self._pos = 0

    def next_sentence(self) -> str:
        s = self._lines[self._pos]
        self._pos += 1
        return self._apply(s)

    def has_next(self) -> bool:
        return self._pos < len(self._lines)


class AggregatingSentenceIterator(SentenceIterator):
    """Chains several iterators. ≙ ``AggregatingSentenceIterator.java``."""

    def __init__(self, *iterators: SentenceIterator):
        super().__init__()
        self._iterators = list(iterators)
        self.reset()

    def reset(self) -> None:
        for it in self._iterators:
            it.reset()
        self._idx = 0

    def _current(self) -> Optional[SentenceIterator]:
        while self._idx < len(self._iterators):
            if self._iterators[self._idx].has_next():
                return self._iterators[self._idx]
            self._idx += 1
        return None

    def has_next(self) -> bool:
        return self._current() is not None

    def next_sentence(self) -> str:
        return self._apply(self._current().next_sentence())


# --------------------------------------------------------------------------
# label-aware documents (ParagraphVectors input)
# --------------------------------------------------------------------------

@dataclass
class LabelledDocument:
    """≙ ``documentiterator/LabelledDocument.java``."""

    content: str
    labels: List[str] = field(default_factory=list)

    @property
    def label(self) -> Optional[str]:
        return self.labels[0] if self.labels else None


class LabelAwareIterator:
    """≙ ``documentiterator/LabelAwareIterator.java``."""

    def __iter__(self) -> Iterator[LabelledDocument]:
        self.reset()
        while self.has_next():
            yield self.next_document()

    def next_document(self) -> LabelledDocument:
        raise NotImplementedError

    def has_next(self) -> bool:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError


class SimpleLabelAwareIterator(LabelAwareIterator):
    """In-memory list of LabelledDocuments.
    ≙ ``documentiterator/SimpleLabelAwareIterator.java``."""

    def __init__(self, documents: Iterable[LabelledDocument]):
        self._docs = list(documents)
        self._pos = 0

    def next_document(self) -> LabelledDocument:
        d = self._docs[self._pos]
        self._pos += 1
        return d

    def has_next(self) -> bool:
        return self._pos < len(self._docs)

    def reset(self) -> None:
        self._pos = 0


class LabelsSource:
    """Generates/holds document labels. ≙ ``text/documentiterator/LabelsSource.java``."""

    def __init__(self, template: str = "DOC_%d"):
        self.template = template
        self.labels: List[str] = []
        self._counter = 0

    def next_label(self) -> str:
        label = self.template % self._counter
        self._counter += 1
        self.labels.append(label)
        return label

    def store_label(self, label: str) -> None:
        if label not in self.labels:
            self.labels.append(label)
