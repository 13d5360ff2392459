"""DataVec bridge — record readers + record->DataSet iterators.

Reference: DataVec's ``RecordReader`` SPI wrapped by
``deeplearning4j-core/.../datasets/datavec/RecordReaderDataSetIterator.java``
(records -> DataSet with one-hot labels / regression slices) and
``SequenceRecordReaderDataSetIterator.java`` (aligned sequence readers ->
[batch, time, features] with masks for unequal lengths).

CSV files parse through the port's native C++ core
(``deeplearning4j_tpu_torch/native``); a non-numeric or ragged field
raises there (the reference re-parses in Python).  Sequence padding and
masking follow the framework's static-shape discipline, so a captured
step sees one signature a padded length.

Port: a copy of ``deeplearning4j_tpu/datasets/datavec.py`` with its imports
rewritten.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Sequence, Union

import numpy as np

from deeplearning4j_tpu_torch import native
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterator import DataSetIterator

# Alignment modes for sequence labels (reference
# SequenceRecordReaderDataSetIterator.AlignmentMode)
ALIGN_START = "align_start"
ALIGN_END = "align_end"
EQUAL_LENGTH = "equal_length"


class RecordReader:
    """Iterates records (one example = list of float values)."""

    def next_record(self) -> List[float]:
        raise NotImplementedError

    def has_next(self) -> bool:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError


class CollectionRecordReader(RecordReader):
    """In-memory list of records (reference CollectionRecordReader)."""

    def __init__(self, records: Sequence[Sequence[float]]):
        self._records = [list(r) for r in records]
        self._pos = 0

    def next_record(self):
        r = self._records[self._pos]
        self._pos += 1
        return r

    def has_next(self):
        return self._pos < len(self._records)

    def reset(self):
        self._pos = 0


class CSVRecordReader(RecordReader):
    """CSV reader (reference CSVRecordReader): one record per line, optional
    header skip.  All-numeric files parse through the native multithreaded
    path.  ``initialize`` takes a file path (str/Path) or literal CSV
    content as ``bytes``."""

    def __init__(self, skip_lines: int = 0, delimiter: str = ","):
        self.skip_lines = skip_lines
        self.delimiter = delimiter
        self._matrix: Optional[np.ndarray] = None
        self._pos = 0

    def initialize(self, source: Union[str, Path, bytes]) -> "CSVRecordReader":
        if isinstance(source, bytes):
            data = source
        else:
            path = Path(source)
            if not path.exists():
                raise FileNotFoundError(
                    f"CSV file not found: {path} (pass literal content as "
                    "bytes)")
            data = path.read_bytes()
        self._matrix = native.csv_to_matrix(data, self.delimiter,
                                            self.skip_lines)
        self._pos = 0
        return self

    def matrix(self) -> np.ndarray:
        if self._matrix is None:
            raise RuntimeError("CSVRecordReader not initialized")
        return self._matrix

    def next_record(self):
        r = self.matrix()[self._pos]
        self._pos += 1
        return list(r)

    def has_next(self):
        return self._matrix is not None and self._pos < len(self._matrix)

    def reset(self):
        self._pos = 0


class SequenceRecordReader:
    """Iterates sequences (one example = [time, values] record list)."""

    def next_sequence(self) -> List[List[float]]:
        raise NotImplementedError

    def has_next(self) -> bool:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError


class CollectionSequenceRecordReader(SequenceRecordReader):
    def __init__(self, sequences: Sequence[Sequence[Sequence[float]]]):
        self._seqs = [[list(r) for r in s] for s in sequences]
        self._pos = 0

    def next_sequence(self):
        s = self._seqs[self._pos]
        self._pos += 1
        return s

    def has_next(self):
        return self._pos < len(self._seqs)

    def reset(self):
        self._pos = 0


class CSVSequenceRecordReader(SequenceRecordReader):
    """One CSV file per sequence (reference CSVSequenceRecordReader)."""

    def __init__(self, skip_lines: int = 0, delimiter: str = ","):
        self.skip_lines = skip_lines
        self.delimiter = delimiter
        self._files: List[Path] = []
        self._pos = 0

    def initialize(self, paths: Sequence[Union[str, Path]]
                   ) -> "CSVSequenceRecordReader":
        self._files = [Path(p) for p in paths]
        self._pos = 0
        return self

    def next_sequence(self):
        m = native.csv_to_matrix(self._files[self._pos].read_bytes(),
                                 self.delimiter, self.skip_lines)
        self._pos += 1
        return [list(r) for r in m]

    def has_next(self):
        return self._pos < len(self._files)

    def reset(self):
        self._pos = 0


def _one_hot(value: float, num_classes: int) -> np.ndarray:
    c = int(value)
    if not 0 <= c < num_classes:
        raise ValueError(f"label value {value} outside [0, {num_classes})")
    out = np.zeros(num_classes, np.float32)
    out[c] = 1.0
    return out


class RecordReaderDataSetIterator(DataSetIterator):
    """Records -> DataSet minibatches.

    Classification: ``label_index`` column becomes a one-hot label over
    ``num_classes``; remaining columns are features.  Regression
    (``regression=True``): columns [label_index, label_index_to] are the
    (raw) label vector.  ``label_index=None`` yields unlabeled features.
    """

    def __init__(self, reader: RecordReader, batch_size: int,
                 label_index: Optional[int] = None,
                 num_classes: Optional[int] = None,
                 regression: bool = False,
                 label_index_to: Optional[int] = None):
        if label_index is not None and not regression and not num_classes:
            raise ValueError("classification needs num_classes")
        self.reader = reader
        self._batch_size = batch_size
        self.label_index = label_index
        self.num_classes = num_classes
        self.regression = regression
        self.label_index_to = (label_index if label_index_to is None
                               else label_index_to)

    def _split(self, record: List[float]):
        vals = np.asarray(record, np.float32)
        if self.label_index is None:
            return vals, None
        lo, hi = self.label_index, self.label_index_to
        label_cols = vals[lo:hi + 1]
        feat = np.concatenate([vals[:lo], vals[hi + 1:]])
        if self.regression:
            return feat, label_cols
        return feat, _one_hot(label_cols[0], self.num_classes)

    def has_next(self):
        return self.reader.has_next()

    def next(self) -> DataSet:
        feats, labels = [], []
        while self.reader.has_next() and len(feats) < self._batch_size:
            f, l = self._split(self.reader.next_record())
            feats.append(f)
            if l is not None:
                labels.append(l)
        features = np.stack(feats)
        labs = (np.stack(labels) if labels
                else np.zeros((len(feats), 0), np.float32))
        return DataSet(features, labs)

    def reset(self):
        self.reader.reset()

    def batch(self):
        return self._batch_size


class SequenceRecordReaderDataSetIterator(DataSetIterator):
    """Aligned (features, labels) sequence readers -> [b, T, f] DataSets with
    masks.  Unequal feature/label lengths are aligned per ``alignment``
    (reference AlignmentMode): labels placed at the start (ALIGN_START) or
    end (ALIGN_END) of the padded time axis, masks marking validity.
    Single-reader mode splits each timestep record at ``label_index``.
    """

    def __init__(self, features_reader: SequenceRecordReader,
                 labels_reader: Optional[SequenceRecordReader] = None,
                 batch_size: int = 32,
                 num_classes: Optional[int] = None,
                 regression: bool = False,
                 label_index: Optional[int] = None,
                 alignment: str = EQUAL_LENGTH):
        self.features_reader = features_reader
        self.labels_reader = labels_reader
        self._batch_size = batch_size
        self.num_classes = num_classes
        self.regression = regression
        self.label_index = label_index
        self.alignment = alignment

    def has_next(self):
        return self.features_reader.has_next()

    def _label_array(self, rows: List[List[float]]) -> np.ndarray:
        if self.regression:
            return np.asarray(rows, np.float32)
        return np.stack([_one_hot(r[0], self.num_classes) for r in rows])

    def next(self) -> DataSet:
        fseqs, lseqs = [], []
        while (self.features_reader.has_next()
               and len(fseqs) < self._batch_size):
            fs = self.features_reader.next_sequence()
            if self.labels_reader is not None:
                ls = self.labels_reader.next_sequence()
            elif self.label_index is not None:
                li = self.label_index
                ls = [[r[li]] for r in fs]
                fs = [r[:li] + r[li + 1:] for r in fs]
            else:
                ls = None
            fseqs.append(np.asarray(fs, np.float32))
            if ls is not None:
                lseqs.append(self._label_array(ls))

        b = len(fseqs)
        T = max(max(len(s) for s in fseqs),
                max((len(s) for s in lseqs), default=0))
        nf = fseqs[0].shape[1]
        features = np.zeros((b, T, nf), np.float32)
        fmask = np.zeros((b, T), np.float32)
        for i, s in enumerate(fseqs):
            t0 = T - len(s) if self.alignment == ALIGN_END else 0
            features[i, t0:t0 + len(s)] = s
            fmask[i, t0:t0 + len(s)] = 1.0
        if not lseqs:
            return DataSet(features, np.zeros((b, T, 0), np.float32), fmask,
                           None)
        nl = lseqs[0].shape[1]
        labels = np.zeros((b, T, nl), np.float32)
        lmask = np.zeros((b, T), np.float32)
        for i, s in enumerate(lseqs):
            t0 = T - len(s) if self.alignment == ALIGN_END else 0
            labels[i, t0:t0 + len(s)] = s
            lmask[i, t0:t0 + len(s)] = 1.0
        return DataSet(features, labels, fmask, lmask)

    def reset(self):
        self.features_reader.reset()
        if self.labels_reader is not None:
            self.labels_reader.reset()

    def batch(self):
        return self._batch_size
