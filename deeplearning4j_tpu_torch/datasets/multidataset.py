"""MultiDataSet — multi-input / multi-output minibatches for ComputationGraph.

Reference: ND4J ``MultiDataSet`` (features[], labels[] + masks) consumed by
``ComputationGraph.fit(MultiDataSetIterator)`` (``ComputationGraph.java:599``),
built from named record-reader columns by
``RecordReaderMultiDataSetIterator`` (``deeplearning4j-core/.../datavec/
RecordReaderMultiDataSetIterator.java``: builder with addInput/addOutput/
addOutputOneHot column ranges) and prefetched by
``AsyncMultiDataSetIterator`` (``deeplearning4j-nn/.../iterator/
AsyncMultiDataSetIterator.java``).

Arrays stay host-side numpy tuples; the graph's train step stages them
onto the card once a step (through the captured step's pinned ring).
Inputs/outputs map positionally onto ``GraphConfiguration.inputs`` /
``.outputs`` (the reference's convention).

Port: a copy of ``deeplearning4j_tpu/datasets/multidataset.py``.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class MultiDataSet:
    features: Tuple[np.ndarray, ...]
    labels: Tuple[np.ndarray, ...]
    features_masks: Optional[Tuple[Optional[np.ndarray], ...]] = None
    labels_masks: Optional[Tuple[Optional[np.ndarray], ...]] = None

    def __post_init__(self):
        self.features = tuple(self.features)
        self.labels = tuple(self.labels)
        if self.features_masks is not None:
            self.features_masks = tuple(self.features_masks)
        if self.labels_masks is not None:
            self.labels_masks = tuple(self.labels_masks)

    def __len__(self) -> int:
        return self.features[0].shape[0]

    def num_examples(self) -> int:
        return len(self)

    def subset(self, idx) -> "MultiDataSet":
        def _sub(arrs):
            if arrs is None:
                return None
            return tuple(None if a is None else a[idx] for a in arrs)

        return MultiDataSet(_sub(self.features), _sub(self.labels),
                            _sub(self.features_masks), _sub(self.labels_masks))

    def shuffle(self, rng: np.random.RandomState) -> "MultiDataSet":
        idx = np.arange(len(self))
        rng.shuffle(idx)
        return self.subset(idx)

    def batch_by(self, batch_size: int, drop_last: bool = False) -> List["MultiDataSet"]:
        out = []
        for i in range(0, len(self), batch_size):
            b = self.subset(slice(i, i + batch_size))
            if len(b) < batch_size and drop_last:
                continue
            out.append(b)
        return out

    @staticmethod
    def merge(sets: Sequence["MultiDataSet"]) -> "MultiDataSet":
        def _cat(pick):
            arrs = [pick(s) for s in sets]
            if arrs[0] is None:
                return None
            return tuple(
                None if any(a[i] is None for a in arrs)
                else np.concatenate([a[i] for a in arrs], 0)
                for i in range(len(arrs[0]))
            )

        return MultiDataSet(
            _cat(lambda s: s.features), _cat(lambda s: s.labels),
            _cat(lambda s: s.features_masks), _cat(lambda s: s.labels_masks),
        )


class MultiDataSetIterator:
    """Iterable over MultiDataSet minibatches with reset semantics
    (reference ``MultiDataSetIterator.java``)."""

    def __iter__(self) -> Iterator[MultiDataSet]:
        self.reset()
        return self

    def __next__(self) -> MultiDataSet:
        if not self.has_next():
            raise StopIteration
        return self.next()

    def next(self) -> MultiDataSet:
        raise NotImplementedError

    def has_next(self) -> bool:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError

    def batch(self) -> int:
        raise NotImplementedError

    def async_supported(self) -> bool:
        return True


class ListMultiDataSetIterator(MultiDataSetIterator):
    """In-memory MultiDataSet batched to fixed size."""

    def __init__(self, data: MultiDataSet, batch_size: int, drop_last: bool = False):
        self._data = data
        self._batch_size = batch_size
        self._batches = data.batch_by(batch_size, drop_last)
        self._pos = 0

    def next(self) -> MultiDataSet:
        b = self._batches[self._pos]
        self._pos += 1
        return b

    def has_next(self) -> bool:
        return self._pos < len(self._batches)

    def reset(self) -> None:
        self._pos = 0

    def batch(self) -> int:
        return self._batch_size

    def total_examples(self) -> int:
        return len(self._data)


_SENTINEL = object()


class AsyncMultiDataSetIterator(MultiDataSetIterator):
    """Background-thread prefetch with a bounded queue (reference
    ``AsyncMultiDataSetIterator.java``: blocking queue + producer thread —
    keeps host ETL off the device dispatch path)."""

    def __init__(self, underlying: MultiDataSetIterator, prefetch_size: int = 2):
        self.underlying = underlying
        self.prefetch = prefetch_size
        self._queue: "queue.Queue" = queue.Queue(maxsize=prefetch_size)
        self._thread: Optional[threading.Thread] = None
        self._next_item = _SENTINEL
        self._start()

    def _start(self):
        self._queue = queue.Queue(maxsize=self.prefetch)
        self._producer_error: Optional[BaseException] = None

        def run():
            try:
                while self.underlying.has_next():
                    self._queue.put(self.underlying.next())
            except BaseException as e:  # surface on the consumer side —
                self._producer_error = e  # never silently truncate the epoch
            finally:
                self._queue.put(_SENTINEL)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        self._next_item = self._queue.get()

    def _check_error(self):
        if self._producer_error is not None:
            err, self._producer_error = self._producer_error, None
            raise RuntimeError("async prefetch producer failed") from err

    def has_next(self):
        if self._next_item is _SENTINEL:
            self._check_error()
            return False
        return True

    def next(self):
        item = self._next_item
        if item is _SENTINEL:
            self._check_error()
            raise StopIteration
        self._next_item = self._queue.get()
        return item

    def reset(self):
        if self._thread is not None and self._thread.is_alive():
            while self._next_item is not _SENTINEL:
                self._next_item = self._queue.get()
            self._thread.join(timeout=5)
        self.underlying.reset()
        self._start()

    def batch(self):
        return self.underlying.batch()


@dataclasses.dataclass(frozen=True)
class _ColumnSpec:
    reader: str
    col_from: int
    col_to: int              # inclusive, reference convention
    one_hot_classes: Optional[int] = None


class RecordReaderMultiDataSetIterator(MultiDataSetIterator):
    """Named record readers -> multi-input/-output minibatches (reference
    ``RecordReaderMultiDataSetIterator.java`` builder).  Column ranges are
    inclusive, matching the reference's ``addInput(name, from, to)``.

    Example::

        it = (RecordReaderMultiDataSetIterator.builder(batch_size=32)
              .add_reader("csv", reader)
              .add_input("csv", 0, 3)
              .add_output_one_hot("csv", 4, 3)
              .build())
    """

    def __init__(self, batch_size: int, readers, inputs, outputs):
        self._batch_size = batch_size
        self._readers = readers            # name -> RecordReader
        self._inputs: List[_ColumnSpec] = inputs
        self._outputs: List[_ColumnSpec] = outputs
        self.reset()

    class Builder:
        def __init__(self, batch_size: int):
            self._batch = batch_size
            self._readers = {}
            self._inputs: List[_ColumnSpec] = []
            self._outputs: List[_ColumnSpec] = []

        def add_reader(self, name: str, reader) -> "RecordReaderMultiDataSetIterator.Builder":
            self._readers[name] = reader
            return self

        def add_input(self, reader: str, col_from: int, col_to: int):
            self._inputs.append(_ColumnSpec(reader, col_from, col_to))
            return self

        def add_output(self, reader: str, col_from: int, col_to: int):
            self._outputs.append(_ColumnSpec(reader, col_from, col_to))
            return self

        def add_output_one_hot(self, reader: str, column: int, num_classes: int):
            self._outputs.append(
                _ColumnSpec(reader, column, column, one_hot_classes=num_classes))
            return self

        def build(self) -> "RecordReaderMultiDataSetIterator":
            for spec in self._inputs + self._outputs:
                if spec.reader not in self._readers:
                    raise ValueError(f"unknown reader '{spec.reader}'")
            if not self._inputs or not self._outputs:
                raise ValueError("need at least one input and one output spec")
            return RecordReaderMultiDataSetIterator(
                self._batch, self._readers, self._inputs, self._outputs)

    @staticmethod
    def builder(batch_size: int) -> "RecordReaderMultiDataSetIterator.Builder":
        return RecordReaderMultiDataSetIterator.Builder(batch_size)

    def reset(self):
        for r in self._readers.values():
            r.reset()
        self._done = False

    def has_next(self):
        if self._done:
            return False
        return all(r.has_next() for r in self._readers.values())

    def _collect(self, spec: _ColumnSpec, rows: dict) -> np.ndarray:
        vals = np.asarray(rows[spec.reader], np.float32)
        cols = vals[:, spec.col_from : spec.col_to + 1]
        if spec.one_hot_classes is not None:
            idx = cols[:, 0].astype(np.int64)
            return np.eye(spec.one_hot_classes, dtype=np.float32)[idx]
        return cols

    def next(self) -> MultiDataSet:
        rows = {name: [] for name in self._readers}
        for _ in range(self._batch_size):
            if not all(r.has_next() for r in self._readers.values()):
                break
            for name, r in self._readers.items():
                rows[name].append(np.asarray(r.next_record(), np.float32))
        if not any(rows.values()):
            raise StopIteration
        if not all(r.has_next() for r in self._readers.values()):
            self._done = True
        feats = tuple(self._collect(s, rows) for s in self._inputs)
        labs = tuple(self._collect(s, rows) for s in self._outputs)
        return MultiDataSet(feats, labs)

    def batch(self):
        return self._batch_size
