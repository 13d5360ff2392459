"""DataSetIterator abstraction + async prefetch.

Reference: ``datasets/iterator/DataSetIterator.java`` API (next/hasNext/reset/
batch/totalExamples...), ``AsyncDataSetIterator.java:36-76`` (background
thread + LinkedBlockingQueue prefetch — the thread boundary that overlaps
host ETL with device compute), ``MultipleEpochsIterator``,
``SamplingDataSetIterator``, ``IteratorDataSetIterator``.

Port: a copy of ``deeplearning4j_tpu/datasets/iterator.py`` with its
imports rewritten.  Every iterator hands out numpy ``DataSet``s; the
producer thread of ``AsyncDataSetIterator`` touches no tensor and no
CUDA stream: a batch reaches the card on the training thread, staged
through the captured step's pinned ring (``models/capture.py``).
``NativeBatchDataSetIterator`` runs the port's own native batcher
(``deeplearning4j_tpu_torch/native``).
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Iterator, List, Optional

import numpy as np

logger = logging.getLogger("deeplearning4j_tpu_torch.datasets")

from deeplearning4j_tpu_torch.datasets.dataset import DataSet


class DataSetIterator:
    """Iterable over DataSet minibatches with reset semantics."""

    def __iter__(self) -> Iterator[DataSet]:
        self.reset()
        return self

    def __next__(self) -> DataSet:
        if not self.has_next():
            raise StopIteration
        return self.next()

    def next(self) -> DataSet:
        raise NotImplementedError

    def has_next(self) -> bool:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError

    def batch(self) -> int:
        raise NotImplementedError

    def total_examples(self) -> Optional[int]:
        return None

    def input_columns(self) -> Optional[int]:
        return None

    def total_outcomes(self) -> Optional[int]:
        return None

    def async_supported(self) -> bool:
        return True


class ListDataSetIterator(DataSetIterator):
    """In-memory list of examples batched to fixed size (reference
    ``ListDataSetIterator``)."""

    def __init__(self, data: DataSet, batch_size: int, drop_last: bool = False):
        self._data = data
        self._batch_size = batch_size
        self._drop_last = drop_last
        self._batches = data.batch_by(batch_size, drop_last)
        self._pos = 0

    def next(self) -> DataSet:
        b = self._batches[self._pos]
        self._pos += 1
        return b

    def has_next(self) -> bool:
        return self._pos < len(self._batches)

    def reset(self) -> None:
        self._pos = 0

    def batch(self) -> int:
        return self._batch_size

    def total_examples(self):
        return len(self._data)

    def dataset(self) -> DataSet:
        """The whole DataSet this iterator batches (to hand to another
        iterator, e.g. ``NativeBatchDataSetIterator``)."""
        return self._data

    def input_columns(self):
        return int(np.prod(self._data.features.shape[1:]))

    def total_outcomes(self):
        return int(self._data.labels.shape[-1])


class IteratorDataSetIterator(DataSetIterator):
    """Re-batch an iterator of single examples / odd-sized DataSets into
    fixed minibatches (reference ``IteratorDataSetIterator``)."""

    def __init__(self, source, batch_size: int):
        self._source_factory = source if callable(source) else None
        self._source_list = None if callable(source) else list(source)
        self._batch_size = batch_size
        self.reset()

    def reset(self):
        src = self._source_factory() if self._source_factory else iter(self._source_list)
        self._iter = iter(src)
        self._buffer: List[DataSet] = []
        self._exhausted = False
        self._pending: Optional[DataSet] = None
        self._fill()

    def _fill(self):
        count = sum(len(d) for d in self._buffer)
        while count < self._batch_size and not self._exhausted:
            try:
                d = next(self._iter)
                self._buffer.append(d)
                count += len(d)
            except StopIteration:
                self._exhausted = True
        if self._buffer:
            merged = DataSet.merge(self._buffer) if len(self._buffer) > 1 else self._buffer[0]
            if len(merged) > self._batch_size:
                self._pending = merged.subset(slice(self._batch_size, None))
                merged = merged.subset(slice(0, self._batch_size))
            self._buffer = [merged]

    def has_next(self):
        return bool(self._buffer)

    def next(self):
        out = self._buffer.pop(0)
        if self._pending is not None:
            self._buffer = [self._pending]
            self._pending = None
            self._fill()
        else:
            self._fill()
        return out

    def batch(self):
        return self._batch_size


class MultipleEpochsIterator(DataSetIterator):
    """Replays an underlying iterator N times (reference
    ``MultipleEpochsIterator``)."""

    def __init__(self, epochs: int, underlying: DataSetIterator):
        self.epochs = epochs
        self.underlying = underlying
        self._epoch = 0

    def has_next(self):
        if self.underlying.has_next():
            return True
        if self._epoch + 1 < self.epochs:
            self._epoch += 1
            self.underlying.reset()
            return self.underlying.has_next()
        return False

    def next(self):
        return self.underlying.next()

    def reset(self):
        self._epoch = 0
        self.underlying.reset()

    def batch(self):
        return self.underlying.batch()


class SamplingDataSetIterator(DataSetIterator):
    """Draws random with-replacement minibatches (reference
    ``SamplingDataSetIterator``)."""

    def __init__(self, data: DataSet, batch_size: int, total_batches: int, seed: int = 0):
        self._data = data
        self._batch_size = batch_size
        self._total = total_batches
        self._seed = seed
        self.reset()

    def reset(self):
        self._rng = np.random.RandomState(self._seed)
        self._count = 0

    def has_next(self):
        return self._count < self._total

    def next(self):
        idx = self._rng.randint(0, len(self._data), self._batch_size)
        self._count += 1
        return self._data.subset(idx)

    def batch(self):
        return self._batch_size


class NativeBatchDataSetIterator(DataSetIterator):
    """Shuffled minibatch iterator over an in-memory DataSet, backed by the
    port's native C++ pipeline (producer thread + reusable buffer pool,
    ``deeplearning4j_tpu_torch/native``): batch assembly happens off the
    Python thread; a short final batch arrives zero-padded with a
    synthesized labels mask (static shapes, so the captured step keeps
    one signature for full batches and one for the padded one).  Each
    ``reset`` draws a new permutation (seed + resets).
    ``force_python=True`` feeds from the batcher's plain version (the
    same batches, bit for bit)."""

    def __init__(self, data: DataSet, batch_size: int, shuffle: bool = True,
                 seed: int = 1, drop_last: bool = False,
                 force_python: bool = False):
        from deeplearning4j_tpu_torch import native

        if data.features_mask is not None or data.labels_mask is not None:
            raise ValueError("masked DataSets are not supported; use "
                             "ListDataSetIterator")
        self._data = data
        self._batch_size = batch_size
        self._seed = seed
        self._resets = 0
        self._batcher = native.Batcher(data.features, data.labels, batch_size,
                                       shuffle=shuffle, seed=seed,
                                       drop_last=drop_last,
                                       force_python=force_python)
        self._pending: Optional[DataSet] = None
        self._advance()

    def _advance(self):
        out = self._batcher.next()
        if out is None:
            self._pending = None
            return
        feat, lab, n_valid = out
        lmask = None
        if n_valid < self._batch_size:
            # batch already zero-padded by the batcher; just mark valid rows
            shape = ((self._batch_size,) if lab.ndim == 2
                     else (self._batch_size, lab.shape[1]))
            lmask = np.zeros(shape, np.float32)
            lmask[:n_valid] = 1.0
        self._pending = DataSet(feat, lab, None, lmask)

    def has_next(self):
        return self._pending is not None

    def next(self):
        out = self._pending
        if out is None:
            raise StopIteration
        self._advance()
        return out

    def reset(self):
        # new permutation each epoch (deterministic given the base seed)
        self._resets += 1
        self._batcher.reset(self._seed + self._resets)
        self._advance()

    def batch(self):
        return self._batch_size

    def total_examples(self):
        return len(self._data)

    def async_supported(self):
        return False  # already asynchronous

    def close(self):
        self._batcher.close()


_SENTINEL = object()


class AsyncDataSetIterator(DataSetIterator):
    """Background-thread prefetch with a bounded queue (reference
    ``AsyncDataSetIterator.java:36-76``: LinkedBlockingQueue(prefetch) + a
    producer thread).  Wraps any DataSetIterator; ``fit`` wraps its input in
    this automatically like the reference's ``fit(DataSetIterator)`` :1032."""

    def __init__(self, underlying: DataSetIterator, prefetch_size: int = 2,
                 reset_timeout_s: float = 5.0):
        self.underlying = underlying
        self.prefetch = prefetch_size
        self.reset_timeout_s = float(reset_timeout_s)
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
            # drain (bounded) so the producer can finish, then join.  A
            # producer that makes NO progress for a whole timeout window is
            # stuck inside ``underlying.next()`` — starting a second
            # producer over the same underlying iterator would race it
            # (two threads advancing one iterator = interleaved/dropped
            # batches), so hard-fail instead of silently abandoning the
            # old thread.  Each drained item re-arms the deadline: a
            # merely SLOW producer (heavy per-batch preprocessing) gets a
            # full window per batch, not one window for the whole drain.
            deadline = time.monotonic() + self.reset_timeout_s
            while self._next_item is not _SENTINEL:
                try:
                    self._next_item = self._queue.get(
                        timeout=max(0.05, deadline - time.monotonic()))
                except queue.Empty:
                    break
                deadline = time.monotonic() + self.reset_timeout_s
            self._thread.join(timeout=max(0.05,
                                          deadline - time.monotonic()))
            if self._thread.is_alive():
                logger.error(
                    "AsyncDataSetIterator.reset: producer thread still "
                    "alive after %.1fs drain+join — refusing to start a "
                    "second producer over the same underlying iterator",
                    self.reset_timeout_s)
                raise RuntimeError(
                    "AsyncDataSetIterator.reset: prefetch producer did not "
                    f"stop within {self.reset_timeout_s}s (stuck in "
                    "underlying.next()?); a second producer would race the "
                    "live one on the underlying iterator")
        self.underlying.reset()
        self._start()

    def batch(self):
        return self.underlying.batch()
