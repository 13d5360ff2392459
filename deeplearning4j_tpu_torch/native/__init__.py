"""Native runtime core: numpy-facing wrappers over the port's C++ library
(``native/loader.py`` builds it with g++ at first use).

Counterpart of ``deeplearning4j_tpu/native``.  Every entry point runs the
native code; its plain Python version (the same results: the same float32
values, the same deterministic xorshift64* shuffle, the same file bytes)
runs only when the caller passes ``force_python=True``, as the tests do
to hold the two against each other.  A failed build raises (``loader``),
and so does input the native parser refuses (a non-numeric or ragged CSV
field, a truncated IDX file): nothing re-parses quietly.  Reference roles:
DataVec record parsing, MnistManager IDX decoding
(``deeplearning4j-core/.../datasets/mnist/MnistManager.java``), the
AsyncDataSetIterator producer thread
(``deeplearning4j-nn/.../iterator/AsyncDataSetIterator.java:36-76``), and
the batch-and-export DataSet files
(``spark/data/BatchAndExportDataSetsFunction.java``).
"""

from __future__ import annotations

import ctypes
import struct
from typing import Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.native.loader import build, lib

__all__ = [
    "build", "lib", "csv_to_matrix", "parse_idx_images", "parse_idx_labels",
    "gather_rows", "Batcher", "write_dataset", "read_dataset",
    "dataset_header",
]

_MAGIC = 0x44344A54      # 'D4JT'


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


# ------------------------------------------------------------------- CSV
def _csv_plain(data: bytes, delimiter: str, skip_lines: int) -> np.ndarray:
    lines = [ln for ln in data.decode("utf-8").splitlines()[skip_lines:]
             if ln.strip()]
    if not lines:
        return np.zeros((0, 0), np.float32)
    rows = [[float(f) for f in ln.split(delimiter)] for ln in lines]
    if len({len(r) for r in rows}) != 1:
        raise ValueError("CSV rows have different numbers of fields")
    return np.asarray(rows, np.float32)


def csv_to_matrix(data: bytes, delimiter: str = ",", skip_lines: int = 0,
                  force_python: bool = False) -> np.ndarray:
    """Parse an all-numeric CSV byte buffer into a float32 matrix (blank
    lines skipped); a non-numeric or ragged field raises ``ValueError``."""
    if force_python:
        return _csv_plain(data, delimiter, skip_lines)
    L = lib()
    n_cols = ctypes.c_long(0)
    rows = L.csv_dims(data, len(data), delimiter.encode(), skip_lines,
                      ctypes.byref(n_cols))
    if rows <= 0 or n_cols.value <= 0:
        return np.zeros((0, 0), np.float32)
    out = np.empty((rows, n_cols.value), np.float32)
    got = L.csv_parse(data, len(data), delimiter.encode(), skip_lines,
                      _fp(out), rows, n_cols.value, 0)
    if got != rows:
        raise ValueError(f"CSV: a non-numeric or ragged field among {rows} "
                         f"rows of {n_cols.value} columns")
    return out


# ------------------------------------------------------------------- IDX
def _idx_images_plain(data: bytes, n: int, rows: int, cols: int) -> np.ndarray:
    raw = np.frombuffer(data, np.uint8, count=n * rows * cols, offset=16)
    return (raw.astype(np.float32) / 255.0).reshape(n, rows * cols)


def parse_idx_images(data: bytes, force_python: bool = False) -> np.ndarray:
    """IDX3 ubyte images -> float32 [n, rows*cols] normalized to [0,1]."""
    magic, n, rows, cols = struct.unpack(">IIII", data[:16])
    if magic != 0x803:
        raise ValueError(f"bad IDX3 magic {magic:#x}")
    if force_python:
        return _idx_images_plain(data, n, rows, cols)
    out = np.empty((n, rows * cols), np.float32)
    got = lib().idx_images(data, len(data), _fp(out), n, 0)
    if got != n:
        raise ValueError(f"IDX3: {len(data)} bytes hold fewer than the "
                         f"{n} images of {rows}x{cols} the header says")
    return out


def _idx_labels_plain(data: bytes, n: int, n_classes: int) -> np.ndarray:
    raw = np.frombuffer(data, np.uint8, count=n, offset=8)
    out = np.zeros((n, n_classes), np.float32)
    valid = raw < n_classes  # out-of-range labels -> all-zero row (native parity)
    out[np.nonzero(valid)[0], raw[valid]] = 1.0
    return out


def parse_idx_labels(data: bytes, n_classes: int = 10,
                     force_python: bool = False) -> np.ndarray:
    """IDX1 ubyte labels -> one-hot float32 [n, n_classes]."""
    magic, n = struct.unpack(">II", data[:8])
    if magic != 0x801:
        raise ValueError(f"bad IDX1 magic {magic:#x}")
    if force_python:
        return _idx_labels_plain(data, n, n_classes)
    out = np.empty((n, n_classes), np.float32)
    got = lib().idx_labels(data, len(data), _fp(out), n_classes, n)
    if got != n:
        raise ValueError(f"IDX1: {len(data)} bytes hold fewer than the {n} "
                         f"labels the header says")
    return out


# ---------------------------------------------------------------- gather
def gather_rows(src: np.ndarray, idx: np.ndarray,
                force_python: bool = False) -> np.ndarray:
    """Gather rows of a 2-D float32 array (multithreaded in native)."""
    src = np.ascontiguousarray(src, np.float32)
    idx64 = np.ascontiguousarray(idx, np.int64)
    if len(idx64) and (idx64.min() < 0 or idx64.max() >= len(src)):
        raise IndexError("gather index out of range")
    if force_python:
        return src[idx64]
    out = np.empty((len(idx64), src.shape[1]), np.float32)
    lib().gather_rows_f32(_fp(src), src.shape[1],
                          idx64.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                          len(idx64), _fp(out), 0)
    return out


# --------------------------------------------------------------- batcher
class Batcher:
    """Shuffled minibatch pipeline over in-memory arrays.

    Native: a C++ producer thread, a reusable buffer pool and a bounded
    queue.  ``force_python=True``: a synchronous numpy gather with the
    same deterministic xorshift64* shuffle, so the batch order matches
    bit for bit.
    """

    def __init__(self, features: np.ndarray, labels: Optional[np.ndarray],
                 batch_size: int, shuffle: bool = True, seed: int = 1,
                 queue_cap: int = 2, drop_last: bool = False,
                 force_python: bool = False):
        if labels is not None and len(labels) != len(features):
            # the producer gathers label rows by the features' permutation
            raise ValueError(f"{len(labels)} label rows for "
                             f"{len(features)} feature rows")
        self._f = np.ascontiguousarray(
            features.reshape(len(features), -1), np.float32)
        self._l = (None if labels is None else
                   np.ascontiguousarray(labels.reshape(len(labels), -1),
                                        np.float32))
        self._fshape = features.shape[1:]
        self._lshape = None if labels is None else labels.shape[1:]
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._n = len(features)
        self._handle = None
        self._L = None if force_python else lib()
        if self._L is not None:
            # gather single-threaded: the producer thread is already off the
            # consumer's critical path, and per-batch thread spawn would cost
            # more than the copy for typical minibatch sizes
            self._handle = self._L.batcher_create(
                _fp(self._f), None if self._l is None else _fp(self._l),
                self._n, self._f.shape[1],
                0 if self._l is None else self._l.shape[1],
                batch_size, int(shuffle), seed, 1, queue_cap, int(drop_last))
        else:
            self._py_reset(seed)

    # deterministic xorshift64* Fisher-Yates matching the C++ implementation
    def _py_perm(self, seed: int) -> np.ndarray:
        perm = np.arange(self._n, dtype=np.int64)
        if not self.shuffle:
            return perm
        x = seed if seed else 0x9E3779B97F4A7C15
        mask = (1 << 64) - 1
        for i in range(self._n - 1, 0, -1):
            x ^= x >> 12; x = (x ^ (x << 25)) & mask; x ^= x >> 27
            r = (x * 0x2545F4914F6CDD1D) & mask
            j = r % (i + 1)
            perm[i], perm[j] = perm[j], perm[i]
        return perm

    def _py_reset(self, seed: int):
        self._perm = self._py_perm(seed)
        self._pos = 0

    def next(self) -> Optional[Tuple[np.ndarray, Optional[np.ndarray], int]]:
        """(features, labels, n_valid) for the next batch, or None at epoch
        end.  Short final batches are zero-padded to batch_size."""
        bs = self.batch_size
        if self._handle is not None:
            feat = np.empty((bs, self._f.shape[1]), np.float32)
            lab = (None if self._l is None else
                   np.empty((bs, self._l.shape[1]), np.float32))
            n_valid = ctypes.c_long(0)
            ok = self._L.batcher_next(
                self._handle, _fp(feat), None if lab is None else _fp(lab),
                ctypes.byref(n_valid))
            if not ok:
                return None
            nv = n_valid.value
        else:
            if self._pos >= self._n:
                return None
            idx = self._perm[self._pos:self._pos + bs]
            nv = len(idx)
            if nv < bs and self.drop_last:
                self._pos = self._n
                return None
            self._pos += bs
            feat = np.zeros((bs, self._f.shape[1]), np.float32)
            feat[:nv] = self._f[idx]
            lab = None
            if self._l is not None:
                lab = np.zeros((bs, self._l.shape[1]), np.float32)
                lab[:nv] = self._l[idx]
        feat = feat.reshape((bs,) + self._fshape)
        if lab is not None:
            lab = lab.reshape((bs,) + self._lshape)
        return feat, lab, nv

    def reset(self, seed: int = 1):
        if self._handle is not None:
            self._L.batcher_reset(self._handle, seed)
        else:
            self._py_reset(seed)

    def close(self):
        if self._handle is not None:
            self._L.batcher_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


# ------------------------------------------------------ DataSet container
def _flat(features: np.ndarray, labels: Optional[np.ndarray]):
    f = np.ascontiguousarray(features.reshape(len(features), -1), np.float32)
    l = (np.zeros((len(f), 0), np.float32) if labels is None else
         np.ascontiguousarray(labels.reshape(len(labels), -1), np.float32))
    return f, l


def write_dataset(path, features: np.ndarray,
                  labels: Optional[np.ndarray] = None,
                  force_python: bool = False) -> None:
    """Write the binary DataSet container: magic 'D4JT', u32 version 1,
    i64 n, feature and label elements a row, then the float32 payloads."""
    f, l = _flat(features, labels)
    if force_python:
        with open(path, "wb") as fh:
            fh.write(struct.pack("<IIqqq", _MAGIC, 1, len(f), f.shape[1],
                                 l.shape[1]))
            fh.write(f.tobytes())
            fh.write(l.tobytes())
        return
    if lib().dataset_write(str(path).encode(), _fp(f), _fp(l), len(f),
                           f.shape[1], l.shape[1]) != 0:
        raise OSError(f"cannot write the DataSet container {path}")


def dataset_header(path) -> Tuple[int, int, int]:
    """(n, feat_elems, lab_elems) from a DataSet container's 32-byte header."""
    with open(path, "rb") as fh:
        header = fh.read(32)
    if len(header) < 32:
        raise ValueError(f"truncated dataset header in {path}")
    magic, _ver, n, fe, le = struct.unpack("<IIqqq", header)
    if magic != _MAGIC:
        raise ValueError(f"bad dataset magic {magic:#x} in {path}")
    return n, fe, le


def read_dataset(path, force_python: bool = False
                 ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Read the binary DataSet container back: (features [n, fe], labels
    [n, le] or None when le is 0)."""
    n, fe, le = dataset_header(path)
    if force_python:
        with open(path, "rb") as fh:
            fh.seek(32)
            feat = np.frombuffer(fh.read(4 * n * fe), np.float32)
            labs = np.frombuffer(fh.read(4 * n * le), np.float32)
        if feat.size != n * fe or labs.size != n * le:
            raise ValueError(f"truncated dataset payload in {path}")
        return (feat.reshape(n, fe).copy(),
                labs.reshape(n, le).copy() if le else None)
    feat = np.empty((n, fe), np.float32)
    labs = np.empty((n, le), np.float32)
    if lib().dataset_read(str(path).encode(), _fp(feat), _fp(labs)) != 0:
        raise ValueError(f"truncated or unreadable DataSet container {path}")
    return feat, (labs if le else None)
