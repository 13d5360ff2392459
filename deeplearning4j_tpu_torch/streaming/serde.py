"""NDArray / DataSet wire serialization for the streaming layer.

Reference: ``dl4j-streaming/.../serde/RecordSerializer.java`` plus the
base64 NDArray encoding used by ``kafka/NDArrayPublisher.java`` /
``NDArrayConsumer.java`` (arrays travel as base64 strings inside JSON
messages).  Format here: little-endian float32 payload + explicit shape,
JSON-framed, so any consumer can decode without this library.

Consume-side validation: anything pulled off a topic that will reach a
``fit`` or ``output`` call can be decoded with ``validate=True`` (or via
``consume_dataset_json``), which rejects undecodable base64, dtype/shape
mismatches, payload-length lies, and NaN/Inf values with a typed
``BadRecordError`` instead of letting a poisoned record corrupt a whole
training window.  ``BadRecordError.reason`` carries a bounded-cardinality
classification (``bad_json`` / ``bad_envelope`` / ``bad_base64`` /
``bad_dtype`` / ``shape_mismatch`` / ``non_finite``) — the quarantine
path labels its metrics with it.

Port: a copy of ``deeplearning4j_tpu/streaming/serde.py`` with its imports
rewritten to the port.
"""

from __future__ import annotations

import base64
import binascii
import json
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet


class BadRecordError(ValueError):
    """A malformed stream record — the quarantine (dead-letter) trigger.

    ``reason`` is one of a small fixed set so it is safe as a metric
    label: ``bad_json``, ``bad_envelope``, ``bad_base64``, ``bad_dtype``,
    ``shape_mismatch``, ``non_finite``.
    """

    def __init__(self, message: str, reason: str = "bad_envelope"):
        super().__init__(message)
        self.reason = reason


def array_to_base64(arr: np.ndarray) -> Dict[str, Any]:
    """{'shape': [...], 'dtype': 'float32', 'data': <base64>} envelope."""
    arr = np.ascontiguousarray(arr, np.float32)
    return {
        "shape": list(arr.shape),
        "dtype": "float32",
        "data": base64.b64encode(arr.tobytes()).decode("ascii"),
    }


def base64_to_array(env: Dict[str, Any], validate: bool = False) -> np.ndarray:
    """Decode one NDArray envelope.  With ``validate`` every way a record
    can lie is checked BEFORE the array is returned: envelope keys, dtype,
    shape types, strict base64 (a bit-flipped payload character fails
    instead of being silently skipped), byte length vs shape, and value
    finiteness — each failure raises ``BadRecordError`` with a bounded
    ``reason``."""
    if not validate:
        raw = base64.b64decode(env["data"])
        return np.frombuffer(raw, np.float32).reshape(env["shape"]).copy()
    if not isinstance(env, dict) or "data" not in env or "shape" not in env:
        raise BadRecordError(
            "envelope must be a dict with 'shape' and 'data'",
            reason="bad_envelope")
    dtype = env.get("dtype", "float32")
    if dtype != "float32":
        raise BadRecordError(f"unsupported dtype {dtype!r} (want float32)",
                             reason="bad_dtype")
    shape = env["shape"]
    if (not isinstance(shape, (list, tuple))
            or not all(isinstance(d, int) and not isinstance(d, bool)
                       and d >= 0 for d in shape)):
        raise BadRecordError(f"bad shape {shape!r}", reason="shape_mismatch")
    try:
        # strict alphabet: a corrupted (bit-flipped) character raises here
        # instead of being skipped by the default lenient decoder
        raw = base64.b64decode(env["data"], validate=True)
    except (binascii.Error, TypeError, ValueError) as e:
        raise BadRecordError(f"undecodable base64 payload: {e}",
                             reason="bad_base64")
    expected = int(np.prod(shape, dtype=np.int64)) * 4
    if len(raw) != expected:
        raise BadRecordError(
            f"payload is {len(raw)} bytes but shape {list(shape)} needs "
            f"{expected}", reason="shape_mismatch")
    arr = np.frombuffer(raw, np.float32).reshape(shape).copy()
    if not np.isfinite(arr).all():
        raise BadRecordError("payload contains NaN/Inf values",
                             reason="non_finite")
    return arr


def dataset_to_json(ds: DataSet, meta: Optional[Dict[str, Any]] = None) -> str:
    """Serialize a DataSet message.  ``meta`` rides along verbatim under
    a ``"meta"`` key (e.g. ``{"ts": time.time()}`` — the publish
    timestamp the online pipeline's model-freshness measurement reads);
    consumers that don't know about it ignore it."""
    obj: Dict[str, Any] = {"features": array_to_base64(ds.features),
                           "labels": array_to_base64(ds.labels)}
    if ds.features_mask is not None:
        obj["features_mask"] = array_to_base64(ds.features_mask)
    if ds.labels_mask is not None:
        obj["labels_mask"] = array_to_base64(ds.labels_mask)
    if meta:
        obj["meta"] = meta
    return json.dumps(obj)


def dataset_from_json(text: str, validate: bool = False) -> DataSet:
    ds, _meta = _decode_dataset(text, validate)
    return ds


def consume_dataset_json(text: str) -> Tuple[DataSet, Dict[str, Any]]:
    """The validating consume path: decode one DataSet message, rejecting
    anything malformed with ``BadRecordError`` (see module docstring).
    Returns ``(dataset, meta)`` where ``meta`` is the publisher's
    metadata dict (empty when absent)."""
    return _decode_dataset(text, validate=True)


def _decode_dataset(text: str,
                    validate: bool) -> Tuple[DataSet, Dict[str, Any]]:
    try:
        obj = json.loads(text)
    except (ValueError, TypeError) as e:
        raise BadRecordError(f"record is not JSON: {e}", reason="bad_json")
    if validate and (not isinstance(obj, dict) or "features" not in obj
                     or "labels" not in obj):
        raise BadRecordError(
            "DataSet message must be a dict with 'features' and 'labels'",
            reason="bad_envelope")
    feats = base64_to_array(obj["features"], validate=validate)
    labels = base64_to_array(obj["labels"], validate=validate)
    if validate:
        if feats.ndim == 0 or labels.ndim == 0:
            # a 0-d array has no row axis — len() on it would raise an
            # UNTYPED error downstream instead of quarantining
            raise BadRecordError(
                "scalar (0-d) features/labels have no batch dimension",
                reason="shape_mismatch")
        if len(labels) and len(feats) and len(labels) != len(feats):
            raise BadRecordError(
                f"features have {len(feats)} rows but labels {len(labels)}",
                reason="shape_mismatch")
    fmask = (base64_to_array(obj["features_mask"], validate=validate)
             if "features_mask" in obj else None)
    lmask = (base64_to_array(obj["labels_mask"], validate=validate)
             if "labels_mask" in obj else None)
    if validate:
        for name, mask in (("features_mask", fmask), ("labels_mask", lmask)):
            if mask is None:
                continue
            # a shape-lying mask would crash fit mid-window — same
            # quarantine contract as the features/labels themselves
            if mask.ndim == 0 or len(mask) != len(feats):
                raise BadRecordError(
                    f"{name} has "
                    f"{'no batch dimension' if mask.ndim == 0 else f'{len(mask)} rows'}"
                    f" but features have {len(feats)}",
                    reason="shape_mismatch")
    meta = obj.get("meta") if isinstance(obj, dict) else None
    if not isinstance(meta, dict):
        meta = {}
    if validate:
        ts = meta.get("ts")
        if ts is not None and (not isinstance(ts, (int, float))
                               or isinstance(ts, bool)
                               or not math.isfinite(ts)):
            raise BadRecordError(f"bad meta.ts {ts!r}", reason="bad_envelope")
    return DataSet(feats, labels, fmask, lmask), meta


def record_to_dataset(record: Sequence[float], label_index: Optional[int],
                      num_classes: Optional[int] = None,
                      regression: bool = False) -> DataSet:
    """Single record -> 1-example DataSet (the record-conversion step of
    ``conversion/dataset/*`` in the reference streaming module)."""
    vals = np.asarray(list(record), np.float32)
    if label_index is None:
        return DataSet(vals[None, :], np.zeros((1, 0), np.float32))
    feat = np.concatenate([vals[:label_index], vals[label_index + 1:]])
    if regression:
        lab = vals[label_index:label_index + 1]
    else:
        if not num_classes:
            raise ValueError("num_classes is required for classification "
                             "records (regression=False)")
        c = int(vals[label_index])
        if not 0 <= c < num_classes:
            raise ValueError(f"label value {c} outside [0, {num_classes})")
        lab = np.zeros(num_classes, np.float32)
        lab[c] = 1.0
    return DataSet(feat[None, :], lab[None, :])
