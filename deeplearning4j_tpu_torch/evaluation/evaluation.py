"""Classification evaluation — accuracy/precision/recall/F1, top-N, confusion
matrix, time-series masking, per-example metadata attribution.

Reference: ``eval/Evaluation.java:43,160-374`` (eval, topN :290-300,
evalTimeSeries :314-346), ``eval/ConfusionMatrix.java``.  The counting is
vectorised: one numpy pass builds the [C, C] confusion matrix via a
scatter-add; derived metrics are tiny host math.

Port: a copy of ``deeplearning4j_tpu/evaluation/evaluation.py``; it
takes host arrays (the facades' ``evaluate`` copies each output to the
host once).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


class ConfusionMatrix:
    def __init__(self, n_classes: int):
        self.n = n_classes
        self.matrix = np.zeros((n_classes, n_classes), np.int64)

    def add(self, actual: int, predicted: int, count: int = 1):
        self.matrix[actual, predicted] += count

    def add_matrix(self, m: np.ndarray):
        self.matrix += m.astype(np.int64)

    def count(self, actual: int, predicted: int) -> int:
        return int(self.matrix[actual, predicted])

    def actual_total(self, c: int) -> int:
        return int(self.matrix[c].sum())

    def predicted_total(self, c: int) -> int:
        return int(self.matrix[:, c].sum())

    def __str__(self):
        return str(self.matrix)


class Evaluation:
    def __init__(self, n_classes: Optional[int] = None,
                 labels: Optional[Sequence[str]] = None, top_n: int = 1):
        self.label_names = list(labels) if labels else None
        if n_classes is None and labels:
            n_classes = len(labels)
        self.n_classes = n_classes
        self.top_n = top_n
        self.confusion: Optional[ConfusionMatrix] = None
        self.top_n_correct = 0
        self.top_n_total = 0
        # per-example metadata attribution (reference eval/meta/)
        self.prediction_errors: List = []

    def _ensure(self, c: int):
        if self.confusion is None:
            self.n_classes = self.n_classes or c
            self.confusion = ConfusionMatrix(self.n_classes)

    def eval(self, labels, predictions, mask=None, metadata=None):
        """labels/predictions: [batch, C] one-hot/probabilities, or
        [batch, time, C] with optional [batch, time] mask (reference
        evalTimeSeries)."""
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        if labels.ndim == 3:
            if mask is not None:
                mask = np.asarray(mask).reshape(-1).astype(bool)
                labels = labels.reshape(-1, labels.shape[-1])[mask]
                predictions = predictions.reshape(-1, predictions.shape[-1])[mask]
            else:
                labels = labels.reshape(-1, labels.shape[-1])
                predictions = predictions.reshape(-1, predictions.shape[-1])
        C = labels.shape[-1]
        self._ensure(C)
        actual = labels.argmax(-1)
        pred = predictions.argmax(-1)
        # one-pass confusion matrix (scatter-add)
        m = np.zeros((C, C), np.int64)
        np.add.at(m, (actual, pred), 1)
        self.confusion.add_matrix(m)
        # top-N (reference :290-300)
        if self.top_n > 1:
            order = np.argsort(-predictions, axis=-1)[:, : self.top_n]
            self.top_n_correct += int((order == actual[:, None]).any(-1).sum())
        else:
            self.top_n_correct += int((pred == actual).sum())
        self.top_n_total += len(actual)
        if metadata is not None:
            for i, (a, p) in enumerate(zip(actual, pred)):
                if a != p:
                    self.prediction_errors.append((metadata[i], int(a), int(p)))

    # ---- derived metrics -------------------------------------------------
    def _tp(self, c):
        return self.confusion.count(c, c)

    def accuracy(self) -> float:
        m = self.confusion.matrix
        total = m.sum()
        return float(np.trace(m) / total) if total else 0.0

    def top_n_accuracy(self) -> float:
        return self.top_n_correct / self.top_n_total if self.top_n_total else 0.0

    def precision(self, c: Optional[int] = None) -> float:
        if c is not None:
            pt = self.confusion.predicted_total(c)
            return self._tp(c) / pt if pt else 0.0
        vals = [self.precision(i) for i in range(self.n_classes)
                if self.confusion.actual_total(i) > 0]
        return float(np.mean(vals)) if vals else 0.0

    def recall(self, c: Optional[int] = None) -> float:
        if c is not None:
            at = self.confusion.actual_total(c)
            return self._tp(c) / at if at else 0.0
        vals = [self.recall(i) for i in range(self.n_classes)
                if self.confusion.actual_total(i) > 0]
        return float(np.mean(vals)) if vals else 0.0

    def f1(self, c: Optional[int] = None) -> float:
        p, r = self.precision(c), self.recall(c)
        return 2 * p * r / (p + r) if (p + r) else 0.0

    def false_positive_rate(self, c: int) -> float:
        fp = self.confusion.predicted_total(c) - self._tp(c)
        neg = self.confusion.matrix.sum() - self.confusion.actual_total(c)
        return fp / neg if neg else 0.0

    def stats(self) -> str:
        lines = ["==================== Evaluation ===================="]
        lines.append(f" Examples:  {self.confusion.matrix.sum()}")
        lines.append(f" Accuracy:  {self.accuracy():.4f}")
        if self.top_n > 1:
            lines.append(f" Top-{self.top_n} Accuracy: {self.top_n_accuracy():.4f}")
        lines.append(f" Precision: {self.precision():.4f}")
        lines.append(f" Recall:    {self.recall():.4f}")
        lines.append(f" F1 Score:  {self.f1():.4f}")
        lines.append("Confusion matrix (rows=actual, cols=predicted):")
        lines.append(str(self.confusion))
        return "\n".join(lines)
