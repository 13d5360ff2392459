"""Regression evaluation — MSE/MAE/RMSE/RSE/R^2 per output column.

Reference: ``eval/RegressionEvaluation.java`` (streaming accumulation of
per-column stats so arbitrarily many batches fold in).

Port: a copy of ``deeplearning4j_tpu/evaluation/regression.py``."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


class RegressionEvaluation:
    def __init__(self, n_columns: Optional[int] = None,
                 column_names: Optional[Sequence[str]] = None):
        self.column_names = list(column_names) if column_names else None
        if n_columns is None and column_names:
            n_columns = len(column_names)
        self.n = n_columns
        self._initialized = False

    def _ensure(self, c):
        if not self._initialized:
            self.n = self.n or c
            z = lambda: np.zeros(self.n, np.float64)
            self.sum_sq_err = z()
            self.sum_abs_err = z()
            self.sum_label = z()
            self.sum_label_sq = z()
            self.sum_pred = z()
            self.sum_pred_sq = z()
            self.sum_label_pred = z()
            self.count = 0
            self._initialized = True

    def eval(self, labels, predictions, mask=None):
        labels = np.asarray(labels, np.float64)
        predictions = np.asarray(predictions, np.float64)
        if labels.ndim == 3:
            if mask is not None:
                m = np.asarray(mask).reshape(-1).astype(bool)
                labels = labels.reshape(-1, labels.shape[-1])[m]
                predictions = predictions.reshape(-1, predictions.shape[-1])[m]
            else:
                labels = labels.reshape(-1, labels.shape[-1])
                predictions = predictions.reshape(-1, predictions.shape[-1])
        self._ensure(labels.shape[-1])
        err = predictions - labels
        self.sum_sq_err += (err ** 2).sum(0)
        self.sum_abs_err += np.abs(err).sum(0)
        self.sum_label += labels.sum(0)
        self.sum_label_sq += (labels ** 2).sum(0)
        self.sum_pred += predictions.sum(0)
        self.sum_pred_sq += (predictions ** 2).sum(0)
        self.sum_label_pred += (labels * predictions).sum(0)
        self.count += labels.shape[0]

    def mean_squared_error(self, c: int) -> float:
        return float(self.sum_sq_err[c] / self.count)

    def mean_absolute_error(self, c: int) -> float:
        return float(self.sum_abs_err[c] / self.count)

    def root_mean_squared_error(self, c: int) -> float:
        return float(np.sqrt(self.sum_sq_err[c] / self.count))

    def relative_squared_error(self, c: int) -> float:
        mean_label = self.sum_label[c] / self.count
        tss = self.sum_label_sq[c] - self.count * mean_label ** 2
        return float(self.sum_sq_err[c] / tss) if tss else float("inf")

    def correlation_r2(self, c: int) -> float:
        n = self.count
        num = n * self.sum_label_pred[c] - self.sum_label[c] * self.sum_pred[c]
        d1 = n * self.sum_label_sq[c] - self.sum_label[c] ** 2
        d2 = n * self.sum_pred_sq[c] - self.sum_pred[c] ** 2
        den = np.sqrt(d1 * d2)
        return float(num / den) if den else 0.0

    def average_mean_squared_error(self) -> float:
        return float(np.mean(self.sum_sq_err / self.count))

    def stats(self) -> str:
        lines = ["================ RegressionEvaluation ================"]
        for c in range(self.n):
            name = self.column_names[c] if self.column_names else f"col{c}"
            lines.append(
                f" {name}: MSE={self.mean_squared_error(c):.6f} "
                f"MAE={self.mean_absolute_error(c):.6f} "
                f"RMSE={self.root_mean_squared_error(c):.6f} "
                f"R2={self.correlation_r2(c):.4f}"
            )
        return "\n".join(lines)
