"""Losses — counterpart of ``deeplearning4j_tpu/nn/losses.py``.

Every loss takes (labels, preoutput, activation name, mask) and returns
per-example scores ([batch] or [batch, time]); ``score`` reduces them.
Gradients come from autograd over the score.  labels/preoutput are
[batch, n_out] or [batch, time, n_out]; a mask is [batch] or
[batch, time].
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from deeplearning4j_tpu_torch.nn import activations

_EPS = 1e-8


def _activate(preout, activation: str):
    return activations.get(activation)(preout)


def _apply_mask(per_example, mask):
    if mask is None:
        return per_example
    return per_example * mask


def mse(labels, preout, activation="identity", mask=None):
    out = _activate(preout, activation)
    return _apply_mask(((out - labels) ** 2).sum(dim=-1), mask)


def l1(labels, preout, activation="identity", mask=None):
    out = _activate(preout, activation)
    return _apply_mask((out - labels).abs().sum(dim=-1), mask)


def l2(labels, preout, activation="identity", mask=None):
    # reference L2 = sum of squared errors (no 1/n)
    return mse(labels, preout, activation, mask)


def xent(labels, preout, activation="sigmoid", mask=None):
    """Binary cross-entropy (reference XENT)."""
    out = _activate(preout, activation).clamp(_EPS, 1.0 - _EPS)
    per = -(labels * torch.log(out)
            + (1 - labels) * torch.log(1 - out)).sum(dim=-1)
    return _apply_mask(per, mask)


def mcxent(labels, preout, activation="softmax", mask=None):
    """Multi-class cross-entropy; with softmax through ``log_softmax``."""
    if activation == "softmax":
        per = -(labels * torch.log_softmax(preout, dim=-1)).sum(dim=-1)
    else:
        out = _activate(preout, activation).clamp(_EPS, 1.0)
        per = -(labels * torch.log(out)).sum(dim=-1)
    return _apply_mask(per, mask)


def negativeloglikelihood(labels, preout, activation="softmax", mask=None):
    return mcxent(labels, preout, activation, mask)


def kl_divergence(labels, preout, activation="softmax", mask=None):
    out = _activate(preout, activation).clamp(_EPS, 1.0)
    lab = labels.clamp(_EPS, 1.0)
    per = (lab * (torch.log(lab) - torch.log(out))).sum(dim=-1)
    return _apply_mask(per, mask)


def poisson(labels, preout, activation="identity", mask=None):
    out = _activate(preout, activation).clamp(min=_EPS)
    return _apply_mask((out - labels * torch.log(out)).sum(dim=-1), mask)


def cosine_proximity(labels, preout, activation="identity", mask=None):
    out = _activate(preout, activation)
    num = (labels * out).sum(dim=-1)
    den = (torch.linalg.vector_norm(labels, dim=-1)
           * torch.linalg.vector_norm(out, dim=-1) + _EPS)
    return _apply_mask(-num / den, mask)


def hinge(labels, preout, activation="identity", mask=None):
    out = _activate(preout, activation)
    return _apply_mask(torch.clamp(1.0 - labels * out, min=0.0).sum(dim=-1),
                       mask)


def squared_hinge(labels, preout, activation="identity", mask=None):
    out = _activate(preout, activation)
    per = (torch.clamp(1.0 - labels * out, min=0.0) ** 2).sum(dim=-1)
    return _apply_mask(per, mask)


_REGISTRY: Dict[str, Callable] = {
    "mse": mse,
    "l1": l1,
    "l2": l2,
    "xent": xent,
    "mcxent": mcxent,
    "negativeloglikelihood": negativeloglikelihood,
    "kl_divergence": kl_divergence,
    "reconstruction_crossentropy": xent,
    "poisson": poisson,
    "cosine_proximity": cosine_proximity,
    "hinge": hinge,
    "squared_hinge": squared_hinge,
}


def get(name: str) -> Callable:
    try:
        return _REGISTRY[name.lower()]
    except KeyError:
        raise ValueError(
            f"Unknown loss '{name}'. Known: {sorted(_REGISTRY)}") from None


def score(name, labels, preout, activation, mask=None, mean=True):
    """Per-example scores summed over time, then the mean over the batch
    — or, with a mask, the sum over the number of unmasked steps."""
    per = get(name)(labels, preout, activation, mask)
    if per.ndim > 1:
        per = per.sum(dim=tuple(range(1, per.ndim)))
    if not mean:
        return per
    if mask is not None:
        return per.sum() / torch.clamp(mask.sum(), min=1.0)
    return per.mean()
