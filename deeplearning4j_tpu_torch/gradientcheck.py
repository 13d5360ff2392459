"""Numerical gradient checking — counterpart of ``deeplearning4j_tpu/gradientcheck.py``.

Central differences of the network's loss against its autograd gradient,
in float64 on a float64 copy of the parameters (reference
``GradientCheckUtil.java``).  It runs through the built-in paths, with
the helpers disabled: the kernels do not take float64, and float64 stays
off the helpers, as in the reference.  Inputs are small, so the perturbed losses are
evaluated one pair at a time.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.helpers import helpers_disabled
from deeplearning4j_tpu_torch.models.sequential import (
    _tree_like, cast_tree, tree_leaves,
)


def check_gradients(net, x, y, *, epsilon: float = 1e-6,
                    max_rel_error: float = 1e-3, min_abs_error: float = 1e-8,
                    fmask=None, lmask=None,
                    max_params_per_array: Optional[int] = 64, seed: int = 0,
                    print_results: bool = False) -> bool:
    """Check d(loss)/d(params) of ``net`` (a ``MultiLayerNetwork``) at
    (x, y) on up to ``max_params_per_array`` randomly chosen entries of
    every parameter tensor (None = all)."""
    params = cast_tree(net.params, torch.float64)
    leaves = [p.detach().clone() for p in tree_leaves(params)]
    tree = _tree_like(params, leaves)
    x = torch.as_tensor(x, device=net.device)
    if x.is_floating_point():
        x = x.double()
    y = torch.as_tensor(y, dtype=torch.float64, device=net.device)
    fm = None if fmask is None else torch.as_tensor(
        fmask, dtype=torch.float64, device=net.device)
    lm = None if lmask is None else torch.as_tensor(
        lmask, dtype=torch.float64, device=net.device)

    def loss():
        with helpers_disabled():
            return net._loss_fn(tree, x, y, None, fm, lm, train=False)[0]

    for p in leaves:
        p.requires_grad_(True)
    analytic = torch.autograd.grad(loss(), leaves, allow_unused=True)
    for p in leaves:
        p.requires_grad_(False)

    rng = np.random.RandomState(seed)
    n_ok, failures = 0, []
    with torch.no_grad():
        for li, (p, g) in enumerate(zip(leaves, analytic)):
            flat = p.view(-1)
            ana = (np.zeros(flat.numel()) if g is None
                   else g.reshape(-1).cpu().numpy())
            idxs = np.arange(flat.numel())
            if max_params_per_array is not None and \
                    flat.numel() > max_params_per_array:
                idxs = rng.choice(flat.numel(), max_params_per_array,
                                  replace=False)
            for i in sorted(idxs):
                orig = float(flat[i])
                flat[i] = orig + epsilon
                up = float(loss())
                flat[i] = orig - epsilon
                down = float(loss())
                flat[i] = orig
                num = (up - down) / (2 * epsilon)
                a = float(ana[i])
                denom = max(abs(num), abs(a))
                rel = abs(num - a) / denom if denom > 0 else 0.0
                if rel < max_rel_error or abs(num - a) < min_abs_error:
                    n_ok += 1
                else:
                    failures.append((li, int(i), a, num, rel))
    if print_results or failures:
        print(f"GradientCheck: {n_ok} passed, {len(failures)} failed")
        for li, i, a, num, rel in failures[:20]:
            print(f"  leaf {li} idx {i}: analytic={a:.8g} numeric={num:.8g} "
                  f"rel={rel:.4g}")
    return not failures
