"""The port's fused dropout + residual + LayerNorm
(``deeplearning4j_tpu_torch/helpers/fused_epilogue.py``) against the JAX
package's ``dropout_residual_norm`` (its Pallas kernel in interpret mode
on the CPU, its custom VJP ``_drn_bwd``), with the same explicit mask.

Shapes are off the TPU tiling on purpose (rows = 10, C = 96).
Tolerance: ``atol=1e-5`` on the forward and on the grads of h, res, γ
and β (float32, different summation orders)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.helpers.fused_epilogue import (
    dropout_residual_norm as jdrn,
)
from deeplearning4j_tpu_torch.helpers import fused_epilogue as fe

ATOL = 1e-5
ROWS, C = 10, 96


def _data(seed, with_res):
    rng = np.random.default_rng(seed)
    h = (rng.standard_normal((ROWS, C)) * 2 + 0.5).astype(np.float32)
    res = rng.standard_normal((ROWS, C)).astype(np.float32)
    gamma = (rng.standard_normal(C) + 1).astype(np.float32)
    beta = rng.standard_normal(C).astype(np.float32)
    mask = rng.random((ROWS, C)) < 0.75
    g = rng.standard_normal((ROWS, C)).astype(np.float32)
    return h, (res if with_res else None), gamma, beta, mask, g


@pytest.mark.parametrize("with_mask", [True, False], ids=["mask", "nomask"])
@pytest.mark.parametrize("with_res", [True, False], ids=["res", "prologue"])
def test_matches_jax(with_res, with_mask):
    h, res, gamma, beta, mask, g = _data(7, with_res)
    mask = mask if with_mask else None
    rate = 0.25 if with_mask else 0.0
    args = [h, gamma, beta] + ([res] if with_res else [])

    def jfn(h, gamma, beta, *res):
        return jdrn(h, res[0] if res else None, gamma, beta, eps=1e-5,
                    rate=rate, mask=None if mask is None
                    else jnp.asarray(mask))

    jy, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in args))
    jgrads = vjp(jnp.asarray(g))

    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    y = fe.dropout_residual_norm(
        targs[0], targs[3] if with_res else None, targs[1], targs[2],
        eps=1e-5, rate=rate,
        mask=None if mask is None else torch.from_numpy(mask))
    grads = torch.autograd.grad(y, targs, torch.from_numpy(g))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), atol=ATOL)
    for got, want in zip(grads, jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_train_draws_the_mask_from_the_generator():
    """``train`` with ``rate > 0`` and no mask draws one from the
    generator: the same generator gives the same output, and the dropped
    elements are exactly zero."""
    h, _, gamma, beta, _, _ = _data(8, False)
    args = [torch.from_numpy(a) for a in (h, gamma, beta)]
    gen = torch.Generator().manual_seed(1234)
    a = fe.dropout_residual_norm(args[0], None, args[1], args[2], rate=0.5,
                                 generator=gen, train=True)
    b = fe.dropout_residual_norm(args[0], None, args[1], args[2], rate=0.5,
                                 generator=gen, train=True)
    assert torch.equal(a, b)
    dropped = (a == 0).float().mean().item()
    assert 0.3 < dropped < 0.7
    with pytest.raises(ValueError, match="generator"):
        fe.dropout_residual_norm(args[0], None, args[1], args[2], rate=0.5,
                                 train=True)


def test_cpu_tensors_take_the_plain_version_and_are_counted():
    h, _, gamma, beta, _, _ = _data(9, False)
    before = (fe.counts.plain_calls, fe.counts.launches)
    fe.dropout_residual_norm(*(torch.from_numpy(a) for a in (h,)), None,
                             torch.from_numpy(gamma), torch.from_numpy(beta))
    assert (fe.counts.plain_calls, fe.counts.launches) == (before[0] + 1,
                                                           before[1])


def test_supports():
    assert fe.supports(torch.zeros(3, 96))
    assert fe.supports(torch.zeros(3, 1024, dtype=torch.bfloat16))
    assert not fe.supports(torch.zeros(3, 96, dtype=torch.float64))
    assert not fe.supports(torch.zeros(3, 30))           # not whole vectors
    assert not fe.supports(torch.zeros(3, 8196))          # past 8192 in f32
