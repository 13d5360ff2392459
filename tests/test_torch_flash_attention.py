"""Flash attention in the port (``deeplearning4j_tpu_torch/helpers/flash_attention.py``)
against the JAX package's Pallas kernel, run in interpret mode on the CPU
as its own tests run it.

On CPU tensors the port's ``flash_attention`` runs its plain versions
through the same ``autograd.Function`` the CUDA kernels sit behind, so
these tests hold the port's forward, its saved lse and its backward.

Tolerances: O and lse to ``atol=rtol=2e-5``, gradients scaled by their
largest magnitude to ``atol=2e-5`` — those of
``tests/test_flash_attention.py`` for the JAX kernel (float32, different
summation orders)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.helpers import flash_attention as jfa
from deeplearning4j_tpu_torch.helpers import flash_attention as fa
from deeplearning4j_tpu_torch.nn.layers.attention import dot_product_attention

TOL = 2e-5

CASES = {
    # name: (shape [B, T, H, D], causal, window)
    "t256_causal": ((2, 256, 2, 64), True, None),
    "t256_full": ((2, 256, 2, 64), False, None),
    "t384_causal": ((2, 384, 2, 32), True, None),
    "t384_full": ((2, 384, 2, 32), False, None),
    "t256_window64": ((2, 256, 2, 64), True, 64),
}


def _inputs(seed, shape, n=4):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _jax_lse(q, k, v, causal, window):
    """The JAX kernel's logsumexp [B, H, T] straight from ``_fwd_call``
    (the public function returns O only)."""
    b, t, h, d = q.shape
    bq, bk = jfa.pick_blocks(t)
    pad = ((0, 0), (0, 0), (0, 0), (0, (-d) % jfa.LANES))

    def to_bh(x):
        x = jnp.pad(jnp.asarray(x), pad)
        return x.transpose(0, 2, 1, 3).reshape(b * h, t, x.shape[-1])

    _, lse = jfa._fwd_call(to_bh(q), to_bh(k), to_bh(v), scale=1.0 / d ** 0.5,
                           causal=causal, window=window, block_q=bq,
                           block_k=bk, interpret=True)
    return np.asarray(lse[:, :, 0]).reshape(b, h, t)


def _scaled(a, ref):
    return np.abs(a - ref).max() / max(np.abs(ref).max(), 1e-30)


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_matches_jax_kernel(name):
    shape, causal, window = CASES[name]
    q, k, v, do = _inputs(sorted(CASES).index(name), shape)
    jo, vjp = jax.vjp(
        lambda q, k, v: jfa.flash_attention(q, k, v, causal=causal,
                                            window=window, interpret=True),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(do))

    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = fa.flash_attention(tq, tk, tv, causal=causal, window=window)
    grads = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo), atol=TOL,
                               rtol=TOL)
    for g, jg in zip(grads, jgrads):
        assert _scaled(g.numpy(), np.asarray(jg)) <= TOL

    _, lse = fa.flash_attention_plain_fwd(torch.from_numpy(q),
                                          torch.from_numpy(k),
                                          torch.from_numpy(v), causal, window)
    np.testing.assert_allclose(lse.numpy(), _jax_lse(q, k, v, causal, window),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("causal, window", [(True, None), (False, None),
                                            (True, 5)])
def test_plain_backward_matches_autograd_of_dot_product_attention(causal,
                                                                   window):
    q, k, v, do = (torch.from_numpy(a) for a in
                   _inputs(3, (2, 37, 3, 16)))
    o, lse = fa.flash_attention_plain_fwd(q, k, v, causal, window)
    dq, dk, dv = fa.flash_attention_plain_bwd(q, k, v, o, lse, do, causal,
                                              window)
    tq, tk, tv = (x.clone().requires_grad_() for x in (q, k, v))
    ref = dot_product_attention(tq, tk, tv, causal=causal, window=window)
    want = torch.autograd.grad(ref, (tq, tk, tv), do)
    np.testing.assert_allclose(o.numpy(), ref.detach().numpy(), atol=TOL)
    for got, w in zip((dq, dk, dv), want):
        assert _scaled(got.numpy(), w.numpy()) <= TOL


def test_ragged_length_matches_dot_product_attention():
    """T = 100 tiles by nothing the TPU kernel takes; the port's path
    takes any T."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(4, (2, 100, 2, 24)))
    assert not jfa.supports(100, 24) and fa.supports(q)
    tq, tk, tv = (x.clone().requires_grad_() for x in (q, k, v))
    o = fa.flash_attention(tq, tk, tv, causal=True)
    got = torch.autograd.grad(o, (tq, tk, tv), do)
    rq, rk, rv = (x.clone().requires_grad_() for x in (q, k, v))
    ref = dot_product_attention(rq, rk, rv, causal=True)
    want = torch.autograd.grad(ref, (rq, rk, rv), do)
    np.testing.assert_allclose(o.detach().numpy(), ref.detach().numpy(),
                               atol=TOL)
    for g, w in zip(got, want):
        assert _scaled(g.numpy(), w.numpy()) <= TOL


def test_cpu_tensors_take_the_plain_version_and_are_counted():
    q, k, v, do = (torch.from_numpy(a).requires_grad_(i < 3)
                   for i, a in enumerate(_inputs(5, (1, 20, 2, 8))))
    before = (fa.fwd_counts.plain_calls, fa.dq_counts.plain_calls,
              fa.dkv_counts.plain_calls, fa.fwd_counts.launches)
    o = fa.flash_attention(q, k, v, causal=True)
    torch.autograd.grad(o, (q, k, v), do)
    after = (fa.fwd_counts.plain_calls, fa.dq_counts.plain_calls,
             fa.dkv_counts.plain_calls, fa.fwd_counts.launches)
    assert after == (before[0] + 1, before[1] + 1, before[2] + 1, before[3])


def test_supports_refuses_float64_and_ragged_head_dims():
    x = torch.zeros(1, 5, 2, 16)
    assert fa.supports(x) and fa.supports(x.bfloat16())
    assert not fa.supports(x.double())
    assert not fa.supports(x.half())
    assert not fa.supports(torch.zeros(1, 5, 2, 12))
    assert not fa.supports(torch.zeros(1, 5, 2, 264))
    helper = fa.FlashAttentionHelper()
    assert helper.supports(x) and not helper.supports(x.double())
