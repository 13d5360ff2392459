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
    assert fa.supports(x.half())
    assert not fa.supports(torch.zeros(1, 5, 2, 12))
    assert not fa.supports(torch.zeros(1, 5, 2, 264))
    helper = fa.FlashAttentionHelper()
    assert helper.supports(x) and not helper.supports(x.double())


def test_attention_layer_routes_float16_and_raises_off_the_cpu():
    """``SelfAttentionLayer`` sends a float16 tensor to the helper (its
    plain version on the CPU, close to the float32 result); a non-CPU
    tensor the kernels do not take (float64 on the ``meta`` device here)
    raises with the helpers on and takes the built-in path with them
    off.  A padding mask keeps the built-in path, as in the reference."""
    from deeplearning4j_tpu_torch import helpers
    from deeplearning4j_tpu_torch.nn.layers import SelfAttentionLayer

    layer = SelfAttentionLayer(n_in=32, n_out=32, n_heads=2, causal=True,
                               name="attn")
    params = layer.init(torch.Generator().manual_seed(1))
    x = torch.from_numpy(_inputs(8, (2, 11, 32))[0])
    ref = layer.apply(params, x)
    before = fa.fwd_counts.plain_calls
    y = layer.apply({k: v.half() for k, v in params.items()}, x.half())
    assert fa.fwd_counts.plain_calls == before + 1 and y.dtype == torch.half
    assert _scaled(y.float().numpy(), ref.numpy()) <= 5e-3
    mask = torch.ones(2, 11)
    layer.apply(params, x, mask=mask)
    assert fa.fwd_counts.plain_calls == before + 1

    meta = torch.empty(2, 11, 32, dtype=torch.float64, device="meta")
    mparams = {k: v.double().to("meta") for k, v in params.items()}
    with pytest.raises(TypeError, match="helpers_disabled"):
        layer.apply(mparams, meta)
    with helpers.helpers_disabled():
        out = layer.apply(mparams, meta)
    assert out.shape == meta.shape and out.dtype == torch.float64


# ------------------------------------------------- the wgmma kernels' walk
# A numpy mirror of the loop bounds of ``flash_fwd_wgmma`` and
# ``flash_dkv_wgmma`` (``csrc/flash_attention.cu``): ``key_range``,
# ``query_range``, ``band_hit`` and ``tile_full`` with the kernels' tile
# sizes.  The forward walks 128-key tiles under a 128-row query tile, the
# dK/dV kernel 64-row query steps under a 128-key tile; each block is two
# consumer warpgroups of 64 rows (queries or keys), and a warpgroup skips
# a tile in which its rows see no key.
TILE, STEP, WG_ROWS = 128, 64, 64


def _live(q, k, t, causal, window):
    """The mask as the kernels' ``live``, over index arrays."""
    keep = (q < t) & (k < t)
    if causal:
        keep &= k <= q
        if window:
            keep &= k > q - window
    return keep


def _band_hit(q0, q1, k0, k1, t, causal, window):
    q1, k1 = min(q1, t), min(k1, t)
    if q0 >= q1 or k0 >= k1:
        return False
    if not causal:
        return True
    return q1 - 1 >= k0 and (not window or q0 - (k1 - 1) < window)


def _tile_full(q0, bq, k0, bk, t, causal, window):
    if q0 + bq > t or k0 + bk > t:
        return False
    if not causal:
        return True
    return k0 + bk - 1 <= q0 and (not window or k0 > q0 + bq - 1 - window)


def _key_range(q0, bm, t, causal, window):
    lo, hi = 0, t
    if causal:
        hi = min(t, q0 + bm)
        if window:
            lo = max(0, q0 - window + 1)
    return lo // bm * bm, hi


def _query_range(k0, bm, t, causal, window):
    lo, hi = 0, t
    if causal:
        lo = k0
        if window:
            hi = min(t, k0 + bm - 1 + window)
    return lo // bm * bm, hi


def _walk(kernel, t, causal, window):
    """(loaded (rows, cols) tiles as (q0, q1, k0, k1), visits [T, T]):
    every tile the producer loads, and how often a consumer computes each
    live (query, key) pair."""
    visits = np.zeros((t, t), dtype=np.int64)
    loaded = []
    for blk in range((t + TILE - 1) // TILE):
        if kernel == "fwd":
            q0 = blk * TILE
            k_lo, k_hi = _key_range(q0, TILE, t, causal, window)
            tiles = [(q0, q0 + TILE, k, k + TILE)
                     for k in range(k_lo, k_hi, TILE)]
            parts = [(q0 + WG_ROWS * w, q0 + WG_ROWS * (w + 1), None, None)
                     for w in range(2)]
        else:
            k0 = blk * TILE
            q_lo, q_hi = _query_range(k0, TILE, t, causal, window)
            q_lo = q_lo // STEP * STEP
            tiles = [(q, q + STEP, k0, k0 + TILE)
                     for q in range(q_lo, q_hi, STEP)]
            parts = [(None, None, k0 + WG_ROWS * w, k0 + WG_ROWS * (w + 1))
                     for w in range(2)]
        loaded += tiles
        for pq0, pq1, pk0, pk1 in parts:
            rects = [((pq0, pq1) if pq0 is not None else (tq0, tq1),
                      (pk0, pk1) if pk0 is not None else (tk0, tk1))
                     for tq0, tq1, tk0, tk1 in tiles]
            hits = [_band_hit(q0, q1, k0, k1, t, causal, window)
                    for (q0, q1), (k0, k1) in rects]
            for ((q0, q1), (k0, k1)), hit in zip(rects, hits):
                if not hit:
                    continue
                qi, ki = np.meshgrid(np.arange(q0, q1), np.arange(k0, k1),
                                     indexing="ij")
                keep = _live(qi, ki, t, causal, window)
                if _tile_full(q0, q1 - q0, k0, k1 - k0, t, causal, window):
                    assert keep.all()
                visits[qi[keep], ki[keep]] += 1
    return loaded, visits


@pytest.mark.parametrize("kernel", ["fwd", "dkv"])
@pytest.mark.parametrize("causal, window", [
    (False, None), (True, None), (True, 1), (True, 100), (True, 128),
    (True, 200)], ids=["full", "causal", "window1", "window100",
                      "window128", "window200"])
def test_wgmma_tile_walk_visits_each_live_pair_once(kernel, causal, window):
    """For every T from 1 to 300: each live (query, key) pair is computed
    exactly once, and every loaded tile holds a live pair (none outside
    the band)."""
    for t in range(1, 301):
        loaded, visits = _walk(kernel, t, causal, window)
        pos = np.arange(t)
        live = _live(pos[:, None], pos[None, :], t, causal, window)
        assert (visits == live).all(), (t, np.argwhere(visits != live)[:3])
        for q0, q1, k0, k1 in loaded:
            assert q0 < t and k0 < t
            assert _band_hit(q0, q1, k0, k1, t, causal, window), (t, q0, k0)


def test_build_digest_covers_headers_and_flags(tmp_path):
    """The kernels' library name changes with the source, with any
    ``.cuh`` header beside it and with the compile flags, so an edit to
    any of them rebuilds instead of loading a stale library."""
    from deeplearning4j_tpu_torch.helpers import cuda_build

    src = tmp_path / "k.cu"
    src.write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    first = cuda_build.build_digest(src)
    assert cuda_build.build_digest(src) == first
    (tmp_path / "h.cuh").write_text("// two\n")
    second = cuda_build.build_digest(src)
    assert second != first
    flags = cuda_build.NVCC_FLAGS + ("-lcuda",)
    assert cuda_build.build_digest(src, flags) != second
    src.write_text('#include "h.cuh"\n// edited\n')
    assert cuda_build.build_digest(src) != second
