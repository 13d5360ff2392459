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


def _grad_err(a, ref):
    """Scaled error; where the reference's largest magnitude is below
    1e-3 (at T = 1 a row's one key has weight 1, so dq and dk are 0 up to
    rounding) the absolute difference."""
    return (np.abs(a - ref).max() if np.abs(ref).max() < 1e-3
            else _scaled(a, ref))


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


# ------------------------------------------ the tensor-core kernels' walk
# A numpy mirror of the loop bounds of ``flash_fwd_wgmma``,
# ``flash_dq_wgmma`` and ``flash_dkv_wgmma`` (``csrc/flash_attention.cu``):
# ``key_range``, ``query_range``, ``band_hit`` and ``tile_full`` with the
# kernels' tile sizes.  The forward walks 128-key tiles under a 128-row
# query tile, dQ 64-key steps under a 128-row query tile, the dK/dV kernel
# 64-row query steps under a 128-key tile; each block is two consumer
# warpgroups of 64 rows (queries or keys), and a warpgroup skips a tile in
# which its rows see no key.  The float32 ``flash_fwd_tf32``,
# ``flash_dq_tf32`` and ``flash_dkv_tf32`` walk the same 128-row blocks in
# 32-row steps, each block eight warps of 16 rows that skip the steps
# their rows do not see.
TILE, STEP, WG_ROWS = 128, 64, 64
TF_STEP, TF_ROWS = 32, 16
# kernel: (rows of a block, step, rows of a block's part)
WALKS = {"fwd": (TILE, TILE, WG_ROWS), "dq": (TILE, STEP, WG_ROWS),
         "dkv": (TILE, STEP, WG_ROWS), "fwd_tf32": (TILE, TF_STEP, TF_ROWS),
         "dq_tf32": (TILE, TF_STEP, TF_ROWS),
         "dkv_tf32": (TILE, TF_STEP, TF_ROWS)}


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


def _key_range(q0, bm, t, causal, window, step=None):
    step = step or bm
    lo, hi = 0, t
    if causal:
        hi = min(t, q0 + bm)
        if window:
            lo = max(0, q0 - window + 1)
    return lo // step * step, hi


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
    tile, step, part = WALKS[kernel]
    for blk in range((t + tile - 1) // tile):
        if kernel.startswith(("fwd", "dq")):
            q0 = blk * tile
            k_lo, k_hi = _key_range(q0, tile, t, causal, window, step)
            tiles = [(q0, q0 + tile, k, k + step)
                     for k in range(k_lo, k_hi, step)]
            parts = [(q0 + part * w, q0 + part * (w + 1), None, None)
                     for w in range(tile // part)]
        else:
            k0 = blk * tile
            q_lo, q_hi = _query_range(k0, tile, t, causal, window)
            q_lo = q_lo // step * step
            tiles = [(q, q + step, k0, k0 + tile)
                     for q in range(q_lo, q_hi, step)]
            parts = [(None, None, k0 + part * w, k0 + part * (w + 1))
                     for w in range(tile // part)]
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


@pytest.mark.parametrize("kernel", sorted(WALKS))
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


LOG2E = np.float32(1.4426950408889634)


def _rows(a, r0, n):
    """Rows [r0, r0 + n) of a [T, D] array, zero past T, as TMA loads a
    tile."""
    out = np.zeros((n, a.shape[1]), np.float32)
    part = a[r0:r0 + n]
    out[:len(part)] = part
    return out


def _dq_blocks(q, k, v, o, do, lse, causal, window):
    """(dq, delta) of one [T, D] head, computed in float32 on the block
    schedule of ``flash_dq_wgmma``: 128-query blocks of two 64-row
    warpgroups; 64-key steps from ``key_range`` rounded to the step;
    steps a warpgroup's rows do not see skipped; p = 2^(s·scale·log2 e −
    lse·log2 e) masked only on steps that are not full; delta from the
    block's O and dO tiles (zero rows past T)."""
    t, d = q.shape
    sl2 = np.float32(1.0 / np.sqrt(d)) * LOG2E
    dq = np.zeros_like(q)
    delta = np.zeros(t, np.float32)
    for q0 in range(0, t, TILE):
        k_lo, k_hi = _key_range(q0, TILE, t, causal, window, STEP)
        qt, dot = _rows(q, q0, TILE), _rows(do, q0, TILE)
        dl = (_rows(o, q0, TILE) * dot).sum(-1, dtype=np.float32)
        for w in range(2):
            r0 = q0 + WG_ROWS * w
            rows = np.arange(r0, r0 + WG_ROWS)
            lr = rows - q0
            lse2 = np.where(rows < t, lse[np.minimum(rows, t - 1)] * LOG2E,
                            np.float32(0))
            acc = np.zeros((WG_ROWS, d), np.float32)
            for k0 in range(k_lo, k_hi, STEP):
                if not _band_hit(r0, r0 + WG_ROWS, k0, k0 + STEP, t, causal,
                                 window):
                    continue
                kt, vt = _rows(k, k0, STEP), _rows(v, k0, STEP)
                p = np.exp2(qt[lr] @ kt.T * sl2 - lse2[:, None])
                if not _tile_full(r0, WG_ROWS, k0, STEP, t, causal, window):
                    keep = _live(rows[:, None], np.arange(k0, k0 + STEP)[None],
                                 t, causal, window)
                    p = np.where(keep, p, np.float32(0))
                ds = p * (dot[lr] @ vt.T - dl[lr][:, None])
                acc += ds.astype(np.float32) @ kt
            live_rows = rows < t
            dq[rows[live_rows]] = acc[live_rows] / np.float32(np.sqrt(d))
            delta[rows[live_rows]] = dl[lr[live_rows]]
    return dq, delta


def _dq_case(seed, t, d, causal, window):
    q, k, v, do = _inputs(seed, (1, t, 1, d))
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = fa.flash_attention_plain_fwd(tq, tk, tv, causal, window)
    dq, delta = _dq_blocks(q[0, :, 0], k[0, :, 0], v[0, :, 0],
                           o.numpy()[0, :, 0], do[0, :, 0],
                           lse.numpy()[0, 0], causal, window)
    return (q, k, v, do), (tq, tk, tv, tdo, o, lse), dq, delta


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("t", [1, 100, 300])
@pytest.mark.parametrize("causal, window", [(True, None), (False, None),
                                            (True, 64)],
                         ids=["causal", "full", "window64"])
def test_dq_block_schedule_matches_plain_backward(causal, window, t, d):
    """The wgmma dQ kernel's schedule, emulated in numpy, gives the plain
    backward's dq and ``_row_delta``'s delta within 1e-5 (float32)."""
    _, (tq, tk, tv, tdo, o, lse), dq, delta = _dq_case(t + d, t, d, causal,
                                                       window)
    rdq, _, _ = fa.flash_attention_plain_bwd(tq, tk, tv, o, lse, tdo,
                                             causal, window)
    assert _grad_err(dq, rdq.numpy()[0, :, 0]) <= 1e-5
    np.testing.assert_allclose(delta, fa._row_delta(o, tdo).numpy()[0, 0],
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("d, causal, window", [(128, True, None),
                                               (64, False, None),
                                               (128, True, 64)],
                         ids=["causal_d128", "full_d64", "window64_d128"])
def test_dq_block_schedule_matches_jax_kernel(d, causal, window):
    """At T = 256, which the JAX kernel tiles, the emulated schedule's dq
    against the JAX backward run in interpret mode."""
    (q, k, v, do), _, dq, _ = _dq_case(7 + d, 256, d, causal, window)
    _, vjp = jax.vjp(
        lambda q, k, v: jfa.flash_attention(q, k, v, causal=causal,
                                            window=window, interpret=True),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jdq = np.asarray(vjp(jnp.asarray(do))[0])[0, :, 0]
    assert _scaled(dq, jdq) <= TOL


# ------------------------------------------------ the tf32x3 kernels
# ``flash_dq_tf32`` and ``flash_dkv_tf32`` multiply float32 on the tensor
# cores in TF32 (10-bit mantissa), three products per pair of operands.
def _tf32(x):
    """The kernels' ``to_tf32``, which rounds as ``cvt.rna.tf32.f32``
    does: float32 to a 10-bit mantissa, ties away from zero (low 13 bits
    zero)."""
    u = np.asarray(x, np.float32).view(np.uint32)
    mag = ((u & np.uint32(0x7FFFFFFF)) + np.uint32(0x1000)) \
        & np.uint32(0xFFFFE000)
    return ((u & np.uint32(0x80000000)) | mag).view(np.float32)


def _split(x):
    """x = big + small, both TF32 values, as the kernels' ``split``."""
    big = _tf32(x)
    return big, _tf32(np.asarray(x, np.float32) - big)


def _mm(a, b, products=3):
    """a @ b as the kernels take it on ``mma.sync`` m16n8k8: each product
    exact (TF32 significands), summed into a float32 accumulator, the two
    small products first.  ``products=1`` is one TF32 product."""
    (ab, asm), (bb, bsm) = _split(a), _split(b)
    f64 = np.float64
    if products == 1:
        return (ab.astype(f64) @ bb.astype(f64)).astype(np.float32)
    acc = (asm.astype(f64) @ bb.astype(f64)).astype(np.float32)
    acc += (ab.astype(f64) @ bsm.astype(f64)).astype(np.float32)
    acc += (ab.astype(f64) @ bb.astype(f64)).astype(np.float32)
    return acc


NEG_INF32 = np.float32(fa.NEG_INF)


def _tf32_fwd_blocks(q, k, v, causal, window, products=3):
    """(o, lse) of one [T, D] head on the block schedule of
    ``flash_fwd_tf32``: 128-query blocks of eight 16-row warps, 32-key
    steps from ``key_range`` rounded to the step, steps a warp's rows do
    not see skipped; ``softmax_step``'s online softmax (m the running max
    of the raw scores, p = 2^(s sl2 - m sl2), masks only on steps that are
    not full); S = Q K^T and O += P V through ``_mm``; lse = m scale +
    log l."""
    t, d = q.shape
    scale = np.float32(1.0 / np.sqrt(d))
    sl2 = scale * LOG2E
    o = np.zeros_like(q)
    lse = np.zeros(t, np.float32)
    for q0 in range(0, t, TILE):
        k_lo, k_hi = _key_range(q0, TILE, t, causal, window, TF_STEP)
        for r0 in range(q0, q0 + TILE, TF_ROWS):
            if r0 >= t:
                break
            rows = np.arange(r0, r0 + TF_ROWS)
            qt = _rows(q, r0, TF_ROWS)
            m = np.full(TF_ROWS, NEG_INF32)
            l = np.zeros(TF_ROWS, np.float32)
            acc = np.zeros((TF_ROWS, d), np.float32)
            for k0 in range(k_lo, k_hi, TF_STEP):
                if not _band_hit(r0, r0 + TF_ROWS, k0, k0 + TF_STEP, t,
                                 causal, window):
                    continue
                kt, vt = _rows(k, k0, TF_STEP), _rows(v, k0, TF_STEP)
                sc = _mm(qt, kt.T, products)
                if not _tile_full(r0, TF_ROWS, k0, TF_STEP, t, causal,
                                  window):
                    keep = _live(rows[:, None],
                                 np.arange(k0, k0 + TF_STEP)[None], t,
                                 causal, window)
                    sc = np.where(keep, sc, NEG_INF32)
                mx = np.maximum(m, sc.max(1))
                alpha = np.exp2((m - mx) * sl2)
                mu = np.where(mx > NEG_INF32 / 2, mx * sl2, np.float32(0))
                p = np.exp2(sc * sl2 - mu[:, None])
                l = alpha * l + p.sum(1, dtype=np.float32)
                m = mx
                acc = acc * alpha[:, None] + _mm(p, vt, products)
            seen = l > 0
            inv = np.where(seen, 1 / np.where(seen, l, 1), np.float32(0))
            live = rows < t
            o[rows[live]] = (acc * inv[:, None])[live]
            lse[rows[live]] = np.where(
                seen, m * scale + np.log(np.where(seen, l, 1)),
                NEG_INF32)[live]
    return o, lse


def _tf32_fwd_case(seed, t, d, causal, window):
    q, k, v = _inputs(seed, (1, t, 1, d), n=3)
    o, lse = _tf32_fwd_blocks(q[0, :, 0], k[0, :, 0], v[0, :, 0], causal,
                              window)
    return (q, k, v), o, lse


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("t", [1, 100, 300])
@pytest.mark.parametrize("causal, window", [(True, None), (False, None),
                                            (True, 64)],
                         ids=["causal", "full", "window64"])
def test_tf32x3_forward_schedule_matches_plain(causal, window, t, d):
    """The tf32x3 forward's schedule, online softmax and 3xTF32 products,
    emulated in numpy, give the plain forward's o and lse within 1e-5
    (float32)."""
    (q, k, v), o, lse = _tf32_fwd_case(t + 2 * d, t, d, causal, window)
    ro, rlse = fa.flash_attention_plain_fwd(
        *(torch.from_numpy(a) for a in (q, k, v)), causal, window)
    np.testing.assert_allclose(o, ro.numpy()[0, :, 0], atol=1e-5, rtol=0)
    np.testing.assert_allclose(lse, rlse.numpy()[0, 0], atol=1e-5, rtol=0)


@pytest.mark.parametrize("d, causal, window", [(128, True, None),
                                               (64, False, None),
                                               (128, True, 64)],
                         ids=["causal_d128", "full_d64", "window64_d128"])
def test_tf32x3_forward_schedule_matches_jax_kernel(d, causal, window):
    """At T = 256 the emulated tf32x3 forward's o and lse against the JAX
    forward run in interpret mode."""
    (q, k, v), o, lse = _tf32_fwd_case(13 + d, 256, d, causal, window)
    jo = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal, window=window, interpret=True)
    np.testing.assert_allclose(o, np.asarray(jo)[0, :, 0], atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(lse, _jax_lse(q, k, v, causal, window)[0, 0],
                               atol=TOL, rtol=TOL)


def _tf32_dq_blocks(q, k, v, o, do, lse, causal, window, products=3):
    """(dq, delta) of one [T, D] head on the block schedule of
    ``flash_dq_tf32``: 128-query blocks of eight 16-row warps, 32-key
    steps from ``key_range`` rounded to the step, steps a warp's rows do
    not see skipped, masks only on steps that are not full; delta =
    rowsum(dO·O) per row in float32; every product through ``_mm``."""
    t, d = q.shape
    sl2 = np.float32(1.0 / np.sqrt(d)) * LOG2E
    dq = np.zeros_like(q)
    delta = (o * do).sum(-1, dtype=np.float32)
    for q0 in range(0, t, TILE):
        k_lo, k_hi = _key_range(q0, TILE, t, causal, window, TF_STEP)
        for r0 in range(q0, q0 + TILE, TF_ROWS):
            if r0 >= t:
                break
            rows = np.arange(r0, r0 + TF_ROWS)
            qt, dot = _rows(q, r0, TF_ROWS), _rows(do, r0, TF_ROWS)
            lse2 = np.where(rows < t, lse[np.minimum(rows, t - 1)] * LOG2E,
                            np.float32(0))
            dl = np.where(rows < t, delta[np.minimum(rows, t - 1)],
                          np.float32(0))
            acc = np.zeros((TF_ROWS, d), np.float32)
            for k0 in range(k_lo, k_hi, TF_STEP):
                if not _band_hit(r0, r0 + TF_ROWS, k0, k0 + TF_STEP, t,
                                 causal, window):
                    continue
                kt, vt = _rows(k, k0, TF_STEP), _rows(v, k0, TF_STEP)
                p = np.exp2(_mm(qt, kt.T, products) * sl2 - lse2[:, None])
                if not _tile_full(r0, TF_ROWS, k0, TF_STEP, t, causal,
                                  window):
                    keep = _live(rows[:, None],
                                 np.arange(k0, k0 + TF_STEP)[None], t,
                                 causal, window)
                    p = np.where(keep, p, np.float32(0))
                ds = p * (_mm(dot, vt.T, products) - dl[:, None])
                acc += _mm(ds, kt, products)
            live = rows < t
            dq[rows[live]] = acc[live] * np.float32(1.0 / np.sqrt(d))
    return dq, delta


def _tf32_dkv_blocks(q, k, v, do, lse, delta, causal, window, products=3):
    """(dk, dv) of one [T, D] head on the block schedule of
    ``flash_dkv_tf32``: 128-key blocks of eight 16-key warps, 32-query
    steps from ``query_range`` rounded to the step, lse and delta read
    with the step."""
    t, d = q.shape
    sl2 = np.float32(1.0 / np.sqrt(d)) * LOG2E
    scale = np.float32(1.0 / np.sqrt(d))
    dk, dv = np.zeros_like(k), np.zeros_like(v)
    lse_p = np.concatenate([lse, np.zeros(TILE, np.float32)])
    del_p = np.concatenate([delta, np.zeros(TILE, np.float32)])
    for k0 in range(0, t, TILE):
        q_lo, q_hi = _query_range(k0, TILE, t, causal, window)
        q_lo = q_lo // TF_STEP * TF_STEP
        for kb in range(k0, k0 + TILE, TF_ROWS):
            if kb >= t:
                break
            keys = np.arange(kb, kb + TF_ROWS)
            kt, vt = _rows(k, kb, TF_ROWS), _rows(v, kb, TF_ROWS)
            dk_acc = np.zeros((TF_ROWS, d), np.float32)
            dv_acc = np.zeros((TF_ROWS, d), np.float32)
            for q0 in range(q_lo, q_hi, TF_STEP):
                if not _band_hit(q0, q0 + TF_STEP, kb, kb + TF_ROWS, t,
                                 causal, window):
                    continue
                qt, dot = _rows(q, q0, TF_STEP), _rows(do, q0, TF_STEP)
                lse2 = lse_p[q0:q0 + TF_STEP] * LOG2E
                p = np.exp2(_mm(kt, qt.T, products) * sl2 - lse2[None])
                if not _tile_full(q0, TF_STEP, kb, TF_ROWS, t, causal,
                                  window):
                    keep = _live(np.arange(q0, q0 + TF_STEP)[None],
                                 keys[:, None], t, causal, window)
                    p = np.where(keep, p, np.float32(0))
                ds = p * (_mm(vt, dot.T, products)
                          - del_p[q0:q0 + TF_STEP][None])
                dv_acc += _mm(p, dot, products)
                dk_acc += _mm(ds, qt, products)
            live = keys < t
            dk[keys[live]] = dk_acc[live] * scale
            dv[keys[live]] = dv_acc[live]
    return dk, dv


def _tf32_case(seed, t, d, causal, window, products=3):
    q, k, v, do = _inputs(seed, (1, t, 1, d))
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = fa.flash_attention_plain_fwd(tq, tk, tv, causal, window)
    head = [a[0, :, 0] for a in (q, k, v, o.numpy(), do)]
    lse1 = lse.numpy()[0, 0]
    dq, delta = _tf32_dq_blocks(*head, lse1, causal, window, products)
    return (q, k, v, do), (tq, tk, tv, tdo, o, lse), (dq, delta), head, lse1


def test_tf32_rounding_and_split():
    """``_tf32`` rounds to nearest with ties away, keeps 10 mantissa
    bits, and big + small holds a float32 to about 2^-22 of it."""
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)
    assert _tf32(one + ulp / 2) == one + ulp            # tie: away from 0
    assert _tf32(-(one + ulp / 2)) == -(one + ulp)
    assert _tf32(one + ulp / 2 - np.float32(2.0 ** -23)) == one
    x = np.random.default_rng(0).standard_normal(10000).astype(np.float32)
    assert not (_tf32(x).view(np.uint32) & np.uint32(0x1FFF)).any()
    big, small = _split(x)
    assert np.abs(big - x).max() / np.abs(x).max() > 1e-4
    assert (np.abs(big.astype(np.float64) + small - x)
            <= np.abs(x) * 2.0 ** -21).all()


def test_tf32_fragments_give_the_product():
    """The fragment layouts the kernels rely on, lane by lane (lane =
    4 g + t).  ldmatrix of an 8 x 4-float matrix hands lane (g, t) float
    (g, t), which is the tf32 A and B layout (``load_a``, the B loads of
    ``mma3_abt``); and an accumulator (row g, cols 2t, 2t + 1) fed back
    as A with k relabelled (k = t is token 2t, k = t + 4 token 2t + 1)
    times B read from token rows 2t and 2t + 1 (``mma3_pb``) is P·B."""
    rng = np.random.default_rng(1)
    g, t = np.divmod(np.arange(32), 4)

    def mma(a, b):
        """m16n8k8 from per-lane A (4 values) and B (2) fragments."""
        am, bm = np.zeros((16, 8)), np.zeros((8, 8))
        am[g, t], am[g + 8, t], am[g, t + 4], am[g + 8, t + 4] = a.T
        bm[t, g], bm[t + 4, g] = b.T
        return am @ bm

    def ldsm4(tile, row_of_lane, col_of_lane):
        """ldmatrix .x4: lane l gives the row of matrix l // 8 (4 floats
        from its column); lane (g, t) receives float t of row g of each."""
        rows = [[tile[row_of_lane[8 * m + i],
                      col_of_lane[8 * m + i]:col_of_lane[8 * m + i] + 4]
                 for i in range(8)] for m in range(4)]
        return np.stack([np.array(rows[m])[g, t] for m in range(4)], 1)

    lane = np.arange(32)
    m = lane // 8
    tile = rng.standard_normal((40, 24))
    r0, c0 = 16, 8
    a = ldsm4(tile, r0 + lane % 8 + 8 * (m & 1), c0 + 4 * (m >> 1))
    bt = rng.standard_normal((16, 24))
    b = ldsm4(bt, 8 * (0 + (m >> 1)) + lane % 8, c0 + 4 * (m & 1))
    want = tile[r0:r0 + 16, c0:c0 + 8] @ bt[:16, c0:c0 + 8].T
    np.testing.assert_allclose(mma(a, b[:, :2]), want[:, :8])
    np.testing.assert_allclose(mma(a, b[:, 2:]), want[:, 8:])

    p = rng.standard_normal((16, 8))
    acc = np.stack([p[g, 2 * t], p[g, 2 * t + 1], p[g + 8, 2 * t],
                    p[g + 8, 2 * t + 1]], 1)
    a = acc[:, [0, 2, 1, 3]]
    tokens = rng.standard_normal((8, 8))
    b = np.stack([tokens[2 * t, g], tokens[2 * t + 1, g]], 1)
    np.testing.assert_allclose(mma(a, b), p @ tokens)
    # without the relabelling the same registers give another product
    b_plain = np.stack([tokens[t, g], tokens[t + 4, g]], 1)
    assert np.abs(mma(a, b_plain) - p @ tokens).max() > 1e-3


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("t", [1, 100, 300])
@pytest.mark.parametrize("causal, window", [(True, None), (False, None),
                                            (True, 64)],
                         ids=["causal", "full", "window64"])
def test_tf32x3_block_schedule_matches_plain_backward(causal, window, t, d):
    """The tf32x3 dQ and dK/dV kernels' schedules and 3xTF32 products,
    emulated in numpy, give the plain backward's dq, dk, dv and
    ``_row_delta``'s delta within 1e-5 (float32)."""
    _, (tq, tk, tv, tdo, o, lse), (dq, delta), head, lse1 = _tf32_case(
        t + d + 1, t, d, causal, window)
    q, k, v, _, do = head
    dk, dv = _tf32_dkv_blocks(q, k, v, do, lse1, delta, causal, window)
    refs = fa.flash_attention_plain_bwd(tq, tk, tv, o, lse, tdo, causal,
                                        window)
    for got, ref in zip((dq, dk, dv), refs):
        assert _grad_err(got, ref.numpy()[0, :, 0]) <= 1e-5
    np.testing.assert_allclose(delta, fa._row_delta(o, tdo).numpy()[0, 0],
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("d, causal, window", [(128, True, None),
                                               (64, False, None),
                                               (128, True, 64)],
                         ids=["causal_d128", "full_d64", "window64_d128"])
def test_tf32x3_block_schedule_matches_jax_kernel(d, causal, window):
    """At T = 256 the emulated tf32x3 schedules' dq, dk and dv against the
    JAX backward run in interpret mode."""
    (q, k, v, do), _, (dq, delta), head, lse1 = _tf32_case(
        11 + d, 256, d, causal, window)
    dk, dv = _tf32_dkv_blocks(head[0], head[1], head[2], head[4], lse1,
                              delta, causal, window)
    _, vjp = jax.vjp(
        lambda q, k, v: jfa.flash_attention(q, k, v, causal=causal,
                                            window=window, interpret=True),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for got, jg in zip((dq, dk, dv), vjp(jnp.asarray(do))):
        assert _scaled(got, np.asarray(jg)[0, :, 0]) <= TOL


def test_one_tf32_product_misses_the_float32_budget():
    """Why three products: at T = 1024, D = 128, causal, dq from one TF32
    product per pair misses the float32 budget (1e-4 of the largest
    magnitude) by an order of magnitude, and 3xTF32 keeps it within
    1e-5."""
    errs = {}
    for products in (1, 3):
        _, (tq, tk, tv, tdo, o, lse), (dq, _), _, _ = _tf32_case(
            5, 1024, 128, True, None, products)
        rdq = fa.flash_attention_plain_bwd(tq, tk, tv, o, lse, tdo,
                                           True, None)[0]
        errs[products] = _scaled(dq, rdq.numpy()[0, :, 0])
    assert errs[1] >= 1e-4 and errs[3] <= 1e-5, errs


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
