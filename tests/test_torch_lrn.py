"""The port's LRN (``deeplearning4j_tpu_torch/helpers/lrn.py`` and
``LocalResponseNormalization``) against the JAX package: its Pallas
kernel ``pallas_ops.lrn`` with its custom VJP, run in interpret mode on
the CPU as the JAX package's own tests run it, and the JAX layer.

On the CPU the port's wrappers run their kernels' plain versions through
the same ``autograd.Function`` as on the card.  Cases cover odd and even
windows (n = 4 pins the kernel's n + 1 channels), channel counts below
the window, at AlexNet's first LRN and off the TPU's 128-lane tiling,
and an alpha large enough that the backward's window term matters.
Tolerance: float32 at ``atol=1e-5`` scaled by the reference's largest
magnitude (different summation orders)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.helpers import pallas_ops
from deeplearning4j_tpu.nn.layers.normalization import (
    LocalResponseNormalization as JLRN,
)
from deeplearning4j_tpu_torch import helpers
from deeplearning4j_tpu_torch.helpers import lrn
from deeplearning4j_tpu_torch.nn.layers import layer_from_dict

ATOL = 1e-5
K, BETA = 2.0, 0.75


def _close(got, want, atol=ATOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(got - want).max() <= atol * scale, np.abs(got - want).max()


def _data(seed, shape):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    return x, g


def _jax_lrn(x, g, n, alpha):
    y, vjp = jax.vjp(lambda v: pallas_ops.lrn(v, K, n, alpha, BETA),
                     jnp.asarray(x))
    (dx,) = vjp(jnp.asarray(g))
    return np.asarray(y), np.asarray(dx)


@pytest.mark.parametrize("alpha", [1e-4, 1e-2])
@pytest.mark.parametrize("c", [3, 96, 130])
@pytest.mark.parametrize("n", [3, 4, 5, 7])
def test_matches_pallas_with_its_vjp(n, c, alpha):
    x, g = _data(n * 1000 + c, (37, c))
    jy, jdx = _jax_lrn(x, g, n, alpha)
    tx = torch.tensor(x, requires_grad=True)
    before = (lrn.fwd_counts.plain_calls, lrn.bwd_counts.plain_calls)
    y = lrn.lrn(tx, K, n, alpha, BETA)
    (dx,) = torch.autograd.grad(y, tx, torch.from_numpy(g))
    assert (lrn.fwd_counts.plain_calls,
            lrn.bwd_counts.plain_calls) == (before[0] + 1, before[1] + 1)
    _close(y.detach().numpy(), jy)
    _close(dx.numpy(), jdx)
    # the plain versions, called directly
    _close(lrn.lrn_fwd_plain(torch.from_numpy(x), K, n, alpha, BETA), jy)
    _close(lrn.lrn_bwd_plain(torch.from_numpy(x), torch.from_numpy(g), K, n,
                             alpha, BETA), jdx)


def test_rank_4_nhwc_matches_pallas():
    """An NHWC activation: the window runs along the last axis, the
    wrapper views it as [N·H·W, C]."""
    x, g = _data(5, (2, 5, 6, 11))
    jy, jdx = _jax_lrn(x.reshape(-1, 11), g.reshape(-1, 11), 5, 1e-2)
    tx = torch.tensor(x, requires_grad=True)
    y = lrn.LRNHelper().apply(tx, K, 5, 1e-2, BETA)
    assert y.shape == (2, 5, 6, 11)
    (dx,) = torch.autograd.grad(y, tx, torch.from_numpy(g))
    _close(y.detach().numpy().reshape(-1, 11), jy)
    _close(dx.numpy().reshape(-1, 11), jdx)


def test_even_n_sums_n_plus_one_channels():
    """n = 4 sums offsets -2..2, five channels, as the Pallas kernel; the
    window sum zeroes past either edge."""
    v = torch.arange(1.0, 7.0)[None, :]
    got = lrn.window_sum(v, 4 // 2)
    assert got.tolist() == [[6.0, 10.0, 15.0, 20.0, 18.0, 15.0]]
    x = torch.ones(1, 9)
    y = lrn.lrn_fwd_plain(x, 0.0, 4, 1.0, 1.0)
    # interior channels see 5 ones, edges 3 and 4
    np.testing.assert_allclose(y.numpy()[0], 1.0 / np.array(
        [3, 4, 5, 5, 5, 5, 5, 4, 3], np.float32), rtol=1e-6)


@pytest.mark.parametrize("n", [4, 5])
def test_layer_matches_jax_layer(n):
    """``LocalResponseNormalization`` on CPU tensors (the helper's plain
    version) against the JAX layer (its Pallas helper at this size),
    forward and gradient."""
    jl = JLRN(n=n, alpha=1e-2, name="lrn")
    layer = layer_from_dict(jl.to_dict())
    assert layer == layer_from_dict(layer.to_dict())
    assert not layer.has_params() and layer.init(None) == {}
    x, g = _data(9, (2, 4, 3, 10))
    jy, vjp = jax.vjp(lambda v: jl.apply({}, {}, v)[0], jnp.asarray(x))
    (jdx,) = vjp(jnp.asarray(g))
    tx = torch.tensor(x, requires_grad=True)
    before = lrn.fwd_counts.plain_calls
    y = layer.apply({}, tx)
    assert lrn.fwd_counts.plain_calls == before + 1
    (dx,) = torch.autograd.grad(y, tx, torch.from_numpy(g))
    _close(y.detach().numpy(), jy)
    _close(dx.numpy(), jdx)
    # the built-in path (helpers off) is the same function
    with helpers.helpers_disabled():
        yb = layer.apply({}, torch.from_numpy(x))
    _close(yb.numpy(), jy)


def test_layer_in_16_bit_types_and_float64():
    layer = layer_from_dict(JLRN(alpha=1e-2).to_dict())
    x, _ = _data(3, (2, 3, 3, 8))
    ref = layer.apply({}, torch.from_numpy(x)).numpy()
    for dtype in (torch.bfloat16, torch.float16):
        before = lrn.fwd_counts.plain_calls
        y = layer.apply({}, torch.from_numpy(x).to(dtype))
        assert y.dtype == dtype and lrn.fwd_counts.plain_calls == before + 1
        assert np.abs(y.float().numpy() - ref).max() <= 1e-2 * np.abs(
            ref).max()
    # float64 on the CPU takes the built-in path, as in a gradient check
    before = lrn.fwd_counts.plain_calls
    y64 = layer.apply({}, torch.from_numpy(x).double())
    assert y64.dtype == torch.float64
    assert lrn.fwd_counts.plain_calls == before
    _close(y64.numpy(), ref)


def test_layer_raises_off_the_cpu_for_a_type_the_kernels_do_not_take():
    """A non-CPU float64 tensor (on the ``meta`` device here) raises with
    the helpers on, and takes the built-in path with them off."""
    layer = layer_from_dict(JLRN().to_dict())
    meta = torch.empty(2, 3, 3, 8, dtype=torch.float64, device="meta")
    assert helpers.get_helper("lrn") is not None
    with pytest.raises(TypeError, match="helpers_disabled"):
        layer.apply({}, meta)
    with helpers.helpers_disabled():
        out = layer.apply({}, meta)
    assert out.shape == meta.shape and out.dtype == torch.float64


def test_supports_and_tiling():
    assert lrn.supports(torch.zeros(3, 5))
    assert lrn.supports(torch.zeros(2, 4, 4, 7, dtype=torch.bfloat16))
    assert lrn.supports(torch.zeros(3, 5, dtype=torch.float16))
    assert not lrn.supports(torch.zeros(3, 5, dtype=torch.float64))
    assert not lrn.supports(torch.zeros(0, 5))
    assert lrn.tiling(96) == (21, 96)
    assert lrn.tiling(256) == (8, 256)
    assert lrn.tiling(5000) == (1, lrn.TILE)
    assert lrn.tiling(1) == (lrn.MAX_ROWS, 1)
    # the route a call takes: AlexNet's shapes in every type on the vector
    # route, the rest staged
    bf = torch.bfloat16
    for c in (96, 256):
        x = torch.zeros(4, c, dtype=bf)
        assert lrn.route(x, 5) == "vector"
        assert lrn.route(x, 5, torch.zeros_like(x)) == "vector"
        assert lrn.route(x.half(), 5) == "vector"
    assert lrn.route(torch.zeros(4, 96), 5) == "vector"      # float32, V = 4
    assert lrn.route(torch.zeros(4, 8, dtype=bf), 9) == "vector"  # 2h = V
    assert lrn.route(torch.zeros(4, 130, dtype=bf), 5) == "staged"
    assert lrn.route(torch.zeros(4, 3, dtype=bf), 5) == "staged"
    buf = torch.zeros(4 * 96 + 1, dtype=bf)
    unaligned = buf[1:].view(4, 96)
    assert unaligned.data_ptr() % 16 == 2
    assert lrn.route(unaligned, 5) == "staged"
    assert lrn.route(torch.zeros(4, 96, dtype=bf), 5, unaligned) == "staged"
    assert lrn.route(torch.zeros(4, 96), 7) == "staged"      # 2h = 6 > V
    assert lrn.route(torch.zeros(4, 8, dtype=bf), 11) == "staged"
    assert lrn.route(torch.zeros(2, 5000, dtype=bf), 5) == "staged"


def _emulate_kernel(x, g, k, n, alpha, beta, rpb, ct):
    """The kernels' tiling in numpy, index for index: a tile of rpb rows
    and ct channels, x staged with a halo (h forward, 2h backward) and g
    with h, zeros outside [0, C); s^-β and t over the tile plus a halo of
    h; each output from its tile's staged values alone."""
    rows, c = x.shape
    h = n // 2
    y = np.full_like(x, np.nan)
    dx = np.full_like(x, np.nan)

    def stage(src, r0, nr, ch0, count):
        out = np.zeros((nr, count), np.float32)
        for j in range(count):
            ch = ch0 + j
            if 0 <= ch < c:
                out[:, j] = src[r0:r0 + nr, ch]
        return out

    for r0 in range(0, rows, rpb):
        for c0 in range(0, c, ct):
            nr, w = min(rpb, rows - r0), min(ct, c - c0)
            xs = stage(x, r0, nr, c0 - h, w + 2 * h)
            for col in range(w):
                win = xs[:, col:col + 2 * h + 1]
                s = k + alpha * (win * win).sum(1)
                y[r0:r0 + nr, c0 + col] = xs[:, col + h] * s ** -beta
            xs = stage(x, r0, nr, c0 - 2 * h, w + 4 * h)
            gs = stage(g, r0, nr, c0 - h, w + 2 * h)
            ps = np.zeros_like(gs)
            ts = np.zeros_like(gs)
            for j in range(w + 2 * h):
                win = xs[:, j:j + 2 * h + 1]
                s = k + alpha * (win * win).sum(1)
                ps[:, j] = s ** -beta
                if 0 <= c0 - h + j < c:
                    ts[:, j] = gs[:, j] * xs[:, j + h] * (ps[:, j] / s)
            for col in range(w):
                jj = col + h
                tsum = ts[:, col:col + 2 * h + 1].sum(1)
                dx[r0:r0 + nr, c0 + col] = (
                    gs[:, jj] * ps[:, jj]
                    - 2 * alpha * beta * xs[:, jj + h] * tsum)
    return y, dx


@pytest.mark.parametrize("rows,c,n,ct", [
    (23, 96, 5, None),      # whole rows, AlexNet's LRN1 width
    (9, 130, 4, None),      # ragged, even n
    (5, 3, 7, None),        # C < n: every window runs off both edges
    (4, 50, 7, 16),         # channel tiles with a halo, ragged last tile
    (3, 40, 3, 1),          # one channel a tile
])
def test_kernel_tiling_in_numpy(rows, c, n, ct):
    """Channel tiles with a halo (forced small here; on the card they
    start above ``lrn.TILE`` channels) give the plain version's result."""
    x, g = _data(rows + c, (rows, c))
    rpb, tile = lrn.tiling(c) if ct is None else (2, ct)
    y, dx = _emulate_kernel(x, g, K, n, 1e-2, BETA, rpb, tile)
    assert not np.isnan(y).any() and not np.isnan(dx).any()
    _close(y, lrn.lrn_fwd_plain(torch.from_numpy(x), K, n, 1e-2, BETA))
    _close(dx, lrn.lrn_bwd_plain(torch.from_numpy(x), torch.from_numpy(g),
                                 K, n, 1e-2, BETA))


def _emulate_vector(x, g, k, n, alpha, beta, v):
    """The vector route's warp schedule in numpy, index for index: lane l
    of warp tile t holds vector t·TILE_VECTORS + l − 1 of the flattened
    [rows·C / v, v] tensor (zeros past either end); warp w loads the
    tiles w·U .. w·U + U − 1 (U = FWD_TILES forward, BWD_TILES backward)
    before its arithmetic, and the grid has warps enough for every tile;
    the halo comes from lanes l ∓ 1 by shuffles
    (a lane with no such neighbour reads its own value), zeroed where the
    vector starts or ends a row (its position in the row by unsigned
    modulo, as in the kernel); the backward's t halo likewise from the
    neighbours' t; lanes 1..TILE_VECTORS store.  Returns y, dx and how
    often each vector was stored by each direction."""
    rows, c = x.shape
    h, lanes = n // 2, np.arange(lrn.LANES)
    per_row = c // v
    nvec = rows * per_row
    xv, gv = x.reshape(nvec, v), g.reshape(nvec, v)
    tiles = -(-nvec // lrn.TILE_VECTORS)
    y = np.full((nvec, v), np.nan, np.float32)
    dx = np.full((nvec, v), np.nan, np.float32)
    stored = np.zeros((2, nvec), np.int64)

    def load(src, e):
        ok = (e >= 0) & (e < nvec)
        out = np.zeros((lrn.LANES, v), np.float32)
        out[ok] = src[e[ok]]
        return out

    def up(a):      # __shfl_up_sync(.., 1): lane l reads lane l - 1
        return np.concatenate([a[:1], a[:-1]])

    def down(a):    # __shfl_down_sync(.., 1): lane l reads lane l + 1
        return np.concatenate([a[1:], a[-1:]])

    def with_halo(own, first, last):
        left, right = up(own)[:, v - h:].copy(), down(own)[:, :h].copy()
        left[first], right[last] = 0.0, 0.0
        return np.concatenate([left, own, right], 1)

    def window(a, i):
        out = a[:, i].copy()
        for d in range(1, 2 * h + 1):
            out = out + a[:, i + d]
        return out

    def lane_vectors(tile):
        e = tile * lrn.TILE_VECTORS + lanes - 1
        pos = (e & 0xFFFFFFFF) % per_row
        keep = (lanes >= 1) & (lanes <= lrn.TILE_VECTORS) & (e < nvec)
        return e, pos == 0, pos == per_row - 1, keep

    for t0 in range(0, tiles, lrn.FWD_TILES):      # one warp each
        raw = [load(xv, lane_vectors(t0 + u)[0])
               for u in range(lrn.FWD_TILES)]
        for u in range(lrn.FWD_TILES):
            e, first, last, keep = lane_vectors(t0 + u)
            xs = with_halo(raw[u], first, last)
            out = np.stack([
                xs[:, h + i] * (k + alpha * window(xs * xs, i)) ** -beta
                for i in range(v)], 1)
            y[e[keep]] = out[keep]
            stored[0, e[keep]] += 1
    for t0 in range(0, tiles, lrn.BWD_TILES):
        raw = [(load(xv, lane_vectors(t0 + u)[0]),
                load(gv, lane_vectors(t0 + u)[0]))
               for u in range(lrn.BWD_TILES)]
        for u in range(lrn.BWD_TILES):
            e, first, last, keep = lane_vectors(t0 + u)
            xs, gs = with_halo(raw[u][0], first, last), raw[u][1]
            s = np.stack([k + alpha * window(xs * xs, i)
                          for i in range(v)], 1)
            pw = s ** -beta
            t = with_halo(gs * xs[:, h:h + v] * s ** (-beta - 1),
                          first, last)
            out = np.stack([
                gs[:, i] * pw[:, i]
                - 2 * alpha * beta * xs[:, h + i] * window(t, i)
                for i in range(v)], 1)
            dx[e[keep]] = out[keep]
            stored[1, e[keep]] += 1
    return y.reshape(rows, c), dx.reshape(rows, c), stored


@pytest.mark.parametrize("c,n,v", [(c, n, 8) for c in (8, 16, 96, 256)
                                   for n in (3, 4, 5, 7)]
                         + [(c, 5, 4) for c in (8, 16, 96, 256)])
def test_vector_lane_schedule_in_numpy(c, n, v):
    """The vector route's lanes, halos from neighbour lanes, warp-edge
    lanes and row-edge zeros give the plain version's result, every vector
    stored exactly once; 37 rows never fill the last warp tile.  v = 8 is
    a 16-bit type's vector, v = 4 float32's."""
    rows = 37
    assert (rows * c // v) % lrn.TILE_VECTORS
    x, g = _data(rows * c + n, (rows, c))
    y, dx, stored = _emulate_vector(x, g, K, n, 1e-2, BETA, v)
    assert (stored == 1).all()
    _close(y, lrn.lrn_fwd_plain(torch.from_numpy(x), K, n, 1e-2, BETA))
    _close(dx, lrn.lrn_bwd_plain(torch.from_numpy(x), torch.from_numpy(g),
                                 K, n, 1e-2, BETA))
