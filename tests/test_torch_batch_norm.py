"""The port's BatchNorm (``deeplearning4j_tpu_torch/helpers/batch_norm.py``
and ``BatchNormalization``) against the JAX package: its Pallas kernels
``bn_training`` (with its custom VJP) and ``bn_inference`` run in
interpret mode on the CPU, and its ``BatchNormalization.apply`` at rank 4.

On the CPU the port's wrappers run their kernels' plain versions through
the same ``autograd.Function``s as on the card.  Shapes include ragged
rows and channels (off the TPU's (8, 128) tiling).  Tolerances (float32,
different summation orders): ``atol=1e-5`` on outputs and moments,
``rtol=1e-4, atol=1e-5`` on gradients (sums over every row); bfloat16
paths against each other to 2e-2 of the output's magnitude (one bfloat16
rounding)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.helpers import pallas_ops
from deeplearning4j_tpu.nn.layers.normalization import (
    BatchNormalization as JBatchNorm,
)
from deeplearning4j_tpu_torch import helpers
from deeplearning4j_tpu_torch.helpers import batch_norm as bn
from deeplearning4j_tpu_torch.nn.layers import layer_from_dict

ATOL = 1e-5
RTOL_G, ATOL_G = 1e-4, 1e-5
SHAPES = {"small": (12, 7), "ragged": (37, 130), "one_row": (1, 5),
          "tall": (300, 3)}


def _data(seed, m, c):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((m, c)) * 2 + 0.7).astype(np.float32)
    gamma = (rng.standard_normal(c) + 1).astype(np.float32)
    beta = rng.standard_normal(c).astype(np.float32)
    g = rng.standard_normal((m, c)).astype(np.float32)
    return x, gamma, beta, g


def _t(*arrays, grad=False):
    return [torch.tensor(a, requires_grad=grad) for a in arrays]


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_training_matches_pallas_with_its_vjp(name):
    m, c = SHAPES[name]
    x, gamma, beta, g = _data(1, m, c)

    def jfn(x, gamma, beta):
        return pallas_ops.bn_training(x, gamma, beta, 1e-5)

    (jy, jmean, jvar), vjp = jax.vjp(
        jfn, jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
    jgrads = vjp((jnp.asarray(g), jnp.zeros(c, jnp.float32),
                  jnp.zeros(c, jnp.float32)))
    tx, tg, tb = _t(x, gamma, beta, grad=True)
    before = (bn.train_fwd_counts.plain_calls,
              bn.train_bwd_counts.plain_calls)
    y, mean, var = bn.BatchNormHelper().apply_training(tx, tg, tb, 1e-5)
    grads = torch.autograd.grad(y, (tx, tg, tb), torch.from_numpy(g))
    assert (bn.train_fwd_counts.plain_calls,
            bn.train_bwd_counts.plain_calls) == (before[0] + 1,
                                                 before[1] + 1)
    assert not mean.requires_grad and mean.dtype == torch.float32
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), atol=ATOL)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), atol=ATOL)
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar), atol=ATOL)
    for got, want, what in zip(grads, jgrads, ("dx", "dgamma", "dbeta")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=RTOL_G, atol=ATOL_G, err_msg=what)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_inference_matches_pallas_with_its_vjp(name):
    m, c = SHAPES[name]
    x, gamma, beta, g = _data(2, m, c)
    rng = np.random.default_rng(3)
    mean = rng.standard_normal(c).astype(np.float32)
    var = (rng.random(c) + 0.5).astype(np.float32)

    def jfn(x, mean, var, gamma, beta):
        return pallas_ops.bn_inference(x, mean, var, gamma, beta, 1e-5)

    jy, vjp = jax.vjp(jfn, *(jnp.asarray(a)
                             for a in (x, mean, var, gamma, beta)))
    jgrads = vjp(jnp.asarray(g))
    targs = _t(x, mean, var, gamma, beta, grad=True)
    before = bn.inference_counts.plain_calls
    y = bn.BatchNormHelper().apply_inference(*targs, 1e-5)
    grads = torch.autograd.grad(y, targs, torch.from_numpy(g))
    assert bn.inference_counts.plain_calls == before + 1
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), atol=ATOL)
    for got, want, what in zip(grads, jgrads,
                               ("dx", "dmean", "dvar", "dgamma", "dbeta")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=RTOL_G, atol=ATOL_G, err_msg=what)


@pytest.mark.parametrize("lock", [False, True], ids=["affine", "locked"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "infer"])
def test_layer_matches_jax_at_rank_4(train, lock):
    """``BatchNormalization`` on NHWC: output and new running stats, the
    JAX layer's plain path (rank 4 training) or Pallas inference against
    the port's helper path."""
    kw = dict(gamma=1.5, beta=-0.25) if lock else {}
    jl = JBatchNorm(n_out=6, decay=0.8, lock_gamma_beta=lock,
                    activation="relu", **kw)
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((3, 5, 4, 6)) * 1.5 + 0.5).astype(np.float32)
    params = {} if lock else {
        "gamma": (rng.standard_normal(6) + 1).astype(np.float32),
        "beta": rng.standard_normal(6).astype(np.float32)}
    state = {"mean": rng.standard_normal(6).astype(np.float32),
             "var": (rng.random(6) + 0.5).astype(np.float32)}
    jy, jstate = jl.apply(
        jax.tree_util.tree_map(jnp.asarray, params),
        jax.tree_util.tree_map(jnp.asarray, state), jnp.asarray(x),
        train=train)
    layer = layer_from_dict(jl.to_dict())
    assert layer.param_shapes() == ({} if lock else {"gamma": (6,),
                                                      "beta": (6,)})
    counts = bn.train_fwd_counts if train else bn.inference_counts
    before = counts.plain_calls
    y, new_state = layer.apply_with_state(
        {k: torch.from_numpy(v) for k, v in params.items()},
        {k: torch.from_numpy(v) for k, v in state.items()},
        torch.from_numpy(x), train=train)
    assert counts.plain_calls == before + 1
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=ATOL)
    for k in ("mean", "var"):
        assert new_state[k].dtype == torch.float32
        np.testing.assert_allclose(new_state[k].numpy(),
                                   np.asarray(jstate[k]), atol=ATOL)


@pytest.mark.parametrize("train", [True, False], ids=["train", "infer"])
def test_builtin_path_matches_jax_builtin_path(train):
    """With helpers off both layers take the reference's jnp formula."""
    from deeplearning4j_tpu import helpers as jhelpers

    jl = JBatchNorm(n_out=5)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, 3, 3, 5)).astype(np.float32)
    params = {"gamma": (rng.random(5) + 0.5).astype(np.float32),
              "beta": rng.standard_normal(5).astype(np.float32)}
    state = {"mean": rng.standard_normal(5).astype(np.float32),
             "var": (rng.random(5) + 0.5).astype(np.float32)}
    jhelpers.enable_helpers(False)
    helpers.enable_helpers(False)
    try:
        jy, jstate = jl.apply(
            jax.tree_util.tree_map(jnp.asarray, params),
            jax.tree_util.tree_map(jnp.asarray, state), jnp.asarray(x),
            train=train)
        before = (bn.train_fwd_counts.plain_calls,
                  bn.inference_counts.plain_calls)
        y, new_state = layer_from_dict(jl.to_dict()).apply_with_state(
            {k: torch.from_numpy(v) for k, v in params.items()},
            {k: torch.from_numpy(v) for k, v in state.items()},
            torch.from_numpy(x), train=train)
        assert (bn.train_fwd_counts.plain_calls,
                bn.inference_counts.plain_calls) == before
    finally:
        jhelpers.enable_helpers(True)
        helpers.enable_helpers(True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=ATOL)
    for k in ("mean", "var"):
        np.testing.assert_allclose(new_state[k].numpy(),
                                   np.asarray(jstate[k]), atol=ATOL)


def test_bfloat16_paths_keep_their_own_dtypes():
    """Under bfloat16 the built-in inference path promotes to float32
    through the float32 running stats (as the reference's jnp does); the
    helper returns x's type.  The two agree within one bfloat16
    rounding."""
    layer = layer_from_dict(JBatchNorm(n_out=8).to_dict())
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((2, 3, 3, 8)).astype(
        np.float32) * 3 + 1).bfloat16()
    params = {"gamma": torch.full((8,), 1.25, dtype=torch.bfloat16),
              "beta": torch.full((8,), 0.5, dtype=torch.bfloat16)}
    state = {"mean": torch.from_numpy(rng.standard_normal(8).astype(
                 np.float32)),
             "var": torch.from_numpy((rng.random(8) + 0.5).astype(
                 np.float32))}
    fast, _ = layer.apply_with_state(params, state, x)
    helpers.enable_helpers(False)
    try:
        plain, _ = layer.apply_with_state(params, state, x)
    finally:
        helpers.enable_helpers(True)
    assert fast.dtype == torch.bfloat16 and plain.dtype == torch.float32
    scale = plain.abs().max().item()
    assert (fast.float() - plain).abs().max().item() <= 2e-2 * scale


def test_layer_refuses_plain_apply_and_keeps_float64_off_the_helper():
    layer = layer_from_dict(JBatchNorm(n_out=3).to_dict())
    x = torch.randn(4, 3, dtype=torch.float64)
    with pytest.raises(TypeError, match="apply_with_state"):
        layer.apply({}, x)
    before = bn.train_fwd_counts.plain_calls
    params = layer.init(torch.Generator(), torch.float64)
    y, _ = layer.apply_with_state(params, layer.init_state(), x, train=True)
    assert y.dtype == torch.float64
    assert bn.train_fwd_counts.plain_calls == before


def test_float16_takes_the_helper_and_float64_off_the_cpu_raises():
    """float16 goes to the helper (its plain version on the CPU) and
    comes back in float16, within one float16 rounding of the float32
    formula; a tensor off the CPU that the kernels do not take (float64,
    on the ``meta`` device here) raises unless the helpers are off."""
    layer = layer_from_dict(JBatchNorm(n_out=6).to_dict())
    rng = np.random.default_rng(8)
    x = torch.from_numpy((rng.standard_normal((2, 3, 3, 6)) * 2 + 1).astype(
        np.float32)).half()
    params = {"gamma": torch.full((6,), 1.5), "beta": torch.full((6,), 0.25)}
    state = layer.init_state()
    before = bn.train_fwd_counts.plain_calls
    y, st = layer.apply_with_state(
        {k: v.half() for k, v in params.items()}, state, x, train=True)
    assert bn.train_fwd_counts.plain_calls == before + 1
    assert y.dtype == torch.float16 and st["mean"].dtype == torch.float32
    with helpers.helpers_disabled():
        ref, rst = layer.apply_with_state(params, state, x.float(),
                                          train=True)
    assert helpers.get_helper("batch_norm") is not None
    assert (y.float() - ref).abs().max().item() <= 2e-3 * ref.abs().max()
    for k in ("mean", "var"):
        np.testing.assert_allclose(st[k].numpy(), rst[k].numpy(), atol=ATOL)

    meta = torch.empty(4, 6, dtype=torch.float64, device="meta")
    mparams = {k: v.double().to("meta") for k, v in params.items()}
    mstate = {k: v.to("meta") for k, v in state.items()}
    with pytest.raises(TypeError, match="enable_helpers"):
        layer.apply_with_state(mparams, mstate, meta, train=True)
    with helpers.helpers_disabled():
        out, _ = layer.apply_with_state(mparams, mstate, meta, train=True)
    assert out.shape == (4, 6) and out.dtype == torch.float64


def test_supports():
    assert bn.supports(torch.zeros(3, 5))
    assert bn.supports(torch.zeros(2, 4, 4, 7, dtype=torch.bfloat16))
    assert bn.supports(torch.zeros(3, 5, dtype=torch.float16))
    assert not bn.supports(torch.zeros(3, 5, dtype=torch.float64))
    assert not bn.supports(torch.zeros(0, 5))
    assert not bn.supports(torch.zeros(5))


@pytest.mark.parametrize("m,c", [(1, 1), (7, 3), (6272, 2048),
                                 (1605632, 64), (100000, 130)])
def test_chunking_covers_every_row(m, c):
    rpc, n = bn.chunking(m, c, 132)
    assert rpc % 8 == 0 and rpc >= 64
    assert (n - 1) * rpc < m <= n * rpc
    assert n <= 65535
    tiles = -(-c // 32)
    assert tiles * n <= max(8 * 132, tiles) + tiles


def test_kernel_moment_merge_in_numpy():
    """The moments kernel's arithmetic, run in numpy on the kernel's own
    grid: per thread a sum shifted by its first value, then Chan's merge
    over the 8 row lanes of a chunk and over the chunks in order.  It
    must give the two-pass mean and biased variance, also for data far
    from zero."""
    rng = np.random.default_rng(7)
    m, c = 1000, 5
    x = (rng.standard_normal((m, c)) * 0.01 + 100.0).astype(np.float32)
    rpc, n_chunks = bn.chunking(m, c, 1)

    def merge(a, b):
        (na, ma, qa), (nb, mb, qb) = a, b
        if nb == 0:
            return a
        nn = na + nb
        d = mb - ma
        f = np.float32(nb / nn)
        return nn, np.float32(ma + d * f), np.float32(qa + qb + d * d * na * f)

    for ch in range(c):
        total = (0, np.float32(0), np.float32(0))
        for k in range(n_chunks):
            lanes = []
            for ty in range(8):
                rows = x[k * rpc + ty:min((k + 1) * rpc, m):8, ch]
                if rows.size == 0:
                    lanes.append((0, np.float32(0), np.float32(0)))
                    continue
                v = rows - rows[0]
                s, q, n = v.sum(dtype=np.float32), (v * v).sum(
                    dtype=np.float32), rows.size
                lanes.append((n, np.float32(rows[0] + s / n),
                              np.float32(max(q - s * s / n, 0.0))))
            part = lanes[0]
            for lane in lanes[1:]:
                part = merge(part, lane)
            total = merge(total, (min(rpc, m - k * rpc), part[1], part[2]))
        n, mean, m2 = total
        assert n == m
        ref = x[:, ch].astype(np.float64)
        np.testing.assert_allclose(mean, ref.mean(), rtol=1e-6)
        np.testing.assert_allclose(m2 / m, ref.var(), rtol=1e-3)


def _elementwise_blocks(x, mean, var, gamma, beta, eps, vec, sms):
    """The inference pass of ``bn_elementwise_kernel`` run in numpy on the
    grid ``elementwise_grid`` gives: per (channel slice, row chunk) block
    and (tx, ty) thread, the thread's ``vec`` channels' coefficients
    worked out once, then its rows ty, ty + by, ... of the chunk.  Returns
    y and how often each element was written."""
    m, c = x.shape
    bx, by, rpc, n_chunks = bn.elementwise_grid(m, c, vec, sms)
    assert bx * by <= 256 and n_chunks <= 65535
    assert (n_chunks - 1) * rpc < m <= n_chunks * rpc
    slices = -(-(c // vec) // bx)
    y = np.zeros_like(x)
    writes = np.zeros(x.shape, np.int64)
    for sx in range(slices):
        for tx in range(bx):
            col = sx * bx + tx
            if col * vec >= c:
                continue
            ch = np.arange(col * vec, col * vec + vec)
            scale = gamma[ch] / np.sqrt(var[ch] + np.float32(eps))
            for cy in range(n_chunks):
                for ty in range(by):
                    rows = np.arange(cy * rpc + ty, min((cy + 1) * rpc, m),
                                     by)
                    y[np.ix_(rows, ch)] = ((x[np.ix_(rows, ch)] - mean[ch])
                                           * scale + beta[ch])
                    writes[np.ix_(rows, ch)] += 1
    return y, writes


@pytest.mark.parametrize("m, c, vec, sms", [
    (37, 130, 1, 132),     # ragged C: the scalar path
    (300, 3, 1, 132),      # C below a vector
    (2000, 64, 8, 4),      # the stem's C in bf16 vectors, several chunks
    (49, 2048, 8, 132),    # the last stage's C: one slice of 256 vectors
    (70, 4096, 4, 132),    # float32 vectors, four channel slices
    (333, 24, 4, 2),       # vec_c
], ids=["ragged130", "c3", "stem", "last_stage", "slices4", "vec24"])
def test_elementwise_grid_matches_inference(m, c, vec, sms):
    """Every element is written once, and the kernel's arithmetic on its
    grid gives the plain version's and the JAX kernel's output."""
    x, gamma, beta, _ = _data(9, m, c)
    rng = np.random.default_rng(10)
    mean = rng.standard_normal(c).astype(np.float32)
    var = (rng.random(c) + 0.5).astype(np.float32)
    y, writes = _elementwise_blocks(x, mean, var, gamma, beta, 1e-5, vec,
                                    sms)
    assert (writes == 1).all()
    plain = bn.bn_inference_plain(*_t(x, mean, var, gamma, beta), 1e-5)
    np.testing.assert_allclose(y, plain.numpy(), atol=ATOL)
    jy = pallas_ops.bn_inference(*(jnp.asarray(a) for a in
                                   (x, mean, var, gamma, beta)), 1e-5)
    np.testing.assert_allclose(y, np.asarray(jy), atol=ATOL)


def test_prepare_keeps_per_channel_types():
    """The kernels read gamma and beta in their own type: ``_prepare``
    hands bfloat16 and float16 ones on as they are (no cast launch per
    call), the running stats as float32, and refuses a mixed pair."""
    x = torch.zeros(4, 6, dtype=torch.bfloat16)
    for dt in (torch.bfloat16, torch.float16, torch.float32):
        gamma, beta = torch.ones(6, dtype=dt), torch.zeros(6, dtype=dt)
        mean, var = torch.zeros(6), torch.ones(6)
        _, _, out = bn._prepare(x, mean=mean, var=var, gamma=gamma,
                                beta=beta)
        assert out["gamma"] is gamma and out["beta"] is beta
        assert out["gamma"].dtype == dt and out["mean"] is mean
        assert bn._adt(out) == bn._DTYPE_CODES[dt]
    with pytest.raises(TypeError, match="one type"):
        bn._prepare(x, gamma=torch.ones(6), beta=torch.zeros(6).bfloat16())
