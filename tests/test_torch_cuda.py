"""The port's CUDA kernels on the card, against their plain versions.

Needs an NVIDIA GPU: every test skips without one.  The file imports no
JAX, so it runs on a machine that has none; run it there without the
session conftest (which sets JAX up):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: float32 to 1e-4 absolute; bfloat16 to 2e-2 absolute, the
plain version fed the same bfloat16 tensors (it accumulates in float32
like the kernel; the two round at different places)."""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.helpers import paged_attention as pa

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 5e-3}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


def _case(seed, b, t, hq, hkv, d, *, ps=16, maxp=32, pages=513,
          dtype=torch.bfloat16, device="cuda"):
    """Engine-shaped inputs: page 0 is the trash page; row 0 is an idle
    slot (all-trash block row, positions from 0); the other rows end at
    random positions in partly filled pages."""
    rng = np.random.default_rng(seed)
    g = torch.Generator().manual_seed(seed)
    pk = torch.randn(pages * ps, hkv, d, generator=g)
    pv = torch.randn(pages * ps, hkv, d, generator=g)
    q = torch.randn(b, t, hq, d, generator=g)
    block = rng.integers(1, pages, size=(b, maxp)).astype(np.int32)
    last = rng.integers(t - 1, maxp * ps, size=(b,))
    last[0] = t - 1
    block[0] = 0
    for i in range(b):
        block[i, int(last[i]) // ps + 1:] = 0
    qpos = ((last - (t - 1))[:, None] + np.arange(t)).astype(np.int32)
    dev = torch.device(device)
    return ([x.to(dev, dtype) for x in (q, pk, pv)]
            + [torch.from_numpy(block).to(dev), torch.from_numpy(qpos).to(dev)])


CASES = {
    "decode": (16, 1, 8, 8, 128),
    "prefill": (1, 16, 8, 8, 128),
    "gqa": (16, 1, 8, 2, 128),
    "gqa_chunk": (3, 5, 8, 2, 64),
    "d32": (4, 2, 4, 4, 32),
    "d256": (2, 3, 4, 2, 256),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_plain(name, dtype, cuda):
    args = _case(7, *CASES[name], dtype=dtype)
    before = pa.counts.launches
    out = pa.paged_decode_attention(*args, page_size=16)
    assert pa.counts.launches == before + 1
    ref = pa.paged_attention_plain(*args, 16)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == args[0].shape
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= TOL[dtype], err


def test_kernel_refuses_what_it_does_not_take(cuda):
    q, pk, pv, block, qpos = _case(1, 2, 1, 4, 4, 128)
    with pytest.raises(TypeError):
        pa.paged_decode_attention(q.half(), pk.half(), pv.half(), block,
                                  qpos, page_size=16)
    with pytest.raises(TypeError):
        pa.paged_decode_attention(q, pk, pv, block.long(), qpos,
                                  page_size=16)
    q, pk, pv, block, qpos = _case(1, 2, 3, 4, 4, 128)
    with pytest.raises(ValueError, match="contiguous"):
        pa.paged_decode_attention(q.transpose(1, 2).contiguous()
                                  .transpose(1, 2), pk, pv, block, qpos,
                                  page_size=16)
    q, pk, pv, block, qpos = _case(1, 2, 1, 4, 4, 12)
    with pytest.raises(ValueError, match="head dim"):
        pa.paged_decode_attention(q, pk, pv, block, qpos, page_size=16)


def test_engine_goes_through_the_kernel(cuda):
    """A small bfloat16 model served on the card launches the kernel once
    per attention layer per call and never runs the plain version."""
    from deeplearning4j_tpu_torch.generation import GenerationEngine
    from deeplearning4j_tpu_torch.models.zoo import transformer_char_lm

    net = transformer_char_lm(vocab_size=29, d_model=64, n_heads=4,
                              layers=2, compute_dtype="bfloat16")
    pa.counts.reset()
    eng = GenerationEngine(net, slots=4, page_size=16, max_context=64,
                           prefill_buckets=(16,)).start()
    try:
        outs = [h.result(timeout=60) for h in
                [eng.submit([1 + i, 2, 3], 12) for i in range(6)]]
    finally:
        eng.stop()
    assert all(len(o) == 12 for o in outs)
    calls = eng.programs.prefill_calls + eng.programs.decode_calls
    assert pa.counts.launches == 2 * calls and pa.counts.plain_calls == 0


# ---------------------------------------------------------------- flash
from deeplearning4j_tpu_torch.helpers import flash_attention as fa  # noqa: E402
from deeplearning4j_tpu_torch.helpers import fused_epilogue as fe  # noqa: E402

FLASH_CASES = {
    # name: (B, T, H, D, causal, window)
    "small_causal": (2, 96, 2, 64, True, None),
    "ragged_causal": (1, 100, 3, 32, True, None),
    "not_causal": (2, 77, 2, 16, False, None),
    "window": (1, 200, 2, 64, True, 33),
    "d256": (1, 70, 2, 256, True, None),
    "d40": (2, 45, 1, 40, True, 7),
    "full_width": (8, 2048, 8, 128, True, None),
    # the wgmma path's edges (bf16 and f16 at D = 64 and 128): one row,
    # a tile less one, a tile plus one, a ragged third tile
    "t1_d64": (2, 1, 3, 64, True, None),
    "t1_d128": (2, 1, 3, 128, True, None),
    "t127_d64": (1, 127, 2, 64, True, None),
    "t127_d128": (1, 127, 2, 128, True, None),
    "t129_d64": (1, 129, 2, 64, True, None),
    "t129_d128": (1, 129, 2, 128, True, None),
    "t300_d64": (2, 300, 2, 64, True, None),
    "t300_d128": (2, 300, 2, 128, True, None),
    # windows across 128-row tiles
    "window100_d64": (1, 300, 2, 64, True, 100),
    "window100_d128": (1, 300, 2, 128, True, 100),
    "window200_d64": (1, 300, 2, 64, True, 200),
    "window200_d128": (1, 300, 2, 128, True, 200),
    # non-causal, ragged T
    "full_ragged_d64": (2, 300, 2, 64, False, None),
    "full_ragged_d128": (2, 300, 2, 128, False, None),
    # B*H = 300: more blocks than SMs
    "bh300_d64": (60, 129, 5, 64, True, None),
    "bh300_d128": (60, 129, 5, 128, True, None),
}


def _flash_inputs(seed, b, t, h, d, dtype):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(b, t, h, d, generator=g).to("cuda", dtype)
            for _ in range(4)]


def _scaled_err(a, b):
    """Largest difference over the reference's largest magnitude."""
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max().clamp_min(1e-30)).item()


def _grad_err(a, b):
    """``_scaled_err``; where the reference's largest magnitude is below
    1e-3 the absolute difference instead.  At T = 1 a row's one key has
    softmax weight 1, so dq and dk are 0 up to rounding and a relative
    measure is rounding over rounding."""
    if b.float().abs().max().item() < 1e-3:
        return (a.float() - b.float()).abs().max().item()
    return _scaled_err(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("name", sorted(FLASH_CASES))
def test_flash_kernels_match_plain(name, dtype, cuda):
    b, t, h, d, causal, window = FLASH_CASES[name]
    q, k, v, do = _flash_inputs(11, b, t, h, d, dtype)
    counts = (fa.fwd_counts.launches, fa.dq_counts.launches,
              fa.dkv_counts.launches)
    o, lse = fa.flash_fwd(q, k, v, causal=causal, window=window)
    dq, dk, dv = fa.flash_bwd(q, k, v, o, lse, do, causal=causal,
                              window=window)
    assert (fa.fwd_counts.launches, fa.dq_counts.launches,
            fa.dkv_counts.launches) == tuple(c + 1 for c in counts)
    ro, rlse = fa.flash_attention_plain_fwd(q, k, v, causal, window)
    rdq, rdk, rdv = fa.flash_attention_plain_bwd(q, k, v, o, lse, do,
                                                 causal, window)
    torch.cuda.synchronize()
    assert o.dtype == dtype and lse.dtype == torch.float32
    assert (o.float() - ro.float()).abs().max().item() <= TOL[dtype]
    assert (lse - rlse).abs().max().item() <= TOL[dtype]
    for got, ref in ((dq, rdq), (dk, rdk), (dv, rdv)):
        assert got.dtype == dtype
        assert _grad_err(got, ref) <= TOL[dtype]
    # the delta dQ hands to dK/dV (computed in the kernel on the wgmma
    # route) is the torch reduction's, up to summation order
    dq2, delta = fa._launch_dq(q, k, v, do, o, lse, causal, window)
    ref = fa._row_delta(o, do)
    torch.cuda.synchronize()
    assert torch.equal(dq2, dq)
    assert (delta - ref).abs().max().item() <= 1e-5 * max(
        1.0, ref.abs().max().item())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "f16"])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_dkv_is_the_same_run_to_run(d, dtype, cuda):
    """dK/dV uses no atomics: two runs give bitwise the same gradients."""
    q, k, v, do = _flash_inputs(13, 3, 300, 4, d, dtype)
    o, lse = fa.flash_fwd(q, k, v, causal=True)
    delta = fa._row_delta(o, do)
    first = fa._launch_dkv(q, k, v, do, lse, delta, True, None)
    second = fa._launch_dkv(q, k, v, do, lse, delta, True, None)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_flash_paths_at_the_main_path_shape(cuda):
    """The char-LM's D = 128 in bf16 and f16 takes wgmma for the forward,
    dQ and dK/dV, as does D = 64; D = 16 and 32 take mma.sync; float32
    the CUDA cores."""
    for dtype in (torch.bfloat16, torch.float16):
        for d in (64, 128):
            for kernel in ("fwd", "dq", "dkv"):
                assert fa.kernel_path(kernel, dtype, d) == "wgmma"
        assert fa.kernel_path("fwd", dtype, 32) == "mma_sync"
        assert fa.kernel_path("dq", dtype, 32) == "mma_sync"
        assert fa.kernel_path("dkv", dtype, 40) == "cuda_cores"
    assert fa.kernel_path("fwd", torch.float32, 128) == "cuda_cores"
    assert fa.kernel_path("dq", torch.float32, 128) == "cuda_cores"


def test_flash_tensor_map_failure_raises(cuda):
    """A pointer that TMA cannot take (2-byte aligned) fails the tensor-map
    encode: the launcher returns the error, nothing runs on another
    path, and the wrapper's check raises on it."""
    q, k, v, _ = _flash_inputs(2, 1, 128, 2, 128, torch.bfloat16)
    o = torch.zeros_like(q)
    lse = torch.zeros(1, 2, 128, device="cuda")
    fa.build()
    before = o.clone()
    rc = fa._lib.dl4j_flash_fwd(q.data_ptr() + 2, k.data_ptr(), v.data_ptr(),
                                o.data_ptr(), lse.data_ptr(),
                                *fa._tail(q, 1, 128, 2, 128, True, None),
                                fa._stream(q.device))
    torch.cuda.synchronize()
    assert rc >= fa._MAP_ERROR
    assert torch.equal(o, before)
    with pytest.raises(RuntimeError, match="tensor-map"):
        fa._raise_on(rc, "forward")


def test_flash_autograd_on_the_card(cuda):
    """``flash_attention`` differentiates through the kernels: its grads
    equal those of the plain ``dot_product_attention`` in float32."""
    from deeplearning4j_tpu_torch.nn.layers.attention import (
        dot_product_attention,
    )

    q, k, v, do = _flash_inputs(3, 2, 130, 2, 32, torch.float32)
    for x in (q, k, v):
        x.requires_grad_(True)
    before = fa.dkv_counts.launches
    o = fa.flash_attention(q, k, v, causal=True, window=50)
    g = torch.autograd.grad(o, (q, k, v), do)
    assert fa.dkv_counts.launches == before + 1
    ref = dot_product_attention(q, k, v, causal=True, window=50)
    gr = torch.autograd.grad(ref, (q, k, v), do)
    assert (o - ref).abs().max().item() <= 1e-4
    for a, r in zip(g, gr):
        assert (a - r).abs().max().item() <= 1e-4


def test_flash_wrapper_refuses_what_it_does_not_take(cuda):
    q, k, v, _ = _flash_inputs(1, 1, 16, 2, 64, torch.float32)
    with pytest.raises(TypeError):
        fa.flash_fwd(q.double(), k.double(), v.double(), causal=True)
    with pytest.raises(TypeError):
        fa.flash_fwd(q, k.bfloat16(), v, causal=True)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_fwd(q[..., :12].contiguous(), k[..., :12].contiguous(),
                     v[..., :12].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_fwd(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="shape"):
        fa.flash_fwd(q, k[:, :8].contiguous(), v[:, :8].contiguous())
    assert not fa.supports(q.double()) and not fa.supports(q[..., :12])


# ------------------------------------------------------- fused epilogue
DRN_CASES = {
    # name: (rows, C, residual, mask)
    "prologue": (300, 1024, False, False),
    "prologue_mask": (300, 1024, False, True),
    "residual": (17, 96, True, False),
    "residual_mask": (33, 4096, True, True),
    "wide": (5, 8192, True, True),
    "full_width": (16384, 1024, False, True),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("name", sorted(DRN_CASES))
def test_epilogue_kernel_matches_plain(name, dtype, cuda):
    rows, c, has_res, has_mask = DRN_CASES[name]
    g = torch.Generator().manual_seed(5)
    h = (torch.randn(rows, c, generator=g) * 3 + 1).to("cuda", dtype)
    res = torch.randn(rows, c, generator=g).to("cuda", dtype) if has_res \
        else None
    gamma = (torch.randn(c, generator=g) + 1).to("cuda", dtype)
    beta = torch.randn(c, generator=g).to("cuda", dtype)
    mask = (torch.rand(rows, c, generator=g) < 0.9).cuda() if has_mask \
        else None
    before = fe.counts.launches
    out = fe.dropout_residual_norm_2d(h, res, gamma, beta, mask, 1e-5, 0.9)
    assert fe.counts.launches == before + 1
    ref = fe.dropout_residual_norm_plain(h, res, gamma, beta, mask, 1e-5,
                                         0.9)
    torch.cuda.synchronize()
    assert out.dtype == dtype
    assert _scaled_err(out, ref) <= TOL[dtype]


def test_epilogue_autograd_on_the_card(cuda):
    g = torch.Generator().manual_seed(9)
    h, res = (torch.randn(2, 7, 64, generator=g).cuda().requires_grad_()
              for _ in range(2))
    gamma = (torch.randn(64, generator=g) + 1).cuda().requires_grad_()
    beta = torch.randn(64, generator=g).cuda().requires_grad_()
    mask = torch.rand(2, 7, 64, generator=g).cuda() < 0.7
    y = fe.dropout_residual_norm(h, res, gamma, beta, rate=0.3, mask=mask)
    gy = torch.randn_like(y)
    got = torch.autograd.grad(y, (h, res, gamma, beta), gy)
    x = (h + res).double()
    ref = torch.nn.functional.layer_norm(x, (64,), gamma.double(),
                                         beta.double(), 1e-5)
    ref = torch.where(mask, ref / 0.7, torch.zeros_like(ref))
    want = torch.autograd.grad(ref, (h, res, gamma, beta), gy.double())
    assert (y.double() - ref).abs().max().item() <= 1e-4
    for a, r in zip(got, want):
        assert (a.double() - r).abs().max().item() <= 1e-4


def test_epilogue_wrapper_refuses_what_it_does_not_take(cuda):
    h = torch.randn(4, 64, device="cuda")
    gamma, beta = torch.ones(64, device="cuda"), torch.zeros(64, device="cuda")
    with pytest.raises(TypeError):
        fe.dropout_residual_norm_2d(h.double(), None, gamma.double(),
                                    beta.double(), None, 1e-5, 1.0)
    with pytest.raises(ValueError, match="multiple"):
        fe.dropout_residual_norm_2d(h[:, :30].contiguous(), None,
                                    gamma[:30], beta[:30], None, 1e-5, 1.0)
    with pytest.raises(TypeError):
        fe.dropout_residual_norm_2d(h, None, gamma.bfloat16(), beta, None,
                                    1e-5, 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        fe.dropout_residual_norm_2d(h.t().contiguous().t(), None, gamma,
                                    beta, None, 1e-5, 1.0)


@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float16"])
def test_fit_step_goes_through_the_kernels(compute_dtype, cuda):
    """One bfloat16 or float16 ``fit`` step of a small char-LM on the card
    launches each flash kernel once per attention layer and the prologue
    once per residual block, and never runs a plain version."""
    from deeplearning4j_tpu_torch.models.zoo import transformer_char_lm

    net = transformer_char_lm(vocab_size=29, d_model=64, n_heads=4,
                              layers=2, compute_dtype=compute_dtype)
    ids = np.random.default_rng(0).integers(0, 29, (2, 40))
    y = np.eye(29, dtype=np.float32)[np.roll(ids, -1, 1)]
    counts = (fa.fwd_counts, fa.dq_counts, fa.dkv_counts, fe.counts)
    for c in counts:
        c.reset()
    net.fit(ids, y)
    net.fit(ids, y)
    assert [c.launches for c in counts] == [4, 4, 4, 8]
    assert [c.plain_calls for c in counts] == [0, 0, 0, 0]
    assert np.isfinite(net.score_value) and net.iteration == 2


def test_dropout_and_remat_on_the_card(cuda):
    """A pre-norm block with input dropout, recomputed in the backward
    (``remat``): the masks are drawn on the card from the same keys in
    the forward and the recompute, so the kernel path's grads equal the
    built-in path's (float32, kernel vs library LayerNorm)."""
    from deeplearning4j_tpu_torch import helpers
    from deeplearning4j_tpu_torch.models.sequential import tree_leaves
    from deeplearning4j_tpu_torch.nn.layers import (
        DenseLayer, LayerNorm, ResidualBlock, SelfAttentionLayer,
    )

    x = torch.randn(2, 48, 64, generator=torch.Generator().manual_seed(2))
    x = x.cuda()
    for sub in (DenseLayer(n_in=64, n_out=64, activation="relu",
                           dropout=0.25),
                SelfAttentionLayer(n_in=64, n_out=64, n_heads=4,
                                   n_kv_heads=2, causal=True, rope=True,
                                   dropout=0.25)):
        block = ResidualBlock(remat=True, layers=(LayerNorm(n_in=64), sub))
        params = block.init(torch.Generator().manual_seed(0),
                            device=torch.device("cuda"))
        leaves = tree_leaves(params)
        grads = []
        for on in (True, False):
            helpers.enable_helpers(on)
            try:
                for p in leaves:
                    p.grad = None
                    p.requires_grad_(True)
                before = fe.counts.launches
                y = block.apply(params, x, train=True,
                                rng=torch.Generator().manual_seed(9))
                assert fe.counts.launches == before + on
                (y * y).mean().backward()   # recomputes the block
                assert fe.counts.launches == before + 2 * on
                grads.append([p.grad.clone() for p in leaves])
            finally:
                helpers.enable_helpers(True)
        for a, b in zip(*grads):
            assert (a - b).abs().max().item() <= 1e-4 * max(
                1.0, b.abs().max().item())


# ------------------------------------------------------------ batch norm
from deeplearning4j_tpu_torch.helpers import batch_norm as bn  # noqa: E402

BN_CASES = {
    # name: (rows, C)
    "stem": (1605632, 64),
    "last_stage": (6272, 2048),
    "stage3": (25088, 1024),
    "ragged": (1001, 130),
    "one_row": (1, 7),
    "narrow": (50000, 3),
    "vector_c": (333, 24),
}


def _bn_inputs(seed, m, c, dtype):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(m, c, generator=g) * 2 + 3).to("cuda", dtype)
    gy = torch.randn(m, c, generator=g).to("cuda", dtype)
    gamma = (torch.randn(c, generator=g) + 1).cuda()
    beta = torch.randn(c, generator=g).cuda()
    return x, gy, gamma, beta


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("name", sorted(BN_CASES))
def test_batch_norm_kernels_match_plain(name, dtype, cuda):
    m, c = BN_CASES[name]
    x, gy, gamma, beta = _bn_inputs(13, m, c, dtype)
    before = (bn.train_fwd_counts.launches, bn.train_bwd_counts.launches,
              bn.inference_counts.launches)
    y, mean, var, inv = bn.bn_train_fwd_2d(x, gamma, beta, 1e-5)
    dx, dgamma, dbeta = bn.bn_train_bwd_2d(x, gy, gamma, mean, inv)
    yi = bn.bn_inference_2d(x, mean, var, gamma, beta, 1e-5)
    assert (bn.train_fwd_counts.launches, bn.train_bwd_counts.launches,
            bn.inference_counts.launches) == tuple(b + 1 for b in before)
    ry, rmean, rvar, rinv = bn.bn_train_fwd_plain(x, gamma, beta, 1e-5)
    rdx, rdgamma, rdbeta = bn.bn_train_bwd_plain(x, gy, gamma, rmean, rinv)
    ryi = bn.bn_inference_plain(x, rmean, rvar, gamma, beta, 1e-5)
    torch.cuda.synchronize()
    assert y.dtype == dx.dtype == yi.dtype == dtype

    def err(a, ref):
        # relative to the largest magnitude, absolute below 1 (a single
        # row normalises to exactly 0 and its dx is 0)
        return ((a.float() - ref.float()).abs().max()
                / ref.float().abs().max().clamp_min(1.0)).item()

    for got, ref in ((mean, rmean), (var, rvar), (inv, rinv)):
        assert err(got, ref) <= 1e-5
    for got, ref in ((y, ry), (yi, ryi), (dx, rdx), (dgamma, rdgamma),
                     (dbeta, rdbeta)):
        assert err(got, ref) <= TOL[dtype]


@pytest.mark.parametrize("adt", [torch.bfloat16, torch.float16],
                         ids=["bf16", "f16"])
@pytest.mark.parametrize("name", ["last_stage", "ragged"])
def test_batch_norm_reads_per_channel_values_in_their_own_type(name, adt,
                                                               cuda):
    """gamma and beta in bfloat16 or float16 give bitwise what their
    float32 copies give (the widening is exact), in all three kernels."""
    m, c = BN_CASES[name]
    x, gy, gamma, beta = _bn_inputs(17, m, c, torch.bfloat16)
    gamma, beta = gamma.to(adt), beta.to(adt)
    g32, b32 = gamma.float(), beta.float()
    y, mean, var, inv = bn.bn_train_fwd_2d(x, gamma, beta, 1e-5)
    y32, _, _, _ = bn.bn_train_fwd_2d(x, g32, b32, 1e-5)
    dx, dgamma, dbeta = bn.bn_train_bwd_2d(x, gy, gamma, mean, inv)
    dx32, dg32, db32 = bn.bn_train_bwd_2d(x, gy, g32, mean, inv)
    rvar = var + 0.25
    yi = bn.bn_inference_2d(x, mean, rvar, gamma, beta, 1e-5)
    yi32 = bn.bn_inference_2d(x, mean, rvar, g32, b32, 1e-5)
    torch.cuda.synchronize()
    for a, b in ((y, y32), (dx, dx32), (dgamma, dg32), (dbeta, db32),
                 (yi, yi32)):
        assert torch.equal(a, b)
    ryi = bn.bn_inference_plain(x, mean, rvar, gamma, beta, 1e-5)
    assert _scaled_err(yi, ryi) <= TOL[torch.bfloat16]


def test_batch_norm_is_the_same_run_to_run(cuda):
    x, gy, gamma, beta = _bn_inputs(3, 200000, 96, torch.bfloat16)
    runs = []
    for _ in range(2):
        y, mean, var, inv = bn.bn_train_fwd_2d(x, gamma, beta, 1e-5)
        runs.append((y, mean, var) + bn.bn_train_bwd_2d(x, gy, gamma, mean,
                                                        inv))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_batch_norm_autograd_on_the_card(cuda):
    """The helper's training and inference paths differentiate through
    the kernels: float32 grads equal those of the float64 formula."""
    helper = bn.BatchNormHelper()
    g = torch.Generator().manual_seed(4)
    x = (torch.randn(3, 5, 5, 12, generator=g) + 1).cuda().requires_grad_()
    gamma = (torch.randn(12, generator=g) + 1).cuda().requires_grad_()
    beta = torch.randn(12, generator=g).cuda().requires_grad_()
    gy = torch.randn(3, 5, 5, 12, generator=g).cuda()
    y, mean, var = helper.apply_training(x, gamma, beta, 1e-5)
    got = torch.autograd.grad(y, (x, gamma, beta), gy)
    xd = x.double()
    m = xd.mean(dim=(0, 1, 2))
    v = xd.var(dim=(0, 1, 2), unbiased=False)
    ref = (xd - m) * torch.rsqrt(v + 1e-5) * gamma.double() + beta.double()
    want = torch.autograd.grad(ref, (x, gamma, beta), gy.double())
    assert (y.double() - ref).abs().max().item() <= 1e-4
    for a, r in zip(got, want):
        assert (a.double() - r).abs().max().item() <= 1e-4 * max(
            1.0, r.abs().max().item())
    mean, var = mean.detach(), var.detach() + 0.5
    yi = helper.apply_inference(x, mean, var, gamma, beta, 1e-5)
    got = torch.autograd.grad(yi, (x, gamma, beta), gy)
    ref = ((xd - mean.double()) * torch.rsqrt(var.double() + 1e-5)
           * gamma.double() + beta.double())
    want = torch.autograd.grad(ref, (x, gamma, beta), gy.double())
    for a, r in zip(got, want):
        assert (a.double() - r).abs().max().item() <= 1e-4 * max(
            1.0, r.abs().max().item())


def test_batch_norm_wrapper_refuses_what_it_does_not_take(cuda):
    x, gy, gamma, beta = _bn_inputs(1, 16, 8, torch.float32)
    with pytest.raises(TypeError):
        bn.bn_train_fwd_2d(x.double(), gamma, beta, 1e-5)
    with pytest.raises(ValueError, match="contiguous"):
        bn.bn_train_fwd_2d(x.t().contiguous().t(), gamma, beta, 1e-5)
    with pytest.raises(ValueError, match="must be"):
        bn.bn_train_fwd_2d(x, gamma[:4], beta, 1e-5)
    with pytest.raises(TypeError):
        bn.bn_train_bwd_2d(x, gy.bfloat16(), gamma, gamma, gamma)
    with pytest.raises(ValueError, match="a row"):
        bn.bn_inference_2d(x[:0], gamma, gamma, gamma, beta, 1e-5)


def test_batch_norm_layer_raises_for_float64_on_the_card(cuda):
    """A CUDA tensor the kernels do not take never goes to the built-in
    path quietly: float64 raises, and runs only with helpers disabled."""
    from deeplearning4j_tpu_torch import helpers
    from deeplearning4j_tpu_torch.nn.layers import BatchNormalization

    layer = BatchNormalization(n_out=8, name="bn")
    dev = torch.device("cuda")
    params = layer.init(None, torch.float64, dev)
    state = layer.init_state(dev)
    x = torch.randn(4, 3, 3, 8, dtype=torch.float64, device=dev)
    before = bn.train_fwd_counts.launches
    with pytest.raises(TypeError, match="enable_helpers"):
        layer.apply_with_state(params, state, x, train=True)
    with helpers.helpers_disabled():
        y, _ = layer.apply_with_state(params, state, x, train=True)
    assert y.dtype == torch.float64
    assert bn.train_fwd_counts.launches == before


@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float16"])
def test_resnet_goes_through_the_batch_norm_kernels(compute_dtype, cuda):
    """A small ResNet in bfloat16 or float16 on the card: ``output``
    launches the inference kernel once per BatchNorm layer and ``fit`` the
    training kernels once each, with no plain-version call."""
    from deeplearning4j_tpu_torch.models.zoo import resnet50

    net = resnet50(height=16, width=16, channels=3, n_classes=4,
                   blocks=(1, 1), stem_stride=1, init_channels=8,
                   compute_dtype=compute_dtype)
    x = np.random.default_rng(0).random((4, 16, 16, 3)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[[0, 1, 2, 3]]
    counts = (bn.inference_counts, bn.train_fwd_counts, bn.train_bwd_counts)
    for c in counts:
        c.reset()
    out = net.output(x)
    net.fit(x, y)
    net.fit(x, y)
    assert [c.launches for c in counts] == [9, 18, 18]
    assert [c.plain_calls for c in counts] == [0, 0, 0]
    assert out.shape == (4, 4) and bool(torch.isfinite(out).all())
    assert np.isfinite(net.score_value)
    assert net.net_state["stem_bn"]["mean"].dtype == torch.float32


def test_layers_raise_for_float64_on_the_card(cuda):
    """Attention and a pre-norm block on a float64 CUDA tensor raise with
    the helpers on (the kernels take f32, bf16 and f16), and run their
    built-in paths only with helpers disabled."""
    from deeplearning4j_tpu_torch import helpers
    from deeplearning4j_tpu_torch.nn.layers import (
        DenseLayer, LayerNorm, ResidualBlock, SelfAttentionLayer,
    )

    dev = torch.device("cuda")
    attn = SelfAttentionLayer(n_in=32, n_out=32, n_heads=2, causal=True)
    block = ResidualBlock(layers=(LayerNorm(n_in=32),
                                  DenseLayer(n_in=32, n_out=32)))
    x = torch.randn(2, 9, 32, dtype=torch.float64, device=dev)
    for layer in (attn, block):
        params = layer.init(torch.Generator().manual_seed(0), torch.float64,
                            dev)
        with pytest.raises(TypeError, match="helpers_disabled"):
            layer.apply(params, x)
        with helpers.helpers_disabled():
            y = layer.apply(params, x)
        assert y.dtype == torch.float64 and y.shape == x.shape


# ------------------------------------------------------------------- LRN
from deeplearning4j_tpu_torch.helpers import lrn  # noqa: E402

LRN_CASES = {
    # name: (rows, C, n)
    "lrn1": (373248, 96, 5),
    "lrn2": (86528, 256, 5),
    "ragged": (1001, 130, 5),
    "narrow": (777, 3, 5),
    "n7": (5000, 96, 7),
    "even_n": (999, 64, 4),
    "channel_tiles": (37, 5000, 5),
    "one_channel": (64, 1, 3),
}


def _lrn_inputs(seed, rows, c, dtype):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(rows, c, generator=g) * 3).to("cuda", dtype)
    gy = torch.randn(rows, c, generator=g).to("cuda", dtype)
    return x, gy


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("name", sorted(LRN_CASES))
def test_lrn_kernels_match_plain(name, dtype, cuda):
    rows, c, n = LRN_CASES[name]
    x, gy = _lrn_inputs(21, rows, c, dtype)
    before = (lrn.fwd_counts.launches, lrn.bwd_counts.launches)
    y = lrn.lrn_fwd_2d(x, 2.0, n, 1e-2, 0.75)
    dx = lrn.lrn_bwd_2d(x, gy, 2.0, n, 1e-2, 0.75)
    assert (lrn.fwd_counts.launches,
            lrn.bwd_counts.launches) == (before[0] + 1, before[1] + 1)
    ry = lrn.lrn_fwd_plain(x, 2.0, n, 1e-2, 0.75)
    rdx = lrn.lrn_bwd_plain(x, gy, 2.0, n, 1e-2, 0.75)
    torch.cuda.synchronize()
    assert y.dtype == dx.dtype == dtype
    assert _scaled_err(y, ry) <= TOL[dtype]
    assert _scaled_err(dx, rdx) <= TOL[dtype]


def test_lrn_is_the_same_run_to_run(cuda):
    x, gy = _lrn_inputs(4, 86528, 256, torch.bfloat16)
    runs = [(lrn.lrn_fwd_2d(x, 2.0, 5, 1e-4, 0.75),
             lrn.lrn_bwd_2d(x, gy, 2.0, 5, 1e-4, 0.75)) for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_lrn_autograd_on_the_card(cuda):
    """``lrn.lrn`` differentiates through both kernels on an NHWC view:
    float32 grads equal those of the float64 formula."""
    g = torch.Generator().manual_seed(6)
    x = (torch.randn(2, 7, 5, 24, generator=g) * 2).cuda().requires_grad_()
    gy = torch.randn(2, 7, 5, 24, generator=g).cuda()
    before = lrn.bwd_counts.launches
    y = lrn.lrn(x, 2.0, 5, 1e-2, 0.75)
    (got,) = torch.autograd.grad(y, x, gy)
    assert lrn.bwd_counts.launches == before + 1
    xd = x.double()
    ref = xd / (2.0 + 1e-2 * lrn.window_sum(xd * xd, 2)) ** 0.75
    (want,) = torch.autograd.grad(ref, x, gy.double())
    assert (y.double() - ref).abs().max().item() <= 1e-4
    assert (got.double() - want).abs().max().item() <= 1e-4


def test_lrn_wrapper_refuses_what_it_does_not_take(cuda):
    x, gy = _lrn_inputs(1, 16, 8, torch.float32)
    with pytest.raises(TypeError):
        lrn.lrn_fwd_2d(x.double(), 2.0, 5, 1e-4, 0.75)
    with pytest.raises(TypeError):
        lrn.lrn_bwd_2d(x, gy.bfloat16(), 2.0, 5, 1e-4, 0.75)
    with pytest.raises(ValueError, match="contiguous"):
        lrn.lrn_fwd_2d(x.t().contiguous().t(), 2.0, 5, 1e-4, 0.75)
    with pytest.raises(ValueError, match="rows"):
        lrn.lrn_fwd_2d(x[:0], 2.0, 5, 1e-4, 0.75)
    with pytest.raises(RuntimeError, match="launch failed"):
        lrn.lrn_fwd_2d(x, 2.0, 40001, 1e-4, 0.75)   # no tile fits


def test_lrn_layer_raises_for_float64_on_the_card(cuda):
    from deeplearning4j_tpu_torch import helpers
    from deeplearning4j_tpu_torch.nn.layers import LocalResponseNormalization

    layer = LocalResponseNormalization(name="lrn")
    x = torch.randn(2, 5, 5, 16, dtype=torch.float64, device="cuda")
    before = lrn.fwd_counts.launches
    with pytest.raises(TypeError, match="helpers_disabled"):
        layer.apply({}, x)
    with helpers.helpers_disabled():
        y = layer.apply({}, x)
    assert y.dtype == torch.float64
    assert lrn.fwd_counts.launches == before


@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float16"])
def test_alexnet_goes_through_the_lrn_kernels(compute_dtype, cuda):
    """A small AlexNet on the card: ``output`` launches the forward kernel
    once per LRN layer and ``fit`` both kernels once each, with no
    plain-version call."""
    from deeplearning4j_tpu_torch.models.zoo import alexnet

    net = alexnet(height=67, width=67, n_classes=5,
                  compute_dtype=compute_dtype)
    x = np.random.default_rng(0).random((4, 67, 67, 3)).astype(np.float32)
    y = np.eye(5, dtype=np.float32)[[0, 1, 2, 3]]
    counts = (lrn.fwd_counts, lrn.bwd_counts)
    for c in counts:
        c.reset()
    out = net.output(x)
    assert [c.launches for c in counts] == [2, 0]
    net.fit(x, y)
    net.fit(x, y)
    assert [c.launches for c in counts] == [6, 4]
    assert [c.plain_calls for c in counts] == [0, 0]
    assert out.shape == (4, 5) and bool(torch.isfinite(out).all())
    assert np.isfinite(net.score_value)
