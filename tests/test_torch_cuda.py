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
}


def _flash_inputs(seed, b, t, h, d, dtype):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(b, t, h, d, generator=g).to("cuda", dtype)
            for _ in range(4)]


def _scaled_err(a, b):
    """Largest difference over the reference's largest magnitude."""
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max().clamp_min(1e-30)).item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
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
        assert _scaled_err(got, ref) <= TOL[dtype]


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
        fa.flash_fwd(q.half(), k.half(), v.half(), causal=True)
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
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
        fe.dropout_residual_norm_2d(h.half(), None, gamma.half(),
                                    beta.half(), None, 1e-5, 1.0)
    with pytest.raises(ValueError, match="multiple"):
        fe.dropout_residual_norm_2d(h[:, :30].contiguous(), None,
                                    gamma[:30], beta[:30], None, 1e-5, 1.0)
    with pytest.raises(TypeError):
        fe.dropout_residual_norm_2d(h, None, gamma.bfloat16(), beta, None,
                                    1e-5, 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        fe.dropout_residual_norm_2d(h.t().contiguous().t(), None, gamma,
                                    beta, None, 1e-5, 1.0)


def test_fit_step_goes_through_the_kernels(cuda):
    """One bfloat16 ``fit`` step of a small char-LM on the card launches
    each flash kernel once per attention layer and the prologue once per
    residual block, and never runs a plain version."""
    from deeplearning4j_tpu_torch.models.zoo import transformer_char_lm

    net = transformer_char_lm(vocab_size=29, d_model=64, n_heads=4,
                              layers=2, compute_dtype="bfloat16")
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
