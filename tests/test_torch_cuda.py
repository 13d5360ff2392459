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
from deeplearning4j_tpu_torch.models.common import tree_leaves

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


# the split over keys at long contexts: (B, T, Hq, Hkv, D, page size,
# pages a row); pages of 24 put split edges (multiples of 8) inside pages
SPLIT_CASES = {
    "long4096": (16, 1, 8, 8, 128, 16, 256),
    "long_gqa_ps24": (4, 1, 8, 2, 128, 24, 160),
    "long_prefill_ps24": (2, 16, 8, 8, 128, 24, 160),
    "d64_ps8": (8, 1, 4, 4, 64, 8, 300),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(SPLIT_CASES))
def test_split_kernel_matches_plain_and_repeats_bitwise(name, dtype, cuda):
    """Long contexts split over the blocks of a cluster: the kernel
    matches the plain version and gives the same bits on a second call
    (the splits merge in a fixed order, no atomics)."""
    b, t, hq, hkv, d, ps, maxp = SPLIT_CASES[name]
    args = _case(5, b, t, hq, hkv, d, ps=ps, maxp=maxp, pages=b * maxp + 1,
                 dtype=dtype)
    first = pa.paged_decode_attention(*args, page_size=ps)
    second = pa.paged_decode_attention(*args, page_size=ps)
    ref = pa.paged_attention_plain(*args, ps)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    err = (first.float() - ref.float()).abs().max().item()
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


def _paged_launches(fn):
    """``fn()`` under the profiler; the paged kernel's launches on the
    device (graph replays included: the Python counts do not tick on
    replay)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, sum(e.count for e in prof.key_averages()
                    if "paged_decode_kernel" in e.key)


def _small_engine(capture=None, slots=4):
    from deeplearning4j_tpu_torch.generation import GenerationEngine
    from deeplearning4j_tpu_torch.generation.programs import (
        GenerationPrograms,
    )
    from deeplearning4j_tpu_torch.models.zoo import transformer_char_lm

    net = transformer_char_lm(vocab_size=29, d_model=64, n_heads=4,
                              layers=2, compute_dtype="bfloat16")
    eng = GenerationEngine(net, slots=slots, page_size=16, max_context=64,
                           prefill_buckets=(16, 32))
    if capture is not None:
        p = eng.programs
        eng.programs = GenerationPrograms(
            net, slots=p.slots, pages_per_slot=p.pages_per_slot,
            page_size=p.page_size, num_pages=p.num_pages,
            prefill_buckets=p.prefill_buckets, capture=capture)
    return eng


def test_engine_goes_through_the_kernel(cuda):
    """A small bfloat16 model served on the card: every call is a graph
    replay, each graph holds one paged-kernel launch per attention layer,
    and the profiler counts that many launches per call while serving;
    the plain version never runs."""
    eng = _small_engine()
    pa.counts.reset()
    eng.start()
    try:
        progs = eng.programs
        calls0 = progs.prefill_calls + progs.decode_calls
        outs, launches = _paged_launches(lambda: [
            h.result(timeout=60) for h in
            [eng.submit([1 + i, 2, 3], 12) for i in range(6)]])
    finally:
        eng.stop()
    assert all(len(o) == 12 for o in outs)
    calls = progs.prefill_calls + progs.decode_calls - calls0
    assert progs.graph_launches() == {"prefill_16": 2, "prefill_32": 2,
                                      "decode": 2}
    assert launches == 2 * calls and calls > 0
    assert progs.replays == progs.prefill_calls + progs.decode_calls
    assert pa.counts.plain_calls == 0


def _program_inputs(rng, progs, step):
    """A decode call's host arrays: live rows at mixed positions in their
    own pages, greedy and sampled (top-k, top-p) rows mixed."""
    s, maxp = progs.slots, progs.pages_per_slot
    block = (1 + np.arange(s * maxp, dtype=np.int32)).reshape(s, maxp)
    pos = (np.arange(s, dtype=np.int32) * 3 + 5 + step)
    return dict(block=block, pos=pos,
                tokens=rng.integers(0, 29, s).astype(np.int32),
                keys=rng.integers(0, 2 ** 32, (s, 2), dtype=np.uint64)
                .astype(np.uint32),
                token_idx=np.full(s, step, np.int32),
                temps=np.array([0, 0.8, 1.2, 0.0][:s], np.float32),
                top_ks=np.array([0, 5, 0, 0][:s], np.int32),
                top_ps=np.array([1, 1, 0.9, 1][:s], np.float32))


def test_captured_programs_equal_eager_programs_bitwise(cuda):
    """Captured decode and prefill against ``capture=False`` on the same
    inputs: tokens, logits and the pools bit for bit over several
    steps."""
    runs = {}
    for capture in (True, False):
        progs = _small_engine(capture).programs
        progs.warm()
        rng = np.random.default_rng(0)
        toks, logits = [], []
        for b in progs.prefill_buckets:
            prompt = np.zeros((1, b), np.int32)
            prompt[0, :b - 3] = rng.integers(0, 29, b - 3)
            toks.append(progs.prefill(
                b, (1 + np.arange(progs.pages_per_slot, dtype=np.int32))
                [None], np.zeros(1, np.int32), b - 4, prompt,
                np.array([[7, 9]], np.uint32), np.zeros(1, np.int32),
                np.array([0.9], np.float32), np.array([4], np.int32),
                np.ones(1, np.float32)))
            logits.append(progs.last_logits.clone())
        for step in range(5):
            toks.append(progs.decode(**_program_inputs(rng, progs, step)))
            logits.append(progs.last_logits.clone())
        torch.cuda.synchronize()
        runs[capture] = (toks, logits, [t.clone() for t in
                                        tree_leaves(progs.pools)], progs)
    (ct, cl, cp, cprogs), (et, el, ep, eprogs) = runs[True], runs[False]
    assert cprogs.captures == 3 and eprogs.captures == 0
    # the warm-up's three calls, then two prefills and five decodes
    assert cprogs.replays == 3 + 2 + 5 and eprogs.replays == 0
    for a, b in zip(ct, et):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(cl, el):
        assert torch.equal(a, b)
    for a, b in zip(cp, ep):
        assert torch.equal(a, b)


def test_steady_state_serving_captures_nothing(cuda):
    eng = _small_engine().start()
    try:
        progs = eng.programs
        assert progs.captures == len(progs.prefill_buckets) + 1
        replays = progs.replays
        for _ in range(2):
            outs = [h.result(timeout=60) for h in
                    [eng.submit([3, 1 + i] * (i + 1), 9, temperature=0.7,
                                top_k=5, seed=i) for i in range(7)]]
            assert all(len(o) == 9 for o in outs)
        assert progs.captures == len(progs.prefill_buckets) + 1
        assert progs.replays > replays
        stats = eng.stats()
        assert stats["captures"] == progs.captures
        assert stats["replays"] == progs.replays
    finally:
        eng.stop()
    # a restart warms the same graphs: still nothing new
    eng.start()
    try:
        assert len(eng.generate([1, 2, 3], 4)) == 4
        assert eng.programs.captures == len(eng.programs.prefill_buckets) + 1
    finally:
        eng.stop()


def test_engine_error_path_reseeds_pools_in_place_and_serves(cuda):
    eng = _small_engine().start()
    try:
        progs = eng.programs
        ptrs = [t.data_ptr() for t in tree_leaves(progs.pools)]
        want = eng.generate([5, 6, 7], 6).tolist()
        real = progs.decode
        failed = []

        def fail_once(*a, **kw):
            if not failed:
                failed.append(1)
                raise RuntimeError("injected decode failure")
            return real(*a, **kw)

        progs.decode = fail_once
        with pytest.raises(RuntimeError, match="injected"):
            eng.submit([1, 2], 5).result(timeout=60)
        progs.decode = real
        assert [t.data_ptr() for t in tree_leaves(progs.pools)] == ptrs
        assert eng.generate([5, 6, 7], 6).tolist() == want
        assert progs.captures == len(progs.prefill_buckets) + 1
    finally:
        eng.stop()


@pytest.mark.parametrize("window", [None, 8], ids=["linear", "rolling"])
def test_captured_generate_equals_the_host_loop(window, cuda):
    """``generate``'s replayed loop against ``sample_sequence`` (eager
    ``rnn_time_step``), greedy and sampled (step i of both reads noise
    slice i), on a float32 stack; a second call with the same key
    captures nothing; every loop reads the net's own parameters."""
    from deeplearning4j_tpu_torch.models.decode import generate
    from deeplearning4j_tpu_torch.models.zoo import transformer_char_lm
    from deeplearning4j_tpu_torch.utils.sampling import sample_sequence

    net = transformer_char_lm(vocab_size=29, d_model=64, n_heads=4,
                              layers=2, max_cache=64, window=window,
                              n_kv_heads=2 if window else None)
    prompt = np.random.default_rng(3).integers(0, 29, (4, 6))
    got = generate(net, prompt, 30, temperature=0.0)
    ref = sample_sequence(net, prompt, 30, temperature=0.0)
    np.testing.assert_array_equal(got, ref)
    (gen,) = net._graph_cache.values()
    assert gen.captures == 1 and gen.replays == 29
    np.testing.assert_array_equal(
        generate(net, prompt, 30, temperature=0.0), got)
    assert gen.captures == 1 and gen.replays == 58
    a = generate(net, prompt, 30, temperature=0.9, top_k=7, rng=3)
    np.testing.assert_array_equal(
        generate(net, prompt, 30, temperature=0.9, top_k=7, rng=3), a)
    np.testing.assert_array_equal(
        sample_sequence(net, prompt, 30, temperature=0.9, top_k=7, rng=3), a)
    np.testing.assert_array_equal(
        generate(net, prompt, 30, temperature=0.9, top_k=1, rng=3), got)
    assert len(net._graph_cache) == 3
    assert ([t.data_ptr() for t in tree_leaves(net._graph_params)]
            == [t.data_ptr() for t in tree_leaves(net.params)])


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
    # and tf32x3 routes) is the torch reduction's, up to summation order
    dq2, delta = fa._launch_dq(q, k, v, do, o, lse, causal, window)
    ref = fa._row_delta(o, do)
    torch.cuda.synchronize()
    assert torch.equal(dq2, dq)
    assert (delta - ref).abs().max().item() <= 1e-5 * max(
        1.0, ref.abs().max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=["f32", "bf16", "f16"])
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
    dQ and dK/dV, as does D = 64; D = 16 and 32 take mma.sync.  float32
    takes tf32x3 for the forward, dQ and dK/dV at D = 64 and 128, and the
    CUDA cores at other D (40)."""
    for dtype in (torch.bfloat16, torch.float16):
        for d in (64, 128):
            for kernel in ("fwd", "dq", "dkv"):
                assert fa.kernel_path(kernel, dtype, d) == "wgmma"
        assert fa.kernel_path("fwd", dtype, 32) == "mma_sync"
        assert fa.kernel_path("dq", dtype, 32) == "mma_sync"
        assert fa.kernel_path("dkv", dtype, 40) == "cuda_cores"
    for d in (64, 128):
        assert fa.kernel_path("fwd", torch.float32, d) == "tf32x3"
        assert fa.kernel_path("dq", torch.float32, d) == "tf32x3"
        assert fa.kernel_path("dkv", torch.float32, d) == "tf32x3"
    for kernel in ("fwd", "dq", "dkv"):
        assert fa.kernel_path(kernel, torch.float32, 40) == "cuda_cores"


# the float32 forward at the chip run's shapes (B cut to 2)
F32_FWD_CASES = {
    # name: (B, T, H, D, causal, window)
    "causal": (2, 2048, 8, 128, True, None),
    "full": (2, 2048, 8, 128, False, None),
    "window256": (2, 2048, 8, 128, True, 256),
    "t1000": (2, 1000, 8, 128, True, None),
    "d64": (2, 2048, 8, 64, True, None),
    "t1_d128": (2, 1, 8, 128, True, None),
    "t1_d64": (2, 1, 8, 64, False, None),
}


@pytest.mark.parametrize("name", sorted(F32_FWD_CASES))
def test_flash_f32_forward_matches_plain(name, cuda):
    """The tf32x3 forward against the plain forward: o and lse within
    1e-4, and the same bits on a second call."""
    b, t, h, d, causal, window = F32_FWD_CASES[name]
    assert fa.kernel_path("fwd", torch.float32, d) == "tf32x3"
    q, k, v, _ = _flash_inputs(21, b, t, h, d, torch.float32)
    o, lse = fa.flash_fwd(q, k, v, causal=causal, window=window)
    o2, lse2 = fa.flash_fwd(q, k, v, causal=causal, window=window)
    ro, rlse = fa.flash_attention_plain_fwd(q, k, v, causal, window)
    torch.cuda.synchronize()
    assert (o - ro).abs().max().item() <= TOL[torch.float32]
    assert (lse - rlse).abs().max().item() <= TOL[torch.float32]
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


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
    """One bfloat16 or float16 eager ``fit`` step of a small char-LM on
    the card launches each flash kernel once per attention layer and the
    prologue once per residual block, and never runs a plain version (a
    captured step's launches: ``test_captured_fit_equals_eager``)."""
    from deeplearning4j_tpu_torch.models.zoo import transformer_char_lm

    net = transformer_char_lm(vocab_size=29, d_model=64, n_heads=4,
                              layers=2, compute_dtype=compute_dtype)
    net._capture = False    # eager: each step's launches tick the counts
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


def _bn_err(a, ref):
    """Largest difference relative to the reference's largest magnitude,
    absolute below 1 (a single row normalises to exactly 0 and its dx is
    0 up to rounding)."""
    return ((a.float() - ref.float()).abs().max()
            / ref.float().abs().max().clamp_min(1.0)).item()


BN_REDUCTION_CASES = {
    # name: (rows, C, dtype, offset in elements); ResNet-50's BatchNorm
    # inputs at batch 128 in bfloat16 first
    "stem": (1605632, 64, torch.bfloat16, 0),
    "stage1_64": (401408, 64, torch.bfloat16, 0),
    "stage1_256": (401408, 256, torch.bfloat16, 0),
    "stage2_128": (100352, 128, torch.bfloat16, 0),
    "stage2_512": (100352, 512, torch.bfloat16, 0),
    "stage3_256": (25088, 256, torch.bfloat16, 0),
    "stage3_1024": (25088, 1024, torch.bfloat16, 0),
    "stage4_512": (6272, 512, torch.bfloat16, 0),
    "stage4_2048": (6272, 2048, torch.bfloat16, 0),
    "stem_f32": (1605632, 64, torch.float32, 0),
    "m1": (1, 64, torch.bfloat16, 0),             # variance 0
    "c1": (300001, 1, torch.float32, 0),
    "ragged_bf16": (101101, 130, torch.bfloat16, 0),  # the scalar path
    "ragged_f16": (101101, 130, torch.float16, 0),
    "unaligned": (50000, 64, torch.bfloat16, 1),  # x one element off
    "single_chunk": (200, 64, torch.bfloat16, 0),
}


@pytest.mark.parametrize("name", list(BN_REDUCTION_CASES))
def test_batch_norm_reductions_match_plain(name, cuda):
    """The two reductions (moments with the merge folded in, grad sums
    with theirs) on their grid, through the training forward and
    backward: the moments to 1e-5 and the outputs and dgamma, dbeta to
    ``TOL``; 16-byte vectors exactly where C is whole vectors and x and g
    are aligned."""
    m, c, dtype, offset = BN_REDUCTION_CASES[name]
    g = torch.Generator().manual_seed(29)
    base = (torch.randn(m * c + offset, generator=g) * 2 + 3).to("cuda",
                                                                 dtype)
    gbase = torch.randn(m * c + offset, generator=g).to("cuda", dtype)
    x, gy = base[offset:].view(m, c), gbase[offset:].view(m, c)
    gamma = (torch.randn(c, generator=g) + 1).cuda()
    beta = torch.randn(c, generator=g).cuda()
    vec = bn._vec(x, gy)
    assert vec == (1 if offset or c % (16 // x.element_size()) else
                   16 // x.element_size())
    bx, by, rpc, n_chunks = bn.chunking(m, c, vec, bn._sm_count(x.device))
    if name == "single_chunk":
        assert n_chunks == 1
    y, mean, var, inv = bn.bn_train_fwd_2d(x, gamma, beta, 1e-5)
    dx, dgamma, dbeta = bn.bn_train_bwd_2d(x, gy, gamma, mean, inv)
    ry, rmean, rvar, rinv = bn.bn_train_fwd_plain(x, gamma, beta, 1e-5)
    rdx, rdgamma, rdbeta = bn.bn_train_bwd_plain(x, gy, gamma, rmean, rinv)
    torch.cuda.synchronize()
    for got, ref in ((mean, rmean), (var, rvar), (inv, rinv)):
        assert _bn_err(got, ref) <= 1e-5
    for got, ref in ((y, ry), (dx, rdx), (dgamma, rdgamma),
                     (dbeta, rdbeta)):
        assert _bn_err(got, ref) <= TOL[dtype]
    if m == 1:
        assert not var.any()


def test_batch_norm_reductions_repeat_and_leave_counters_at_zero(cuda):
    """Calls back to back, without a sync, at C = 64 (one channel slice)
    and C = 2048 (32 slices) and again: every repeat gives the same bits,
    and the arrival counters are zero when the stream is done."""
    cases = [_bn_inputs(31, 1605632, 64, torch.bfloat16),
             _bn_inputs(37, 6272, 2048, torch.bfloat16)]
    runs = []
    for i in (0, 1, 0, 1, 0):
        x, gy, gamma, beta = cases[i]
        y, mean, var, inv = bn.bn_train_fwd_2d(x, gamma, beta, 1e-5)
        runs.append((i, (y, mean, var) + bn.bn_train_bwd_2d(
            x, gy, gamma, mean, inv)))
    torch.cuda.synchronize()
    assert bn._arrivals and all(not t.any() for t in bn._arrivals.values())
    for i in (0, 1):
        same = [r for j, r in runs if j == i]
        for other in same[1:]:
            for a, b in zip(same[0], other):
                assert torch.equal(a, b)
        x, gy, gamma, beta = cases[i]
        ry, rmean, rvar, rinv = bn.bn_train_fwd_plain(x, gamma, beta, 1e-5)
        assert _bn_err(same[0][1], rmean) <= 1e-5
        assert _bn_err(same[0][0], ry) <= TOL[torch.bfloat16]


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
    """A small ResNet in bfloat16 or float16 on the card, eager: ``output``
    launches the inference kernel once per BatchNorm layer and ``fit`` the
    training kernels once each, with no plain-version call."""
    from deeplearning4j_tpu_torch.models.zoo import resnet50

    net = resnet50(height=16, width=16, channels=3, n_classes=4,
                   blocks=(1, 1), stem_stride=1, init_channels=8,
                   compute_dtype=compute_dtype)
    net._capture = False    # eager: each call's launches tick the counts
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

_ALL = ("f32", "bf16", "f16")
LRN_CASES = {
    # name: (rows, C, n, x's offset in elements into its buffer, the types
    # that take the vector route; the others take the staged one)
    "lrn1": (373248, 96, 5, 0, _ALL),
    "lrn2": (86528, 256, 5, 0, _ALL),
    "ragged": (1001, 130, 5, 0, ()),
    "narrow": (777, 3, 5, 0, ()),
    "n7": (5000, 96, 7, 0, ("bf16", "f16")),      # float32: 2h = 6 > 4
    "even_n": (999, 64, 4, 0, _ALL),
    "channel_tiles": (37, 5000, 5, 0, ()),
    "one_channel": (64, 1, 3, 0, ()),
    "c8": (4099, 8, 5, 0, _ALL),                  # one vector a row
    "c16": (4099, 16, 3, 0, _ALL),
    "unaligned": (999, 96, 5, 1, ()),
    "n9": (2001, 96, 9, 0, ("bf16", "f16")),      # 2h = 8: V in 16 bits
    "n17": (2001, 96, 17, 0, ()),                 # 2h = 16 > 8
    "one_row": (1, 96, 5, 0, _ALL),
}
_LRN_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16,
               "f16": torch.float16}


def _lrn_inputs(seed, rows, c, dtype, offset=0):
    """x (``offset`` elements into its buffer) and gy on the card."""
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(rows, c, generator=g) * 3).to("cuda", dtype)
    if offset:
        buf = torch.empty(rows * c + offset, device="cuda", dtype=dtype)
        buf[offset:].view(rows, c).copy_(x)
        x = buf[offset:].view(rows, c)
    gy = torch.randn(rows, c, generator=g).to("cuda", dtype)
    return x, gy


@pytest.mark.parametrize("dtype", sorted(_LRN_DTYPES))
@pytest.mark.parametrize("name", sorted(LRN_CASES))
def test_lrn_kernels_match_plain(name, dtype, cuda):
    rows, c, n, offset, vector = LRN_CASES[name]
    x, gy = _lrn_inputs(21, rows, c, _LRN_DTYPES[dtype], offset)
    want = "vector" if dtype in vector else "staged"
    assert lrn.route(x, n) == lrn.route(x, n, gy) == want
    before = (lrn.fwd_counts.launches, lrn.bwd_counts.launches)
    y = lrn.lrn_fwd_2d(x, 2.0, n, 1e-2, 0.75)
    dx = lrn.lrn_bwd_2d(x, gy, 2.0, n, 1e-2, 0.75)
    assert (lrn.fwd_counts.launches,
            lrn.bwd_counts.launches) == (before[0] + 1, before[1] + 1)
    ry = lrn.lrn_fwd_plain(x, 2.0, n, 1e-2, 0.75)
    rdx = lrn.lrn_bwd_plain(x, gy, 2.0, n, 1e-2, 0.75)
    torch.cuda.synchronize()
    assert y.dtype == dx.dtype == _LRN_DTYPES[dtype]
    assert _scaled_err(y, ry) <= TOL[_LRN_DTYPES[dtype]]
    assert _scaled_err(dx, rdx) <= TOL[_LRN_DTYPES[dtype]]


@pytest.mark.parametrize("name", ["lrn1", "lrn2"])
def test_lrn_is_the_same_run_to_run(name, cuda):
    rows, c, _, _, _ = LRN_CASES[name]
    x, gy = _lrn_inputs(4, rows, c, torch.bfloat16)
    runs = [(lrn.lrn_fwd_2d(x, 2.0, 5, 1e-4, 0.75),
             lrn.lrn_bwd_2d(x, gy, 2.0, 5, 1e-4, 0.75)) for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_lrn_vector_entry_refuses_what_its_route_does_not_take(cuda):
    """The vector kernels' C entry points return an error without
    launching where ``route`` would pick the staged kernels."""
    lrn.build()
    stream = torch.cuda.current_stream().cuda_stream
    buf = torch.zeros(64 * 96 + 1, device="cuda", dtype=torch.bfloat16)
    out = torch.empty(64, 96, device="cuda", dtype=torch.bfloat16)
    for x, c, half in ((buf[1:].view(64, 96), 96, 2),   # unaligned
                       (buf[:64 * 96].view(64, 96), 90, 2),  # C % 8
                       (buf[:64 * 96].view(64, 96), 96, 5)):  # 2h > 8
        rc = lrn._launchers["dl4j_lrn_fwd_vec"](
            x.data_ptr(), out.data_ptr(), 1, 64, c, half, 2.0, 1e-4, 0.75,
            stream)
        assert rc != 0
    torch.cuda.synchronize()


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
    """A small AlexNet on the card, eager: ``output`` launches the forward
    kernel once per LRN layer and ``fit`` both kernels once each, with no
    plain-version call."""
    from deeplearning4j_tpu_torch.models.zoo import alexnet

    net = alexnet(height=67, width=67, n_classes=5,
                  compute_dtype=compute_dtype)
    net._capture = False    # eager: each call's launches tick the counts
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


# ------------------------------------------------------ captured steps
def _capture_net(name):
    """The nets the captured-step tests train: a small char-LM in
    bfloat16 (flash kernels, prologue), a conv net with BatchNorm and
    LRN in bfloat16, and an MLP with dropout under Adam with a step
    learning-rate schedule (the scalars and keys change every replay)."""
    from deeplearning4j_tpu_torch.models.sequential import MultiLayerNetwork
    from deeplearning4j_tpu_torch.models.zoo import transformer_char_lm
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers import (
        BatchNormalization, ConvolutionLayer, DenseLayer,
        LocalResponseNormalization, OutputLayer, SubsamplingLayer,
    )

    if name == "transformer":
        return transformer_char_lm(vocab_size=29, d_model=64, n_heads=4,
                                   layers=2, compute_dtype="bfloat16")
    b = NeuralNetConfiguration.builder().seed(5)
    if name == "conv":
        conf = (b.updater("nesterovs", learning_rate=0.05).list()
                .compute_dtype("bfloat16")
                .layer(ConvolutionLayer(n_out=16, kernel_size=(3, 3),
                                        activation="identity"))
                .layer(BatchNormalization(activation="relu"))
                .layer(LocalResponseNormalization(n=5))
                .layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
                .layer(DenseLayer(n_out=32, activation="relu"))
                .layer(OutputLayer(n_out=4))
                .set_input_type(InputType.convolutional(12, 12, 3)).build())
    else:
        conf = (b.updater("adam", learning_rate=0.02, lr_policy="step",
                          lr_policy_decay_rate=0.5, lr_policy_steps=2.0)
                .list()
                .layer(DenseLayer(n_in=20, n_out=64, activation="relu",
                                  dropout=0.5))
                .layer(DenseLayer(n_in=64, n_out=64, activation="relu",
                                  dropout=0.5))
                .layer(OutputLayer(n_in=64, n_out=4)).build())
    return MultiLayerNetwork(conf).init()


def _capture_batches(name, n, seed=0, batch=6):
    rs = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        if name == "transformer":
            ids = rs.integers(0, 29, (2, 40))
            out.append((ids, np.eye(29, dtype=np.float32)[np.roll(ids, -1,
                                                                   1)]))
            continue
        shape = (batch, 12, 12, 3) if name == "conv" else (batch, 20)
        out.append((rs.random(shape, np.float32),
                    np.eye(4, dtype=np.float32)[rs.integers(0, 4, batch)]))
    return out


def _eager_twin(net):
    """A copy of ``net`` that runs its bodies eagerly, with the same key
    stream position (``clone`` starts a fresh stream, as the
    reference's)."""
    twin = net.clone()
    twin._keys._gen.set_state(net._keys._gen.get_state())
    twin._capture = False
    return twin


def _all_state(net):
    return (tree_leaves(net.params) + tree_leaves(net.updater_state)
            + tree_leaves(net.net_state))


def _assert_same_state(a, b):
    for x, y in zip(_all_state(a), _all_state(b), strict=True):
        assert torch.equal(x, y)


CAPTURE_LAUNCHES = {
    "transformer": {"flash_fwd": 2, "flash_dq": 2, "flash_dkv": 2,
                    "prologue": 4},
    "conv": {"bn_train_fwd": 1, "bn_train_bwd": 1, "lrn_fwd": 1,
             "lrn_bwd": 1},
    "mlp": {},
}


@pytest.mark.parametrize("name", sorted(CAPTURE_LAUNCHES))
def test_captured_fit_equals_eager(name, cuda):
    """Six ``fit`` steps on distinct host batches, with no sync between
    them (the pinned ring at work), through the captured graph and
    eagerly from the same state: every loss, param, updater-state and
    running-stat tensor equal bit for bit.  One capture, five replays;
    the graph holds each kernel's launches of one step."""
    a = _capture_net(name)
    b = _eager_twin(a)
    data = _capture_batches(name, 6)
    losses = []
    for x, y in data:
        a.fit(x, y)
        b.fit(x, y)
        losses.append((a.score_value, b.score_value))
    assert all(la == lb for la, lb in losses), losses
    _assert_same_state(a, b)
    graphs = a._step_graphs
    assert (graphs.captures, graphs.replays) == (1, 5)
    assert b._step_graphs is None
    assert list(graphs.graph_launches().values()) == [CAPTURE_LAUNCHES[name]]


def test_dropout_masks_change_from_replay_to_replay(cuda):
    """Replays of one batch draw new masks from new keys: their losses
    differ, and equal the eager steps' one for one."""
    a = _capture_net("mlp")
    b = _eager_twin(a)
    x, y = _capture_batches("mlp", 1)[0]
    got, want = [], []
    for _ in range(4):
        a.fit(x, y)
        b.fit(x, y)
        got.append(a.score_value)
        want.append(b.score_value)
    assert got == want and len(set(got)) == 4


def test_fit_scanned_equals_fit_on_the_card(cuda):
    """``fit_scanned`` over 10 batches in windows of 4 (two full windows
    and a tail of two), each batch a replay of the captured step, equals
    captured ``fit`` over the same batches bit for bit, with one capture
    between them."""
    a = _capture_net("mlp")
    b = _eager_twin(a)
    b._capture = True
    data = _capture_batches("mlp", 10, seed=3)
    for x, y in data:
        a.fit(x, y)
    b.fit_scanned(data, scan_steps=4)
    assert b.iteration == a.iteration == 10
    assert b.score_value == a.score_value
    _assert_same_state(a, b)
    assert b._step_graphs.captures == 1
    assert b._step_graphs.replays == 9


def test_steady_state_training_captures_nothing(cuda):
    net = _capture_net("conv")
    for x, y in _capture_batches("conv", 4):
        net.fit(x, y)
    graphs = net._step_graphs
    assert (graphs.captures, graphs.replays) == (1, 3)
    small = _capture_batches("conv", 2, batch=3)
    for x, y in small:
        net.fit(x, y)
    assert graphs.captures == 2
    for x, y in _capture_batches("conv", 2) + small:
        net.fit(x, y)
    assert (graphs.captures, graphs.replays) == (2, 8)


def test_replaced_trees_are_recaptured_and_read(cuda):
    """Replacing the params, the updater state or the layer state (new
    tensors, as ``init``, a load or ``interop`` make) recaptures the step,
    and the new graph reads the new tensors: the same as an eager twin
    given the same replacement."""
    from deeplearning4j_tpu_torch.models.common import tree_clone

    a = _capture_net("conv")
    b = _eager_twin(a)
    other = _capture_net("conv")
    for x, y in _capture_batches("conv", 2, seed=9):
        other.fit(x, y)
    data = _capture_batches("conv", 6, seed=4)
    for i, (x, y) in enumerate(data):
        if i == 2:
            for net in (a, b):
                net.params = tree_clone(other.params)
        if i == 3:
            for net in (a, b):
                net.updater_state = tree_clone(other.updater_state)
        if i == 4:
            for net in (a, b):
                net.net_state = tree_clone(other.net_state)
        a.fit(x, y)
        b.fit(x, y)
        assert a.score_value == b.score_value
    _assert_same_state(a, b)
    assert a._step_graphs.captures == 4


def test_captured_output_equals_eager(cuda):
    """``output`` replays a captured inference graph on both facades: the
    same values as the eager forward, a copy the next call does not
    touch, and no new capture for new values of one shape."""
    from deeplearning4j_tpu_torch.models.zoo import resnet50

    for net, x in ((_capture_net("conv"), _capture_batches("conv", 2)),
                   (resnet50(height=16, width=16, channels=3, n_classes=4,
                             blocks=(1, 1), stem_stride=1, init_channels=8,
                             compute_dtype="bfloat16"),
                    [(np.random.default_rng(s).random((4, 16, 16, 3),
                                                      np.float32), None)
                     for s in range(2)])):
        eager = _eager_twin(net)
        first = net.output(x[0][0])
        second = net.output(x[1][0])
        again = net.output(x[0][0])
        assert torch.equal(first, eager.output(x[0][0]))
        assert torch.equal(second, eager.output(x[1][0]))
        assert torch.equal(first, again) and not torch.equal(first, second)
        assert (net._step_graphs.captures, net._step_graphs.replays) == \
            (1, 2)


def test_batch_norm_counters_under_replay(cuda):
    """Each captured train graph owns its BatchNorm arrival counters,
    zeroed by a node of the graph: after each replay they are zero and
    the step equals the eager one; two nets' graphs (captured on the
    shared capture stream) hold distinct buffers; warm-ups on the one
    side stream do not grow the per-stream cache.  (Between a graph's
    replays its counters may hold another graph's intermediates: the
    graphs of one net share a memory pool, and each replay zeroes its
    counters before their first use.)"""
    from deeplearning4j_tpu_torch.models.zoo import resnet50

    def tiny(seed):
        return resnet50(height=16, width=16, channels=3, n_classes=4,
                        blocks=(1, 1), stem_stride=1, init_channels=8,
                        compute_dtype="bfloat16", seed=seed)

    nets = [tiny(1), tiny(2)]
    twins = [_eager_twin(net) for net in nets]
    x = np.random.default_rng(0).random((6, 16, 16, 3)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[[0, 1, 2, 3, 0, 1]]
    nets[0].fit(x, y)
    twins[0].fit(x, y)
    streams = len(bn._arrivals)
    for net, twin in zip(nets, twins):
        for b in (2, 3, 5, 6):      # new shapes: a warm-up each
            for _ in range(2):      # then a replay
                net.fit(x[:b], y[:b])
                twin.fit(x[:b], y[:b])
            assert net.score_value == twin.score_value
            scratch = list(net._step_graphs.programs.values())[-1] \
                .graph.scratch
            assert scratch
            assert all(int(t.abs().sum()) == 0 for t in scratch)
        _assert_same_state(net, twin)
    assert len(bn._arrivals) == streams
    ptrs = [{t.data_ptr() for p in net._step_graphs.programs.values()
             for t in p.graph.scratch} for net in nets]
    assert len(ptrs[0]) == len(ptrs[1]) == 4
    assert not ptrs[0] & ptrs[1]


def test_a_collected_cycle_does_not_break_a_capture(cuda):
    """A dropped net lives on in a reference cycle (net -> graph cache ->
    program -> body -> net) holding its captured graph, its staging ring
    and a pinned buffer last copied on the default stream, and would be
    collected at the first allocation inside another capture's body,
    which invalidates that capture.  The collector is held off for the
    capture, so the net is freed after it, and the capture stands."""
    import gc

    from deeplearning4j_tpu_torch.backend.device import (
        capture_graph, warm_on_side_stream,
    )

    x = torch.ones(1 << 16, device="cuda")
    armed = []

    def body():
        if armed:
            gc.set_threshold(1, 1, 1)   # collect at the next allocation
        junk = [[] for _ in range(1000)]
        return x * 2 + len(junk)

    old = gc.get_threshold()
    try:
        for _ in range(3):
            armed.clear()
            warm_on_side_stream(body, x.device)
            gc.collect()
            # the dead net's objects stay in the youngest generation, so
            # the first collection in the body takes them
            gc.disable()
            dead = _capture_net("conv")
            for bx, by in _capture_batches("conv", 2):
                dead.fit(bx, by)
            dead.pinned = torch.ones(1 << 16, pin_memory=True)
            x.copy_(dead.pinned, non_blocking=True)
            assert dead._step_graphs.captures == 1
            del dead, bx, by
            gc.set_threshold(10 ** 6)   # nothing collected before the body
            gc.enable()
            armed.append(True)
            graph, out = capture_graph(body)
            gc.set_threshold(*old)
            graph.replay()
            assert torch.equal(out, torch.full_like(x, 1002.0))
    finally:
        gc.set_threshold(*old)
        gc.enable()


def test_a_failed_capture_raises(cuda):
    """A body that syncs with the host cannot be captured: ``fit``
    raises, and nothing carries on eagerly.  The warm-up before the
    capture stands as the step it was: the iteration, loss and params
    are those of one eager step, and the program leaves the cache, so a
    retry is one more such step."""
    net = _capture_net("mlp")
    twin = _eager_twin(net)
    body = net._train_body

    def syncing(**kw):
        loss = body(**kw)
        float(loss)           # a device-to-host read inside the capture
        return loss

    net._train_body = syncing
    for i, (x, y) in enumerate(_capture_batches("mlp", 2)):
        with pytest.raises(RuntimeError):
            net.fit(x, y)
        twin.fit(x, y)
        assert net.iteration == twin.iteration == i + 1
        assert net.score_value == twin.score_value
        _assert_same_state(net, twin)
        assert not net._step_graphs.programs
    assert net._step_graphs.captures == 0


# ------------------------------------------------------------ recurrent
def _lstm_lm(tbptt, hidden=32, vocab=29):
    from deeplearning4j_tpu_torch.models.zoo import graves_lstm_char_lm

    return graves_lstm_char_lm(vocab_size=vocab, hidden=hidden, tbptt=tbptt,
                               lr=0.01)


def _one_hot_batches(n, t, vocab=29, batch=6, seed=0):
    rs = np.random.default_rng(seed)
    eye = np.eye(vocab, dtype=np.float32)
    out = []
    for _ in range(n):
        ids = rs.integers(0, vocab, (batch, t))
        out.append((eye[ids], eye[np.roll(ids, -1, 1)]))
    return out


@pytest.mark.parametrize("t,tbptt,captures,iterations", [
    (50, 50, 1, 6), (21, 8, 2, 18)], ids=["one_window", "three_windows"])
def test_captured_lstm_fit_equals_eager(t, tbptt, captures, iterations,
                                        cuda):
    """The GravesLSTM char-LM's ``fit``, one window a batch (T 50) and
    TBPTT's 8 + 8 + 5 (a program for each window length, the carries
    through their static buffers), captured and eager from one state:
    every loss and state tensor equal bit for bit."""
    a = _lstm_lm(tbptt)
    b = _eager_twin(a)
    for x, y in _one_hot_batches(6, t):
        a.fit(x, y)
        b.fit(x, y)
        assert a.score_value == b.score_value
    _assert_same_state(a, b)
    graphs = a._step_graphs
    assert a.iteration == b.iteration == iterations
    assert (graphs.captures, graphs.replays) == (captures,
                                                 iterations - captures)


def test_captured_lstm_graph_fit_equals_eager(cuda):
    """A ``ComputationGraph`` of two GravesLSTMs read by
    ``LastTimeStepVertex`` into a dense head, with a features mask."""
    from deeplearning4j_tpu_torch.models.graph import ComputationGraph
    from deeplearning4j_tpu_torch.models.vertices import LastTimeStepVertex
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import GravesLSTM, OutputLayer

    conf = (NeuralNetConfiguration.builder().seed(3)
            .updater("rmsprop", learning_rate=0.01).graph()
            .add_inputs("in")
            .add_layer("l0", GravesLSTM(n_in=29, n_out=32), "in")
            .add_layer("l1", GravesLSTM(n_in=32, n_out=32), "l0")
            .add_vertex("last", LastTimeStepVertex(), "l1")
            .add_layer("out", OutputLayer(n_in=32, n_out=5), "last")
            .set_outputs("out").build())
    a = ComputationGraph(conf).init()
    b = _eager_twin(a)
    rs = np.random.default_rng(1)
    for x, _ in _one_hot_batches(5, 12, seed=2):
        y = np.eye(5, dtype=np.float32)[rs.integers(0, 5, 6)]
        fm = (np.arange(12)[None] < rs.integers(3, 13, (6, 1))).astype(
            np.float32)
        a.fit(x, y, fmask=fm)
        b.fit(x, y, fmask=fm)
        assert a.score_value == b.score_value
    _assert_same_state(a, b)
    assert (a._step_graphs.captures, a._step_graphs.replays) == (1, 4)


@pytest.mark.parametrize("name", ["GravesLSTM", "GravesBidirectionalLSTM"])
def test_lstm_on_the_card_matches_the_cpu(name, cuda):
    """The layer's forward (masked) and its gradients on the card against
    the CPU on the same weights, float32 (full float32 matmuls)."""
    from deeplearning4j_tpu_torch.backend.device import resolve_device
    from deeplearning4j_tpu_torch.nn import layers

    resolve_device("cuda")      # pins full float32
    layer = getattr(layers, name)(n_in=77, n_out=200)
    params = layer.init(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    x = torch.randn(16, 50, 77, generator=g)
    w = torch.randn(16, 50, 200, generator=g)
    mask = (torch.arange(50)[None] < torch.randint(
        10, 51, (16, 1), generator=g)).float()
    out = {}
    for dev in ("cpu", "cuda"):
        p = {k: v.to(dev, copy=True).requires_grad_(True)
             for k, v in params.items()}
        y = layer.apply(p, x.to(dev), mask=mask.to(dev))
        (y * w.to(dev)).sum().backward()
        out[dev] = (y.detach().cpu(), {k: v.grad.cpu() for k, v in p.items()})
    assert (out["cuda"][0] - out["cpu"][0]).abs().max().item() <= 1e-4
    for k, gc in out["cpu"][1].items():
        err = (out["cuda"][1][k] - gc).abs().max().item()
        assert err <= 1e-4 * max(1.0, gc.abs().max().item()), (k, err)


def test_captured_lstm_generate_equals_eager(cuda):
    """``generate`` over LSTM carries: the replayed loop (h, c as graph
    state) against ``sample_sequence`` (eager ``rnn_time_step``), greedy
    and sampled; a second call captures nothing."""
    from deeplearning4j_tpu_torch.models.decode import generate
    from deeplearning4j_tpu_torch.utils.sampling import sample_sequence

    net = _lstm_lm(50)
    prompt = np.random.default_rng(3).integers(0, 29, (4, 6))
    got = generate(net, prompt, 30, temperature=0.0)
    np.testing.assert_array_equal(
        got, sample_sequence(net, prompt, 30, temperature=0.0))
    (gen,) = net._graph_cache.values()
    assert gen.captures == 1 and gen.replays == 29
    np.testing.assert_array_equal(
        generate(net, prompt, 30, temperature=0.0), got)
    assert gen.captures == 1
    a = generate(net, prompt, 30, temperature=0.9, top_k=7, rng=3)
    np.testing.assert_array_equal(
        sample_sequence(net, prompt, 30, temperature=0.9, top_k=7, rng=3), a)
