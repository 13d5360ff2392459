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


def _small_net(seed=12345):
    from deeplearning4j_tpu_torch.models.zoo import transformer_char_lm

    return transformer_char_lm(vocab_size=29, d_model=64, n_heads=4,
                               layers=2, compute_dtype="bfloat16",
                               seed=seed)


def _small_engine(capture=None, slots=4, net=None, **kw):
    from deeplearning4j_tpu_torch.generation import GenerationEngine

    eng = GenerationEngine(net or _small_net(), slots=slots, page_size=16,
                           max_context=64, prefill_buckets=(16, 32), **kw)
    eng._capture = capture     # internal: False runs the programs eagerly
    return eng


def _small_programs(capture):
    """The small engine's programs on their own pools, not started."""
    from deeplearning4j_tpu_torch.generation.programs import (
        GenerationPrograms,
    )

    return GenerationPrograms(_small_net(), slots=4, pages_per_slot=4,
                              page_size=16, num_pages=17,
                              prefill_buckets=(16, 32), capture=capture)


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
        progs = _small_programs(capture)
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


def _keep_serving(eng, stop, errors, n=12):
    """Client load until ``stop``: the decode thread replays its graphs."""
    import threading

    def client(i):
        while not stop.is_set():
            try:
                out = eng.generate([1 + i, 2, 3], n)
                assert len(out) == n
            except Exception as e:          # reported by the test
                errors.append(e)
                return

    threads = [threading.Thread(target=client, args=(i,)) for i in range(2)]
    for th in threads:
        th.start()
    return threads


def test_page_transport_round_trips_beside_a_replaying_decode(cuda):
    """``read_page``/``write_page`` copy a page bit for bit into the live
    pools, in place, while the decode thread replays its captured graph
    over the same pools; the two pages are held out of the allocator."""
    import threading

    eng = _small_engine(num_pages=4 * 4 + 3)
    held = eng.cache.alloc(2)            # before the decode thread runs
    eng.start()
    stop, errors = threading.Event(), []
    try:
        progs = eng.programs
        ptrs = [x.data_ptr() for x in tree_leaves(progs.pools)]
        want = eng.generate([7, 8, 9], 12).tolist()
        threads = _keep_serving(eng, stop, errors)
        g = torch.Generator().manual_seed(0)

        def noise(tree):
            if isinstance(tree, dict):
                return {k: noise(v) for k, v in tree.items()}
            return torch.randn(tree.shape, generator=g).to(tree.dtype)

        payload = noise(progs.read_page(held[0]))
        for _ in range(20):
            progs.write_page(held[0], payload)
            back = progs.read_page(held[0])
            progs.write_page(held[1], back)
            again = progs.read_page(held[1])
            for a, b, c in zip(tree_leaves(payload), tree_leaves(back),
                               tree_leaves(again)):
                assert torch.equal(a, b) and torch.equal(b, c)
        stop.set()
        for th in threads:
            th.join(60)
        assert not errors, errors
        assert [x.data_ptr() for x in tree_leaves(progs.pools)] == ptrs
        assert eng.generate([7, 8, 9], 12).tolist() == want
        assert progs.captures == len(progs.prefill_buckets) + 1
    finally:
        stop.set()
        eng.stop()


def test_a_version_is_captured_while_another_replays(cuda):
    """``deploy`` captures the new version's graphs on this thread while
    the decode thread replays the old version's: no request fails, the
    new version captures one graph a program, and it then serves the
    tokens of an engine started on it."""
    import threading

    net_b = _small_net(seed=7)
    eng = _small_engine()
    eng.start()
    stop, errors = threading.Event(), []
    try:
        old = eng.programs
        threads = _keep_serving(eng, stop, errors)
        long = [eng.submit([4, 5, 6], 40) for _ in range(3)]
        mv = eng.deploy("default", net_b)
        new = eng.programs
        assert new is not old
        assert new.captures == len(new.prefill_buckets) + 1
        assert mv.detector.compile_count == new.captures
        assert all(len(h.result(timeout=60)) == 40 for h in long)
        stop.set()
        for th in threads:
            th.join(60)
        assert not errors, errors
        got = eng.generate([3, 1, 4], 10).tolist()
        assert new.captures == len(new.prefill_buckets) + 1
    finally:
        stop.set()
        eng.stop()
    fresh = _small_engine(net=net_b).start()
    try:
        assert fresh.generate([3, 1, 4], 10).tolist() == got
    finally:
        fresh.stop()


def test_paged_attention_at_the_prefix_hit_shape(cuda):
    """A prefix hit's suffix prefill: 16 queries at positions 512..527
    over 528 cached keys (bfloat16, pages of 16), against the plain
    version; two calls give the same bits."""
    rng = np.random.default_rng(3)
    g = torch.Generator().manual_seed(3)
    ps, maxp, pages = 16, 40, 16 * 40 + 1
    q = torch.randn(1, 16, 8, 128, generator=g)
    pk = torch.randn(pages * ps, 8, 128, generator=g)   # flattened pools
    pv = torch.randn(pages * ps, 8, 128, generator=g)
    block = np.zeros((1, maxp), np.int32)
    block[0, :33] = rng.permutation(np.arange(1, pages))[:33]
    qpos = (512 + np.arange(16, dtype=np.int32))[None]
    args = ([x.to("cuda", torch.bfloat16) for x in (q, pk, pv)]
            + [torch.from_numpy(block).cuda(), torch.from_numpy(qpos).cuda()])
    out = pa.paged_decode_attention(*args, page_size=ps)
    again = pa.paged_decode_attention(*args, page_size=ps)
    ref = pa.paged_attention_plain(*args, ps)
    assert torch.equal(out, again)
    assert (out.float() - ref.float()).abs().max().item() <= \
        TOL[torch.bfloat16]


def _serving_mlp():
    from deeplearning4j_tpu_torch.models.sequential import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers.dense import (
        DenseLayer, OutputLayer,
    )

    conf = (NeuralNetConfiguration.builder().seed(12345)
            .updater("sgd", learning_rate=0.1).list()
            .layer(DenseLayer(n_in=64, n_out=256, activation="relu"))
            .layer(OutputLayer(n_in=256, n_out=10, loss="mcxent",
                               activation="softmax")).build())
    return MultiLayerNetwork(conf).init()


@pytest.mark.parametrize("max_batch,buckets", [(8, 4), (512, 10)])
def test_serving_engine_captures_nothing_after_warm_up(max_batch, buckets,
                                                       cuda):
    """The ServingEngine's warm-up captures one ``output`` graph a bucket
    through the version's detector; traffic then replays them and
    captures nothing.  A policy with more buckets than the net's graph
    cache holds (8) recaptures on every pass of its LRU, and the
    detector counts every one of those captures."""
    from deeplearning4j_tpu_torch.models.capture import GRAPH_CACHE_SIZE
    from deeplearning4j_tpu_torch.serving import ServingEngine

    net = _serving_mlp()
    eng = ServingEngine(net, max_batch=max_batch, max_wait_ms=0.5,
                        example=np.zeros((64,), np.float32)).start()
    rs = np.random.RandomState(0)
    xs = [rs.rand(int(r), 64).astype(np.float32)
          for r in (1, 3, 8, 5, 2, 7, 300, 129, 1, 8)]
    try:
        mv = eng.models.active("default")
        assert mv.detector.compile_count == buckets
        assert net._step_graphs.captures == buckets
        outs = [eng.predict(x) for x in xs]
        extra = net._step_graphs.captures - buckets
        assert mv.detector.compile_count == buckets + extra
    finally:
        eng.stop()
    if buckets <= GRAPH_CACHE_SIZE:
        assert extra == 0
    else:
        assert extra > 0
    net._capture = False
    for x, out in zip(xs, outs):
        np.testing.assert_allclose(out, net.output(x).cpu().numpy(),
                                   rtol=1e-5, atol=1e-6)


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


# ------------------------------------------- the guard, resume and server
def _guarded_conv(**stab):
    """The ``conv`` capture net (bf16, BatchNorm, LRN, Nesterov) under
    ``training_stability(**stab)``."""
    from deeplearning4j_tpu_torch.models.sequential import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers import (
        BatchNormalization, ConvolutionLayer, DenseLayer,
        LocalResponseNormalization, OutputLayer, SubsamplingLayer,
    )

    conf = (NeuralNetConfiguration.builder().seed(5)
            .updater("nesterovs", learning_rate=0.05)
            .training_stability(**stab).list()
            .compute_dtype("bfloat16")
            .layer(ConvolutionLayer(n_out=16, kernel_size=(3, 3),
                                    activation="identity"))
            .layer(BatchNormalization(activation="relu"))
            .layer(LocalResponseNormalization(n=5))
            .layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
            .layer(DenseLayer(n_out=32, activation="relu"))
            .layer(OutputLayer(n_out=4))
            .set_input_type(InputType.convolutional(12, 12, 3)).build())
    return MultiLayerNetwork(conf).init()


def test_poisoned_step_replays_the_guarded_graph(cuda):
    """A poisoned batch (same shape and type) replays the guarded graph
    without a capture, and the step is a bit-exact no-op on params,
    updater state and running stats; the scale halves on the device and
    the eager twin agrees bit for bit."""
    from deeplearning4j_tpu_torch.resilience import (
        FaultInjector, inject_faults,
    )

    a = _guarded_conv(loss_scaling="dynamic", loss_scale=2.0 ** 8,
                      loss_scale_growth_interval=100, check_every=100)
    b = _eager_twin(a)
    data = _capture_batches("conv", 5)
    for x, y in data[:3]:
        a.fit(x, y)
        b.fit(x, y)
    key = "__stability__"
    before = [t.clone() for t in tree_leaves(a.params)
              + tree_leaves({k: v for k, v in a.updater_state.items()
                             if k != key}) + tree_leaves(a.net_state)]
    with inject_faults(FaultInjector().poison_gradients(
            "0", at_step=3, until_step=4)):
        a.fit(*data[3])
    with inject_faults(FaultInjector().poison_gradients(
            "0", at_step=3, until_step=4)):
        b.fit(*data[3])
    after = (tree_leaves(a.params)
             + tree_leaves({k: v for k, v in a.updater_state.items()
                            if k != key}) + tree_leaves(a.net_state))
    assert all(torch.equal(x, y) for x, y in zip(before, after))
    st = a.updater_state[key]
    assert float(st["nonfinite_total"]) == 1.0
    assert float(st["loss_scale"]) == 2.0 ** 7
    assert (a._step_graphs.captures, a._step_graphs.replays) == (1, 3)
    a.fit(*data[4])
    b.fit(*data[4])
    _assert_same_state(a, b)


def test_restore_into_a_captured_net_then_replay(cuda, tmp_path):
    """A restore writes the checkpoint into the tensors a captured graph
    holds: the replays that follow equal the uninterrupted run bit for
    bit, with no capture after the first."""
    from deeplearning4j_tpu_torch.resilience import CheckpointManager

    a = _capture_net("conv")
    ref = _eager_twin(a)
    ref._capture = True
    data = _capture_batches("conv", 6, seed=2)
    cm = CheckpointManager(str(tmp_path), save_every_steps=2,
                           async_save=False)
    a.fit(data[:4], checkpoint_manager=cm)
    leaves = _all_state(a)
    a.fit(data[4:])                  # steps 5 and 6, to be undone
    assert cm.restore(a)[3] == 4 and a.iteration == 4
    assert all(x is y for x, y in zip(_all_state(a), leaves, strict=True))
    a.fit(data[4:])
    ref.fit(data)
    _assert_same_state(a, ref)
    assert a.score_value == ref.score_value
    assert a._step_graphs.captures == 1
    cm.close()


def test_retried_step_equals_an_unfailed_one(cuda):
    """A transient fault before step 2 retries it with the key stream
    set back: dropout masks and all, the captured run equals an unfailed
    captured run bit for bit."""
    from deeplearning4j_tpu_torch.resilience import (
        FaultInjector, RetryPolicy, inject_faults,
    )

    a = _capture_net("mlp")
    ref = _eager_twin(a)
    ref._capture = True
    data = _capture_batches("mlp", 5, seed=6)
    rp = RetryPolicy(max_retries=2, base_delay_s=0.0, jitter=0.0)
    with inject_faults(FaultInjector().fail_at_step(
            2, component="MultiLayerNetwork", transient=True)):
        a.fit(data, retry_policy=rp)
    ref.fit(data)
    assert rp.retries == 1 and a.iteration == 5
    _assert_same_state(a, ref)
    assert a.score_value == ref.score_value


def test_inference_server_sse_ids_equal_engine_generate(cuda):
    """``POST /generate`` with ``stream: true`` on the card: one SSE event
    a token, ids equal to ``engine.generate`` without HTTP."""
    import json
    import urllib.request

    from deeplearning4j_tpu_torch.generation import GenerationEngine
    from deeplearning4j_tpu_torch.models.zoo import transformer_char_lm
    from deeplearning4j_tpu_torch.serving import ServingEngine
    from deeplearning4j_tpu_torch.streaming import InferenceServer

    lm = transformer_char_lm(vocab_size=29, d_model=64, n_heads=4, layers=2,
                             compute_dtype="bfloat16", max_cache=64)
    gen = GenerationEngine(lm, slots=4, page_size=16, max_context=64,
                           prefill_buckets=(16,)).start()
    eng = ServingEngine(_capture_net("mlp"), max_batch=4,
                        example=np.zeros(20, np.float32))
    server = InferenceServer(engine=eng, generation=gen)
    try:
        eng.start()
        url = f"http://127.0.0.1:{server.start()}/generate"
        prompts = np.random.default_rng(8).integers(0, 29, (4, 9)).tolist()
        for p in prompts:
            req = urllib.request.Request(url, data=json.dumps(
                {"prompt": p, "max_tokens": 20, "stream": True}).encode())
            with urllib.request.urlopen(req, timeout=60) as r:
                events = [json.loads(line[6:]) for line in
                          r.read().decode().split("\n\n")
                          if line.startswith("data: ")]
            assert events[-1]["done"] is True
            got = [e["token"] for e in events[:-1]]
            assert got == gen.generate(p, 20).tolist()
    finally:
        server.stop()
        eng.stop()
        gen.stop()


# ------------------------------------------ introspection, numerics, kerneldiff
def _with_policies(net, **policies):
    import dataclasses

    net.conf = dataclasses.replace(net.conf, **policies)
    return net


@pytest.mark.parametrize("name", ["transformer", "conv"])
@pytest.mark.parametrize("policies", [
    {"introspection": {}},
    {"introspection": {}, "numerics": {"interval": 2}}])
def test_captured_introspection_step_equals_eager(name, policies, cuda):
    """With introspection (and the interval-gated ledger) on, the
    captured step equals the eager one bit for bit — params, updater
    state and the statistics vectors — and equals the same net without
    the policies in its parameters; after the warm-up of each program
    (one, or two with the ledger's skip) nothing is captured."""
    plain = _capture_net(name)
    a = _with_policies(plain.clone(), **policies)
    a._keys._gen.set_state(plain._keys._gen.get_state())
    b = _eager_twin(a)
    data = _capture_batches(name, 6)
    for x, y in data:
        a.fit(x, y)
        b.fit(x, y)
        plain.fit(x, y)
    # bit for bit, NaN included (the ledger's loss-scale slot is NaN
    # without the guard)
    for x, y in zip(_all_state(a), _all_state(b), strict=True):
        assert torch.equal(x.view(torch.int32) if x.dtype == torch.float32
                           else x, y.view(torch.int32)
                           if y.dtype == torch.float32 else y)
    for x, y in zip(tree_leaves(a.params), tree_leaves(plain.params)):
        assert torch.equal(x, y)
    want = 2 if "numerics" in policies else 1
    assert a._step_graphs.captures == want
    from deeplearning4j_tpu_torch.observability import introspection

    h = introspection.harvest_model(a)
    assert h["iteration"] == 5
    assert all(np.isfinite(e["norm"]) for e in h["gradient_stats"].values())


def test_kerneldiff_sweep_on_the_card(cuda):
    """Every kernel of the registry on the card against the float64
    references over the reference's full grid: within the dtype budgets
    (a kernel's error propagates and fails the test)."""
    from deeplearning4j_tpu_torch.observability import kerneldiff

    report = kerneldiff.run_sweep(full=True, device="cuda")
    assert report["summary"]["untrusted"] == [], \
        kerneldiff.format_report(report)
    for k in report["kernels"].values():
        assert all(c["status"] in ("pass", "tolerance_only")
                   for c in k["configs"])


# ------------------------------------------------ the step profiler, fleet
def _profiled_lm(device):
    from deeplearning4j_tpu_torch.models.zoo import transformer_char_lm

    return transformer_char_lm(vocab_size=29, d_model=64, n_heads=4,
                               layers=2, compute_dtype="bfloat16", seed=7,
                               device=device)


def _lm_batch(seed=0, b=2, t=40):
    ids = np.random.default_rng(seed).integers(0, 29, (b, t))
    return ids, np.eye(29, dtype=np.float32)[np.roll(ids, -1, 1)]


def test_captured_step_cost_equals_the_cpu_count(cuda, tmp_path):
    """A captured step's cost is taken in its warm-up run (the genuine
    first step, before the capture), kernels included, and equals the
    CPU count of the same net: the matmuls through the dispatcher, the
    flash kernels as their wrappers report them once."""
    from deeplearning4j_tpu_torch.observability import StepProfiler

    costs = []
    for device in ("cuda", "cpu"):
        net = _profiled_lm(device)
        with StepProfiler(str(tmp_path / device), use_torch_profiler=False):
            for _ in range(3):
                net.fit(*_lm_batch())
        costs.append(net._instrumented["train_step"].detector.last_cost)
        if device == "cuda":
            assert net._step_graphs.captures == 1
    card, host = costs
    assert card["flops"] > 0 and card["kernel_flops"] > 0
    assert card["flops"] == host["flops"]
    assert card["kernel_flops"] == host["kernel_flops"]


def test_profiler_installed_after_the_capture_on_the_card(cuda, tmp_path):
    """A profiler installed after the step was captured sees replays
    only: no cost and no flops for them, one flight record saying why;
    after ``capture.release`` the next capture counts the step: the
    flops of a net profiled from its first step."""
    from deeplearning4j_tpu_torch.models import capture
    from deeplearning4j_tpu_torch.observability import (
        StepProfiler, get_flight_recorder,
    )

    early = _profiled_lm("cuda")
    with StepProfiler(str(tmp_path / "early"), use_torch_profiler=False):
        early.fit(*_lm_batch())
    want = early._instrumented["train_step"].detector.last_cost
    net = _profiled_lm("cuda")
    for _ in range(2):
        net.fit(*_lm_batch())
    step = net._instrumented["train_step"]
    step.detector.warn = lambda msg: None
    with StepProfiler(str(tmp_path / "late"), use_torch_profiler=False):
        net.fit(*_lm_batch())
        assert step.detector.last_cost is None
        capture.release(net)
        net.fit(*_lm_batch())
        net.fit(*_lm_batch())
    torch.cuda.synchronize()
    evs = [e for e in get_flight_recorder().events()
           if e.kind == "profile_cost_unavailable"
           and e.to_dict()["fn"] == "MultiLayerNetwork.train_step"]
    assert len(evs) >= 1
    assert net._step_graphs.captures == 1
    got = step.detector.last_cost
    assert got["flops"] == want["flops"] > 0
    assert got["kernel_flops"] == want["kernel_flops"] > 0


def test_event_timed_step_under_the_profiler(cuda, tmp_path):
    """On the card the profiled step is timed by CUDA events around its
    replay: the capture's MFU is unclamped in (0, 1], its Chrome trace
    names the flash kernels replayed from the graph, and the train step
    counts one compile (its capture) however many steps follow."""
    import json
    import os
    import re

    from deeplearning4j_tpu_torch.observability import (
        MetricsRegistry, StepProfiler, get_flight_recorder, set_registry,
    )

    old = set_registry(MetricsRegistry())
    try:
        net = _profiled_lm("cuda")
        prof = StepProfiler(str(tmp_path), capture_step=4).install()
        for _ in range(6):
            net.fit(*_lm_batch())
        prof.uninstall()
        from deeplearning4j_tpu_torch.observability import get_registry

        assert get_registry().get_value(
            "dl4j_compiles_total", fn="MultiLayerNetwork.train_step") == 1
        caps = [e.to_dict() for e in get_flight_recorder().events()
                if e.kind == "profile_capture" and e.to_dict()[
                    "path"].startswith(str(tmp_path))]
        assert len(caps) == 1 and caps[0]["reason"] == "step:4"
        meta = json.load(open(os.path.join(caps[0]["path"],
                                           "capture.json")))
        assert meta["timed_on"] == "cuda_events"
        assert meta["flops"] > 0 and 0.0 < meta["mfu_unclamped"] <= 1.0
        assert meta["seconds"] > 0
        trace = json.load(open(meta["torch_trace"]))
        names = {e.get("name", "") for e in trace["traceEvents"]}
        # demangled: "void (anonymous namespace)::flash_fwd_wgmma<...>"
        assert any(re.search(r"\bflash_(fwd|dq|dkv)", n) for n in names)
    finally:
        set_registry(old)


def test_subprocess_replica_on_cuda_answers_generate(cuda):
    """One supervisor-spawned replica on the card (its own CUDA context,
    weights, pools and graphs) answers ``/generate`` with the ids of an
    in-process engine on the same seed.  The in-process engine builds
    the kernels first; the replica loads them."""
    import json
    import urllib.request

    from deeplearning4j_tpu_torch.fleet import ReplicaSupervisor
    from deeplearning4j_tpu_torch.generation import GenerationEngine
    from deeplearning4j_tpu_torch.observability import MetricsRegistry

    eng = GenerationEngine(_profiled_lm("cuda"), slots=4, page_size=16,
                           max_context=64, prefill_buckets=(16,),
                           prefix_cache=True).start()
    prompt = list(range(1, 13))
    try:
        want = eng.submit(prompt, 8).result(timeout=120)
    finally:
        eng.stop(drain=False)
    sup = ReplicaSupervisor(
        warmup_timeout_s=300, registry=MetricsRegistry(),
        replica_args={"vocab": 29, "d_model": 64, "n_heads": 4,
                      "layers": 2, "model_seed": 7,
                      "compute_dtype": "bfloat16", "slots": 4,
                      "page_size": 16, "max_context": 64,
                      "prefill_buckets": "16"})
    try:
        rp = sup.start_replica("g0")
        body = json.dumps({"prompt": prompt, "max_tokens": 8}).encode()
        req = urllib.request.Request(
            f"{rp.url}/generate", data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            env = json.loads(resp.read().decode())
        assert env["replica"] == "g0"
        assert env["tokens"] == want
    finally:
        sup.stop_all()


# ------------------------------------------- pretraining, MoE, solvers
@pytest.mark.parametrize("shape", [(7,), (128, 500), (33, 17, 5)])
def test_device_key_draws_equal_the_generators(shape, cuda):
    """``bernoulli_probs`` and ``normal`` from a device key on the card
    equal the generator's draws on the CPU: the Bernoulli samples except
    where the uniform lies within 1e-6 of the probability (none in
    practice: the uniforms are exact), the normals to float32 rounding of
    ``log`` and ``cos``."""
    from deeplearning4j_tpu_torch.backend import rng as rng_mod

    g = torch.Generator().manual_seed(4)
    probs = torch.rand(shape, generator=g)
    host = torch.Generator().manual_seed(991)
    key = rng_mod.device_key(991, cuda)
    s_cpu = rng_mod.bernoulli_probs(host, probs)
    s_gpu = rng_mod.bernoulli_probs(key, probs.to(cuda)).cpu()
    u = rng_mod.uniform(host, shape, "cpu")
    far = (u - probs).abs() >= 1e-6
    assert torch.equal(s_cpu[far], s_gpu[far])
    z_cpu = rng_mod.normal(host, shape, "cpu")
    z_gpu = rng_mod.normal(key, shape, cuda).cpu()
    assert (z_cpu - z_gpu).abs().max().item() <= 1e-5


def test_captured_pretrain_equals_eager(cuda):
    """A DBN's layerwise pretraining through the captured programs (one a
    RBM) equals the eager run bit for bit from the same key stream."""
    from deeplearning4j_tpu_torch.models.zoo import dbn

    kw = dict(n_in=64, hidden=(48, 32), n_classes=4, device="cuda")
    net, eager = dbn(**kw), dbn(**kw)
    eager._capture = False
    rs = np.random.RandomState(0)
    batches = [rs.rand(32, 64).astype(np.float32) for _ in range(3)]
    net.pretrain(batches, epochs=2)
    eager.pretrain(batches, epochs=2)
    for a, b in zip(tree_leaves(net.params), tree_leaves(eager.params)):
        assert torch.equal(a, b)
    assert net._step_graphs.captures == 2
    assert net._step_graphs.replays == 2 * (2 * 3 - 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_dispatch_equals_a_one_hot_einsum(dtype, cuda):
    """The MoE forward's scatter and gather on the card against the
    one-hot dispatch and combine in float32 over the same routing and
    weights (exact routing: bfloat16 tokens, float32 einsums)."""
    from deeplearning4j_tpu_torch.nn.layers import MoELayer

    layer = MoELayer(n_in=64, n_out=64, num_experts=4, hidden=128,
                     capacity_factor=1.0, name="moe")
    p = {k: v.to(cuda, dtype) for k, v in layer.init(
        torch.Generator().manual_seed(3)).items()}
    for k in ("b_up", "b_down"):
        p[k] = 0.1 * torch.randn(p[k].shape, generator=torch.Generator(
        ).manual_seed(5)).to(cuda, dtype)
    x = torch.randn(2048, 64, generator=torch.Generator().manual_seed(6)
                    ).to(cuda, dtype)
    r = layer.route(p, x)
    E, C = 4, r.capacity
    slot = torch.zeros(2048, E, C, device=cuda)
    kept = r.kept.nonzero()[:, 0]
    slot[kept, r.expert[kept], r.pos[kept].long()] = 1.0
    f = {k: v.float() for k, v in p.items()}
    ein = torch.einsum("tec,td->ecd", slot, x.float())
    hdn = torch.relu(torch.einsum("ecd,edh->ech", ein, f["W_up"])
                     + f["b_up"][:, None])
    out = torch.einsum("ech,eho->eco", hdn, f["W_down"]) + f["b_down"][:, None]
    want = torch.einsum("tec,eco->to", slot, out) * r.gate.float()[:, None] \
        + x.float()
    got = layer.apply(p, x).float()
    tol = TOL[dtype] * max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= tol
    assert int((~r.kept).sum()) > 0       # some tokens were dropped


def test_captured_solver_value_grad_equals_eager(cuda):
    """A solver ``fit`` (L-BFGS, 10 iterations) through the captured
    value/grad program equals the eager evaluation's bit for bit: loss,
    parameters, and one capture for two solves."""
    from deeplearning4j_tpu_torch.models.zoo import dbn
    import dataclasses

    kw = dict(n_in=64, hidden=(48,), n_classes=4, device="cuda")
    net, eager = dbn(**kw), dbn(**kw)
    for n in (net, eager):
        n.conf = dataclasses.replace(n.conf, optimization_algo="lbfgs",
                                     num_iterations=10)
    eager._capture = False
    rs = np.random.RandomState(1)
    for _ in range(2):
        x = rs.rand(64, 64).astype(np.float32)
        y = np.eye(4, dtype=np.float32)[rs.randint(0, 4, 64)]
        net.fit(x, y)
        eager.fit(x, y)
        assert net.score_value == eager.score_value
    for a, b in zip(tree_leaves(net.params), tree_leaves(eager.params)):
        assert torch.equal(a, b)
    assert net._step_graphs.captures == 1


@pytest.fixture
def deterministic_cudnn():
    """LeNet's cuDNN weight gradients differ run to run unless cuDNN is
    deterministic (``chip_smoke.py``'s lenet phase)."""
    torch.backends.cudnn.deterministic = True
    yield
    torch.backends.cudnn.deterministic = False


@pytest.mark.parametrize("n", [40, 48], ids=["padded", "whole"])
def test_native_fed_captured_fit_equals_its_plain_twin(n, cuda,
                                                       deterministic_cudnn):
    """LeNet's captured ``fit`` over two epochs fed by
    ``NativeBatchDataSetIterator`` (the C++ batcher) against a twin fed by
    the batcher's plain version: the same batches, so the same parameters,
    updater state and losses bit for bit; one capture for the full batch
    signature and one for the padded, masked batch (40 rows in batches of
    16), and none in the second epoch."""
    from deeplearning4j_tpu_torch.datasets import (
        DataSet, NativeBatchDataSetIterator,
    )
    from deeplearning4j_tpu_torch.models.zoo import lenet

    rs = np.random.RandomState(3)
    data = DataSet(rs.rand(n, 784).astype(np.float32),
                   np.eye(10, dtype=np.float32)[rs.randint(0, 10, n)])
    nets = [lenet(device="cuda"), lenet(device="cuda")]
    its = [NativeBatchDataSetIterator(data, 16, seed=5),
           NativeBatchDataSetIterator(data, 16, seed=5, force_python=True)]
    caps = []
    for _ in range(2):
        for net, it in zip(nets, its):
            net.fit(it)
        caps.append(nets[0]._step_graphs.captures)
        assert nets[0].score_value == nets[1].score_value
    assert caps == ([2, 2] if n == 40 else [1, 1])
    assert nets[1]._step_graphs.captures == caps[-1]
    for part in ("params", "updater_state"):
        for a, b in zip(tree_leaves(getattr(nets[0], part)),
                        tree_leaves(getattr(nets[1], part))):
            assert torch.equal(a, b)


def test_convolution_listener_on_a_captured_fit(cuda, deterministic_cudnn,
                                                tmp_path):
    """``ConvolutionalIterationListener`` rendering every second step of
    LeNet's captured ``fit`` adds no capture and leaves the run equal to
    one without it bit for bit."""
    from deeplearning4j_tpu_torch.models.zoo import lenet
    from deeplearning4j_tpu_torch.ui import ConvolutionalIterationListener

    net, plain = lenet(device="cuda"), lenet(device="cuda")
    rs = np.random.RandomState(4)
    listener = ConvolutionalIterationListener(
        rs.rand(1, 784).astype(np.float32), tmp_path, frequency=2)
    net.set_listeners(listener)
    for _ in range(6):
        x = rs.rand(32, 784).astype(np.float32)
        y = np.eye(10, dtype=np.float32)[rs.randint(0, 10, 32)]
        net.fit(x, y)
        plain.fit(x, y)
        assert net.score_value == plain.score_value
    assert net._step_graphs.captures == 1 and net._step_graphs.replays == 5
    assert len(listener.rendered) == 3
    for a, b in zip(tree_leaves(net.params), tree_leaves(plain.params)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 96),
                                           (False, None)])
def test_ulysses_through_the_flash_kernel_matches_plain(causal, window,
                                                        cuda):
    """Ulysses' local attention launches the flash forward kernel on the
    card (once a call, the slots' head groups as one batch); it equals
    the same call with the helpers off (the plain attention) and exact
    attention on the whole sequence."""
    from deeplearning4j_tpu_torch import helpers
    from deeplearning4j_tpu_torch.backend import mesh as tmesh
    from deeplearning4j_tpu_torch.nn.layers.attention import (
        dot_product_attention,
    )
    from deeplearning4j_tpu_torch.parallel import ring_self_attention

    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(2, 512, 8, 64, generator=g).to(cuda,
                                                           torch.bfloat16)
               for _ in range(3))
    mesh = tmesh.default_mesh(seq=4, devices=["cuda"] * 4)
    before = helpers.kernel_counts()["flash_fwd"].launches
    got = ring_self_attention(q, k, v, mesh, causal=causal, window=window,
                              impl="ulysses")
    torch.cuda.synchronize()
    assert helpers.kernel_counts()["flash_fwd"].launches == before + 1
    with helpers.helpers_disabled():
        plain = ring_self_attention(q, k, v, mesh, causal=causal,
                                    window=window, impl="ulysses")
        exact = dot_product_attention(q, k, v, causal=causal, window=window)
    tol = TOL[torch.bfloat16]
    assert (got.float() - plain.float()).abs().max().item() < tol
    assert (got.float() - exact.float()).abs().max().item() < tol


def test_seq_axis_layer_outside_a_step_launches_flash(cuda):
    """A seq_axis char-LM outside a sequence-parallel step has one slot:
    its forward launches the flash kernel as the plain net's does (a
    launch a layer, in the warm-up and in the capture), and their
    outputs are equal."""
    from deeplearning4j_tpu_torch import helpers
    from deeplearning4j_tpu_torch.models import zoo

    kw = dict(vocab_size=32, d_model=128, n_heads=2, layers=2,
              compute_dtype="bfloat16", device=cuda)
    a = zoo.transformer_char_lm(seq_axis="seq", **kw)
    b = zoo.transformer_char_lm(**kw)
    x = np.random.default_rng(0).integers(0, 32, (2, 256))

    def launches_of(net):
        before = helpers.kernel_counts()["flash_fwd"].launches
        out = net.output(x)
        torch.cuda.synchronize()
        return out, helpers.kernel_counts()["flash_fwd"].launches - before

    out_a, n_a = launches_of(a)
    out_b, n_b = launches_of(b)
    assert n_a == n_b >= 2            # a launch a layer at least
    assert torch.equal(out_a, out_b)


# the bf16 kernels' window against the plain versions': the change of
# all the params, relative in norm (the four-slot case below).  On the
# H100 it reads 1.472e-02; with the flash output zeroed 1.15, with it
# 1 % high 2.0e-02 (within bf16's scale, so not caught)
WRAPPER_CHANGE_RTOL = 5e-2


def four_slot_window_change_error(cuda):
    """A four-slot ParallelWrapper window of a small bf16 char-LM,
    captured, eager and on the plain versions (helpers off), SGD:
    asserts the captured window's launches and that it equals the eager
    one bit for bit; returns ``||dc - dp|| / ||dp||``, ``dc`` and ``dp``
    the params' change from their initial values on the kernels and on
    the plain versions."""
    from deeplearning4j_tpu_torch import helpers
    from deeplearning4j_tpu_torch.backend import mesh as tmesh
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.models import capture as cap
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper

    rng = np.random.default_rng(0)
    batches = [DataSet(rng.integers(0, 32, (2, 128)),
                       np.eye(32, dtype=np.float32)[
                           rng.integers(0, 32, (2, 128))])
               for _ in range(8)]
    out, init = {}, None
    for mode in ("captured", "eager", "plain"):
        net = zoo.transformer_char_lm(vocab_size=32, d_model=128,
                                      n_heads=2, layers=2, updater="sgd",
                                      lr=1e-2, compute_dtype="bfloat16",
                                      device=cuda)
        if init is None:
            init = net.params_to_vector().astype(np.float64)
        net._capture = mode == "captured"
        pw = ParallelWrapper(net, workers=4, mesh=tmesh.default_mesh(
            data=4, devices=["cuda"] * 4))
        if mode == "plain":
            with helpers.helpers_disabled():
                pw.fit(iter(batches))
        else:
            pw.fit(iter(batches))
        out[mode] = net.params_to_vector().astype(np.float64)
        if mode == "captured":
            graphs = cap.step_graphs(pw._staged)
            assert graphs.captures == 1 and graphs.replays == 1
            launches = next(iter(graphs.graph_launches().values()))
            assert launches["flash_fwd"] == 4 * 2
            assert launches["prologue"] == 4 * 4
    np.testing.assert_array_equal(out["captured"], out["eager"])
    dc, dp = out["captured"] - init, out["plain"] - init
    return float(np.linalg.norm(dc - dp) / np.linalg.norm(dp))


def test_four_slot_wrapper_window_captured_equals_eager_and_plain(cuda):
    """The four-slot window (``four_slot_window_change_error``): captured
    equals eager bit for bit, launches the flash and prologue kernels for
    every replica, and its change of the params agrees with the plain
    versions' at bf16's scale.  SGD keeps the change linear in the
    gradient, so a wrong kernel moves the ratio by its own size."""
    rel = four_slot_window_change_error(cuda)
    print(f"kernels' window against the plain versions': the change's "
          f"relative error {rel:.3e}")
    assert rel < WRAPPER_CHANGE_RTOL


# the tensor- and pipeline-parallel steps against the plain versions':
# the change of all the params, relative in norm, at bf16's scale (the
# four-slot window's bound above)
SLOT_STEP_CHANGE_RTOL = WRAPPER_CHANGE_RTOL


def _lm_batches(n, b, t=128, vocab=32, seed=0):
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(0, vocab, (b, t))
        out.append(DataSet(ids, np.eye(vocab, dtype=np.float32)[
            np.roll(ids, -1, 1)]))
    return out


def _small_lm(cuda):
    from deeplearning4j_tpu_torch.models import zoo

    return zoo.transformer_char_lm(vocab_size=32, d_model=128, n_heads=2,
                                   layers=2, updater="sgd", lr=1e-2,
                                   compute_dtype="bfloat16", device=cuda)


def slot_step_change_error(cuda, kind):
    """Two steps of a small bf16 char-LM under the tensor-parallel master
    (data 2 x model 2 slots) or the compiled pipeline (2 stages, 4
    microbatches), captured, eager and on the plain versions (helpers
    off), SGD: asserts the captured step's launches and that it equals
    the eager one bit for bit; returns ``||dc - dp|| / ||dp||`` (the
    params' change on the kernels and on the plain versions)."""
    from deeplearning4j_tpu_torch import helpers
    from deeplearning4j_tpu_torch.backend import mesh as tmesh
    from deeplearning4j_tpu_torch.datasets.iterator import (
        ListDataSetIterator,
    )
    from deeplearning4j_tpu_torch.models import capture as cap
    from deeplearning4j_tpu_torch.parallel import (
        DistributedNetwork, PipelineParallelTrainingMaster,
        TensorParallelTrainingMaster,
    )

    batches = _lm_batches(2, 4)
    out, init = {}, None
    for mode in ("captured", "eager", "plain"):
        net = _small_lm(cuda)
        if init is None:
            init = net.params_to_vector().astype(np.float64)
        net._capture = mode == "captured"
        if kind == "tp":
            master = TensorParallelTrainingMaster(mesh=tmesh.default_mesh(
                data=2, model=2, devices=["cuda"] * 4))

            def run():
                for ds in batches:
                    DistributedNetwork(net, master).fit(
                        ListDataSetIterator(ds, 4))
        else:
            master = PipelineParallelTrainingMaster(
                n_stages=2, n_microbatches=4, devices=["cuda"] * 2)

            def run():
                master.execute_training(net, batches)
        if mode == "plain":
            with helpers.helpers_disabled():
                run()
        else:
            run()
        out[mode] = net.params_to_vector().astype(np.float64)
        if mode == "captured":
            # the tensor-parallel step's graph is the net's own (its
            # sharded leaves are views of the net's tensors)
            graphs = cap.step_graphs(net if kind == "tp" else master._h)
            assert graphs.captures == 1 and graphs.replays == 1
            launches = next(iter(graphs.graph_launches().values()))
            # a flash call a layer (tp: the model slots' head groups side
            # by side; pipeline: a call a microbatch), a prologue a block
            per = 1 if kind == "tp" else 4
            assert launches["flash_fwd"] == 2 * per
            assert launches["flash_dq"] == 2 * per
            assert launches["prologue"] == 4 * per
            if kind == "pp":
                assert master._compiled_kind == "periodic"
    np.testing.assert_array_equal(out["captured"], out["eager"])
    dc, dp = out["captured"] - init, out["plain"] - init
    return float(np.linalg.norm(dc - dp) / np.linalg.norm(dp))


@pytest.mark.parametrize("kind", ["tp", "pp"])
def test_slot_master_step_captured_equals_eager_and_plain(kind, cuda):
    """The tensor-parallel step and the compiled pipeline step
    (``slot_step_change_error``): captured equals eager bit for bit, the
    kernels launch as the design says, and the change of the params
    agrees with the plain versions' at bf16's scale."""
    rel = slot_step_change_error(cuda, kind)
    print(f"{kind}: the change's relative error against the plain "
          f"versions {rel:.3e}")
    assert rel < SLOT_STEP_CHANGE_RTOL


def test_sync_master_batch_norm_on_the_gathered_rows(cuda):
    """The sync master's BatchNorm over four slots' rows: the training
    kernels run once on the gathered rows (the global batch's moments),
    and the step equals the plain version's and the single net's."""
    from deeplearning4j_tpu_torch import helpers
    from deeplearning4j_tpu_torch.backend import mesh as tmesh
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.datasets.iterator import (
        ListDataSetIterator,
    )
    from deeplearning4j_tpu_torch.models.sequential import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import (
        BatchNormalization, DenseLayer, OutputLayer,
    )
    from deeplearning4j_tpu_torch.parallel import (
        DistributedNetwork, SyncTrainingMaster,
    )

    def make():
        return MultiLayerNetwork(
            NeuralNetConfiguration.builder().seed(13)
            .updater("sgd", learning_rate=0.1).list()
            .layer(DenseLayer(n_in=6, n_out=64, activation="tanh"))
            .layer(BatchNormalization(n_out=64))
            .layer(OutputLayer(n_in=64, n_out=3)).build()).init(cuda)

    rng = np.random.default_rng(3)
    ds = DataSet(rng.standard_normal((256, 6)).astype(np.float32),
                 np.eye(3, dtype=np.float32)[rng.integers(0, 3, 256)])
    got = {}
    for mode in ("kernels", "plain", "single"):
        net = make()
        net._capture = False
        before = helpers.kernel_counts()["bn_train_fwd"].launches
        if mode == "single":
            net.fit(ds.features, ds.labels)
        else:
            master = SyncTrainingMaster(mesh=tmesh.default_mesh(
                data=4, devices=["cuda"] * 4))
            if mode == "plain":
                with helpers.helpers_disabled():
                    DistributedNetwork(net, master).fit(
                        ListDataSetIterator(ds, 256))
            else:
                DistributedNetwork(net, master).fit(
                    ListDataSetIterator(ds, 256))
        torch.cuda.synchronize()
        n = helpers.kernel_counts()["bn_train_fwd"].launches - before
        assert n == (0 if mode == "plain" else 1), (mode, n)
        got[mode] = (net.params_to_vector(),
                     net.net_state["layer_1"]["mean"].cpu().numpy())
    for mode in ("plain", "single"):
        np.testing.assert_allclose(got["kernels"][0], got[mode][0],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["kernels"][1], got[mode][1],
                                   rtol=1e-5, atol=1e-6)


# ------------------------------------------------ the NLP embedding stack

def _nlp_corpus(n=300, seed=7):
    rs = np.random.RandomState(seed)
    words = [f"w{i}" for i in range(40)]
    return [" ".join(rs.choice(words, size=rs.randint(3, 12)))
            for _ in range(n)]


def _w2v(device, hs=True, negative=0, algo="skipgram", mesh=None):
    from deeplearning4j_tpu_torch import nlp
    from deeplearning4j_tpu_torch.nlp.distributed import DistributedWord2Vec

    cls = nlp.Word2Vec if mesh is None else DistributedWord2Vec
    b = (cls.Builder().iterate(_nlp_corpus()).layer_size(32).window_size(3)
         .use_hierarchic_softmax(hs).negative_sample(negative)
         .elements_learning_algorithm(algo).learning_rate(0.1).seed(3)
         .batch_size(64))
    if mesh is None:
        b.device(device)
    else:
        b.mesh(mesh)
    return b.build()


@pytest.mark.parametrize("algo,hs,negative", [
    ("skipgram", True, 0), ("skipgram", False, 5), ("cbow", True, 0),
    ("cbow", False, 5)])
def test_nlp_captured_fit_against_eager_and_the_cpu(algo, hs, negative,
                                                    cuda):
    """A fit's steps as captured graphs (one a padded batch shape) against
    the same fit eager on the card and on the CPU (the same seeded
    weights, pairs and, from the same keys, negatives): within rounding,
    as ``index_add_`` on the card is not ordered."""
    cap, eager = _w2v("cuda", hs, negative, algo), _w2v("cuda", hs,
                                                        negative, algo)
    eager._capture = False
    host = _w2v("cpu", hs, negative, algo)
    for m in (cap, eager, host):
        m.fit()
    counts = cap.programs.counts()
    assert counts["captures"] >= 1 and counts["replays"] > 0
    assert eager.programs.counts()["captures"] == 0
    for n in ("syn0", "syn1", "syn1neg"):
        a = getattr(cap.lookup, n)
        if a is None:
            continue
        torch.testing.assert_close(a, getattr(eager.lookup, n), rtol=1e-5,
                                   atol=1e-6)
        torch.testing.assert_close(a.cpu(), getattr(host.lookup, n),
                                   rtol=1e-5, atol=1e-6)
    assert abs(cap.cum_loss - host.cum_loss) <= 1e-5 * host.cum_loss


def test_nlp_distributed_slots_on_the_card(cuda):
    from deeplearning4j_tpu_torch.backend import mesh as mesh_mod

    serial = _w2v("cuda")
    serial.fit()
    dist = _w2v("cuda", mesh=mesh_mod.default_mesh(
        data=4, devices=["cuda"] * 4))
    dist.fit()
    assert dist.programs.counts()["captures"] >= 1
    torch.testing.assert_close(dist.syn0, serial.syn0, rtol=0, atol=1e-4)


def test_nlp_glove_captured_against_the_cpu(cuda):
    from deeplearning4j_tpu_torch import nlp

    def glove(device):
        return (nlp.Glove.Builder().iterate(_nlp_corpus()).layer_size(16)
                .window_size(4).epochs(2).batch_size(128).seed(3)
                .device(device).build().fit())

    cap, host = glove("cuda"), glove("cpu")
    assert cap.programs.counts()["captures"] == 1
    torch.testing.assert_close(cap.lookup.syn0.cpu(), host.lookup.syn0,
                               rtol=1e-5, atol=1e-6)


# ------------------------------------------- graphs, clustering, Viterbi

def _planted(n=60, groups=3, edges=400, inside=0.8, seed=2, device="cpu"):
    """A planted-partition graph (the smoke's BlogCatalog stand-in, small)."""
    from deeplearning4j_tpu_torch import graphs

    rs = np.random.RandomState(seed)
    g = graphs.Graph(n)
    group = np.arange(n) % groups
    for _ in range(edges):
        a = rs.randint(n)
        pool = np.nonzero((group == group[a]) == (rs.rand() < inside))[0]
        g.add_edge(int(a), int(rs.choice(pool)))
    return g


@pytest.mark.parametrize("window", [3, 10])
def test_graphs_deepwalk_captured_fit_against_the_cpu(window, cuda):
    """DeepWalk's batch steps as captured graphs on the card against the
    same fit on the CPU (the same walks, tree, weights and pairs)."""
    from deeplearning4j_tpu_torch import graphs

    def fit(device):
        return graphs.DeepWalk(vector_size=32, window_size=window,
                               walk_length=20, walks_per_vertex=4,
                               batch_size=128, seed=5,
                               device=device).fit(_planted())

    card, host = fit("cuda"), fit("cpu")
    counts = card.programs.counts()
    assert counts["captures"] >= 1 and counts["replays"] > 0
    for n in ("syn0", "syn1"):
        torch.testing.assert_close(getattr(card.lookup, n).cpu(),
                                   getattr(host.lookup, n), rtol=1e-5,
                                   atol=1e-6)
    assert card.vertices_nearest(3, 5) == host.vertices_nearest(3, 5)


def test_clustering_lloyd_iteration_against_the_cpu(cuda):
    """One Lloyd iteration and a whole k-means on the card against the
    CPU: equal assignments, centres within rtol 1e-5, atol 1e-6."""
    from deeplearning4j_tpu_torch.clustering import KMeansClustering, kmeans

    rs = np.random.RandomState(0)
    x = (rs.randn(8, 64) * 3)[rs.randint(0, 8, 5000)] + rs.randn(5000, 64)
    pts = torch.as_tensor(x.astype(np.float32))
    c0 = pts[:8]
    card = kmeans._lloyd_step(pts.cuda(), c0.cuda())
    host = kmeans._lloyd_step(pts, c0)
    assert torch.equal(card[1].cpu(), host[1])
    torch.testing.assert_close(card[0].cpu(), host[0], rtol=1e-5, atol=1e-6)
    a = KMeansClustering(8, device="cuda").apply_to(x)
    b = KMeansClustering(8, device="cpu").apply_to(x)
    np.testing.assert_array_equal(a.assignments, b.assignments)
    np.testing.assert_allclose(a.centers, b.centers, rtol=1e-5, atol=1e-6)


def test_clustering_tsne_step_against_the_cpu(cuda):
    """Ten exact t-SNE steps on the card against the CPU from the same P
    and state, and the captured fit against the eager one on the card."""
    from deeplearning4j_tpu_torch.clustering import Tsne, tsne

    rs = np.random.RandomState(1)
    x = (rs.randn(10, 20) * 3)[rs.randint(0, 10, 400)] + rs.randn(400, 20)
    P = tsne._joint_p(x, 30.0)
    y0 = torch.as_tensor((rs.randn(400, 2) * 1e-2).astype(np.float32))
    states = []
    for dev in ("cuda", "cpu"):
        Pd = torch.as_tensor(np.asarray(P * 4, np.float32)).to(dev)
        y = y0.clone().to(dev)
        vel, gains = torch.zeros_like(y), torch.ones_like(y)
        lr = torch.tensor(200.0, device=dev)
        mom = torch.tensor(0.5, device=dev)
        for _ in range(10):
            kl = tsne.tsne_step_(Pd, y, vel, gains, lr, mom)
        states.append((y.cpu(), vel.cpu(), gains.cpu(), float(kl)))
    for a, b in zip(states[0][:3], states[1][:3]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
    assert states[0][3] == pytest.approx(states[1][3], rel=1e-4)
    cap = Tsne(n_iter=150, device="cuda")
    eager = Tsne(n_iter=150, device="cuda")
    eager._capture = False
    yc, ye = cap.embed(P), eager.embed(P)
    assert (cap.captures, cap.replays) == (1, 149)
    np.testing.assert_allclose(yc, ye, rtol=0, atol=1e-5)


@pytest.mark.parametrize("T,S", [(1000, 8), (300, 64), (5, 3)])
def test_viterbi_path_against_the_cpu(T, S, cuda):
    """The card's recursion (captured chunks where T allows) against the
    CPU's: the same path and score, bit for bit."""
    from deeplearning4j_tpu_torch.utils import viterbi

    rs = np.random.RandomState(T)
    em = np.log(rs.dirichlet(np.ones(S), T)).astype(np.float32)
    tr = np.log(rs.dirichlet(np.ones(S), S)).astype(np.float32)
    before = dict(viterbi.counts)
    pc, sc = viterbi.viterbi_decode(em, tr, device="cuda")
    ph, sh = viterbi.viterbi_decode(em, tr, device="cpu")
    assert np.array_equal(pc, ph) and sc == sh
    chunks = (T - 1) // viterbi.CHUNK
    assert viterbi.counts["captures"] - before["captures"] == int(chunks > 0)


# ------------------------------------------------ the mesh across processes
def _xchild():
    """``tests/_torch_distributed_child.py`` by its own name (this file
    runs with ``--noconftest`` on the card, where ``tests`` may name
    another package); spawned children find it on the same path."""
    import sys
    from pathlib import Path

    here = str(Path(__file__).resolve().parent)
    if here not in sys.path:
        sys.path.insert(0, here)
    import _torch_distributed_child

    return _torch_distributed_child


def test_distributed_gloo_all_gather_of_cuda_tensors(cuda):
    """Two processes on ``cuda:0`` over gloo: the mesh's cross-process
    all-gather of tensors on the card (gloo's own CUDA path) equals the
    same collective of the CPU tensors, in rank order, float32 and
    bfloat16, and the census counts each gather's bytes."""
    ranks = _xchild().spawn([{"name": "g", "kind": "cuda_gather"}],
                         backend="gloo")
    for res in ranks:
        g = res["g"]
        for dt in ("torch.float32", "torch.bfloat16"):
            device, equal, got = g[dt]
            assert device == "cuda" and equal
            np.testing.assert_array_equal(got, ranks[0]["g"][dt][2])
        # float32 and bfloat16 [3, 5], each on the card and on the CPU
        assert g["bytes"] == 2 * (15 * 4 + 15 * 2)


def test_distributed_nccl_world_of_one_psum(cuda):
    """A world of one over NCCL: the slot psum's cross-process sum is the
    slot psum bit for bit."""
    (res,) = _xchild().spawn([{"name": "p", "kind": "nccl_psum"}],
                             world=1)
    assert res["p"] == {"equal": True, "backend": "nccl"}


def test_distributed_wrapper_window_captured_on_the_card(cuda):
    """Two processes on ``cuda:0`` over gloo, each holding two of
    ``ParallelWrapper``'s four slots: the local replica steps are one
    captured graph, replayed in later windows with the exchange between
    replays; the ranks end bit for bit equal, and equal to the same
    wrapper in one process on the card (its whole window one graph)."""
    xc = _xchild()
    rs = np.random.RandomState(4)
    x = rs.rand(64, 8).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rs.randint(0, 4, 64)]
    from deeplearning4j_tpu_torch.models.sequential import (
        MultiLayerNetwork,
    )
    from deeplearning4j_tpu_torch.nn import layers as L
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration

    net = MultiLayerNetwork(
        NeuralNetConfiguration.builder().seed(21)
        .updater("adam", learning_rate=0.05).list()
        .layer(L.DenseLayer(n_in=8, n_out=16, activation="tanh"))
        .layer(L.OutputLayer(n_in=16, n_out=4, loss="mcxent",
                             activation="softmax")).build()).init(
        device="cpu")
    job = dict(name="w", kind="wrapper", conf=net.conf.to_json(),
               params={k: {n: t.numpy() for n, t in v.items()}
                       for k, v in net.params.items()},
               x=x, y=y, batch=4, freq=2, device="cuda")
    ranks = xc.spawn([job], backend="gloo")
    one = xc.wrapper(job)
    for r in ranks:
        w = r["w"]
        np.testing.assert_array_equal(w["params"], ranks[0]["w"]["params"])
        np.testing.assert_array_equal(w["params"], one["params"])
        assert w["graphs"]["captures"] == 1
        assert w["graphs"]["replays"] == 1
        assert w["graphs"]["programs"] == ["window_local"]
    assert one["graphs"]["programs"] == ["window"]


def _xjob(name, kind, n=64, batch=4, **kw):
    """A child job on the card: the parity tests' small net (Adam) and
    ``n`` rows of its data."""
    from deeplearning4j_tpu_torch.models.sequential import (
        MultiLayerNetwork,
    )
    from deeplearning4j_tpu_torch.nn import layers as L
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration

    b = (NeuralNetConfiguration.builder().seed(21)
         .updater("adam", learning_rate=0.05))
    if kw.pop("observe", False):
        b = (b.training_introspection()
             .training_numerics(interval=1, sample=7))
    net = MultiLayerNetwork(
        b.list().layer(L.DenseLayer(n_in=8, n_out=16, activation="tanh"))
        .layer(L.OutputLayer(n_in=16, n_out=4, loss="mcxent",
                             activation="softmax")).build()).init(
        device="cpu")
    rs = np.random.RandomState(4)
    return dict(name=name, kind=kind, conf=net.conf.to_json(),
                params={k: {m: t.numpy() for m, t in v.items()}
                        for k, v in net.params.items()},
                x=rs.rand(n, 8).astype(np.float32),
                y=np.eye(4, dtype=np.float32)[rs.randint(0, 4, n)],
                batch=batch, device="cuda", **kw)


def test_distributed_nccl_world_of_one_commit_and_resume(cuda, tmp_path):
    """A world of one over NCCL: the sync master commits every step
    through ``CheckpointManager`` (its barriers on a gloo group of their
    own), and a fresh net resumed from the commit ends bit for bit equal
    to the unfaulted fit."""
    (res,) = _xchild().spawn([_xjob("c", "commit", n=48, batch=8, first=2,
                                    dir=str(tmp_path / "ck"))], world=1)
    c = res["c"]
    assert c["saved"] == [1, 2] and c["steps"] == [1, 2, 3, 4, 5, 6]
    assert c["iteration"] == 6
    np.testing.assert_array_equal(c["got"], c["want"])


@pytest.mark.parametrize("master", ["sync", "wrapper"])
def test_distributed_resilient_fit_on_the_card(cuda, tmp_path, master):
    """Two processes on ``cuda:0`` over gloo: a fatal fault on every rank,
    the resume from the last commit, rank 1's retryable fault and its
    preemption notice, rank 1's lone fatal fault (the tests'
    ``resilient`` job): the resumed run equals the unfaulted one bit for
    bit on both ranks."""
    job = _xjob("r", "resilient", n=48 if master == "sync" else 64,
                batch=8 if master == "sync" else 4, master=master,
                dir=str(tmp_path / "ck"), fatal_at=3, retry_at=2,
                preempt_at=3)
    a, b = (r["r"] for r in _xchild().spawn([job], backend="gloo"))
    for r in (a, b):
        assert r["fatal"] == "InjectedFault" and r["retries"] == 1
        assert r["latest"] == 3
        np.testing.assert_array_equal(r["resumed"], r["unfaulted"])
    np.testing.assert_array_equal(a["resumed"], b["resumed"])
    assert (a["lone_fatal"][0], b["lone_fatal"][0]) == ("PeerStepFault",
                                                       "InjectedFault")


def test_distributed_statistics_on_the_card(cuda):
    """Two processes on ``cuda:0`` over gloo with the introspection
    policy and a stride-sampled ledger: the sync master's vectors equal
    on both ranks; the wrapper's local graph holds the replicas'
    statistics and its gathered ``[K, N]`` stacks equal the one-process
    wrapper's on the card bit for bit."""
    xc = _xchild()
    fit = _xjob("f", "fit", n=32, batch=32, observe=True)
    wrap = _xjob("w", "wrapper", observe=True)
    ranks = xc.spawn([fit, wrap], backend="gloo")
    one = xc.wrapper(wrap)
    for r in ranks:
        for k, v in r["f"]["observed"].items():
            np.testing.assert_array_equal(v, ranks[0]["f"]["observed"][k])
        np.testing.assert_array_equal(r["w"]["params"], one["params"])
        for k, v in r["w"]["live"].items():
            assert v.shape[0] == 4
            np.testing.assert_array_equal(v, one["live"][k])
        assert r["w"]["graphs"]["programs"] == ["window_local"]


def test_distributed_word2vec_on_the_card(cuda):
    """Two processes on ``cuda:0`` over gloo, each two of the four slots:
    ``DistributedWord2Vec`` (skip-gram HS) eager across processes, the
    ranks bit for bit, within 1e-4 of the one-process four-slot fit on
    the card (``index_add_`` is unordered there)."""
    rs = np.random.RandomState(7)
    words = [f"w{i}" for i in range(40)]
    sentences = [" ".join(rs.choice(words, 12)) for _ in range(80)]
    job = dict(name="n", kind="nlp_fit", sentences=sentences, device="cuda",
               w2v=dict(layer_size=32, window_size=3, min_word_frequency=2,
                        learning_rate=0.2, epochs=2, seed=1, batch_size=64))
    a, b = (r["n"] for r in _xchild().spawn([job], backend="gloo"))
    one = _xchild().nlp_fit(job)
    for k in a["tables"]:
        np.testing.assert_array_equal(a["tables"][k], b["tables"][k])
        np.testing.assert_allclose(a["tables"][k], one["tables"][k],
                                   atol=1e-4, rtol=0)
    assert a["captures"] == 0 and one["captures"] >= 1
