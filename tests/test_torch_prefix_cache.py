"""The port's persistent radix-tree prefix cache
(``deeplearning4j_tpu_torch/generation/prefix_cache.py``) and the engine
around it, against the JAX package on the CPU.

- The reference's tree unit tests (``tests/test_prefix_cache.py``), each
  run over the JAX package's ``PrefixCache`` on its ``PagedKVCache`` and
  over the port's, with the same numpy page transport.
- The engine: a prefix-cache hit's greedy tokens equal a cold prefill's,
  the free-on-release engine's and the JAX ``GenerationEngine(prefix_
  cache=True)``'s on one zip checkpoint; pages round-trip the host tier
  bit for bit (the programs' transport, and through a tight pool); chat
  pinning; the invalidation drill on a hot-swap and a rollback; page
  exhaustion that sheds and never evicts a pinned node.
"""

import threading
import time

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import generation as jax_generation
from deeplearning4j_tpu.models import serialization as jax_serialization
from deeplearning4j_tpu.models.zoo import transformer_char_lm as jax_lm
from deeplearning4j_tpu_torch import generation as port_generation
from deeplearning4j_tpu_torch.generation import GenerationEngine
from deeplearning4j_tpu_torch.models import serialization
from deeplearning4j_tpu_torch.serving.admission import QueueFullError

VOCAB = 29
IMPLS = {"jax": jax_generation, "torch": port_generation}


@pytest.fixture(params=sorted(IMPLS))
def gen(request):
    """The package whose ``PrefixCache``/``PagedKVCache`` a unit test runs."""
    return IMPLS[request.param]


def _checkpoint(tmp_path_factory, seed):
    """A JAX char-LM written to the reference's zip; (JAX net, port net
    restored from the zip on the CPU)."""
    jnet = jax_lm(vocab_size=VOCAB, d_model=32, n_heads=4, layers=2,
                  max_cache=128, seed=seed)
    path = tmp_path_factory.mktemp("ckpt") / f"lm{seed}.zip"
    jax_serialization.write_model(jnet, str(path))
    return jnet, serialization.load_model(path, device="cpu")


@pytest.fixture(scope="module")
def nets(tmp_path_factory):
    return _checkpoint(tmp_path_factory, 12345)


@pytest.fixture(scope="module")
def nets2(tmp_path_factory):
    return _checkpoint(tmp_path_factory, 777)


@pytest.fixture(scope="module")
def lm(nets):
    return nets[1]


@pytest.fixture(scope="module")
def engine(lm):
    eng = GenerationEngine(lm, slots=4, page_size=4, max_context=32,
                           max_queue=64, deadline_s=30.0,
                           prefix_cache=True)
    eng.start()
    yield eng
    eng.stop()


# ------------------------------------------------------- numpy-level plumbing
class NumpyTransport:
    """Unit-test pool transport: fake numpy pools, byte-exact slices."""

    def __init__(self, num_pages, page_size, feat=4):
        self.pools = {"att": {
            "pk": np.zeros((num_pages, page_size, 1, feat), np.float32),
            "pv": np.zeros((num_pages, page_size, 1, feat), np.float32)}}

    def page_bytes(self):
        c = self.pools["att"]
        return (c["pk"].nbytes + c["pv"].nbytes) // c["pk"].shape[0]

    def cache_read_page(self, page):
        c = self.pools["att"]
        return {"att": {"pk": c["pk"][page].copy(),
                        "pv": c["pv"][page].copy()}}

    def cache_write_page(self, page, payload):
        self.pools["att"]["pk"][page] = payload["att"]["pk"]
        self.pools["att"]["pv"][page] = payload["att"]["pv"]

    def stamp(self, page, value):
        self.pools["att"]["pk"][page] = value
        self.pools["att"]["pv"][page] = -value

    def read_stamp(self, page):
        return float(self.pools["att"]["pk"][page].flat[0])


def _mk(gen, num_pages=17, page_size=4, pages_per_slot=8, budget=1 << 20):
    cache = gen.PagedKVCache(num_pages, page_size, pages_per_slot)
    tp = NumpyTransport(num_pages, page_size)
    pc = gen.PrefixCache(cache, host_budget_bytes=budget, transport=tp,
                         page_bytes=tp.page_bytes())
    pc.set_version("v1")
    cache.retention = pc
    return cache, pc, tp


def _stamp_fresh(pc, tp, prompt, res):
    """What the engine's prefill does to full prompt pages: write
    content that is a function of the WHOLE chain up to each page."""
    ps = pc.page_size
    for i in range(len(prompt) // ps):
        page = res.pages[i]
        if i >= res.shared_len // ps:
            tp.stamp(page, _chain_stamp(prompt, i))


def _chain_stamp(prompt, i):
    return float(hash(tuple(prompt[:(i + 1) * 4])) % 100003) + 1.0


# ------------------------------------------------------------ unit: admission
def test_admission_pricing_hit_cheaper_than_miss(gen):
    """A hit is priced at ⌈suffix/page⌉: a pool too small for a cold
    admission still admits the same prompt when its prefix is cached."""
    cache, pc, tp = _mk(gen, num_pages=9, page_size=4, pages_per_slot=8)
    prompt = list(range(12))
    res = pc.admit(prompt, 5)          # 12+5-1=16 -> 4 pages, 3 cached
    _stamp_fresh(pc, tp, prompt, res)
    assert res.shared_len == 0 and len(res.pages) == 4
    cache.free(res.pages)              # request leaves; tree keeps 3
    assert pc.resident_pages() == 3
    pin = pc.pin(prompt)               # cached prefix is un-evictable
    blocker = pc.admit([100, 101, 102, 103, 104], 4)   # 2 pages
    _stamp_fresh(pc, tp, [100, 101, 102, 103, 104], blocker)
    assert cache.free_pages == 3
    with pytest.raises(gen.PageExhaustedError):
        pc.admit([200 + i for i in range(12)], 5)
    res2 = pc.admit(prompt, 5)
    assert res2.shared_len == 8 and len(res2.pages) == 4
    assert res2.pages[:2] == res.pages[:2]
    cache.free(res2.pages)
    cache.free(blocker.pages)
    pc.unpin(pin)


def test_mid_admission_hit_refs_before_eviction(gen):
    """The matched nodes are ref'd before room-making runs, so the
    eviction pass can never free the very pages the hit points at."""
    cache, pc, tp = _mk(gen, num_pages=7, page_size=4, pages_per_slot=8,
                        budget=0)      # no host tier: evictions drop
    old = list(range(9))
    res = pc.admit(old, 8)             # 9+8-1=16 -> 4 pages, 2 cached
    _stamp_fresh(pc, tp, old, res)
    cache.free(res.pages)
    assert pc.resident_pages() == 2 and cache.free_pages == 4
    filler = [50 + i for i in range(9)]
    res_f = pc.admit(filler, 8)
    _stamp_fresh(pc, tp, filler, res_f)
    cache.free(res_f.pages)
    assert cache.free_pages == 2 and pc.resident_pages() == 4
    res2 = pc.admit(old, 16)           # 9+16-1=24 -> 6 pages
    assert res2.shared_len == 8
    for i in range(2):
        assert tp.read_stamp(res2.pages[i]) == _chain_stamp(old, i)
    assert pc.evictions.get("capacity", 0) == 2   # both filler nodes
    assert pc.resident_pages() == 2               # only old's remain
    cache.free(res2.pages)


def test_stale_version_match_raises(gen):
    cache, pc, tp = _mk(gen)
    prompt = list(range(8))
    res = pc.admit(prompt, 4)
    _stamp_fresh(pc, tp, prompt, res)
    cache.free(res.pages)
    pc.set_version("v2")   # swap WITHOUT the engine's invalidate
    with pytest.raises(gen.StalePrefixError):
        pc.admit(prompt, 4)


def test_failed_prefill_forgets_created_nodes(gen):
    cache, pc, tp = _mk(gen)
    prompt = list(range(8))
    res = pc.admit(prompt, 4)
    pc.forget(res)
    cache.free(res.pages)
    assert pc.resident_pages() == 0
    assert cache.free_pages == cache.num_pages - 1
    res2 = pc.admit(prompt, 4)
    assert res2.shared_len == 0
    cache.free(res2.pages)


# -------------------------------------------------- unit: host tier + pinning
def test_offload_restore_round_trip_unit(gen):
    cache, pc, tp = _mk(gen, num_pages=6, page_size=4, pages_per_slot=8)
    a = list(range(9))
    res = pc.admit(a, 8)
    _stamp_fresh(pc, tp, a, res)
    cache.free(res.pages)
    assert cache.free_pages == 3
    b = [20 + i for i in range(9)]
    res_b = pc.admit(b, 8)
    _stamp_fresh(pc, tp, b, res_b)
    cache.free(res_b.pages)
    assert pc.offload_total > 0 and pc.host_pages() > 0
    assert pc.host_bytes == pc.host_pages() * tp.page_bytes()
    res_a = pc.admit(a, 8)
    assert res_a.shared_len == 8 and res_a.restored_pages > 0
    for i in range(2):
        assert tp.read_stamp(res_a.pages[i]) == _chain_stamp(a, i)
    assert pc.restore_total > 0
    cache.free(res_a.pages)


def test_matched_host_node_protected_during_room_making(gen):
    cache, pc, tp = _mk(gen, num_pages=6, page_size=4, pages_per_slot=8,
                        budget=128)
    assert tp.page_bytes() == 128
    a = list(range(9))
    res = pc.admit(a, 8)
    _stamp_fresh(pc, tp, a, res)
    cache.free(res.pages)
    b = [20 + i for i in range(9)]
    res_b = pc.admit(b, 8)
    _stamp_fresh(pc, tp, b, res_b)
    cache.free(res_b.pages)
    assert pc.host_pages() == 1 and res_b.offloaded_pages == 1
    res_a = pc.admit(a, 8)
    assert res_a.shared_len == 8 and res_a.restored_pages == 1
    for i in range(2):
        assert tp.read_stamp(res_a.pages[i]) == _chain_stamp(a, i)
    assert pc.evictions.get("host_capacity", 0) == 0
    assert pc.evictions.get("capacity", 0) == 1
    assert pc.host_pages() == 0 and pc.host_bytes == 0
    assert pc.pinned_pages() == 0
    cache.free(res_a.pages)


def test_host_budget_bounds_tier_then_drops(gen):
    cache, pc, tp = _mk(gen, num_pages=7, page_size=4, pages_per_slot=8,
                        budget=0)
    for base in (0, 20, 40):
        p = [base + i for i in range(8)]
        r = pc.admit(p, 9)
        _stamp_fresh(pc, tp, p, r)
        cache.free(r.pages)
    assert pc.host_pages() == 0 and pc.offload_total == 0
    assert pc.evictions.get("capacity", 0) > 0


def test_pinned_nodes_survive_pressure_and_unpin_releases(gen):
    cache, pc, tp = _mk(gen, num_pages=6, page_size=4, pages_per_slot=8,
                        budget=0)
    a = list(range(9))
    res = pc.admit(a, 8)
    _stamp_fresh(pc, tp, a, res)
    cache.free(res.pages)
    pin = pc.pin(a)
    assert pc.pinned_pages() == 2 and cache.free_pages == 3
    b = [20 + i for i in range(12)]
    with pytest.raises(gen.PageExhaustedError):
        pc.admit(b, 5)                 # 4 pages, only 3 free
    assert pc.resident_pages() == 2    # a's nodes untouched
    res_a = pc.admit(a, 8)             # pinned prefix still hits
    assert res_a.shared_len == 8
    cache.free(res_a.pages)
    pc.unpin(pin)
    res_b = pc.admit(b, 5)             # now a's cold nodes may go
    cache.free(res_b.pages)
    with pytest.raises(KeyError):
        pc.unpin(pin)                  # double unpin raises


def test_double_unpin_raises_after_invalidate(gen):
    cache, pc, tp = _mk(gen)
    a = list(range(8))
    r = pc.admit(a, 4)
    _stamp_fresh(pc, tp, a, r)
    cache.free(r.pages)
    pin = pc.pin(a)
    pc.invalidate("swap")
    pc.unpin(pin)                      # legal (no-op on nodes)
    with pytest.raises(KeyError):
        pc.unpin(pin)


def test_stats_consistent_under_concurrent_eviction(gen):
    """``stats()`` owns the tree lock: a stats walk racing admit/offload/
    invalidate churn never reports torn numbers."""
    rng = np.random.RandomState(20260807)
    cache, pc, tp = _mk(gen, num_pages=13, page_size=4, pages_per_slot=8,
                        budget=3 * 512)
    families = [list(rng.randint(0, 50, 16)) for _ in range(4)]
    stop = threading.Event()
    torn = []

    def reader():
        while not stop.is_set():
            st = pc.stats()
            if st["host_tier_bytes"] != st["host_pages"] * tp.page_bytes():
                torn.append(("host_tier", st))
            if (st["resident_pages"] > st["nodes"]
                    or st["pinned_pages"] > st["nodes"]):
                torn.append(("pages_vs_nodes", st))
            total = st["hits"] + st["misses"]
            expect = round(st["hits"] / total, 4) if total else 0.0
            if st["hit_rate"] != expect:
                torn.append(("hit_rate", st))

    readers = [threading.Thread(target=reader, daemon=True)
               for _ in range(3)]
    for t in readers:
        t.start()
    inflight = []
    try:
        for _ in range(300):
            op = rng.randint(0, 8)
            if op <= 4:
                fam = families[rng.randint(len(families))]
                prompt = fam[:int(rng.randint(5, len(fam) + 1))]
                try:
                    res = pc.admit(prompt, int(rng.randint(1, 6)))
                except gen.PageExhaustedError:
                    continue
                _stamp_fresh(pc, tp, prompt, res)
                inflight.append(res)
            elif op <= 6 and inflight:
                cache.free(inflight.pop(
                    rng.randint(len(inflight))).pages)
            elif rng.random_sample() < 0.2:
                pc.invalidate("pool_reset")
    finally:
        stop.set()
        for t in readers:
            t.join(timeout=10.0)
    assert not any(t.is_alive() for t in readers)
    assert torn == [], f"torn stats snapshots: {torn[:3]}"
    assert pc.offload_total > 0 or pc.evictions


def test_cache_invariant_fuzz(gen):
    """Seeded admit/release/pin/unpin/invalidate churn, checked step by
    step against a model-checker dict: chain-stamped content on every
    hit, allocator/free-list consistency, pinned nodes never evicted, no
    page freed while referenced."""
    rng = np.random.RandomState(20260806)
    cache, pc, tp = _mk(gen, num_pages=13, page_size=4, pages_per_slot=8,
                        budget=3 * 512)
    inflight = []
    pins = {}
    families = [list(rng.randint(0, 50, 16)) for _ in range(4)]

    def check_invariants():
        free = set(cache._free)
        assert len(free) == len(cache._free), "free list duplicates"
        for p in free:
            assert cache.refcount(p) == 0, f"page {p} free but ref'd"
        for p in range(1, cache.num_pages):
            assert cache.refcount(p) >= 0
            if cache.refcount(p) == 0:
                assert p in free, f"page {p} leaked (ref 0, not free)"
        resident = [n.page for n in pc._all if n.page is not None]
        assert len(resident) == len(set(resident)), "node page dup"
        for pg in resident:
            assert cache.refcount(pg) >= 1 and pg not in free
        assert pc.host_bytes == pc.host_pages() * tp.page_bytes()
        for nodes in pc._pins.values():
            for n in nodes:
                assert n.pins >= 1

    for step in range(400):
        op = rng.randint(0, 10)
        if op <= 3:
            fam = families[rng.randint(len(families))]
            prompt = fam[:int(rng.randint(5, len(fam) + 1))]
            try:
                res = pc.admit(prompt, int(rng.randint(1, 6)))
            except gen.PageExhaustedError:
                pass
            else:
                for i in range(res.shared_len // 4):
                    assert tp.read_stamp(res.pages[i]) == \
                        _chain_stamp(prompt, i), f"step {step}"
                _stamp_fresh(pc, tp, prompt, res)
                inflight.append((prompt, res))
        elif op <= 5 and inflight:
            _, res = inflight.pop(rng.randint(len(inflight)))
            cache.free(res.pages)
        elif op == 6:
            fam = families[rng.randint(len(families))]
            pins[pc.pin(fam[:int(rng.randint(4, 13))])] = True
        elif op == 7 and pins:
            pid = list(pins)[rng.randint(len(pins))]
            del pins[pid]
            pc.unpin(pid)
        elif op == 8 and rng.random_sample() < 0.1:
            pc.invalidate("pool_reset")
            tp.pools["att"]["pk"][:] = 0
            tp.pools["att"]["pv"][:] = 0
        check_invariants()
    for _, res in inflight:
        cache.free(res.pages)
    check_invariants()
    assert pc.hits > 0 and pc.misses > 0
    assert pc.offload_total > 0 or pc.evictions


# ----------------------------------------------------------- engine: parity
def test_persistent_hits_equal_cold_legacy_and_jax(engine, lm, nets, rng):
    """Cold pass == warm (cached-hit) pass == free-on-release engine ==
    the JAX engine with its prefix cache, token for token; warm passes
    must actually hit, in both packages."""
    prompts = [rng.randint(0, VOCAB, 9).tolist() for _ in range(4)]
    legacy = GenerationEngine(lm, slots=4, page_size=4, max_context=32)
    legacy.start()
    try:
        ref = [legacy.generate(p, 8).tolist() for p in prompts]
    finally:
        legacy.stop()
    jeng = jax_generation.GenerationEngine(
        nets[0], slots=4, page_size=4, max_context=32, prefix_cache=True,
        prefill_buckets=(16,))
    jeng.start()
    try:
        jax_cold = [jeng.generate(p, 8).tolist() for p in prompts]
        jax_warm = [jeng.generate(p, 8).tolist() for p in prompts]
        jax_hits = jeng.prefix_cache.hits
    finally:
        jeng.stop()
    assert jax_cold == jax_warm == ref
    assert jax_hits >= len(prompts)

    h0 = engine.prefix_cache.hits
    cold = [engine.generate(p, 8).tolist() for p in prompts]
    warm = [engine.generate(p, 8).tolist() for p in prompts]
    assert cold == ref and warm == ref
    assert engine.prefix_cache.hits >= h0 + len(prompts)
    kw = dict(temperature=0.9, top_k=7, seed=42)
    s1 = engine.generate(prompts[0], 8, **kw).tolist()
    s2 = engine.generate(prompts[0], 8, **kw).tolist()
    assert s1 == s2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_page_transport_round_trip_bit_exact(dtype):
    """``read_page`` then ``write_page`` into another page copies every
    pool's slices bit for bit, in place (the pool tensors stay the
    same objects); ``page_nbytes`` is one page of every K and V."""
    from deeplearning4j_tpu_torch.generation.programs import (
        GenerationPrograms,
    )
    from deeplearning4j_tpu_torch.models.common import tree_leaves
    from deeplearning4j_tpu_torch.models.zoo import transformer_char_lm

    net = transformer_char_lm(vocab_size=VOCAB, d_model=32, n_heads=4,
                              layers=2, device="cpu",
                              compute_dtype=None if dtype == "float32"
                              else dtype)
    progs = GenerationPrograms(net, slots=2, pages_per_slot=4, page_size=4,
                               num_pages=9, prefill_buckets=(4,))
    progs.warm()
    g = torch.Generator().manual_seed(0)
    leaves = tree_leaves(progs.pools)
    for t in leaves:
        t.copy_(torch.randn(t.shape, generator=g).to(t.dtype))
    payload = progs.read_page(3)
    progs.write_page(6, payload)
    for t in leaves:
        assert torch.equal(t[6], t[3])
    assert [a is b for a, b in zip(tree_leaves(progs.pools), leaves)] \
        == [True] * len(leaves)
    again = progs.read_page(6)
    for a, b in zip(tree_leaves(payload), tree_leaves(again)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert progs.page_nbytes() == sum(t[0].numel() * t.element_size()
                                      for t in leaves)


def test_engine_offload_restore_round_trip(lm, rng):
    """Tight pool: cold pages spill to host mid-run and restore on
    revisit; every completion stays identical to the legacy engine."""
    eng = GenerationEngine(lm, slots=2, page_size=4, max_context=32,
                           num_pages=13, prefix_cache=True)
    eng.start()
    try:
        prompts = [rng.randint(0, VOCAB, 9).tolist() for _ in range(6)]
        ref = [eng.generate(p, 8).tolist() for p in prompts]
        st = eng.prefix_cache.stats()
        assert st["offload_total"] > 0, st
        again = [eng.generate(p, 8).tolist() for p in prompts]
        assert again == ref
        st = eng.prefix_cache.stats()
        assert st["restore_total"] > 0 and st["hits"] >= len(prompts), st
    finally:
        eng.stop()
    legacy = GenerationEngine(lm, slots=2, page_size=4, max_context=32,
                              num_pages=13)
    legacy.start()
    try:
        assert [legacy.generate(p, 8).tolist() for p in prompts] == ref
    finally:
        legacy.stop()


def test_chat_session_pinning(engine, rng):
    """Multi-turn conversation: pin the history after each turn; later
    turns only prefill the new tokens (shared_len grows)."""
    history = rng.randint(0, VOCAB, 6).tolist()
    pin = None
    shared_seen = []
    for _ in range(3):
        req = engine.submit(history, 4)
        toks = req.result(timeout=60)
        shared_seen.append(req.shared_len)
        history = history + toks + rng.randint(0, VOCAB, 2).tolist()
        if pin is not None:
            engine.unpin_prefix(pin)
        pin = engine.pin_prefix(history)
    engine.unpin_prefix(pin)
    assert shared_seen[1] > 0 and shared_seen[2] > shared_seen[1]
    with pytest.raises(KeyError):
        engine.unpin_prefix(pin)


# ---------------------------------------------- engine: invalidation + 429s
def test_hot_swap_invalidation_drill(lm, nets2, rng):
    """After a deploy the next identical prompt must not hit the old
    tree: its tokens equal a fresh engine's on the new weights and the
    JAX engine's; a rollback invalidates again."""
    lm2 = nets2[1]
    eng = GenerationEngine(lm, slots=2, page_size=4, max_context=32,
                           prefix_cache=True)
    eng.start()
    try:
        prompt = rng.randint(0, VOCAB, 9).tolist()
        eng.generate(prompt, 8)
        before = eng.generate(prompt, 8).tolist()
        assert eng.prefix_cache.hits >= 1

        eng.deploy("default", lm2, retain_old=True)
        got = eng.generate(prompt, 8).tolist()
        st = eng.prefix_cache.stats()
        assert st["evictions_total"].get("swap", 0) > 0, st
        jeng = jax_generation.GenerationEngine(
            nets2[0], slots=2, page_size=4, max_context=32,
            prefill_buckets=(16,))
        jeng.start()
        try:
            assert got == jeng.generate(prompt, 8).tolist()
        finally:
            jeng.stop()

        eng.rollback()
        assert eng.generate(prompt, 8).tolist() == before
        assert eng.prefix_cache.stats()["evictions_total"]["swap"] > \
            st["evictions_total"]["swap"]
    finally:
        eng.stop()


def test_restart_invalidates_pool_reset(lm, rng):
    eng = GenerationEngine(lm, slots=2, page_size=4, max_context=32,
                           prefix_cache=True)
    eng.start()
    prompt = rng.randint(0, VOCAB, 9).tolist()
    ref = eng.generate(prompt, 8).tolist()
    assert eng.prefix_cache.resident_pages() > 0
    eng.stop()
    eng.start()
    try:
        assert eng.prefix_cache.resident_pages() == 0
        assert eng.prefix_cache.stats()["evictions_total"].get(
            "pool_reset", 0) > 0
        assert eng.generate(prompt, 8).tolist() == ref
    finally:
        eng.stop()


def test_page_exhaustion_sheds_never_evicts_pinned(lm, rng):
    """Every page pinned or in flight: admission must shed (429 once the
    queue fills) rather than evict a pinned node; unpinning unblocks
    the queued requests."""
    eng = GenerationEngine(lm, slots=2, page_size=4, max_context=32,
                           num_pages=9, max_queue=2, deadline_s=30.0,
                           prefix_cache=True)
    eng.start()
    try:
        a = rng.randint(0, VOCAB, 9).tolist()
        b = rng.randint(0, VOCAB, 9).tolist()
        for p in (a, b):
            eng.generate(p, 8)
        pin_a, pin_b = eng.pin_prefix(a), eng.pin_prefix(b)
        assert eng.prefix_cache.pinned_pages() == 4
        blocker = eng.submit(rng.randint(0, VOCAB, 9).tolist(), 8,
                             temperature=0.5, seed=3)
        blocker.result(timeout=60)
        q1 = eng.submit(rng.randint(0, VOCAB, 12).tolist(), 8)
        q2 = eng.submit(rng.randint(0, VOCAB, 12).tolist(), 8)
        time.sleep(0.3)
        assert not q1.done.is_set() and not q2.done.is_set()
        assert eng.prefix_cache.pinned_pages() == 4   # nothing evicted
        with pytest.raises(QueueFullError):
            eng.submit(rng.randint(0, VOCAB, 12).tolist(), 8)
        eng.unpin_prefix(pin_a)
        eng.unpin_prefix(pin_b)
        assert len(q1.result(timeout=60)) == 8
        assert len(q2.result(timeout=60)) == 8
    finally:
        eng.stop()


def test_cache_stats_payload(engine, rng):
    engine.generate(rng.randint(0, VOCAB, 9).tolist(), 4)
    body = engine.cache_stats()
    assert body["cache"]["num_pages"] == engine.cache.num_pages
    pc = body["prefix_cache"]
    assert pc is not None and pc["nodes"] >= 1
    assert set(pc) >= {"hits", "misses", "resident_pages",
                       "host_tier_bytes", "pinned_pages", "offload_total",
                       "restore_total", "evictions_total"}
    with pytest.raises(RuntimeError, match="prefix cache"):
        GenerationEngine(engine.models.active("default").model, slots=2,
                         page_size=4, max_context=32).pin_prefix([1, 2])
