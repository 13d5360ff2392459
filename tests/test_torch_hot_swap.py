"""The port's GenerationEngine hot-swap (``deploy``/``rollback``/
``commit_swap`` over ``serving/registry.py``) against the JAX package on
the CPU, with weights carried across through the reference's zip
checkpoints.

- Zero dropped streams under a deploy: clients generate continuously,
  streams in flight across the swap get all their tokens, and the pool
  tensors stay the same objects (a captured graph holds their address).
- An incompatible deploy (other cache geometry) is rejected and the old
  version goes on serving (reference ``test_generation.py:426``).
- Rollback between steps replays the retained version's programs: the
  old tokens come back and nothing is built again.
- After a commit, greedy ids equal the JAX engine's on the new weights.
- The version's detector: one compile a program at deploy, none after.
"""

import threading
import time

import numpy as np
import pytest

from deeplearning4j_tpu import generation as jax_generation
from deeplearning4j_tpu.models import serialization as jax_serialization
from deeplearning4j_tpu.models.zoo import transformer_char_lm as jax_lm
from deeplearning4j_tpu_torch.generation import GenerationEngine
from deeplearning4j_tpu_torch.models import serialization
from deeplearning4j_tpu_torch.models.common import tree_leaves

VOCAB = 29
GEOM = dict(slots=4, page_size=4, max_context=32, prefill_buckets=(8, 16))


def _checkpoint(tmp_path_factory, seed, layers=2):
    jnet = jax_lm(vocab_size=VOCAB, d_model=32, n_heads=4, layers=layers,
                  max_cache=128, seed=seed)
    path = tmp_path_factory.mktemp("ckpt") / f"lm{seed}_{layers}.zip"
    jax_serialization.write_model(jnet, str(path))
    return jnet, serialization.load_model(path, device="cpu")


@pytest.fixture(scope="module")
def v1(tmp_path_factory):
    return _checkpoint(tmp_path_factory, 12345)


@pytest.fixture(scope="module")
def v2(tmp_path_factory):
    return _checkpoint(tmp_path_factory, 31337)


def _jax_ids(jnet, prompts, n):
    jeng = jax_generation.GenerationEngine(jnet, **GEOM)
    jeng.start()
    try:
        return [jeng.generate(p, n).tolist() for p in prompts]
    finally:
        jeng.stop()


def _wait_for(ready, what, timeout_s=60.0):
    """Polls ``ready()`` until it holds; fails the test after
    ``timeout_s`` seconds."""
    deadline = time.monotonic() + timeout_s
    while not ready():
        if time.monotonic() > deadline:
            pytest.fail(f"waited {timeout_s} s for {what}")
        time.sleep(0.005)


def test_hot_swap_zero_drops(v1, v2, rng):
    """Clients generate continuously while a new version is deployed:
    every stream completes with all its tokens, none errors, the
    streams in flight at the swap keep their pages, and the registry
    serves the new version after."""
    eng = GenerationEngine(v1[1], max_queue=64, deadline_s=60.0, **GEOM)
    eng.start()
    try:
        pools = tree_leaves(eng._pools)
        stop = threading.Event()
        results, errors = [], []
        lock = threading.Lock()

        def client(cid):
            r = np.random.RandomState(cid)
            while not stop.is_set():
                n = int(r.randint(2, 12))
                try:
                    toks = eng.generate(
                        r.randint(0, VOCAB, r.randint(1, 8)).tolist(), n)
                except Exception as e:    # must not happen
                    with lock:
                        errors.append(e)
                    return
                with lock:
                    results.append(len(toks) == n)

        def finished():
            with lock:
                return len(results) + len(errors)

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(3)]
        for t in threads:
            t.start()
        _wait_for(lambda: finished() >= 6, "6 generations before the deploy")
        long = [eng.submit(rng.randint(0, VOCAB, 5).tolist(), 20)
                for _ in range(2)]
        _wait_for(lambda: all(h.tokens for h in long),
                  "the long streams' first tokens")
        assert not any(h.done.is_set() for h in long)
        before = finished()
        mv2 = eng.deploy("default", v2[1])
        _wait_for(lambda: finished() >= before + 6,
                  "6 generations after the deploy")
        stop.set()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors
        assert len(results) > 10 and all(results)
        assert all(len(h.result(timeout=60)) == 20 for h in long)
        assert eng.models.active("default").version == mv2.version == 2
        assert [a is b for a, b in zip(tree_leaves(eng._pools), pools)] \
            == [True] * len(pools)
        # the displaced version retired and its programs dropped
        assert list(eng._programs) == [mv2.key]
        prompt = rng.randint(0, VOCAB, 6).tolist()
        assert eng.generate(prompt, 8).tolist() == \
            _jax_ids(v2[0], [prompt], 8)[0]
    finally:
        eng.stop()


def test_incompatible_deploy_rejected(v1, tmp_path_factory):
    eng = GenerationEngine(v1[1], slots=2, page_size=4, max_context=16,
                           prefill_buckets=(8,))
    eng.start()
    try:
        bad = _checkpoint(tmp_path_factory, 5, layers=1)[1]
        with pytest.raises(ValueError, match="geometry"):
            eng.deploy("default", bad)
        with pytest.raises(ValueError, match="one model name"):
            eng.deploy("other", v1[1])
        # old version still serves, nothing of the rejected one kept
        assert eng.generate([1, 2, 3], 3).shape == (3,)
        assert eng.models.active("default").version == 1
        assert len(eng._programs) == 1
    finally:
        eng.stop()


def test_rollback_between_steps(v1, v2, rng):
    """A retaining deploy keeps the old version's programs; rollback
    flips back to them (nothing built again) and the old tokens
    return; the displaced version is retired and its programs go."""
    eng = GenerationEngine(v1[1], **GEOM)
    eng.start()
    try:
        prompt = rng.randint(0, VOCAB, 4).tolist()
        first = eng.generate(prompt, 6).tolist()
        mv1 = eng.models.active("default")
        old_progs = eng.programs
        compiles1 = mv1.detector.compile_count
        mv2 = eng.deploy("default", v2[1], retain_old=True)
        assert eng.models.retained("default") is mv1
        assert set(eng._programs) == {mv1.key, mv2.key}
        second = eng.generate(prompt, 6).tolist()
        assert second != first             # different weights served
        restored = eng.rollback()
        assert restored is mv1 and eng.programs is old_progs
        assert eng.generate(prompt, 6).tolist() == first
        assert mv1.detector.compile_count == compiles1
        assert list(eng._programs) == [mv1.key]
        assert mv2.state == "retired" and mv2.model is None
    finally:
        eng.stop()


def test_commit_swap_serves_the_jax_engines_ids(v1, v2, rng):
    """deploy(retain_old) + commit_swap: the retained version retires and
    later requests give the JAX engine's ids on the new weights; the new
    version's detector counted one compile a program at deploy and none
    while serving."""
    eng = GenerationEngine(v1[1], **GEOM)
    eng.start()
    try:
        prompts = [rng.randint(0, VOCAB, int(rng.randint(2, 12))).tolist()
                   for _ in range(4)]
        mv2 = eng.deploy("default", v2[1], retain_old=True)
        programs = len(GEOM["prefill_buckets"]) + 1
        assert mv2.detector.compile_count == programs
        released = eng.commit_swap()
        assert released.version == 1 and released.state == "retired"
        assert eng.commit_swap() is None          # idempotent
        got = [eng.generate(p, 7).tolist() for p in prompts]
        assert got == _jax_ids(v2[0], prompts, 7)
        assert mv2.detector.compile_count == programs
        assert mv2.detector.recompile_count == 0
        stats = eng.stats()
        assert stats["models"]["active"]["default"]["version"] == 2
        assert stats["captures"] == 0     # the CPU captures nothing
    finally:
        eng.stop()


def test_deploy_before_start_serves_the_deployed_version(v1, v2):
    """A deploy before start builds the version over the same pools that
    start then zeroes; the engine serves the deployed version."""
    eng = GenerationEngine(v1[1], **GEOM)
    mv2 = eng.deploy("default", v2[1])
    eng.start()
    try:
        assert eng.models.active("default") is mv2
        assert eng.generate([3, 4, 5], 5).tolist() == \
            _jax_ids(v2[0], [[3, 4, 5]], 5)[0]
    finally:
        eng.stop()
