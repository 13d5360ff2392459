"""The port's continuous-batching GenerationEngine
(``deeplearning4j_tpu_torch/generation/``) against the JAX package's, and
against its own oracles, on the CPU with the same float32 weights.

- Greedy join/leave traffic: the port's tokens are IDENTICAL to the JAX
  engine's for the same requests.
- Join/leave output equals isolated sequential decode (the oracle of
  ``tests/test_generation.py``).
- Seeded sampling is slot-invariant (the port's own streams: the
  reference's threefry draws cannot be reproduced in torch).
- Admission errors: 429 on a full queue, 503 after stop, 504 on an
  expired queued request."""

import time

import numpy as np
import pytest

import jax

from deeplearning4j_tpu.generation import GenerationEngine as JaxEngine
from deeplearning4j_tpu.models.zoo import transformer_char_lm as jax_lm
from deeplearning4j_tpu_torch.generation import GenerationEngine
from deeplearning4j_tpu_torch.models.common import tree_leaves
from deeplearning4j_tpu_torch.helpers import paged_attention as pa
from deeplearning4j_tpu_torch.models.interop import params_from_numpy
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.serving.admission import (
    DeadlineExceededError, QueueFullError, ShuttingDownError,
)

VOCAB = 29
GEOM = dict(slots=4, page_size=4, max_context=32, prefill_buckets=(4, 16))


@pytest.fixture(scope="module")
def jax_net():
    return jax_lm(vocab_size=VOCAB, d_model=32, n_heads=4, layers=2,
                  max_cache=128, seed=7)


@pytest.fixture(scope="module")
def port_net(jax_net):
    conf = MultiLayerConfiguration.from_json(jax_net.conf.to_json())
    return params_from_numpy(conf, jax.device_get(jax_net.params),
                             device="cpu")


@pytest.fixture(scope="module")
def engine(port_net):
    eng = GenerationEngine(port_net, max_queue=64, deadline_s=30.0,
                           **GEOM).start()
    yield eng
    eng.stop()


def _traffic(seed, n=8):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, VOCAB, int(rng.integers(1, 12))).tolist()
               for _ in range(n)]
    lens = [int(rng.integers(2, 10)) for _ in prompts]
    return prompts, lens


def _serve_mixed(eng, prompts, lens):
    """Staggered submits: requests join and leave the running batch at
    different steps."""
    handles = []
    for i, (p, n) in enumerate(zip(prompts, lens)):
        handles.append(eng.submit(p, n))
        if i % 3 == 0:
            time.sleep(0.002)
    out = [h.result(timeout=60) for h in handles]
    assert all(h.finish_reason == "length" for h in handles)
    return out


def test_greedy_tokens_identical_to_jax_engine(jax_net, engine):
    prompts, lens = _traffic(0)
    jeng = JaxEngine(jax_net, max_queue=64, deadline_s=30.0, **GEOM)
    jeng.start()
    try:
        ref = _serve_mixed(jeng, prompts, lens)
    finally:
        jeng.stop()
    pa.counts.reset()
    got = _serve_mixed(engine, prompts, lens)
    assert got == ref
    # the CPU run went through the kernel's plain version, never a launch
    assert pa.counts.launches == 0 and pa.counts.plain_calls > 0


def test_join_leave_equals_sequential(engine):
    prompts, lens = _traffic(1)
    seq = [engine.generate(p, n).tolist() for p, n in zip(prompts, lens)]
    assert _serve_mixed(engine, prompts, lens) == seq


def test_seeded_sampling_slot_invariant(engine):
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, VOCAB, 6).tolist()
    kw = dict(temperature=0.9, top_k=7, top_p=0.95, seed=123)
    alone = engine.generate(prompt, 8, **kw).tolist()
    noise = [engine.submit(rng.integers(0, VOCAB, 5).tolist(), 6,
                           temperature=1.1, seed=50 + i) for i in range(3)]
    busy = engine.generate(prompt, 8, **kw).tolist()
    for h in noise:
        h.result(timeout=60)
    assert busy == alone
    # a different seed gives a different stream
    assert engine.generate(prompt, 8, **{**kw, "seed": 124}).tolist() != alone


def test_admission_errors(port_net):
    eng = GenerationEngine(port_net, max_queue=1, deadline_s=30.0, **GEOM)
    first = eng.submit([1, 2, 3], 4)
    with pytest.raises(QueueFullError) as e:
        eng.submit([1, 2, 3], 4)
    assert e.value.http_status == 429
    eng.scheduler.purge_pending(now=time.monotonic() + 60.0)
    with pytest.raises(DeadlineExceededError) as e:
        first.result(timeout=1)
    assert e.value.http_status == 504
    with pytest.raises(ValueError):
        eng.submit(list(range(17)), 4)          # over the largest bucket
    eng.start()
    eng.stop(drain=False)
    with pytest.raises(ShuttingDownError) as e:
        eng.submit([1, 2, 3], 4)
    assert e.value.http_status == 503


def test_error_path_reseeds_the_pools_in_place(port_net):
    """A failed decode step fails the running batch and zeroes the pools
    in place (a captured graph holds their addresses); the engine goes on
    serving the same tokens.  On the CPU nothing is captured."""
    eng = GenerationEngine(port_net, max_queue=8, deadline_s=30.0,
                           **GEOM).start()
    try:
        progs = eng.programs
        pools = tree_leaves(progs.pools)
        want = eng.generate([4, 5, 6], 5).tolist()
        real = progs.decode
        progs.decode = lambda *a, **kw: (_ for _ in ()).throw(
            RuntimeError("injected decode failure"))
        with pytest.raises(RuntimeError, match="injected"):
            eng.submit([1, 2], 4).result(timeout=60)
        progs.decode = real
        assert eng.generate([4, 5, 6], 5).tolist() == want
        assert all(a is b for a, b in zip(tree_leaves(progs.pools), pools))
        stats = eng.stats()
        assert stats["captures"] == 0 and stats["replays"] == 0
    finally:
        eng.stop()
