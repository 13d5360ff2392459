"""Sequence parallelism in the port against the JAX package: ring and
Ulysses attention over S sequence slots against exact attention and the
JAX ``ring_self_attention`` on S virtual devices (causal, windowed, GQA,
gradients), and ``SequenceParallelTrainingMaster`` over (data=2, seq=4)
slots against the single net and the JAX master.  Tolerances are the
reference tests' (``tests/test_sequence_parallel.py``: attention
``rtol=atol=2e-5``, gradients ``5e-5``, training ``rtol=1e-4,
atol=1e-5``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from deeplearning4j_tpu import parallel as jpar
from deeplearning4j_tpu.backend import device as jbackend
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.models.zoo import transformer_char_lm as jax_lm
from deeplearning4j_tpu.nn.layers.attention import (
    dot_product_attention as jax_attention,
)

from deeplearning4j_tpu_torch import helpers
from deeplearning4j_tpu_torch.backend.mesh import collective_totals
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.models import zoo
from deeplearning4j_tpu_torch.models.interop import params_from_numpy
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.layers.attention import (
    dot_product_attention,
)
from deeplearning4j_tpu_torch.parallel import (
    SequenceParallelTrainingMaster, ring_attention, ring_self_attention,
)
from deeplearning4j_tpu_torch.parallel.sequence_parallel import shard_seq

from tests._torch_parallel_common import tmesh_of, tvec

ATT = dict(rtol=2e-5, atol=2e-5)


def _qkv(seed, b=2, t=32, h=4, d=8, hkv=None):
    rng = np.random.default_rng(seed)
    shapes = [(b, t, h, d), (b, t, hkv or h, d), (b, t, hkv or h, d)]
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _jmesh(n_seq):
    devs = np.array(jax.devices()[:n_seq]).reshape(1, 1, n_seq)
    return Mesh(devs, (jbackend.AXIS_DATA, jbackend.AXIS_MODEL,
                       jbackend.AXIS_SEQ))


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
@pytest.mark.parametrize("causal,window", [(False, None), (True, None),
                                           (True, 6)])
def test_attention_matches_exact_and_jax(impl, causal, window):
    q, k, v = _qkv(0)
    tq, tk, tv = map(torch.tensor, (q, k, v))
    got = ring_self_attention(tq, tk, tv, tmesh_of(1, seq=4), causal=causal,
                              window=window, impl=impl)
    want = dot_product_attention(tq, tk, tv, causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **ATT)
    jgot = jpar.ring_self_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), _jmesh(4),
                                    causal=causal, window=window, impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), **ATT)


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_gqa_attention_matches_exact(impl):
    q, k, v = _qkv(3, h=8, hkv=4)
    tq, tk, tv = map(torch.tensor, (q, k, v))
    got = ring_self_attention(tq, tk, tv, tmesh_of(1, seq=4), causal=True,
                              impl=impl)
    want = dot_product_attention(tq, tk, tv, causal=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **ATT)
    jwant = jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant), **ATT)


def test_ulysses_gqa_bypasses_the_flash_helper():
    """K/V with fewer heads than Q never reach the flash helper (it
    takes MHA only); equal heads do."""
    seen = []

    class Spy:
        def supports(self, q):
            return True

        def attend(self, q, k, v, *, causal=False, window=None):
            seen.append((q.shape[2], k.shape[2]))
            return dot_product_attention(q, k, v, causal=causal,
                                         window=window)

    q, k, v = map(torch.tensor, _qkv(4, h=8, hkv=4))
    old = helpers._registry.get("attention")
    helpers.register_helper("attention", Spy())
    try:
        ring_self_attention(q, k, v, tmesh_of(1, seq=4), causal=True,
                            impl="ulysses")
        assert seen == []
        ring_self_attention(q, q, q, tmesh_of(1, seq=4), causal=True,
                            impl="ulysses")
        assert seen == [(2, 2)]
    finally:
        helpers.register_helper("attention", old)


def test_ring_gradients_match_exact():
    q, k, v = [torch.tensor(a, requires_grad=True)
               for a in _qkv(1, b=1, t=16, h=2, d=4)]
    mesh = tmesh_of(1, seq=4)
    ge = torch.autograd.grad(
        (dot_product_attention(q, k, v, causal=True) ** 2).sum(), (q, k, v))
    gr = torch.autograd.grad(
        (ring_self_attention(q, k, v, mesh, causal=True) ** 2).sum(),
        (q, k, v))
    for a, b in zip(ge, gr):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=5e-5,
                                   atol=5e-5)


def test_ring_rotates_kv_with_the_slot_roll():
    before = collective_totals().get("collective-permute",
                                     {"count": 0})["count"]
    q, k, v = map(torch.tensor, _qkv(2, b=1, t=16))
    S = 4
    ring_attention(shard_seq(q, S), shard_seq(k, S), shard_seq(v, S),
                   causal=True)
    after = collective_totals()["collective-permute"]["count"]
    assert after - before == 2 * (S - 1)          # K and V, S - 1 steps


def _char_batches(vocab, b, t, n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(0, vocab, (b, t))
        y = np.eye(vocab, dtype=np.float32)[rng.integers(0, vocab, (b, t))]
        out.append((ids.astype(np.int32), y))
    return out


@pytest.mark.parametrize("kv_heads", [None, 1])
def test_sp_training_matches_single_net_and_jax(kv_heads):
    """(data=2, seq=4) slots, SGD (rounding stays linear), three steps:
    the port equals its single net and the JAX master on 8 devices."""
    vocab, b, t = 11, 4, 16
    batches = _char_batches(vocab, b, t, n=3)
    kw = dict(vocab_size=vocab, d_model=16, n_heads=2, layers=1, seed=7,
              updater="sgd", lr=0.1, n_kv_heads=kv_heads)
    jnet = jax_lm(seq_axis=jbackend.AXIS_SEQ, **kw)
    conf = MultiLayerConfiguration.from_json(jnet.conf.to_json())
    sp = params_from_numpy(conf, jax.device_get(jnet.params), device="cpu")
    single = zoo.transformer_char_lm(device="cpu", **kw)
    single.params = params_from_numpy(
        conf, jax.device_get(jnet.params), device="cpu").params
    jmesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 1, 4),
                 (jbackend.AXIS_DATA, jbackend.AXIS_MODEL,
                  jbackend.AXIS_SEQ))
    jpar.SequenceParallelTrainingMaster(mesh=jmesh).execute_training(
        jnet, [JDataSet(x, y) for x, y in batches])
    SequenceParallelTrainingMaster(mesh=tmesh_of(2, seq=4)).execute_training(
        sp, [DataSet(x, y) for x, y in batches])
    for x, y in batches:
        single.fit(x, y)
    np.testing.assert_allclose(tvec(sp), tvec(single), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tvec(sp), np.asarray(jnet.params_to_vector()),
                               rtol=1e-4, atol=1e-5)
    assert abs(float(sp.score_value) - float(jnet.score_value)) < 1e-4
    assert sp.iteration == 3


def test_sp_master_with_one_seq_slot_takes_the_flash_route():
    """A master whose seq axis has one slot runs the layer's ordinary
    route (the flash helper, its plain version on the CPU; no ring fold)
    and trains as the single net does."""
    from deeplearning4j_tpu_torch.helpers import flash_attention as fa

    vocab, b, t = 11, 4, 16
    batches = _char_batches(vocab, b, t, n=3, seed=1)
    kw = dict(vocab_size=vocab, d_model=16, n_heads=2, layers=1, seed=7,
              updater="sgd", lr=0.1, device="cpu")
    sp = zoo.transformer_char_lm(seq_axis="seq", **kw)
    single = zoo.transformer_char_lm(**kw)
    before = fa.fwd_counts.plain_calls
    SequenceParallelTrainingMaster(mesh=tmesh_of(2, seq=1)).execute_training(
        sp, [DataSet(x, y) for x, y in batches])
    assert fa.fwd_counts.plain_calls == before + len(batches)
    for x, y in batches:
        single.fit(x, y)
    np.testing.assert_allclose(tvec(sp), tvec(single), rtol=1e-4, atol=1e-5)


def test_sp_master_rejects_a_batch_that_does_not_divide():
    net = zoo.transformer_char_lm(vocab_size=5, d_model=8, n_heads=2,
                                  layers=1, seq_axis="seq", device="cpu")
    x = np.zeros((3, 8), np.int32)
    y = np.zeros((3, 8, 5), np.float32)
    with pytest.raises(ValueError, match="must divide"):
        SequenceParallelTrainingMaster(mesh=tmesh_of(2, seq=4)) \
            .execute_training(net, [DataSet(x, y)])


def test_seq_axis_layer_outside_a_step_is_plain_attention():
    """Outside a master's step a seq_axis net has one slot: it takes the
    plain net's route, through the flash helper (its plain version on the
    CPU), not the ring fold, and its output is the plain net's."""
    from deeplearning4j_tpu_torch.helpers import flash_attention as fa

    kw = dict(vocab_size=7, d_model=16, n_heads=2, layers=1, device="cpu")
    a = zoo.transformer_char_lm(seq_axis="seq", **kw)
    b = zoo.transformer_char_lm(**kw)
    x = np.random.default_rng(0).integers(0, 7, (2, 12))
    before = fa.fwd_counts.plain_calls
    out_a = a.output(x).numpy()
    assert fa.fwd_counts.plain_calls == before + 1
    np.testing.assert_allclose(out_a, b.output(x).numpy(),
                               rtol=1e-5, atol=1e-6)
    with helpers.helpers_disabled():
        np.testing.assert_allclose(a.output(x).numpy(), b.output(x).numpy(),
                                   rtol=1e-5, atol=1e-6)
    assert a.conf.layers[1].layers[1].seq_axis == "seq"
