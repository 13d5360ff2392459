"""The NLP stack's device steps (``deeplearning4j_tpu_torch/nlp/learning.py``)
against the JAX package's (``deeplearning4j_tpu/nlp/learning.py``) on
the same numpy inputs made from a seed, with planted row collisions and
padded (masked) rows: skip-gram and CBOW under negative sampling and
hierarchical softmax, and GloVe's AdaGrad step with duplicated rows and
columns.  Every dtype is pinned (``tests/conftest.py`` turns on jax's
x64)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nlp import learning as jl
from deeplearning4j_tpu_torch.nlp import learning as tl
from deeplearning4j_tpu_torch.nlp.lookup import InMemoryLookupTable
from deeplearning4j_tpu_torch.nlp.vocab import VocabCache, VocabWord

TOL = dict(rtol=1e-5, atol=1e-6)
V, D, B, K, L, C = 40, 16, 32, 5, 6, 6


def _case(seed):
    """Matrices, batch indices with planted collisions (rows 3 and 7 hit
    many times on both sides) and the last quarter of the batch padded."""
    rs = np.random.RandomState(seed)
    syn0 = ((rs.rand(V, D) - 0.5) / D).astype(np.float32)
    syn1 = (rs.randn(V, D) * 0.1).astype(np.float32)
    inputs = rs.randint(0, V, B).astype(np.int32)
    targets = rs.randint(0, V, B).astype(np.int32)
    inputs[::4] = 3
    targets[1::5] = 7
    negs = rs.randint(0, V, (B, K)).astype(np.int32)
    negs[:, 0] = 7
    mask = np.ones(B, np.float32)
    mask[-B // 4:] = 0.0
    lengths = rs.randint(1, L + 1, B)
    code_mask = (np.arange(L)[None, :] < lengths[:, None]).astype(np.float32)
    points = (rs.randint(0, V - 1, (B, L)) * code_mask).astype(np.int32)
    points[:, 0] = 3
    codes = (rs.rand(B, L) < 0.5).astype(np.float32) * code_mask
    ctx = rs.randint(0, V, (B, C)).astype(np.int32)
    ctx[:, 0] = 3
    width = rs.randint(1, C + 1, B)
    ctx[np.arange(C)[None, :] >= width[:, None]] = -1
    ctx_mask = (ctx >= 0).astype(np.float32)
    return dict(syn0=syn0, syn1=syn1, inputs=inputs, targets=targets,
                negs=negs, mask=mask, points=points, codes=codes,
                code_mask=code_mask, ctx=ctx, ctx_mask=ctx_mask,
                lr=np.float32(0.3))


def _t(a):
    return torch.as_tensor(np.array(a))


def _j(a):
    return jnp.asarray(np.array(a))


def _held(ours, theirs, loss, jloss):
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_sg_ns_step_matches_jax(seed):
    c = _case(seed)
    args = [c[k] for k in ("inputs", "targets", "negs", "mask")]
    j0, j1, jloss = jl.sg_ns_step(_j(c["syn0"]), _j(c["syn1"]),
                                  *map(_j, args), jnp.float32(c["lr"]))
    s0, s1 = _t(c["syn0"]), _t(c["syn1"])
    loss = tl.sg_ns_step(s0, s1, *map(_t, args), _t(c["lr"]))
    _held((s0, s1), (j0, j1), loss, jloss)


@pytest.mark.parametrize("seed", [0, 1])
def test_sg_hs_step_matches_jax(seed):
    c = _case(seed)
    args = [c[k] for k in ("inputs", "points", "codes", "code_mask", "mask")]
    j0, j1, jloss = jl.sg_hs_step(_j(c["syn0"]), _j(c["syn1"]),
                                  *map(_j, args), jnp.float32(c["lr"]))
    s0, s1 = _t(c["syn0"]), _t(c["syn1"])
    loss = tl.sg_hs_step(s0, s1, *map(_t, args), _t(c["lr"]))
    _held((s0, s1), (j0, j1), loss, jloss)


@pytest.mark.parametrize("seed", [0, 1])
def test_cbow_ns_step_matches_jax(seed):
    c = _case(seed)
    args = [c[k] for k in ("ctx", "ctx_mask", "targets", "negs", "mask")]
    j0, j1, jloss = jl.cbow_ns_step(_j(c["syn0"]), _j(c["syn1"]),
                                    *map(_j, args), jnp.float32(c["lr"]))
    s0, s1 = _t(c["syn0"]), _t(c["syn1"])
    loss = tl.cbow_ns_step(s0, s1, *map(_t, args), _t(c["lr"]))
    _held((s0, s1), (j0, j1), loss, jloss)


@pytest.mark.parametrize("seed", [0, 1])
def test_cbow_hs_step_matches_jax(seed):
    c = _case(seed)
    args = [c[k] for k in ("ctx", "ctx_mask", "points", "codes", "code_mask",
                           "mask")]
    j0, j1, jloss = jl.cbow_hs_step(_j(c["syn0"]), _j(c["syn1"]),
                                    *map(_j, args), jnp.float32(c["lr"]))
    s0, s1 = _t(c["syn0"]), _t(c["syn1"])
    loss = tl.cbow_hs_step(s0, s1, *map(_t, args), _t(c["lr"]))
    _held((s0, s1), (j0, j1), loss, jloss)


def _glove_case(seed):
    """A GloVe batch whose rows and columns repeat (row 2 and column 5
    many times, the pair (2, 5) twice) and whose tail is padding."""
    rs = np.random.RandomState(seed)
    state = [((rs.rand(V, D) - 0.5) / D).astype(np.float32),
             ((rs.rand(V, D) - 0.5) / D).astype(np.float32),
             (rs.randn(V) * 0.1).astype(np.float32),
             (rs.randn(V) * 0.1).astype(np.float32),
             (1.0 + rs.rand(V, D)).astype(np.float32),
             (1.0 + rs.rand(V, D)).astype(np.float32),
             (1.0 + rs.rand(V)).astype(np.float32),
             (1.0 + rs.rand(V)).astype(np.float32)]
    rows = rs.randint(0, V, B).astype(np.int32)
    cols = rs.randint(0, V, B).astype(np.int32)
    rows[::3] = 2
    cols[::4] = 5
    rows[1], cols[1], rows[9], cols[9] = 2, 5, 2, 5
    xij = (rs.rand(B) * 150 + 0.5).astype(np.float32)
    mask = np.ones(B, np.float32)
    mask[-5:] = 0.0
    xij[-5:] = 1.0
    return state, [rows, cols, xij, mask]


@pytest.mark.parametrize("seed", [0, 1])
def test_glove_step_matches_jax_with_duplicates(seed):
    state, batch = _glove_case(seed)
    scal = (0.05, 100.0, 0.75)
    jout = jl.glove_step(*map(_j, state), *map(_j, batch),
                         *(jnp.float32(s) for s in scal))
    ts = [_t(a) for a in state]
    loss = tl.glove_step(*ts, *map(_t, batch),
                         *(torch.tensor(s, dtype=torch.float32)
                           for s in scal))
    _held(ts, jout[:8], loss, jout[8])


def test_glove_accumulates_before_it_gathers():
    """A row taken twice in one batch is scaled by the accumulator after
    both squared gradients: the AdaGrad order of the reference."""
    state, _ = _glove_case(3)
    ts = [_t(a) for a in state]
    hw0 = ts[4][2].clone()
    rows = torch.tensor([2, 2], dtype=torch.int32)
    cols = torch.tensor([5, 6], dtype=torch.int32)
    xij = torch.tensor([3.0, 7.0])
    wi, wj = ts[0][rows].clone(), ts[1][cols].clone()
    diff = ((wi * wj).sum(1) + ts[2][rows] + ts[3][cols] - torch.log(xij))
    g = torch.clamp((xij / 100.0) ** 0.75, max=1.0) * diff
    gw = g[:, None] * wj
    w_before = ts[0][2].clone()
    tl.glove_step(*ts, rows, cols, xij, torch.ones(2),
                  torch.tensor(0.05), torch.tensor(100.0), torch.tensor(0.75))
    hist = hw0 + gw[0] ** 2 + gw[1] ** 2
    want = w_before - (0.05 / torch.sqrt(hist + 1e-8)) * (gw[0] + gw[1])
    np.testing.assert_allclose(ts[0][2].numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-7)


def test_update_out_false_leaves_the_output_rows():
    c = _case(4)
    s0, s1 = _t(c["syn0"]), _t(c["syn1"])
    ref0 = _t(c["syn0"])
    ref1 = _t(c["syn1"])
    tl.sg_hs_step(ref0, ref1, *(_t(c[k]) for k in (
        "inputs", "points", "codes", "code_mask", "mask")), _t(c["lr"]))
    tl.sg_hs_step(s0, s1, *(_t(c[k]) for k in (
        "inputs", "points", "codes", "code_mask", "mask")), _t(c["lr"]),
        update_out=False)
    assert torch.equal(s1, _t(c["syn1"]))
    assert torch.equal(s0, ref0)
    s0, s1 = _t(c["syn0"]), _t(c["syn1"])
    tl.sg_ns_step(s0, s1, *(_t(c[k]) for k in (
        "inputs", "targets", "negs", "mask")), _t(c["lr"]), update_out=False)
    assert torch.equal(s1, _t(c["syn1"]))


def test_negatives_stay_below_the_row_count():
    """Every sampled row is a row of the table, the tail of the float32
    cumulative included (a uniform above its last value takes the last
    row); the same key draws the same rows; a device key and a generator
    of one seed draw the same rows."""
    from deeplearning4j_tpu_torch.backend import rng

    cache = VocabCache()
    for i in range(V):
        cache.add_token(VocabWord(label=f"w{i}", element_frequency=1 + i % 7))
    cache.finalize_vocab()
    lk = InMemoryLookupTable(cache, D, negative=5, device="cpu")
    lk.reset_weights()
    lk._neg_cdf[-1] = 0.5      # half of the uniforms fall past the end
    a = lk.sample_negatives(rng.device_key(9, "cpu"), (64, K))
    assert a.dtype == torch.int32 and a.shape == (64, K)
    assert int(a.min()) >= 0 and int(a.max()) == V - 1
    assert torch.equal(a, lk.sample_negatives(rng.device_key(9, "cpu"),
                                              (64, K)))
    assert torch.equal(a, lk.sample_negatives(
        torch.Generator().manual_seed(9), (64, K)))
    assert not torch.equal(a, lk.sample_negatives(rng.device_key(10, "cpu"),
                                                  (64, K)))


def test_sampled_frequencies_follow_the_unigram_power():
    from deeplearning4j_tpu_torch.backend import rng

    cache = VocabCache()
    freqs = [1000, 300, 100, 30, 10]
    for i, f in enumerate(freqs):
        cache.add_token(VocabWord(label=f"w{i}", element_frequency=f))
    cache.finalize_vocab()
    lk = InMemoryLookupTable(cache, 4, negative=5, device="cpu")
    lk.reset_weights()
    draws = lk.sample_negatives(rng.device_key(1, "cpu"), (200000,))
    got = np.bincount(draws.numpy(), minlength=5) / 200000
    p = np.asarray(freqs, np.float64) ** 0.75
    np.testing.assert_allclose(got, p / p.sum(), atol=5e-3)
