"""The port's ``generate``, ``sample_sequence`` and engine sampler against
the JAX package's, on the CPU.

- ``generate`` (greedy) gives the JAX ``generate``'s ids for the cases
  of the reference's ``tests/test_decode.py``: a linear cache, a GQA
  rolling cache decoded past its window, the one-hot GravesLSTM char-LM
  on both facades (``:50`` and ``:127``: the LSTM carries through the
  loop), a ``ComputationGraph`` attention stack, a collapse-column
  embedding, and one-hot inputs whose width comes from the input-side
  layer (the reference's LSTM variants of the last three take an
  attention stack here).
- ``sample_sequence`` (the host loop over ``rnn_time_step``) equals
  ``generate`` greedily, as in the reference; the overflow is refused up
  front; a multi-input graph is refused with the reference's guidance.
- Sampled ``generate``: shape, the same seed gives the same ids,
  ``top_k=1`` is greedy, and the ids are ``sample_sequence``'s with the
  same seed (both read step i's noise at step i).  The port's draws are
  its own (torch generators), so they are not compared with JAX's.
- Every cached loop of a net reads one parameter tree (in float32 the
  net's own tensors), brought up to the net's weights at every call;
  the cache keeps at most ``GRAPH_CACHE_SIZE`` loops.
- ``sample_rows`` with ``fill_row_noise`` equals the engine's earlier
  per-row sampler (kept here as the reference) bit for bit.

Weights are the JAX nets', carried across; every dtype is float32.
Greedy ids must be equal."""

import numpy as np
import pytest
import torch

import jax

from deeplearning4j_tpu.models.decode import generate as jax_generate
from deeplearning4j_tpu.models.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.models.sequential import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.models.vertices import MergeVertex as JMerge
from deeplearning4j_tpu.models.zoo import (
    graves_lstm_char_lm as jax_lstm_lm, transformer_char_lm as jax_lm,
)
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.layers import (
    DenseLayer as JDense, EmbeddingLayer as JEmbedding,
    GravesLSTM as JGraves,
    LayerNorm as JLayerNorm, OutputLayer as JOutput,
    RnnOutputLayer as JRnnOutput, SelfAttentionLayer as JSelfAttention,
)
from deeplearning4j_tpu_torch.models.decode import (
    GRAPH_CACHE_SIZE, build_decode_fn, generate, named_layers_of,
)
from deeplearning4j_tpu_torch.models.common import (
    seed_stream_caches, tree_clone, tree_leaves,
)
from deeplearning4j_tpu_torch.models.graph import GraphConfiguration
from deeplearning4j_tpu_torch.models.interop import (
    graph_params_from_numpy, params_from_numpy,
)
from deeplearning4j_tpu_torch.models.zoo import (
    transformer_char_lm as port_lm,
)
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.utils.sampling import (
    _draw_seed, _filter_logits, fill_row_noise, sample_rows, sample_sequence,
    step_noise,
)


def _port(jnet):
    params = jax.device_get(jnet.params)
    if isinstance(jnet, JMLN):
        conf = MultiLayerConfiguration.from_json(jnet.conf.to_json())
        return params_from_numpy(conf, params, device="cpu")
    conf = GraphConfiguration.from_json(jnet.conf.to_json())
    return graph_params_from_numpy(conf, params, device="cpu")


def _prompt(seed, vocab, shape):
    return np.random.RandomState(seed).randint(0, vocab, shape)


def _graph(seed, inputs, layers, outputs=("out",)):
    g = (JNNC.builder().seed(seed).updater("sgd", learning_rate=0.1)
         .graph().add_inputs(*inputs))
    for name, layer, ins in layers:
        if isinstance(layer, JMerge):
            g = g.add_vertex(name, layer, *ins)
        else:
            g = g.add_layer(name, layer, *ins)
    return JGraph(g.set_outputs(*outputs).build()).init()


def _cg_attention(vocab=13, d=16, collapse=False):
    """Reference ``test_decode.py:96`` (collapse=False) and the attention
    counterpart of its collapse-column case (``:170``)."""
    return _graph(6 if not collapse else 8, ("ids",), [
        ("emb", JEmbedding(n_in=vocab, n_out=d, collapse_column=collapse),
         ("ids",)),
        ("attn", JSelfAttention(n_in=d, n_out=d, n_heads=2, causal=True,
                                max_cache=64), ("emb",)),
        ("ln", JLayerNorm(n_in=d), ("attn",)),
        ("out", JRnnOutput(n_in=d, n_out=vocab, loss="mcxent",
                           activation="softmax"), ("ln",))])


def _cg_lstm(vocab=11, hidden=12):
    """Reference ``test_decode.py:102`` (``_cg_lstm_char_lm``)."""
    return _graph(5, ("in",), [
        ("lstm", JGraves(n_in=vocab, n_out=hidden), ("in",)),
        ("out", JRnnOutput(n_in=hidden, n_out=vocab, loss="mcxent",
                           activation="softmax"), ("lstm",))])


def _cg_one_hot(n_in=30, vocab=11):
    """One-hot input whose width is the input-side layer's n_in (30), not
    the head's n_out (11): reference ``test_decode.py:198``."""
    return _graph(10, ("in",), [
        ("attn", JSelfAttention(n_in=n_in, n_out=16, n_heads=2, causal=True,
                                max_cache=16), ("in",)),
        ("out", JRnnOutput(n_in=16, n_out=vocab, loss="mcxent",
                           activation="softmax"), ("attn",))])


def _mln_one_hot(n_in=30, vocab=11):
    """The sequential counterpart (reference ``test_decode.py:220``)."""
    b = (JNNC.builder().seed(12).updater("sgd", learning_rate=0.1).list()
         .layer(JSelfAttention(n_in=n_in, n_out=16, n_heads=2, causal=True,
                               max_cache=16))
         .layer(JRnnOutput(n_in=16, n_out=vocab, loss="mcxent",
                           activation="softmax")))
    return JMLN(b.build()).init()


# name: (JAX net, prompt seed, vocab, prompt shape, steps)
GREEDY = {
    "linear": (lambda: jax_lm(vocab_size=17, d_model=16, n_heads=2,
                              layers=2, max_cache=64), 0, 17, (3, 5), 12),
    "gqa_rolling": (lambda: jax_lm(vocab_size=13, d_model=16, n_heads=4,
                                   layers=2, n_kv_heads=2, window=8),
                    1, 13, (2, 6), 20),
    "mln_lstm": (lambda: jax_lstm_lm(vocab_size=11, hidden=12, tbptt=8),
                 2, 11, (2, 4), 10),
    "cg_lstm": (_cg_lstm, 3, 11, (2, 4), 10),
    "cg_attention": (_cg_attention, 4, 13, (3, 5), 12),
    "cg_collapse_column": (lambda: _cg_attention(vocab=11, collapse=True),
                           9, 11, (2, 4), 6),
    "cg_one_hot": (_cg_one_hot, 10, 30, (2, 3), 4),
    "mln_one_hot": (_mln_one_hot, 12, 30, (2, 3), 4),
}


@pytest.mark.parametrize("name", sorted(GREEDY))
def test_greedy_generate_matches_jax_and_the_host_loop(name):
    make, seed, vocab, shape, steps = GREEDY[name]
    jnet = make()
    net = _port(jnet)
    prompt = _prompt(seed, vocab, shape)
    ref = np.asarray(jax_generate(jnet, prompt, steps, temperature=0.0))
    got = generate(net, prompt, steps, temperature=0.0)
    assert got.shape == (shape[0], steps) and got.dtype == np.int64
    np.testing.assert_array_equal(got, ref)
    if name.endswith("one_hot"):
        assert got.max() < 11       # the head's width, not the input's
    loop = sample_sequence(net, prompt, steps, temperature=0.0)
    np.testing.assert_array_equal(loop, got)
    # the eager function build_decode_fn returns is the same generation
    one_hot = name.endswith(("one_hot", "lstm"))
    fn = build_decode_fn(net, steps, temperature=0.0, one_hot=one_hot,
                         vocab_size=(30 if name.endswith("one_hot") else
                                     vocab if one_hot else None))
    carries = seed_stream_caches(named_layers_of(net), {}, shape[0], None,
                                 "cpu")
    ids, _ = fn(net.compute_params(), carries, torch.as_tensor(prompt))
    np.testing.assert_array_equal(ids.numpy(), got)


def test_generate_overflow_checked_upfront():
    """Reference ``test_decode.py:77``."""
    net = _port(jax_lm(vocab_size=8, d_model=8, n_heads=2, layers=1,
                       max_cache=6))
    prompt = np.zeros((1, 4), np.int64)
    with pytest.raises(ValueError, match="max_cache"):
        generate(net, prompt, 5)             # 4 + 5 - 1 > 6
    assert not net._graph_cache
    assert generate(net, prompt, 2).shape == (1, 2)
    assert generate(net, prompt, 3).shape == (1, 3)   # 4 + 3 - 1 = 6


def test_generate_caches_one_program_per_key():
    net = _port(jax_lm(vocab_size=17, d_model=16, n_heads=2, layers=1,
                       max_cache=32))
    prompt = _prompt(3, 17, (2, 3))
    a = generate(net, prompt, 5, temperature=0.0)
    b = generate(net, prompt, 5, temperature=0.0)
    np.testing.assert_array_equal(a, b)
    assert len(net._graph_cache) == 1
    generate(net, prompt, 6, temperature=0.0)
    generate(net, prompt, 5, temperature=0.7)
    assert len(net._graph_cache) == 3


def test_multi_input_graph_rejected_with_guidance():
    """Reference ``test_decode.py:150``."""
    jnet = _graph(7, ("a", "b"), [
        ("da", JDense(n_in=4, n_out=4), ("a",)),
        ("db", JDense(n_in=4, n_out=4), ("b",)),
        ("m", JMerge(), ("da", "db")),
        ("out", JOutput(n_in=8, n_out=2, loss="mcxent",
                        activation="softmax"), ("m",))])
    with pytest.raises(ValueError, match="single-input"):
        generate(_port(jnet), np.zeros((1, 3), np.int64), 2)


def test_sampled_generate_shape_determinism_and_filtering():
    """Reference ``test_decode.py:61``, with the port's own draws."""
    net = _port(jax_lm(vocab_size=17, d_model=16, n_heads=2, layers=1,
                       max_cache=64))
    prompt = _prompt(3, 17, (4, 3))
    a = generate(net, prompt, 9, temperature=0.8, top_k=5, rng=7)
    b = generate(net, prompt, 9, temperature=0.8, top_k=5, rng=7)
    assert a.shape == (4, 9)
    np.testing.assert_array_equal(a, b)      # same seed -> same draw
    c = generate(net, prompt, 9, temperature=0.8, top_k=5, rng=8)
    assert not np.array_equal(a, c)          # another seed -> another draw
    greedy = generate(net, prompt, 9, temperature=0.0)
    top1 = generate(net, prompt, 9, temperature=0.8, top_k=1, rng=7)
    np.testing.assert_array_equal(top1, greedy)
    nucleus = generate(net, prompt, 9, temperature=1.3, top_p=0.6, rng=7)
    assert nucleus.shape == (4, 9) and nucleus.max() < 17
    # the host loop draws from the same noise, slice i at step i
    loop = sample_sequence(net, prompt, 9, temperature=0.8, top_k=1, rng=7)
    np.testing.assert_array_equal(loop, greedy)
    np.testing.assert_array_equal(
        sample_sequence(net, prompt, 9, temperature=0.8, top_k=5, rng=7), a)
    np.testing.assert_array_equal(
        sample_sequence(net, prompt, 9, temperature=1.3, top_p=0.6, rng=7),
        nucleus)


def _scaled(tree, by):
    """A new tree of the floating tensors times ``by``."""
    if isinstance(tree, dict):
        return {k: _scaled(v, by) for k, v in tree.items()}
    return tree * by if tree.is_floating_point() else tree


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_cached_loops_share_the_parameters(dtype):
    net = port_lm(vocab_size=17, d_model=16, n_heads=2, layers=1,
                  max_cache=32, compute_dtype=dtype, device="cpu")
    generate(net, _prompt(3, 17, (2, 3)), 5, temperature=0.0)
    held = [t.data_ptr() for t in tree_leaves(net._graph_params)]
    generate(net, _prompt(4, 17, (2, 6)), 5, temperature=0.0)
    assert len(net._graph_cache) == 2
    assert [t.data_ptr() for t in tree_leaves(net._graph_params)] == held
    if dtype is None:       # float32: the net's own tensors, no copy
        assert held == [t.data_ptr() for t in tree_leaves(net.params)]
    # new weights (a replaced tree) reach the cached loop, in place
    net.params = _scaled(net.params, 1.5)
    prompt = _prompt(3, 17, (2, 3))
    got = generate(net, prompt, 5, temperature=0.0)
    assert [t.data_ptr() for t in tree_leaves(net._graph_params)] == held
    fresh = net.clone()
    fresh.params = tree_clone(net.params)
    np.testing.assert_array_equal(
        got, generate(fresh, prompt, 5, temperature=0.0))


def test_graph_cache_keeps_the_most_recently_used_loops():
    net = port_lm(vocab_size=17, d_model=16, n_heads=2, layers=1,
                  max_cache=64, device="cpu")
    prompt = _prompt(3, 17, (1, 2))
    for steps in range(1, GRAPH_CACHE_SIZE + 1):
        generate(net, prompt, steps, temperature=0.0)
    first = net._graph_cache[next(iter(net._graph_cache))]
    generate(net, prompt, 1, temperature=0.0)      # used again: kept
    generate(net, prompt, GRAPH_CACHE_SIZE + 1, temperature=0.0)
    assert len(net._graph_cache) == GRAPH_CACHE_SIZE
    # steps=2, the least recently used, went; the order is of last use
    assert [k[1] for k in net._graph_cache] == [
        *range(3, GRAPH_CACHE_SIZE + 1), 1, GRAPH_CACHE_SIZE + 1]
    assert [g for k, g in net._graph_cache.items() if k[1] == 1] == [first]


def test_static_filters_are_validated():
    net = _port(jax_lm(vocab_size=8, d_model=8, n_heads=2, layers=1,
                       max_cache=16))
    prompt = np.zeros((1, 2), np.int64)
    with pytest.raises(ValueError, match="top_k"):
        generate(net, prompt, 2, temperature=1.0, top_k=0)
    with pytest.raises(ValueError, match="top_p"):
        sample_sequence(net, prompt, 2, temperature=1.0, top_p=1.5)


def test_step_noise_is_seeded():
    a = step_noise(3, 4, 2, 5, "cpu")
    assert a.shape == (4, 2, 5) and a.dtype == torch.float32
    assert torch.equal(a, step_noise(3, 4, 2, 5, "cpu"))
    assert not torch.equal(a, step_noise(4, 4, 2, 5, "cpu"))


# ------------------------------------------------------------------ sampler
def _sample_tokens_reference(logits, keys, token_idx, temperature, top_k,
                             top_p):
    """The engine's per-row sampler before it took its noise from a
    buffer: the sampled rows picked on the host, each row's noise from its
    own generator."""
    out = torch.argmax(logits, dim=-1)
    temperature = np.asarray(temperature, np.float32)
    rows = np.flatnonzero(temperature > 0)
    if rows.size == 0:
        return out
    sel = torch.as_tensor(rows)
    temp = torch.as_tensor(temperature[rows])
    filtered = _filter_logits(
        logits[sel] / temp[:, None].to(logits.dtype),
        torch.as_tensor(np.asarray(top_k)[rows]),
        torch.as_tensor(np.asarray(top_p, np.float32)[rows]))
    tiny = torch.finfo(torch.float32).tiny
    noise = torch.stack([
        -torch.log(-torch.log(torch.rand(
            logits.shape[-1], generator=torch.Generator().manual_seed(
                _draw_seed(keys[r], token_idx[r]))).clamp_min(tiny)))
        for r in rows])
    out[sel] = torch.argmax(filtered + noise.to(logits.dtype), dim=-1)
    return out


@pytest.mark.parametrize("seed", range(4))
def test_sample_rows_equals_the_per_row_sampler(seed):
    rng = np.random.default_rng(seed)
    b, v = 12, 37
    logits = torch.from_numpy(
        rng.standard_normal((b, v)).astype(np.float32) * 3)
    keys = rng.integers(0, 2 ** 32, (b, 2), dtype=np.uint64).astype(
        np.uint32)
    token_idx = rng.integers(0, 100, b).astype(np.int32)
    # greedy, sampled, top-k, top-p and both filters, mixed
    temps = np.array([0, 0.7, 1.0, 1.3, 0, 0.9, 2.0, 0.5, -1, 1.1, 0.8, 1.0],
                     np.float32)
    top_ks = np.array([0, 0, 5, 0, 3, 1, 0, 9, 0, 4, 0, 50], np.int32)
    top_ps = np.array([1, 1, 1, 0.8, 1, 1, 0.3, 0.9, 0.5, 1, 0.05, 1.0],
                      np.float32)
    ref = _sample_tokens_reference(logits.clone(), keys, token_idx, temps,
                                   top_ks, top_ps)
    noise = torch.full((b, v), float("nan"))   # greedy rows never read
    fill_row_noise(noise, keys, token_idx, temps)
    got = sample_rows(logits, noise, torch.from_numpy(temps),
                      torch.from_numpy(top_ks), torch.from_numpy(top_ps))
    assert got.dtype == torch.int64
    assert torch.equal(got, ref)
