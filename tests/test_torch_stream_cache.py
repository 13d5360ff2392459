"""The port's stream caches against the JAX package's, on the CPU: the
linear and rolling KV caches of ``SelfAttentionLayer.apply_with_carry``,
``dot_product_attention``'s offsets and positions, the residual block's
caches, the facades' ``rnn_time_step`` / ``rnn_clear_previous_state``
and the host-side capacity check.

Every input is made with numpy from a seed and every dtype is float32;
the weights are the JAX layer's or net's, carried across.  Tolerance:
``atol=1e-5`` for outputs and caches (float32, different summation
orders); positions exactly."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.models.common import (
    check_cache_capacity as jax_check_capacity,
)
from deeplearning4j_tpu.models.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.models.zoo import transformer_char_lm as jax_lm
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.layers import (
    EmbeddingLayer as JEmbedding, LayerNorm as JLayerNorm,
    ResidualBlock as JResidualBlock, RnnOutputLayer as JRnnOutput,
    SelfAttentionLayer as JSelfAttention,
)
from deeplearning4j_tpu.nn.layers.attention import (
    dot_product_attention as jax_dpa,
)
from deeplearning4j_tpu_torch.models.common import check_cache_capacity
from deeplearning4j_tpu_torch.models.graph import GraphConfiguration
from deeplearning4j_tpu_torch.models.interop import (
    graph_params_from_numpy, params_from_numpy,
)
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.layers import layer_from_dict
from deeplearning4j_tpu_torch.nn.layers.attention import dot_product_attention
from deeplearning4j_tpu_torch.nn.layers.base import Layer, register_layer

ATOL = 1e-5


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree, np.float32))


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL)


def _same_cache(port, ref):
    """The port's cache against the JAX one: k, v within ATOL; pos and
    kpos exactly, in int32."""
    assert sorted(port) == sorted(ref)
    _close(port["k"].numpy(), ref["k"])
    _close(port["v"].numpy(), ref["v"])
    assert port["pos"].dtype == torch.int32 and port["pos"].ndim == 0
    assert int(port["pos"]) == int(ref["pos"])
    if "kpos" in ref:
        assert port["kpos"].dtype == torch.int32
        np.testing.assert_array_equal(port["kpos"].numpy(),
                                      np.asarray(ref["kpos"]))


# ------------------------------------------------------ dot_product_attention
@pytest.mark.parametrize("kind", ["offsets", "tensor_offset", "positions"])
def test_dot_product_attention_offsets_and_positions(kind):
    q, k, v = _x(0, 2, 3, 4, 8), _x(1, 2, 7, 2, 8), _x(2, 2, 7, 2, 8)
    if kind == "positions":
        # a rolling ring's out-of-order keys
        qpos = np.array([9, 10, 11], np.int32)
        kpos = np.array([8, 5, 6, 7, -(2 ** 30), 9, 10], np.int32)
        kw = dict(q_positions=qpos, k_positions=kpos)
    else:
        kw = dict(q_offset=4, k_offset=1)
    ref = jax_dpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=True, window=3,
                  **{n: jnp.asarray(a) for n, a in kw.items()})
    pkw = {n: torch.from_numpy(a) if isinstance(a, np.ndarray) else a
           for n, a in kw.items()}
    if kind == "tensor_offset":
        pkw["q_offset"] = torch.tensor(4, dtype=torch.int32)
    out = dot_product_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=True, window=3,
                                **pkw)
    _close(out.numpy(), ref)


# ------------------------------------------------------------------- layer
STREAM = {
    # name: (layer fields, chunk lengths)
    "linear": (dict(n_heads=4, max_cache=12), (5, 1, 1, 3)),
    "linear_gqa_rope": (dict(n_heads=4, n_kv_heads=2, rope=True,
                             max_cache=12), (5, 1, 1, 3)),
    "rolling": (dict(n_heads=4, window=4), (5, 1, 1, 3, 6)),
    "rolling_gqa_rope": (dict(n_heads=4, n_kv_heads=1, window=4, rope=True),
                         (5, 1, 1, 3, 6, 1)),
}


@pytest.mark.parametrize("name", sorted(STREAM))
def test_self_attention_stream_cache_matches_jax(name):
    fields, chunks = STREAM[name]
    jl = JSelfAttention(n_in=16, n_out=16, causal=True, flash=False,
                        **fields)
    params = _np_tree(jl.init(jax.random.PRNGKey(3), jnp.float32))
    pl, pp = layer_from_dict(jl.to_dict()), _torch_tree(params)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jcache = jl.init_cache(2, jnp.float32)
    pcache = pl.init_cache(2, torch.float32, "cpu")
    _same_cache(pcache, jcache)
    x = _x(4, 2, sum(chunks), 16)
    at = 0
    for t in chunks:
        chunk = x[:, at:at + t]
        at += t
        ref, _, jcache = jl.apply_with_carry(jp, {}, jnp.asarray(chunk),
                                             jcache)
        out, got = pl.apply_with_carry(pp, torch.from_numpy(chunk), pcache)
        assert got is pcache     # updated in place, handed back
        _close(out.numpy(), ref)
        _same_cache(pcache, jcache)


def test_linear_cache_overflow_is_refused_at_the_same_position():
    jl = JSelfAttention(n_in=8, n_out=8, n_heads=2, causal=True,
                        max_cache=6)
    pl = layer_from_dict(jl.to_dict())
    jc, pc = jl.init_cache(1), pl.init_cache(1, device="cpu")
    for pos, t, over in [(0, 6, False), (0, 7, True), (4, 2, False),
                         (4, 3, True), (5, 1, False), (6, 1, True)]:
        assert pl.cache_overflow(pc, t, pos=pos) is over
        assert jl.cache_overflow(jc, t, pos=pos) is over
    with pytest.raises(ValueError) as jerr:
        jax_check_capacity({"attn": jc}, 3, pos=4)
    with pytest.raises(ValueError) as err:
        check_cache_capacity({"attn": pc}, 3, pos=4)
    assert str(err.value) == str(jerr.value)
    assert "max_cache=6" in str(err.value)
    # without a host position the device scalar is read
    pc["pos"].fill_(5)
    assert pl.cache_overflow(pc, 2) and not pl.cache_overflow(pc, 1)
    # a rolling cache never overflows
    rl = layer_from_dict(dataclasses.replace(jl, window=3).to_dict())
    assert not rl.cache_overflow(rl.init_cache(1, device="cpu"), 100, pos=0)


def test_residual_block_caches_match_jax():
    attn = JSelfAttention(n_in=8, n_out=8, n_heads=2, causal=True,
                          max_cache=9)
    jb = JResidualBlock(layers=(JLayerNorm(n_in=8), attn))
    mlp = JResidualBlock(layers=(JLayerNorm(n_in=8),))
    pb = layer_from_dict(jb.to_dict())
    jc, pc = jb.init_cache(3), pb.init_cache(3, device="cpu")
    assert sorted(pc) == sorted(jc) == ["sub1"]
    assert tuple(pc["sub1"]["k"].shape) == jc["sub1"]["k"].shape
    assert layer_from_dict(mlp.to_dict()).init_cache(3) is None
    assert mlp.init_cache(3) is None


# ------------------------------------------------------------------ facades
VOCAB = 23


def _mln_pair(**kw):
    jnet = jax_lm(vocab_size=VOCAB, d_model=16, n_heads=4, layers=2,
                  seed=9, **kw)
    conf = MultiLayerConfiguration.from_json(jnet.conf.to_json())
    return jnet, params_from_numpy(conf, jax.device_get(jnet.params),
                                   device="cpu")


def _cg_pair(collapse=False):
    conf = (JNNC.builder().seed(6).updater("sgd", learning_rate=0.1).graph()
            .add_inputs("ids")
            .add_layer("emb", JEmbedding(n_in=VOCAB, n_out=16,
                                         collapse_column=collapse), "ids")
            .add_layer("attn", JSelfAttention(n_in=16, n_out=16, n_heads=2,
                                              causal=True, rope=True,
                                              max_cache=32), "emb")
            .add_layer("ln", JLayerNorm(n_in=16), "attn")
            .add_layer("out", JRnnOutput(n_in=16, n_out=VOCAB,
                                         loss="mcxent",
                                         activation="softmax"), "ln")
            .set_outputs("out").build())
    jnet = JGraph(conf).init()
    pconf = GraphConfiguration.from_json(conf.to_json())
    return jnet, graph_params_from_numpy(pconf, jax.device_get(jnet.params),
                                         device="cpu")


FACADES = {
    "mln_linear": lambda: _mln_pair(max_cache=32),
    "mln_rolling_gqa": lambda: _mln_pair(n_kv_heads=2, window=5),
    "cg": lambda: _cg_pair(),
    "cg_collapse_column": lambda: _cg_pair(collapse=True),
}


@pytest.mark.parametrize("name", sorted(FACADES))
def test_rnn_time_step_matches_jax(name):
    jnet, net = FACADES[name]()
    ids = np.random.default_rng(1).integers(0, VOCAB, (3, 9))
    feeds = [ids[:, :4], ids[:, 4], ids[:, 5:6], ids[:, 6:]]
    for feed in feeds:
        ref = np.asarray(jnet.rnn_time_step(feed))
        got = net.rnn_time_step(feed)
        assert got.dtype == torch.float32 and got.shape == ref.shape
        _close(got.numpy(), ref)
    assert net._stream_pos == 9
    # clearing restarts the stream: the first chunk again gives the same
    net.rnn_clear_previous_state()
    jnet.rnn_clear_previous_state()
    assert net._stream_pos == 0 and not net._rnn_state
    again = net.rnn_time_step(feeds[0])
    _close(again.numpy(), np.asarray(jnet.rnn_time_step(feeds[0])))
    # without the clear, the stream goes on from where it stood
    on = net.rnn_time_step(feeds[0])
    assert not np.allclose(on.numpy(), again.numpy())


def test_rnn_time_step_streams_like_output():
    """The streamed steps of a linear-cache stack equal the full-sequence
    ``output`` at every position."""
    _, net = _mln_pair(max_cache=32)
    ids = np.random.default_rng(2).integers(0, VOCAB, (2, 7))
    full = net.output(ids).numpy()
    steps = [net.rnn_time_step(ids[:, i]).numpy() for i in range(7)]
    _close(np.stack(steps, axis=1), full)


def test_rnn_time_step_refuses_overflow_before_the_call():
    jnet, net = _mln_pair(max_cache=8)
    ids = np.zeros((1, 6), np.int64)
    net.rnn_time_step(ids)
    jnet.rnn_time_step(ids)
    with pytest.raises(ValueError) as err:
        net.rnn_time_step(ids[:, :3])
    with pytest.raises(ValueError) as jerr:
        jnet.rnn_time_step(ids[:, :3])
    assert str(err.value) == str(jerr.value)
    assert net._stream_pos == 6       # the refused chunk changed nothing


@register_layer
@dataclasses.dataclass(frozen=True)
class _CarriesState(Layer):
    """A stand-in recurrent layer: the identity, carrying the count of
    timesteps it has seen, with no stream cache and no params."""

    def has_params(self) -> bool:
        return False

    def apply_with_carry(self, params, x, carry, **kw):
        return x, (0 if carry is None else carry) + x.shape[1]


@pytest.mark.parametrize("facade", ["mln", "cg"])
def test_rnn_time_step_over_a_recurrent_layer_names_a6(facade):
    """A stack holding a layer that carries recurrent state (ROADMAP A6,
    ported) streams: the layer's carry goes from call to call, and the
    outputs are the stack's without it (the stand-in is the identity)."""
    from deeplearning4j_tpu_torch.models.graph import (
        ComputationGraph, GraphNode,
    )
    from deeplearning4j_tpu_torch.models.sequential import MultiLayerNetwork

    if facade == "mln":
        _, base = _mln_pair(max_cache=8)
        layers = base.conf.layers[:1] + (_CarriesState(name="rnn"),) \
            + base.conf.layers[1:]
        net = MultiLayerNetwork(dataclasses.replace(base.conf,
                                                    layers=layers))
    else:
        _, base = _cg_pair()
        nodes = base.conf.nodes + (GraphNode("rnn", ("emb",),
                                             layer=_CarriesState(name="rnn")),)
        net = ComputationGraph(dataclasses.replace(base.conf, nodes=nodes))
    net.params = {**base.params, "rnn": {}}
    net.device = base.device
    ids = np.random.default_rng(5).integers(0, VOCAB, (1, 5))
    for chunk in (ids[:, :2], ids[:, 2:]):
        _close(net.rnn_time_step(chunk).numpy(),
               base.rnn_time_step(chunk).numpy())
    assert net._rnn_state["rnn"] == 5
