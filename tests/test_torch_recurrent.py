"""The port's recurrent stack (``deeplearning4j_tpu_torch/nn/layers/recurrent.py``,
the recurrent vertices, streaming over LSTM carries) against the JAX
package's, on the CPU.

- ``GravesLSTM``, ``LSTM`` and ``GravesBidirectionalLSTM``: the forward
  with and without a mask, with and without a carry (the bidirectional
  layer carries none), the final carries, ``step`` against ``apply``,
  and the gradients of the weights and the input against ``jax.grad``.
- The port's own init: the reference's shapes, the forget-gate bias at
  1.0, the schemes' fans, the config round trip.
- ``LastTimeStepVertex`` and ``DuplicateToTimeSeriesVertex``, masked and
  not.
- ``rnn_time_step`` fed in chunks against the JAX facades' on LSTM
  stacks and on a stack mixing an LSTM with attention, on both facades,
  and against one ``output`` over the whole sequence.

Every input is made with numpy from a seed, every dtype is float32, and
the weights are the JAX layer's or net's, carried across.  Tolerances:
outputs and carries ``atol=1e-5``; gradients ``rtol=1e-4, atol=1e-5``
(float32, different summation orders)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.models.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.models.sequential import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.models.vertices import (
    DuplicateToTimeSeriesVertex as JDuplicate,
    LastTimeStepVertex as JLastStep,
)
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.layers import (
    GravesBidirectionalLSTM as JBidi, GravesLSTM as JGraves, LSTM as JLSTM,
    OutputLayer as JOutput, RnnOutputLayer as JRnnOutput,
    SelfAttentionLayer as JSelfAttention,
)
from deeplearning4j_tpu_torch.models.graph import GraphConfiguration
from deeplearning4j_tpu_torch.models.interop import (
    graph_params_from_numpy, params_from_numpy,
)
from deeplearning4j_tpu_torch.models.vertices import vertex_from_dict
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.layers import GravesLSTM, layer_from_dict

ATOL = 1e-5
RTOL_GRAD, ATOL_GRAD = 1e-4, 1e-5
N_IN, HID, B, T = 5, 7, 3, 9


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _torch_tree(tree, grad=False):
    if isinstance(tree, dict):
        return {k: _torch_tree(v, grad) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree, np.float32), requires_grad=grad)


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _mask(seed, b=B, t=T):
    """[B, T] float mask with ragged lengths (row 0 full, another with
    gaps inside), as the reference's masking tests use."""
    rs = np.random.default_rng(seed)
    m = (rs.random((b, t)) > 0.3).astype(np.float32)
    m[0] = 1.0
    return m


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol)


_CLASSES = {"GravesLSTM": JGraves, "LSTM": JLSTM,
            "GravesBidirectionalLSTM": JBidi}


def _pair(name, key=0, **kw):
    """(JAX layer, its params as numpy, the port layer)."""
    jl = _CLASSES[name](n_in=N_IN, n_out=HID, **kw)
    params = _np_tree(jl.init(jax.random.PRNGKey(key), jnp.float32))
    return jl, params, layer_from_dict(jl.to_dict())


# ------------------------------------------------------------------ layers
@pytest.mark.parametrize("name,masked,carried", [
    ("GravesLSTM", False, False), ("GravesLSTM", True, False),
    ("GravesLSTM", False, True), ("GravesLSTM", True, True),
    ("LSTM", False, False), ("LSTM", True, False), ("LSTM", False, True),
    ("LSTM", True, True),
    ("GravesBidirectionalLSTM", False, False),
    ("GravesBidirectionalLSTM", True, False)])
def test_forward_matches_jax(name, masked, carried):
    jl, params, pl = _pair(name)
    x = _x(1, B, T, N_IN)
    mask = _mask(2) if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    pp = _torch_tree(params)
    if name == "GravesBidirectionalLSTM":
        ref, _ = jl.apply(params, {}, jnp.asarray(x), mask=jm)
        out = pl.apply(pp, torch.from_numpy(x), mask=tm)
        _close(out.numpy(), ref)
        return
    carry = ((_x(3, B, HID), _x(4, B, HID)) if carried else None)
    ref, _, (rh, rc) = jl.apply_with_carry(
        params, {}, jnp.asarray(x),
        None if carry is None else tuple(map(jnp.asarray, carry)), mask=jm)
    out, (h, c) = pl.apply_with_carry(
        pp, torch.from_numpy(x),
        None if carry is None else tuple(map(torch.from_numpy, carry)),
        mask=tm)
    assert out.shape == (B, T, HID)
    _close(out.numpy(), ref)
    _close(h.numpy(), rh)
    _close(c.numpy(), rc)
    if masked:
        # a masked step emits 0
        assert np.all(out.numpy()[mask == 0] == 0)
    # apply is apply_with_carry without its carry
    _close(pl.apply(pp, torch.from_numpy(x), mask=tm).numpy(),
           jl.apply(params, {}, jnp.asarray(x), mask=jm)[0])


@pytest.mark.parametrize("name", ["GravesLSTM", "LSTM",
                                  "GravesBidirectionalLSTM"])
@pytest.mark.parametrize("masked", [False, True])
def test_gradients_match_jax(name, masked):
    """d sum(w * y) / d(params, x) against ``jax.grad`` of the same."""
    jl, params, pl = _pair(name, key=5)
    x = _x(6, B, T, N_IN)
    w = _x(7, B, T, HID)
    mask = _mask(8) if masked else None

    def jloss(p, xx):
        y, _ = jl.apply(p, {}, xx, mask=None if mask is None
                        else jnp.asarray(mask))
        return jnp.sum(y * jnp.asarray(w))

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    pp = _torch_tree(params, grad=True)
    tx = torch.tensor(x, requires_grad=True)
    y = pl.apply(pp, tx, mask=None if mask is None
                 else torch.from_numpy(mask))
    (y * torch.from_numpy(w)).sum().backward()
    assert sorted(pp) == sorted(jg)
    for k in pp:
        np.testing.assert_allclose(pp[k].grad.numpy(), np.asarray(jg[k]),
                                   rtol=RTOL_GRAD, atol=ATOL_GRAD,
                                   err_msg=k)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx),
                               rtol=RTOL_GRAD, atol=ATOL_GRAD)


@pytest.mark.parametrize("name", ["GravesLSTM", "LSTM"])
def test_step_matches_apply_and_jax(name):
    """``step`` over the timesteps one by one is ``apply``; each step is
    the JAX layer's ``step``."""
    jl, params, pl = _pair(name, key=9)
    pp = _torch_tree(params)
    x = _x(10, B, T, N_IN)
    carry = pl.initial_carry(B)
    jcarry = jl.initial_carry(B)
    assert all(torch.equal(c, torch.zeros(B, HID)) for c in carry)
    ys = []
    for t in range(T):
        y, carry = pl.step(pp, carry, torch.from_numpy(x[:, t]))
        jy, jcarry = jl.step(params, jcarry, jnp.asarray(x[:, t]))
        _close(y.numpy(), jy)
        ys.append(y)
    _close(torch.stack(ys, 1).numpy(),
           pl.apply(pp, torch.from_numpy(x)).numpy())
    _close(carry[1].numpy(), jcarry[1])


def test_bidirectional_sums_a_forward_and_a_reversed_lstm():
    """The backward direction is a GravesLSTM over reversed time whose
    output is flipped back: with a mask too (the reverse scan freezes
    the state in reversed time)."""
    _, params, pl = _pair("GravesBidirectionalLSTM", key=11)
    x = _x(12, B, T, N_IN)
    mask = _mask(13)
    pp = _torch_tree(params)
    one = GravesLSTM(n_in=N_IN, n_out=HID)
    fwd = one.apply({k[2:]: v for k, v in pp.items() if k[:2] == "f_"},
                    torch.from_numpy(x), mask=torch.from_numpy(mask))
    bwd = one.apply({k[2:]: v for k, v in pp.items() if k[:2] == "b_"},
                    torch.from_numpy(x[:, ::-1].copy()),
                    mask=torch.from_numpy(mask[:, ::-1].copy()))
    _close(pl.apply(pp, torch.from_numpy(x),
                    mask=torch.from_numpy(mask)).numpy(),
           (fwd + bwd.flip(1)).numpy())


@pytest.mark.parametrize("name", ["GravesLSTM", "LSTM",
                                  "GravesBidirectionalLSTM"])
def test_init_has_the_reference_layout(name):
    jl, params, pl = _pair(name)
    got = pl.init(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: v.shape for k, v in params.items()} == \
        {k: tuple(v) for k, v in pl.param_shapes().items()}
    for prefix in (("f_", "b_") if name == "GravesBidirectionalLSTM"
                   else ("",)):
        b = got[prefix + "b"].numpy()
        np.testing.assert_array_equal(b, params[prefix + "b"])
        assert np.all(b[HID:2 * HID] == 1.0) and b.sum() == HID
    assert pl.to_dict() == jl.to_dict()


def test_init_uses_the_reference_fans():
    """W draws with fans (n_in, n_out), RW and the peepholes with
    (n_out, n_out): with ``xavier_uniform`` every draw lies inside its
    bound, and the widest reaches close to it."""
    layer = GravesLSTM(n_in=40, n_out=30, weight_init="xavier_uniform")
    p = layer.init(torch.Generator().manual_seed(1))
    for key, (fi, fo) in (("W", (40, 30)), ("RW", (30, 30)),
                          ("pI", (30, 30))):
        bound = np.sqrt(6.0 / (fi + fo))
        got = p[key].abs().max().item()
        assert got <= bound and (key == "pI" or got > 0.95 * bound), key


def test_distribution_init_reaches_the_lstm():
    layer = GravesLSTM(n_in=6, n_out=4, weight_init="distribution",
                       dist={"type": "uniform", "lower": 2.0, "upper": 3.0})
    p = layer.init(torch.Generator().manual_seed(2))
    for key in ("W", "RW", "pI", "pF", "pO"):
        assert 2.0 <= p[key].min() and p[key].max() <= 3.0, key


@pytest.mark.parametrize("peephole", [True, False])
def test_interop_carries_lstm_params_and_rmsprop_state(peephole):
    """``params_from_numpy`` and ``updater_state_from_numpy`` carry an
    MLN of a bidirectional layer (``f_``/``b_`` prefixes) and an LSTM,
    peepholes on or off, in the reference's layout, RMSProp's ``ms``
    included: the port's output and next step match the JAX net's."""
    from deeplearning4j_tpu_torch.models.interop import (
        updater_state_from_numpy,
    )

    conf = (JNNC.builder().seed(5).updater("rmsprop", learning_rate=0.01)
            .list()
            .layer(JBidi(n_in=N_IN, n_out=HID, peephole=peephole))
            .layer(JGraves(n_in=HID, n_out=HID, peephole=peephole))
            .layer(JRnnOutput(n_in=HID, n_out=3, loss="mcxent",
                              activation="softmax")).build())
    jnet = JMLN(conf).init()
    x = _x(14, B, T, N_IN)
    y = np.eye(3, dtype=np.float32)[
        np.random.default_rng(15).integers(0, 3, (B, T))]
    jnet.fit(x, y)
    net = params_from_numpy(MultiLayerConfiguration.from_json(
        conf.to_json()), _np_tree(jnet.params), device="cpu")
    assert sorted(net.params["layer_0"]) == sorted(
        jnet.params["layer_0"])
    net.updater_state = updater_state_from_numpy(
        net, _np_tree(jnet.updater_state))
    _close(net.output(x).numpy(), jnet.output(x))
    jnet.fit(x, y)
    net.fit(x, y)
    for layer, tree in _np_tree(jnet.params).items():
        for k, v in tree.items():
            np.testing.assert_allclose(net.params[layer][k].numpy(), v,
                                       rtol=RTOL_GRAD, atol=ATOL_GRAD)


# ---------------------------------------------------------------- vertices
@pytest.mark.parametrize("masked", [False, True])
def test_last_time_step_vertex(masked):
    x = _x(20, 4, 6, 3)
    mask = None
    if masked:
        # row 2 fully masked: the gather clamps at step 0
        mask = np.array([[1, 1, 1, 0, 0, 0], [1, 1, 1, 1, 1, 1],
                         [0, 0, 0, 0, 0, 0], [1, 0, 1, 1, 0, 0]],
                        np.float32)
    jv = JLastStep()
    pv = vertex_from_dict(jv.to_dict())
    ref = jv.apply([jnp.asarray(x)],
                   mask=None if mask is None else jnp.asarray(mask))
    out = pv.apply([torch.from_numpy(x)],
                   mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("timesteps", [None, 5])
def test_duplicate_to_time_series_vertex(timesteps):
    x = _x(21, 3, 4)
    ref_in = _x(22, 3, 7, 2)
    jv = JDuplicate(timesteps=timesteps)
    pv = vertex_from_dict(jv.to_dict())
    ref = jv.apply([jnp.asarray(x), jnp.asarray(ref_in)])
    out = pv.apply([torch.from_numpy(x), torch.from_numpy(ref_in)])
    assert out.shape == ref.shape == (3, timesteps or 7, 4)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def _graph_head_conf(masked_input=False):
    """A graph of an LSTM read at its last step by ``LastTimeStepVertex``
    and a dense head, then ``DuplicateToTimeSeriesVertex`` back over
    the input's time axis into an RNN head."""
    return (JNNC.builder().seed(3).updater("sgd", learning_rate=0.1)
            .graph().add_inputs("in")
            .add_layer("lstm", JGraves(n_in=N_IN, n_out=HID), "in")
            .add_vertex("last", JLastStep(), "lstm")
            .add_layer("cls", JOutput(n_in=HID, n_out=3, loss="mcxent",
                                      activation="softmax"), "last")
            .add_vertex("dup", JDuplicate(), "last", "in")
            .add_layer("seq", JRnnOutput(n_in=HID, n_out=2, loss="mse",
                                         activation="identity"), "dup")
            .set_outputs("cls", "seq").build())


@pytest.mark.parametrize("masked", [False, True])
def test_graph_with_the_recurrent_vertices_matches_jax(masked):
    jnet = JGraph(_graph_head_conf()).init()
    conf = GraphConfiguration.from_json(jnet.conf.to_json())
    net = graph_params_from_numpy(conf, _np_tree(jnet.params),
                                  device="cpu")
    x = _x(23, B, T, N_IN)
    mask = _mask(24) if masked else None
    refs = jnet.output(x, fmask=mask)
    outs = net.output(x, fmask=mask)
    for o, r in zip(outs, refs):
        _close(o.numpy(), r)
    y = {"cls": np.eye(3, dtype=np.float32)[[0, 2, 1]],
         "seq": _x(25, B, T, 2)}
    np.testing.assert_allclose(
        net.score(x, y, fmask=mask), jnet.score(x, y, fmask=mask),
        rtol=1e-5)


# --------------------------------------------------------------- streaming
def _stack_conf(kind, vocab=6):
    b = JNNC.builder().seed(4).updater("sgd", learning_rate=0.1).list()
    if kind == "lstm":
        b.layer(JGraves(n_in=vocab, n_out=HID))
        b.layer(JLSTM(n_in=HID, n_out=HID))
    else:
        b.layer(JGraves(n_in=vocab, n_out=8))
        b.layer(JSelfAttention(n_in=8, n_out=8, n_heads=2, causal=True,
                               max_cache=32))
        b.layer(JLSTM(n_in=8, n_out=HID))
    b.layer(JRnnOutput(n_in=HID, n_out=vocab, loss="mcxent",
                       activation="softmax"))
    return b.build()


def _facades(kind, facade, vocab=6):
    if facade == "mln":
        jnet = JMLN(_stack_conf(kind, vocab)).init()
        conf = MultiLayerConfiguration.from_json(jnet.conf.to_json())
        return jnet, params_from_numpy(conf, _np_tree(jnet.params),
                                       device="cpu")
    g = (JNNC.builder().seed(4).updater("sgd", learning_rate=0.1).graph()
         .add_inputs("in"))
    prev = "in"
    for i, layer in enumerate(_stack_conf(kind, vocab).layers):
        g.add_layer(f"n{i}", layer, prev)
        prev = f"n{i}"
    jnet = JGraph(g.set_outputs(prev).build()).init()
    conf = GraphConfiguration.from_json(jnet.conf.to_json())
    return jnet, graph_params_from_numpy(conf, _np_tree(jnet.params),
                                         device="cpu")


@pytest.mark.parametrize("kind", ["lstm", "mixed"])
@pytest.mark.parametrize("facade", ["mln", "cg"])
def test_rnn_time_step_in_chunks_matches_jax(kind, facade):
    """Chunks of 3, 1 (a [B, F] step) and 4 steps carry the LSTMs' (h, c)
    (and the attention cache) from call to call as the reference does;
    the chunks together equal one ``output`` over the sequence; after
    ``rnn_clear_previous_state`` the stream starts again from zeros."""
    jnet, net = _facades(kind, facade)
    x = np.eye(6, dtype=np.float32)[
        np.random.default_rng(30).integers(0, 6, (2, 8))]
    outs = []
    for chunk in (x[:, :3], x[:, 3], x[:, 4:]):
        ref = jnet.rnn_time_step(chunk)
        got = net.rnn_time_step(chunk)
        assert got.shape == ref.shape
        _close(got.numpy(), ref)
        outs.append(got if got.ndim == 3 else got[:, None])
    _close(torch.cat(outs, 1).numpy(), net.output(x).numpy())
    name = "n0" if facade == "cg" else "layer_0"
    h, c = net._rnn_state[name]
    jh, jc = jnet._rnn_state[name]
    _close(h.numpy(), jh)
    _close(c.numpy(), jc)
    net.rnn_clear_previous_state()
    _close(net.rnn_time_step(x[:, :3]).numpy(), outs[0].numpy())
