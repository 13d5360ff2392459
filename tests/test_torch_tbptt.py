"""Truncated BPTT in the port (``models/common.py`` ``fit_tbptt``, both
facades' ``_fit_tbptt``) against the JAX package's ``fit``, on the CPU.

- Three TBPTT ``fit`` calls on both facades, T two and a half windows
  (so the last window is shorter), with RMSProp and with Adam: params,
  updater state, ``score_value`` and ``iteration`` (one a window)
  against the JAX ``fit`` on the same weights and batches.
- Masks sliced with the windows; a graph's rank-2 input passed whole to
  every window; a graph without a sequence input refused with the
  reference's message; ``_batch_adv``.
- ``fit_scanned`` refuses TBPTT as the JAX facades do.
- The capture path (``models/capture.py``) on the CPU, the card's calls
  replaced by an emulation (a "graph" that reruns its body and writes
  the results into the captured outputs): one program a window length,
  each captured once, the carries staged into the shorter window's
  program and left in place for the next window of the same length,
  bit-equal to eager ``fit``.

Tolerances: params and updater state ``rtol=1e-4, atol=1e-5`` (float32,
different summation orders, compounded over nine updates); the learning
rate is 0.01, the committed ``lstm.zip``'s: RMSProp's first steps move
each weight by about ``lr / sqrt(1 - decay)``, whatever the gradient's
size, so a float32 difference in a gradient near zero becomes a
difference of that size in the weight."""

import numpy as np
import pytest
import torch

import jax

from deeplearning4j_tpu.models.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.models.sequential import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.layers import (
    DenseLayer as JDense, GravesLSTM as JGraves, LSTM as JLSTM,
    RnnOutputLayer as JRnnOutput,
)
from deeplearning4j_tpu.models.vertices import (
    DuplicateToTimeSeriesVertex as JDuplicate, MergeVertex as JMerge,
)
from deeplearning4j_tpu_torch.models import capture
from deeplearning4j_tpu_torch.models.common import tree_leaves, tree_paths
from deeplearning4j_tpu_torch.models.graph import GraphConfiguration
from deeplearning4j_tpu_torch.models.interop import (
    graph_params_from_numpy, params_from_numpy,
)
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration

RTOL, ATOL = 1e-4, 1e-5
VOCAB, HID, B, WINDOW, T = 6, 8, 3, 8, 20     # windows of 8, 8 and 4


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _mln_conf(updater):
    return (JNNC.builder().seed(11).updater(updater, learning_rate=0.01)
            .list()
            .layer(JGraves(n_in=VOCAB, n_out=HID))
            .layer(JLSTM(n_in=HID, n_out=HID))
            .layer(JRnnOutput(n_in=HID, n_out=VOCAB, loss="mcxent",
                              activation="softmax"))
            .backprop_type("truncated_bptt", fwd_length=WINDOW,
                           back_length=WINDOW)
            .build())


def _cg_conf(updater, static_input=False):
    """The same stack as a graph; ``static_input`` adds a rank-2 input,
    broadcast over time and merged with the LSTM's output."""
    g = (JNNC.builder().seed(11).updater(updater, learning_rate=0.01)
         .graph().add_inputs("in", *(("ctx",) if static_input else ()))
         .add_layer("lstm", JGraves(n_in=VOCAB, n_out=HID), "in")
         .add_layer("lstm2", JLSTM(n_in=HID, n_out=HID), "lstm"))
    head_in = "lstm2"
    if static_input:
        g.add_layer("ctx_d", JDense(n_in=3, n_out=4, activation="tanh"),
                    "ctx")
        g.add_vertex("dup", JDuplicate(), "ctx_d", "in")
        g.add_vertex("cat", JMerge(), "lstm2", "dup")
        head_in = "cat"
    return (g.add_layer("out", JRnnOutput(
                n_in=HID + (4 if static_input else 0), n_out=VOCAB,
                loss="mcxent", activation="softmax"), head_in)
            .set_outputs("out")
            .backprop_type("truncated_bptt", fwd_length=WINDOW,
                           back_length=WINDOW)
            .build())


def _pair(facade, updater, **kw):
    if facade == "mln":
        jnet = JMLN(_mln_conf(updater)).init()
        conf = MultiLayerConfiguration.from_json(jnet.conf.to_json())
        return jnet, params_from_numpy(conf, _np_tree(jnet.params),
                                       device="cpu")
    jnet = JGraph(_cg_conf(updater, **kw)).init()
    conf = GraphConfiguration.from_json(jnet.conf.to_json())
    return jnet, graph_params_from_numpy(conf, _np_tree(jnet.params),
                                         device="cpu")


def _batch(seed):
    ids = np.random.default_rng(seed).integers(0, VOCAB, (B, T))
    eye = np.eye(VOCAB, dtype=np.float32)
    return eye[ids], eye[np.roll(ids, -1, 1)]


def _assert_state_close(net, jnet):
    for part in ("params", "updater_state"):
        want = dict(tree_paths(_np_tree(getattr(jnet, part))))
        got = dict(tree_paths(getattr(net, part)))
        assert sorted(got) == sorted(want), part
        for path, a in got.items():
            np.testing.assert_allclose(a.numpy(), want[path], rtol=RTOL,
                                       atol=ATOL, err_msg=f"{part} {path}")


@pytest.mark.parametrize("updater", ["rmsprop", "adam"])
@pytest.mark.parametrize("facade", ["mln", "cg"])
def test_tbptt_fit_matches_jax(facade, updater):
    jnet, net = _pair(facade, updater)
    for seed in range(3):
        x, y = _batch(seed)
        jnet.fit(x, y)
        net.fit(x, y)
        np.testing.assert_allclose(net.score_value, float(jnet.score_value),
                                   rtol=RTOL)
    # one iteration a window: three windows (8, 8, 4) a batch
    assert net.iteration == jnet.iteration == 9
    _assert_state_close(net, jnet)


@pytest.mark.parametrize("facade", ["mln", "cg"])
def test_tbptt_with_masks_matches_jax(facade):
    """Features and labels masks are cut with the windows; on the graph a
    rank-2 input reaches every window whole."""
    jnet, net = _pair(facade, "adam",
                      **({"static_input": True} if facade == "cg" else {}))
    rs = np.random.default_rng(40)
    for seed in range(2):
        x, y = _batch(10 + seed)
        fm = (rs.random((B, T)) > 0.2).astype(np.float32)
        lm = (rs.random((B, T)) > 0.2).astype(np.float32)
        if facade == "cg":
            x = {"in": x, "ctx": rs.standard_normal((B, 3)).astype(
                np.float32)}
        jnet.fit(x, y, fmask=fm, lmask=lm)
        net.fit(x, y, fmask=fm, lmask=lm)
    assert net.iteration == jnet.iteration == 6
    _assert_state_close(net, jnet)


def test_graph_tbptt_needs_a_sequence_input():
    conf = (JNNC.builder().seed(1).graph().add_inputs("in")
            .add_layer("out", JRnnOutput(n_in=4, n_out=2, loss="mse",
                                         activation="identity"), "in")
            .set_outputs("out").backprop_type("truncated_bptt", 4, 4)
            .build())
    jnet = JGraph(conf).init()
    net = graph_params_from_numpy(GraphConfiguration.from_json(
        conf.to_json()), _np_tree(jnet.params), device="cpu")
    x, y = np.zeros((2, 4), np.float32), np.zeros((2, 2), np.float32)
    with pytest.raises(ValueError) as jerr:
        jnet.fit(x, y)
    with pytest.raises(ValueError) as err:
        net.fit(x, y)
    assert str(err.value) == str(jerr.value)
    assert net.iteration == 0


def test_batch_adv_counts_windows_as_jax():
    jnet, net = _pair("cg", "sgd", static_input=True)
    for t in (1, 8, 9, 20):
        x = {"in": np.zeros((2, t, VOCAB), np.float32),
             "ctx": np.zeros((2, 3), np.float32)}
        assert net._batch_adv(x) == jnet._batch_adv(x)


@pytest.mark.parametrize("facade", ["mln", "cg"])
def test_fit_scanned_refuses_tbptt_as_jax(facade):
    jnet, net = _pair(facade, "sgd")
    batches = [_batch(0)]
    with pytest.raises(ValueError) as jerr:
        jnet.fit_scanned(batches, scan_steps=2)
    with pytest.raises(ValueError) as err:
        net.fit_scanned(batches, scan_steps=2)
    assert str(err.value) == str(jerr.value) == \
        "fit_scanned does not support TBPTT"


# ------------------------------------------------- the capture path, emulated
class _ReplayGraph:
    """A captured graph's stand-in: ``replay`` reruns the body and writes
    its tensors into the outputs of the capture, as a replay rewrites
    the graph's static output."""

    def __init__(self, fn, out):
        self.fn, self.out = fn, out

    def replay(self):
        for dst, src in zip(tree_leaves(self.out), tree_leaves(self.fn())):
            if dst is not src:
                dst.copy_(src)


def _emulate_capture(monkeypatch, net):
    """The card's calls replaced: the warm-up runs the body, the pinned
    staging is a plain copy (the self-copy skip kept), and the capture
    records the body without its effects (the net's state and every
    program's static inputs are restored after it runs once), as a
    capture enqueues nothing."""
    def fake_capture(fn, pool=None):
        held = capture.state_leaves(net) + [
            t for p in net._step_graphs.programs.values()
            for t in tree_leaves(p.statics)]
        saved = [t.clone() for t in held]
        out = fn()
        for t, s in zip(held, saved):
            t.copy_(s)
        return _ReplayGraph(fn, out), out

    def put(self, dst, src, name):
        src = capture.host_or_device(src)
        if src is not dst:
            dst.copy_(src)

    monkeypatch.setattr(capture, "captures", lambda n: n is net)
    monkeypatch.setattr(capture, "warm_on_side_stream",
                        lambda fn, device: fn())
    monkeypatch.setattr(capture, "capture_graph", fake_capture)
    monkeypatch.setattr(capture.StepGraphs, "_pool", lambda self: None)
    monkeypatch.setattr(capture.StepGraphs, "put", put)


@pytest.mark.parametrize("facade", ["mln", "cg"])
def test_captured_tbptt_equals_eager(monkeypatch, facade):
    """Two batches of 8 + 8 + 4: two programs (window lengths 8 and 4),
    each captured once and replayed after; the emulated capture path
    equals eager ``fit`` bit for bit, so the carries reach each window
    through the programs' static buffers."""
    jnet, net = _pair(facade, "rmsprop")
    _, eager = _pair(facade, "rmsprop")
    _emulate_capture(monkeypatch, net)
    batches = [_batch(20 + i) for i in range(3)]
    for x, y in batches:
        net.fit(x, y)
        eager.fit(x, y)
        assert net.score_value == eager.score_value
    graphs = net._step_graphs
    assert net.iteration == eager.iteration == 9
    assert graphs.captures == 2 and graphs.replays == 7
    x_path = ("x",) if facade == "mln" else ("inputs", "in")
    assert sorted({path: shape for path, shape, _ in p.cache_key[1]}[x_path]
                  for p in graphs.programs.values()) == \
        [(B, 4, VOCAB), (B, WINDOW, VOCAB)]
    for a, b in zip(tree_leaves(net.params), tree_leaves(eager.params)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(net.updater_state),
                    tree_leaves(eager.updater_state)):
        assert torch.equal(a, b)
