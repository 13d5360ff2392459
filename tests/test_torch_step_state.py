"""The invariants a captured train step relies on, checked on the CPU
(``models/capture.py``, ``backend/rng.py``, ``optimize/updaters.py``):

- a step updates params, updater state and BatchNorm's running stats in
  place: every tensor keeps its address;
- the step's updater scalars (learning rate with its schedule and
  per-layer overrides, momentum, Adam's bias corrections) read from a
  device tensor give exactly the updates of the host floats, and are
  the host floats at float32 rounding;
- a device key and a host generator with one seed split into the same
  children and draw the same mask; two draws from one key are one mask;
  step keys differ, and the keep rate lies within 3 sigma of 1 - p;
- a cached step program is dropped when the net's params, updater state,
  layer state or configuration are replaced (host-side cache logic);
  the net's one graph cache bounds each kind of program on its own;
- a failed capture leaves its warm-up recorded as the step it was;
- the pinned staging ring hands a slot out only once its event is done;
- a BatchNorm call inside a capture takes its arrival counters from the
  capture's own scratch, and a call on another thread does not;
- the garbage collector is held off for a capture, and back after it.

The updates are compared exactly (the same float32 arithmetic on the
same values); scalars at float32 rounding."""

import contextlib
import dataclasses
import gc
import threading

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch import helpers
from deeplearning4j_tpu_torch.backend import device as device_mod
from deeplearning4j_tpu_torch.backend import rng
from deeplearning4j_tpu_torch.backend.device import PinnedRing
from deeplearning4j_tpu_torch.helpers import batch_norm as bn
from deeplearning4j_tpu_torch.models import capture, zoo
from deeplearning4j_tpu_torch.models.common import tree_clone, tree_leaves
from deeplearning4j_tpu_torch.nn.conf import (
    NeuralNetConfiguration, UpdaterConfig,
)
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.models.sequential import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize import updaters as upd

TINY_RESNET = dict(height=16, width=16, channels=3, n_classes=4,
                   blocks=(1, 1), stem_stride=1, init_channels=8,
                   updater="nesterovs", lr=0.1)
POLICIES = {
    "none": dict(),
    "exponential": dict(lr_policy="exponential", lr_policy_decay_rate=0.9),
    "inverse": dict(lr_policy="inverse", lr_policy_decay_rate=0.1,
                    lr_policy_power=0.75),
    "step": dict(lr_policy="step", lr_policy_decay_rate=0.5,
                 lr_policy_steps=2.0),
    "poly": dict(lr_policy="poly", lr_policy_power=2.0, lr_policy_steps=5.0),
    "sigmoid": dict(lr_policy="sigmoid", lr_policy_decay_rate=0.7,
                    lr_policy_steps=3.0),
    "warmup_cosine": dict(lr_policy="warmup_cosine",
                          lr_policy_warmup_steps=2.0, lr_policy_steps=5.0,
                          lr_policy_min_fraction=0.1),
    "schedule": dict(lr_policy="schedule", lr_schedule={1: 0.05, 2: 0.02},
                     momentum_schedule={2: 0.5}),
}
UPDATERS = ("sgd", "nesterovs", "adagrad", "rmsprop", "adadelta", "adam",
            "adamw")


def _ptrs(net):
    return [t.data_ptr() for t in (tree_leaves(net.params)
                                   + tree_leaves(net.updater_state)
                                   + tree_leaves(net.net_state))]


def _images(seed, n=4):
    rs = np.random.default_rng(seed)
    return (rs.random((n, 16, 16, 3), np.float32),
            np.eye(4, dtype=np.float32)[rs.integers(0, 4, n)])


def test_a_step_keeps_every_state_tensor_in_place():
    """ResNet (a ComputationGraph) with Nesterov: params, the velocity
    and every BatchNorm running stat keep their addresses, and the stats
    move."""
    net = zoo.resnet50(device="cpu", **TINY_RESNET)
    before = _ptrs(net)
    stats = [t.clone() for t in tree_leaves(net.net_state)]
    for s in range(3):
        net.fit(*_images(s))
    assert _ptrs(net) == before
    assert all(not torch.equal(a, b)
               for a, b in zip(stats, tree_leaves(net.net_state)))


def test_an_adam_step_keeps_its_moments_in_place():
    conf = (NeuralNetConfiguration.builder().seed(2)
            .updater("adam", learning_rate=1e-2).list()
            .layer(DenseLayer(n_in=5, n_out=7, activation="tanh",
                              dropout=0.2))
            .layer(OutputLayer(n_in=7, n_out=3)).build())
    net = MultiLayerNetwork(conf).init(device="cpu")
    before = _ptrs(net)
    rs = np.random.default_rng(0)
    x = rs.random((6, 5), np.float32)
    y = np.eye(3, dtype=np.float32)[rs.integers(0, 3, 6)]
    for _ in range(3):
        net.fit(x, y)
    assert _ptrs(net) == before
    assert float(tree_leaves(net.updater_state["m"])[0].abs().sum()) > 0


def _tree(rng_, scale=1.0):
    return {"layer_0": {"W": torch.tensor(rng_.standard_normal((3, 4))
                                          * scale, dtype=torch.float32),
                        "b": torch.tensor(rng_.standard_normal(4) * scale,
                                          dtype=torch.float32)},
            "layer_1": {"sub0": {"gamma": torch.tensor(
                rng_.standard_normal(4) * scale, dtype=torch.float32)}}}


@pytest.mark.parametrize("name", UPDATERS)
@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_device_scalars_equal_host_floats(policy, name):
    """Five steps with the scalars as 0-d float32 tensors (views of one
    buffer, as a captured step reads them) against the host floats, with
    a per-layer override: the same updates and state bit for bit, and
    each scalar is its host float rounded to float32."""
    cfg = UpdaterConfig(name=name, learning_rate=0.1, momentum=0.9,
                        weight_decay=0.01, **POLICIES[policy])
    overrides = {"layer_1": 0.03}
    r = np.random.default_rng(1)
    params = _tree(r)
    host_state = upd.init_state(cfg, params)
    dev_state = tree_clone(host_state)
    for it in range(5):
        grads = _tree(r, 3.0)
        want_u, host_state = upd.update(cfg, grads, host_state, it,
                                        overrides, params=params)
        vals = upd.step_scalars(cfg, it, list(grads), overrides)
        buf = torch.tensor(list(vals.values()), dtype=torch.float32)
        for (k, v), t in zip(vals.items(), buf):
            assert t.item() == float(np.float32(v)), (k, it)
        views = dict(zip(vals, buf.unbind(0)))
        got_u, dev_state = upd.update(cfg, grads, dev_state, 99, {},
                                      params=params, scalars=views)
        for a, b in zip(tree_leaves(got_u), tree_leaves(want_u)):
            assert torch.equal(a, b), (policy, name, it)
        for a, b in zip(tree_leaves(dev_state), tree_leaves(host_state)):
            assert torch.equal(a, b), (policy, name, it)
        upd.apply_updates_(params, want_u)


def test_step_scalars_follow_the_schedules():
    cfg = UpdaterConfig(name="adam", learning_rate=0.1,
                        **POLICIES["schedule"])
    got = [upd.step_scalars(cfg, it, ["a", "b"], {"b": 0.5})
           for it in range(3)]
    assert [g[("lr", "a")] for g in got] == [0.1, 0.05, 0.02]
    assert [g[("lr", "b")] for g in got] == [0.5, 0.05, 0.02]
    assert [g["mu"] for g in got] == [0.9, 0.9, 0.5]
    assert got[0]["bc1"] == upd._bias_correction(cfg.adam_beta1, 1.0)
    assert got[2]["bc2"] == upd._bias_correction(cfg.adam_beta2, 3.0)


@pytest.mark.parametrize("shape, p", [((400, 250), 0.7), ((3, 5, 7), 0.5),
                                      ((1,), 0.1), ((128, 33), 1.0)])
def test_device_key_and_generator_draw_the_same_mask(shape, p):
    seed = 987654321
    host = rng.bernoulli(torch.Generator().manual_seed(seed), p, shape, "cpu")
    dev = rng.bernoulli(rng.device_key(seed, "cpu"), p, shape, "cpu")
    assert host.dtype == torch.bool and host.shape == shape
    assert torch.equal(host, dev)


def test_split_children_agree_and_draw_the_same_masks():
    seed = 31337
    g = torch.Generator().manual_seed(seed)
    k = rng.device_key(seed, "cpu")
    gk, kk = rng.split(g, 6), rng.split(k, 6)
    assert [c.initial_seed() for c in gk] == [int(c) for c in kk]
    assert len({c.initial_seed() for c in gk}) == 6
    for a, b in zip(rng.split(gk[2], 3), rng.split(kk[2], 3)):
        assert torch.equal(rng.bernoulli(a, 0.4, (9, 11), "cpu"),
                           rng.bernoulli(b, 0.4, (9, 11), "cpu"))


def test_two_draws_from_one_key_are_one_mask():
    k = rng.device_key(5, "cpu")
    layer = DenseLayer(n_in=64, n_out=8, dropout=0.5, name="d")
    x = torch.ones(32, 64)
    a = layer.maybe_dropout(x, train=True, rng=k)
    b = layer.maybe_dropout(x, train=True, rng=k)
    assert torch.equal(a, b)
    assert torch.equal(rng.bernoulli(k, 0.3, (50,), "cpu"),
                       rng.bernoulli(k, 0.3, (50,), "cpu"))


def test_step_keys_differ_and_keep_rate_is_unbiased():
    stream = rng.KeyStream(11)
    n, p = 200_000, 0.6
    masks = [rng.bernoulli(rng.device_key(rng.seed_of(stream.next()), "cpu"),
                           p, (n,), "cpu") for _ in range(4)]
    for i in range(len(masks)):
        for j in range(i):
            assert not torch.equal(masks[i], masks[j])
        rate = masks[i].float().mean().item()
        assert abs(rate - p) <= 3 * np.sqrt(p * (1 - p) / n)


# ------------------------------------------------------- the graph cache
def _mlp():
    conf = (NeuralNetConfiguration.builder().seed(1)
            .updater("nesterovs", learning_rate=0.1).list()
            .layer(DenseLayer(n_in=4, n_out=3, activation="tanh"))
            .layer(OutputLayer(n_in=3, n_out=2)).build())
    return MultiLayerNetwork(conf).init(device="cpu")


def _captured(graphs, net, inputs):
    """The program for ``inputs``, marked captured against the net's
    current state (as ``StepGraphs.run`` marks it)."""
    prog = graphs.program("train", net._train_body, inputs)
    if prog.graph is None:
        prog.graph = object()
        prog.leaves = capture.state_leaves(net)
        prog.conf = net.conf
    return prog


def test_replaced_state_invalidates_the_cached_step():
    net = _mlp()
    graphs = capture.StepGraphs(net)
    inputs = {"x": capture.host_or_device(np.zeros((5, 4), np.float32)),
              "y": capture.host_or_device(np.zeros((5, 2), np.float32)),
              "fmask": None, "lmask": None}
    first = _captured(graphs, net, inputs)
    assert _captured(graphs, net, inputs) is first
    # in-place writes keep the program
    net.set_params_vector(np.ones(net.num_params(), np.float32))
    assert _captured(graphs, net, inputs) is first
    seen = [first]
    for replace in (lambda: setattr(net, "params", tree_clone(net.params)),
                    lambda: setattr(net, "updater_state",
                                    tree_clone(net.updater_state)),
                    lambda: net.init(device="cpu"),
                    lambda: setattr(net, "conf", dataclasses.replace(
                        net.conf))):
        replace()
        prog = _captured(graphs, net, inputs)
        assert all(prog is not p for p in seen)
        seen.append(prog)
        assert _captured(graphs, net, inputs) is prog
    # the layer state (BatchNorm's running stats) too
    res = zoo.resnet50(device="cpu", **TINY_RESNET)
    graphs = capture.StepGraphs(res)
    x, y = _images(0)
    inputs = {"inputs": {"input": capture.host_or_device(x)},
              "labels": {"fc": capture.host_or_device(y)}, "fmask": None,
              "lmask": None}
    prog = _captured(graphs, res, inputs)
    assert _captured(graphs, res, inputs) is prog
    res.net_state = tree_clone(res.net_state)
    assert _captured(graphs, res, inputs) is not prog


def test_the_cache_keys_on_shapes_masks_helpers_and_lru():
    net = _mlp()
    graphs = capture.StepGraphs(net)

    def inputs(b, lmask=False):
        return {"x": capture.host_or_device(np.zeros((b, 4), np.float32)),
                "y": capture.host_or_device(np.zeros((b, 2), np.float32)),
                "fmask": None,
                "lmask": (capture.host_or_device(np.ones((b,), np.float32))
                          if lmask else None)}

    a = _captured(graphs, net, inputs(5))
    assert _captured(graphs, net, inputs(6)) is not a
    assert _captured(graphs, net, inputs(5, lmask=True)) is not a
    with helpers.helpers_disabled():
        assert _captured(graphs, net, inputs(5)) is not a
    out = graphs.program("output", net._output_body,
                         {"x": inputs(5)["x"], "fmask": None})
    assert out is not a
    assert _captured(graphs, net, inputs(5)) is a
    for b in range(10, 10 + capture.GRAPH_CACHE_SIZE):
        _captured(graphs, net, inputs(b))
    kinds = [k[0] for k in graphs.programs]
    assert kinds.count("train") == capture.GRAPH_CACHE_SIZE
    assert _captured(graphs, net, inputs(5)) is not a   # evicted
    # the bound is per kind: train programs never evict the output one
    assert graphs.programs[out.cache_key] is out


def test_one_graph_cache_holds_every_kind_with_its_own_bound():
    """``generate``'s loops and the step programs share the net's one
    cache; each kind keeps its ``GRAPH_CACHE_SIZE`` most recently used."""
    net = _mlp()
    made = []

    def make():
        made.append(object())
        return made[-1]

    for i in range(capture.GRAPH_CACHE_SIZE + 2):
        capture.cached(net, ("decode", i), make)
        capture.cached(net, ("output", i), make)
    first_train = capture.cached(net, ("train", 0), make)
    keys = list(net._graph_cache)
    for kind in ("decode", "output"):
        assert [k[1] for k in keys if k[0] == kind] == list(
            range(2, capture.GRAPH_CACHE_SIZE + 2))
    assert capture.cached(net, ("train", 0), make) is first_train
    assert list(net._graph_cache)[-1] == ("train", 0)
    stale = capture.cached(net, ("train", 0), make, fresh=lambda e: False)
    assert stale is not first_train and stale is made[-1]


def _mlp_batches(n):
    rs = np.random.default_rng(7)
    return [(rs.random((5, 4), np.float32),
             np.eye(2, dtype=np.float32)[rs.integers(0, 2, 5)])
            for _ in range(n)]


def test_a_failed_capture_records_its_warm_up_step(monkeypatch):
    """The first call of a shape runs the body as the genuine step, then
    captures it.  When the capture fails, ``fit`` raises, the warm-up
    stands as the step it was (``iteration`` and ``score_value``
    advanced, the params those of one eager step) and the program
    leaves the cache, so a retry is a new first call at the next
    iteration.  The capture path runs on the CPU here with the card's
    calls replaced: the warm-up by a plain call, the capture by one that
    fails, the pinned staging by a plain copy."""
    def failing_capture(fn, pool=None):
        raise RuntimeError("capture failed")

    monkeypatch.setattr(capture, "captures", lambda net: True)
    monkeypatch.setattr(capture, "warm_on_side_stream",
                        lambda fn, device: fn())
    monkeypatch.setattr(capture, "capture_graph", failing_capture)
    monkeypatch.setattr(capture.StepGraphs, "_pool", lambda self: None)
    monkeypatch.setattr(
        capture.StepGraphs, "put",
        lambda self, dst, src, name: dst.copy_(capture.host_or_device(src)))
    net = _mlp()
    twin = _mlp()
    twin._capture = False
    for i, (x, y) in enumerate(_mlp_batches(2)):
        with pytest.raises(RuntimeError, match="capture failed"):
            net.fit(x, y)
        with monkeypatch.context() as m:
            m.setattr(capture, "captures", lambda n: False)
            twin.fit(x, y)
        assert net.iteration == twin.iteration == i + 1
        assert net.score_value == twin.score_value
        for a, b in zip(tree_leaves(net.params), tree_leaves(twin.params)):
            assert torch.equal(a, b)
        assert not net._step_graphs.programs
        assert net._step_graphs.captures == 0


# ----------------------------------------------------------- staging ring
class _FakeEvent:
    log = []

    def __init__(self):
        self.done = True

    def record(self):
        self.done = False

    def query(self):
        return self.done

    def synchronize(self):
        _FakeEvent.log.append(self)
        self.done = True


def test_pinned_ring_hands_out_a_slot_only_when_its_event_is_done():
    _FakeEvent.log = []
    ring = PinnedRing(depth=2, event=_FakeEvent)
    events = []
    for step in range(6):
        slot = ring.acquire()
        assert slot == step % 2
        if step >= 2:
            # the slot's last copies (two steps back) were waited for
            assert events[step - 2].done
            assert _FakeEvent.log[-1] is events[step - 2]
        ring.release(slot)
        events.append(ring._events[slot])
        assert not events[-1].done      # queued, not yet complete
    # a slot whose event completed on its own is not waited for
    events[-2].done = True
    waited = len(_FakeEvent.log)
    ring.acquire()
    assert len(_FakeEvent.log) == waited


def test_batch_norm_counters_in_a_capture_are_the_captures_own(monkeypatch):
    """Inside a capture (the thread's ``device._capture.scratch`` set, as
    ``capture_graph`` sets it) every call of one capture shares one
    zeroed buffer, grown when a call needs more slices; outside it the
    per-stream buffer."""
    dev = torch.device("cpu")
    state = device_mod._capture
    outside = bn._arrival_counters(dev, 12345, 8)
    monkeypatch.setattr(state, "scratch", {})
    a = bn._arrival_counters(dev, 12345, 8)
    b = bn._arrival_counters(dev, 12345, 100)
    assert a is b and a is not outside and a.numel() >= 100
    assert int(a.abs().sum()) == 0
    c = bn._arrival_counters(dev, 12345, 1000)
    assert c is not a and c.numel() >= 1000
    made = state.scratch[None]
    assert len(made) == 2 and made[0] is a and made[1] is c
    monkeypatch.setattr(state, "scratch", {})
    assert bn._arrival_counters(dev, 12345, 8) is not a
    monkeypatch.setattr(state, "scratch", None)
    assert bn._arrival_counters(dev, 12345, 8) is outside


def test_another_thread_does_not_see_a_captures_scratch(monkeypatch):
    """A capture lets other threads run on: a BatchNorm call on another
    thread while one captures takes the per-stream buffer, not the
    capture's scratch."""
    dev = torch.device("cpu")
    outside = bn._arrival_counters(dev, 12345, 8)
    monkeypatch.setattr(device_mod._capture, "scratch", {})
    mine = bn._arrival_counters(dev, 12345, 8)
    seen = []
    worker = threading.Thread(
        target=lambda: seen.append(bn._arrival_counters(dev, 12345, 8)))
    worker.start()
    worker.join()
    assert mine is not outside and seen[0] is outside
    assert device_mod._capture.scratch[None] == [mine]


def test_the_collector_is_held_off_for_a_capture(monkeypatch):
    """``capture_graph`` disables the garbage collector while the body is
    captured (a collected cycle could free pinned memory and invalidate
    the capture) and restores it after, also when the capture fails;
    a collector that was off stays off.  The card's graph is faked."""
    seen = []

    class FakeGraph:
        pass

    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda graph, **kw: contextlib.nullcontext())

    def body():
        seen.append(gc.isenabled())
        return "out"

    def failing():
        seen.append(gc.isenabled())
        raise RuntimeError("capture failed")

    was = gc.isenabled()
    try:
        gc.enable()
        graph, out = device_mod.capture_graph(body)
        assert out == "out" and graph.scratch == []
        assert seen == [False] and gc.isenabled()
        with pytest.raises(RuntimeError, match="capture failed"):
            device_mod.capture_graph(failing)
        assert seen == [False, False] and gc.isenabled()
        gc.disable()
        device_mod.capture_graph(body)
        assert not gc.isenabled()
    finally:
        (gc.enable if was else gc.disable)()
