"""The port's training introspection (``observability/introspection.py``,
``models/common.StepWatch``) on the CPU.

- The reference's ``tests/test_introspection.py:100-392`` oracles over
  the port (the data-parallel cases at :264 and :290 wait for ROADMAP
  A10): a guarded fit with introspection on is bit-identical to one
  without, and nothing is captured after warm-up (the card's capture
  emulated, ``test_torch_tbptt._emulate_capture``); collection and the
  update:param ratio; the graph facade; the policy through the config
  JSON and the zip (a JAX zip's ``__introspect__`` vector restores into
  the port); a dying ReLU layer named by the monitor, the flight event
  and the health rule; the anomaly rules; ``StatsReport`` serde; the
  crash-safe ``FileStatsStorage``.
- Against JAX: after the same steps from the same weights, the
  harvested gradient, update and parameter norms and the activation
  summaries equal the reference's harvest (float32, ``rtol=1e-4``), on
  both facades and under the guard's loss scale.
"""

import json
import time

import numpy as np
import pytest
import torch

import deeplearning4j_tpu_torch.nn.conf as port_conf
from deeplearning4j_tpu_torch.models import serialization
from deeplearning4j_tpu_torch.models.common import tree_leaves
from deeplearning4j_tpu_torch.models.graph import ComputationGraph
from deeplearning4j_tpu_torch.models.sequential import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.conf import (
    MultiLayerConfiguration, NeuralNetConfiguration, TrainingIntrospection,
)
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.observability import (
    AnomalyMonitor, HealthRule, MetricsRegistry, get_flight_recorder,
    get_registry, introspection,
)
from deeplearning4j_tpu_torch.ui import (
    FileStatsStorage, InMemoryStatsStorage, StatsListener, StatsReport,
)

RTOL = 1e-4


def flight_events(kind, **attrs):
    return [ev for ev in get_flight_recorder().events()
            if ev.kind == kind
            and all(ev.attrs.get(k) == v for k, v in attrs.items())]


def _builder(mod, seed, intro, stab, updater):
    b = (mod.NeuralNetConfiguration.builder().seed(seed)
         .updater(updater, learning_rate=0.01))
    if intro:
        b.training_introspection()
    if stab:
        b.training_stability()
    return b


def make_net(seed=1, intro=True, stab=False, activation="tanh",
             updater="adam"):
    conf = (_builder(port_conf, seed, intro, stab, updater).list()
            .layer(DenseLayer(n_in=6, n_out=10, activation=activation))
            .layer(OutputLayer(n_in=10, n_out=3, loss="mcxent",
                               activation="softmax"))
            .build())
    return MultiLayerNetwork(conf).init(device="cpu")


def batch(seed=0, n=24):
    rs = np.random.RandomState(seed)
    x = rs.rand(n, 6).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, n)]
    return x, y


# ----------------------------------------------------- device-side collection
def test_bit_identical_and_no_capture_after_warm_up_guarded(monkeypatch):
    """A guarded fit with introspection on equals the same fit without
    it bit for bit, through the (emulated) captured step: one capture,
    then replays only."""
    from tests.test_torch_tbptt import _emulate_capture

    x, y = batch()
    on = make_net(intro=True, stab=True)
    off = make_net(intro=False, stab=True)
    on.fit(x, y)        # check_trainable gives the net its subtree
    _emulate_capture(monkeypatch, on)
    for _ in range(6):
        on.fit(x, y)
        off.fit(x, y)
    off.fit(x, y)
    graphs = on._step_graphs
    assert graphs.captures == 1 and graphs.replays == 5
    for a, b in zip(tree_leaves(on.params), tree_leaves(off.params)):
        assert torch.equal(a, b)
    h = introspection.harvest_model(on)
    assert h["iteration"] == on.iteration - 1
    assert all(np.isfinite(e["norm"]) and e["norm"] > 0
               for e in h["gradient_stats"].values())


def test_unguarded_collection_and_ratio():
    x, y = batch()
    net = make_net(intro=True, stab=False)
    for _ in range(4):
        net.fit(x, y)
    h = introspection.harvest_model(net)
    assert set(h["gradient_stats"]) == {"layer_0", "layer_1"}
    for e in h["update_stats"].values():
        assert e["norm"] > 0 and e["param_norm"] > 0
        assert abs(e["ratio"] - e["norm"] / e["param_norm"]) < 1e-9
    assert h["replicas"] is None
    for e in h["activation_stats"].values():
        assert np.isfinite(e["mean"]) and np.isfinite(e["std"])


def _graph_net(mod, seed=3):
    p = (mod.nn.conf.NeuralNetConfiguration.builder().seed(seed)
         .updater("adam", learning_rate=0.01))
    p.training_introspection()
    L = mod.nn.layers
    conf = (p.graph().add_inputs("in")
            .add_layer("dense", L.DenseLayer(n_in=6, n_out=8,
                                             activation="relu"), "in")
            .add_layer("out", L.OutputLayer(n_in=8, n_out=3, loss="mcxent",
                                            activation="softmax"), "dense")
            .set_outputs("out")
            .build())
    return conf


def test_graph_facade_collection():
    import deeplearning4j_tpu_torch as port

    net = ComputationGraph(_graph_net(port)).init(device="cpu")
    x, y = batch()
    for _ in range(3):
        net.fit(x, y)
    h = introspection.harvest_model(net)
    assert set(h["gradient_stats"]) == {"dense", "out"}
    assert "dense" in h["activation_stats"]


def test_conf_serde_roundtrip_and_model_save(tmp_path):
    net = make_net(intro=True)
    back = MultiLayerConfiguration.from_json(net.conf.to_json())
    assert back.introspection == TrainingIntrospection().to_dict()
    x, y = batch()
    net.fit(x, y)
    p = str(tmp_path / "model.zip")
    net.save(p)
    loaded = MultiLayerNetwork.load(p, device="cpu")
    assert introspection.STATE_KEY in loaded.updater_state
    # the checkpointed stats travel with the updater state
    assert torch.equal(
        loaded.updater_state[introspection.STATE_KEY]["packed"],
        net.updater_state[introspection.STATE_KEY]["packed"])
    loaded.fit(x, y)   # and the restored net keeps training + collecting
    assert introspection.harvest_model(loaded)["iteration"] == 1


def test_a_jax_zip_carries_its_vector_into_the_port(tmp_path):
    """The reference's zip (its ``__introspect__`` vector in the updater
    state) restores into the port with the vector, and training goes on
    collecting into it."""
    from deeplearning4j_tpu.models.sequential import (
        MultiLayerNetwork as JNet,
    )
    from deeplearning4j_tpu.nn import conf as jconf, layers as jlayers
    from deeplearning4j_tpu.observability import (
        introspection as jintro,
    )

    jnet = JNet(_builder(jconf, 1, True, False, "adam").list()
                .layer(jlayers.DenseLayer(n_in=6, n_out=10,
                                          activation="tanh"))
                .layer(jlayers.OutputLayer(n_in=10, n_out=3, loss="mcxent",
                                           activation="softmax"))
                .build()).init()
    x, y = batch()
    jnet.fit(x, y)
    jnet.save(str(tmp_path / "j.zip"))
    net = serialization.restore_multi_layer_network(tmp_path / "j.zip",
                                                    device="cpu")
    np.testing.assert_array_equal(
        net.updater_state[introspection.STATE_KEY]["packed"].numpy(),
        np.asarray(jnet.updater_state[jintro.STATE_KEY]["packed"]))
    assert introspection.harvest_model(net)["iteration"] == 0
    net.fit(x, y)
    assert introspection.harvest_model(net)["iteration"] == 1


# --------------------------------------------------------------- dead units
def test_dying_relu_named_in_rule_and_flight_event():
    net = make_net(seed=7, intro=True, activation="relu")
    with torch.no_grad():
        net.params["layer_0"]["b"] -= 100.0
    storage = InMemoryStatsStorage()
    net.set_listeners(StatsListener(storage, session_id="dying"))
    x, y = batch(seed=7)
    for _ in range(3):
        net.fit(x, y)
    rep = storage.get_latest_update("dying")
    assert rep.activation_stats["layer_0"]["zero_fraction"] > 0.99
    evs = flight_events("introspection_anomaly", rule="max_dead_fraction",
                        layer="layer_0")
    assert evs, "no introspection_anomaly flight event for layer_0"
    verdict = HealthRule("dead", "max_dead_fraction", 0.5).evaluate(
        get_registry())
    assert not verdict["ok"]
    assert "layer_0" in verdict["detail"]


def test_anomaly_monitor_update_ratio_and_spread():
    mon = AnomalyMonitor(band_low=1e-3, band_high=1e-1,
                         max_gradient_norm_ratio=10.0, warn_interval_s=0.0)
    harvested = {
        "iteration": 5,
        "gradient_stats": {"a": {"norm": 100.0}, "b": {"norm": 1.0}},
        "update_stats": {"a": {"norm": 1.0, "param_norm": 1.0,
                               "ratio": 1.0},
                         "b": {"norm": 1e-6, "param_norm": 1.0,
                               "ratio": 1e-6}},
        "activation_stats": {},
    }
    rules = {(v["rule"], v["layer"]) for v in mon.check(harvested)}
    assert ("update_ratio_band", "a") in rules
    assert ("update_ratio_band", "b") in rules
    assert ("max_gradient_norm_ratio", "b") in rules
    harvested["update_stats"]["a"]["ratio"] = 0.0
    assert ("update_ratio_band", "a") not in {
        (v["rule"], v["layer"]) for v in mon.check(harvested)}


def test_update_ratio_band_health_rule():
    reg = MetricsRegistry()
    g = reg.gauge("dl4j_layer_update_ratio",
                  "Per-layer update:param norm ratio (test reuse)",
                  labels=("layer",))
    g.set(1e-3, layer="healthy_x")
    g.set(0.9, layer="bouncy_x")
    rule = HealthRule("band", "update_ratio_band", 0.1, limit_low=1e-5)
    verdict = rule.evaluate(reg)
    assert not verdict["ok"]
    assert "bouncy_x" in verdict["detail"]
    g.set(1e-3, layer="bouncy_x")
    assert rule.evaluate(reg)["ok"]
    g.set(0.0, layer="frozen_x")
    verdict = rule.evaluate(reg)
    assert not verdict["ok"] and "frozen_x" in verdict["detail"]
    gn = reg.gauge("dl4j_layer_gradient_norm", "test", labels=("layer",))
    gn.set(100.0, layer="top_x")
    gn.set(1e-6, layer="bottom_x")
    verdict = HealthRule("spread", "max_gradient_norm_ratio",
                         1e3).evaluate(reg)
    assert not verdict["ok"]
    assert "top_x" in verdict["detail"] and "bottom_x" in verdict["detail"]


# ------------------------------------------------------------ report serde
def test_stats_report_serde_roundtrip_new_fields():
    rep = StatsReport(
        session_id="s", iteration=3, timestamp=1.5, score=0.25,
        learning_rate=0.01,
        gradient_stats={"l0": {"norm": 0.5, "per_replica": [0.4, 0.6]}},
        update_stats={"l0": {"norm": 0.01, "ratio": 2e-3,
                             "param_norm": 5.0}},
        activation_stats={"l0": {"mean": 0.1, "std": 0.2,
                                 "zero_fraction": 0.3}},
        replicas=2)
    back = StatsReport.from_json(rep.to_json())
    assert back == rep
    d = json.loads(rep.to_json())
    d["field_from_the_future"] = {"x": 1}
    assert StatsReport.from_json(json.dumps(d)) == rep


# ------------------------------------------------------------ file storage
def _fill_storage(path, n=3):
    storage = FileStatsStorage(path)
    net = make_net(seed=5, intro=True)
    net.set_listeners(StatsListener(storage, session_id="filed"))
    x, y = batch(seed=5)
    for _ in range(n):
        net.fit(x, y)
    return storage


def test_file_storage_reload_equals_memory(tmp_path):
    p = str(tmp_path / "stats.jsonl")
    storage = _fill_storage(p)
    reloaded = FileStatsStorage(p)
    assert reloaded.list_session_ids() == storage.list_session_ids()
    mem, disk = storage.get_updates("filed"), reloaded.get_updates("filed")
    assert len(disk) == len(mem)
    for a, b in zip(mem, disk):
        assert (a.iteration, a.score, a.gradient_stats, a.update_stats,
                a.activation_stats, a.param_histograms) == \
               (b.iteration, b.score, b.gradient_stats, b.update_stats,
                b.activation_stats, b.param_histograms)
    assert reloaded.get_init_report("filed") is not None


def test_file_storage_torn_tail_recovered(tmp_path):
    p = str(tmp_path / "stats.jsonl")
    storage = _fill_storage(p)
    n_good = len(storage.get_updates("filed"))
    with open(p, "ab") as f:
        f.write(b'{"type": "update", "session_id": "filed", "iter')
    reloaded = FileStatsStorage(p)
    assert len(reloaded.get_updates("filed")) == n_good
    reloaded.put_update(StatsReport(session_id="filed", iteration=99,
                                    timestamp=time.time()))
    ups = FileStatsStorage(p).get_updates("filed")
    assert len(ups) == n_good + 1 and ups[-1].iteration == 99


def test_file_storage_missing_final_newline_kept(tmp_path):
    p = str(tmp_path / "stats.jsonl")
    FileStatsStorage(p).put_update(StatsReport(
        session_id="s", iteration=1, timestamp=0.0))
    with open(p, "r+b") as f:
        f.seek(0, 2)
        f.truncate(f.tell() - 1)
    reloaded = FileStatsStorage(p)
    assert len(reloaded.get_updates("s")) == 1
    reloaded.put_update(StatsReport(session_id="s", iteration=2,
                                    timestamp=0.0))
    assert len(FileStatsStorage(p).get_updates("s")) == 2


def test_session_id_no_collision():
    ids = {StatsListener(InMemoryStatsStorage()).session_id
           for _ in range(50)}
    assert len(ids) == 50


# ----------------------------------------------------------- against JAX
def _jax_mln(seed, stab, activation):
    from deeplearning4j_tpu.models.sequential import (
        MultiLayerNetwork as JNet,
    )
    from deeplearning4j_tpu.nn import conf as jconf, layers as jlayers

    return JNet(_builder(jconf, seed, True, stab, "adam").list()
                .layer(jlayers.DenseLayer(n_in=6, n_out=10,
                                          activation=activation))
                .layer(jlayers.OutputLayer(n_in=10, n_out=3, loss="mcxent",
                                           activation="softmax"))
                .build()).init()


def _close_harvest(h, jh):
    assert h["iteration"] == jh["iteration"]
    for sect, keys in (("gradient_stats", ("norm",)),
                       ("update_stats", ("norm", "param_norm", "ratio")),
                       ("activation_stats", ("mean", "std",
                                             "zero_fraction"))):
        assert set(h[sect]) == set(jh[sect])
        for layer in h[sect]:
            for k in keys:
                np.testing.assert_allclose(
                    h[sect][layer][k], jh[sect][layer][k], rtol=RTOL,
                    atol=1e-7, err_msg=f"{sect}/{layer}/{k}")


@pytest.mark.parametrize("stab", [False, True])
@pytest.mark.parametrize("activation", ["tanh", "relu"])
def test_harvest_matches_jax_sequential(stab, activation):
    from deeplearning4j_tpu.observability import (
        introspection as jintro,
    )

    jnet = _jax_mln(4, stab, activation)
    net = make_net(seed=4, intro=True, stab=stab, activation=activation)
    net.set_params_vector(np.asarray(jnet.params_to_vector()))
    for i in range(3):
        x, y = batch(seed=10 + i)
        net.fit(x, y)
        jnet.fit(x, y)
    _close_harvest(introspection.harvest_model(net),
                   jintro.harvest_model(jnet))


def test_harvest_matches_jax_graph():
    import deeplearning4j_tpu as jax_pkg
    import deeplearning4j_tpu.models.graph as jgraph
    import deeplearning4j_tpu_torch as port
    from deeplearning4j_tpu.observability import (
        introspection as jintro,
    )

    jnet = jgraph.ComputationGraph(_graph_net(jax_pkg)).init()
    net = ComputationGraph(_graph_net(port)).init(device="cpu")
    net.set_params_vector(np.asarray(jnet.params_to_vector()))
    for i in range(3):
        x, y = batch(seed=20 + i)
        net.fit(x, y)
        jnet.fit(x, y)
    _close_harvest(introspection.harvest_model(net),
                   jintro.harvest_model(jnet))


def test_checkpoint_manager_carries_the_vector_in_place(tmp_path):
    """The ``__introspect__`` vector checkpoints with the updater state
    and a restore writes it back into the net's own tensor."""
    from deeplearning4j_tpu_torch.resilience import CheckpointManager

    x, y = batch()
    net = make_net(intro=True)
    net.fit(x, y)
    cm = CheckpointManager(str(tmp_path), async_save=False)
    cm.save(net, block=True)
    saved = net.updater_state[introspection.STATE_KEY]["packed"].clone()
    packed = net.updater_state[introspection.STATE_KEY]["packed"]
    net.fit(x, y)
    assert not torch.equal(packed, saved)
    cm.restore(net)
    assert net.updater_state[introspection.STATE_KEY]["packed"] is packed
    assert torch.equal(packed, saved)
    assert introspection.harvest_model(net)["iteration"] == 0
    cm.close()


def test_reserved_subtrees_are_the_engines_keys_and_no_updaters():
    """``updaters.RESERVED_KEYS`` names exactly the subtrees of the
    guard, introspection and the numerics ledger, and ``inner_state``
    (what the updater and the guard's split read) leaves them out."""
    from deeplearning4j_tpu_torch.observability import numerics
    from deeplearning4j_tpu_torch.optimize import updaters as upd
    from deeplearning4j_tpu_torch.resilience import stability

    assert set(upd.RESERVED_KEYS) == {
        stability.STATE_KEY, introspection.STATE_KEY, numerics.STATE_KEY}
    state = {"m": {}, "v": {}, **{k: {} for k in upd.RESERVED_KEYS}}
    assert set(upd.inner_state(state)) == {"m", "v"}
    stab, inner = stability.split_state(state)
    assert stab is state[stability.STATE_KEY]
    assert set(inner) == {"m", "v"}
