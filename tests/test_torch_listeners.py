"""The port's listeners (``optimize/listeners.py``), fit telemetry
(``observability/fitmetrics.py``) and training UI stats
(``ui/stats.py``, ``ui/storage.py``) on the CPU.

- The reference's ``tests/test_ui.py:51-114`` oracles over the port:
  ``StatsListener`` scores and histograms, its reporting frequency, the
  flow listener, ``FileStatsStorage`` reloads, the storage fan-out.
- The reference's listener cases (``tests/test_health.py:656-704``,
  ``tests/test_lazy_score.py:62``, ``tests/test_observability.py:282``):
  ``PerformanceListener``'s rolling rate and ETA, collected scores,
  the fit-loop metrics; ``ProfilerListener`` writes a Chrome trace.
- The port against the JAX package: a report's parameter histograms and
  summaries equal the reference's ``_tensor_stats`` on the same weights
  (counts exactly, statistics to 1e-6 relative); the listeners see the
  same iterations and batch sizes as the JAX facades'.
- Both facades: listeners fire once a step (a TBPTT window, a
  ``fit_scanned`` window), and a listener that reads no score leaves
  the loss on the device.
"""

import json
import time

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.datasets import (
    DataSet, ListDataSetIterator,
)
from deeplearning4j_tpu_torch.models.sequential import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.observability import (
    MetricsRegistry, fit_telemetry, get_registry, set_registry,
)
from deeplearning4j_tpu_torch.optimize.listeners import (
    CollectScoresIterationListener, ComposableIterationListener,
    IterationListener, PerformanceListener, ProfilerListener,
    ScoreIterationListener,
)
from deeplearning4j_tpu_torch.ui import (
    FileStatsStorage, FlowIterationListener, HistogramIterationListener,
    InMemoryStatsStorage, StatsListener, StatsReport,
    StatsUpdateConfiguration,
)


def tiny_net():
    conf = (NeuralNetConfiguration.builder().seed(1)
            .updater("sgd", learning_rate=0.5)
            .list()
            .layer(DenseLayer(n_in=2, n_out=4, activation="tanh"))
            .layer(OutputLayer(n_in=4, n_out=2, loss="mcxent",
                               activation="softmax"))
            .build())
    return MultiLayerNetwork(conf).init(device="cpu")


def xor():
    x = np.array([[0, 0], [0, 1], [1, 0], [1, 1]], np.float32)
    y = np.array([[1, 0], [0, 1], [0, 1], [1, 0]], np.float32)
    return x, y


@pytest.fixture
def fresh_registry():
    old = get_registry()
    reg = MetricsRegistry()
    set_registry(reg)
    try:
        yield reg
    finally:
        set_registry(old)


# ------------------------------------------------- test_ui.py:51-114
def test_stats_listener_collects_scores_and_histograms():
    net = tiny_net()
    storage = InMemoryStatsStorage()
    net.set_listeners(StatsListener(storage, session_id="s1"))
    x, y = xor()
    for _ in range(5):
        net.fit(x, y)
    assert storage.list_session_ids() == ["s1"]
    init = storage.get_init_report("s1")
    assert init.model_class == "MultiLayerNetwork"
    assert init.num_params == net.num_params()
    assert init.backend == "cpu"
    ups = storage.get_updates("s1")
    assert len(ups) == 5
    assert all(np.isfinite(u.score) for u in ups)
    hist = ups[-1].param_histograms
    assert any(k.endswith("/W") for k in hist)
    k = next(iter(hist))
    assert len(hist[k]["counts"]) == 20
    assert sum(hist[k]["counts"]) > 0


def test_stats_listener_frequency():
    net = tiny_net()
    storage = InMemoryStatsStorage()
    net.set_listeners(StatsListener(
        storage, session_id="s2",
        config=StatsUpdateConfiguration(reporting_frequency=3,
                                        collect_histograms_params=False)))
    x, y = xor()
    for _ in range(9):
        net.fit(x, y)
    ups = storage.get_updates("s2")
    assert [u.iteration for u in ups] == [3, 6, 9]


def test_flow_listener_records_structure():
    net = tiny_net()
    storage = InMemoryStatsStorage()
    net.set_listeners(FlowIterationListener(storage, session_id="f1",
                                            frequency=1))
    x, y = xor()
    net.fit(x, y)
    flow = storage.get_updates("f1")[-1].param_stats["flow"]
    assert len(flow["layers"]) == 2
    assert flow["layers"][0]["params"] == 2 * 4 + 4


def test_file_storage_roundtrip(tmp_path):
    p = str(tmp_path / "stats.jsonl")
    storage = FileStatsStorage(p)
    net = tiny_net()
    net.set_listeners(HistogramIterationListener(storage))
    x, y = xor()
    for _ in range(3):
        net.fit(x, y)
    sid = storage.list_session_ids()[0]
    reloaded = FileStatsStorage(p)
    assert reloaded.list_session_ids() == storage.list_session_ids()
    assert len(reloaded.get_updates(sid)) == 3
    assert reloaded.get_init_report(sid) is not None


def test_storage_listener_fanout():
    storage = InMemoryStatsStorage()
    got = []
    storage.add_listener(lambda rep: got.append(rep.iteration))
    storage.put_update(StatsReport(session_id="x", iteration=7,
                                   timestamp=time.time()))
    assert got == [7]


# ---------------------------------------------------- against JAX
def test_param_histograms_match_the_reference():
    """The report's histograms and summaries, computed by torch where
    the parameters lie, against the reference's jitted pass on the same
    weights."""
    from deeplearning4j_tpu.ui.stats import _tensor_stats as jax_stats
    from deeplearning4j_tpu_torch.ui.stats import _tensor_stats

    net = tiny_net()
    x, y = xor()
    net.fit(x, y)
    got = _tensor_stats(net.params, 20)
    want = jax_stats({k: {n: t.numpy() for n, t in v.items()}
                      for k, v in net.params.items()}, 20)
    assert set(got) == set(want)
    for name, e in got.items():
        w = want[name]
        assert e["counts"] == w["counts"], name
        for key in ("min", "max", "mean", "stdev", "mean_magnitude"):
            np.testing.assert_allclose(e[key], w[key], rtol=1e-6,
                                       atol=1e-7)
        np.testing.assert_allclose(e["bins"], w["bins"], rtol=1e-6,
                                   atol=1e-7)


class _Log(IterationListener):
    def __init__(self):
        self.seen = []
        self.batch = None

    def set_batch_size(self, n):
        self.batch = n

    def iteration_done(self, model, iteration):
        self.seen.append((iteration, self.batch))


def test_listener_iterations_match_jax():
    """The same fit on both facades' MultiLayerNetwork: listeners see
    the same (iteration, batch size) sequence."""
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
    from deeplearning4j_tpu.datasets.iterator import (
        ListDataSetIterator as JList,
    )
    from deeplearning4j_tpu.models.sequential import (
        MultiLayerNetwork as JNet,
    )
    from deeplearning4j_tpu.nn import layers as jlayers
    from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JConf

    rs = np.random.RandomState(0)
    x = rs.rand(20, 2).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rs.randint(0, 2, 20)]
    jnet = JNet((JConf.builder().seed(1).updater("sgd", learning_rate=0.5)
                 .list().layer(jlayers.DenseLayer(n_in=2, n_out=4))
                 .layer(jlayers.OutputLayer(n_in=4, n_out=2)).build())
                ).init()
    net = tiny_net()
    a, b = _Log(), _Log()
    net.set_listeners(a)
    jnet.set_listeners(b)
    net.fit(ListDataSetIterator(DataSet(x, y), 8), epochs=2)
    jnet.fit(JList(JDataSet(x, y), 8), epochs=2)
    assert a.seen == b.seen == [(i, 8) for i in range(1, 7)]


# ------------------------------------------------------------ listeners
def test_score_and_composable_listeners():
    logs = []
    scores = CollectScoresIterationListener(frequency=2)
    net = tiny_net()
    net.set_listeners(ComposableIterationListener(
        ScoreIterationListener(print_iterations=1, log=logs.append),
        scores))
    net.add_listener(_Log())
    x, y = xor()
    for _ in range(4):
        net.fit(x, y)
    assert len(logs) == 4 and logs[0].startswith("Score at iteration 1")
    assert [i for i, _ in scores.scores] == [2, 4]
    assert all(np.isfinite(s) for _, s in scores.scores)
    assert len(net.listeners) == 2 and net.listeners[1].seen[-1] == (4, 4)


def test_collect_scores_over_an_iterator():
    rs = np.random.RandomState(1)
    x = rs.rand(64, 2).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rs.randint(0, 2, 64)]
    net = tiny_net()
    lst = CollectScoresIterationListener(frequency=1)
    net.set_listeners(lst)
    net.fit(ListDataSetIterator(DataSet(x, y), 16))
    assert len(lst.scores) == 4
    assert all(np.isfinite(s) for _, s in lst.scores)


def test_performance_listener_eta_and_rolling():
    logs = []
    pl = PerformanceListener(frequency=1, report=logs.append,
                             total_iterations=100)
    net = tiny_net()
    net.set_listeners(pl)
    x, y = xor()
    for _ in range(4):
        net.fit(x, y)
    assert pl.rolling_samples_per_sec and pl.rolling_samples_per_sec > 0
    assert pl.eta_seconds is not None and pl.eta_seconds >= 0
    assert any("rolling samples/sec" in m for m in logs)
    assert any("ETA:" in m for m in logs)


def test_performance_listener_eta_on_resumed_model():
    pl = PerformanceListener(frequency=1, report=lambda m: None,
                             total_iterations=100)

    class M:
        last_batch_size = 8

    for i in range(5000, 5005):
        pl.iteration_done(M(), i)
    assert pl.eta_seconds is not None and pl.eta_seconds > 0


def test_profiler_listener_writes_a_chrome_trace(tmp_path):
    pl = ProfilerListener(str(tmp_path / "prof"), start_iteration=1,
                          duration=2)
    net = tiny_net()
    net.set_listeners(pl)
    x, y = xor()
    for _ in range(4):
        net.fit(x, y)
    assert not pl._active and pl.trace_path is not None
    with open(pl.trace_path) as f:
        trace = json.load(f)
    assert trace["traceEvents"]


# ------------------------------------------------------------ telemetry
def test_fit_records_step_metrics(fresh_registry):
    net = tiny_net()
    x, y = xor()
    for _ in range(3):
        net.fit(x, y)
    reg = fresh_registry
    assert reg.get_value("dl4j_fit_iterations_total",
                         model="MultiLayerNetwork") == 3
    hist = reg.get("dl4j_fit_step_seconds").get(model="MultiLayerNetwork")
    assert hist.count == 3 and hist.sum > 0
    assert reg.get_value("dl4j_fit_batch_size",
                         model="MultiLayerNetwork") == 4
    assert reg.get_value("dl4j_fit_samples_per_second",
                         model="MultiLayerNetwork") > 0
    assert net.last_step_seconds > 0 and net.last_samples_per_second > 0
    # the score gauge holds the device loss (read at scrape)
    assert np.isfinite(reg.get_value("dl4j_fit_score",
                                     model="MultiLayerNetwork"))
    assert "dl4j_fit_step_seconds_bucket" in reg.to_prometheus()


def test_fit_telemetry_handle_follows_the_registry(fresh_registry):
    tel = fit_telemetry("X")
    assert fit_telemetry("X") is tel
    tel.record_step(0.5, 10, torch.tensor(2.0), steps=2)
    assert fresh_registry.get_value("dl4j_fit_iterations_total",
                                    model="X") == 2
    assert fresh_registry.get_value("dl4j_fit_last_step_seconds",
                                    model="X") == 0.25
    assert fresh_registry.get_value("dl4j_fit_score", model="X") == 2.0
    fresh_registry.reset()
    assert fit_telemetry("X") is not tel


def test_a_listener_without_the_score_leaves_it_on_the_device():
    """The fit loop hands listeners the net; the loss stays a tensor
    until someone reads ``score_value``."""
    net = tiny_net()
    net.set_listeners(_Log())
    x, y = xor()
    net.fit(x, y)
    assert torch.is_tensor(net._score)
    assert np.isfinite(net.score_value)
    assert isinstance(net._score, float)


def test_graph_tbptt_and_scanned_windows_notify():
    """The graph facade's listeners (``set_listeners``) fire once a TBPTT
    window; ``fit_scanned`` fires once a window with its samples."""
    from deeplearning4j_tpu_torch.models.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.layers import LSTM, RnnOutputLayer

    conf = (NeuralNetConfiguration.builder().seed(2)
            .updater("sgd", learning_rate=0.1).graph()
            .backprop_type("truncated_bptt", 3)
            .add_inputs("in")
            .add_layer("l", LSTM(n_in=2, n_out=4), "in")
            .add_layer("out", RnnOutputLayer(n_in=4, n_out=2), "l")
            .set_outputs("out").build())
    net = ComputationGraph(conf).init(device="cpu")
    log = _Log()
    net.set_listeners(log)
    rs = np.random.RandomState(3)
    x = rs.rand(5, 7, 2).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rs.randint(0, 2, (5, 7))]
    net.fit(x, y)
    assert log.seen == [(1, 5), (2, 5), (3, 5)]
    seq = tiny_net()
    slog = _Log()
    seq.set_listeners(slog)
    a, b = xor()
    seq.fit_scanned([(a, b)] * 5, scan_steps=2)
    assert slog.seen == [(2, 8), (4, 8), (5, 4)]
