"""The port's health rules and cluster aggregation
(``deeplearning4j_tpu_torch/observability/health.py``): the reference's
``tests/test_health.py`` cases that exercise ``health.py``, each run over
the JAX package's module and the port's (``impl``), with the same
inputs and the same expected verdicts; the port's ``InferenceServer``
``/health`` and ``/healthz``; and the rules the resilience slice reads
(``max_nonfinite_steps``, ``max_divergence_rewinds``,
``max_checkpoint_staleness``).  The masters' straggler acceptance runs
wait for ROADMAP A10."""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from deeplearning4j_tpu import observability as jax_obs
from deeplearning4j_tpu_torch import observability as port_obs

IMPLS = {"jax": jax_obs, "torch": port_obs}


@pytest.fixture(params=sorted(IMPLS))
def obs(request):
    """The observability package under test, with a fresh process
    registry (restored afterwards)."""
    mod = IMPLS[request.param]
    old = mod.get_registry()
    mod.set_registry(mod.MetricsRegistry())
    yield mod
    mod.set_registry(old)


# ------------------------------------------------------- straggler detection
def test_straggler_detector_names_slow_worker(obs):
    warns = []
    det = obs.StragglerDetector("unit", threshold=2.0, min_steps=3,
                                warn=warns.append)
    flagged = False
    for _ in range(8):
        for w in range(4):
            hit = det.observe(w, 0.010 if w != 2 else 0.050,
                              phases={"dispatch": 0.050})
            flagged = flagged or (hit and w == 2)
    assert flagged
    assert det.stragglers().keys() == {"2"}
    assert obs.get_registry().get_value(
        "dl4j_stragglers_total", component="unit", worker="2") > 0
    assert len(warns) == 1
    assert "worker 2" in warns[0] and "dispatch" in warns[0]
    assert "cluster median" in warns[0]


@pytest.mark.parametrize("times,want", [
    ({"0": 0.010, "1": 0.060}, {"1"}),                  # two workers
    ({"0": 0.00002, "1": 0.00002, "2": 0.00006,         # jitter floor
      "3": 0.00002}, set()),
])
def test_straggler_detector_cases(obs, times, want):
    det = obs.StragglerDetector("pair", threshold=2.0, min_steps=3,
                                warn=lambda m: None)
    for _ in range(8):
        for w, t in times.items():
            det.observe(w, t)
    assert set(det.stragglers()) == want


def test_straggler_detector_quiet_on_healthy_cluster(obs):
    warns = []
    det = obs.StragglerDetector("unit2", threshold=2.0, min_steps=3,
                                warn=warns.append)
    rs = np.random.RandomState(0)
    for _ in range(20):
        for w in range(4):
            assert not det.observe(w, 0.010 * (0.8 + 0.4 * rs.rand()))
    assert det.stragglers() == {} and warns == []
    assert obs.get_registry().get_value(
        "dl4j_stragglers_total", component="unit2", worker="0") is None


def test_worker_telemetry_families_and_cluster_view(obs):
    wt = obs.WorkerTelemetry("comp", min_steps=3)
    for _ in range(6):
        for w in range(3):
            wt.observe(w, 0.01 * (w + 1), batch=32)
    reg = obs.get_registry()
    assert reg.get("dl4j_worker_step_seconds").get(
        component="comp", worker="0").count == 6
    assert reg.get_value("dl4j_worker_samples_per_second", component="comp",
                         worker="2") == pytest.approx(32 / 0.03)
    view = wt.cluster_view()
    assert view["workers"] == 3 and view["slowest_worker"] == "2"
    assert view["step_seconds"]["max"] == pytest.approx(0.03)
    assert view["step_seconds"]["p50"] == pytest.approx(0.02)
    assert view["samples_per_second_total"] > 0


# ---------------------------------------------------------- aggregation
_OK = {"worker": "good", "count": 3, "mean": 0.02, "samples": [0.02] * 3,
       "samples_per_second": 50.0}
_GARBAGE = [
    None, {}, "not-a-dict", 42, [],
    {"worker": "no-count"},
    {"worker": "zero", "count": 0},
    {"worker": "bool-count", "count": True},
    {"worker": "str-count", "count": "three"},
    {"worker": "bad-mean", "count": 2, "mean": "fast"},
    {"worker": "bad-samples", "count": 2, "mean": 0.01, "samples": "oops"},
    {"worker": "mixed-samples", "count": 2, "mean": 0.01,
     "samples": [0.01, "nan-ish", None, True]},
    {"worker": "bad-sps", "count": 2, "mean": 0.01,
     "samples_per_second": {"rate": 1}},
]


@pytest.mark.parametrize("snaps", [
    [{"worker": "a", "count": 4, "mean": 0.01, "samples": [0.01] * 4,
      "samples_per_second": 100.0},
     {"worker": "b", "count": 4, "mean": 0.04, "samples": [0.04] * 4,
      "samples_per_second": 25.0}],
    [],
    [_OK, dict(_OK, worker="newer", mean=0.04, some_v2_field={"n": True})],
    [_OK, dict(_OK, worker="alien", schema=99)],
    [_OK] + _GARBAGE,
    _GARBAGE[:5],
], ids=["plain", "empty", "newer_keys", "alien_schema", "garbage",
        "all_garbage"])
def test_cluster_aggregator_merge_matches_jax(snaps):
    got = port_obs.ClusterStatsAggregator.merge(snaps)
    want = jax_obs.ClusterStatsAggregator.merge(snaps)
    assert json.dumps(got, sort_keys=True, default=str) == json.dumps(
        want, sort_keys=True, default=str)


def test_cluster_aggregator_from_registry(obs):
    wt = obs.WorkerTelemetry("regview", min_steps=2)
    for _ in range(5):
        wt.observe("0", 0.002)
        wt.observe("1", 0.2)
    view = obs.ClusterStatsAggregator.from_registry(component="regview")
    assert view["workers"] == 2 and view["slowest_worker"] == "1"
    assert view["step_seconds"]["max"] == pytest.approx(0.2)


# ----------------------------------------------------------------- rules
def test_histogram_quantile(obs):
    reg = obs.get_registry()
    h = reg.histogram("q_seconds", "q", buckets=(0.01, 0.1, 1.0)).labels()
    for _ in range(90):
        h.observe(0.005)
    for _ in range(10):
        h.observe(0.5)
    assert obs.histogram_quantile(h, 0.5) <= 0.01
    assert 0.1 < obs.histogram_quantile(h, 0.99) <= 1.0
    assert np.isnan(obs.histogram_quantile(
        reg.histogram("q2_seconds", "q").labels(), 0.99))


def test_health_rules_verdicts(obs):
    reg = obs.get_registry()
    h = reg.histogram("dl4j_fit_step_seconds", "t",
                      labels=("model",)).labels(model="M")
    for _ in range(100):
        h.observe(0.3)
    reg.gauge("dl4j_fit_samples_per_second", "s",
              labels=("model",)).set(50.0, model="M")
    reg.counter("dl4j_recompiles_total", "r", labels=("fn",)).inc(
        5, fn="step")
    verdict = obs.HealthEvaluator([
        obs.HealthRule("step_p99", "max_step_p99", 0.1),
        obs.HealthRule("tput", "min_throughput", 100.0),
        obs.HealthRule("recompiles", "max_recompiles", 3),
    ], component="t1").evaluate()
    assert not verdict.healthy
    assert {r["name"] for r in verdict.failing} == {
        "step_p99", "tput", "recompiles"}
    by_name = {r["name"]: r for r in verdict.results}
    assert by_name["step_p99"]["observed"] > 0.1
    assert by_name["recompiles"]["observed"] == 5.0
    assert reg.get_value("dl4j_health_status", component="t1") == 0.0
    ok = obs.HealthEvaluator([
        obs.HealthRule("step_p99", "max_step_p99", 1.0),
        obs.HealthRule("tput", "min_throughput", 10.0),
        obs.HealthRule("recompiles", "max_recompiles", 10),
    ], component="t2").evaluate()
    assert ok.healthy and ok.failing == []
    assert reg.get_value("dl4j_health_status", component="t2") == 1.0


def test_min_throughput_ignores_stale_low_child(obs):
    reg = obs.get_registry()
    fam = reg.gauge("dl4j_fit_samples_per_second", "s", labels=("model",))
    fam.set(5.0, model="tiny_warmup")
    fam.set(10000.0, model="production")
    res = obs.HealthRule("tput", "min_throughput", 100.0).evaluate(reg)
    assert res["ok"] and res["observed"] == 10000.0


@pytest.mark.parametrize("require", [False, True])
def test_health_rule_no_data_and_require_data(obs, require):
    res = obs.HealthRule("p99", "max_step_p99", 0.1,
                         require_data=require).evaluate(obs.get_registry())
    assert res["ok"] is (not require)
    if not require:
        assert res["observed"] is None


def test_health_predicate_rule(obs):
    reg = obs.get_registry()
    rule = obs.HealthRule("alive", "predicate",
                          fn=lambda extra: (extra, extra, "thread check"))
    assert rule.evaluate(reg, extra=True)["ok"]
    assert not rule.evaluate(reg, extra=False)["ok"]
    boom = obs.HealthRule("alive", "predicate",
                          fn=lambda extra: 1 / 0).evaluate(reg)
    assert not boom["ok"] and "raised" in boom["detail"]


@pytest.mark.parametrize("kind,family,labels,value,limit,ok", [
    ("max_nonfinite_steps", "dl4j_nonfinite_steps_total",
     {"component": "c"}, 3.0, 2, False),
    ("max_nonfinite_steps", "dl4j_nonfinite_steps_total",
     {"component": "c"}, 2.0, 2, True),
    ("max_divergence_rewinds", "dl4j_divergence_rewinds_total",
     {"component": "c"}, 1.0, 0, False),
    ("max_checkpoint_staleness", "dl4j_checkpoint_staleness_seconds",
     {"directory": "/d"}, 7200.0, 3600, False),
    ("max_checkpoint_staleness", "dl4j_checkpoint_staleness_seconds",
     {"directory": "/d"}, 10.0, 3600, True),
])
def test_resilience_rules(obs, kind, family, labels, value, limit, ok):
    """The rules resilience reads, over the metric families its
    runtimes publish; the same verdict and observed value in both."""
    reg = obs.get_registry()
    if family.endswith("_total"):
        reg.counter(family, "h", labels=tuple(labels)).inc(value, **labels)
    else:
        reg.gauge(family, "h", labels=tuple(labels)).set(value, **labels)
    res = obs.HealthRule("r", kind, limit).evaluate(reg)
    assert res["ok"] is ok and res["observed"] == value


@pytest.mark.parametrize("which", ["serving", "training"])
def test_default_rule_sets_match(which):
    if which == "serving":
        got = port_obs.default_serving_rules(max_queue_depth=10.0)
        want = jax_obs.default_serving_rules(max_queue_depth=10.0)
    else:
        got = port_obs.default_training_rules(max_step_p99_s=1.0)
        want = jax_obs.default_training_rules(max_step_p99_s=1.0)
    assert [(r.name, r.kind, r.limit) for r in got] == [
        (r.name, r.kind, r.limit) for r in want]


# -------------------------------------------------------------- endpoints
def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, json.loads(r.read())


def test_inference_server_health_endpoint():
    from deeplearning4j_tpu_torch.models.sequential import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.streaming import InferenceServer

    old = port_obs.get_registry()
    port_obs.set_registry(port_obs.MetricsRegistry())
    net = MultiLayerNetwork(
        (NeuralNetConfiguration.builder().seed(7)
         .updater("sgd", learning_rate=0.1).list()
         .layer(DenseLayer(n_in=8, n_out=16))
         .layer(OutputLayer(n_in=16, n_out=4)).build())).init(device="cpu")
    server = InferenceServer(net, max_batch=8, port=0)
    try:
        url = f"http://127.0.0.1:{server.start()}"
        status, body = _get(f"{url}/health")
        assert status == 200 and body["healthy"] is True
        assert {"dispatcher_alive", "queue_depth", "recompile_budget"} <= {
            r["name"] for r in body["rules"]}
        server.health.rules.append(port_obs.HealthRule(
            "always_red", "max_queue_depth", -1.0,
            metric="dl4j_serving_queue_depth"))
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"{url}/health", timeout=10)
        assert ei.value.code == 503
        body = json.loads(ei.value.read())
        assert body["healthy"] is False and "always_red" in body["failing"]
        red = [r for r in body["rules"] if r["name"] == "always_red"][0]
        assert red["observed"] is not None and red["limit"] == -1.0
        status, hz = _get(f"{url}/healthz")
        assert status == 200 and hz == {"status": "ok",
                                        "dispatcher_alive": True}
    finally:
        server.stop()
        port_obs.set_registry(old)
