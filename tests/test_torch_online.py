"""The port's online learning (``deeplearning4j_tpu_torch/online/``) on
the CPU: the reference's ``tests/test_online.py`` oracles over the port —
stream consumption with quarantine, the HTTP transport through a broker
restart, the promotion state machine (gate, canary, retaining swap,
watch, rollback), windowed fit with a crash replayed bit for bit, both
facades, the chaos drill — and the JAX pipeline against the port's fed
the same records from the same weights (the same outcomes, final
parameters within ``rtol=1e-4``).  What the port adds: a rejected
window's revert writes into the trainer's tensors, and an error from
``fit`` that is not a trainer crash fails the run."""

import json
import threading
import time
import urllib.request

import numpy as np
import pytest

import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.models.common import tree_leaves
from deeplearning4j_tpu_torch.models.sequential import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.observability import (
    MetricsRegistry, get_flight_recorder,
)
from deeplearning4j_tpu_torch.online import (
    OnlineLearningPipeline, PromotionManager, StreamConsumer,
    default_gate_rules,
)
from deeplearning4j_tpu_torch.resilience import (
    CheckpointManager, FaultInjector, RetryPolicy, inject_faults,
)
from deeplearning4j_tpu_torch.serving import ServingEngine
from deeplearning4j_tpu_torch.streaming import MessageBroker, dataset_to_json

N_IN, N_OUT = 2, 2


def small_net(seed=7, lr=0.3):
    conf = (NeuralNetConfiguration.builder().seed(seed)
            .updater("sgd", learning_rate=lr).list()
            .layer(DenseLayer(n_in=N_IN, n_out=8, activation="tanh"))
            .layer(OutputLayer(n_in=8, n_out=N_OUT, loss="mcxent",
                               activation="softmax"))
            .build())
    return MultiLayerNetwork(conf).init(device="cpu")


def task_batch(rng, n=16, poisoned=False):
    """Linearly separable 2-class task (fast for plain SGD, so healthy
    windows measurably improve and poisoned ones measurably regress)."""
    x = rng.rand(n, N_IN).astype(np.float32)
    y = (x[:, 0] + x[:, 1] > 1.0).astype(np.int64)
    if poisoned:
        y = 1 - y      # inverted labels: valid records, regressed model
    lab = np.zeros((n, N_OUT), np.float32)
    lab[np.arange(n), y] = 1.0
    return DataSet(x, lab)


def publish_window(broker, topic, rng, n_batches, batch=16, poisoned=False):
    for _ in range(n_batches):
        broker.publish(topic, dataset_to_json(
            task_batch(rng, batch, poisoned=poisoned),
            meta={"ts": time.time()}))


def make_engine(registry=None, **kw):
    kw.setdefault("max_batch", 16)
    kw.setdefault("max_queue", 4096)
    kw.setdefault("example", np.zeros((N_IN,), np.float32))
    engine = ServingEngine(small_net(), registry=registry, **kw)
    engine.start()
    return engine


def fast_pm(engine, holdout, registry=None, **kw):
    kw.setdefault("gate_rules", default_gate_rules(max_loss_regression=0.35))
    kw.setdefault("canary_fraction", 1.0)
    kw.setdefault("canary_min_requests", 2)
    kw.setdefault("canary_timeout_s", 10.0)
    kw.setdefault("watch_window_s", 0.2)
    kw.setdefault("watch_poll_s", 0.02)
    return PromotionManager(engine, eval_set=holdout, registry=registry,
                            **kw)


def events(kind):
    return [e for e in get_flight_recorder().events() if e.kind == kind]


# ------------------------------------------------------------ consumer
def test_consumer_quarantines_bad_records_and_counts():
    reg = MetricsRegistry()
    broker = MessageBroker(registry=reg)
    quarantine = broker.subscribe("t.quarantine")
    cons = StreamConsumer("t", broker=broker, registry=reg)
    rng = np.random.RandomState(0)

    good = task_batch(rng, 4)
    broker.publish("t", dataset_to_json(good))
    nan = task_batch(rng, 4)
    nan.features[0, 0] = np.nan
    broker.publish("t", dataset_to_json(nan))
    broker.publish("t", "this is not json")
    lies = json.loads(dataset_to_json(task_batch(rng, 4)))
    lies["features"]["shape"] = [400, 400]     # payload-length lie
    broker.publish("t", json.dumps(lies))
    good2 = task_batch(rng, 4)
    broker.publish("t", dataset_to_json(good2))

    got1 = cons.poll_dataset(timeout=2.0)
    got2 = cons.poll_dataset(timeout=2.0)
    assert got1 is not None and got2 is not None
    np.testing.assert_allclose(got1[0].features, good.features)
    np.testing.assert_allclose(got2[0].features, good2.features)
    assert cons.poll_dataset(timeout=0.1) is None
    assert cons.quarantined == 3 and cons.delivered == 2

    reasons = set()
    while quarantine.qsize():
        letter = json.loads(quarantine.get_nowait())
        reasons.add(letter["reason"])
        assert letter["topic"] == "t" and "payload" in letter
    assert reasons == {"non_finite", "bad_json", "shape_mismatch"}
    assert reg.get_value("dl4j_stream_quarantined_total", topic="t",
                         reason="non_finite") == 1
    assert len(events("stream_quarantined")) >= 3


def test_consumer_http_retries_through_broker_restart():
    """Satellite: dead/restarted broker endpoint — the consumer backs
    off through the outage and resumes the SAME subscription with no
    duplicated and no lost messages among those published after the
    broker came back."""
    rng = np.random.RandomState(1)
    broker = MessageBroker()
    port = broker.serve()
    url = f"http://127.0.0.1:{port}"

    def publish_http(ds):
        req = urllib.request.Request(
            f"{url}/publish/t", data=dataset_to_json(ds).encode(),
            headers={"Content-Type": "application/json"})
        urllib.request.urlopen(req, timeout=5)

    retry = RetryPolicy(max_retries=40, base_delay_s=0.05, max_delay_s=0.15,
                        seed=3, component="test-consumer")
    cons = StreamConsumer("t", url=url, sub_id="s1", retry_policy=retry)
    # HTTP subscriptions are created server-side by the first poll
    assert cons.poll_dataset(timeout=0.2) is None
    first = task_batch(rng, 4)
    publish_http(first)
    got = cons.poll_dataset(timeout=5.0)
    np.testing.assert_allclose(got[0].features, first.features)

    broker.stop()   # the endpoint dies mid-stream

    def restart():
        time.sleep(0.4)
        broker2 = MessageBroker()
        broker2.serve(port=port)

    threading.Thread(target=restart, daemon=True).start()
    # this poll spans the outage: it must retry with backoff until the
    # restarted endpoint answers (an empty poll re-creates the sub)
    assert cons.poll_dataset(timeout=0.3) is None
    assert retry.retries > 0, "the outage never exercised the backoff path"

    after = [task_batch(rng, 4) for _ in range(3)]
    for ds in after:
        publish_http(ds)
    received = [cons.poll_dataset(timeout=5.0) for _ in range(3)]
    assert all(r is not None for r in received)
    for r, ds in zip(received, after):       # ordered, exactly once
        np.testing.assert_allclose(r[0].features, ds.features)
    assert cons.poll_dataset(timeout=0.2) is None   # no duplicates


# ----------------------------------------------------------- promotion
def test_gate_rejects_regressed_candidate_registry_untouched():
    reg = MetricsRegistry()
    engine = make_engine(registry=reg)
    try:
        rng = np.random.RandomState(2)
        holdout = task_batch(rng, 48)
        pm = fast_pm(engine, holdout, registry=reg,
                     canary_fraction=None)       # gate is under test
        v0 = engine.models.active("default").version

        poisoned = small_net(seed=9, lr=1.0)
        for _ in range(12):
            poisoned.fit(*_xy(task_batch(rng, 32, poisoned=True)))
        res = pm.consider(poisoned, "bad-candidate")

        assert res.outcome == "rejected"
        assert engine.models.active("default").version == v0
        assert reg.get_value("dl4j_promotions_total", model="default",
                             outcome="rejected") == 1
        ev = [e for e in events("promotion_rejected")
              if e.attrs.get("candidate") == "bad-candidate"]
        assert ev and "no_loss_regression_vs_active" in \
            ev[-1].attrs["failed_rules"]
    finally:
        engine.stop()


def _xy(ds):
    return ds.features, ds.labels


def test_canary_rejects_erroring_candidate():
    reg = MetricsRegistry()
    engine = make_engine(registry=reg)
    try:
        rng = np.random.RandomState(3)
        holdout = task_batch(rng, 32)

        class ExplodesOnRealTraffic:
            """Scores fine offline and warms up fine (zeros), but raises
            on live rows — exactly the failure class a canary exists to
            absorb before a full swap would."""

            def output(self, x):
                if np.asarray(x).max() > 0:
                    raise RuntimeError("boom on real traffic")
                return np.zeros((len(x), N_OUT), np.float32)

            def score(self, x, y, fmask=None, lmask=None):
                return 0.5

        pm = fast_pm(engine, holdout, registry=reg, gate_rules=[],
                     canary_max_error_rate=0.0)
        v0 = engine.models.active("default").version
        res = pm.consider(ExplodesOnRealTraffic(), "exploder")
        assert res.outcome == "canary_rejected"
        assert res.canary["bad"] > 0
        assert engine.models.active("default").version == v0
        assert "default:canary" not in engine.models.names()
        assert reg.get_value("dl4j_promotions_total", model="default",
                             outcome="canary_rejected") == 1
        # the primary kept serving fine throughout
        out = engine.predict(holdout.features[:4])
        assert np.isfinite(np.asarray(out)).all()
    finally:
        engine.stop()


def test_promote_commit_and_freshness_gauge():
    reg = MetricsRegistry()
    engine = make_engine(registry=reg)
    try:
        rng = np.random.RandomState(4)
        holdout = task_batch(rng, 48)
        pm = fast_pm(engine, holdout, registry=reg)
        cand = small_net(seed=11)
        ts = time.time() - 2.0
        res = pm.consider(cand, "good-candidate", event_ts=ts)
        assert res.outcome == "promoted"
        assert res.freshness_s is not None and res.freshness_s >= 2.0
        assert reg.get_value("dl4j_online_model_freshness_seconds",
                             model="default") >= 2.0
        # the rollback window is CLOSED after commit
        assert engine.models.retained("default") is None
        with pytest.raises(Exception):
            engine.rollback("default")
    finally:
        engine.stop()


def test_watch_regression_triggers_automatic_rollback():
    reg = MetricsRegistry()
    engine = make_engine(registry=reg)
    try:
        rng = np.random.RandomState(5)
        holdout = task_batch(rng, 32)
        baseline = engine.models.active("default").model.output(
            holdout.features).numpy()

        # the forced post-swap metric regression: every watch poll fires
        # requests with an impossible deadline -> real `deadline`
        # statuses on the serving counters
        def poisoned_sleep(dt):
            for _ in range(3):
                try:
                    engine.predict(holdout.features[:4], deadline_s=1e-6)
                except Exception:
                    pass
            time.sleep(min(dt, 0.02))

        pm = fast_pm(engine, holdout, registry=reg,
                     gate_rules=[], canary_fraction=None,
                     watch_window_s=0.5, watch_min_requests=3,
                     watch_max_error_rate=0.3, sleep=poisoned_sleep)
        v0 = engine.models.active("default").version
        res = pm.consider(small_net(seed=12), "watched-candidate")
        assert res.outcome == "rolled_back"
        active = engine.models.active("default")
        assert active.version == v0, "rollback must restore the previous"
        assert reg.get_value("dl4j_promotions_total", model="default",
                             outcome="rolled_back") == 1
        assert events("rollback"), "engine rollback flight event missing"
        # and the restored version actually serves the OLD weights
        out = np.asarray(engine.predict(holdout.features))
        np.testing.assert_allclose(out, baseline, atol=1e-5)
    finally:
        engine.stop()


# ------------------------------------------------------------- pipeline
def test_pipeline_trains_windows_and_promotes(tmp_path):
    reg = MetricsRegistry()
    engine = make_engine(registry=reg)
    try:
        rng = np.random.RandomState(6)
        broker = MessageBroker(registry=reg)
        holdout = task_batch(rng, 48)
        cm = CheckpointManager(str(tmp_path), keep=5, async_save=False,
                               registry=reg)
        pipe = OnlineLearningPipeline(
            small_net(seed=7), engine, topic="train", broker=broker,
            checkpoint_manager=cm,
            promotion=fast_pm(engine, holdout, registry=reg),
            window_size=2, poll_timeout_s=0.3, registry=reg)
        publish_window(broker, "train", rng, 4)
        summary = pipe.run(max_windows=2)
        assert summary["windows"] == 2
        assert summary["outcomes"].get("promoted") == 2
        assert summary["active_version"] == 3    # initial + 2 promotions
        assert len(summary["freshness_s"]) == 2
        assert reg.get_value("dl4j_online_windows_total",
                             status="trained") == 2
        # each window boundary committed a checkpoint (anchor + 2)
        assert len(cm.all_steps()) >= 3
    finally:
        engine.stop()


def test_pipeline_partial_window_still_trains(tmp_path):
    reg = MetricsRegistry()
    engine = make_engine(registry=reg)
    try:
        rng = np.random.RandomState(8)
        broker = MessageBroker(registry=reg)
        pipe = OnlineLearningPipeline(
            small_net(seed=7), engine, topic="train", broker=broker,
            checkpoint_manager=CheckpointManager(
                str(tmp_path), async_save=False, registry=reg),
            promotion=fast_pm(engine, task_batch(rng, 32), registry=reg),
            window_size=8, poll_timeout_s=0.3, registry=reg)
        publish_window(broker, "train", rng, 2)   # < window_size
        summary = pipe.run(max_windows=1)
        assert summary["windows"] == 1
        assert summary["records_delivered"] == 2
    finally:
        engine.stop()


def test_trainer_crash_replay_is_resume_equivalent(tmp_path):
    """A fatal mid-window crash restores the window boundary and replays
    the window from memory: the final weights are bit-identical to an
    uninterrupted run over the same stream, and nothing was re-consumed
    from the broker."""

    def run(tmp, crash):
        reg = MetricsRegistry()
        engine = make_engine(registry=reg)
        try:
            rng = np.random.RandomState(9)
            broker = MessageBroker(registry=reg)
            net = small_net(seed=13)
            pipe = OnlineLearningPipeline(
                net, engine, topic="train", broker=broker,
                checkpoint_manager=CheckpointManager(
                    str(tmp), keep=5, async_save=False, registry=reg),
                promotion=fast_pm(engine, task_batch(rng, 32), registry=reg,
                                  canary_fraction=None, watch_window_s=0.0),
                window_size=3, poll_timeout_s=0.3, registry=reg,
                retry_policy=RetryPolicy(max_retries=1, base_delay_s=0.01,
                                         component="online", registry=reg))
            publish_window(broker, "train", rng, 6)
            inj = FaultInjector(seed=1)
            if crash:
                # step 4 = inside the SECOND window (steps 3,4,5)
                inj.fail_at_step(4, component="MultiLayerNetwork",
                                 transient=False)
            with inject_faults(inj):
                summary = pipe.run(max_windows=2)
            assert summary["windows"] == 2
            if crash:
                assert [e for e in inj.injected
                        if e["kind"] == "step_fault"], "fault never fired"
                assert reg.get_value("dl4j_online_windows_total",
                                     status="retried") == 1
                assert events("online_trainer_crash")
            assert pipe.consumer.delivered == 6   # stream never re-read
            return [p.clone() for p in tree_leaves(net.params)]
        finally:
            engine.stop()

    clean = run(tmp_path / "clean", crash=False)
    crashed = run(tmp_path / "crashed", crash=True)
    for a, b in zip(clean, crashed):
        assert torch.equal(a, b)


def test_pipeline_works_with_computation_graph(tmp_path):
    """Both fit-loop facades drive the windowed mini-epochs."""
    from deeplearning4j_tpu_torch.models.graph import ComputationGraph

    conf = (NeuralNetConfiguration.builder().seed(3)
            .updater("sgd", learning_rate=0.3).graph()
            .add_inputs("in")
            .add_layer("d", DenseLayer(n_in=N_IN, n_out=8,
                                       activation="tanh"), "in")
            .add_layer("out", OutputLayer(n_in=8, n_out=N_OUT,
                                          loss="mcxent",
                                          activation="softmax"), "d")
            .set_outputs("out").build())
    net = ComputationGraph(conf).init(device="cpu")
    serving_model = ComputationGraph(conf).init(device="cpu")

    reg = MetricsRegistry()
    engine = ServingEngine(serving_model, max_batch=16, registry=reg,
                           example=np.zeros((N_IN,), np.float32))
    engine.start()
    try:
        rng = np.random.RandomState(10)
        broker = MessageBroker(registry=reg)
        pipe = OnlineLearningPipeline(
            net, engine, topic="train", broker=broker,
            checkpoint_manager=CheckpointManager(
                str(tmp_path), async_save=False, registry=reg),
            promotion=fast_pm(engine, task_batch(rng, 32), registry=reg),
            window_size=2, poll_timeout_s=0.3, registry=reg)
        publish_window(broker, "train", rng, 2)
        summary = pipe.run(max_windows=1)
        assert summary["outcomes"].get("promoted") == 1
        assert engine.models.active("default").model_type \
            == "ComputationGraph"
    finally:
        engine.stop()


# ------------------------------------------------------- chaos acceptance
def test_chaos_full_loop(tmp_path):
    """The acceptance drill: injected bad records, one fatal trainer
    crash mid-window, one deliberately regressed candidate, and a forced
    post-swap metric regression — the pipeline quarantines, auto-resumes,
    refuses the regressed candidate by name, promotes the next healthy
    one, and rolls back automatically, while concurrent serving clients
    see correct answers with zero dropped requests."""
    reg = MetricsRegistry()
    engine = make_engine(registry=reg)
    rng = np.random.RandomState(42)
    broker = MessageBroker(registry=reg)
    quarantine = broker.subscribe("train.quarantine")
    holdout = task_batch(rng, 64)

    # -------- concurrent serving load, asserting correctness per reply
    stop = threading.Event()
    failures, served = [], [0]

    def client():
        # own RNG: the shared `rng` drives the published training stream
        # and must stay deterministic
        feats = np.random.RandomState(123).rand(4, N_IN).astype(np.float32)
        while not stop.is_set():
            try:
                out = np.asarray(engine.predict(feats, deadline_s=10.0))
                if out.shape != (4, N_OUT) or not np.isfinite(out).all() \
                        or abs(float(out[0].sum()) - 1.0) > 1e-3:
                    failures.append(f"bad output {out!r}")
                served[0] += 1
            except Exception as e:
                failures.append(repr(e))

    clients = [threading.Thread(target=client, daemon=True)
               for _ in range(3)]
    for t in clients:
        t.start()

    # -------- forced post-swap regression, armed for the LAST window
    armed = {"on": False}

    def chaos_sleep(dt):
        # fire only while a rollback window is OPEN (post-swap watch):
        # the canary phase must judge the candidate on clean traffic
        if armed["on"] and engine.models.retained("default") is not None:
            for _ in range(4):
                try:
                    engine.predict(holdout.features[:4], deadline_s=1e-6)
                except Exception:
                    pass
        time.sleep(min(dt, 0.02))

    cm = CheckpointManager(str(tmp_path), keep=8, async_save=False,
                           registry=reg)
    # watch rules: the stock error-rate/probe rules PLUS an absolute
    # post-swap deadline-burst cap — the concurrent clients' ok volume
    # must not be able to dilute the forced regression below a rate
    # threshold, so the chaos assertion stays deterministic under load
    from deeplearning4j_tpu_torch.observability import HealthRule
    from deeplearning4j_tpu_torch.online import default_watch_rules

    def _deadline_burst(e):
        n = (e or {}).get("statuses", {}).get("deadline", 0)
        return (n <= 2, n, "post-swap deadline failures vs burst cap 2")

    pm = fast_pm(engine, holdout, registry=reg,
                 gate_rules=default_gate_rules(max_loss_regression=0.15),
                 watch_rules=default_watch_rules(max_error_rate=0.3,
                                                 min_requests=3)
                 + [HealthRule("deadline_burst", "predicate",
                               fn=_deadline_burst)],
                 watch_window_s=0.4, watch_poll_s=0.05,
                 sleep=chaos_sleep)
    net = small_net(seed=5, lr=1.0)
    pipe = OnlineLearningPipeline(
        net, engine, topic="train", broker=broker, checkpoint_manager=cm,
        promotion=pm, window_size=3, poll_timeout_s=0.5, registry=reg)

    try:
        # ---- window 1: healthy, laced with bad records + a trainer crash
        nan = task_batch(rng, 16)
        nan.features[0, 1] = np.inf
        broker.publish("train", dataset_to_json(nan))
        broker.publish("train", "garbage{{{")
        publish_window(broker, "train", rng, 3, batch=32)
        inj = FaultInjector(seed=7).fail_at_step(
            1, component="MultiLayerNetwork", transient=False)
        with inject_faults(inj):
            r1 = pipe.run(max_windows=1)
        assert [e for e in inj.injected if e["kind"] == "step_fault"]
        assert r1["outcomes"].get("promoted") == 1
        assert pipe.consumer.quarantined == 2
        assert reg.get_value("dl4j_online_windows_total",
                             status="retried") == 1
        v_good = engine.models.active("default").version

        # ---- window 2: poisoned-but-valid labels -> regressed candidate
        publish_window(broker, "train", rng, 3, batch=32, poisoned=True)
        r2 = pipe.run(max_windows=1)
        assert r2["outcomes"].get("rejected") == 1
        assert engine.models.active("default").version == v_good
        named = [e for e in events("promotion_rejected")
                 if str(e.attrs.get("candidate", "")).startswith("window-2")]
        assert named, "the flight event must name the refused candidate"

        # ---- window 3: healthy again -> promotes through canary + swap
        publish_window(broker, "train", rng, 3, batch=32)
        r3 = pipe.run(max_windows=1)
        assert r3["outcomes"].get("promoted") == 2
        v_promoted = engine.models.active("default").version
        assert v_promoted > v_good

        # ---- window 4: healthy candidate, but serving regresses after
        # the swap (forced deadline failures) -> automatic rollback
        publish_window(broker, "train", rng, 3, batch=32)
        armed["on"] = True
        r4 = pipe.run(max_windows=1)
        armed["on"] = False
        assert r4["outcomes"].get("rolled_back") == 1
        assert engine.models.active("default").version == v_promoted, \
            "rollback must restore the last promoted version"
        assert reg.get_value("dl4j_promotions_total", model="default",
                             outcome="rolled_back") == 1
    finally:
        stop.set()
        for t in clients:
            t.join(timeout=10)
        engine.stop()
        cm.close()

    # ---- the whole drill dropped ZERO legitimate requests
    assert not failures, failures[:5]
    assert served[0] > 0
    # quarantine preserved both dead letters with their reasons
    letters = []
    while quarantine.qsize():
        letters.append(json.loads(quarantine.get_nowait()))
    assert {l["reason"] for l in letters} == {"non_finite", "bad_json"}


# --------------------------------------------------- review-hardening pins
def test_watch_error_rate_ignores_sheds_in_denominator():
    """95 queue_full deltas must not dilute 2 failures out of 5 judged
    requests below the SLO (same 'judged' convention as the canary)."""
    reg = MetricsRegistry()
    engine = make_engine(registry=reg)
    try:
        pm = fast_pm(engine, task_batch(np.random.RandomState(0), 16),
                     registry=reg)
        base = pm._status_counts()
        with engine._breakdown_lock:
            tally = engine._model_status.setdefault("default", {})
            for status, n in (("ok", 3), ("error", 2), ("queue_full", 95)):
                tally[status] = tally.get(status, 0) + n
        extra = pm._watch_extra(base, True, None)
        assert extra["requests"] == 5         # judged only
        assert extra["bad"] == 2
        assert abs(extra["error_rate"] - 0.4) < 1e-9
        assert extra["statuses"]["queue_full"] == 95   # still visible
    finally:
        engine.stop()


def test_canary_rejects_nan_outputs_via_probe():
    """A candidate that returns NaN without raising scores 'ok' on
    transport tallies — the canary probe verdict must catch it BEFORE
    the full swap."""
    reg = MetricsRegistry()
    engine = make_engine(registry=reg)
    try:
        rng = np.random.RandomState(17)
        holdout = task_batch(rng, 32)

        class NaNModel:
            def output(self, x):
                return np.full((len(np.asarray(x)), N_OUT), np.nan,
                               np.float32)

            def score(self, x, y, fmask=None, lmask=None):
                return 0.5

        pm = fast_pm(engine, holdout, registry=reg, gate_rules=[])
        v0 = engine.models.active("default").version
        res = pm.consider(NaNModel(), "nan-candidate")
        assert res.outcome == "canary_rejected"
        assert "NaN" in res.canary["probe_detail"]
        assert engine.models.active("default").version == v0
    finally:
        engine.stop()


def test_continuous_mode_survives_traffic_lull(tmp_path):
    """start() runs the loop in continuous mode: a quiet period longer
    than poll_timeout_s must NOT silently end it."""
    reg = MetricsRegistry()
    engine = make_engine(registry=reg)
    try:
        rng = np.random.RandomState(18)
        broker = MessageBroker(registry=reg)
        pipe = OnlineLearningPipeline(
            small_net(seed=7), engine, topic="train", broker=broker,
            checkpoint_manager=CheckpointManager(
                str(tmp_path), async_save=False, registry=reg),
            promotion=fast_pm(engine, task_batch(rng, 32), registry=reg),
            window_size=2, poll_timeout_s=0.2, registry=reg)
        pipe.start()
        time.sleep(0.8)          # several idle poll timeouts
        assert pipe._thread.is_alive(), "continuous mode exited on a lull"
        publish_window(broker, "train", rng, 2)
        deadline = time.monotonic() + 30
        while not pipe.results and time.monotonic() < deadline:
            time.sleep(0.05)
        assert pipe.results and pipe.results[0]["outcome"] == "promoted"
        pipe.stop()
        assert not pipe._thread or not pipe._thread.is_alive()
    finally:
        engine.stop()


def test_consumer_retains_dead_letters_locally():
    """The broker has no retention: dead letters published before anyone
    subscribed the quarantine topic must still be inspectable on the
    consumer itself."""
    reg = MetricsRegistry()
    broker = MessageBroker(registry=reg)   # note: NO quarantine subscriber
    cons = StreamConsumer("t", broker=broker, registry=reg)
    bad = task_batch(np.random.RandomState(0), 4)
    bad.features[0, 0] = np.nan
    broker.publish("t", dataset_to_json(bad))
    broker.publish("t", "junk{{")
    assert cons.poll_dataset(timeout=0.3) is None
    letters = list(cons.dead_letters)
    assert [l["reason"] for l in letters] == ["non_finite", "bad_json"]
    assert all("payload" in l for l in letters)


# ------------------------------------------------ the port against JAX
def _jax_small_net(seed=7, lr=1.0):
    from deeplearning4j_tpu.models.sequential import (
        MultiLayerNetwork as JaxMultiLayerNetwork,
    )
    from deeplearning4j_tpu.nn import layers as jlayers
    from deeplearning4j_tpu.nn.conf import (
        NeuralNetConfiguration as JaxConfiguration,
    )

    conf = (JaxConfiguration.builder().seed(seed)
            .updater("sgd", learning_rate=lr).list()
            .layer(jlayers.DenseLayer(n_in=N_IN, n_out=8, activation="tanh"))
            .layer(jlayers.OutputLayer(n_in=8, n_out=N_OUT, loss="mcxent",
                                       activation="softmax"))
            .build())
    return JaxMultiLayerNetwork(conf).init()


def _run_pipeline(online, serving, tmp, jax_side, windows):
    """Four windows of records through one side's pipeline (gate only:
    no canary, no watch, so the outcomes are the losses' verdicts)."""
    if jax_side:
        from deeplearning4j_tpu.observability import (
            MetricsRegistry as JReg,
        )
        from deeplearning4j_tpu.online import (
            OnlineLearningPipeline as JPipe, PromotionManager as JPM,
            default_gate_rules as jrules,
        )
        from deeplearning4j_tpu.resilience import (
            CheckpointManager as JCM,
        )
        from deeplearning4j_tpu.serving import ServingEngine as JEngine
        from deeplearning4j_tpu.streaming import MessageBroker as JBroker

        reg, Engine, PM, rules, Pipe, CM, Broker = (
            JReg(), JEngine, JPM, jrules, JPipe, JCM, JBroker)
    else:
        reg, Engine, PM, rules, Pipe, CM, Broker = (
            MetricsRegistry(), ServingEngine, PromotionManager,
            default_gate_rules, OnlineLearningPipeline, CheckpointManager,
            MessageBroker)
    rng = np.random.RandomState(31)
    holdout = task_batch(rng, 64)
    engine = Engine(serving, max_batch=16, registry=reg,
                    example=np.zeros((N_IN,), np.float32)).start()
    try:
        broker = Broker(registry=reg)
        pipe = Pipe(online, engine, topic="train", broker=broker,
                    checkpoint_manager=CM(str(tmp), keep=5,
                                          async_save=False, registry=reg),
                    promotion=PM(engine, eval_set=holdout, registry=reg,
                                 gate_rules=rules(max_loss_regression=0.05),
                                 canary_fraction=None, watch_window_s=0.0),
                    window_size=3, poll_timeout_s=0.3, registry=reg)
        outcomes = []
        for poisoned in windows:
            for ds in [task_batch(rng, 32, poisoned=poisoned)
                       for _ in range(3)]:
                broker.publish("train", dataset_to_json(ds))
            pipe.run(max_windows=1)
            outcomes.append(pipe.results[-1]["outcome"])
        return outcomes
    finally:
        engine.stop()


def test_jax_and_port_pipelines_agree(tmp_path):
    """The same records from the same weights: the JAX pipeline and the
    port's give the same outcomes (a poisoned window rejected and the
    trainer reverted), and final parameters within ``rtol=1e-4``."""
    windows = (False, False, True, False)
    jnet, jserve = _jax_small_net(seed=7), _jax_small_net(seed=7)
    net, serve = small_net(seed=7, lr=1.0), small_net(seed=7, lr=1.0)
    net.set_params_vector(np.asarray(jnet.params_to_vector()))
    serve.set_params_vector(np.asarray(jserve.params_to_vector()))
    jout = _run_pipeline(jnet, jserve, tmp_path / "jax", True, windows)
    out = _run_pipeline(net, serve, tmp_path / "port", False, windows)
    assert out == jout == ["promoted", "promoted", "rejected", "promoted"]
    np.testing.assert_allclose(net.params_to_vector(),
                               np.asarray(jnet.params_to_vector()),
                               rtol=1e-4, atol=1e-6)


def test_rejected_window_reverts_into_the_trainers_tensors(tmp_path):
    """A rejected window's revert writes the accepted artifact into the
    trainer's own tensors (a captured step keeps replaying on them): the
    same tensor objects, holding the last promoted weights."""
    reg = MetricsRegistry()
    engine = make_engine(registry=reg)
    try:
        rng = np.random.RandomState(12)
        broker = MessageBroker(registry=reg)
        net = small_net(seed=7, lr=1.0)
        leaves = tree_leaves(net.params) + tree_leaves(net.updater_state)
        pipe = OnlineLearningPipeline(
            net, engine, topic="train", broker=broker,
            promotion=fast_pm(engine, task_batch(rng, 64), registry=reg,
                              gate_rules=default_gate_rules(
                                  max_loss_regression=0.05),
                              canary_fraction=None, watch_window_s=0.0),
            window_size=3, poll_timeout_s=0.3, registry=reg,
            workdir=str(tmp_path))
        publish_window(broker, "train", rng, 3, batch=32)
        assert pipe.run(max_windows=1)["promoted"] == 1
        good = net.params_to_vector()
        publish_window(broker, "train", rng, 3, batch=32, poisoned=True)
        pipe.run(max_windows=1)
        assert pipe.results[-1]["outcome"] == "rejected"
        now = tree_leaves(net.params) + tree_leaves(net.updater_state)
        assert all(a is b for a, b in zip(leaves, now))
        np.testing.assert_array_equal(net.params_to_vector(), good)
        split = pipe.results[0]["split_ms"]
        assert {"fit", "save", "zip_write", "load", "evaluate",
                "swap"} <= set(split)
    finally:
        engine.stop()


def test_a_fit_error_that_is_no_trainer_crash_fails_the_run(tmp_path):
    """Only a trainer crash (an injected fault, a lost step state, a
    transient error) is replayed: another error from ``fit`` (as a
    kernel that fails to launch would raise) propagates, it is not a
    dropped window."""
    reg = MetricsRegistry()
    engine = make_engine(registry=reg)
    try:
        rng = np.random.RandomState(13)
        broker = MessageBroker(registry=reg)
        net = small_net(seed=7)
        pipe = OnlineLearningPipeline(
            net, engine, topic="train", broker=broker,
            promotion=fast_pm(engine, task_batch(rng, 16), registry=reg),
            window_size=2, poll_timeout_s=0.3, registry=reg,
            workdir=str(tmp_path))

        def broken_fit(*a, **k):
            raise RuntimeError("kernel launch failed")

        net.fit = broken_fit
        publish_window(broker, "train", rng, 2)
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            pipe.run(max_windows=1)
        assert not pipe.results
    finally:
        engine.stop()


@pytest.mark.parametrize("stage", ["score", "output", "canary", "deploy"])
def test_a_port_candidates_error_fails_the_run(stage, monkeypatch):
    """A net of the port that fails while it is scored, canaried or
    deployed (as a kernel that does not build or launch would) fails the
    run: it is no rejected candidate.  Another model's failure stays a
    rejection (``test_canary_rejects_erroring_candidate``)."""
    reg = MetricsRegistry()
    engine = make_engine(registry=reg)
    try:
        rng = np.random.RandomState(17)
        pm = fast_pm(engine, task_batch(rng, 32), registry=reg)
        cand = small_net(seed=11)

        def boom(*a, **k):
            raise RuntimeError("kernel launch failed")

        if stage in ("score", "output"):
            setattr(cand, stage, boom)
        else:
            monkeypatch.setattr(
                engine, {"canary": "start_canary", "deploy": "deploy"}[stage],
                boom)
        v0 = engine.models.active("default").version
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            pm.consider(cand, "port-candidate")
        assert engine.models.active("default").version == v0
        assert reg.get_value("dl4j_promotions_total", model="default",
                             outcome="rejected") in (None, 0)
    finally:
        engine.stop()


def test_a_port_candidates_canary_error_fails_the_pipeline(tmp_path,
                                                           monkeypatch):
    """The same through ``OnlineLearningPipeline.run``: the window's
    candidate (loaded from its zip) fails to start its canary, and the
    run raises instead of recording a rejected window."""
    reg = MetricsRegistry()
    engine = make_engine(registry=reg)
    try:
        rng = np.random.RandomState(19)
        broker = MessageBroker(registry=reg)
        pipe = OnlineLearningPipeline(
            small_net(seed=7), engine, topic="train", broker=broker,
            promotion=fast_pm(engine, task_batch(rng, 16), registry=reg),
            window_size=2, poll_timeout_s=0.3, registry=reg,
            workdir=str(tmp_path))

        def boom(*a, **k):
            raise RuntimeError("kernel launch failed")

        monkeypatch.setattr(engine, "start_canary", boom)
        publish_window(broker, "train", rng, 2)
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            pipe.run(max_windows=1)
        assert not pipe.results
    finally:
        engine.stop()


def test_a_crash_after_a_rejected_window_replays_from_the_accepted_weights(
        tmp_path):
    """A window rejected (the trainer reverted), then a window whose
    trainer crashes: the replay restores the REVERTED state (the revert's
    checkpoint replaced the rejected window's of the same step) and ends
    bit for bit where an uncrashed twin from the same boundary ends."""
    reg = MetricsRegistry()
    engine = make_engine(registry=reg)
    try:
        rng = np.random.RandomState(12)
        broker = MessageBroker(registry=reg)
        net = small_net(seed=7, lr=1.0)
        pipe = OnlineLearningPipeline(
            net, engine, topic="train", broker=broker,
            checkpoint_manager=CheckpointManager(
                str(tmp_path / "ckpt"), keep=5, async_save=False,
                registry=reg),
            promotion=fast_pm(engine, task_batch(rng, 64), registry=reg,
                              gate_rules=default_gate_rules(
                                  max_loss_regression=0.05),
                              canary_fraction=None, watch_window_s=0.0),
            window_size=3, poll_timeout_s=0.3, registry=reg,
            retry_policy=RetryPolicy(max_retries=1, base_delay_s=0.01,
                                     component="online", registry=reg))
        publish_window(broker, "train", rng, 3, batch=32)
        publish_window(broker, "train", rng, 3, batch=32, poisoned=True)
        pipe.run(max_windows=2)
        assert [r["outcome"] for r in pipe.results] == ["promoted",
                                                        "rejected"]
        twin = net.clone()
        twin._keys.set_state(net._keys.get_state())
        window = [task_batch(rng, 32) for _ in range(3)]
        for ds in window:
            broker.publish("train", dataset_to_json(ds))
        inj = FaultInjector(seed=2).fail_at_step(
            net.iteration + 1, component="MultiLayerNetwork",
            transient=False)
        with inject_faults(inj):
            pipe.run(max_windows=1)
        assert reg.get_value("dl4j_online_windows_total",
                             status="retried") == 1
        twin.fit([(ds.features, ds.labels) for ds in window])
        for a, b in zip(tree_leaves(net.params), tree_leaves(twin.params)):
            assert torch.equal(a, b)
    finally:
        engine.stop()
