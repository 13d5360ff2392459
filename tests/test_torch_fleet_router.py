"""The port's serving fleet (``deeplearning4j_tpu_torch/fleet/``): the
oracles of the reference's ``tests/test_fleet_router.py`` —

- placement: the selftest, seeded tie-breaks, the shadow index's
  pricing, and one seeded simulation giving identical decisions in both
  packages;
- the in-process fleet on engines loaded from the committed
  ``transformer.zip``: prefix-affinity stickiness, ``fleet_route``
  spans, router metrics, drain, queued failover with the session
  re-pinned, no live replica, and the fleet rollout (canary, wave,
  commit; a forced watch regression rolls every replica back) — with the
  port's ids equal to the JAX fleet's for the same prompts;
- the publisher's retry hygiene;
- the subprocess fleet (supervisor-spawned replicas on ``--device cpu``):
  the request-id echo, the SIGKILL drill with the restart's rejoin, the
  mid-stream kill's clean terminal SSE event, the frontend's request
  ids — every completed request's ids those of one in-process port
  engine.

Each test runs under a time limit (``SIGALRM``)."""

import json
import logging
import signal
import threading
import time
import urllib.request
from pathlib import Path

import pytest

from deeplearning4j_tpu import fleet as jax_fleet
from deeplearning4j_tpu.fleet import placement as jax_placement
from deeplearning4j_tpu.generation.engine import (
    GenerationEngine as JaxGenerationEngine,
)
from deeplearning4j_tpu.models import serialization as jax_serialization
from deeplearning4j_tpu.models.zoo import transformer_char_lm as jax_lm
from deeplearning4j_tpu.observability.metrics import (
    MetricsRegistry as JaxMetricsRegistry,
)
from deeplearning4j_tpu_torch.fleet.placement import (
    AFFINITY, CANARY, LEAST_LOADED, PINNED, ReplicaView, ShadowIndex,
    choose, placement_selftest)
from deeplearning4j_tpu_torch.generation.engine import GenerationEngine
from deeplearning4j_tpu_torch.models import serialization
from deeplearning4j_tpu_torch.models.zoo import transformer_char_lm
from deeplearning4j_tpu_torch.observability.metrics import MetricsRegistry
from deeplearning4j_tpu_torch.observability.tracing import get_tracer

FIXTURE = (Path(__file__).resolve().parent / "regression_fixtures"
           / "transformer.zip")
ZIP_VOCAB = 7                   # the committed zip's vocabulary
PROMPT = [i % ZIP_VOCAB for i in range(8)]
TIME_LIMIT_S = 120
ENGINE = dict(slots=2, page_size=4, max_context=32, max_queue=16,
              prefill_buckets=(8,), prefix_cache=True)


@pytest.fixture(autouse=True)
def time_limit():
    """Fail a test that runs past ``TIME_LIMIT_S`` instead of hanging the
    run (the subprocess drills wait on other processes)."""
    def expired(signum, frame):
        raise TimeoutError(f"test ran past {TIME_LIMIT_S} s")

    old = signal.signal(signal.SIGALRM, expired)
    signal.alarm(TIME_LIMIT_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def zip_engine():
    return GenerationEngine(
        serialization.restore_multi_layer_network(FIXTURE, device="cpu"),
        **ENGINE).start()


def make_router(**kw):
    from deeplearning4j_tpu_torch.fleet import FleetRouter

    kw.setdefault("page_size", 4)
    kw.setdefault("registry", MetricsRegistry())
    kw.setdefault("refresh_interval_s", 0.0)
    return FleetRouter(**kw)


# ---------------------------------------------------------------- placement
def test_placement_selftest_passes():
    assert placement_selftest() == 0


def test_placement_deterministic_under_seeded_ties():
    def fresh_views():
        out = []
        for i in range(4):
            v = ReplicaView(f"r{i}", page_size=4, slots=4)
            v.healthy, v.free_pages = True, 64
            out.append(v)
        return out

    seq_a = [choose(fresh_views(), PROMPT, seed=11, n=n)[0]
             for n in range(32)]
    seq_b = [choose(fresh_views(), PROMPT, seed=11, n=n)[0]
             for n in range(32)]
    assert seq_a == seq_b
    seq_c = [choose(fresh_views(), PROMPT, seed=12, n=n)[0]
             for n in range(32)]
    assert seq_a != seq_c


def test_shadow_index_pricing_matches_admission():
    sh = ShadowIndex(page_size=4)
    sh.insert(list(range(10)))
    assert sh.matched_pages(list(range(10))) == 2
    assert sh.matched_pages(list(range(4))) == 1
    assert sh.matched_pages([9, 9, 9, 9]) == 0
    assert sh.observe_version("v2") is True
    assert sh.matched_pages(list(range(8))) == 0


def _simulate(mod, seed):
    """A seeded routing simulation: four replicas with uneven load, a
    stream of prompts sharing prefixes, a drained replica, a canary
    split and a session pin; each decision is placed into its replica's
    shadow index as the router does."""
    views = []
    for i in range(4):
        v = mod.ReplicaView(f"r{i}", page_size=4, slots=4)
        v.healthy, v.free_pages = True, 64
        v.active, v.queued = i % 3, i % 2
        views.append(v)
    views[3].draining = True
    prefixes = [[1, 2, 3, 4, 5, 6, 7, 8], [9, 9, 9, 9, 1, 1, 1, 1],
                [4, 3, 2, 1, 4, 3, 2, 1]]
    out = []
    for n in range(48):
        prompt = prefixes[n % 3] + [n % 5, n % 7]
        split = ("r1", 0.25, seed) if 16 <= n < 32 else None
        session = "r2" if n % 11 == 0 else None
        rid, reason, _scores = mod.choose(
            views, prompt, seed=seed, n=n, split=split,
            session_replica=session)
        next(v for v in views if v.replica_id == rid).shadow.insert(prompt)
        out.append((rid, reason))
    return out


@pytest.mark.parametrize("seed", [0, 7])
def test_seeded_simulation_gives_the_references_decisions(seed):
    ours = _simulate(__import__(
        "deeplearning4j_tpu_torch.fleet.placement", fromlist=["x"]), seed)
    assert ours == _simulate(jax_placement, seed)
    assert {r for r, _ in ours} >= {"r0", "r1", "r2"}


# ----------------------------------------------------------- in-process fleet
@pytest.fixture(scope="module")
def duo():
    """Two live in-process replicas, engines from the committed zip."""
    from deeplearning4j_tpu_torch.fleet import InProcessReplica

    e0, e1 = zip_engine(), zip_engine()
    router = make_router(seed=3)
    router.attach(InProcessReplica("r0", e0))
    router.attach(InProcessReplica("r1", e1))
    yield router, {"r0": e0, "r1": e1}
    for e in (e0, e1):
        e.stop(drain=False)


def test_affinity_keeps_session_on_one_replica(duo):
    router, _engines = duo
    prompt = [3] * 8
    first = router.submit(prompt, 3)
    first.result(timeout=30)
    assert first.finish_reason in ("length", "stop")
    again = router.submit(prompt, 3)
    again.result(timeout=30)
    assert again.replica_id == first.replica_id
    assert again.placements[0].reason == AFFINITY


def test_fleet_route_span_records_placement(duo):
    router, _engines = duo
    req = router.submit([5] * 8, 2)
    req.result(timeout=30)
    spans = [s for s in get_tracer().spans_for_trace(req.trace_id)
             if s.name == "fleet_route"]
    assert spans
    attrs = spans[-1].attrs
    assert attrs["replica"] == req.replica_id
    assert attrs["reason"] in (AFFINITY, LEAST_LOADED, PINNED, CANARY,
                               "repin", "random")
    assert set(attrs["candidates"]) == {"r0", "r1"}
    for s in attrs["candidates"].values():
        assert {"affinity_pages", "load", "free_pages"} <= set(s)


def test_router_metrics_and_replica_table(duo):
    router, _engines = duo
    router.submit([6] * 8, 2).result(timeout=30)
    rows = {r["replica"]: r for r in router.replicas()}
    assert set(rows) == {"r0", "r1"}
    assert all(r["live"] for r in rows.values())
    assert sum(c.value for _l, c in router._m_requests.samples()) >= 1


def test_admin_drain_excludes_replica(duo):
    router, _engines = duo
    router.drain("r0")
    try:
        for _ in range(4):
            req = router.submit([4] * 8, 2)
            req.result(timeout=30)
            assert req.replica_id == "r1"
    finally:
        router.drain("r0", False)


def _jax_fleet_ids(prompts, n_new):
    jnet = jax_serialization.restore_multi_layer_network(str(FIXTURE))
    engines = [JaxGenerationEngine(jnet, **ENGINE).start() for _ in range(2)]
    router = jax_fleet.FleetRouter(page_size=4, seed=3,
                                   registry=JaxMetricsRegistry(),
                                   refresh_interval_s=0.0)
    for i, e in enumerate(engines):
        router.attach(jax_fleet.InProcessReplica(f"r{i}", e))
    try:
        return [router.submit(p, n_new).result(timeout=60) for p in prompts]
    finally:
        for e in engines:
            e.stop(drain=False)


def test_ids_equal_the_jax_fleets(duo):
    """The same prompts through the port's fleet and the reference's, on
    the committed zip's weights: the same greedy ids."""
    router, _engines = duo
    prompts = [PROMPT, [2] * 8, [1, 2, 3], [6, 5, 4, 3, 2, 1, 0, 6]]
    ours = [router.submit(p, 6).result(timeout=60) for p in prompts]
    assert ours == _jax_fleet_ids(prompts, 6)


def test_queued_failover_zero_errors_and_session_repin():
    from deeplearning4j_tpu_torch.fleet import InProcessReplica

    e0, e1 = zip_engine(), zip_engine()
    router = make_router(seed=5, refresh_interval_s=30.0)
    router.attach(InProcessReplica("a", e0))
    router.attach(InProcessReplica("b", e1))
    try:
        prompt = [2] * 8
        pinned_on = router.pin_session("conv", prompt)
        victim = {"a": e0, "b": e1}[pinned_on]
        survivor_id = "b" if pinned_on == "a" else "a"
        victim.stop(drain=False)

        req = router.submit(prompt, 3, session_id="conv")
        toks = req.result(timeout=30)
        assert len(toks) == 3
        assert req.replica_id == survivor_id
        assert req.failovers >= 1
        assert router.session_replica("conv") == survivor_id
        assert sum(c.value for _l, c in router._m_failovers.samples()) >= 1
        again = router.submit(prompt, 2, session_id="conv")
        again.result(timeout=30)
        assert again.replica_id == survivor_id and again.failovers == 0
    finally:
        e0.stop(drain=False)
        e1.stop(drain=False)


def test_no_live_replica_is_terminal():
    from deeplearning4j_tpu_torch.fleet import (
        InProcessReplica, NoLiveReplicaError)

    e = zip_engine()
    router = make_router()
    router.attach(InProcessReplica("only", e))
    e.stop(drain=False)
    with pytest.raises(NoLiveReplicaError):
        router.submit(PROMPT, 2)


def test_fleet_rollout_promotes_and_forced_regression_rolls_back_all(
        tmp_path):
    """Canary, wave, commit on three replicas: every replica serves the
    candidate, whose ids equal the reference engine's on the same
    weights; a forced watch regression then rolls every replica back to
    the promoted version, whose ids it serves again."""
    from deeplearning4j_tpu_torch.fleet import FleetRollout, InProcessReplica

    cand_zip = tmp_path / "candidate.zip"
    jax_serialization.write_model(
        jax_lm(vocab_size=ZIP_VOCAB, d_model=8, n_heads=2, layers=1,
               seed=777), str(cand_zip))
    bad_zip = tmp_path / "bad.zip"
    jax_serialization.write_model(
        jax_lm(vocab_size=ZIP_VOCAB, d_model=8, n_heads=2, layers=1,
               seed=778), str(bad_zip))

    engines = {f"r{i}": zip_engine() for i in range(3)}
    router = make_router(seed=9)
    handles = {rid: InProcessReplica(rid, e) for rid, e in engines.items()}
    for h in handles.values():
        router.attach(h)
    stop_load = threading.Event()

    def load():
        while not stop_load.is_set():
            try:
                router.submit([1] * 8, 2).result(timeout=30)
            except Exception:
                time.sleep(0.05)

    t = threading.Thread(target=load, daemon=True)
    t.start()
    try:
        before = {rid: e.models.active("default").version
                  for rid, e in engines.items()}
        good = serialization.restore_multi_layer_network(cand_zip,
                                                         device="cpu")
        ro = FleetRollout(router, handles, canary_fraction=0.5,
                          canary_min_requests=2, canary_timeout_s=60,
                          watch_window_s=0.3, watch_poll_s=0.05,
                          registry=router.registry)
        res = ro.consider(good, "good")
        assert res.outcome == "promoted"
        assert sorted(res.committed) == sorted(engines)
        after = {rid: e.models.active("default").version
                 for rid, e in engines.items()}
        assert all(after[r] > before[r] for r in engines)
        jeng = JaxGenerationEngine(
            jax_serialization.restore_multi_layer_network(str(cand_zip)),
            **ENGINE).start()
        try:
            want = jeng.submit(PROMPT, 6).result(timeout=60)
        finally:
            jeng.stop(drain=False)
        for e in engines.values():
            assert e.submit(PROMPT, 6).result(timeout=60) == want

        bad = serialization.restore_multi_layer_network(bad_zip,
                                                        device="cpu")
        ro2 = FleetRollout(router, handles, canary_fraction=0.5,
                           canary_min_requests=2, canary_timeout_s=60,
                           watch_window_s=0.3, watch_poll_s=0.05,
                           registry=router.registry,
                           watch_extra_fn=lambda rid: {
                               "probe_ok": False,
                               "probe_detail": "forced regression"})
        res2 = ro2.consider(bad, "bad")
        assert res2.outcome == "rolled_back"
        assert {rid: e.models.active("default").version
                for rid, e in engines.items()} == after
        for e in engines.values():
            assert e.submit(PROMPT, 6).result(timeout=60) == want
        outcomes = {l[0][1]: c.value for l, c in ro2._m_outcomes.samples()}
        assert outcomes.get("rolled_back", 0) >= 1
    finally:
        stop_load.set()
        t.join(timeout=5)
        for e in engines.values():
            e.stop(drain=False)


def test_fleet_rollout_rejects_http_replicas():
    from deeplearning4j_tpu_torch.fleet import FleetRollout, HTTPReplica

    with pytest.raises(ValueError):
        FleetRollout(object(), {"w": HTTPReplica("w", "http://x")})


# ------------------------------------------------------- publisher retry loop
class _FlakyBroker:
    def __init__(self, fail_times, exc=ConnectionError("broker down")):
        self.fail_times = fail_times
        self.exc = exc
        self.calls = 0
        self.delivered = []

    def publish(self, topic, payload):
        self.calls += 1
        if self.calls <= self.fail_times:
            raise self.exc
        self.delivered.append(topic)
        return 1


def test_publisher_transient_outage_backs_off_and_resumes():
    from deeplearning4j_tpu_torch.observability.fleet import (
        TelemetryPublisher,
    )

    broker = _FlakyBroker(fail_times=2)
    pub = TelemetryPublisher("w", broker=broker, interval_s=0.05,
                             registry=MetricsRegistry())
    pub.retry_policy.base_delay_s = 0.01
    pub.start()
    try:
        deadline = time.monotonic() + 10
        while not broker.delivered and time.monotonic() < deadline:
            time.sleep(0.02)
    finally:
        pub.stop()
    assert broker.delivered
    assert broker.calls >= 3
    assert pub.retry_policy.retries >= 2


def test_publisher_fatal_error_surfaces(caplog):
    from deeplearning4j_tpu_torch.observability.fleet import (
        TelemetryPublisher,
    )

    broker = _FlakyBroker(fail_times=10**9, exc=ValueError("bad payload"))
    pub = TelemetryPublisher("w", broker=broker, interval_s=0.05,
                             registry=MetricsRegistry())
    with caplog.at_level(logging.WARNING,
                         logger="deeplearning4j_tpu_torch.observability"):
        pub.start()
        deadline = time.monotonic() + 10
        while not any("telemetry publish failed after retries" in r.message
                      for r in caplog.records) \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        pub.stop()
    assert any("telemetry publish failed after retries" in r.message
               for r in caplog.records)
    assert broker.calls >= 1
    assert pub.retry_policy.retries == 0


def test_publisher_publish_once_keeps_swallow_semantics():
    from deeplearning4j_tpu_torch.observability.fleet import (
        TelemetryPublisher,
    )

    broker = _FlakyBroker(fail_times=10**9)
    pub = TelemetryPublisher("w", broker=broker, registry=MetricsRegistry())
    assert pub.publish_once() == -1


# ----------------------------------------------------------- subprocess fleet
SUB_VOCAB = 40
SUB_MODEL = dict(vocab_size=SUB_VOCAB, d_model=32, n_heads=2, layers=1,
                 max_cache=32, seed=12345)
SUB_ENGINE = dict(slots=4, page_size=4, max_context=32,
                  prefill_buckets=(8,), prefix_cache=True)


@pytest.fixture(scope="module")
def single_engine():
    """One in-process port engine on the replicas' weights: the ids every
    completed fleet request must give."""
    eng = GenerationEngine(transformer_char_lm(**SUB_MODEL, device="cpu"),
                           **SUB_ENGINE).start()
    yield eng
    eng.stop(drain=False)


def _single_ids(eng, prompt, n):
    return eng.submit(list(prompt), n).result(timeout=60)


@pytest.fixture(scope="module")
def subprocess_fleet():
    """Two supervisor-spawned replicas on ``--device cpu`` + broker +
    aggregator + router.  Every test leaves both replicas serving."""
    from deeplearning4j_tpu_torch.fleet import ReplicaSupervisor
    from deeplearning4j_tpu_torch.observability.fleet import FleetAggregator
    from deeplearning4j_tpu_torch.streaming.pubsub import MessageBroker

    broker = MessageBroker()
    burl = f"http://127.0.0.1:{broker.serve(port=0)}"
    agg = FleetAggregator(url=burl, expire_after_s=3.0,
                          registry=MetricsRegistry()).start()
    sup = ReplicaSupervisor(
        broker_url=burl, warmup_timeout_s=180, registry=MetricsRegistry(),
        replica_args={"slots": 4, "page_size": 4, "max_context": 32,
                      "prefill_buckets": "8", "d_model": 32,
                      "n_heads": 2, "layers": 1, "vocab": SUB_VOCAB,
                      "model_seed": 12345, "interval_s": 0.25,
                      "device": "cpu",
                      # paced decode: a per-token window wide enough for
                      # the mid-stream kill to land mid-stream
                      "step_floor_ms": 25}).start()
    try:
        sup.start_replica("w0")
        sup.start_replica("w1")
        router = make_router(aggregator=agg, seed=7, refresh_interval_s=0.1)
        for h in sup.handles(timeout=60).values():
            router.attach(h)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            if sum(r["live"] for r in router.replicas()) == 2:
                break
            time.sleep(0.1)
        assert sum(r["live"] for r in router.replicas()) == 2
        yield router, sup, agg
    finally:
        sup.stop_all()
        agg.stop()
        broker.stop()


def _wait_live(router, wid, timeout=90):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        rows = {r["replica"]: r for r in router.replicas()}
        if rows.get(wid, {}).get("live"):
            return True
        time.sleep(0.2)
    return False


def test_http_replica_envelope_echoes_replica_id(subprocess_fleet,
                                                 single_engine):
    _router, sup, _agg = subprocess_fleet
    rp = sup.processes()["w0"]
    prompt = list(range(8))
    body = json.dumps({"prompt": prompt, "max_tokens": 4}).encode()
    req = urllib.request.Request(
        f"{rp.url}/generate", data=body,
        headers={"Content-Type": "application/json",
                 "X-Request-Id": "cafe0123deadbeef"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        env = json.loads(resp.read().decode())
    assert env["replica"] == "w0"
    assert env["trace_id"] == "cafe0123deadbeef"
    assert env["tokens"] == _single_ids(single_engine, prompt, 4)


def test_sigkill_failover_and_restart_rejoin(subprocess_fleet,
                                             single_engine):
    """SIGKILL the replica a session is pinned on: queued requests are
    retried on the survivor with zero client-visible errors and the
    single engine's ids, the session re-pins there, and the supervisor's
    restart rejoins under a fresh publisher epoch."""
    router, sup, agg = subprocess_fleet
    prompt = [9] * 8
    want = _single_ids(single_engine, prompt, 2)
    pinned_on = router.pin_session("talk", prompt)
    survivor = "w1" if pinned_on == "w0" else "w0"
    epoch = {r["worker"]: r["epoch"] for r in agg.workers()}[pinned_on]

    sup.kill(pinned_on, sig=signal.SIGKILL, restart=True)
    results, errors = [], []
    for _ in range(6):
        try:
            r = router.submit(prompt, 2, session_id="talk")
            results.append(r.result(timeout=60))
        except Exception as e:      # noqa: BLE001 - recording, not hiding
            errors.append(e)
    assert not errors, f"queued requests must not error: {errors!r}"
    assert results == [want] * 6
    assert router.session_replica("talk") == survivor
    assert sum(c.value for _l, c in router._m_failovers.samples()) >= 1

    assert _wait_live(router, pinned_on), "restarted replica must rejoin"
    assert sup.processes()[pinned_on].restarts >= 1
    assert sum(c.value for _l, c in sup._m_restarts.samples()) >= 1
    rows = {r["worker"]: r for r in agg.workers()}
    assert rows[pinned_on]["epoch"] != epoch and not rows[pinned_on]["stale"]


def test_mid_stream_kill_clean_terminal_sse_event(subprocess_fleet,
                                                  single_engine):
    """A replica killed MID-STREAM cannot be failed over: the frontend
    ends the stream with a clean terminal SSE error event, and the
    tokens that did arrive are a prefix of the single engine's."""
    from deeplearning4j_tpu_torch.fleet import FleetFrontend

    router, sup, _agg = subprocess_fleet
    front = FleetFrontend(router, access_log=True)
    fport = front.start()
    prompt = [4] * 8
    try:
        body = json.dumps({"prompt": prompt, "max_tokens": 20,
                           "stream": True}).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{fport}/generate", data=body,
            headers={"Content-Type": "application/json"})
        resp = urllib.request.urlopen(req, timeout=60)
        events, killed = [], None
        while True:
            line = resp.readline()
            if not line:
                break
            line = line.strip()
            if not line.startswith(b"data: "):
                continue
            ev = json.loads(line[len(b"data: "):].decode())
            events.append(ev)
            if killed is None and "token" in ev:
                killed = next(r["replica"] for r in router.replicas()
                              if r["inflight"] > 0)
                sup.kill(killed, sig=signal.SIGKILL, restart=True)
            if ev.get("done"):
                break
        assert killed is not None
        terminal = events[-1]
        assert terminal.get("done") is True
        assert "error" in terminal, f"want terminal error event: {terminal}"
        got = [e["token"] for e in events if "token" in e]
        assert got and got == _single_ids(single_engine, prompt,
                                          20)[:len(got)]
        assert _wait_live(router, killed)
    finally:
        front.stop()


def test_frontend_mints_and_propagates_request_id(subprocess_fleet,
                                                  single_engine):
    from deeplearning4j_tpu_torch.fleet import FleetFrontend

    router, _sup, _agg = subprocess_fleet
    front = FleetFrontend(router)
    fport = front.start()
    prompt = [6] * 8
    try:
        body = json.dumps({"prompt": prompt, "max_tokens": 2}).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{fport}/generate", data=body,
            headers={"Content-Type": "application/json",
                     "X-Request-Id": "feedface00000001"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            env = json.loads(resp.read().decode())
        assert env["trace_id"] == "feedface00000001"
        assert env["replica"] in ("w0", "w1")
        assert env["placement_reason"] in (AFFINITY, LEAST_LOADED,
                                           PINNED, "repin")
        assert env["tokens"] == _single_ids(single_engine, prompt, 2)
        spans = [s for s in get_tracer().spans_for_trace(
            "feedface00000001") if s.name == "fleet_route"]
        assert spans and spans[-1].attrs["replica"] == env["replica"]
        req2 = urllib.request.Request(
            f"http://127.0.0.1:{fport}/generate", data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req2, timeout=60) as resp:
            env2 = json.loads(resp.read().decode())
        assert len(env2["trace_id"]) == 16
    finally:
        front.stop()
