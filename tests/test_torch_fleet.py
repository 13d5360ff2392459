"""The port's fleet telemetry plane (``observability/fleet.py``): the
oracles of the reference's ``tests/test_fleet.py`` that
``test_torch_observability.py`` does not already hold — snapshot schema
and bounds, the epoch/seq delta merge, staleness, the broker and HTTP
federation, forward compatibility, decode SLO attribution on the port's
engine, the access log, and the prefix-cache stats through
``GenerationEngine.fleet_publisher`` across a hot swap — and across the
two packages: each package's aggregator ingests the other's snapshots
and gives the same ``/fleet`` table and the same federated exposition."""

import json
import logging
import time
import urllib.request

import numpy as np
import pytest

import http.client

from deeplearning4j_tpu.observability import fleet as jax_fleet
from deeplearning4j_tpu.observability import metrics as jax_metrics
from deeplearning4j_tpu_torch.generation import GenerationEngine
from deeplearning4j_tpu_torch.models.zoo import transformer_char_lm
from deeplearning4j_tpu_torch.observability.fleet import (
    SCHEMA_VERSION, FleetAggregator, SLOTracker, TelemetryPublisher,
    schema_roundtrip_selftest,
)
from deeplearning4j_tpu_torch.observability.metrics import MetricsRegistry
from deeplearning4j_tpu_torch.streaming import MessageBroker

VOCAB = 29


def small_lm(seed=12345):
    return transformer_char_lm(vocab_size=VOCAB, d_model=32, n_heads=4,
                               layers=2, max_cache=128, seed=seed,
                               device="cpu")


@pytest.fixture(scope="module")
def engine():
    eng = GenerationEngine(small_lm(), slots=4, page_size=4,
                           max_context=32, max_queue=64, deadline_s=30.0,
                           prefix_cache=True)
    eng.start()
    yield eng
    eng.stop()


def wait_for(cond, timeout=10.0, poll=0.02):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if cond():
            return True
        time.sleep(poll)
    return False


def worker_registry(metrics_mod=None):
    """A publisher-side registry with one family of each kind."""
    reg = (metrics_mod.MetricsRegistry() if metrics_mod is not None
           else MetricsRegistry())
    c = reg.counter("dl4j_test_work_total", "Work items processed",
                    labels=("kind",))
    g = reg.gauge("dl4j_test_depth", "Queue depth right now")
    h = reg.histogram("dl4j_test_lat_seconds", "Observed latencies",
                      buckets=(0.01, 0.1, 1.0))
    return reg, c, g, h


def fleet_value(agg, name, worker):
    """Merged value for one worker's unlabeled-or-first sample of a
    family in the rebuilt fleet registry (None = absent)."""
    for fam in agg.registry().families():
        if fam.name != name:
            continue
        total, seen = 0.0, False
        for label_pairs, child in fam.samples():
            labels = dict(label_pairs)
            if labels.get("worker", labels.get("origin")) == worker:
                seen = True
                total += (child.snapshot()["count"]
                          if fam.kind == "histogram" else child.value)
        return total if seen else None
    return None


def wire(worker="w1", epoch="e1", seq=1, families=None, **extra):
    snap = {"schema": SCHEMA_VERSION, "worker": worker, "epoch": epoch,
            "seq": seq, "ts": time.time(), "families": families or {}}
    snap.update(extra)
    return json.dumps(snap)


def counter_fam(value):
    return {"kind": "counter", "help": "h", "label_names": [],
            "samples": [{"labels": {}, "value": value}]}


# ------------------------------------------------------------ SLO tracker
def test_slo_tracker_goodput_window_slides():
    t = SLOTracker(ttft_target_s=1.0, itl_target_s=1.0,
                   goodput_window_s=10.0, registry=MetricsRegistry())
    for i in range(4):
        t.observe_request(ttft_s=0.1, now=100.0 + i)
    assert t.goodput_rps(now=104.0) == pytest.approx(4 / 10.0)
    # two of the four age out of the window
    assert t.goodput_rps(now=111.5) == pytest.approx(2 / 10.0)
    # all gone
    assert t.goodput_rps(now=1000.0) == 0.0


# ------------------------------------------------- snapshot schema + wire
def test_snapshot_schema_and_bounds():
    reg, c, g, h = worker_registry()
    c.inc(3, kind="a")
    g.set(7.5)
    h.observe(0.05)
    pub = TelemetryPublisher(
        "w1", registry=reg,
        state_fn=lambda: {"scheduler": {"queued": 2}},
        prefix_cache=lambda: {"version": "default@v1", "hits": 4})
    snap = pub.snapshot()
    assert snap["schema"] == SCHEMA_VERSION
    assert snap["worker"] == "w1" and snap["seq"] == 1
    assert snap["epoch"] and snap["ts"] > 0
    fams = snap["families"]
    assert fams["dl4j_test_work_total"]["kind"] == "counter"
    assert fams["dl4j_test_work_total"]["samples"][0] == {
        "labels": {"kind": "a"}, "value": 3.0}
    assert fams["dl4j_test_depth"]["samples"][0]["value"] == 7.5
    hist = fams["dl4j_test_lat_seconds"]
    assert hist["buckets"] == [0.01, 0.1, 1.0]
    assert hist["samples"][0]["count"] == 1
    assert snap["state"] == {"scheduler": {"queued": 2}}
    assert snap["prefix_cache"]["version"] == "default@v1"
    # seq advances per snapshot within one epoch
    assert pub.snapshot()["seq"] == 2


def test_snapshot_nan_gauge_serializes_to_null():
    reg = MetricsRegistry()
    reg.gauge("dl4j_test_depth", "Queue depth right now").set(float("nan"))
    pub = TelemetryPublisher("w1", registry=reg)
    payload = pub.serialize()   # allow_nan=False: must not raise
    fams = json.loads(payload)["families"]
    assert fams["dl4j_test_depth"]["samples"][0]["value"] is None


def test_snapshot_bounds_sample_explosion():
    reg = MetricsRegistry()
    c = reg.counter("dl4j_test_work_total", "Work items processed",
                    labels=("kind",))
    for i in range(40):
        c.inc(kind=f"k{i:03d}")
    pub = TelemetryPublisher("w1", registry=reg,
                             max_samples_per_family=16)
    snap = pub.snapshot()
    assert len(snap["families"]["dl4j_test_work_total"]["samples"]) == 16
    assert snap["truncated_samples"] == 24


def test_schema_roundtrip_selftest_green():
    assert schema_roundtrip_selftest() == 0


# ------------------------------------------------------ delta/epoch merge
def test_counter_delta_merge_ignores_replays():
    agg = FleetAggregator(registry=MetricsRegistry())
    assert agg.ingest(wire(seq=1, families={
        "dl4j_test_work_total": counter_fam(10)}))
    assert agg.ingest(wire(seq=2, families={
        "dl4j_test_work_total": counter_fam(25)}))
    assert fleet_value(agg, "dl4j_test_work_total", "w1") == 25.0
    # replay of seq 2 and an out-of-order seq 1 both drop
    assert not agg.ingest(wire(seq=2, families={
        "dl4j_test_work_total": counter_fam(25)}))
    assert not agg.ingest(wire(seq=1, families={
        "dl4j_test_work_total": counter_fam(10)}))
    assert fleet_value(agg, "dl4j_test_work_total", "w1") == 25.0
    assert agg.fleet_table()["merge_skips"].get("replay") == 2


def test_epoch_restart_resumes_without_double_count():
    agg = FleetAggregator(registry=MetricsRegistry())
    agg.ingest(wire(epoch="e1", seq=1, families={
        "dl4j_test_work_total": counter_fam(10)}))
    agg.ingest(wire(epoch="e1", seq=2, families={
        "dl4j_test_work_total": counter_fam(25)}))
    # restart: new epoch re-counts from a fresh base (5), history stays
    agg.ingest(wire(epoch="e2", seq=1, families={
        "dl4j_test_work_total": counter_fam(5)}))
    assert fleet_value(agg, "dl4j_test_work_total", "w1") == 30.0
    # and the new epoch keeps delta-merging
    agg.ingest(wire(epoch="e2", seq=2, families={
        "dl4j_test_work_total": counter_fam(9)}))
    assert fleet_value(agg, "dl4j_test_work_total", "w1") == 34.0


def test_histogram_delta_merge_across_snapshots():
    agg = FleetAggregator(registry=MetricsRegistry())

    def hist_fam(count, total, counts):
        return {"kind": "histogram", "help": "h", "label_names": [],
                "buckets": [0.1, 1.0],
                "samples": [{"labels": {}, "count": count, "sum": total,
                             "min": 0.01, "max": 0.5,
                             "bucket_counts": counts}]}

    agg.ingest(wire(seq=1, families={
        "dl4j_test_lat_seconds": hist_fam(5, 0.5, [2, 3])}))
    agg.ingest(wire(seq=2, families={
        "dl4j_test_lat_seconds": hist_fam(8, 0.9, [3, 5])}))
    assert fleet_value(agg, "dl4j_test_lat_seconds", "w1") == 8


# ----------------------------------------------------------- staleness
def test_stale_worker_drops_gauges_keeps_counters_and_is_named():
    agg = FleetAggregator(expire_after_s=0.2, registry=MetricsRegistry())
    agg.ingest(wire(families={
        "dl4j_test_work_total": counter_fam(12),
        "dl4j_test_depth": {"kind": "gauge", "help": "h",
                            "label_names": [],
                            "samples": [{"labels": {}, "value": 4.0}]},
    }))
    assert fleet_value(agg, "dl4j_test_depth", "w1") == 4.0
    assert agg.workers()[0]["stale"] is False
    assert agg.evaluate_health().healthy
    time.sleep(0.35)
    # flipped stale: gauges vanish from the fleet view, counters survive
    assert agg.workers()[0]["stale"] is True
    assert fleet_value(agg, "dl4j_test_depth", "w1") is None
    assert fleet_value(agg, "dl4j_test_work_total", "w1") == 12.0
    verdict = agg.evaluate_health()
    assert not verdict.healthy
    assert any("w1" in str(r) for r in verdict.results if not r["ok"])
    # the fleet meta gauges agree
    text = agg.registry().to_prometheus()
    assert "dl4j_fleet_stale_workers 1" in text
    assert "dl4j_fleet_workers 0" in text


# ---------------------------------------------------- federation transport
def test_two_publishers_one_aggregator_over_broker():
    broker = MessageBroker()
    agg = FleetAggregator(broker=broker, topic="t.fleet",
                          registry=MetricsRegistry()).start()
    try:
        regs = []
        for i, wid in enumerate(("w1", "w2")):
            reg, c, g, _h = worker_registry()
            c.inc(10 * (i + 1), kind="x")
            g.set(float(i))
            regs.append(TelemetryPublisher(wid, broker=broker,
                                           topic="t.fleet", registry=reg))
        for pub in regs:
            assert pub.publish_once() == 1   # one subscriber: the agg
        assert wait_for(lambda: len(agg.workers()) == 2)
        table = agg.fleet_table()
        assert [w["worker"] for w in table["workers"]] == ["w1", "w2"]
        assert fleet_value(agg, "dl4j_test_work_total", "w1") == 10.0
        assert fleet_value(agg, "dl4j_test_work_total", "w2") == 20.0
        text = agg.registry().to_prometheus()
        assert 'worker="w1"' in text and 'worker="w2"' in text
        assert "dl4j_fleet_workers 2" in text
    finally:
        agg.stop()


def test_http_federation_and_fleet_endpoints():
    broker = MessageBroker()
    bport = broker.serve(port=0)
    url = f"http://127.0.0.1:{bport}"
    agg = FleetAggregator(url=url, topic="t.http",
                          registry=MetricsRegistry()).start()
    try:
        time.sleep(0.3)   # first long-poll registers the subscription
        reg, c, _g, _h = worker_registry()
        c.inc(6, kind="x")
        pub = TelemetryPublisher("w1", url=url, topic="t.http",
                                 registry=reg)
        assert wait_for(lambda: pub.publish_once() >= 1 and
                        len(agg.workers()) == 1)
        fport = agg.serve(port=0)
        with urllib.request.urlopen(
                f"http://127.0.0.1:{fport}/metrics") as resp:
            text = resp.read().decode()
        assert 'dl4j_test_work_total{kind="x",worker="w1"} 6' in text
        assert "dl4j_fleet_workers 1" in text
        with urllib.request.urlopen(
                f"http://127.0.0.1:{fport}/fleet") as resp:
            table = json.loads(resp.read())
        assert table["workers"][0]["worker"] == "w1"
        with urllib.request.urlopen(
                f"http://127.0.0.1:{fport}/health") as resp:
            assert json.loads(resp.read())["healthy"] is True
    finally:
        agg.stop()
        broker.stop()


# ------------------------------------------------- forward compatibility
def test_ingest_never_raises_on_garbage():
    agg = FleetAggregator(registry=MetricsRegistry())
    assert not agg.ingest("{not json")
    assert not agg.ingest(json.dumps([1, 2, 3]))
    assert not agg.ingest(wire(schema=99))          # foreign schema
    assert not agg.ingest(json.dumps({"schema": SCHEMA_VERSION}))  # no id
    # a missing/non-numeric seq is dropped, NOT defaulted to 0 (which
    # would pin the worker and replay-drop all its later snapshots)
    snap = json.loads(wire())
    del snap["seq"]
    assert not agg.ingest(json.dumps(snap))
    assert not agg.ingest(wire(seq="soon"))
    # malformed family fragments are skipped, the snapshot still lands —
    # including fragments that RAISE mid-merge (non-iterable
    # label_names), which must not wedge the aggregator's lock
    assert agg.ingest(wire(seq=1, families={
        "dl4j_bad": "not-a-dict",
        "dl4j_weird": {"kind": "thermometer", "samples": []},
        "dl4j_explodes": {"kind": "gauge", "label_names": 5,
                          "samples": [{"labels": {}, "value": 1.0}]},
        "dl4j_test_work_total": counter_fam(3),
    }, some_future_field={"ok": True}))
    assert fleet_value(agg, "dl4j_test_work_total", "w1") == 3.0
    # the lock was released cleanly: later snapshots keep merging
    assert agg.ingest(wire(seq=2, families={
        "dl4j_test_work_total": counter_fam(7)}))
    assert fleet_value(agg, "dl4j_test_work_total", "w1") == 7.0
    skips = agg.fleet_table()["merge_skips"]
    assert skips.get("parse") == 2
    assert skips.get("schema") == 1
    assert skips.get("fields") == 3
    assert skips.get("family") == 1


def test_vanished_gauge_labelset_drops_from_fleet_view():
    """A gauge label-set absent from the next snapshot (truncated away,
    or simply gone) must leave the fleet view, not stay frozen."""
    agg = FleetAggregator(registry=MetricsRegistry())

    def depth_fam(samples):
        return {"kind": "gauge", "help": "h", "label_names": ["q"],
                "samples": samples}

    agg.ingest(wire(seq=1, families={"dl4j_test_depth": depth_fam(
        [{"labels": {"q": "a"}, "value": 4.0},
         {"labels": {"q": "b"}, "value": 9.0}])}))
    assert fleet_value(agg, "dl4j_test_depth", "w1") == 13.0
    agg.ingest(wire(seq=2, families={"dl4j_test_depth": depth_fam(
        [{"labels": {"q": "a"}, "value": 5.0}])}))
    assert fleet_value(agg, "dl4j_test_depth", "w1") == 5.0
    text = agg.registry().to_prometheus()
    assert 'q="b"' not in text
    # an empty sample list clears the family outright
    agg.ingest(wire(seq=3, families={"dl4j_test_depth": depth_fam([])}))
    assert fleet_value(agg, "dl4j_test_depth", "w1") is None


# ------------------------------------------- decode SLO attribution (e2e)
def test_engine_decode_slo_attribution(engine):
    rs = np.random.RandomState(7)
    for _ in range(4):
        h = engine.submit(rs.randint(0, VOCAB, 6).tolist(), 8)
        assert len(h.result(timeout=60)) == 8
        assert h.slo_ok is not None        # settled by the SLO tracker
    st = engine.stats()
    slo = st["slo"]
    assert slo["finished"] >= 4
    assert slo["good_attainment"] is not None
    assert slo["goodput_rps"] >= 0.0
    # every decode-loop phase fired, and the breakdown reconciles with
    # the loop's busy wall (phases nest inside it, so sum <= busy + eps)
    phases = st["phases"]["phases"]
    for name in ("schedule", "page_gather", "jitted_step",
                 "sample_harvest", "stream_write"):
        assert phases[name]["count"] > 0, name
    phase_ms = sum(p["total_ms"] for p in phases.values())
    assert phase_ms <= st["busy_wall_s"] * 1e3 * 1.1 + 5.0
    assert phase_ms > 0
    # the ITL histogram populated under real decode
    itl = sum(child.snapshot()["count"] for _l, child
              in engine.metrics.inter_token.samples())
    assert itl > 0


def test_generate_access_log_carries_slo_fields(caplog):
    from deeplearning4j_tpu_torch.models.sequential import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.streaming.serving import InferenceServer

    conf = (NeuralNetConfiguration.builder().seed(1)
            .updater("sgd", learning_rate=0.1).list()
            .layer(DenseLayer(n_in=4, n_out=8, activation="relu"))
            .layer(OutputLayer(n_in=8, n_out=3, loss="mcxent",
                               activation="softmax")).build())
    pred = MultiLayerNetwork(conf).init(device="cpu")
    gen = GenerationEngine(small_lm(), slots=2, page_size=4,
                           max_context=16, max_queue=8,
                           prefill_buckets=(8,)).start()
    srv = InferenceServer(pred, generation=gen, access_log=True)
    port = srv.start()
    try:
        with caplog.at_level(logging.INFO,
                             logger="deeplearning4j_tpu_torch.serving.access"):
            c = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
            c.request("POST", "/generate", json.dumps(
                {"prompt": [1, 2, 3], "max_tokens": 5}),
                {"X-Request-Id": "slo-trace-1"})
            r = c.getresponse()
            assert r.status == 200
            r.read()
        lines = [json.loads(rec.message) for rec in caplog.records
                 if rec.name == "deeplearning4j_tpu_torch.serving.access"]
        line = next(l for l in lines if l["trace_id"] == "slo-trace-1")
        assert line["tokens"] == 5
        assert line["slo_ok"] in (True, False)
        # 5 tokens -> 4 inter-token gaps -> a real p50
        assert line["itl_p50_ms"] is not None and line["itl_p50_ms"] >= 0
    finally:
        srv.stop()
        gen.stop()


# ------------------------------- router-facing cache stats + hot swap
def test_prefix_stats_federate_and_hotswap_is_visible(engine):
    broker = MessageBroker()
    agg = FleetAggregator(broker=broker, topic="t.swap",
                          registry=MetricsRegistry()).start()
    pub = engine.fleet_publisher("w-eng", broker=broker, topic="t.swap")
    try:
        engine.submit([1, 2, 3, 4, 5, 6], 4).result(timeout=60)
        assert pub.publish_once() == 1
        assert wait_for(lambda: len(agg.workers()) == 1)
        row = agg.workers()[0]
        # the router-facing surface, exactly as the worker published it
        pc = row["prefix_cache"]
        for key in ("version", "resident_pages", "pinned_pages",
                    "host_tier_bytes", "hit_rate"):
            assert key in pc, key
        v1 = pc["version"]
        assert row["slo"]["finished"] >= 1
        assert row["state"]["scheduler"]
        # hot swap: the tree version tag must change THROUGH the
        # aggregator within one publish interval (the decode loop stamps
        # the tree on its next idle tick, then the publish carries it)
        engine.deploy("default", small_lm(seed=777))
        assert wait_for(lambda: engine.prefix_cache.version != v1)
        assert pub.publish_once() == 1
        assert wait_for(lambda: len(agg.workers()) == 1 and
                        agg.workers()[0]["prefix_cache"]["version"] != v1)
        assert agg.workers()[0]["prefix_cache"]["version"] != v1
    finally:
        agg.stop()


# ------------------------------------------------ across the two packages
def _drive(reg_c, reg_g, reg_h, scale):
    reg_c.inc(3 * scale, kind="a")
    reg_c.inc(scale, kind="b")
    reg_g.set(2.5 * scale)
    for v in (0.005, 0.05 * scale, 0.5):
        reg_h.observe(v)


def _row(row):
    """A ``/fleet`` row without what moves with the wall clock or the
    publisher's random epoch."""
    return {k: v for k, v in row.items() if k not in ("age_s", "epoch")}


def test_each_aggregator_ingests_the_other_packages_snapshots():
    """The port's publisher and the reference's publish the same
    families; each package's aggregator ingests both workers' snapshots,
    and the two give the same ``/fleet`` table and the same federated
    exposition (the fleet's own meta families, which carry ages, set
    apart)."""
    pubs = []
    for wid, mod, pub_cls, scale in (
            ("port", None, TelemetryPublisher, 1),
            ("ref", jax_metrics, jax_fleet.TelemetryPublisher, 2)):
        reg, c, g, h = worker_registry(mod)
        _drive(c, g, h, scale)
        pubs.append(pub_cls(
            wid, registry=reg, state_fn=lambda: {"scheduler": {"queued": 1}},
            prefix_cache=lambda: {"version": "default@v1", "hits": 2}))
    aggs = [FleetAggregator(expire_after_s=3600.0,
                            registry=MetricsRegistry()),
            jax_fleet.FleetAggregator(expire_after_s=3600.0,
                                      registry=jax_metrics.MetricsRegistry())]
    for _ in range(2):          # two rounds: the delta merge too
        wires = [p.serialize() for p in pubs]
        for agg in aggs:
            for w in wires:
                assert agg.ingest(w)
    tables = [[_row(r) for r in agg.fleet_table()["workers"]]
              for agg in aggs]
    assert tables[0] == tables[1]
    assert [r["worker"] for r in tables[0]] == ["port", "ref"]
    texts = [jax_fleet._data_lines(agg.registry()) for agg in aggs]
    assert texts[0] == texts[1]
    assert 'dl4j_test_work_total{kind="a",worker="port"} 3' in texts[0]
    assert 'dl4j_test_work_total{kind="a",worker="ref"} 6' in texts[0]
    assert 'dl4j_test_lat_seconds_count{worker="ref"} 3' in texts[0]


def test_the_reference_aggregator_reads_the_port_engines_publisher(engine):
    """``GenerationEngine.fleet_publisher`` of the port feeds the
    reference's aggregator: the prefix-cache surface, the SLO row and the
    scheduler state arrive as the port's aggregator sees them."""
    engine.submit([1, 2, 3, 4, 5, 6], 3).result(timeout=60)
    pub = engine.fleet_publisher("w-port")
    wire_form = pub.serialize()
    rows = []
    for agg in (FleetAggregator(registry=MetricsRegistry()),
                jax_fleet.FleetAggregator(
                    registry=jax_metrics.MetricsRegistry())):
        assert agg.ingest(wire_form)
        rows.append(_row(agg.workers()[0]))
    assert rows[0] == rows[1]
    assert rows[0]["prefix_cache"]["version"] == \
        engine.prefix_cache.stats()["version"]
    assert rows[0]["slo"]["finished"] >= 1
    assert rows[0]["state"]["scheduler"]["slots"] == 4
