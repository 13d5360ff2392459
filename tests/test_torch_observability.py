"""The port's observability modules (``deeplearning4j_tpu_torch/
observability/``) against the JAX package's on the CPU.

- The metrics registry's Prometheus text and JSON exposition are
  byte-equal to the reference's for the same sequence of operations, and
  so are the serving and decode metric bundles' families.
- After the same seeded traffic, the port's and the JAX package's
  ``GenerationEngine`` and ``ServingEngine`` expose the same metric
  family names and label sets.
- Spans (nesting, request spans, Chrome-trace export, the profiler
  passthrough), ``step_guard`` flight events, the watchdog, and a flight
  report with every section.
- The recompile detector: signatures without ``jax.tree_util``, and the
  capture rule (a capture of a known signature is counted).
- ``SLOTracker`` gives the reference's attainment for the same requests.
"""

import json
import threading
import time

import numpy as np
import pytest

from deeplearning4j_tpu import generation as jax_generation
from deeplearning4j_tpu import serving as jax_serving
from deeplearning4j_tpu.models import serialization as jax_serialization
from deeplearning4j_tpu.models.zoo import transformer_char_lm as jax_lm
from deeplearning4j_tpu.observability import fleet as jax_fleet
from deeplearning4j_tpu.observability import metrics as jax_metrics
from deeplearning4j_tpu.observability import servingmetrics as jax_sm
from deeplearning4j_tpu_torch import generation, serving
from deeplearning4j_tpu_torch.models import serialization
from deeplearning4j_tpu_torch.observability import (
    flightrecorder, fleet, memory, metrics, recompile, servingmetrics,
    tracing,
)

VOCAB = 29


def _drive(m):
    """One sequence of registry operations, on either package's module."""
    reg = m.MetricsRegistry()
    c = reg.counter("dl4j_test_requests_total", "Requests by outcome",
                    labels=("status",))
    c.inc(status="ok")
    c.inc(3, status="ok")
    c.inc(status="error")
    reg.counter("dl4j_test_steps_total", "Steps").inc(7)
    g = reg.gauge("dl4j_test_depth", "Queue depth", labels=("server",))
    g.set(4, server="s0")
    g.set_function(lambda: 2.5, server="s1")
    reg.gauge("dl4j_test_nan", "Never set to a number").set(float("nan"))
    h = reg.histogram("dl4j_test_seconds", "Latency")
    for v in (0.0004, 0.003, 0.02, 0.02, 1.5, 40.0):
        h.observe(v)
    r = reg.histogram("dl4j_test_rows", "Rows", buckets=(1, 4, 16),
                      labels=("model",))
    for v in (1, 3, 3, 20):
        r.observe(v, model="m")
    return reg


def test_exposition_byte_equal_to_the_reference():
    port, ref = _drive(metrics), _drive(jax_metrics)
    assert port.to_prometheus() == ref.to_prometheus()
    assert json.dumps(port.to_json(), sort_keys=True, default=str) == \
        json.dumps(ref.to_json(), sort_keys=True, default=str)


@pytest.mark.parametrize("bundle", ["ServingMetrics", "GenerationMetrics"])
def test_metric_bundles_declare_the_reference_families(bundle):
    """Each bundle's families, helps, types and labels, and a few
    observations through them, render byte-equal."""
    out = []
    for sm, m in ((servingmetrics, metrics), (jax_sm, jax_metrics)):
        reg = m.MetricsRegistry()
        if bundle == "ServingMetrics":
            b = sm.ServingMetrics(reg, server_id="s9")
            b.requests.inc(status="ok")
            b.latency.observe(0.004)
            b.bucket_util.observe(0.75)
            b.set_max_batch(64)
        else:
            b = sm.GenerationMetrics(reg, engine_id="g9")
            b.ttft.observe(0.02)
            b.prefix_cache_hits.inc()
            b.prefix_cache_evictions.inc(2, reason="swap")
            b.active_slots.set(3)
        out.append(reg.to_prometheus())
    assert out[0] == out[1]


def _labelsets(reg, ids=("engine", "server")):
    """{family: (type, sorted label names, sorted label values except the
    per-instance ids)} of a registry."""
    out = {}
    for name, fam in reg.to_json().items():
        names, values = set(), set()
        for v in fam["values"]:
            names |= set(v["labels"])
            values |= {(k, str(x)) for k, x in v["labels"].items()
                       if k not in ids}
        out[name] = (fam["type"], tuple(sorted(names)),
                     tuple(sorted(values)))
    return out


@pytest.fixture(scope="module")
def lms(tmp_path_factory):
    jnet = jax_lm(vocab_size=VOCAB, d_model=32, n_heads=4, layers=2,
                  max_cache=128, seed=5)
    path = tmp_path_factory.mktemp("ckpt") / "lm.zip"
    jax_serialization.write_model(jnet, str(path))
    return jnet, serialization.load_model(path, device="cpu")


def test_generation_engines_expose_the_same_families(lms):
    """Seeded traffic (greedy and sampled, a prefix hit, a pin, a deploy)
    through both engines, each on its own registry: the same families,
    types, label names and label values."""
    regs = []
    for gen, m, net in ((generation, metrics, lms[1]),
                        (jax_generation, jax_metrics, lms[0])):
        reg = m.MetricsRegistry()
        eng = gen.GenerationEngine(net, slots=2, page_size=4,
                                   max_context=32, prefill_buckets=(16,),
                                   registry=reg, prefix_cache=True)
        eng.start()
        try:
            rs = np.random.RandomState(3)
            prompt = rs.randint(0, VOCAB, 9).tolist()
            eng.generate(prompt, 5)
            eng.generate(prompt, 5, temperature=0.8, seed=2)
            pin = eng.pin_prefix(prompt)
            eng.unpin_prefix(pin)
            eng.deploy("default", net, retain_old=True)
            eng.rollback()
            eng.generate(rs.randint(0, VOCAB, 4).tolist(), 3)
        finally:
            eng.stop()
        regs.append(_labelsets(reg))
    assert regs[0] == regs[1]
    assert "dl4j_decode_ttft_seconds" in regs[0]
    assert "dl4j_prefix_cache_hits" in regs[0]


def test_serving_engines_expose_the_same_families(tmp_path):
    from deeplearning4j_tpu.models.sequential import MultiLayerNetwork
    from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu.nn.layers import DenseLayer, OutputLayer

    conf = (NeuralNetConfiguration.builder().seed(7)
            .updater("sgd", learning_rate=0.1).list()
            .layer(DenseLayer(n_in=4, n_out=8, activation="tanh"))
            .layer(OutputLayer(n_in=8, n_out=3, loss="mcxent",
                               activation="softmax")).build())
    jnet = MultiLayerNetwork(conf).init()
    jax_serialization.write_model(jnet, str(tmp_path / "mlp.zip"))
    pnet = serialization.load_model(tmp_path / "mlp.zip", device="cpu")
    regs = []
    for srv, m, net in ((serving, metrics, pnet),
                        (jax_serving, jax_metrics, jnet)):
        reg = m.MetricsRegistry()
        old = m.get_registry()
        m.set_registry(reg)       # the detectors' default registry
        eng = srv.ServingEngine(net, max_batch=4, max_wait_ms=1.0,
                                registry=reg,
                                example=np.zeros((4,), np.float32))
        eng.start()
        try:
            rs = np.random.RandomState(0)
            for rows in (1, 3, 6):
                eng.predict(rs.rand(rows, 4).astype(np.float32))
            with pytest.raises(srv.ModelNotFoundError):
                eng.predict(np.zeros((1, 4), np.float32), model="nope")
            eng.deploy("default", net, example=np.zeros((4,), np.float32))
        finally:
            eng.stop()
            m.set_registry(old)
        regs.append(_labelsets(reg))
    assert regs[0] == regs[1]
    assert "dl4j_compiles_total" in regs[0]


# ------------------------------------------------------------------ tracing
def test_spans_nest_and_export():
    tr = tracing.SpanTracer(max_spans=8)
    with tr.span("outer", k=1) as outer:
        with tr.span("inner") as inner:
            assert [s["name"] for s in tr.live_spans()] == ["outer", "inner"]
    assert inner.parent_id == outer.span_id and outer.parent_id is None
    assert inner.duration_ns >= 0 and tr.live_spans() == []
    now = time.perf_counter_ns()
    tr.record_span("req", now - 1000, now, trace_id="t-1")
    assert [s.name for s in tr.spans_for_trace("t-1")] == ["req"]
    doc = tr.to_chrome_trace()
    assert sum(e["ph"] == "X" for e in doc["traceEvents"]) == 3
    for i in range(10):
        tr.record_span("fill", 0, 1)
    assert len(tr.spans()) == 8 and tr.dropped == 5
    assert len(tracing.new_trace_id()) == 16


def test_profiler_passthrough_exports_a_chrome_trace(tmp_path):
    """``use_torch_profiler`` spans appear as ``record_function`` ranges
    in the one ``torch.profiler`` trace ``profile(log_dir)`` exports."""
    import torch

    tr = tracing.SpanTracer(use_torch_profiler=True)
    with tr.profile(str(tmp_path)):
        with tr.span("port_span_marker"):
            torch.ones(8).sum()
    files = list(tmp_path.glob("trace-*.json"))
    assert len(files) == 1
    assert "port_span_marker" in files[0].read_text()


def test_step_guard_records_and_the_watchdog_dumps(tmp_path):
    rec = flightrecorder.set_flight_recorder(flightrecorder.FlightRecorder(4))
    try:
        with flightrecorder.step_guard("decode_step", active=2):
            pass
        with pytest.raises(ValueError):
            with flightrecorder.step_guard("decode_step"):
                raise ValueError("boom")
        kinds = [e.kind for e in rec.events()]
        assert kinds == ["step_begin", "step_end", "step_begin",
                         "step_error"]
        rec.record("extra")
        assert rec.dropped == 1
        wd = flightrecorder.StepWatchdog(deadline_s=0.05,
                                         report_dir=str(tmp_path),
                                         registry=metrics.MetricsRegistry())
        wd.install()
        try:
            with flightrecorder.step_guard("stuck"):
                time.sleep(0.4)
        finally:
            wd.uninstall()
        assert wd.dumps, "the hung step was not dumped"
        assert flightrecorder.get_watchdog() is None
    finally:
        flightrecorder.set_flight_recorder(None)


def test_flight_report_has_every_section(tmp_path):
    """The report's sections: meta, events, live spans, the registry,
    device memory (empty without a card), the memory attribution (live
    tensors and the peak; no profiler, so no models) and the sharding
    ledgers (``shardstats``, ported with A10: no error record now)."""
    import torch

    keep = torch.ones(64, 64)      # a live tensor the section must see
    rec = flightrecorder.FlightRecorder()
    rec.record("swap", model="default", version=2)
    tr = tracing.SpanTracer()
    reg = metrics.MetricsRegistry()
    reg.counter("dl4j_test_total", "x").inc()
    done = threading.Event()
    entered = threading.Event()

    def hold():
        with tr.span("held_open"):
            entered.set()
            done.wait(10)

    t = threading.Thread(target=hold)
    t.start()
    entered.wait(10)
    try:
        path = flightrecorder.dump_flight_report(
            str(tmp_path / "r.jsonl"), "test", recorder=rec, tracer=tr,
            registry=reg, context={"why": "check"})
    finally:
        done.set()
        t.join(10)
    recs = flightrecorder.read_flight_report(path)
    kinds = [r["record"] for r in recs]
    assert kinds[0] == "meta" and recs[0]["context"] == {"why": "check"}
    assert "event" in kinds and "live_span" in kinds
    assert "registry" in kinds and "device_memory" in kinds
    errors = {r["section"] for r in recs if r["record"] == "error"}
    assert errors == set()
    assert "sharding_ledger" in kinds
    mem = [r for r in recs if r["record"] == "memory_attribution"]
    assert len(mem) == 1 and "models" not in mem[0]
    live = mem[0]["live_buffers"]
    assert live["device"] == "cpu" and live["count"] > 0
    assert live["total_bytes"] >= sum(g["bytes"] for g in live["top"])
    assert live["total_bytes"] >= keep.nbytes
    assert mem[0]["peak"] == {"source": "live_buffers_estimate",
                              "peak_bytes": mem[0]["peak"]["peak_bytes"]}
    assert mem[0]["peak"]["peak_bytes"] > 0
    assert memory.device_memory_stats() == {}
    assert memory.sample_once(reg) == {}


# ------------------------------------------------------------- recompile
def test_fingerprint_and_capture_rule():
    import torch

    reg = metrics.MetricsRegistry()
    warned = []
    det = recompile.RecompileDetector("serving.t", registry=reg,
                                      warn=warned.append)
    x8 = np.zeros((8, 4), np.float32)
    assert det.check((x8,), {}, expected=True)        # new: a compile
    assert not det.check((np.ones((8, 4), np.float32),), {})
    assert det.check((np.zeros((16, 4), np.float32),), {})
    assert det.recompile_count == 1
    assert "args[0]: f32[8,4] -> f32[16,4]" in warned[-1]
    # the capture rule: a replay compiles nothing, a capture of a known
    # signature (dropped by the graph cache's LRU) counts again
    assert not det.check((x8,), {}, captured=False)
    assert det.check((x8,), {}, captured=True)
    assert "captured again" in warned[-1]
    assert det.compile_count == 3
    assert reg.get_value("dl4j_compiles_total", fn="serving.t") == 3
    t = torch.zeros(2, 3, dtype=torch.bfloat16)
    assert recompile.fingerprint((t, {"b": 1, "a": None}), {})[1] == \
        (((2, 3), "bfloat16", "cpu"), ("int",))


def test_slo_tracker_matches_the_reference():
    regs = (metrics.MetricsRegistry(), jax_metrics.MetricsRegistry())
    trackers = [fleet.SLOTracker(ttft_target_s=0.1, itl_target_s=0.02,
                                 registry=regs[0], engine_id="g1"),
                jax_fleet.SLOTracker(ttft_target_s=0.1, itl_target_s=0.02,
                                     registry=regs[1], engine_id="g1")]
    reqs = [(0.05, [0.01, 0.01], True), (0.3, [0.01], True),
            (0.05, [0.05, 0.01, 0.01], True), (0.01, [], False)]
    for tr in trackers:
        got = [tr.observe_request(ttft_s=t, itl_s=i, completed=c, now=1.0)
               for t, i, c in reqs]
        assert got == [True, False, False, False]
    a, b = (tr.as_dict() for tr in trackers)
    a.pop("goodput_rps"), b.pop("goodput_rps")
    assert a == b
    assert regs[0].get_value("dl4j_decode_slo_attainment", engine="g1",
                             slo="ttft") == 0.75
