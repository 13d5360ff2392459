"""The port's step profiler (``observability/profiling.py``) and
``recompile.instrument``, on the CPU: the oracles of the reference's
``tests/test_profiling.py`` through the port's facades — a fit run's
named capture with its Chrome traces and MFU, the disk budget, the
watchdog and straggler triggers, recompile flight events with their
cost, memory attribution in flight dumps — and the port's own step cost:
taken once per signature on the genuine first run (parameters
bit-equal to an unprofiled twin's), the exact matmul count of an MLP
step beside the reference's XLA cost analysis, and a transformer step's
attention kernel counted exactly once."""

import json
import os

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.sequential import (
    MultiLayerNetwork as JaxMultiLayerNetwork,
)
from deeplearning4j_tpu.nn.conf import (
    NeuralNetConfiguration as JaxNeuralNetConfiguration,
)
from deeplearning4j_tpu.nn.layers.dense import (
    DenseLayer as JaxDenseLayer, OutputLayer as JaxOutputLayer,
)
from deeplearning4j_tpu.observability import MetricsRegistry as JaxRegistry
from deeplearning4j_tpu.observability import (
    StepProfiler as JaxStepProfiler, set_registry as jax_set_registry,
)
from deeplearning4j_tpu.observability import get_registry as jax_registry
from deeplearning4j_tpu_torch import helpers
from deeplearning4j_tpu_torch.helpers import flash_attention as fa
from deeplearning4j_tpu_torch.models import zoo
from deeplearning4j_tpu_torch.models.common import tree_leaves
from deeplearning4j_tpu_torch.models.sequential import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.observability import (
    FlightRecorder, MetricsRegistry, SpanTracer, StepProfiler, StepWatchdog,
    StragglerDetector, get_registry, get_tracer, set_flight_recorder,
    set_registry, set_tracer, step_guard,
)
from deeplearning4j_tpu_torch.observability import flightrecorder as fr_mod
from deeplearning4j_tpu_torch.observability import profiling, recompile
from deeplearning4j_tpu_torch.observability.flightrecorder import (
    dump_flight_report, get_flight_recorder, read_flight_report,
)
from deeplearning4j_tpu_torch.observability.recompile import instrument


@pytest.fixture(autouse=True)
def fresh_telemetry():
    """Isolate registry/tracer/flight recorder AND the installed profiler
    per test."""
    old_reg = get_registry()
    old_tr = get_tracer()
    reg = set_registry(MetricsRegistry())
    set_tracer(SpanTracer())
    set_flight_recorder(FlightRecorder())
    yield reg
    prof = profiling.active_profiler()
    if prof is not None:
        prof.uninstall()
    wd = fr_mod.get_watchdog()
    if wd is not None:
        wd.uninstall()
    set_registry(old_reg)
    set_tracer(old_tr)
    set_flight_recorder(FlightRecorder())


def make_net(seed=7, n_in=8):
    return MultiLayerNetwork(
        (NeuralNetConfiguration.builder().seed(seed)
         .updater("sgd", learning_rate=0.1).list()
         .layer(DenseLayer(n_in=n_in, n_out=16))
         .layer(OutputLayer(n_in=16, n_out=4)).build())).init(device="cpu")


def make_batches(n, n_in=8, batch=16, seed=0):
    rs = np.random.RandomState(seed)
    return [(rs.rand(batch, n_in).astype(np.float32),
             np.eye(4, dtype=np.float32)[rs.randint(0, 4, batch)])
            for _ in range(n)]


def flight_events(kind):
    return [e.to_dict() for e in get_flight_recorder().events()
            if e.kind == kind]


# ------------------------------------------------------------- step cost
def test_peak_flops_table_and_cpu_estimate():
    peak, source = profiling.peak_flops_for()
    assert peak > 0 and source in ("table", "cpu-estimate")
    assert profiling.peak_flops_for("cpu") == (
        profiling.CPU_PEAK_FLOPS_ESTIMATE, "cpu-estimate")
    # the card's own dense peaks, no other rows
    assert profiling.PEAK_FLOPS == {"NVIDIA H100": {
        "bfloat16": 989e12, "float16": 989e12, "float32": 67e12}}


def test_cost_cached_per_signature(tmp_path, monkeypatch):
    """The step cost is counted once per NEW signature; repeat calls
    reuse it, and every dispatch counts into the flops counter."""
    made = []

    class Counting(recompile.StepCost):
        def __init__(self):
            super().__init__()
            made.append(self)

    monkeypatch.setattr(recompile, "StepCost", Counting)
    w = torch.ones(4, 8)
    with StepProfiler(str(tmp_path), use_torch_profiler=False):
        f = instrument(lambda a: (a @ w).sum(), "unit.cached")
        x = torch.ones(16, 4)
        for _ in range(3):
            f(x)
    assert len(made) == 1           # one count for one signature
    per_call = f.detector.last_cost["flops"]
    assert per_call == 2 * 16 * 4 * 8
    assert get_registry().get_value("dl4j_step_flops_total",
                                    fn="unit.cached") == 3 * per_call


def test_cost_is_taken_on_the_genuine_first_run(tmp_path, monkeypatch):
    """No step runs twice to be measured: the profiled fit calls the
    train body once a step, counts it once, and ends with parameters bit
    for bit those of an unprofiled twin."""
    made = []

    class Counting(recompile.StepCost):
        def __init__(self):
            super().__init__()
            made.append(self)

    monkeypatch.setattr(recompile, "StepCost", Counting)
    net = make_net()
    twin = net.clone()
    calls = []
    body = net._train_body

    def counted_body(*a, **k):
        calls.append(1)
        return body(*a, **k)

    net._train_body = counted_body
    batches = make_batches(4)
    with StepProfiler(str(tmp_path), use_torch_profiler=False):
        net.fit(batches)
    twin.fit(batches)
    assert len(calls) == 4 and len(made) == 1
    assert made[0].flops > 0
    for a, b in zip(tree_leaves(net.params), tree_leaves(twin.params)):
        assert torch.equal(a, b)


def test_profiler_installed_after_the_capture_counts_the_next_capture(
        tmp_path, monkeypatch):
    """A profiler installed on a job whose step is already captured (the
    straggler and watchdog triggers' usual case) sees replays, which run
    no body to count: the signature stays without a cost, one warning
    and one ``profile_cost_unavailable`` flight record say so, and the
    next capture of the signature (after ``capture.release``) counts
    it, so the steps after it report flops.  The captures are the
    compiles (the card's calls emulated)."""
    from deeplearning4j_tpu_torch.models import capture
    from tests.test_torch_tbptt import _emulate_capture

    net = make_net()
    _emulate_capture(monkeypatch, net)
    batches = make_batches(2)
    net.fit(batches)                       # captured, then replayed
    step = net._instrumented["train_step"]
    warned = []
    step.detector.warn = warned.append
    reg = get_registry()
    with StepProfiler(str(tmp_path), use_torch_profiler=False):
        net.fit(batches + batches)         # replays only
        assert reg.get_value("dl4j_step_flops_total",
                             fn="MultiLayerNetwork.train_step") is None
        assert step.detector.last_cost is None
        assert len(warned) == 1 and "captured before" in warned[0]
        evs = flight_events("profile_cost_unavailable")
        assert len(evs) == 1
        assert evs[0]["fn"] == "MultiLayerNetwork.train_step"
        capture.release(net)
        net.fit(batches)                   # captured again, then replayed
    assert net._step_graphs.captures == 1 and net._step_graphs.replays == 1
    assert reg.get_value("dl4j_compiles_total",
                         fn="MultiLayerNetwork.train_step") == 2
    per_step = step.detector.last_cost["flops"]
    assert per_step > 0
    assert reg.get_value("dl4j_step_flops_total",
                         fn="MultiLayerNetwork.train_step") == 2 * per_step
    # the release's recapture warns as a recompile, not as a lost cost
    assert len(warned) == 2 and "captured again" in warned[1]


def test_kernel_work_is_not_read_inside_a_paused_count():
    """A kernel wrapper's ``work()`` may read its data (paged decode's
    live keys), which a graph capture forbids: a paused ``StepCost``
    never calls it, and counts nothing."""
    from deeplearning4j_tpu_torch.helpers import cost

    read = []

    def work():
        read.append(1)
        return 10.0, 20.0

    counter = cost.StepCost()
    with counter:
        with cost.paused():
            with cost.kernel_cost(work):
                pass
        assert not read and counter.kernel_flops == 0
        with cost.kernel_cost(work):
            pass
    assert read == [1] and counter.kernel_flops == 10.0
    assert counter.kernel_bytes == 20.0


def test_mfu_peak_follows_the_models_compute_type(tmp_path, monkeypatch):
    """MFU is taken against the peak of the tracked model's compute type
    (float32 where the conf names none); ``peak_flops`` overrides it."""
    peaks = {"float32": 67e12, "bfloat16": 989e12}
    asked = []

    def fake_peak(device=None, dtype="float32"):
        asked.append((torch.device(device).type, dtype))
        return peaks[dtype], "table"

    monkeypatch.setattr(profiling, "peak_flops_for", fake_peak)
    f32 = make_net()
    bf16 = MultiLayerNetwork(
        (NeuralNetConfiguration.builder().seed(7)
         .updater("sgd", learning_rate=0.1).list()
         .compute_dtype("bfloat16")
         .layer(DenseLayer(n_in=8, n_out=16))
         .layer(OutputLayer(n_in=16, n_out=4)).build())).init(device="cpu")
    prof = StepProfiler(str(tmp_path))
    prof.track_model(f32, "f32")
    prof.track_model(bf16, "bf16")
    assert prof.peak_for("f32") == (67e12, "table")
    assert prof.peak_for("bf16") == (989e12, "table")
    assert asked == [("cpu", "float32"), ("cpu", "bfloat16")]
    over = StepProfiler(str(tmp_path), peak_flops=1e12)
    over.track_model(bf16, "bf16")
    assert over.peak_for("bf16") == (1e12, "override")
    with StepProfiler(str(tmp_path), capture_step=1):
        bf16.fit(make_batches(2))
    caps = flight_events("profile_capture")
    meta = json.load(open(os.path.join(caps[0]["path"], "capture.json")))
    assert meta["peak_flops"] == 989e12
    assert meta["peak_flops_source"] == "table"


def _mlp(builder, dense, output, seed=3):
    return (builder.builder().seed(seed).updater("sgd", learning_rate=0.1)
            .list()
            .layer(dense(n_in=256, n_out=512, activation="relu"))
            .layer(output(n_in=512, n_out=10, loss="mcxent",
                          activation="softmax")).build())


def test_mlp_step_flops_exact_and_beside_the_reference(tmp_path):
    """A 256->512->10 MLP step at batch 64: exactly the analytic matmul
    count (forward, both weight gradients, the hidden layer's input
    gradient), and within 10 % of the reference's XLA cost analysis of
    the same step, which also counts elementwise operations."""
    b = 64
    rs = np.random.RandomState(0)
    x = rs.rand(b, 256).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rs.randint(0, 10, b)]
    net = MultiLayerNetwork(_mlp(NeuralNetConfiguration, DenseLayer,
                                 OutputLayer)).init(device="cpu")
    with StepProfiler(str(tmp_path), use_torch_profiler=False):
        net.fit([(x, y)])
    ours = get_registry().get_value("dl4j_step_flops_total",
                                    fn="MultiLayerNetwork.train_step")
    fwd = 2 * b * (256 * 512 + 512 * 10)
    assert ours == 2 * fwd + 2 * b * 512 * 10

    old = jax_registry()
    jax_set_registry(JaxRegistry())
    try:
        jnet = JaxMultiLayerNetwork(_mlp(JaxNeuralNetConfiguration,
                                         JaxDenseLayer,
                                         JaxOutputLayer)).init()
        with JaxStepProfiler(str(tmp_path / "jax"), use_jax_profiler=False):
            jnet.fit([(x, y)])
        theirs = jax_registry().get_value("dl4j_step_flops_total",
                                          fn="MultiLayerNetwork.train_step")
    finally:
        jax_set_registry(old)
    assert theirs > 0
    assert abs(ours - theirs) / theirs < 0.10, (ours, theirs)


def test_transformer_step_counts_the_attention_kernel_once(tmp_path):
    """A transformer char-LM step: the matmuls' 6·N·tokens plus each
    layer's flash forward, dQ and dK/dV operations as the wrapper
    reports them — the plain version's own matmuls are not counted a
    second time."""
    vocab, d, heads, layers, b, t = 29, 32, 4, 2, 2, 16
    net = zoo.transformer_char_lm(vocab_size=vocab, d_model=d,
                                  n_heads=heads, layers=layers,
                                  max_cache=64, seed=5, device="cpu")
    rs = np.random.RandomState(1)
    ids = rs.randint(0, vocab, (b, t))
    labels = np.eye(vocab, dtype=np.float32)[np.roll(ids, -1, axis=1)]
    assert helpers.enabled()
    with StepProfiler(str(tmp_path), use_torch_profiler=False):
        net.fit([(ids, labels)])
    cost = net._instrumented["train_step"].detector.last_cost
    n = sum(p.numel() for name, layer in zip(net.params, net.layers)
            if type(layer).__name__ != "EmbeddingLayer"
            for p in tree_leaves(net.params[name]) if p.ndim >= 2)
    q = torch.empty(b, t, heads, d // heads)
    w = fa.work(q, True, None)
    attn = layers * sum(w[k][0] for k in ("fwd", "dq", "dkv"))
    assert cost["kernel_flops"] == attn
    assert cost["flops"] == 6 * n * b * t + attn


# -------------------------------------------- acceptance: fit-run capture
def test_fit_capture_step_and_mfu(tmp_path):
    """A fit run with StepProfiler(capture_step=3) produces readable
    trace files and fills dl4j_model_flops_utilization with a finite
    value in (0, 1] (the unclamped ratio beside it)."""
    prof = StepProfiler(str(tmp_path / "prof"), capture_step=3).install()
    net = make_net()
    net.fit(make_batches(5))

    reg = get_registry()
    mfu = reg.get_value("dl4j_model_flops_utilization",
                        component="MultiLayerNetwork")
    assert mfu is not None and np.isfinite(mfu) and 0.0 < mfu <= 1.0
    assert reg.get_value("dl4j_model_flops_utilization_unclamped",
                         component="MultiLayerNetwork") == mfu
    assert reg.get_value("dl4j_step_flops_total",
                         fn="MultiLayerNetwork.train_step") > 0
    assert reg.get_value("dl4j_step_bytes_per_flop",
                         component="MultiLayerNetwork") > 0

    caps = flight_events("profile_capture")
    assert len(caps) == 1
    assert caps[0]["reason"] == "step:3"
    assert caps[0]["step"] == "fit_step"
    cap_dir = caps[0]["path"]
    doc = json.load(open(os.path.join(cap_dir, "host_spans.trace.json")))
    names = [e["name"] for e in doc["traceEvents"] if e["ph"] == "X"]
    assert "fit_step" in names
    torch_doc = json.load(open(caps[0]["torch_trace"]))
    assert torch_doc["traceEvents"]
    meta = json.load(open(os.path.join(cap_dir, "capture.json")))
    assert meta["flops"] > 0 and 0.0 < meta["mfu"] <= 1.0
    assert meta["mfu_unclamped"] == meta["mfu"]
    assert meta["timed_on"] == "host"
    assert prof.capture_paths == [cap_dir]
    assert reg.get_value("dl4j_profile_captures_total", reason="step") == 1


def test_capture_while_another_session_runs_is_skipped(tmp_path):
    """torch.profiler sessions do not nest: a capture that comes due
    inside another session is skipped and counted, and training goes
    on."""
    from torch.profiler import ProfilerActivity, profile

    StepProfiler(str(tmp_path / "prof"), capture_step=1).install()
    net = make_net()
    with profile(activities=[ProfilerActivity.CPU]):
        net.fit(make_batches(3))
    assert net.iteration == 3
    assert flight_events("profile_capture") == []
    assert [e["reason"] for e in flight_events("profile_skipped")] == [
        "step:1"]
    assert get_registry().get_value("dl4j_profile_captures_skipped_total",
                                    reason="busy") == 1


def test_capture_disk_budget(tmp_path):
    """Oldest capture directories are deleted once the budget is
    exceeded; the newest capture always survives."""
    prof = StepProfiler(str(tmp_path), max_disk_bytes=1,
                        use_torch_profiler=False).install()
    for i in range(3):
        prof.request_capture(f"manual:{i}")
        with step_guard("fit_step", model="Unit", iteration=i):
            pass
    survivors = sorted(d for d in os.listdir(tmp_path)
                       if d.startswith("cap-"))
    assert survivors == ["cap-0003-manual-2"]
    assert len(prof.capture_paths) == 3


def test_watchdog_dump_arms_capture(tmp_path):
    StepProfiler(str(tmp_path / "prof"), use_torch_profiler=False).install()
    wd = StepWatchdog(deadline_s=60.0,
                      report_dir=str(tmp_path / "diag")).install()
    wd.dump("hang", step="fit_step")
    with step_guard("fit_step", model="Unit", iteration=9):
        pass
    caps = flight_events("profile_capture")
    assert len(caps) == 1
    assert caps[0]["reason"] == "watchdog:hang"
    wd.uninstall()


def test_straggler_verdict_triggers_capture(tmp_path):
    """A straggler verdict arms a capture of the next guarded step,
    named in the flight recorder (the reference drives it through a
    4-replica ParallelWrapper, which the port has not yet)."""
    StepProfiler(str(tmp_path), use_torch_profiler=False,
                 cost_analysis=False).install()
    det = StragglerDetector("parallel_wrapper", min_steps=4,
                            warn=lambda msg: None)
    flagged = False
    for _ in range(8):
        for w in ("0", "1", "3"):
            det.observe(w, 0.010)
        flagged = det.observe("2", 0.060) or flagged
    assert flagged and "2" in det.stragglers()
    assert flight_events("profile_requested")
    with step_guard("parallel_window", component="parallel_wrapper",
                    iteration=8):
        pass
    caps = flight_events("profile_capture")
    assert caps and caps[0]["reason"] == "straggler:parallel_wrapper:2"
    assert caps[0]["step"] == "parallel_window"
    assert get_registry().get_value("dl4j_profile_captures_total",
                                    reason="straggler") >= 1


# --------------------------------------------- recompile cost flight event
def test_unexpected_recompile_dumps_signature_and_cost(tmp_path):
    with StepProfiler(str(tmp_path), use_torch_profiler=False):
        f = instrument(lambda a: (a @ a.T).sum(), "unit.recomp")
        f(torch.ones((8, 8), dtype=torch.float32))
        f(torch.ones((16, 8), dtype=torch.float32))
    evs = flight_events("recompile")
    assert len(evs) == 1
    ev = evs[0]
    assert ev["fn"] == "unit.recomp"
    assert "f32[16,8]" in ev["signature"]
    assert "f32[8,8]" in ev["evicted_signature"]
    assert ev["flops"] > ev["evicted_flops"] > 0
    assert ev["flops_delta"] == pytest.approx(
        ev["flops"] - ev["evicted_flops"])
    assert ev["bytes_delta"] > 0


def test_recompile_event_without_profiler_still_names_signature():
    f = instrument(lambda a: a.sum(), "unit.nocost")
    f(torch.ones((4,), dtype=torch.float32))
    f(torch.ones((6,), dtype=torch.float32))
    evs = flight_events("recompile")
    assert len(evs) == 1
    assert "f32[6]" in evs[0]["signature"]
    assert "flops" not in evs[0]


def test_train_step_compiles_once_per_shape(tmp_path):
    """``dl4j_compiles_total{fn=MultiLayerNetwork.train_step}`` counts one
    compile for the one batch shape however many steps follow (on the
    CPU a new signature; on the card a capture)."""
    net = make_net()
    net.fit(make_batches(4))
    reg = get_registry()
    assert reg.get_value("dl4j_compiles_total",
                         fn="MultiLayerNetwork.train_step") == 1
    net.fit_scanned(make_batches(4), scan_steps=2)
    assert reg.get_value("dl4j_compiles_total",
                         fn="MultiLayerNetwork.scanned_step") == 1


# -------------------------------------------------- memory attribution
def test_model_memory_breakdown():
    net = make_net()
    net.fit(make_batches(1))
    br = profiling.model_memory_breakdown(net)
    assert br["params_bytes"] > 0
    assert br["total_bytes"] >= br["params_bytes"]
    assert br["top_leaves"][0]["bytes"] >= br["top_leaves"][-1]["bytes"]
    paths = {leaf["path"] for leaf in br["top_leaves"]}
    assert any("W" in p or "w" in p for p in paths)
    assert br["params_bytes"] == sum(p.nbytes
                                     for p in tree_leaves(net.params))


def test_live_buffer_snapshot():
    keep = torch.ones((128, 128))   # noqa: F841 — held live on purpose
    snap = profiling.live_buffer_snapshot()
    assert snap["total_bytes"] >= keep.nbytes
    assert snap["count"] >= 1
    assert snap["top"][0]["bytes"] > 0


def test_flight_dump_contains_memory_attribution(tmp_path):
    StepProfiler(str(tmp_path / "prof"), use_torch_profiler=False).install()
    net = make_net()
    net.fit(make_batches(2))
    path = str(tmp_path / "report.jsonl")
    dump_flight_report(path, "unit-test")
    records = read_flight_report(path)
    mem = [r for r in records if r["record"] == "memory_attribution"]
    assert len(mem) == 1
    assert mem[0]["live_buffers"]["total_bytes"] > 0
    assert mem[0]["models"]["MultiLayerNetwork"]["params_bytes"] > 0


def test_step_peak_memory_gauge_or_graceful(tmp_path):
    with StepProfiler(str(tmp_path), use_torch_profiler=False):
        net = make_net()
        net.fit(make_batches(2))
    fam = get_registry().get("dl4j_step_peak_memory_bytes")
    from deeplearning4j_tpu_torch.observability.memory import (
        device_memory_stats,
    )

    if device_memory_stats():
        assert fam is not None and fam.samples()


def test_chrome_trace_export_roundtrip(tmp_path):
    tracer = get_tracer()
    with tracer.span("outer", trace_id="t1"):
        with tracer.span("inner"):
            pass
    path = str(tmp_path / "trace.json")
    n = tracer.export_chrome_trace(path)
    assert n == 2
    doc = json.load(open(path))
    evs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert {e["name"] for e in evs} == {"outer", "inner"}
    outer = next(e for e in evs if e["name"] == "outer")
    assert outer["args"]["trace_id"] == "t1"
    assert outer["dur"] >= 0
    metas = [e for e in doc["traceEvents"] if e["ph"] == "M"]
    assert metas and metas[0]["name"] == "thread_name"
