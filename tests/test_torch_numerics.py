"""The port's numerics ledger (``observability/numerics.py``) and float64
kernel-trust sweep (``observability/kerneldiff.py``) on the CPU.

- The reference's ``tests/test_numerics.py:112-288`` and ``:371``
  oracles over the port: the stat block against a numpy oracle with
  the sample budget off, max-abs exact under sampling, the verdict
  thresholds, a ledger-on fit bit-identical to a ledger-off one with no
  capture after warm-up (the card's capture emulated), the interval
  gate (two programs, each captured once: the skipping one leaves the
  snapshot in place), moments under Adam, the spike drill, the KV page
  ledger under the generation engine, the policy's serde.
- Against JAX: ``_entry_stats`` on the same arrays (counts and
  fractions exact, max-abs exact, with and without sampling and a
  scale); the harvested ledger after the same steps from the same
  weights (max-abs to ``rtol=1e-4``, every verdict equal).
- The port's kerneldiff on the CPU: every plain kernel within
  ``DTYPE_BUDGET`` of the float64 references, ULP distance in
  bfloat16 counted as the reference counts it.
"""

import math

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.models.common import tree_leaves
from deeplearning4j_tpu_torch.models.sequential import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.conf import (
    MultiLayerConfiguration, NeuralNetConfiguration, TrainingNumerics,
)
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.observability import (
    get_flight_recorder, get_registry, kerneldiff, numerics,
)
from deeplearning4j_tpu_torch.resilience import (
    FaultInjector, inject_faults,
)


def flight_events(kind, **attrs):
    return [ev for ev in get_flight_recorder().events()
            if ev.kind == kind
            and all(ev.attrs.get(k) == v for k, v in attrs.items())]


def _conf(builder, layers, seed, num, updater, activation, policy_kw):
    b = builder.seed(seed).updater(updater, learning_rate=0.01)
    if num:
        b.training_numerics(**policy_kw)
    return (b.list()
            .layer(layers.DenseLayer(n_in=6, n_out=10,
                                     activation=activation))
            .layer(layers.OutputLayer(n_in=10, n_out=3, loss="mcxent",
                                      activation="softmax"))
            .build())


def make_net(seed=1, num=True, updater="sgd", activation="tanh",
             **policy_kw):
    from deeplearning4j_tpu_torch.nn import layers

    return MultiLayerNetwork(_conf(
        NeuralNetConfiguration.builder(), layers, seed, num, updater,
        activation, policy_kw)).init(device="cpu")


def make_jax_net(seed=1, num=True, updater="sgd", activation="tanh",
                 **policy_kw):
    from deeplearning4j_tpu.models.sequential import (
        MultiLayerNetwork as JNet,
    )
    from deeplearning4j_tpu.nn import layers
    from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JConf

    return JNet(_conf(JConf.builder(), layers, seed, num, updater,
                      activation, policy_kw)).init()


def batch(seed=0, n=24, scale=1.0):
    rs = np.random.RandomState(seed)
    x = (scale * rs.rand(n, 6)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, n)]
    return x, y


def entry_dict(block):
    return numerics._entry_host(block.numpy())


# --------------------------------------------------------- the numpy oracle
def oracle(arrs):
    flat = np.concatenate([np.asarray(a, np.float32).ravel() for a in arrs])
    a = np.abs(flat)
    n = float(a.size)
    max_abs = float(a.max()) if a.size else 0.0
    nz = a > 0
    under, over = {}, {}
    for name, lo, hi in numerics.FORMATS:
        if name == "int8":
            under[name] = float(np.sum(nz & (a < max_abs / 254.0)) / n)
            over[name] = 0.0
        else:
            under[name] = float(np.sum(nz & (a < lo)) / n)
            over[name] = float(np.sum(a > hi) / n)
    hist = np.zeros(numerics.HIST_BINS)
    e = np.floor(np.log2(np.where(nz, a, 1.0)))
    idx = np.clip(e - numerics.HIST_LO, 0, numerics.HIST_BINS - 1)
    for i, keep in zip(idx.astype(int), nz):
        if keep:
            hist[i] += 1
    return max_abs, under, over, hist


def _arrays():
    rs = np.random.RandomState(7)
    return [
        (rs.randn(40, 3) * np.exp2(rs.randint(-30, 18, (40, 3)))
         ).astype(np.float32),
        np.zeros((11,), np.float32),
        np.array([1e-30, 7e4, 0.5], np.float32),
    ]


def test_entry_stats_matches_numpy_oracle():
    arrs = _arrays()
    got = entry_dict(numerics._entry_stats(
        [torch.from_numpy(a) for a in arrs], sample=0))
    max_abs, under, over, hist = oracle(arrs)
    assert got["max_abs"] == pytest.approx(max_abs, rel=1e-6)
    for name in numerics.FORMAT_NAMES:
        assert got["underflow"][name] == pytest.approx(under[name],
                                                       abs=1e-6), name
        assert got["overflow"][name] == pytest.approx(over[name],
                                                      abs=1e-6), name
    assert np.allclose(got["exponent_histogram"], hist)
    assert sum(got["exponent_histogram"]) == int(np.sum(
        np.abs(np.concatenate([a.ravel() for a in arrs])) > 0))


@pytest.mark.parametrize("sample, scale", [(0, None), (1024, None),
                                           (16, None), (0, 0.125),
                                           (16, 2.0 ** -7)])
def test_entry_stats_match_jax(sample, scale):
    """The port's block against the reference's ``_entry_stats`` on the
    same arrays: every count and fraction exact, max-abs exact."""
    import jax
    import jax.numpy as jnp

    from deeplearning4j_tpu.observability import numerics as jnum

    rs = np.random.RandomState(11)
    arrs = _arrays() + [(rs.randn(300) * 3.0).astype(np.float32),
                        np.full((5,), np.inf, np.float32)]
    got = numerics._entry_stats([torch.from_numpy(a) for a in arrs],
                                scale=scale, sample=sample).numpy()
    want = np.asarray(jax.jit(lambda t: jnum._entry_stats(
        t, scale=scale, sample=sample))([jnp.asarray(a) for a in arrs]))
    np.testing.assert_array_equal(got, want)


def test_sampled_stats_keep_max_abs_exact():
    a = np.full((10_000,), 0.5, np.float32)
    a[3] = 1e6          # stride for sample=1024 is 10, index 3 is unsampled
    got = entry_dict(numerics._entry_stats([torch.from_numpy(a)],
                                           sample=1024))
    assert got["max_abs"] == pytest.approx(1e6)
    assert got["overflow"]["float16"] == 0.0
    assert numerics.overflow_hard(got, "float16")
    assert numerics.risk_score(got, "float16") == 1.0
    assert not numerics.verdicts(got)["float16"]
    assert sum(got["exponent_histogram"]) == 1000


def test_verdict_thresholds():
    healthy = {
        "max_abs": 1.0,
        "underflow": {n: 0.0 for n in numerics.FORMAT_NAMES},
        "overflow": {n: 0.0 for n in numerics.FORMAT_NAMES},
        "exponent_histogram": [0.0] * numerics.HIST_BINS,
    }
    healthy["exponent_histogram"][0 - numerics.HIST_LO] = 100.0
    assert all(numerics.verdicts(healthy).values())
    assert numerics.risk_score(healthy, "bfloat16") == 0.0
    wide = dict(healthy)
    wide["exponent_histogram"] = [0.0] * numerics.HIST_BINS
    wide["exponent_histogram"][0 - numerics.HIST_LO] = 40.0
    wide["exponent_histogram"][-20 - numerics.HIST_LO] = 60.0
    assert numerics.absorption_fraction(wide, "bfloat16") == \
        pytest.approx(0.6)
    assert not numerics.verdicts(wide)["bfloat16"]
    assert numerics.verdicts(wide, TrainingNumerics(absorb_threshold=0.7)
                             )["bfloat16"]


def test_a_non_finite_block_is_risky_in_every_format():
    """A NaN gradient block (an overflowed step, seen under the guard)
    harvests as risky for every format with risk 1.0; the reference's
    harvest raises on its logarithm instead (ROADMAP C2)."""
    from deeplearning4j_tpu.observability import numerics as jnum

    for bad in (float("nan"), float("inf")):
        block = numerics._entry_stats([torch.tensor([1.0, bad, 0.5])],
                                      sample=0).numpy()
        e = numerics._entry_host(block)
        assert not any(numerics.verdicts(e).values())
        assert all(numerics.risk_score(e, d) == 1.0
                   for d in numerics.FORMAT_NAMES)
    nan_block = numerics._entry_stats(
        [torch.tensor([1.0, float("nan"), 0.5])], sample=0).numpy()
    with pytest.raises(ValueError):
        jnum.verdicts(jnum._entry_host(nan_block))


# ------------------------------------------------- in-step collection
def test_bit_identical_and_no_capture_after_warm_up(monkeypatch):
    from tests.test_torch_tbptt import _emulate_capture

    x, y = batch()
    on = make_net(num=True, interval=1)
    off = make_net(num=False)
    on.fit(x, y)
    _emulate_capture(monkeypatch, on)
    for _ in range(6):
        on.fit(x, y)
        off.fit(x, y)
    off.fit(x, y)
    assert on._step_graphs.captures == 1
    for a, b in zip(tree_leaves(on.params), tree_leaves(off.params)):
        assert torch.equal(a, b)
    h = numerics.harvest_model(on)
    assert h["iteration"] == on.iteration - 1
    assert set(h["gradients"]) == {"layer_0", "layer_1"}
    assert set(h["activations"]) == {"layer_0", "layer_1"}
    for e in h["gradients"].values():
        assert math.isfinite(e["max_abs"]) and e["max_abs"] > 0
        assert set(e["verdicts"]) == set(numerics.FORMAT_NAMES)


def test_interval_gating_stale_carry(monkeypatch):
    """interval=3: the host picks the collecting or the skipping program
    from the iteration; between collections the harvest returns the
    stale snapshot, the refresh lands on the interval, and after both
    programs' first calls nothing is captured."""
    from tests.test_torch_tbptt import _emulate_capture

    x, y = batch()
    net = make_net(num=True, interval=3)
    net.fit(x, y)                      # iteration 0: collected (eager)
    _emulate_capture(monkeypatch, net)
    assert numerics.harvest_model(net)["iteration"] == 0
    net.fit(x, y)                      # iteration 1: skip (captured)
    net.fit(x, y)                      # iteration 2: skip (replay)
    assert numerics.harvest_model(net)["iteration"] == 0
    net.fit(x, y)                      # iteration 3: collect (captured)
    assert numerics.harvest_model(net)["iteration"] == 3
    for _ in range(4):
        net.fit(x, y)                  # 4..7: replays only
    assert numerics.harvest_model(net)["iteration"] == 6
    graphs = net._step_graphs
    assert graphs.captures == 2 and graphs.replays == 5
    assert sorted(p.cache_key[-1] for p in graphs.programs.values()) == \
        [("numerics", False), ("numerics", True)]


def test_moment_entries_under_adam():
    x, y = batch()
    net = make_net(num=True, updater="adam", interval=1)
    for _ in range(3):
        net.fit(x, y)
    h = numerics.harvest_model(net)
    for e in h["moments"].values():
        assert e["max_abs"] > 0


@pytest.mark.parametrize("updater", ["sgd", "adam"])
def test_harvest_matches_jax(updater):
    """After the same steps from the same weights the ledgers agree:
    max-abs to ``rtol=1e-4`` and every verdict."""
    from deeplearning4j_tpu.observability import numerics as jnum

    jnet = make_jax_net(seed=3, updater=updater, interval=1, sample=0)
    net = make_net(seed=3, updater=updater, interval=1, sample=0)
    net.set_params_vector(np.asarray(jnet.params_to_vector()))
    for i in range(3):
        x, y = batch(seed=30 + i)
        net.fit(x, y)
        jnet.fit(x, y)
    h, jh = numerics.harvest_model(net), jnum.harvest_model(jnet)
    assert h["iteration"] == jh["iteration"]
    for comp in ("gradients", "moments", "activations"):
        for layer, e in h[comp].items():
            je = jh[comp][layer]
            np.testing.assert_allclose(e["max_abs"], je["max_abs"],
                                       rtol=1e-4)
            assert e["verdicts"] == je["verdicts"], (comp, layer)


# ------------------------------------------------------------- spike drill
def test_spike_drill_flips_bf16_verdict_and_flight_event():
    """The reference's drill, from the reference net's weights (the
    drill's margin depends on them)."""
    x, y = batch(scale=1.0)
    net = make_net(num=True, interval=1, absorb_threshold=0.15,
                   activation="relu")
    net.set_params_vector(np.asarray(make_jax_net(
        num=True, interval=1, absorb_threshold=0.15,
        activation="relu").params_to_vector()))
    for _ in range(3):
        net.fit(x, y)
    before = numerics.harvest_model(net)
    safe_before = {(c, l) for c in ("gradients", "activations")
                   for l, e in before[c].items()
                   if e["verdicts"]["bfloat16"]}
    assert safe_before, "healthy run must have bf16-safe blocks"
    inj = FaultInjector().poison_gradients("0", at_step=net.iteration,
                                           mode="spike")
    with inject_faults(inj):
        net.fit(x, y)
    after = numerics.harvest_model(net)
    assert after["iteration"] == net.iteration - 1
    flipped = [(c, l) for (c, l) in safe_before
               if not after[c][l]["verdicts"]["bfloat16"]]
    assert flipped, "spike did not flip any bf16 verdict"
    grew = max(after[c][l]["max_abs"] / max(before[c][l]["max_abs"], 1e-30)
               for (c, l) in safe_before)
    assert grew > 1e2
    monitor = numerics.NumericsMonitor(component="drill", min_iteration=0,
                                       warn=lambda *a, **k: None)
    violations = monitor.check(after)
    assert violations
    layer = violations[0]["layer"]
    assert flight_events("numerics_anomaly", component="drill",
                         layer=layer)
    text = numerics.format_precision_ledger(after)
    assert "RISK" in text and layer in text


# ------------------------------------------------------------ KV-page stats
def test_kv_page_ledger_under_generation_engine():
    from deeplearning4j_tpu_torch.generation import GenerationEngine
    from deeplearning4j_tpu_torch.models.zoo import transformer_char_lm

    lm = transformer_char_lm(vocab_size=29, d_model=32, n_heads=4,
                             layers=2, max_cache=128, device="cpu")
    eng = GenerationEngine(lm, slots=2, page_size=4, max_context=32,
                           max_queue=16, deadline_s=30.0)
    eng.start()
    try:
        toks = eng.generate([1, 2, 3, 4, 5], 8)
        assert len(toks) > 0
        full = eng.kv_numerics(allocated_only=False)
        live = eng.kv_numerics()
    finally:
        eng.stop()
    assert full, "no pageable attention layers reported"
    for pools in full.values():
        assert set(pools) == {"pk", "pv"}
        for e in pools.values():
            assert e["pages"], "non-trash pages must be listed"
            assert max(e["page_max_abs"]) > 0
            assert all(0.0 <= u <= 1.0 for u in e["int8_underflow"])
            assert 0.0 <= e["int8_ready_fraction"] <= 1.0
    for layer, pools in live.items():
        for leaf, e in pools.items():
            assert set(e["pages"]) <= set(full[layer][leaf]["pages"])


def test_kv_page_ledger_matches_jax_on_the_same_pools():
    from deeplearning4j_tpu.observability import numerics as jnum

    rs = np.random.RandomState(5)
    pools = {"layer_1": {"sub1": {
        "pk": (rs.randn(6 * 4, 2, 8) * np.exp2(rs.randint(-9, 3, (24, 1, 1)))
               ).astype(np.float32),
        "pv": rs.randn(6 * 4, 2, 8).astype(np.float32)}}}
    tpools = {"layer_1": {"sub1": {k: torch.from_numpy(v) for k, v in
                                   pools["layer_1"]["sub1"].items()}}}
    for allocated in (None, [2, 3]):
        assert numerics.kv_page_ledger(tpools, 4, allocated) == \
            jnum.kv_page_ledger(pools, 4, allocated)


# --------------------------------------------------------- kernel trust
def test_kerneldiff_cpu_sweep_within_budget():
    report = kerneldiff.run_sweep(full=True, device="cpu")
    assert report["summary"]["kernels"] == len(kerneldiff.KERNELS)
    assert report["summary"]["untrusted"] == []
    for name, k in report["kernels"].items():
        assert k["classification"] == "within_tolerance", name
        for cfg in k["configs"]:
            assert cfg["status"] == "pass", (name, cfg)
            assert cfg["max_rel_error"] <= \
                kerneldiff.DTYPE_BUDGET[cfg["dtype"]]
    text = kerneldiff.format_report(report)
    assert "paged_decode_attention" in text
    kerneldiff.publish_metrics(report)
    assert get_registry().get("dl4j_kernel_max_rel_error") is not None


def test_kerneldiff_measures_as_the_reference():
    """``measure`` (ULP ordinals by torch's rounding to bfloat16) against
    the reference's (``ml_dtypes``) on the same values."""
    from deeplearning4j_tpu.observability import kerneldiff as jkd

    rs = np.random.RandomState(9)
    ref = rs.randn(257) * np.exp2(rs.randint(-8, 8, 257))
    out = (ref * (1 + rs.randn(257) * 1e-3)).astype(np.float32)
    for dtype in ("float32", "bfloat16"):
        np.testing.assert_array_equal(kerneldiff._bits(out, dtype),
                                      jkd._bits(out, dtype))
        assert kerneldiff.measure(torch.from_numpy(out), ref, dtype) == \
            jkd.measure(out, ref, dtype)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_kerneldiff_errors_propagate_on_every_device(monkeypatch, device):
    """A runner's error (a kernel that does not build or launch, a broken
    helper) fails the sweep on every device; nothing is filed as a
    class."""
    def broken(cfg, device):
        raise ImportError("no such helper")

    gen, _, exact = kerneldiff.KERNELS["lrn_fwd"]
    monkeypatch.setitem(kerneldiff.KERNELS, "lrn_fwd", (gen, broken, exact))
    with pytest.raises(ImportError, match="no such helper"):
        kerneldiff.run_sweep(kernels=["lrn_fwd"], device=device)


def test_kerneldiff_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    """The sweep and its CLI launch the kernels by default: without a GPU
    they refuse, and never report the plain versions under the kernels'
    names."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        kerneldiff.run_sweep(kernels=["lrn_fwd"])
    with pytest.raises(RuntimeError, match="no GPU"):
        kerneldiff.main(["--kernels", "lrn_fwd"])
    assert kerneldiff.main(["--kernels", "lrn_fwd", "--device", "cpu"]) == 0


# ---------------------------------------------------------------- conf serde
def test_policy_serde_roundtrip():
    conf = (NeuralNetConfiguration.builder().seed(5)
            .updater("adam", learning_rate=0.01)
            .training_numerics(sample=512, interval=4,
                               absorb_threshold=0.25)
            .list()
            .layer(DenseLayer(n_in=4, n_out=4, activation="relu"))
            .layer(OutputLayer(n_in=4, n_out=2, loss="mcxent",
                               activation="softmax"))
            .build())
    back = MultiLayerConfiguration.from_dict(conf.to_dict())
    assert back.numerics == conf.numerics
    assert back.numerics["sample"] == 512
    assert back.numerics["interval"] == 4
    assert back.numerics["absorb_threshold"] == 0.25
    net = MultiLayerNetwork(back).init(device="cpu")
    assert numerics.plan_for(net).policy == TrainingNumerics(
        sample=512, interval=4, absorb_threshold=0.25)
    with pytest.raises(ValueError):
        TrainingNumerics(sample=-1)
    with pytest.raises(ValueError):
        TrainingNumerics(interval=0)
    with pytest.raises(ValueError):
        TrainingNumerics(absorb_threshold=0.0)
