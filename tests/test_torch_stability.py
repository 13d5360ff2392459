"""The port's stability engine (``deeplearning4j_tpu_torch/resilience/
stability.py``, the guard inside ``common.sgd_step``) on the CPU.

- The port's own bit-identity: a guarded healthy run (no scaling, and a
  static power-of-two scale) equals its unguarded run bit for bit, on
  both facades; a poisoned step (nan, inf) is a bit-exact no-op on
  params, updater state and BatchNorm's running stats; a spike stays
  finite and is not skipped.  (The reference's own two bit-identity
  tests fail, ROADMAP §C2; the port is held to its own.)
- Against the JAX guard on the same weights, batches and poison
  schedule: the dynamic scale after every step and ``nonfinite_total``
  equal, the params within the train tolerance (``rtol=1e-4,
  atol=1e-5``).
- The scale state checkpoints and resumes; the sentinel escalates from
  backoff to rewind and, without a manager, downgrades to backoff; a
  resumed run does not recount non-finite steps; a poisoned TBPTT window
  starts the next from zero carries; the stability health rules; the
  policy's validation and JSON round trip match the reference's.

The data-parallel masters' poison masking waits for ROADMAP A10.
"""

import tempfile

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import serialization as jax_serialization
from deeplearning4j_tpu.models.sequential import (
    MultiLayerNetwork as JaxMultiLayerNetwork,
)
from deeplearning4j_tpu.nn import layers as jlayers
from deeplearning4j_tpu.nn.conf import (
    NeuralNetConfiguration as JNNC, TrainingStability as JaxStability,
)
from deeplearning4j_tpu.resilience import (
    FaultInjector as JaxInjector, inject_faults as jax_inject,
)
from deeplearning4j_tpu.resilience import stability as jax_stability
from deeplearning4j_tpu_torch.models import serialization
from deeplearning4j_tpu_torch.models.common import tree_paths
from deeplearning4j_tpu_torch.models.graph import ComputationGraph
from deeplearning4j_tpu_torch.models.sequential import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.conf import (
    MultiLayerConfiguration, NeuralNetConfiguration, TrainingStability,
)
from deeplearning4j_tpu_torch.nn.layers import (
    BatchNormalization, DenseLayer, GravesLSTM, OutputLayer, RnnOutputLayer,
)
from deeplearning4j_tpu_torch.observability import (
    FlightRecorder, HealthEvaluator, HealthRule, get_flight_recorder,
    get_registry, set_flight_recorder,
)
from deeplearning4j_tpu_torch.observability.metrics import MetricsRegistry
from deeplearning4j_tpu_torch.resilience import (
    CheckpointManager, FaultInjector, inject_faults, stability,
)

RTOL_FIT, ATOL_FIT = 1e-4, 1e-5
KEY = stability.STATE_KEY


def _mln(stab=None, seed=12345, updater="adam", lr=0.01, bn=True):
    b = (NeuralNetConfiguration.builder().seed(seed)
         .updater(updater, learning_rate=lr))
    if stab is not None:
        b.training_stability(stab)
    lb = b.list().layer(DenseLayer(n_in=6, n_out=10, activation="tanh"))
    if bn:
        lb = lb.layer(BatchNormalization(n_out=10))
    conf = lb.layer(OutputLayer(n_in=10, n_out=3, loss="mcxent",
                                activation="softmax")).build()
    return MultiLayerNetwork(conf).init(device="cpu")


def _graph(stab=None, seed=7):
    b = (NeuralNetConfiguration.builder().seed(seed)
         .updater("adam", learning_rate=0.01))
    if stab is not None:
        b.training_stability(stab)
    conf = (b.graph().add_inputs("in")
            .add_layer("d", DenseLayer(n_in=6, n_out=10,
                                       activation="tanh"), "in")
            .add_layer("bn", BatchNormalization(n_out=10), "d")
            .add_layer("out", OutputLayer(n_in=10, n_out=3, loss="mcxent",
                                          activation="softmax"), "bn")
            .set_outputs("out").build())
    return ComputationGraph(conf).init(device="cpu")


FACADES = {"MultiLayerNetwork": _mln, "ComputationGraph": _graph}


def _batches(n, bs, seed=0):
    rs = np.random.RandomState(seed)
    return [(rs.randn(bs, 6).astype(np.float32),
             np.eye(3, dtype=np.float32)[rs.randint(0, 3, bs)])
            for _ in range(n)]


def _state(net):
    """Every tensor the step writes but the stability state, cloned."""
    upd = {k: v for k, v in net.updater_state.items() if k != KEY}
    return [(p, t.clone()) for tree in (net.params, upd, net.net_state)
            for p, t in tree_paths(tree)]


def _equal(a, b):
    assert [p for p, _ in a] == [p for p, _ in b]
    for (p, x), (_, y) in zip(a, b):
        assert torch.equal(x, y), p


def _stab(net, name):
    return float(net.updater_state[KEY][name])


@pytest.fixture(autouse=True)
def fresh_recorder():
    set_flight_recorder(FlightRecorder())
    yield
    set_flight_recorder(FlightRecorder())


def _events(kind, **attrs):
    return [ev for ev in get_flight_recorder().events() if ev.kind == kind
            and all(ev.attrs.get(k) == v for k, v in attrs.items())]


def _counter(name, **labels):
    fam = get_registry().get(name)
    if fam is None:
        return 0.0
    return sum(child.value for pairs, child in fam.samples()
               if all(dict(pairs).get(k) == v for k, v in labels.items()))


# ------------------------------------------------------- the port's identity
@pytest.mark.parametrize("facade", sorted(FACADES))
@pytest.mark.parametrize("scaling", ["none", "static"])
def test_guarded_healthy_run_is_bit_identical(facade, scaling):
    build = FACADES[facade]
    batches = _batches(6, 6, seed=1)
    plain = build()
    plain.fit(batches)
    stab = TrainingStability(check_every=100, loss_scaling=scaling,
                             loss_scale=2.0 ** 10)
    guarded = build(stab=stab)
    guarded.fit(batches)
    _equal(_state(plain), _state(guarded))
    want = 2.0 ** 10 if scaling == "static" else 1.0
    assert _stab(guarded, "loss_scale") == want
    assert _stab(guarded, "nonfinite_total") == 0.0


@pytest.mark.parametrize("facade", sorted(FACADES))
@pytest.mark.parametrize("mode", ["nan", "inf"])
def test_poisoned_step_is_bitexact_noop(facade, mode):
    build = FACADES[facade]
    batches = _batches(6, 6, seed=2)
    net = build(stab=TrainingStability(check_every=100))
    net.fit(batches[:3])
    before = _state(net)
    inj = FaultInjector(seed=3).poison_gradients("0", at_step=3,
                                                 until_step=4, mode=mode)
    with inject_faults(inj):
        net.fit([batches[3]])
    assert inj.injected[0]["kind"] == "worker_poisoned"
    _equal(before, _state(net))
    assert net.iteration == 4
    assert _stab(net, "nonfinite_total") == 1.0
    # the unguarded contrast run is poisoned by the same batch
    plain = build()
    with inject_faults(FaultInjector(seed=3).poison_gradients(
            "0", at_step=3, until_step=4, mode=mode)):
        plain.fit(batches[:4])
    assert not np.isfinite(plain.params_to_vector()).all()


def test_poison_of_tensor_inputs():
    """Features given as tensors are poisoned where they lie, before
    staging, as numpy ones are: the same no-op and count."""
    batches = [(torch.from_numpy(x), torch.from_numpy(y))
               for x, y in _batches(5, 6, seed=2)]
    net = _mln(stab=TrainingStability(check_every=100))
    net.fit(batches[:3])
    before = _state(net)
    with inject_faults(FaultInjector().poison_gradients(
            "0", at_step=3, until_step=4)):
        net.fit([batches[3]])
    _equal(before, _state(net))
    assert _stab(net, "nonfinite_total") == 1.0
    assert torch.isfinite(batches[3][0]).all()     # the caller's untouched


def test_spike_stays_finite_and_is_not_skipped():
    net = _mln(stab=TrainingStability(check_every=100))
    inj = FaultInjector().poison_gradients("0", at_step=1, until_step=2,
                                           mode="spike")
    with inject_faults(inj):
        net.fit(_batches(4, 6, seed=3))
    assert np.isfinite(net.params_to_vector()).all()
    assert _stab(net, "nonfinite_total") == 0.0


def test_poisoned_tbptt_window_restarts_from_zero_carries():
    """A non-finite TBPTT window leaves params untouched and hands the
    next window zero carries, not NaN."""
    def build():
        return MultiLayerNetwork(
            (NeuralNetConfiguration.builder().seed(17)
             .updater("sgd", learning_rate=0.1)
             .training_stability(check_every=100).list()
             .layer(GravesLSTM(n_in=3, n_out=6))
             .layer(RnnOutputLayer(n_in=6, n_out=3, loss="mcxent",
                                   activation="softmax"))
             .backprop_type("truncated_bptt", fwd_length=4,
                            back_length=4).build())).init(device="cpu")

    rs = np.random.RandomState(4)
    x = rs.rand(2, 12, 3).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, (2, 12))]
    net = build()
    with inject_faults(FaultInjector().poison_gradients(
            "0", at_step=1, until_step=2)):
        net.fit(x, y)
    assert net.iteration == 3
    assert _stab(net, "nonfinite_total") == 1.0
    assert np.isfinite(net.params_to_vector()).all()
    # window 3 started from zeros: the same as a net whose window 2 did
    # not run and whose window 3 ran on fresh carries
    ref = build()
    ref.fit(x[:, :4], y[:, :4])
    ref.fit(x[:, 8:], y[:, 8:])
    np.testing.assert_array_equal(net.params_to_vector(),
                                  ref.params_to_vector())


# --------------------------------------------------------- against the JAX
def _jax_net(stab, seed=9):
    conf = (JNNC.builder().seed(seed).updater("nesterovs", learning_rate=0.05)
            .training_stability(stab).list()
            .layer(jlayers.DenseLayer(n_in=6, n_out=10, activation="tanh"))
            .layer(jlayers.BatchNormalization(n_out=10))
            .layer(jlayers.OutputLayer(n_in=10, n_out=3, loss="mcxent",
                                       activation="softmax")).build())
    return JaxMultiLayerNetwork(conf).init()


def test_dynamic_scale_sequence_matches_jax(tmp_path):
    """One zip, one poison schedule (nan at 2, inf at 5, nan at 6): the
    scale after every step and the non-finite count equal the JAX
    guard's; the params agree within the train tolerance."""
    kw = dict(loss_scaling="dynamic", loss_scale=2.0 ** 8,
              loss_scale_growth_interval=2, check_every=100)
    jnet = _jax_net(JaxStability(**kw))
    path = tmp_path / "w.zip"
    jax_serialization.write_model(jnet, str(path))
    net = serialization.load_model(path, device="cpu")
    assert net.conf.stability["loss_scaling"] == "dynamic"
    batches = _batches(10, 6, seed=6)

    def schedule(inj):
        inj.poison_gradients("0", at_step=2, until_step=3)
        inj.poison_gradients("0", at_step=5, until_step=6, mode="inf")
        inj.poison_gradients("0", at_step=6, until_step=7)
        return inj

    jscales, scales = [], []
    with jax_inject(schedule(JaxInjector())):
        for x, y in batches:
            jnet.fit(x, y)
            jscales.append(float(np.asarray(
                jnet.updater_state[jax_stability.STATE_KEY]["loss_scale"])))
    with inject_faults(schedule(FaultInjector())):
        for x, y in batches:
            net.fit(x, y)
            scales.append(_stab(net, "loss_scale"))
    assert scales == jscales
    assert len(set(scales)) > 2                     # grew and halved
    jst = jnet.updater_state[jax_stability.STATE_KEY]
    assert _stab(net, "nonfinite_total") == float(
        np.asarray(jst["nonfinite_total"])) == 3.0
    assert _stab(net, "growth_streak") == float(
        np.asarray(jst["growth_streak"]))
    np.testing.assert_allclose(net.params_to_vector(),
                               np.asarray(jnet.params_to_vector()),
                               rtol=RTOL_FIT, atol=ATOL_FIT)


def test_dynamic_loss_scale_grows_and_halves():
    stab = TrainingStability(loss_scaling="dynamic", loss_scale=2.0 ** 8,
                             loss_scale_growth_interval=3, check_every=100)
    net = _mln(stab=stab)
    net.fit(_batches(7, 6, seed=6))
    assert _stab(net, "loss_scale") == 2.0 ** 10
    with inject_faults(FaultInjector().poison_gradients(
            "0", at_step=7, until_step=8, mode="inf")):
        net.fit(_batches(1, 6, seed=7))
    assert _stab(net, "loss_scale") == 2.0 ** 9


# ------------------------------------------------- checkpoint and sentinel
def test_scale_state_checkpoints_and_resumes():
    stab = TrainingStability(loss_scaling="dynamic", loss_scale=2.0 ** 8,
                             loss_scale_growth_interval=2, check_every=100)
    with tempfile.TemporaryDirectory() as tmp:
        cm = CheckpointManager(tmp, save_every_steps=2, async_save=False,
                               registry=MetricsRegistry())
        net = _mln(stab=stab)
        net.fit(_batches(6, 6, seed=8), checkpoint_manager=cm)
        fresh = _mln(stab=stab)
        cm.restore(fresh)
        assert fresh.iteration == net.iteration == 6
        for name in ("loss_scale", "growth_streak", "lr_scale",
                     "nonfinite_total"):
            assert _stab(fresh, name) == _stab(net, name)
        cm.close()


def test_sentinel_escalates_backoff_then_rewind_and_resumes_past_failure():
    stab = TrainingStability(check_every=2, nonfinite_streak=2,
                             rewind_cooldown_checks=6)
    batches = _batches(40, 8, seed=9)
    net = _mln(stab=stab)
    with tempfile.TemporaryDirectory() as tmp:
        cm = CheckpointManager(tmp, keep=4, save_every_steps=4,
                               async_save=False, registry=MetricsRegistry())
        net.fit(batches[:8], checkpoint_manager=cm)
        with inject_faults(FaultInjector().poison_gradients(
                "0", at_step=8, until_step=20)):
            net.fit(batches[8:], checkpoint_manager=cm)
        cm.close()
    assert _events("divergence_backoff", component="MultiLayerNetwork")
    rewinds = _events("divergence_rewind", component="MultiLayerNetwork")
    assert rewinds and rewinds[0].attrs["to_step"] <= 8
    assert net.iteration > 20
    assert np.isfinite(net.params_to_vector()).all()
    assert _stab(net, "lr_scale") < 1.0


def test_rewind_without_checkpoint_manager_downgrades_to_backoff():
    stab = TrainingStability(check_every=1, nonfinite_streak=1,
                             rewind_cooldown_checks=1, lr_backoff=0.5)
    net = _mln(stab=stab)
    with inject_faults(FaultInjector().poison_gradients("0", at_step=0)):
        net.fit(_batches(6, 6, seed=10))
    assert _stab(net, "lr_scale") < 0.5     # at least two backoffs
    assert not _events("divergence_rewind", component="MultiLayerNetwork")
    assert np.isfinite(net.params_to_vector()).all()


def test_resumed_run_does_not_recount_checkpointed_nonfinite():
    stab = TrainingStability(check_every=1, nonfinite_streak=1)
    with tempfile.TemporaryDirectory() as tmp:
        cm = CheckpointManager(tmp, save_every_steps=2, async_save=False,
                               registry=MetricsRegistry())
        net = _mln(stab=stab)
        with inject_faults(FaultInjector().poison_gradients(
                "0", at_step=1, until_step=2)):
            net.fit(_batches(4, 6, seed=20), checkpoint_manager=cm)
        total0 = _counter("dl4j_nonfinite_steps_total",
                          component="MultiLayerNetwork")
        backoffs0 = _counter("dl4j_divergence_backoffs_total",
                             component="MultiLayerNetwork")
        net2 = _mln(stab=stab)
        net2.fit(_batches(8, 6, seed=21), checkpoint_manager=CheckpointManager(
            tmp, async_save=False, registry=MetricsRegistry()))
        assert net2.iteration > 4
        assert _counter("dl4j_nonfinite_steps_total",
                        component="MultiLayerNetwork") == total0
        assert _counter("dl4j_divergence_backoffs_total",
                        component="MultiLayerNetwork") == backoffs0
        cm.close()


def test_spike_mode_trips_the_sentinel(tmp_path):
    """A finite loss spike escalates through the spike path, in the port
    as in the JAX guard, on one zip's weights.  The dense layer is linear
    so that the spiked features reach the logits (behind a tanh they
    saturate and the loss stays within 2x; the reference's own case
    passes only on flight events that earlier tests left, ROADMAP
    §C2)."""
    from deeplearning4j_tpu import observability as jax_obs

    stab = dict(check_every=1, spike_factor=5.0, spike_patience=2)
    jconf = (JNNC.builder().seed(12345).updater("adam", learning_rate=0.01)
             .training_stability(JaxStability(**stab)).list()
             .layer(jlayers.DenseLayer(n_in=6, n_out=10,
                                       activation="identity"))
             .layer(jlayers.OutputLayer(n_in=10, n_out=3, loss="mcxent",
                                        activation="softmax")).build())
    jnet = JaxMultiLayerNetwork(jconf).init()
    jax_serialization.write_model(jnet, str(tmp_path / "w.zip"))
    net = serialization.load_model(tmp_path / "w.zip", device="cpu")
    old = jax_obs.get_flight_recorder()
    jax_obs.set_flight_recorder(jax_obs.FlightRecorder())
    try:
        for n, inj, ctx in ((jnet, JaxInjector, jax_inject),
                            (net, FaultInjector, inject_faults)):
            n.fit(_batches(6, 6, seed=11))
            with ctx(inj().poison_gradients("0", at_step=6, mode="spike")):
                n.fit(_batches(6, 6, seed=12))
        jax_events = [ev for ev in jax_obs.get_flight_recorder().events()
                      if ev.kind == "divergence_backoff"]
    finally:
        jax_obs.set_flight_recorder(old)
    mine = _events("divergence_backoff", component="MultiLayerNetwork")
    assert mine and len(mine) == len(jax_events)
    assert [e.attrs["step"] for e in mine] == [e.attrs["step"]
                                               for e in jax_events]
    assert _stab(net, "nonfinite_total") == 0.0


def test_stability_health_rules():
    reg = MetricsRegistry()
    rt = stability.StabilityRuntime(
        "hr", TrainingStability(check_every=1), registry=reg)
    ev = HealthEvaluator([HealthRule("nf", "max_nonfinite_steps", 2),
                          HealthRule("rw", "max_divergence_rewinds", 0)],
                         component="hr_test", registry=reg)
    assert ev.evaluate().healthy
    rt._publish(3.0, 1.0)
    verdict = ev.evaluate()
    assert not verdict.healthy
    assert verdict.failing[0]["observed"] == 3.0


# ----------------------------------------------------------------- policy
@pytest.mark.parametrize("kwargs,match", [
    ({"loss_scaling": "bogus"}, "loss_scaling"),
    ({"lr_backoff": 1.5}, "lr_backoff"),
    ({"loss_scale_factor": 1.0}, "loss_scale_factor"),
    ({"check_every": 0}, "check_every"),
    ({"loss_scale": 0.0}, "loss scales"),
])
def test_policy_validation_matches_reference(kwargs, match):
    for cls in (TrainingStability, JaxStability):
        with pytest.raises(ValueError, match=match):
            cls(**kwargs)


def test_policy_json_round_trip_matches_reference():
    stab = dict(loss_scaling="dynamic", check_every=7)
    conf = (NeuralNetConfiguration.builder()
            .training_stability(TrainingStability(**stab)).list()
            .layer(DenseLayer(n_in=4, n_out=4, activation="relu"))
            .layer(OutputLayer(n_in=4, n_out=2, loss="mcxent",
                               activation="softmax")).build())
    jconf = (JNNC.builder().training_stability(JaxStability(**stab)).list()
             .layer(jlayers.DenseLayer(n_in=4, n_out=4, activation="relu"))
             .layer(jlayers.OutputLayer(n_in=4, n_out=2, loss="mcxent",
                                        activation="softmax")).build())
    back = MultiLayerConfiguration.from_json(conf.to_json())
    assert stability.policy_of(back) == TrainingStability(**stab)
    assert back.stability == jconf.stability.to_dict()
    with pytest.raises(ValueError, match="takes no kwargs"):
        NeuralNetConfiguration.builder().training_stability(
            False, check_every=3)


# ------------------------------------------------ the captured step (emulated)
def test_guard_in_the_captured_step(monkeypatch):
    """The card's capture emulated on the CPU (``test_torch_tbptt``'s
    fake graph that reruns the recorded body): poisoned steps, dynamic
    scaling and the sentinel's in-place LR backoff all run through one
    captured program, replayed, equal to the eager run bit for bit."""
    from tests.test_torch_tbptt import _emulate_capture

    stab = TrainingStability(loss_scaling="dynamic", loss_scale=2.0 ** 8,
                             loss_scale_growth_interval=2, check_every=2,
                             nonfinite_streak=1)
    net, eager = _mln(stab=stab), _mln(stab=stab)
    _emulate_capture(monkeypatch, net)
    batches = _batches(8, 6, seed=13)
    for n in (net, eager):
        inj = FaultInjector().poison_gradients("0", at_step=2, until_step=3)
        inj.poison_gradients("0", at_step=5, until_step=6, mode="inf")
        with inject_faults(inj):
            for x, y in batches:
                n.fit(x, y)
    assert net.score_value == eager.score_value
    _equal(_state(net), _state(eager))
    for name in ("loss_scale", "growth_streak", "lr_scale",
                 "nonfinite_total"):
        assert _stab(net, name) == _stab(eager, name)
    assert _stab(net, "nonfinite_total") == 2.0
    assert _stab(net, "lr_scale") < 1.0          # a backoff landed
    graphs = net._step_graphs
    assert (graphs.captures, graphs.replays) == (1, 7)
