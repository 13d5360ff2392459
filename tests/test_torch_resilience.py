"""The port's resilience (``deeplearning4j_tpu_torch/resilience/`` and
``parallel/checkpoint.py``) on the CPU: the reference's
``tests/test_resilience.py`` cases over the port, on both facades, and
the port against the JAX package.

- ``CheckpointManager``: the commit layout, keep-N with archival,
  ``latest()`` skipping torn and corrupt snapshots, the wall-clock and
  priority triggers, the async writer, the staleness gauge and its
  health rule, labels that do not collide.
- A writer killed between files, a fatal step fault then auto-resume, a
  transient fault retried in place (the key stream set back), a
  preemption that commits a priority checkpoint and resumes, on
  ``MultiLayerNetwork`` and ``ComputationGraph``: each equals the
  uninterrupted run bit for bit.  The skip is counted in iterations
  (``num_iterations > 1``, TBPTT windows).
- What the port adds: a restore writes into the net's tensors in place;
  an error raised by the step itself is not retried (``StepStateLost``).
- Against JAX: a step directory written by the JAX ``CheckpointManager``
  restores into the port with params, updater state and layer state
  exactly equal; a crash-and-resume run of the port equals the JAX one
  within the train parity tolerance (``rtol=1e-4, atol=1e-5``).

The data-parallel masters' cases and ``AsyncDataSetIterator``'s wait for
ROADMAP A10 and A8.  Preemption is driven with ``trigger()`` where the
reference used a listener (listeners come with A8).
"""

import json
import os
import signal
import time

import numpy as np
import pytest

from deeplearning4j_tpu.models import serialization as jax_serialization
from deeplearning4j_tpu.models.sequential import (
    MultiLayerNetwork as JaxMultiLayerNetwork,
)
from deeplearning4j_tpu.nn import layers as jlayers
from deeplearning4j_tpu.resilience import (
    CheckpointManager as JaxCheckpointManager, FaultInjector as JaxInjector,
    InjectedFault as JaxInjectedFault, inject_faults as jax_inject,
)
from deeplearning4j_tpu_torch.models import serialization
from deeplearning4j_tpu_torch.models.common import tree_leaves, tree_paths
from deeplearning4j_tpu_torch.models.graph import ComputationGraph
from deeplearning4j_tpu_torch.models.sequential import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.layers import (
    DenseLayer, GravesLSTM, OutputLayer, RnnOutputLayer,
)
from deeplearning4j_tpu_torch.observability import (
    HealthEvaluator, HealthRule, MetricsRegistry,
)
from deeplearning4j_tpu_torch.parallel import (
    restore_checkpoint, save_checkpoint,
)
from deeplearning4j_tpu_torch.resilience import (
    CheckpointManager, FaultInjector, InjectedFault, PreemptionHandler,
    RetryPolicy, StepStateLost, TransientError, inject_faults, is_transient,
)

RTOL_FIT, ATOL_FIT = 1e-4, 1e-5


# ---------------------------------------------------------------- helpers
def _mln(seed=21, iterations=1):
    return MultiLayerNetwork(
        (NeuralNetConfiguration.builder().seed(seed)
         .updater("adam", learning_rate=0.05).iterations(iterations).list()
         .layer(DenseLayer(n_in=8, n_out=16, activation="relu"))
         .layer(OutputLayer(n_in=16, n_out=4)).build())
    ).init(device="cpu")


def _graph(seed=7):
    conf = (NeuralNetConfiguration.builder().seed(seed)
            .updater("adam", learning_rate=0.05).graph()
            .add_inputs("in")
            .add_layer("d", DenseLayer(n_in=8, n_out=16,
                                       activation="relu"), "in")
            .add_layer("out", OutputLayer(n_in=16, n_out=4), "d")
            .set_outputs("out").build())
    return ComputationGraph(conf).init(device="cpu")


FACADES = {"MultiLayerNetwork": _mln, "ComputationGraph": _graph}


def _batches(n_batches=6, batch=8, seed=0):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n_batches):
        x = rs.rand(batch, 8).astype(np.float32)
        y = np.eye(4, dtype=np.float32)[rs.randint(0, 4, batch)]
        out.append((x, y))
    return out


def _reference(build, batches):
    ref = build()
    for x, y in batches:
        ref.fit(x, y)
    return ref


def _same(a, b):
    """Every param bit for bit."""
    np.testing.assert_array_equal(a.params_to_vector(), b.params_to_vector())


def _cm(path, **kw):
    kw.setdefault("registry", MetricsRegistry())
    return CheckpointManager(str(path), **kw)


# ===================================================== CheckpointManager
class TestCheckpointManager:
    def test_commit_layout_and_latest(self, tmp_path):
        net = _mln()
        net.fit(*_batches(1)[0])
        cm = _cm(tmp_path, async_save=False)
        cm.save(net)
        path = cm.latest()
        assert path is not None and path.endswith("step-00000001")
        commit = json.load(open(os.path.join(path, "COMMIT")))
        assert commit["step"] == 1 and set(commit["files"]) >= {
            "shards-0.npz", "manifest-0.json", "checkpoint.json"}
        meta = json.load(open(os.path.join(path, "checkpoint.json")))
        assert meta["format_version"] == 1 and meta["iteration"] == 1
        assert "torch_key_state" in meta
        net.fit(*_batches(1, seed=1)[0])
        cm.save(net)
        assert cm.latest_step() == 2

    def test_keep_n_retention_with_archival(self, tmp_path):
        net = _mln()
        cm = _cm(tmp_path, keep=2, archive_every_steps=3, async_save=False)
        for x, y in _batches(7):
            net.fit(x, y)
            cm.save(net)
        assert cm.all_steps() == [3, 6, 7]

    def test_latest_skips_torn_and_corrupt(self, tmp_path):
        net = _mln()
        cm = _cm(tmp_path, keep=5, async_save=False)
        for x, y in _batches(3):
            net.fit(x, y)
            cm.save(net)
        assert cm.latest_step() == 3
        inj = FaultInjector(seed=5)
        inj.corrupt_checkpoint(cm._step_dir(3), mode="truncate")
        assert cm.latest_step() == 2
        inj.corrupt_checkpoint(cm._step_dir(2), mode="corrupt")
        assert cm.latest_step() == 1
        inj.corrupt_checkpoint(cm._step_dir(1), mode="drop_commit")
        assert cm.latest() is None

    def test_wall_clock_trigger_and_priority(self, tmp_path):
        net = _mln()
        net.fit(*_batches(1)[0])
        cm = _cm(tmp_path, save_every_seconds=3600, async_save=False)
        assert cm.due(net.iteration) is None
        cm._last_mark_time -= 3601
        assert cm.due(net.iteration) == "time_interval"
        cm.request_priority_save()
        assert cm.due(net.iteration) == "priority"
        assert cm.maybe_save(net) == "priority"
        assert cm.latest_step() == 1
        assert cm.due(net.iteration) is None

    def test_async_save_commits_off_thread(self, tmp_path):
        net = _mln()
        net.fit(*_batches(1)[0])
        reg = MetricsRegistry()
        with CheckpointManager(str(tmp_path), registry=reg) as cm:
            job = cm.save(net)
            job.wait(timeout=30)
            assert cm.latest_step() == 1
            assert reg.get_value("dl4j_checkpoint_saves_total",
                                 trigger="explicit") == 1
            assert reg.get_value("dl4j_checkpoint_last_bytes") > 0

    def test_snapshot_is_a_host_copy(self, tmp_path):
        """A snapshot holds copies: a step after it (which writes the
        params in place) does not change what the writer commits."""
        net = _mln()
        net.fit(*_batches(1)[0])
        want = net.params_to_vector()
        cm = _cm(tmp_path, async_save=False)
        from deeplearning4j_tpu_torch.parallel import snapshot_trees

        snap = snapshot_trees(net)
        net.fit(*_batches(1, seed=1)[0])
        from deeplearning4j_tpu_torch.resilience.checkpoint_manager import (
            _Job,
        )

        cm._run_job(_Job(1, snap, "explicit"))   # the older snapshot
        fresh = _mln(seed=99)
        cm.restore(fresh, step=1)
        np.testing.assert_array_equal(fresh.params_to_vector(), want)

    def test_staleness_gauge_and_health_rule(self, tmp_path):
        reg = MetricsRegistry()
        cm = CheckpointManager(str(tmp_path), async_save=False, registry=reg)
        rule = HealthRule("ckpt_staleness", "max_checkpoint_staleness", 3600)
        assert HealthEvaluator([rule], registry=reg).evaluate().healthy
        cm._start_mono -= 7200
        verdict = HealthEvaluator([rule], registry=reg).evaluate()
        assert not verdict.healthy
        assert verdict.failing[0]["name"] == "ckpt_staleness"
        net = _mln()
        net.fit(*_batches(1)[0])
        cm.save(net)
        assert HealthEvaluator([rule], registry=reg).evaluate().healthy

    def test_staleness_gauge_labels_do_not_collide(self, tmp_path):
        reg = MetricsRegistry()
        a = CheckpointManager(str(tmp_path / "run1" / "best"),
                              async_save=False, registry=reg)
        b = CheckpointManager(str(tmp_path / "run2" / "best"),
                              async_save=False, registry=reg)
        assert a.label != b.label
        net = _mln()
        net.fit(*_batches(1)[0])
        a.save(net)
        sa = reg.get_value("dl4j_checkpoint_staleness_seconds",
                           directory=a.label)
        sb = reg.get_value("dl4j_checkpoint_staleness_seconds",
                           directory=b.label)
        assert sa is not None and sb is not None and sa != sb

    def test_mesh_waits_for_a10(self, tmp_path):
        """A10 is ported: ``mesh=`` restores onto a slot mesh (the values
        into the net's own tensors), and a mesh across several devices
        raises, naming the next A10 slice."""
        import torch

        from deeplearning4j_tpu_torch.backend import mesh as tmesh

        net = _mln()
        save_checkpoint(str(tmp_path), net)
        other = _mln()
        with torch.no_grad():
            for layer in other.params.values():
                for t in layer.values():
                    t.zero_()
        own = other.params["layer_0"]["W"]
        restore_checkpoint(str(tmp_path), other,
                           mesh=tmesh.default_mesh(devices=["cpu"] * 4))
        assert other.params["layer_0"]["W"] is own
        np.testing.assert_array_equal(other.params_to_vector(),
                                      net.params_to_vector())
        with pytest.raises(NotImplementedError, match="A10"):
            tmesh.default_mesh(devices=["cpu", "meta"])


# ============================================================ crash-mid-save
class TestCrashMidSave:
    def test_writer_killed_between_shard_files(self, tmp_path):
        batches = _batches(6)
        ref = _reference(_mln, batches)
        inj = FaultInjector(seed=7).crash_after_files(9)
        reg = MetricsRegistry()
        net = _mln()
        cm = CheckpointManager(str(tmp_path), keep=10, save_every_steps=1,
                               fault_injector=inj, registry=reg)
        net.fit(batches, checkpoint_manager=cm)
        cm.wait_idle()
        assert inj.injected and inj.injected[0]["kind"] == "writer_crash"
        assert net.iteration == 6
        assert reg.get_value("dl4j_checkpoint_failures_total",
                             stage="write") == 1
        assert 3 not in cm.all_steps()
        resumed = _mln(seed=99)
        cm2 = _cm(tmp_path, keep=10)
        resumed.fit(batches, checkpoint_manager=cm2)
        assert resumed.iteration == 6
        _same(ref, resumed)
        cm.close()
        cm2.close()


# ========================================================== injected crashes
@pytest.mark.parametrize("facade", sorted(FACADES))
class TestCrashResume:
    def test_fatal_crash_then_auto_resume_equivalence(self, tmp_path,
                                                      facade):
        build = FACADES[facade]
        batches = _batches(6)
        ref = _reference(build, batches)
        net = build()
        cm = _cm(tmp_path, keep=10, save_every_steps=1, async_save=False)
        with inject_faults(FaultInjector().fail_at_step(
                3, component=facade, transient=False)):
            with pytest.raises(InjectedFault):
                net.fit(batches, checkpoint_manager=cm)
        assert net.iteration == 3 and cm.latest_step() == 3
        resumed = build()
        before = [t for _, t in tree_paths(resumed.params)]
        resumed.fit(batches, checkpoint_manager=cm)
        assert resumed.iteration == 6
        # the restore wrote into the net's tensors: none was replaced
        assert all(a is b for a, b in zip(
            before, [t for _, t in tree_paths(resumed.params)]))
        _same(ref, resumed)

    def test_transient_crash_retried_in_place(self, tmp_path, facade):
        build = FACADES[facade]
        batches = _batches(6)
        ref = _reference(build, batches)
        reg = MetricsRegistry()
        net = build()
        rp = RetryPolicy(max_retries=2, base_delay_s=0.0, jitter=0.0,
                         seed=1, component="fit", registry=reg)
        with inject_faults(FaultInjector().fail_at_step(
                2, component=facade, transient=True)):
            net.fit(batches, retry_policy=rp)
        assert net.iteration == 6
        assert rp.retries == 1
        assert reg.get_value("dl4j_step_retries_total", component="fit") == 1
        _same(ref, net)

    def test_preemption_checkpoints_and_resumes(self, tmp_path, facade):
        """A preemption requested before the fourth batch stops the fit
        at that boundary with a priority checkpoint; a fresh net resumes
        to the uninterrupted run's params."""
        build = FACADES[facade]
        batches = _batches(6)
        ref = _reference(build, batches)
        reg = MetricsRegistry()
        cm = _cm(tmp_path, keep=10, async_save=False)
        net = build()
        with PreemptionHandler(cm, registry=reg) as handler:
            def stream():
                for i, b in enumerate(batches):
                    if i == 3:
                        handler.trigger()
                    yield b

            net.fit(stream(), checkpoint_manager=cm)
            assert handler.stop_requested
        assert net.iteration == 3 and cm.latest_step() == 3
        assert cm.read_commit(cm.latest())["trigger"] in ("priority",
                                                          "preempt")
        assert reg.get_value("dl4j_preemptions_total",
                             signal="SIGTERM") == 1
        resumed = build()
        resumed.fit(batches, checkpoint_manager=cm)
        assert resumed.iteration == 6
        _same(ref, resumed)

    def test_graph_and_list_single_pair_path_saves_on_interval(
            self, tmp_path, facade):
        net = FACADES[facade]()
        cm = _cm(tmp_path, keep=10, save_every_steps=2, async_save=False,
                 auto_resume=False)
        for x, y in _batches(4):
            net.fit(x, y, checkpoint_manager=cm)
        assert net.iteration == 4
        assert cm.all_steps() == [2, 4]


def test_step_error_is_not_retried(tmp_path):
    """An error raised by the step itself (after staging began) is not
    retried in place: ``StepStateLost``, chained to the original."""
    net = _mln()
    rp = RetryPolicy(max_retries=3, base_delay_s=0.0, jitter=0.0,
                     registry=MetricsRegistry())
    calls = []

    def broken(inputs):
        calls.append(1)
        raise ConnectionError("device link reset")

    net._step = broken
    with pytest.raises(StepStateLost) as ei:
        net.fit(_batches(2), retry_policy=rp)
    assert isinstance(ei.value.__cause__, ConnectionError)
    assert len(calls) == 1 and rp.retries == 0


def test_preemption_without_signal_runs_normally():
    net = _mln()
    net.fit(_batches(2))
    assert net.iteration == 2


# ================================================================ retry unit
class TestRetryPolicy:
    def test_classification(self):
        assert is_transient(TransientError("x"))
        assert is_transient(ConnectionError("x"))
        assert is_transient(RuntimeError("RESOURCE_EXHAUSTED: hbm"))
        assert is_transient(RuntimeError("backend UNAVAILABLE"))
        assert not is_transient(ValueError("bad shape"))
        assert not is_transient(KeyboardInterrupt())
        assert not is_transient(RuntimeError("NaN loss"))
        assert not is_transient(StepStateLost("x"))

    def test_backoff_deterministic_and_bounded(self):
        a = RetryPolicy(base_delay_s=1.0, max_delay_s=4.0, jitter=0.25,
                        seed=42, sleep=lambda s: None)
        b = RetryPolicy(base_delay_s=1.0, max_delay_s=4.0, jitter=0.25,
                        seed=42, sleep=lambda s: None)
        da = [a.delay(i) for i in range(6)]
        assert da == [b.delay(i) for i in range(6)]
        assert all(d <= 4.0 * 1.25 for d in da)
        assert da[1] > da[0] * 0.5

    def test_retries_then_succeeds(self):
        reg = MetricsRegistry()
        slept = []
        rp = RetryPolicy(max_retries=3, base_delay_s=0.01, seed=0,
                         component="unit", sleep=slept.append, registry=reg)
        calls = {"n": 0}

        def flaky():
            calls["n"] += 1
            if calls["n"] < 3:
                raise TransientError("blip")
            return "ok"

        assert rp.run(flaky) == "ok"
        assert calls["n"] == 3 and len(slept) == 2
        assert reg.get_value("dl4j_step_retries_total",
                             component="unit") == 2

    def test_fatal_not_retried_and_budget_exhausts(self):
        reg = MetricsRegistry()
        rp = RetryPolicy(max_retries=2, base_delay_s=0.0, component="unit",
                         sleep=lambda s: None, registry=reg)
        with pytest.raises(ValueError):
            rp.run(lambda: (_ for _ in ()).throw(ValueError("bug")))
        assert reg.get_value("dl4j_step_retries_total",
                             component="unit") is None

        def always():
            raise TransientError("down")

        with pytest.raises(TransientError):
            rp.run(always)
        assert reg.get_value("dl4j_retry_exhausted_total",
                             component="unit") == 1
        assert reg.get_value("dl4j_step_retries_total",
                             component="unit") == 2


# ====================================================== skip granularity
def _lstm_net(seed):
    return MultiLayerNetwork(
        (NeuralNetConfiguration.builder().seed(seed)
         .updater("sgd", learning_rate=0.1).list()
         .layer(GravesLSTM(n_in=3, n_out=6))
         .layer(RnnOutputLayer(n_in=6, n_out=3, loss="mcxent",
                               activation="softmax"))
         .backprop_type("truncated_bptt", fwd_length=4,
                        back_length=4).build())).init(device="cpu")


def _seq_batches(n, seed):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        x = rs.rand(2, 12, 3).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, (2, 12))]
        out.append((x, y))
    return out


class TestSkipGranularity:
    def test_num_iterations_gt_1_resume_equivalence(self, tmp_path):
        def build():
            return _mln(seed=31, iterations=2)

        batches = _batches(5)
        ref = _reference(build, batches)
        assert ref.iteration == 10
        net = build()
        cm = _cm(tmp_path, keep=20, save_every_steps=1, async_save=False)
        with inject_faults(FaultInjector().fail_at_step(4, transient=False)):
            with pytest.raises(InjectedFault):
                net.fit(batches, checkpoint_manager=cm)
        assert cm.latest_step() == 4
        resumed = build()
        resumed.fit(batches, checkpoint_manager=cm)
        assert resumed.iteration == 10
        _same(ref, resumed)

    def test_tbptt_resume_equivalence(self, tmp_path):
        batches = _seq_batches(4, 2)
        ref = _reference(lambda: _lstm_net(13), batches)
        assert ref.iteration == 12
        net = _lstm_net(13)
        cm = _cm(tmp_path, keep=20, save_every_steps=1, async_save=False)
        with inject_faults(FaultInjector().fail_at_step(6, transient=False)):
            with pytest.raises(InjectedFault):
                net.fit(batches, checkpoint_manager=cm)
        assert cm.latest_step() == 6
        resumed = _lstm_net(13)
        resumed.fit(batches, checkpoint_manager=cm)
        assert resumed.iteration == 12
        _same(ref, resumed)

    def test_tbptt_transient_window_retry(self):
        (x, y), = _seq_batches(1, 4)
        ref = _lstm_net(17)
        ref.fit(x, y)
        net = _lstm_net(17)
        rp = RetryPolicy(max_retries=2, base_delay_s=0.0, jitter=0.0,
                         registry=MetricsRegistry())
        with inject_faults(FaultInjector().fail_at_step(1, transient=True)):
            net.fit(x, y, retry_policy=rp)
        assert rp.retries == 1 and net.iteration == 3
        _same(ref, net)


# ================================================= preempt-save hardening
class TestSaveIfStale:
    def test_failed_async_save_does_not_cover_preempt_save(self, tmp_path):
        net = _mln()
        net.fit(*_batches(1)[0])
        inj = FaultInjector(seed=3).crash_after_files(1)
        cm = _cm(tmp_path, fault_injector=inj)
        cm.save(net)
        cm.wait_idle()
        assert cm.latest() is None
        assert cm.save_if_stale(net, block=True)
        assert cm.latest_step() == 1
        cm.close()


class TestPreemptionRearm:
    def test_reset_rearms_os_handlers(self, tmp_path):
        cm = _cm(tmp_path, async_save=False)
        with PreemptionHandler(cm, registry=MetricsRegistry()) as ph:
            for _ in range(2):
                os.kill(os.getpid(), signal.SIGTERM)
                for _ in range(100):
                    if ph.stop_requested:
                        break
                    time.sleep(0.01)
                assert ph.stop_requested
                ph.reset()
                assert not ph.stop_requested


# ======================================================= against the JAX
def _jax_bn_net(seed=5, updater="adam"):
    from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC

    return JaxMultiLayerNetwork(
        (JNNC.builder().seed(seed).updater(updater, learning_rate=0.05)
         .list()
         .layer(jlayers.DenseLayer(n_in=8, n_out=16, activation="relu"))
         .layer(jlayers.BatchNormalization(n_out=16))
         .layer(jlayers.OutputLayer(n_in=16, n_out=4)).build())).init()


def test_jax_checkpoint_restores_exactly(tmp_path):
    """A step directory the JAX ``CheckpointManager`` committed restores
    into the port: params, updater state and layer state equal."""
    jnet = _jax_bn_net()
    for x, y in _batches(3):
        jnet.fit(x, y)
    jax_serialization.write_model(jnet, str(tmp_path / "w.zip"))
    jcm = JaxCheckpointManager(str(tmp_path / "ckpt"), async_save=False)
    jcm.save(jnet)
    jcm.close()
    net = serialization.load_model(tmp_path / "w.zip", device="cpu")
    for p in tree_leaves(net.params):          # a net of other values
        p.zero_()
    cm = _cm(tmp_path / "ckpt", async_save=False)
    cm.restore(net)
    assert net.iteration == 3
    want = {"params": jnet.params, "updater_state": jnet.updater_state,
            "net_state": jnet.net_state}
    got = {"params": net.params, "updater_state": net.updater_state,
           "net_state": net.net_state}
    for tree in want:
        wl = {p: np.asarray(v) for p, v in _flat(want[tree]).items()}
        gl = {p: v.numpy() for p, v in _flat(got[tree]).items()}
        assert set(wl) == set(gl), tree
        for path in wl:
            np.testing.assert_array_equal(gl[path], wl[path], err_msg=path)


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def test_crash_resume_matches_jax(tmp_path):
    """The same weights, batches and crash at step 3 in both packages:
    the resumed runs agree within the train tolerance.  Nesterov, not
    Adam: the dense bias feeding the training-mode BatchNorm has a true
    gradient of 0, whose rounding noise Adam would scale to full steps
    (ROADMAP §C, settled)."""
    jnet = _jax_bn_net(seed=9, updater="nesterovs")
    path = tmp_path / "w.zip"
    jax_serialization.write_model(jnet, str(path))
    batches = _batches(6, seed=3)
    jcm = JaxCheckpointManager(str(tmp_path / "j"), keep=10,
                               save_every_steps=1, async_save=False)
    with jax_inject(JaxInjector().fail_at_step(3, transient=False)):
        with pytest.raises(JaxInjectedFault):
            jnet.fit(batches, checkpoint_manager=jcm)
    jres = jax_serialization.restore_multi_layer_network(str(path))
    jres.fit(batches, checkpoint_manager=jcm)
    net = serialization.load_model(path, device="cpu")
    cm = _cm(tmp_path / "t", keep=10, save_every_steps=1, async_save=False)
    with inject_faults(FaultInjector().fail_at_step(3, transient=False)):
        with pytest.raises(InjectedFault):
            net.fit(batches, checkpoint_manager=cm)
    res = serialization.load_model(path, device="cpu")
    res.fit(batches, checkpoint_manager=cm)
    assert res.iteration == jres.iteration == 6
    np.testing.assert_allclose(res.params_to_vector(),
                               np.asarray(jres.params_to_vector()),
                               rtol=RTOL_FIT, atol=ATOL_FIT)
    for path_, v in _flat(jres.net_state).items():
        np.testing.assert_allclose(_flat(res.net_state)[path_].numpy(),
                                   np.asarray(v), rtol=RTOL_FIT,
                                   atol=ATOL_FIT)


def test_restore_into_a_captured_net(tmp_path, monkeypatch):
    """The card's capture emulated on the CPU: a restore writes into the
    tensors the captured program holds, so the replays after it equal
    the uninterrupted run bit for bit and nothing is captured again."""
    from tests.test_torch_tbptt import _emulate_capture

    batches = _batches(6, seed=8)
    ref = _reference(_mln, batches)
    net = _mln()
    _emulate_capture(monkeypatch, net)
    cm = _cm(tmp_path, save_every_steps=2, async_save=False)
    net.fit(batches[:4], checkpoint_manager=cm)
    net.fit(batches[4:])                    # to be undone
    assert cm.restore(net)[3] == 4
    net.fit(batches[4:])
    _same(ref, net)
    assert net._step_graphs.captures == 1
