"""Elastic data parallelism in the port against the JAX package: the
controller (a copy of the reference's host logic), eviction and its
renormalised average, readmission, the sync master's healthy-rows
math, poisoned replicas weighted out under a stability policy, and the
barrier stalls a lockstep run pays — counted, not timed (the reference's
wall-clock gate is left out; ROADMAP C2).  Tolerances are the reference
tests' (``tests/test_parallel.py``, ``tests/test_elastic.py``:
``rtol=2e-5, atol=1e-6``)."""

import numpy as np
import pytest

from deeplearning4j_tpu import parallel as jpar
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.iterator import ListDataSetIterator as JIt
from deeplearning4j_tpu.nn.conf import TrainingStability as JStab
from deeplearning4j_tpu.parallel.elastic import (
    ElasticConfig as JElastic, ElasticController as JController,
)
from deeplearning4j_tpu.resilience import FaultInjector as JInj
from deeplearning4j_tpu.resilience import inject_faults as jinject

from deeplearning4j_tpu_torch import parallel as tpar
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterator import ListDataSetIterator
from deeplearning4j_tpu_torch.observability import (
    MetricsRegistry, get_flight_recorder, get_registry,
)
from deeplearning4j_tpu_torch.parallel import ElasticConfig, ElasticController
from deeplearning4j_tpu_torch.resilience import FaultInjector, inject_faults

from tests._torch_parallel_common import (
    data, jmesh, jvec, pair, tmesh_of, tvec,
)

RTOL, ATOL = 2e-5, 1e-6


def _batches(n, b, seed):
    x, y = data(n * b, seed=seed)
    return [(x[i * b:(i + 1) * b], y[i * b:(i + 1) * b]) for i in range(n)]


def _events(kind, **attrs):
    return [e for e in get_flight_recorder().events()
            if e.kind == kind and all(e.attrs.get(k) == v
                                      for k, v in attrs.items())]


def test_controller_matches_jax_controller():
    """The same transitions on both controllers give the same masks and
    summaries (min_healthy refusal, max_evicted cap, readmission)."""
    out = []
    for ctl_cls, cfg_cls in ((ElasticController, ElasticConfig),
                             (JController, JElastic)):
        ctl = ctl_cls("t", ["0", "1", "2"],
                      config=cfg_cls(min_healthy=2),
                      registry=MetricsRegistry())
        seq = [ctl.evict("1", "manual", step=0),
               ctl.evict("2", "manual", step=1),
               list(ctl.active_mask())]
        ctl.readmit("1", step=2)
        seq.append(list(ctl.active_workers))
        ctl2 = ctl_cls("t2", ["0", "1", "2", "3"],
                       config=cfg_cls(min_healthy=1, max_evicted=1),
                       registry=MetricsRegistry())
        seq += [ctl2.evict("0", "manual", step=0),
                ctl2.evict("1", "manual", step=0)]
        out.append(seq)
    assert out[0] == out[1]


@pytest.mark.parametrize("k_dead", [1, 2])
def test_kill_worker_eviction_and_readmission_match_jax(k_dead):
    """Worker k dies at step 2 and comes back at step 6: evicted
    ("dead"), the average renormalised over the healthy replicas,
    readmitted — the same params as the JAX wrapper."""
    K = 4
    batches = _batches(K * 8, 4, seed=11)
    jn, tn = pair(updater="sgd", lr=0.05)
    ji = JInj(seed=2).kill_worker(str(k_dead), at_step=2, until_step=6)
    with jinject(ji):
        jpar.ParallelWrapper(jn, workers=K, mesh=jmesh(K),
                             elastic=JElastic(evict_after_flags=None)).fit(
            iter([JDataSet(x, y) for x, y in batches]))
    ti = FaultInjector(seed=2).kill_worker(str(k_dead), at_step=2,
                                           until_step=6)
    pw = tpar.ParallelWrapper(tn, workers=K, mesh=tmesh_of(K),
                              elastic=ElasticConfig(evict_after_flags=None))
    with inject_faults(ti):
        pw.fit(iter([DataSet(x, y) for x, y in batches]))
    assert pw.elastic.evicted_workers == []
    evs = _events("elastic_eviction", component="parallel_wrapper",
                  worker=str(k_dead))
    assert evs and evs[-1].attrs["reason"] == "dead"
    assert _events("elastic_readmission", component="parallel_wrapper",
                   worker=str(k_dead))
    np.testing.assert_allclose(tvec(tn), jvec(jn), rtol=RTOL, atol=ATOL)


def test_eviction_average_is_the_healthy_replicas_mean():
    """With replica 1 evicted, a window's average is the mean of the
    three healthy replicas' single-net steps, and every slot — the
    evicted one too — holds it (the readmission's catch-up)."""
    K = 4
    batches = _batches(K, 4, seed=5)
    _, tn = pair(updater="sgd", lr=0.1)
    pw = tpar.ParallelWrapper(tn, workers=K, mesh=tmesh_of(K),
                              elastic=ElasticConfig(
                                  readmit_after_windows=10 ** 9))
    assert pw.elastic.evict("1", "manual", step=0)
    pw.fit(iter([DataSet(x, y) for x, y in batches]))
    reps = [pair(updater="sgd", lr=0.1)[1] for _ in range(K)]
    for r, rep in enumerate(reps):
        rep.fit(*batches[r])
    healthy = np.mean([tvec(reps[r]) for r in (0, 2, 3)], axis=0)
    np.testing.assert_allclose(tvec(tn), healthy, rtol=RTOL, atol=ATOL)
    for stack in (pw._staged.params["layer_0"]["W"],):
        for k in range(1, K):
            assert (stack[k] == stack[0]).all()


def test_poisoned_replica_is_weighted_out_and_named():
    """Under a stability policy a NaN-poisoned replica's window is a
    no-op for it and it is weighted out of the average (the healthy
    mean), a ``replica_poisoned`` flight event names it, and the
    per-worker counter counts it — as in the JAX wrapper."""
    K = 4
    batches = _batches(K, 4, seed=8)
    stab = JStab(check_every=1)
    jn, tn = pair(updater="sgd", lr=0.1, stab=stab)
    ji = JInj(seed=1).poison_gradients("2", at_step=0, until_step=1)
    with jinject(ji):
        jpar.ParallelWrapper(jn, workers=K, mesh=jmesh(K)).fit(
            iter([JDataSet(x, y) for x, y in batches]))
    ti = FaultInjector(seed=1).poison_gradients("2", at_step=0,
                                                until_step=1)
    with inject_faults(ti):
        tpar.ParallelWrapper(tn, workers=K, mesh=tmesh_of(K)).fit(
            iter([DataSet(x, y) for x, y in batches]))
    reps = [pair(updater="sgd", lr=0.1)[1] for _ in range(K)]
    for r, rep in enumerate(reps):
        rep.fit(*batches[r])
    healthy = np.mean([tvec(reps[r]) for r in (0, 1, 3)], axis=0)
    np.testing.assert_allclose(tvec(tn), healthy, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tvec(tn), jvec(jn), rtol=RTOL, atol=ATOL)
    evs = _events("replica_poisoned", component="parallel_wrapper",
                  worker="2")
    assert evs and evs[-1].attrs["windows"] >= 1
    assert get_registry().get_value(
        "dl4j_poisoned_replica_windows_total", component="parallel_wrapper",
        worker="2") >= 1


def test_sync_master_eviction_equals_healthy_rows_math():
    K = 4
    x, y = data(32, seed=17)
    _, tn = pair(updater="sgd", lr=0.1)
    master = tpar.SyncTrainingMaster(mesh=tmesh_of(K),
                                     elastic=ElasticConfig())
    victim = master.elastic.workers[2]
    with inject_faults(FaultInjector(seed=4).kill_worker(victim,
                                                         at_step=0)):
        tpar.DistributedNetwork(tn, master).fit(
            ListDataSetIterator(DataSet(x, y), 8))
    assert master.elastic.summary()["evicted"][victim]["reason"] == "dead"
    assert master.training_stats()["elastic"]["active"] == K - 1
    jn, ref = pair(updater="sgd", lr=0.1)
    keep = np.r_[0:4, 6:8]
    for i in range(4):
        ref.fit(x[i * 8:(i + 1) * 8][keep], y[i * 8:(i + 1) * 8][keep])
    np.testing.assert_allclose(tvec(tn), tvec(ref), rtol=RTOL, atol=ATOL)
    jm = jpar.SyncTrainingMaster(mesh=jmesh(K), elastic=JElastic())
    with jinject(JInj(seed=4).kill_worker(jm.elastic.workers[2],
                                          at_step=0)):
        jpar.DistributedNetwork(jn, jm).fit(JIt(JDataSet(x, y), 8))
    np.testing.assert_allclose(tvec(tn), jvec(jn), rtol=RTOL, atol=ATOL)


def test_hang_worker_evicts_and_clear_readmits():
    K = 4
    _, tn = pair()
    pw = tpar.ParallelWrapper(tn, workers=K, mesh=tmesh_of(K),
                              elastic=ElasticConfig(evict_after_flags=None,
                                                    hang_stall_s=0.0))
    with inject_faults(FaultInjector(seed=3).hang_worker(
            "1", at_step=1, until_step=4)):
        pw.fit(iter([DataSet(x, y) for x, y in _batches(K * 8, 4, 13)]))
    evs = _events("elastic_eviction", component="parallel_wrapper",
                  worker="1")
    assert evs and evs[-1].attrs["reason"] == "hang"
    assert "1" in pw.elastic.active_workers


def test_degraded_mode_stops_paying_the_barrier_stall():
    """Replica 1 is slow and dies at step 2: a lockstep run pays its
    delay at every window's barrier, a degraded run only until the
    eviction — counted by ``window_barrier``, not timed."""
    K, n_win, delay = 4, 8, 0.001

    def run(cfg):
        _, tn = pair()
        pw = tpar.ParallelWrapper(tn, workers=K, mesh=tmesh_of(K),
                                  elastic=cfg)
        inj = (FaultInjector(seed=6).delay_worker("1", delay)
               .kill_worker("1", at_step=2))
        with inject_faults(inj):
            pw.fit(iter([DataSet(x, y)
                         for x, y in _batches(K * n_win, 4, 23)]))
        return pw.elastic

    lock = run(ElasticConfig(degraded_mode=False, hang_stall_s=0.0))
    deg = run(ElasticConfig(evict_after_flags=None, hang_stall_s=0.0))
    assert lock.barrier_stalls == n_win
    assert deg.barrier_stalls == 2
    assert lock.barrier_stall_seconds == pytest.approx(n_win * delay)
    assert deg.barrier_stall_seconds == pytest.approx(2 * delay)


def test_param_avg_master_elastic_state_survives_epochs():
    K = 2
    _, tn = pair()
    m = tpar.ParameterAveragingTrainingMaster(
        workers=K, averaging_frequency=1, mesh=tmesh_of(K),
        elastic=ElasticConfig(readmit_after_windows=10 ** 9))
    m.elastic.evict("1", "manual", step=0)
    d = tpar.DistributedNetwork(tn, m)
    x, y = data(32, seed=2)
    d.fit(ListDataSetIterator(DataSet(x, y), 8), epochs=2)
    assert m.elastic.evicted_workers == ["1"]
    assert m.training_stats()["windows"] == 2


def test_replica_poison_reaches_a_token_models_labels():
    """Token ids cannot be non-finite, so for integer features the
    wrapper's hook poisons the replica's labels instead (the reference's
    hook leaves such a replica healthy); float features are poisoned as
    the reference's."""
    inj = FaultInjector(seed=0).poison_gradients("1", at_step=0,
                                                 until_step=1)
    ids = np.zeros((1, 2, 3, 5), np.int64)
    ys = np.zeros((1, 2, 3, 5, 4), np.float32)
    ys2 = inj.poison_replica_labels(["0", "1"], 0, ids, ys)
    assert np.isnan(ys2[:, 1]).all()
    assert np.isfinite(ys2[:, 0]).all()
    assert (inj.poison_replica_slots(["0", "1"], 0, ids) == ids).all()
    xf = np.zeros((1, 2, 3), np.float32)
    xf2 = inj.poison_replica_slots(["0", "1"], 0, xf)
    assert np.isnan(xf2[:, 1]).all()
    assert inj.poison_replica_labels(["0", "1"], 0, xf, ys) is ys
    assert inj.poison_replica_slots(["0", "1"], 5, xf) is xf
    assert inj.poison_replica_labels(["0", "1"], 5, ids, ys) is ys
