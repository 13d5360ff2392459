"""ZeRO update sharding in the port against the JAX package.

The port's ZeRO runs (``update_sharding="zero"``, ``[K, n/K]`` blocks on
K CPU slots) are held to the port's replicated runs at the reference's
ZeRO-against-replicated tolerance (``tests/test_zero.py``: ``rtol=1e-5``
on params, ``atol=1e-7``), and to the JAX ZeRO runs on K virtual devices
at the reference's distributed-against-reference tolerance
(``tests/test_parallel.py``: ``rtol=2e-5, atol=1e-6``)."""

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import parallel as jpar
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.iterator import ListDataSetIterator as JIt
from deeplearning4j_tpu.nn.conf import TrainingStability as JStab
from deeplearning4j_tpu.observability import shardstats as jshard
from deeplearning4j_tpu.parallel.elastic import ElasticConfig as JElastic
from deeplearning4j_tpu.resilience import FaultInjector as JInj
from deeplearning4j_tpu.resilience import inject_faults as jinject

from deeplearning4j_tpu_torch import parallel as tpar
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterator import ListDataSetIterator
from deeplearning4j_tpu_torch.models.interop import zero_blocks_from_numpy
from deeplearning4j_tpu_torch.observability import shardstats
from deeplearning4j_tpu_torch.optimize import updaters
from deeplearning4j_tpu_torch.parallel import zero as zero_mod
from deeplearning4j_tpu_torch.resilience import FaultInjector, inject_faults
from deeplearning4j_tpu_torch.resilience import stability

from tests._torch_parallel_common import (
    data, jmesh, jvec, pair, tmesh_of, tvec,
)

RTOL, ATOL = 1e-5, 1e-7            # ZeRO against replicated, one framework
X_RTOL, X_ATOL = 2e-5, 1e-6        # the port against the JAX package


@pytest.mark.parametrize("updater", ["adam", "nesterovs", "rmsprop"])
def test_wrapper_zero_matches_replicated_and_jax(updater):
    x, y = data(96)
    K = 4
    vec = {}
    for mode in ("replicated", "zero"):
        _, tn = pair(updater=updater)
        pw = tpar.ParallelWrapper(tn, workers=K, mesh=tmesh_of(K),
                                  update_sharding=mode)
        pw.fit(ListDataSetIterator(DataSet(x, y), 8))
        vec[mode] = tvec(tn)
    jn, _ = pair(updater=updater)
    jpar.ParallelWrapper(jn, workers=K, mesh=jmesh(K),
                         update_sharding="zero").fit(JIt(JDataSet(x, y), 8))
    np.testing.assert_allclose(vec["zero"], vec["replicated"], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(vec["zero"], jvec(jn), rtol=X_RTOL,
                               atol=X_ATOL)


def test_sync_master_zero_matches_replicated_and_jax():
    x, y = data(64)
    K = 4
    vec = {}
    for mode in ("replicated", "zero"):
        _, tn = pair()
        master = tpar.SyncTrainingMaster(mesh=tmesh_of(K),
                                         update_sharding=mode)
        tpar.DistributedNetwork(tn, master).fit(
            ListDataSetIterator(DataSet(x, y), 16))
        vec[mode] = tvec(tn)
        prog = shardstats.program_analysis("SyncTrainingMaster.step")
        if mode == "zero":
            assert prog["collectives"]["reduce-scatter"]["count"] >= 1
            assert prog["collectives"]["all-gather"]["count"] >= 1
    jn, _ = pair()
    jpar.DistributedNetwork(jn, jpar.SyncTrainingMaster(
        mesh=jmesh(K), update_sharding="zero")).fit(JIt(JDataSet(x, y), 16))
    np.testing.assert_allclose(vec["zero"], vec["replicated"], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(vec["zero"], jvec(jn), rtol=X_RTOL,
                               atol=X_ATOL)


def test_sync_master_zero_nondividing_leaves_and_mask():
    """n_out=5: the output bias does not divide by K and stays whole."""
    x, y = data(48, n_out=5)
    lm = np.ones((48,), np.float32)
    lm[3:9] = 0.0
    K = 4
    _, tn = pair(n_out=5)
    tpar.DistributedNetwork(tn, tpar.SyncTrainingMaster(
        mesh=tmesh_of(K), update_sharding="zero")).fit(
        ListDataSetIterator(DataSet(x, y, labels_mask=lm), 16))
    jn, _ = pair(n_out=5)
    jpar.DistributedNetwork(jn, jpar.SyncTrainingMaster(
        mesh=jmesh(K), update_sharding="zero")).fit(
        JIt(JDataSet(x, y, labels_mask=lm), 16))
    np.testing.assert_allclose(tvec(tn), jvec(jn), rtol=X_RTOL, atol=X_ATOL)


def _drill(mode, jax_side):
    """Four replicas, Adam, the guard on, replica 1 poisoned at step 1,
    replica 2 evicted by hand for the second fit, then readmitted."""
    x, y = data(192)
    K = 4
    jn, tn = pair(stab=JStab(check_every=100))
    if jax_side:
        inj = JInj(seed=3).poison_gradients("1", at_step=1, until_step=2,
                                            mode="nan")
        pw = jpar.ParallelWrapper(jn, workers=K, mesh=jmesh(K),
                                  elastic=JElastic(degraded_mode=True),
                                  update_sharding=mode)
        ctx, it, dsc, net = jinject(inj), JIt, JDataSet, jn
    else:
        inj = FaultInjector(seed=3).poison_gradients(
            "1", at_step=1, until_step=2, mode="nan")
        pw = tpar.ParallelWrapper(tn, workers=K, mesh=tmesh_of(K),
                                  elastic=tpar.ElasticConfig(
                                      degraded_mode=True),
                                  update_sharding=mode)
        ctx, it, dsc, net = (inject_faults(inj), ListDataSetIterator,
                             DataSet, tn)
    with ctx:
        pw.fit(it(dsc(x[:64], y[:64]), 16))
        assert pw.elastic.evict("2", reason="manual", step=net.iteration)
        pw.fit(it(dsc(x[64:128], y[64:128]), 16))
        pw.elastic.readmit("2", step=net.iteration)
        pw.fit(it(dsc(x[128:], y[128:]), 16))
    return net


def test_wrapper_zero_with_stability_and_eviction_matches_jax():
    vec = {}
    for mode in ("replicated", "zero"):
        net = _drill(mode, jax_side=False)
        vec[mode] = tvec(net)
        assert np.isfinite(vec[mode]).all()
    jn = _drill("zero", jax_side=True)
    np.testing.assert_allclose(vec["zero"], vec["replicated"], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(vec["zero"], jvec(jn), rtol=X_RTOL,
                               atol=X_ATOL)


def test_ledger_updater_replication_drops_to_one():
    x, y = data(64)
    K = 4
    _, tn = pair()
    tpar.ParallelWrapper(tn, workers=K, mesh=tmesh_of(K),
                         update_sharding="zero").fit(
        ListDataSetIterator(DataSet(x, y), 16))
    led = shardstats.latest_ledgers()["parallel_wrapper"]
    assert led["trees"]["params"]["replication_factor"] <= 1.05
    assert led["trees"]["updater_state"]["replication_factor"] <= 1.1
    assert led["notes"]["update_sharding"] == "zero"
    _, rep = pair()
    tpar.ParallelWrapper(rep, workers=K, mesh=tmesh_of(K)).fit(
        ListDataSetIterator(DataSet(x, y), 16))
    led_rep = shardstats.latest_ledgers()["parallel_wrapper"]
    assert led_rep["trees"]["updater_state"]["replication_factor"] == 4.0
    assert "notes" not in led_rep


def test_projection_matches_actual_and_jax_ledger():
    """The replicated run's projected-ZeRO column equals the ZeRO run's
    per-slot bytes, with a non-dividing leaf and the stability subtree;
    and the port's rows equal the JAX ledger's."""
    x, y = data(64, n_out=5)
    K = 4
    ledgers, jledgers = {}, {}
    for mode in ("replicated", "zero"):
        jn, tn = pair(n_out=5, stab=JStab(check_every=100))
        tpar.ParallelWrapper(tn, workers=K, mesh=tmesh_of(K),
                             update_sharding=mode).fit(
            ListDataSetIterator(DataSet(x, y), 16))
        ledgers[mode] = shardstats.latest_ledgers()["parallel_wrapper"]
        jpar.ParallelWrapper(jn, workers=K, mesh=jmesh(K),
                             update_sharding=mode).fit(
            JIt(JDataSet(x, y), 16))
        jledgers[mode] = jshard.latest_ledgers()["parallel_wrapper"]
    for tree in ("params", "updater_state"):
        projected = ledgers["replicated"]["trees"][tree][
            "zero_projected_per_device_bytes"]
        actual = ledgers["zero"]["trees"][tree]["per_device_bytes"]
        assert abs(projected - actual) <= 0.02 * max(actual, 1)
        for mode in ledgers:
            for key in ("logical_bytes", "per_device_bytes",
                        "replication_factor"):
                assert ledgers[mode]["trees"][tree][key] == \
                    jledgers[mode]["trees"][tree][key], (mode, tree, key)


def test_reserved_subtrees_and_predicate():
    assert set(shardstats.RESERVED_REPLICATED_SUBTREES) == set(
        updaters.RESERVED_KEYS)
    assert stability.STATE_KEY in shardstats.RESERVED_REPLICATED_SUBTREES
    assert set(shardstats.RESERVED_REPLICATED_SUBTREES) == set(
        jshard.RESERVED_REPLICATED_SUBTREES)
    for shape, k in (((16, 4), 4), ((5,), 4), ((), 4), ((8,), 1), ((0,), 2),
                     ((12, 3), 8)):
        assert shardstats.zero_shardable(shape, k) == \
            jshard.zero_shardable(shape, k)


def test_zero_blocks_carry_across():
    """A JAX ZeRO layout's leaves (whole, sharded P('data')) become the
    port's [K, n/K] blocks, equal to the port's own layout."""
    jn, tn = pair(n_out=5)
    lay = zero_mod.ZeroLayout(tmesh_of(4))
    got = zero_blocks_from_numpy(jax.device_get(jn.params), 4, device="cpu")
    want = lay.place(tn.params)
    for ln in want:
        for pn in want[ln]:
            assert torch.equal(got[ln][pn], want[ln][pn]), (ln, pn)
    assert tuple(got["layer_1"]["b"].shape) == (5,)


def test_tree_collectives():
    K = 4
    g = torch.arange(4 * 8 * 3.).reshape(K, 8, 3)
    rs = zero_mod.reduce_scatter_tree({"a": g, "b": torch.ones(K, 5)}, K)
    assert torch.equal(rs["a"], g.sum(0).reshape(K, 2, 3))
    assert torch.equal(rs["b"], torch.full((5,), 4.0))
    gathered = zero_mod.all_gather_tree({"a": rs["a"]}, {"a": True})
    assert torch.equal(gathered["a"], g.sum(0))


def test_validation_errors():
    with pytest.raises(ValueError, match="pure data-parallel"):
        zero_mod.validate_mode("zero", tmesh_of(2, seq=2))
    with pytest.raises(ValueError, match="at least 2"):
        zero_mod.validate_mode("zero", tmesh_of(1))
    with pytest.raises(ValueError, match="averaging_frequency=1"):
        tpar.ParameterAveragingTrainingMaster(
            workers=2, averaging_frequency=3, update_sharding="zero")


def test_wrapper_zero_introspection_parity_and_harvest():
    """Introspection through the ZeRO window: the params equal the
    replicated window's, and the harvested per-replica ``[K, L]`` view
    (each replica's gradient norms, activation stats) equals the
    replicated window's and the JAX ZeRO window's."""
    from deeplearning4j_tpu.observability import introspection as jintro
    from deeplearning4j_tpu_torch.observability import introspection

    x, y = data(64)
    K = 4
    vec, harv = {}, {}
    for mode in ("replicated", "zero"):
        _, tn = pair(intro=True)
        tpar.ParallelWrapper(tn, workers=K, mesh=tmesh_of(K),
                             update_sharding=mode).fit(
            ListDataSetIterator(DataSet(x, y), 16))
        vec[mode] = tvec(tn)
        h = introspection.harvest(introspection.latest(tn),
                                  introspection.plan_for(tn))
        assert h is not None and h.get("replicas") == 4
        assert set(h["gradient_stats"]) == {"layer_0", "layer_1"}
        harv[mode] = h
    jn, _ = pair(intro=True)
    jpar.ParallelWrapper(jn, workers=K, mesh=jmesh(K),
                         update_sharding="zero").fit(JIt(JDataSet(x, y), 16))
    jh = jintro.harvest(jintro.latest(jn), jintro.plan_for(jn))
    np.testing.assert_allclose(vec["zero"], vec["replicated"], rtol=RTOL,
                               atol=ATOL)
    for layer, stats in harv["zero"]["gradient_stats"].items():
        for key in ("per_replica",):
            np.testing.assert_allclose(
                stats[key], harv["replicated"]["gradient_stats"][layer][key],
                rtol=1e-5)
            np.testing.assert_allclose(
                stats[key], jh["gradient_stats"][layer][key], rtol=X_RTOL,
                atol=X_ATOL)
