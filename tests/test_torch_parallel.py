"""The port's data-parallel masters against the JAX masters.

The JAX master runs on ``jax.devices()[:K]`` (the conftest's 8 virtual
CPU devices), the port's on K CPU slots (``backend.mesh``); both start
from the same weights (carried across) and see the same numpy batches.
Tolerances are the reference tests' own (``tests/test_parallel.py``:
``rtol=2e-5, atol=1e-6``)."""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.iterator import (
    ListDataSetIterator as JListIt,
)
from deeplearning4j_tpu import parallel as jpar

from deeplearning4j_tpu_torch import parallel as tpar
from deeplearning4j_tpu_torch.backend import mesh as tmesh
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterator import ListDataSetIterator
from deeplearning4j_tpu_torch.models import capture as cap
from deeplearning4j_tpu_torch.models.interop import stacked_from_numpy
from deeplearning4j_tpu_torch.observability import shardstats

from tests._torch_parallel_common import (
    data, jmesh, jvec, pair, tmesh_of, tvec,
)

RTOL, ATOL = 2e-5, 1e-6


def _batches(n, b, seed=0, n_in=8, n_out=4):
    x, y = data(n * b, n_in, n_out, seed)
    return [(x[i * b:(i + 1) * b], y[i * b:(i + 1) * b]) for i in range(n)]


def test_mesh_slots_share_one_device():
    mesh = tmesh_of(4)
    assert mesh.shape == {"data": 4, "model": 1, "seq": 1}
    assert mesh.size == 4 and mesh.device == torch.device("cpu")
    with pytest.raises(NotImplementedError, match="A10"):
        tmesh.default_mesh(devices=["cpu", "meta"])
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.default_mesh(devices=["cpu"] * 3, model=2)
    with pytest.raises(ValueError, match="!= 4 devices"):
        tmesh.default_mesh(data=3, devices=["cpu"] * 4)


@pytest.mark.parametrize("updater", ["sgd", "adam"])
def test_sync_master_matches_jax_and_single_net(updater):
    """Sync DP over K slots == the JAX sync master over K devices ==
    single-net training on the same global batches."""
    K = 4
    jn, tn = pair(updater=updater, lr=0.1)
    _, single = pair(updater=updater, lr=0.1)
    x, y = data(48)
    jpar.DistributedNetwork(jn, jpar.SyncTrainingMaster(mesh=jmesh(K))).fit(
        JListIt(JDataSet(x, y), 8))
    tpar.DistributedNetwork(tn, tpar.SyncTrainingMaster(
        mesh=tmesh_of(K))).fit(ListDataSetIterator(DataSet(x, y), 8))
    for i in range(0, 48, 8):
        single.fit(x[i:i + 8], y[i:i + 8])
    np.testing.assert_allclose(tvec(tn), jvec(jn), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tvec(tn), tvec(single), rtol=RTOL,
                               atol=ATOL)
    assert tn.iteration == jn.iteration == 6


def test_sync_master_masked_labels_weighting():
    """A labels mask: each slot's loss weighted by sum(mask_slot) /
    psum(sum(mask)), equal to the JAX master's masked global mean."""
    K = 4
    jn, tn = pair(updater="adam")
    x, y = data(32)
    lm = np.ones((32,), np.float32)
    lm[:10] = 0.0                  # slot 0 all masked, slot 1 partly
    jpar.DistributedNetwork(jn, jpar.SyncTrainingMaster(mesh=jmesh(K))).fit(
        JListIt(JDataSet(x, y, labels_mask=lm), 16))
    tpar.DistributedNetwork(tn, tpar.SyncTrainingMaster(
        mesh=tmesh_of(K))).fit(
        ListDataSetIterator(DataSet(x, y, labels_mask=lm), 16))
    np.testing.assert_allclose(tvec(tn), jvec(jn), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("freq", [1, 3])
@pytest.mark.parametrize("updater", ["sgd", "nesterovs", "adam"])
def test_parameter_averaging_matches_jax(freq, updater):
    """ParallelWrapper(K, F): the JAX wrapper's windows and the port's
    agree, and both equal K single nets trained on their batches and
    averaged (the reference's replica oracle)."""
    K = 2
    jn, tn = pair(updater=updater, lr=0.1)
    batches = _batches(K * freq * 2, 4)
    jpar.ParallelWrapper(jn, workers=K, averaging_frequency=freq,
                         mesh=jmesh(K)).fit(
        iter([JDataSet(x, y) for x, y in batches]))
    pw = tpar.ParallelWrapper(tn, workers=K, averaging_frequency=freq,
                              mesh=tmesh_of(K))
    pw.fit(iter([DataSet(x, y) for x, y in batches]))
    np.testing.assert_allclose(tvec(tn), jvec(jn), rtol=RTOL, atol=ATOL)
    assert pw.iteration == 2 * freq
    if updater == "sgd":
        reps = [pair(updater=updater, lr=0.1)[1] for _ in range(K)]
        for r, rep in enumerate(reps):
            for f in range(freq):
                rep.fit(*batches[f * K + r])
        avg = np.mean([tvec(r) for r in reps], axis=0)
        np.testing.assert_allclose(_first_window(freq, K, updater, batches),
                                   avg, rtol=RTOL, atol=ATOL)


def _first_window(freq, K, updater, batches):
    _, tn = pair(updater=updater, lr=0.1)
    tpar.ParallelWrapper(tn, workers=K, averaging_frequency=freq,
                         mesh=tmesh_of(K)).fit(
        iter([DataSet(x, y) for x, y in batches[:K * freq]]))
    return tvec(tn)


def test_param_avg_master_matches_jax():
    K = 4
    jn, tn = pair(updater="adam")
    x, y = data(96)
    jpar.DistributedNetwork(jn, jpar.ParameterAveragingTrainingMaster(
        workers=K, averaging_frequency=2, mesh=jmesh(K))).fit(
        JListIt(JDataSet(x, y), 8), epochs=2)
    tpar.DistributedNetwork(tn, tpar.ParameterAveragingTrainingMaster(
        workers=K, averaging_frequency=2, mesh=tmesh_of(K))).fit(
        ListDataSetIterator(DataSet(x, y), 8), epochs=2)
    np.testing.assert_allclose(tvec(tn), jvec(jn), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n_batches", [5, 7])
def test_ragged_tail_pad_weights_match_jax(n_batches):
    """A tail that fills no whole window: its full frames go first, the
    pad-filled replicas are weighted out — the same params as JAX."""
    K, F = 2, 2
    jn, tn = pair(updater="adam")
    batches = _batches(n_batches, 4, seed=3)
    jpw = jpar.ParallelWrapper(jn, workers=K, averaging_frequency=F,
                               mesh=jmesh(K))
    jpw.fit(iter([JDataSet(x, y) for x, y in batches]))
    tpw = tpar.ParallelWrapper(tn, workers=K, averaging_frequency=F,
                               mesh=tmesh_of(K))
    tpw.fit(iter([DataSet(x, y) for x, y in batches]))
    np.testing.assert_allclose(tvec(tn), jvec(jn), rtol=RTOL, atol=ATOL)
    assert tpw.iteration == jpw.iteration
    pw = tpar.ParallelWrapper(tn, workers=K, averaging_frequency=F,
                              mesh=tmesh_of(K))
    assert pw._pad_weights(3, 4).tolist() == [1.0, 0.0]
    assert pw._pad_weights(4, 4) is None


@pytest.mark.parametrize("n", [64, 52])
def test_native_windows_equal_generic_and_jax(n):
    """In-memory unmasked data goes through native.Batcher slabs; the
    result equals the generic assembler's and the JAX wrapper's native
    path (a ragged tail included)."""
    K, F, B = 2, 2, 8
    jn, native_net = pair(updater="adam")
    _, generic_net = pair(updater="adam")
    x, y = data(n, seed=5)
    jpar.ParallelWrapper(jn, workers=K, averaging_frequency=F,
                         mesh=jmesh(K)).fit(JListIt(JDataSet(x, y), B))
    pw = tpar.ParallelWrapper(native_net, workers=K, averaging_frequency=F,
                              mesh=tmesh_of(K))
    it = ListDataSetIterator(DataSet(x, y), B)
    assert list(pw._native_windows(it))          # the native path runs
    pw.fit(ListDataSetIterator(DataSet(x, y), B))
    tpar.ParallelWrapper(generic_net, workers=K, averaging_frequency=F,
                         mesh=tmesh_of(K)).fit(
        iter(list(ListDataSetIterator(DataSet(x, y), B))))
    np.testing.assert_allclose(tvec(native_net), jvec(jn), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(tvec(native_net), tvec(generic_net),
                               rtol=RTOL, atol=ATOL)


def test_wrapper_second_fit_reuses_its_staged_tensors():
    """A second fit writes into the tensors of the first (a captured
    window replays), and the facade keeps its own tensors."""
    K = 2
    _, tn = pair()
    own = tn.params["layer_0"]["W"]
    pw = tpar.ParallelWrapper(tn, workers=K, mesh=tmesh_of(K))
    pw.fit(iter([DataSet(x, y) for x, y in _batches(2, 4)]))
    staged = pw._staged
    leaf = staged.params["layer_0"]["W"]
    pw.fit(iter([DataSet(x, y) for x, y in _batches(2, 4, seed=9)]))
    assert pw._staged is staged and staged.params["layer_0"]["W"] is leaf
    assert tn.params["layer_0"]["W"] is own
    assert tn.iteration == 2


def test_stacked_trees_carry_across():
    """A JAX wrapper's stacked replica tree becomes the port's stack."""
    from deeplearning4j_tpu.parallel.data_parallel import _stack_tree
    from deeplearning4j_tpu_torch.parallel.data_parallel import _stack
    import jax

    jn, tn = pair()
    got = stacked_from_numpy(jax.device_get(_stack_tree(jn.params, 3)),
                             device="cpu")
    want = _stack(tn.params, 3)
    for ln in want:
        for pn in want[ln]:
            assert torch.equal(got[ln][pn], want[ln][pn])


def test_distributed_evaluation_matches_jax():
    K = 4
    jn, tn = pair()
    x, y = data(60, seed=7)
    jev = jpar.DistributedNetwork(jn, jpar.SyncTrainingMaster(
        mesh=jmesh(K))).evaluate(JListIt(JDataSet(x, y), 16))
    tev = tpar.DistributedNetwork(tn, tpar.SyncTrainingMaster(
        mesh=tmesh_of(K))).evaluate(ListDataSetIterator(DataSet(x, y), 16))
    np.testing.assert_array_equal(np.asarray(tev.confusion.matrix),
                                  np.asarray(jev.confusion.matrix))
    assert tpar.DistributedNetwork(tn, tpar.SyncTrainingMaster(
        mesh=tmesh_of(K))).score(DataSet(x, y)) == pytest.approx(
        float(jn.score(x, y)), rel=1e-5)


def test_wrapper_records_the_collective_census():
    """The window's slot collectives (an all-reduce a leaf) are counted
    per program, with their group size."""
    K = 2
    shardstats.clear_ledgers()
    _, tn = pair()
    tpar.ParallelWrapper(tn, workers=K, mesh=tmesh_of(K)).fit(
        iter([DataSet(x, y) for x, y in _batches(2, 4)]))
    prog = shardstats.program_analysis("ParallelWrapper.fit_window")
    ar = prog["collectives"]["all-reduce"]
    n_leaves = 4 + 8                  # params, Adam's m and v
    assert ar["count"] == n_leaves and ar["group_sizes"] == [K]
    assert prog["one_device"] and prog["link_source"] == "cpu-estimate"
    assert "ParallelWrapper.fit_window" in shardstats.latest_programs()


def test_captured_window_runs_the_same_body(monkeypatch):
    """The window goes through ``StepGraphs`` when the staged trees say
    it captures (the card's calls emulated, as the facades' tests do):
    the result equals the eager window's bit for bit."""
    from tests.test_torch_tbptt import _emulate_capture

    K = 2
    batches = _batches(4, 4)
    out = []
    for emulate in (False, True):
        _, tn = pair()
        pw = tpar.ParallelWrapper(tn, workers=K, mesh=tmesh_of(K))
        if emulate:
            pw._stage(tn)
            _emulate_capture(monkeypatch, pw._staged)
            pw.fit(iter([DataSet(x, y) for x, y in batches]))
            monkeypatch.undo()
            graphs = cap.step_graphs(pw._staged)
            assert graphs.captures == 1 and graphs.replays == 1
        else:
            pw.fit(iter([DataSet(x, y) for x, y in batches]))
        out.append(tvec(tn))
    np.testing.assert_array_equal(out[0], out[1])


def test_not_yet_ported_masters_raise():
    with pytest.raises(NotImplementedError, match="A10"):
        tpar.TensorParallelTrainingMaster(mesh=tmesh_of(2))
    with pytest.raises(NotImplementedError, match="A10"):
        tpar.PipelineParallelTrainingMaster()
    with pytest.raises(NotImplementedError, match="A10"):
        tpar.split_stages(None, 2)
    with pytest.raises(NotImplementedError, match="A10"):
        tpar.initialize_distributed("localhost:1234", 2, 0)
    tpar.initialize_distributed()         # one process needs nothing


def test_wrapper_validation_errors():
    _, tn = pair()
    with pytest.raises(ValueError, match="workers=3"):
        tpar.ParallelWrapper(tn, workers=3, mesh=tmesh_of(2))
    with pytest.raises(ValueError, match="averaging_frequency"):
        tpar.ParallelWrapper(tn, workers=2, mesh=tmesh_of(2),
                             averaging_frequency=2, update_sharding="zero")
    with pytest.raises(ValueError, match="update_sharding"):
        tpar.ParallelWrapper(tn, workers=2, mesh=tmesh_of(2),
                             update_sharding="bogus")


@pytest.mark.parametrize("mode", ["replicated", "zero"])
def test_sync_master_introspection_matches_jax(mode):
    """Under ``conf.introspection`` the sync master records the global
    gradient's norms, the update's and the global batch's activation
    statistics (the slots' moments merged): one cluster-wide value a
    layer, no replica axis, equal to the JAX replicated master's harvest
    in either layout (float32, the introspection tests' ``rtol=1e-4``).
    The JAX ZeRO master averages its shards' activation std instead
    (``pmean``), a statistic the port does not copy (ROADMAP C2)."""
    from deeplearning4j_tpu.observability import introspection as jintro
    from deeplearning4j_tpu_torch.observability import introspection

    K = 4
    jn, tn = pair(intro=True)
    x, y = data(32, seed=2)
    jpar.DistributedNetwork(jn, jpar.SyncTrainingMaster(
        mesh=jmesh(K))).fit(JListIt(JDataSet(x, y), 16))
    tpar.DistributedNetwork(tn, tpar.SyncTrainingMaster(
        mesh=tmesh_of(K), update_sharding=mode)).fit(
        ListDataSetIterator(DataSet(x, y), 16))
    np.testing.assert_allclose(tvec(tn), jvec(jn), rtol=RTOL, atol=ATOL)
    h = introspection.harvest(introspection.latest(tn),
                              introspection.plan_for(tn))
    jh = jintro.harvest(jintro.latest(jn), jintro.plan_for(jn))
    assert h["replicas"] is None and h["iteration"] == jh["iteration"] == 1
    for sect in ("gradient_stats", "update_stats", "activation_stats"):
        for layer, stats in jh[sect].items():
            for key, v in stats.items():
                if isinstance(v, float):
                    np.testing.assert_allclose(
                        h[sect][layer][key], v, rtol=1e-4, atol=1e-7,
                        err_msg=f"{sect}/{layer}/{key}")
