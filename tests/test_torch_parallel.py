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
    # a ParallelWrapper over a mesh that spans two processes (rank 0 of a
    # group of two; the mesh reads the group's size and rank) holds its
    # two slots of the four, resilient or not; a master of the model axis
    # is not ported there (A14b)
    _, tn = pair()
    span = tmesh.Mesh(np.asarray(["cpu"] * 4, dtype=object).reshape(4, 1, 1),
                      tmesh.AXES, processes=2)
    pw = tpar.ParallelWrapper(tn, workers=4, mesh=span,
                              retry_policy=object())
    assert (pw.workers, pw._k_local, pw._lo) == (4, 2, 0)
    tp_span = tmesh.Mesh(np.asarray(["cpu"] * 4, dtype=object).reshape(
        2, 2, 1), tmesh.AXES, processes=2)
    with pytest.raises(NotImplementedError, match="A14b"):
        tpar.TensorParallelTrainingMaster(mesh=tp_span)
    tpar.initialize_distributed()         # one process needs nothing
    with pytest.raises(NotImplementedError,
                       match="A10, meshes across processes and GPUs"):
        tmesh.default_mesh(devices=["cpu", "meta"])


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


# ----------------------------------------------- rows coupled by the batch
def _coupled(kind, updater="sgd", lr=0.1):
    """Dense(6->8) then BatchNormalization or MoELayer(4 experts,
    capacity 1.0), then the head: the layers whose forward couples the
    rows of the batch."""
    from deeplearning4j_tpu.models.sequential import MultiLayerNetwork
    from deeplearning4j_tpu.nn import layers as jl
    from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration

    mid = (jl.BatchNormalization(n_out=8) if kind == "bn" else
           jl.MoELayer(n_in=8, n_out=8, num_experts=4, capacity_factor=1.0))
    return MultiLayerNetwork(
        NeuralNetConfiguration.builder().seed(13)
        .updater(updater, learning_rate=lr).list()
        .layer(jl.DenseLayer(n_in=6, n_out=8, activation="tanh"))
        .layer(mid)
        .layer(jl.OutputLayer(n_in=8, n_out=3, loss="mcxent",
                              activation="softmax")).build()).init()


@pytest.mark.parametrize("mode", ["replicated", "zero"])
@pytest.mark.parametrize("kind", ["bn", "moe"])
def test_sync_master_couples_the_global_batch(kind, mode):
    """BatchNorm's statistics and the MoE layer's routing over the global
    batch, as the reference's one replicated program: the port's
    replicated and ZeRO layouts equal the JAX replicated master (whose
    own ZeRO layout normalises per shard, ROADMAP C2) and the single net
    on the whole batch, BatchNorm's running statistics included."""
    from tests._torch_parallel_common import port_of

    K = 4
    rs = np.random.RandomState(3)
    x = rs.randn(32, 6).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, 32)]
    jn = _coupled(kind)
    tn, single = port_of(jn), port_of(_coupled(kind))
    jpar.DistributedNetwork(jn, jpar.SyncTrainingMaster(mesh=jmesh(K))).fit(
        JListIt(JDataSet(x, y), 32), epochs=2)
    tpar.DistributedNetwork(tn, tpar.SyncTrainingMaster(
        mesh=tmesh_of(K), update_sharding=mode)).fit(
        ListDataSetIterator(DataSet(x, y), 32), epochs=2)
    single.fit(ListDataSetIterator(DataSet(x, y), 32), epochs=2)
    np.testing.assert_allclose(tvec(tn), jvec(jn), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tvec(tn), tvec(single), rtol=RTOL,
                               atol=ATOL)
    if kind == "bn":
        for k in ("mean", "var"):
            np.testing.assert_allclose(
                tn.net_state["layer_1"][k].numpy(),
                np.asarray(jn.net_state["layer_1"][k]), rtol=RTOL,
                atol=ATOL)


def test_sync_master_couples_rows_in_one_recorded_gather():
    """The coupled layer reads the data slots' rows gathered: one
    all-gather over the K slots a forward, in the step's census."""
    from tests._torch_parallel_common import port_of

    K = 4
    shardstats.clear_ledgers()
    tn = port_of(_coupled("bn"))
    x, y = data(32, 6, 3)
    tpar.DistributedNetwork(tn, tpar.SyncTrainingMaster(
        mesh=tmesh_of(K))).fit(ListDataSetIterator(DataSet(x, y), 32))
    ag = shardstats.program_analysis("SyncTrainingMaster.step")[
        "collectives"]["all-gather"]
    assert ag["count"] == 1 and ag["group_sizes"] == [K]
    assert ag["bytes"] == 32 * 8 * 4


def test_sync_master_dropout_equals_the_single_net():
    """Dropout under the sync master: one mask at the global batch's
    shape, drawn from the step's key as the single net draws it, so the
    replicated step equals the single net's on the whole batch."""
    from tests._torch_parallel_common import port_of
    from deeplearning4j_tpu.models.sequential import MultiLayerNetwork
    from deeplearning4j_tpu.nn import layers as jl
    from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration

    def make():
        return MultiLayerNetwork(
            NeuralNetConfiguration.builder().seed(5)
            .updater("sgd", learning_rate=0.1).list()
            .layer(jl.DenseLayer(n_in=8, n_out=16, activation="tanh"))
            .layer(jl.OutputLayer(n_in=16, n_out=4, dropout=0.5))
            .build()).init()

    x, y = data(32)
    tn, single = port_of(make()), port_of(make())
    tpar.DistributedNetwork(tn, tpar.SyncTrainingMaster(
        mesh=tmesh_of(4))).fit(ListDataSetIterator(DataSet(x, y), 16))
    single.fit(ListDataSetIterator(DataSet(x, y), 16))
    np.testing.assert_array_equal(tvec(tn), tvec(single))


# ------------------------------------------------------ the numerics ledger
@pytest.mark.parametrize("interval", [1, 2])
def test_sync_master_carries_the_numerics_ledger(interval):
    """The ledger's blocks under the replicated sync master against the
    JAX master's (from the global gradient and the global batch's
    activations; interval 2: a collecting and a skipping program)."""
    from deeplearning4j_tpu.observability import numerics as jnum
    from deeplearning4j_tpu_torch.observability import numerics
    from tests.test_torch_numerics import batch, make_jax_net, make_net

    K = 4
    jn = make_jax_net(seed=3, updater="adam", interval=interval, sample=0)
    tn = make_net(seed=3, updater="adam", interval=interval, sample=0)
    tn.set_params_vector(np.asarray(jn.params_to_vector()))
    x, y = batch(seed=4, n=32)
    jpar.DistributedNetwork(jn, jpar.SyncTrainingMaster(mesh=jmesh(K))).fit(
        JListIt(JDataSet(x, y), 16), epochs=2)
    tpar.DistributedNetwork(tn, tpar.SyncTrainingMaster(
        mesh=tmesh_of(K))).fit(ListDataSetIterator(DataSet(x, y), 16),
                               epochs=2)
    np.testing.assert_allclose(tvec(tn), jvec(jn), rtol=RTOL, atol=ATOL)
    h, jh = numerics.harvest_model(tn), jnum.harvest_model(jn)
    assert h["iteration"] == jh["iteration"]
    for comp in ("gradients", "moments", "activations"):
        assert set(h[comp]) == set(jh[comp])
        for layer, e in h[comp].items():
            np.testing.assert_allclose(e["max_abs"],
                                       jh[comp][layer]["max_abs"],
                                       rtol=1e-4)
            assert e["verdicts"] == jh[comp][layer]["verdicts"]


def test_zero_sync_master_carries_the_ledger_through_unchanged():
    """Under ZeRO the ``__numerics__`` subtree rides through the step
    unchanged, as the reference's docstring says (and its ZeRO master
    does)."""
    from deeplearning4j_tpu.observability import numerics as jnum
    from deeplearning4j_tpu_torch.observability import numerics
    from tests.test_torch_numerics import batch, make_jax_net, make_net

    jn = make_jax_net(seed=3, updater="adam", interval=1, sample=0)
    tn = make_net(seed=3, updater="adam", interval=1, sample=0)
    tn.set_params_vector(np.asarray(jn.params_to_vector()))
    x, y = batch(seed=4, n=32)
    import jax

    from deeplearning4j_tpu_torch.models.common import tree_clone, tree_leaves

    numerics.ensure_state(tn)
    jnum.ensure_state(jn)
    before = tree_clone(tn.updater_state[numerics.STATE_KEY])
    jbefore = jax.tree_util.tree_leaves(jax.device_get(
        jn.updater_state[jnum.STATE_KEY]))
    jpar.DistributedNetwork(jn, jpar.SyncTrainingMaster(
        mesh=jmesh(4), update_sharding="zero")).fit(
        JListIt(JDataSet(x, y), 16))
    tpar.DistributedNetwork(tn, tpar.SyncTrainingMaster(
        mesh=tmesh_of(4), update_sharding="zero")).fit(
        ListDataSetIterator(DataSet(x, y), 16))
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(tn.updater_state[numerics.STATE_KEY]),
        tree_leaves(before)))
    for a, b in zip(jax.tree_util.tree_leaves(jax.device_get(
            jn.updater_state[jnum.STATE_KEY])), jbefore):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(tvec(tn), jvec(jn), rtol=RTOL, atol=ATOL)


# ------------------------------------------------- graph nets under masters
def _graph_pair(make):
    import jax

    from deeplearning4j_tpu_torch.models.graph import GraphConfiguration
    from deeplearning4j_tpu_torch.models.interop import (
        graph_params_from_numpy,
    )

    jn = make()
    conf = GraphConfiguration.from_json(jn.conf.to_json())
    return jn, graph_params_from_numpy(conf, jax.device_get(jn.params),
                                       jax.device_get(jn.net_state),
                                       device="cpu")


def _small_cg():
    from deeplearning4j_tpu.models.graph import ComputationGraph
    from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu.nn.layers import DenseLayer, OutputLayer

    return ComputationGraph(
        NeuralNetConfiguration.builder().seed(31)
        .updater("sgd", learning_rate=0.2).graph()
        .add_inputs("in")
        .add_layer("d", DenseLayer(n_in=6, n_out=12, activation="tanh"), "in")
        .add_layer("out", OutputLayer(n_in=12, n_out=3), "d")
        .set_outputs("out").build()).init()


def test_sync_dp_trains_computation_graph_resnet():
    """``test_parallel.py:140``: a narrow ResNet (a ComputationGraph with
    BatchNorm) under the sync master, three epochs, against the JAX
    master (BatchNorm's statistics over the global batch in both)."""
    from deeplearning4j_tpu.models.zoo import resnet50

    def make():
        return resnet50(height=16, width=16, n_classes=4, blocks=(1,),
                        stem_stride=1, init_channels=8, lr=0.01)

    jn, tn = _graph_pair(make)
    rs = np.random.RandomState(5)
    x = rs.rand(16, 16, 16, 3).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rs.randint(0, 4, 16)]
    jpar.DistributedNetwork(jn, jpar.SyncTrainingMaster(mesh=jmesh(4))).fit(
        JListIt(JDataSet(x, y), 16), epochs=3)
    tpar.DistributedNetwork(tn, tpar.SyncTrainingMaster(
        mesh=tmesh_of(4))).fit(ListDataSetIterator(DataSet(x, y), 16),
                               epochs=3)
    assert tn.iteration == jn.iteration == 3
    assert np.isfinite(float(tn.score_value))
    assert tn.output(x).shape == (16, 4)
    np.testing.assert_allclose(tvec(tn), jvec(jn), rtol=1e-4, atol=1e-5)


def test_sync_dp_cg_equals_single_device_math():
    """``test_parallel.py:162``: a graph under sync DP == the same graph
    trained serially, and == the JAX master."""
    batches = _batches(4, 16, seed=9, n_in=6, n_out=3)
    jn, tn = _graph_pair(_small_cg)
    _, serial = _graph_pair(_small_cg)
    for x, y in batches:
        serial.fit(x, y)
    xs = np.concatenate([b[0] for b in batches])
    ys = np.concatenate([b[1] for b in batches])
    jpar.DistributedNetwork(jn, jpar.SyncTrainingMaster(mesh=jmesh(4))).fit(
        JListIt(JDataSet(xs, ys), 16))
    tpar.DistributedNetwork(tn, tpar.SyncTrainingMaster(
        mesh=tmesh_of(4))).fit(ListDataSetIterator(DataSet(xs, ys), 16))
    np.testing.assert_allclose(tvec(tn), tvec(serial), rtol=0, atol=2e-5)
    np.testing.assert_allclose(tvec(tn), jvec(jn), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mode", ["replicated", "zero"])
def test_computation_graph_under_wrapper_and_zero(mode):
    """A graph under ``ParallelWrapper`` (averaging every 2 steps) and
    under the ZeRO sync master, against the JAX counterparts."""
    batches = _batches(4, 16, seed=11, n_in=6, n_out=3)
    jn, tn = _graph_pair(_small_cg)
    jpw = jpar.ParallelWrapper(jn, workers=2, mesh=jmesh(2),
                               averaging_frequency=1 if mode == "zero"
                               else 2, update_sharding=mode)
    tpw = tpar.ParallelWrapper(tn, workers=2, mesh=tmesh_of(2),
                               averaging_frequency=1 if mode == "zero"
                               else 2, update_sharding=mode)
    jpw.fit(iter([JDataSet(x, y) for x, y in batches]))
    tpw.fit(iter([DataSet(x, y) for x, y in batches]))
    np.testing.assert_allclose(tvec(tn), jvec(jn), rtol=RTOL, atol=ATOL)
    if mode == "zero":
        jz, tz = _graph_pair(_small_cg)
        xs = np.concatenate([b[0] for b in batches])
        ys = np.concatenate([b[1] for b in batches])
        jpar.DistributedNetwork(jz, jpar.SyncTrainingMaster(
            mesh=jmesh(4), update_sharding="zero")).fit(
            JListIt(JDataSet(xs, ys), 16))
        tpar.DistributedNetwork(tz, tpar.SyncTrainingMaster(
            mesh=tmesh_of(4), update_sharding="zero")).fit(
            ListDataSetIterator(DataSet(xs, ys), 16))
        np.testing.assert_allclose(tvec(tz), jvec(jz), rtol=RTOL, atol=ATOL)
