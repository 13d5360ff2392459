"""The sync master across processes: two CPU processes joined in a gloo
group, each holding two of the mesh's four data slots, against the JAX
master on four virtual devices (``jax.devices()[:4]``), the port's
master in one process and the single net.

One pair of children (``tests/_torch_distributed_child.py``, spawned
fresh, JAX never loaded there) runs every job once, started by a module
fixture; each test computes its references while they run, then reads
its jobs' results.  The same numpy weights and
batches go to both packages.  Tolerances are the reference tests' own
(``tests/test_parallel.py``: ``rtol=2e-5, atol=1e-6``); across ranks
and across layouts the parameters are held bit for bit."""

import json
import os

import numpy as np
import pytest

from tests import _torch_distributed_child as xchild

RTOL, ATOL = 2e-5, 1e-6
K = 4


def _fit_job(name, jn, x, y, batch, **kw):
    import jax

    return dict(name=name, kind="fit", conf=jn.conf.to_json(),
                params=jax.device_get(jn.params), x=x, y=y, batch=batch,
                **kw)


def _coupled(kind, updater="adam", lr=0.05):
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


def _dropout_net():
    from deeplearning4j_tpu.models.sequential import MultiLayerNetwork
    from deeplearning4j_tpu.nn import layers as jl
    from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration

    return MultiLayerNetwork(
        NeuralNetConfiguration.builder().seed(5)
        .updater("sgd", learning_rate=0.1).list()
        .layer(jl.DenseLayer(n_in=8, n_out=16, activation="tanh"))
        .layer(jl.OutputLayer(n_in=16, n_out=4, dropout=0.5))
        .build()).init()


def _coupled_data():
    rs = np.random.RandomState(3)
    return (rs.randn(32, 6).astype(np.float32),
            np.eye(3, dtype=np.float32)[rs.randint(0, 3, 32)])


def _stab():
    from deeplearning4j_tpu.nn.conf import TrainingStability

    return TrainingStability(check_every=100)


def _jax_zero_save(directory):
    """A ZeRO sync master on the JAX package's 4 devices, saved with its
    params and updater state laid over the data axis."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as JP

    from deeplearning4j_tpu import parallel as jpar
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
    from deeplearning4j_tpu.datasets.iterator import (
        ListDataSetIterator as JListIt,
    )
    from tests._torch_parallel_common import data, jmesh, pair

    jn, _ = pair(updater="adam", lr=0.1, seed=31)
    x, y = data(32, seed=9)
    mesh = jmesh(K)
    jpar.DistributedNetwork(jn, jpar.SyncTrainingMaster(
        mesh=mesh, update_sharding="zero")).fit(JListIt(JDataSet(x, y), 16))

    def lay(a):
        a = jax.device_get(a)
        spec = JP("data") if a.ndim and a.shape[0] % K == 0 else JP()
        return jax.device_put(a, NamedSharding(mesh, spec))

    trees = {"params": jax.tree.map(lay, jn.params),
             "updater_state": jax.tree.map(lay, jn.updater_state),
             "net_state": jn.net_state}
    jpar.save_checkpoint(directory, jn, trees=trees)
    return jn


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every job in one pair of children; (rank 0's, rank 1's) results
    by job name, plus the inputs the tests compare against."""
    from tests._torch_parallel_common import data, jax_net, pair

    root = tmp_path_factory.mktemp("xproc")
    lone = _lone_rank()
    inputs = {}
    jobs = []
    x48, y48 = data(48)
    for upd in ("sgd", "adam"):
        jn = jax_net(updater=upd, lr=0.1)
        inputs[upd] = jn
        for mode in ("replicated", "zero"):
            jobs.append(_fit_job(f"{upd}_{mode}", jn, x48, y48, 8,
                                 mode=mode,
                                 save=(str(root / f"ckpt_{mode}")
                                       if upd == "adam" else None)))
    x32, y32 = data(32)
    lm = np.ones((32,), np.float32)
    lm[:10] = 0.0                  # slot 0 all masked, slot 1 partly
    jn = jax_net(updater="adam")
    inputs["masked"] = (jn, x32, y32, lm)
    jobs.append(_fit_job("masked", jn, x32, y32, 16, lm=lm))
    xc, yc = _coupled_data()
    for kind in ("bn", "moe"):
        jn = _coupled(kind)
        inputs[kind] = jn
        for mode in ("replicated", "zero"):
            jobs.append(_fit_job(f"{kind}_{mode}", jn, xc, yc, 32,
                                 mode=mode, epochs=2))
    jn = _dropout_net()
    inputs["dropout"] = jn
    jobs.append(_fit_job("dropout", jn, x32, y32, 16))
    # the guard: slot d2's rows (rank 1's) poisoned with NaN at step 1,
    # then labels that overflow the loss in rank 1's rows only
    jn = jax_net(updater="adam", stab=_stab())
    inputs["guard"] = jn
    for mode in ("replicated", "zero"):
        jobs.append(_fit_job(
            f"guard_nan_{mode}", jn, x32, y32, 16, mode=mode,
            poison=dict(worker="d2", at_step=1, until_step=2, mode="nan")))
    big = y32.copy()
    big[16:] *= np.float32(1e38)
    jobs.append(_fit_job("guard_overflow", jn, x32[:32], big, 32))
    x60, y60 = data(60, seed=7)
    jn, _ = pair()
    inputs["eval"] = (jn, x60, y60)
    jobs.append(dict(name="eval", kind="evaluate", conf=jn.conf.to_json(),
                     params=_params(jn), x=x60, y=y60))
    jn = _coupled("moe")
    inputs["eval_moe"] = (jn, xc, yc)
    jobs.append(dict(name="eval_moe", kind="evaluate",
                     conf=jn.conf.to_json(), params=_params(jn), x=xc,
                     y=yc))
    jsave = str(root / "jax_ckpt")
    inputs["jax_save"] = (_jax_zero_save(jsave), jsave)
    jn0, _ = pair(updater="adam", lr=0.1, seed=77)
    jobs.append(dict(name="restore", kind="restore",
                     conf=jn0.conf.to_json(), params=_params(jn0),
                     dir=jsave))
    ji = jax_net(intro=True)
    jobs.append(dict(name="guards", kind="guards", conf=ji.conf.to_json(),
                     params=_params(ji), dir=str(root / "manager")))
    group = xchild.Group(jobs)
    return {"group": group, "inputs": inputs, "root": root, "lone": lone}


def _lone_rank():
    """Rank 0 of a world of two, alone, with a 3 s timeout: a process
    that prints how long it took to fail."""
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    code = ("import time; t = time.monotonic()\n"
            "from deeplearning4j_tpu_torch.parallel import "
            "initialize_distributed as init\n"
            "try:\n"
            f"    init('127.0.0.1:{port}', 2, 0, timeout=3)\n"
            "except Exception as e:\n"
            "    print('failed', time.monotonic() - t, type(e).__name__)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return subprocess.Popen([sys.executable, "-c", code], cwd=root,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _params(jn):
    import jax

    return jax.device_get(jn.params)


def _ranks(runs):
    """Each rank's results (waits for the children)."""
    return runs["group"].wait()


def _both(runs, name):
    a, b = (r[name] for r in _ranks(runs))
    return a, b


def _jax_sync(jn, x, y, batch, lm=None, epochs=1):
    from deeplearning4j_tpu import parallel as jpar
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
    from deeplearning4j_tpu.datasets.iterator import (
        ListDataSetIterator as JListIt,
    )
    from tests._torch_parallel_common import jmesh, jvec

    jpar.DistributedNetwork(jn, jpar.SyncTrainingMaster(mesh=jmesh(K))).fit(
        JListIt(JDataSet(x, y, labels_mask=lm), batch), epochs=epochs)
    return jvec(jn)


def _port_sync(jn, x, y, batch, mode="replicated", epochs=1, lm=None,
               inj=None):
    """The port's master on K slots in this one process."""
    from deeplearning4j_tpu_torch import parallel as tpar
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.datasets.iterator import (
        ListDataSetIterator,
    )
    from deeplearning4j_tpu_torch.resilience import inject_faults
    from tests._torch_parallel_common import port_of, tmesh_of

    tn = port_of(jn)
    d = tpar.DistributedNetwork(tn, tpar.SyncTrainingMaster(
        mesh=tmesh_of(K), update_sharding=mode))
    it = ListDataSetIterator(DataSet(x, y, labels_mask=lm), batch)
    for _ in range(epochs):
        if inj is not None:
            with inject_faults(inj):
                d.fit(it)
        else:
            d.fit(it)
    return tn


@pytest.mark.parametrize("updater", ["sgd", "adam"])
def test_sync_master_across_processes_matches_jax(runs, updater):
    """2 processes x 2 slots == the JAX sync master over 4 devices == the
    single net on the same global batches; the ranks and the two
    layouts agree bit for bit."""
    from tests._torch_parallel_common import jax_net, port_of, tvec

    jn = runs["inputs"][updater]
    single = port_of(jn)
    jref = _jax_sync(jax_net(updater=updater, lr=0.1), *_data48(), 8)
    x, y = _data48()
    for i in range(0, 48, 8):
        single.fit(x[i:i + 8], y[i:i + 8])
    rep = _both(runs, f"{updater}_replicated")
    zero = _both(runs, f"{updater}_zero")
    np.testing.assert_array_equal(rep[0]["params"], rep[1]["params"])
    np.testing.assert_array_equal(zero[0]["params"], zero[1]["params"])
    np.testing.assert_array_equal(zero[0]["params"], rep[0]["params"])
    np.testing.assert_allclose(rep[0]["params"], jref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(rep[0]["params"], tvec(single), rtol=RTOL,
                               atol=ATOL)
    assert rep[0]["iteration"] == 6


def _data48():
    from tests._torch_parallel_common import data

    return data(48)


def test_masked_labels_weighting_across_processes(runs):
    """Rank 0's rows 0-9 masked (slot 0 whole): the loss divides by the
    global mask count, as the JAX master's masked global mean."""
    from tests._torch_parallel_common import jax_net

    jn, x, y, lm = runs["inputs"]["masked"]
    jref = _jax_sync(jax_net(updater="adam"), x, y, 16, lm=lm)
    a, b = _both(runs, "masked")
    np.testing.assert_array_equal(a["params"], b["params"])
    np.testing.assert_allclose(a["params"], jref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", ["bn", "moe"])
def test_coupled_layers_read_the_global_batch(runs, kind):
    """BatchNorm's statistics and the MoE layer's routing over every
    process's rows: both layouts equal the JAX replicated master, the
    port's one-process master and each other bit for bit, BatchNorm's
    running statistics equal on both ranks."""
    from tests._torch_parallel_common import tvec

    jn = runs["inputs"][kind]
    x, y = _coupled_data()
    jref_net = _coupled(kind)
    jref = _jax_sync(jref_net, x, y, 32, epochs=2)
    one = _port_sync(jn, x, y, 32, epochs=2)
    rep, zero = _both(runs, f"{kind}_replicated"), _both(runs, f"{kind}_zero")
    for r in rep + zero:
        np.testing.assert_array_equal(r["params"], rep[0]["params"])
    np.testing.assert_allclose(rep[0]["params"], jref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(rep[0]["params"], tvec(one), rtol=RTOL,
                               atol=ATOL)
    if kind == "bn":
        for k in ("mean", "var"):
            np.testing.assert_array_equal(rep[0]["net_state"]["layer_1"][k],
                                          rep[1]["net_state"]["layer_1"][k])
            np.testing.assert_allclose(
                rep[0]["net_state"]["layer_1"][k],
                np.asarray(jref_net.net_state["layer_1"][k]), rtol=RTOL,
                atol=ATOL)


def test_dropout_masks_are_the_global_batch_rows(runs):
    """Each process draws the global mask's rows it holds: the step
    equals the single net's on the whole batch (a mask drawn per process
    from the start would not)."""
    from tests._torch_parallel_common import data, port_of, tvec

    jn = runs["inputs"]["dropout"]
    x, y = data(32)
    single = port_of(jn)
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.datasets.iterator import (
        ListDataSetIterator,
    )

    single.fit(ListDataSetIterator(DataSet(x, y), 16))
    one = _port_sync(jn, x, y, 16)
    np.testing.assert_array_equal(tvec(one), tvec(single))
    a, b = _both(runs, "dropout")
    np.testing.assert_array_equal(a["params"], b["params"])
    np.testing.assert_allclose(a["params"], tvec(single), rtol=RTOL,
                               atol=ATOL)


def test_guard_takes_the_same_branch_on_both_ranks(runs):
    """NaN rows in rank 1's slot d2 are zeroed and renormalised out on both
    ranks, equal to the one-process master (and ZeRO to replicated bit
    for bit); labels that overflow the loss in rank 1's rows alone make
    both ranks skip the step."""
    from deeplearning4j_tpu_torch.resilience import FaultInjector
    from tests._torch_parallel_common import data, tvec

    jn = runs["inputs"]["guard"]
    x, y = data(32)
    inj = FaultInjector(seed=3).poison_gradients("d2", at_step=1,
                                                 until_step=2, mode="nan")
    one = _port_sync(jn, x, y, 16, inj=inj)
    rep, zero = _both(runs, "guard_nan_replicated"), _both(
        runs, "guard_nan_zero")
    for r in rep + zero:
        assert "worker_poisoned" in r["poisoned"]
        np.testing.assert_array_equal(r["params"], rep[0]["params"])
        assert r["stab"] == rep[0]["stab"]
    np.testing.assert_allclose(rep[0]["params"], tvec(one), rtol=RTOL,
                               atol=ATOL)
    a, b = _both(runs, "guard_overflow")
    for r in (a, b):
        np.testing.assert_array_equal(r["params"], r["p0"])
        assert r["stab"]["nonfinite_total"] == 1.0
    assert a["stab"] == b["stab"]


def test_distributed_evaluate_and_score_match_jax(runs):
    """Each process runs its own rows; every rank counts the whole batch
    (the reference's ``test_distributed_evaluation``) and scores the
    global loss."""
    from deeplearning4j_tpu import parallel as jpar
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
    from deeplearning4j_tpu.datasets.iterator import (
        ListDataSetIterator as JListIt,
    )
    from tests._torch_parallel_common import jmesh

    jn, x, y = runs["inputs"]["eval"]
    jev = jpar.DistributedNetwork(jn, jpar.SyncTrainingMaster(
        mesh=jmesh(K))).evaluate(JListIt(JDataSet(x, y), 16))
    for r in _ranks(runs):
        np.testing.assert_array_equal(r["eval"]["confusion"],
                                      np.asarray(jev.confusion.matrix))
        assert r["eval"]["score"] == pytest.approx(float(jn.score(x, y)),
                                                   rel=1e-5)


def test_distributed_evaluate_and_score_of_the_moe_net_match_jax(runs):
    """The MoE router under ``evaluate`` and ``score`` routes the global
    batch's tokens (its capacity and buffer positions counted over both
    processes' rows), as the JAX master's one program does."""
    from deeplearning4j_tpu import parallel as jpar
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
    from deeplearning4j_tpu.datasets.iterator import (
        ListDataSetIterator as JListIt,
    )
    from tests._torch_parallel_common import jmesh

    jn, x, y = runs["inputs"]["eval_moe"]
    jev = jpar.DistributedNetwork(jn, jpar.SyncTrainingMaster(
        mesh=jmesh(K))).evaluate(JListIt(JDataSet(x, y), 16))
    for r in _ranks(runs):
        np.testing.assert_array_equal(r["eval_moe"]["confusion"],
                                      np.asarray(jev.confusion.matrix))
        np.testing.assert_allclose(
            r["eval_moe"]["outputs"],
            np.concatenate([np.asarray(jn.output(x[i:i + 16]))
                            for i in (0, 16)]), rtol=RTOL, atol=ATOL)
        assert r["eval_moe"]["score"] == pytest.approx(
            float(jn.score(x, y)), rel=1e-5)


def test_two_process_save_has_the_reference_layout(runs):
    """Two manifests and shard files, one meta with ``"processes": 2``
    written by process 0; each ZeRO block saved by the process of its
    slots, a replicated leaf once (by process 0)."""
    for mode in ("zero", "replicated"):
        d = runs["root"] / f"ckpt_{mode}"
        assert sorted(os.listdir(d)) == [
            "checkpoint.json", "manifest-0.json", "manifest-1.json",
            "shards-0.npz", "shards-1.npz"]
        meta = json.load(open(d / "checkpoint.json"))
        assert meta["processes"] == 2 and meta["iteration"] == 6
    d = runs["root"] / "ckpt_zero"
    m0 = json.load(open(d / "manifest-0.json"))["leaves"]
    m1 = json.load(open(d / "manifest-1.json"))["leaves"]
    w = "updater_state/m/layer_0/W"
    assert m0[w]["spec"] == ["data"]
    assert [s["index"][0] for s in m0[w]["shards"]] == [[0, 2], [2, 4]]
    assert [s["index"][0] for s in m1[w]["shards"]] == [[4, 6], [6, 8]]
    d = runs["root"] / "ckpt_replicated"
    m0 = json.load(open(d / "manifest-0.json"))["leaves"]
    m1 = json.load(open(d / "manifest-1.json"))["leaves"]
    assert set(m0) == set(m1) and w in m0
    for p in m0:
        assert m0[p]["spec"] == [] and len(m0[p]["shards"]) == 1
        assert m1[p]["shards"] == [] and m1[p]["dtype"] == m0[p]["dtype"]


def test_two_process_save_restores_in_jax_and_one_process(runs):
    """The ZeRO run's save restores in the JAX package and in one port
    process, equal to the children's parameters bit for bit."""
    from deeplearning4j_tpu import parallel as jpar
    from deeplearning4j_tpu_torch import parallel as tpar
    from tests._torch_parallel_common import jmesh, pair, tvec

    for mode in ("zero", "replicated"):
        d = str(runs["root"] / f"ckpt_{mode}")
        want = _ranks(runs)[0][f"adam_{mode}"]["params"]
        jn, tn = pair(updater="adam", lr=0.1, seed=99)
        jpar.restore_checkpoint(d, jn, mesh=jmesh(2))
        np.testing.assert_array_equal(np.asarray(jn.params_to_vector(),
                                                 np.float32), want)
        tpar.restore_checkpoint(d, tn)
        np.testing.assert_array_equal(tvec(tn).astype(np.float32), want)
        assert tn.iteration == 6


def test_jax_four_device_save_restores_onto_two_processes(runs):
    from tests._torch_parallel_common import jvec

    jn, _ = runs["inputs"]["jax_save"]
    for r in _ranks(runs):
        np.testing.assert_array_equal(r["restore"]["params"],
                                      jvec(jn).astype(np.float32))
        assert r["restore"]["iteration"] == jn.iteration
        np.testing.assert_array_equal(
            r["restore"]["updater_state"]["m"]["layer_0"]["W"],
            np.asarray(jn.updater_state["m"]["layer_0"]["W"]))


@pytest.mark.parametrize("case,label", [
    ("TensorParallel", "A14b"), ("Pipeline", "A14b"),
    ("SequenceParallel", "A14b")])
def test_a14_guards_raise_across_processes(runs, case, label):
    for r in _ranks(runs):
        kind, msg = r["guards"][case]
        assert kind == "NotImplementedError", (case, kind, msg)
        assert label in msg


@pytest.mark.parametrize("case", [
    "DistributedWord2Vec", "DistributedGlove", "CheckpointManager",
    "resilient fit", "introspection", "wrapper introspection",
    "wrapper numerics", "wrapper checkpoint_manager",
    "wrapper retry_policy"])
def test_a14c_and_a14e_paths_run_across_processes(runs, case):
    """Each path that raised before A14c and A14e were ported builds and
    runs a small fit (or a save and a resume) under the two-process mesh
    on both ranks."""
    for r in _ranks(runs):
        assert r["guards"][case] == ("none", ""), r["guards"][case]


def test_a14a_masters_build_across_processes(runs):
    """``ParallelWrapper``, ``ParameterAveragingTrainingMaster`` and an
    elastic sync master build under the two-process mesh (A14a ported);
    nothing in the port names A14a, A14c or A14e (ported too)."""
    import pathlib

    for r in _ranks(runs):
        assert r["guards"]["built"] == ("none", "")
    root = pathlib.Path(__file__).resolve().parent.parent
    for f in (root / "deeplearning4j_tpu_torch").rglob("*.py"):
        text = f.read_text()
        for label in ("A14a", "A14A", "A14c", "A14C", "A14e", "A14E"):
            assert label not in text, (f, label)


def test_a_data_axis_that_does_not_divide_raises(runs):
    for r in _ranks(runs):
        kind, msg = r["guards"]["three slots"]
        assert kind == "ValueError" and "2 processes" in msg


def test_a_missing_rank_fails_within_the_timeout(runs):
    """A world of two whose second rank never comes (started beside the
    children, in the fixture): the first fails within its 3 s timeout
    instead of hanging."""
    out, err = runs["lone"].communicate(timeout=60)
    assert "failed" in out, out + err
    assert float(out.split()[1]) < 30


def test_children_load_no_jax_and_exchange_over_gloo(runs):
    for r in _ranks(runs):
        assert r["jax_loaded"] is False
    a, b = _both(runs, "adam_replicated")
    # six steps, each one exchange of the gradients and the loss
    assert a["stats"]["exchange_count"] == b["stats"]["exchange_count"] == 6
    assert a["stats"]["exchange_bytes"] > 0
