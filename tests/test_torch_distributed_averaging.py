"""Parameter averaging and elasticity across processes: two CPU processes
joined in a gloo group, each holding two of the mesh's four data slots,
running ``ParallelWrapper`` (replicated at F 1 and 3, SGD and Adam,
``average_updaters`` both ways; ZeRO), ``ParameterAveragingTrainingMaster``,
``elastic=`` on the wrapper and the sync master, and the sync master's
ZeRO with gradient normalization.

They are held against the JAX package on ``jax.devices()[:4]`` with the
same numpy weights and batches, at the reference tests' tolerances
(``tests/test_parallel.py``: ``rtol=2e-5, atol=1e-6``;
``tests/test_zero.py``: ``rtol=1e-5, atol=1e-7`` for ZeRO against
replicated), and against the port itself: the two processes equal the
one-process four-slot run bit for bit, and the ranks each other.

One pair of children (``tests/_torch_distributed_child.py``, JAX never
loaded there) runs every job, started by a module fixture; the
one-process runs are the same job functions called here."""

import contextlib
import gc

import numpy as np
import pytest
import torch

from tests import _torch_distributed_child as xchild

RTOL, ATOL = 2e-5, 1e-6
Z_RTOL, Z_ATOL = 1e-5, 1e-7
K = 4
WRAPPER = [("sgd", 1, True, "iter"), ("sgd", 3, True, "list"),
           ("adam", 1, True, "list"), ("adam", 3, True, "iter"),
           ("adam", 1, False, "iter"), ("adam", 3, False, "iter")]
NORMS = ["clip_l2_per_layer", "clip_l2_per_param_type"]


def _params(jn):
    import jax

    return jax.device_get(jn.params)


def _job(name, jn, x, y, batch, kind="wrapper", **kw):
    return dict(name=name, kind=kind, conf=jn.conf.to_json(),
                params=_params(jn), x=x, y=y, batch=batch, **kw)


def _norm_net(kind):
    from deeplearning4j_tpu.models.sequential import MultiLayerNetwork
    from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu.nn.layers import DenseLayer, OutputLayer

    return MultiLayerNetwork(
        NeuralNetConfiguration.builder().seed(41)
        .updater("adam", learning_rate=0.05)
        .gradient_normalization(kind, 0.05).list()
        .layer(DenseLayer(n_in=8, n_out=16, activation="tanh"))
        .layer(OutputLayer(n_in=16, n_out=4, loss="mcxent",
                           activation="softmax")).build()).init()


def _stab():
    from deeplearning4j_tpu.nn.conf import TrainingStability

    return TrainingStability(check_every=1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every job in one pair of children; the jobs and their inputs by
    name."""
    from tests._torch_parallel_common import data, jax_net

    root = tmp_path_factory.mktemp("xavg")
    jobs = {}
    x96, y96 = data(96, seed=4)
    for upd, freq, avg, src in WRAPPER:
        jobs[f"w_{upd}_{freq}_{avg}"] = _job(
            f"w_{upd}_{freq}_{avg}", jax_net(updater=upd, lr=0.1), x96, y96,
            4, freq=freq, avg=avg, source=src)
    jobs["captured"] = dict(jobs["w_adam_3_True"], name="captured",
                            emulate_capture=True)
    jobs["zero"] = _job("zero", jax_net(updater="adam"), x96, y96, 8,
                        mode="zero", source="list",
                        save=str(root / "zero_ckpt"))
    jobs["zero_rep"] = _job("zero_rep", jax_net(updater="adam"), x96, y96, 8,
                            source="list")
    jobs["pam"] = _job("pam", jax_net(updater="adam"), x96, y96, 8, freq=2,
                       epochs=2, source="list")
    x28, y28 = data(28, seed=3)
    jobs["ragged"] = _job("ragged", jax_net(updater="adam"), x28, y28, 4,
                          freq=2)
    x52, y52 = data(52, seed=6)
    jobs["ragged_native"] = _job("ragged_native", jax_net(updater="adam"),
                                 x52, y52, 4, freq=2, source="list")
    x16, y16 = data(16, seed=5)
    jobs["evict"] = _job("evict", jax_net(updater="sgd", lr=0.1), x16, y16,
                         4, evict="3",
                         elastic=dict(readmit_after_windows=10 ** 9))
    x128, y128 = data(128, seed=11)
    jobs["kill"] = _job(
        "kill", jax_net(updater="sgd", lr=0.05), x128, y128, 4,
        elastic=dict(evict_after_flags=None),
        faults=[["kill_worker", dict(worker="3", at_step=2, until_step=6)]],
        fault_seed=2)
    jobs["hang"] = _job(
        "hang", jax_net(), x128, y128, 4,
        elastic=dict(evict_after_flags=None, hang_stall_s=0.0),
        faults=[["hang_worker", dict(worker="2", at_step=1, until_step=4)]])
    x16b, y16b = data(16, seed=8)
    jobs["poison"] = _job(
        "poison", jax_net(updater="sgd", lr=0.1, stab=_stab()), x16b, y16b,
        4, faults=[["poison_gradients", dict(worker="3", at_step=0,
                                             until_step=1)]],
        fault_seed=1)
    jobs["straggler"] = _job(
        "straggler", jax_net(updater="sgd", lr=0.05), x128, y128, 4,
        elastic=dict(evict_after_flags=2, readmit_after_windows=2,
                     hang_stall_s=0.0, straggler_window=4,
                     straggler_min_excess_s=0.03),
        faults=[["delay_worker", dict(worker="3", seconds=0.1)]],
        fits=[{}, {"clear_delay": "3"}])
    x32, y32 = data(32, seed=17)
    jobs["sync_evict"] = _job(
        "sync_evict", jax_net(updater="sgd", lr=0.1), x32, y32, 8,
        kind="fit", elastic={},
        faults=[["kill_worker", dict(worker="d2", at_step=0)]], fault_seed=4)
    x48, y48 = data(48, seed=9)
    for gn in NORMS:
        for mode in ("zero", "replicated"):
            jobs[f"norm_{gn}_{mode}"] = _job(
                f"norm_{gn}_{mode}", _norm_net(gn), x48, y48, 16,
                kind="fit", mode=mode)
    jobs["streams"] = dict(name="streams", kind="streams")
    group = xchild.Group(list(jobs.values()))
    out = {"group": group, "jobs": jobs, "root": root}
    yield out
    out.clear()              # the results and the one-process runs' nets
    gc.collect()


def _both(runs, name):
    return tuple(r[name] for r in runs["group"].wait())


@contextlib.contextmanager
def _threads(n=2):
    """The children's intra-op thread count, for the one-process runs."""
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def _one(runs, name, **over):
    """The job's run in this process: one process, four slots (once)."""
    key = (name, tuple(sorted(over.items())))
    if key not in runs.setdefault("one", {}):
        job = dict(runs["jobs"][name], **over)
        with _threads():
            runs["one"][key] = xchild.JOBS[job["kind"]](job)
    return runs["one"][key]


def _equal_trees(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _equal_trees(a[k], b[k], f"{path}/{k}")
    else:
        np.testing.assert_array_equal(a, b, err_msg=path)


def _bitwise(runs, name, one=None):
    """Both ranks equal each other and the one-process run, every leaf."""
    a, b = _both(runs, name)
    one = one or _one(runs, name)
    for r in (a, b):
        np.testing.assert_array_equal(r["params"], one["params"])
        _equal_trees(r["updater_state"], one["updater_state"])
        _equal_trees(r["net_state"], one["net_state"])
        assert r["iteration"] == one["iteration"]
    np.testing.assert_array_equal([a["score"], b["score"]],
                                  [one["score"]] * 2)   # NaN equal to NaN
    return a, b, one


def _jax_wrapper(job, elastic=None, inj=None, evict=None, zero=False):
    """The JAX wrapper on ``jax.devices()[:4]`` over ``job``'s weights and
    batches: its params vector, updater state and flight events."""
    from deeplearning4j_tpu import parallel as jpar
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
    from deeplearning4j_tpu.datasets.iterator import (
        ListDataSetIterator as JIt,
    )
    from deeplearning4j_tpu.models.sequential import MultiLayerNetwork
    from deeplearning4j_tpu.nn.conf import MultiLayerConfiguration
    from deeplearning4j_tpu.observability import get_flight_recorder
    from deeplearning4j_tpu.resilience import inject_faults
    from tests._torch_parallel_common import jmesh, jvec
    import jax.numpy as jnp

    jn = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        job["conf"])).init()
    jn.params = {k: {n: jnp.asarray(v) for n, v in lv.items()}
                 for k, lv in job["params"].items()}
    x, y, b = job["x"], job["y"], job["batch"]
    since = len(get_flight_recorder().events())
    pw = jpar.ParallelWrapper(
        jn, workers=K, averaging_frequency=job.get("freq", 1),
        average_updaters=job.get("avg", True), mesh=jmesh(K),
        elastic=elastic if elastic is not None else False,
        update_sharding="zero" if zero else "replicated")
    if evict is not None:
        pw.elastic.evict(evict, "manual", step=0)
    it = (JIt(JDataSet(x, y), b) if job.get("source") == "list" else
          iter([JDataSet(x[i:i + b], y[i:i + b])
                for i in range(0, len(x), b)]))
    with (inject_faults(inj) if inj is not None
          else contextlib.nullcontext()):
        pw.fit(it)
    events = [(e.kind, dict(e.attrs)) for e in
              get_flight_recorder().events()[since:]
              if e.kind in ("elastic_eviction", "elastic_readmission")]
    return jvec(jn), jn, events


def _steps(events, kind):
    return [(a["worker"], a.get("reason"), a["step"])
            for k, a in events if k == kind]


@pytest.mark.parametrize("upd,freq,avg,src", WRAPPER)
def test_wrapper_across_processes_matches_jax(runs, upd, freq, avg, src):
    """2 processes x 2 slots == the one-process four-slot wrapper bit for
    bit, every leaf, on both ranks; == the JAX wrapper over 4 devices at
    the reference's tolerance (with un-averaged updaters, the facade's
    updater state is replica 0's in both)."""
    from tests._torch_parallel_common import assert_trees_close, jtree

    name = f"w_{upd}_{freq}_{avg}"
    a, _, _ = _bitwise(runs, name)
    jv, jn, _ = _jax_wrapper(runs["jobs"][name])
    np.testing.assert_allclose(a["params"], jv, rtol=RTOL, atol=ATOL)
    assert_trees_close({k: v for k, v in jtree(jn.updater_state).items()},
                       a["updater_state"], RTOL, ATOL)
    assert a["iteration"] == len(runs["jobs"][name]["x"]) // 4 // K


def test_local_capture_replays_between_exchanges(runs):
    """With the card's capture calls emulated on the CPU, each process
    captures its replicas' steps once (the program ``window_local``, no
    collective inside) and replays it in the next window, the exchange
    and the average run between replays; the params equal the eager
    run's bit for bit."""
    a, b = _both(runs, "captured")
    want = _both(runs, "w_adam_3_True")[0]
    for r in (a, b):
        assert r["graphs"] == {"captures": 1, "replays": 1,
                               "programs": ["window_local"]}
        np.testing.assert_array_equal(r["params"], want["params"])
        _equal_trees(r["updater_state"], want["updater_state"])


def test_zero_window_across_processes(runs):
    """The ZeRO wrapper across processes: the ranks' params bit for bit,
    equal to the one-process ZeRO wrapper, within ``tests/test_zero.py``'s
    tolerance of the two-process replicated run and of the JAX ZeRO
    wrapper at the reference's."""
    a, b = _both(runs, "zero")
    np.testing.assert_array_equal(a["params"], b["params"])
    one = _one(runs, "zero", save=None)
    np.testing.assert_array_equal(a["params"], one["params"])
    rep = _both(runs, "zero_rep")[0]
    np.testing.assert_allclose(a["params"], rep["params"], rtol=Z_RTOL,
                               atol=Z_ATOL)
    jv, _, _ = _jax_wrapper(runs["jobs"]["zero"], zero=True)
    np.testing.assert_allclose(a["params"], jv, rtol=RTOL, atol=ATOL)


def test_zero_wrapper_save_restores_in_jax_and_one_process(runs):
    """The two-process ZeRO wrapper's ``state_trees()`` save: each process
    wrote its slots' blocks; it restores in the JAX package and in one
    port process equal to the children's params bit for bit, the moments
    to the one-process ZeRO wrapper's (a rank's own tensors hold only its
    slots' blocks current)."""
    import json
    import os

    from deeplearning4j_tpu import parallel as jpar
    from deeplearning4j_tpu_torch import parallel as tpar
    from tests._torch_parallel_common import jmesh, pair, tvec

    a, _ = _both(runs, "zero")
    d = runs["root"] / "zero_ckpt"
    assert sorted(os.listdir(d)) == [
        "checkpoint.json", "manifest-0.json", "manifest-1.json",
        "shards-0.npz", "shards-1.npz"]
    m1 = json.load(open(d / "manifest-1.json"))["leaves"]
    assert [s["index"][0] for s in
            m1["updater_state/m/layer_0/W"]["shards"]] == [[4, 6], [6, 8]]
    jn, tn = pair(updater="adam", seed=99)
    jpar.restore_checkpoint(str(d), jn, mesh=jmesh(2))
    np.testing.assert_array_equal(
        np.asarray(jn.params_to_vector(), np.float32), a["params"])
    tpar.restore_checkpoint(str(d), tn)
    np.testing.assert_array_equal(tvec(tn).astype(np.float32), a["params"])
    one = _one(runs, "zero", save=None)
    for slot in ("m", "v"):
        np.testing.assert_array_equal(
            tn.updater_state[slot]["layer_0"]["W"].numpy(),
            one["updater_state"][slot]["layer_0"]["W"])
        np.testing.assert_array_equal(
            np.asarray(jn.updater_state[slot]["layer_0"]["W"]),
            one["updater_state"][slot]["layer_0"]["W"])
    np.testing.assert_array_equal(
        a["updater_state"]["m"]["layer_0"]["W"][:4],
        one["updater_state"]["m"]["layer_0"]["W"][:4])


def test_param_avg_master_across_processes(runs):
    """``ParameterAveragingTrainingMaster`` (a wrapper an epoch, 2 epochs
    at F 2) over ``DistributedNetwork``: the ranks and the one-process
    master bit for bit, the JAX master at the reference's tolerance."""
    from deeplearning4j_tpu import parallel as jpar
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
    from deeplearning4j_tpu.datasets.iterator import (
        ListDataSetIterator as JIt,
    )
    from tests._torch_parallel_common import jax_net, jmesh, jvec

    a, _, _ = _bitwise(runs, "pam")
    jn = jax_net(updater="adam")
    job = runs["jobs"]["pam"]
    jpar.DistributedNetwork(jn, jpar.ParameterAveragingTrainingMaster(
        workers=K, averaging_frequency=2, mesh=jmesh(K))).fit(
        JIt(JDataSet(job["x"], job["y"]), 8), epochs=2)
    np.testing.assert_allclose(a["params"], jvec(jn), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["ragged", "ragged_native"])
def test_ragged_tail_pad_weights_across_processes(runs, name):
    """A tail that fills no whole window (7 and 13 minibatches at K 4,
    F 2): the global ``[K]`` pad weights leave the pad-filled replicas
    out on both ranks, as the one-process wrapper and the JAX one."""
    a, _, _ = _bitwise(runs, name)
    jv, _, _ = _jax_wrapper(runs["jobs"][name])
    np.testing.assert_allclose(a["params"], jv, rtol=RTOL, atol=ATOL)


def test_manual_eviction_renormalizes_across_processes(runs):
    """Replica 3 (rank 1's) evicted by hand: the average is the healthy
    replicas' mean on both ranks (the single nets' oracle), the
    one-process wrapper's bit for bit and the JAX wrapper's."""
    from deeplearning4j_tpu.parallel.elastic import ElasticConfig as JEl
    from tests._torch_parallel_common import port_of, tvec

    a, b, _ = _bitwise(runs, "evict")
    assert a["masks"] == b["masks"] == [(0, [1.0, 1.0, 1.0, 0.0])]
    job = runs["jobs"]["evict"]
    jv, jn, _ = _jax_wrapper(job, elastic=JEl(readmit_after_windows=10 ** 9),
                             evict="3")
    np.testing.assert_allclose(a["params"], jv, rtol=RTOL, atol=ATOL)
    x, y = job["x"], job["y"]
    reps = []
    for r in (0, 1, 2):
        net = port_of(jn)
        from deeplearning4j_tpu_torch.models.interop import (
            params_from_numpy,
        )
        net = params_from_numpy(net.conf, job["params"], device="cpu")
        net.fit(x[4 * r:4 * r + 4], y[4 * r:4 * r + 4])
        reps.append(tvec(net))
    np.testing.assert_allclose(a["params"], np.mean(reps, axis=0),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["kill", "hang"])
def test_faults_evict_and_readmit_at_the_reference_windows(runs, name):
    """A killed (3, steps 2-6) or hung (2, steps 1-4) replica is evicted
    and readmitted at the same windows as in the JAX wrapper, on both
    ranks with equal masks; the params equal the one-process run bit for
    bit and the JAX run at the reference's tolerance."""
    from deeplearning4j_tpu.parallel.elastic import ElasticConfig as JEl
    from deeplearning4j_tpu.resilience import FaultInjector as JInj

    a, b, one = _bitwise(runs, name)
    assert a["masks"] == b["masks"] == one["masks"]
    job = runs["jobs"][name]
    inj = JInj(seed=job.get("fault_seed", 3))
    for method, kw in job["faults"]:
        getattr(inj, method)(**kw)
    jv, _, jev = _jax_wrapper(job, elastic=JEl(**job["elastic"]), inj=inj)
    np.testing.assert_allclose(a["params"], jv, rtol=RTOL, atol=ATOL)
    for kind in ("elastic_eviction", "elastic_readmission"):
        want = _steps(jev, kind)
        assert want, kind
        for r in (a, b):
            assert _steps(r["events"], kind) == want
    assert a["evicted"] == b["evicted"] == []


def test_poisoned_replica_of_rank_one_is_weighted_out(runs):
    """Under a stability policy replica 3's NaN window is weighted out on
    both ranks (the gathered finite flags): the healthy mean, the JAX
    wrapper's params, and a ``replica_poisoned`` event naming replica 3
    on both ranks."""
    from deeplearning4j_tpu.resilience import FaultInjector as JInj

    a, b, _ = _bitwise(runs, "poison")
    job = runs["jobs"]["poison"]
    inj = JInj(seed=1).poison_gradients("3", at_step=0, until_step=1)
    jv, _, _ = _jax_wrapper(job, inj=inj)
    np.testing.assert_allclose(a["params"], jv, rtol=RTOL, atol=ATOL)
    for r in (a, b):
        ev = [e for k, e in r["events"] if k == "replica_poisoned"]
        assert [e["worker"] for e in ev] == ["3"]


def test_straggler_of_rank_one_evicted_and_readmitted_on_both_ranks(runs):
    """Replica 3 (rank 1's) delayed by 100 ms: each process times its own
    replicas and the times are gathered, so both ranks flag it and evict
    it at the same window (equal masks every window, equal events), count
    the same barrier stalls, and readmit it on probation.  The other
    replicas' times are the host's own: a loaded host may flag one of
    them too, on both ranks alike."""
    a, b = _both(runs, "straggler")
    assert a["masks"] == b["masks"]
    assert a["stalls"] == b["stalls"] > 0
    assert any(m[3] == 0.0 for _, m in a["masks"])
    for kind in ("elastic_eviction", "elastic_readmission"):
        assert _steps(a["events"], kind) == _steps(b["events"], kind)
    first = _steps(a["events"], "elastic_eviction")[0]
    assert first[:2] == ("3", "straggler")
    assert any(w == "3" and step > first[2] for w, _, step in
               _steps(a["events"], "elastic_readmission"))
    np.testing.assert_array_equal(a["params"], b["params"])


def test_sync_master_eviction_across_processes(runs):
    """Slot d2 (rank 1's) dies at step 0: every rank weights its rows out
    with the same mask, the healthy rows' math of the single net and the
    JAX master's eviction."""
    from deeplearning4j_tpu import parallel as jpar
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
    from deeplearning4j_tpu.datasets.iterator import (
        ListDataSetIterator as JIt,
    )
    from deeplearning4j_tpu.parallel.elastic import ElasticConfig as JEl
    from deeplearning4j_tpu.resilience import FaultInjector as JInj
    from deeplearning4j_tpu.resilience import inject_faults as jinject
    from tests._torch_parallel_common import jax_net, jmesh, jvec, port_of
    from tests._torch_parallel_common import tvec

    a, b = _both(runs, "sync_evict")
    np.testing.assert_array_equal(a["params"], b["params"])
    assert a["masks"] == b["masks"]
    assert all(m == [1.0, 1.0, 0.0, 1.0] for _, m in a["masks"])
    assert a["summary"]["evicted"]["d2"]["reason"] == "dead"
    job = runs["jobs"]["sync_evict"]
    x, y = job["x"], job["y"]
    jn = jax_net(updater="sgd", lr=0.1)
    ref = port_of(jn)
    keep = np.r_[0:4, 6:8]
    for i in range(4):
        ref.fit(x[i * 8:(i + 1) * 8][keep], y[i * 8:(i + 1) * 8][keep])
    np.testing.assert_allclose(a["params"], tvec(ref), rtol=RTOL, atol=ATOL)
    jm = jpar.SyncTrainingMaster(mesh=jmesh(K), elastic=JEl())
    with jinject(JInj(seed=4).kill_worker(jm.elastic.workers[2],
                                          at_step=0)):
        jpar.DistributedNetwork(jn, jm).fit(JIt(JDataSet(x, y), 8))
    np.testing.assert_allclose(a["params"], jvec(jn), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("gn", NORMS)
def test_sync_master_zero_gradient_normalization_across_processes(runs, gn):
    """ZeRO with clipping by L2 per layer and per parameter: each norm is
    the whole leaf's, so both ranks equal the two-process replicated
    master bit for bit (which normalizes the whole summed gradient), the
    one-process ZeRO master at ``tests/test_zero.py``'s tolerance (the
    processes' gradients are summed in rank order there) and the JAX ZeRO
    master at the reference's."""
    from deeplearning4j_tpu import parallel as jpar
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
    from deeplearning4j_tpu.datasets.iterator import (
        ListDataSetIterator as JIt,
    )
    from tests._torch_parallel_common import jmesh, jvec

    a, b = _both(runs, f"norm_{gn}_zero")
    np.testing.assert_array_equal(a["params"], b["params"])
    rep = _both(runs, f"norm_{gn}_replicated")[0]
    np.testing.assert_array_equal(a["params"], rep["params"])
    one = _one(runs, f"norm_{gn}_zero")
    np.testing.assert_allclose(a["params"], one["params"], rtol=Z_RTOL,
                               atol=Z_ATOL)
    assert not np.allclose(a["params"], a["p0"])
    jn = _norm_net(gn)
    job = runs["jobs"][f"norm_{gn}_zero"]
    jpar.DistributedNetwork(jn, jpar.SyncTrainingMaster(
        mesh=jmesh(K), update_sharding="zero")).fit(
        JIt(JDataSet(job["x"], job["y"]), 16))
    np.testing.assert_allclose(a["params"], jvec(jn), rtol=RTOL, atol=ATOL)


def test_large_gathers_go_over_parallel_streams(runs):
    """A gather of 12 MiB goes over the mesh's gloo streams in chunks
    (float32, and bfloat16 as bytes) and equals the stack of every
    rank's tensor bit for bit."""
    for r in runs["group"].wait():
        for dt in ("torch.float32", "torch.bfloat16"):
            assert r["streams"][dt] == (True, 3)


def test_children_load_no_jax(runs):
    for r in runs["group"].wait():
        assert r["jax_loaded"] is False
