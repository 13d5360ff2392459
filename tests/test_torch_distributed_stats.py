"""Training statistics and resilient fits across processes: two CPU
processes joined in a gloo group, each holding two of the mesh's four
data slots.

- The introspection policy and the numerics ledger under the sync master
  (replicated and ZeRO) and under ``ParallelWrapper`` (replicated at F 1
  and 2, and ZeRO), against the JAX package on ``jax.devices()[:4]``
  with the same numpy weights and batches, at the reference tests'
  tolerances (``tests/test_introspection.py``' ``rtol=1e-4``; the
  ledger's max-abs to ``rtol=1e-4`` and every verdict equal, as
  ``tests/test_torch_parallel.py`` holds the one-process master).  The
  ranks' vectors are equal bit for bit; the wrapper's two processes
  equal its one-process four-slot run bit for bit.
- A stride-sampled ledger whose sample crosses the process boundary:
  its sampled counts are the global batch's sample (a per-rank sample
  would count twice as many values), equal to the JAX master's.
- A listener on one rank only, with both policies on under the wrapper:
  every rank folds back at the same windows.
- Resilient fits (``checkpoint_manager=``, ``retry_policy=``) of both
  masters: a fatal fault on every rank, the resume from the last commit,
  a retryable fault and a preemption notice on rank 1 alone, a fatal
  fault on rank 1 alone; the resumed run equals the unfaulted one bit
  for bit, and the committed directory restores in the JAX package and
  in one process.

One pair of children (``tests/_torch_distributed_child.py``, JAX never
loaded there) runs every job, started by a module fixture; the
one-process runs are the same job functions called here."""

import contextlib
import gc
import os

import numpy as np
import pytest
import torch

from tests import _torch_distributed_child as xchild

RTOL, ATOL = 2e-5, 1e-6
I_RTOL, I_ATOL = 1e-4, 1e-7       # tests/test_introspection.py, harvests
K = 4
WRAPPED = [("replicated", 1), ("replicated", 2), ("zero", 1)]
LISTENED = [True, False]          # average_updaters
RESILIENT = [("sync", "replicated"), ("sync", "zero"),
             ("wrapper", "replicated"), ("wrapper", "zero")]


def _params(jn):
    import jax

    return jax.device_get(jn.params)


def _job(name, jn, x, y, batch, kind="fit", **kw):
    return dict(name=name, kind=kind, conf=jn.conf.to_json(),
                params=_params(jn), x=x, y=y, batch=batch, **kw)


def _numerics_net(**kw):
    from tests.test_torch_numerics import make_jax_net

    return make_jax_net(seed=3, updater="adam", **kw)


def _observed_net(updater="adam", interval=2):
    """The introspection policy and the numerics ledger together."""
    from deeplearning4j_tpu.models.sequential import MultiLayerNetwork
    from deeplearning4j_tpu.nn import conf as jconf
    from deeplearning4j_tpu.nn.layers import DenseLayer, OutputLayer

    b = (jconf.NeuralNetConfiguration.builder().seed(21)
         .updater(updater, learning_rate=0.05)
         .training_introspection(jconf.TrainingIntrospection())
         .training_numerics(interval=interval, sample=0))
    return MultiLayerNetwork(
        b.list().layer(DenseLayer(n_in=8, n_out=16, activation="tanh"))
        .layer(OutputLayer(n_in=16, n_out=4, loss="mcxent",
                           activation="softmax")).build()).init()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every job in one pair of children; the jobs by name."""
    from tests._torch_parallel_common import data, jax_net
    from tests.test_torch_numerics import batch

    root = tmp_path_factory.mktemp("xstats")
    jobs = {}
    x32, y32 = data(32, seed=2)
    for mode in ("replicated", "zero"):
        jobs[f"intro_{mode}"] = _job(f"intro_{mode}", jax_net(intro=True),
                                     x32, y32, 16, mode=mode)
    xn, yn = batch(seed=4, n=32)
    for interval in (1, 2):
        jobs[f"num_{interval}"] = _job(
            f"num_{interval}", _numerics_net(interval=interval, sample=0),
            xn, yn, 16, epochs=2)
    jobs["num_zero"] = _job("num_zero", _numerics_net(interval=1, sample=0),
                            xn, yn, 16, mode="zero")
    jobs["num_stride"] = _job("num_stride",
                              _numerics_net(interval=1, sample=7), xn, yn,
                              32)
    x64, y64 = data(64, seed=5)
    for mode, freq in WRAPPED:
        # an interval-gated ledger needs F 1 in the wrapper
        jobs[f"w_{mode}_{freq}"] = _job(
            f"w_{mode}_{freq}", _observed_net(interval=3 - freq), x64, y64,
            4, kind="wrapper", mode=mode, freq=freq)
    for avg in LISTENED:
        # a listener on rank 1 alone, both policies on
        jobs[f"w_listener_{avg}"] = _job(
            f"w_listener_{avg}", _observed_net(interval=1), x64, y64, 4,
            kind="wrapper", avg=avg, listener_rank=1)
    for master, mode in RESILIENT:
        # the sync master: 6 steps of 8 rows; the wrapper: 4 windows of
        # 4 replicas x 4 rows
        name = f"res_{master}_{mode}"
        x, y = data(48 if master == "sync" else 64, seed=7)
        jobs[name] = _job(
            name, jax_net(updater="adam", lr=0.05), x, y,
            8 if master == "sync" else 4, kind="resilient", master=master,
            mode=mode, dir=str(root / name), fatal_at=3, retry_at=2,
            preempt_at=3, **{"async": mode == "zero"})
    group = xchild.Group(list(jobs.values()))
    out = {"group": group, "jobs": jobs, "root": root}
    yield out
    out.clear()
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


def _one(runs, name):
    """The job's run in this process: one process, four slots."""
    job = runs["jobs"][name]
    with _threads():
        return xchild.JOBS[job["kind"]](job)


def _jax_net_of(job):
    import jax.numpy as jnp

    from deeplearning4j_tpu.models.sequential import MultiLayerNetwork
    from deeplearning4j_tpu.nn.conf import MultiLayerConfiguration

    jn = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        job["conf"])).init()
    jn.params = {k: {n: jnp.asarray(v) for n, v in lv.items()}
                 for k, lv in job["params"].items()}
    return jn


def _jax_sync(job, mode="replicated"):
    """The JAX sync master over the job's weights and batches."""
    from deeplearning4j_tpu import parallel as jpar
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
    from deeplearning4j_tpu.datasets.iterator import (
        ListDataSetIterator as JIt,
    )
    from tests._torch_parallel_common import jmesh

    jn = _jax_net_of(job)
    jpar.DistributedNetwork(jn, jpar.SyncTrainingMaster(
        mesh=jmesh(K), update_sharding=mode)).fit(
        JIt(JDataSet(job["x"], job["y"]), job["batch"]),
        epochs=job.get("epochs", 1))
    return jn


def _jax_wrapper(job):
    from deeplearning4j_tpu import parallel as jpar
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
    from tests._torch_parallel_common import jmesh

    jn = _jax_net_of(job)
    x, y, b = job["x"], job["y"], job["batch"]
    jpar.ParallelWrapper(
        jn, workers=K, averaging_frequency=job.get("freq", 1),
        mesh=jmesh(K), update_sharding=job.get("mode", "replicated")).fit(
        iter([JDataSet(x[i:i + b], y[i:i + b]) for i in range(0, len(x), b)]))
    return jn


def _port_intro(packed, conf_json):
    """A harvested ``__introspect__`` vector (or ``[K, N]`` stack)."""
    from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
    from deeplearning4j_tpu_torch.observability import introspection

    conf = MultiLayerConfiguration.from_json(conf_json)
    plan = introspection.plan_for(_bare(conf))
    return introspection.harvest({"packed": packed}, plan)


def _port_numerics(packed, conf_json):
    from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
    from deeplearning4j_tpu_torch.observability import numerics

    conf = MultiLayerConfiguration.from_json(conf_json)
    return numerics.harvest({"packed": packed}, numerics.plan_for(_bare(conf)))


def _bare(conf):
    """A net-like holder of ``conf`` and its layers (what the plans
    read)."""
    from deeplearning4j_tpu_torch.models.sequential import MultiLayerNetwork

    return MultiLayerNetwork(conf)


def _close_harvests(h, jh, rtol=I_RTOL, atol=I_ATOL):
    assert h["iteration"] == jh["iteration"]
    for sect in ("gradient_stats", "update_stats", "activation_stats"):
        for layer, stats in jh[sect].items():
            for key, v in stats.items():
                if isinstance(v, (float, list)):
                    np.testing.assert_allclose(
                        h[sect][layer][key], v, rtol=rtol, atol=atol,
                        err_msg=f"{sect}/{layer}/{key}")


def _equal_trees(a, b, path=""):
    if isinstance(b, dict):
        assert set(a) == set(b), path
        for k in b:
            _equal_trees(a[k], b[k], f"{path}/{k}")
    else:
        np.testing.assert_array_equal(a, b, err_msg=path)


def _equal_observed(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ------------------------------------------------------------ the sync master
@pytest.mark.parametrize("mode", ["replicated", "zero"])
def test_sync_master_introspection_across_processes_matches_jax(runs, mode):
    """The global gradient's, the update's and the parameters' norms and
    the global batch's activation statistics (each rank's partial sums
    summed over the processes first): the ranks bit for bit, both layouts
    bit for bit, equal to the JAX replicated master's harvest (its ZeRO
    master averages its shards' activation std, ROADMAP C2)."""
    from deeplearning4j_tpu.observability import introspection as jintro
    from tests._torch_parallel_common import jvec

    a, b = _both(runs, f"intro_{mode}")
    _equal_observed(a["observed"], b["observed"])
    _equal_observed(a["observed"],
                    _both(runs, "intro_replicated")[0]["observed"])
    job = runs["jobs"][f"intro_{mode}"]
    jn = _jax_sync(job)
    np.testing.assert_allclose(a["params"], jvec(jn), rtol=RTOL, atol=ATOL)
    h = _port_intro(a["observed"]["__introspect__"], job["conf"])
    jh = jintro.harvest(jintro.latest(jn), jintro.plan_for(jn))
    assert h["replicas"] is None and jh["iteration"] == 1
    _close_harvests(h, jh)


@pytest.mark.parametrize("interval", [1, 2])
def test_sync_master_numerics_across_processes_matches_jax(runs, interval):
    """The ledger's blocks across processes (interval 2: a collecting and
    a skipping step) against the JAX master's: max-abs to ``rtol=1e-4``,
    every verdict equal; the ranks bit for bit."""
    from deeplearning4j_tpu.observability import numerics as jnum

    a, b = _both(runs, f"num_{interval}")
    _equal_observed(a["observed"], b["observed"])
    job = runs["jobs"][f"num_{interval}"]
    jn = _jax_sync(job)
    h = _port_numerics(a["observed"]["__numerics__"], job["conf"])
    jh = jnum.harvest_model(jn)
    assert h["iteration"] == jh["iteration"]
    for comp in ("gradients", "moments", "activations"):
        assert set(h[comp]) == set(jh[comp])
        for layer, e in h[comp].items():
            np.testing.assert_allclose(e["max_abs"],
                                       jh[comp][layer]["max_abs"], rtol=1e-4)
            assert e["verdicts"] == jh[comp][layer]["verdicts"]


def test_zero_sync_master_carries_the_ledger_across_processes(runs):
    """Under ZeRO the ``__numerics__`` subtree rides through the steps
    unchanged on both ranks, as in one process."""
    a, b = _both(runs, "num_zero")
    for r in (a, b):
        v = r["observed"]["__numerics__"]
        assert v[0] == -1.0 and not v[1:].any()


def test_stride_sample_crossing_the_process_boundary(runs):
    """A ledger of ``sample=7`` over one step of 32 rows (16 a process):
    layer 0's activation is 320 values, sampled every 46th of the global
    batch, so rank 1's rows start its sample at local position 24; the
    sampled counts are the global sample's 7 values a layer (a sample
    per rank would count 14), every histogram and fraction equal to the
    JAX master's."""
    from deeplearning4j_tpu.observability import numerics as jnum

    a, b = _both(runs, "num_stride")
    _equal_observed(a["observed"], b["observed"])
    job = runs["jobs"]["num_stride"]
    jn = _jax_sync(job)
    h = _port_numerics(a["observed"]["__numerics__"], job["conf"])
    jh = jnum.harvest_model(jn)
    for layer, e in h["activations"].items():
        want = jh["activations"][layer]
        assert sum(want["exponent_histogram"]) == 7
        assert e["exponent_histogram"] == want["exponent_histogram"]
        for kind in ("underflow", "overflow"):
            for fmt, v in want[kind].items():
                assert e[kind][fmt] == pytest.approx(v, abs=1e-7), (
                    layer, kind, fmt)
        np.testing.assert_allclose(e["max_abs"], want["max_abs"], rtol=1e-4)


# --------------------------------------------------------------- the wrapper
@pytest.mark.parametrize("mode,freq", WRAPPED)
def test_wrapper_statistics_across_processes(runs, mode, freq):
    """Under ``ParallelWrapper`` the ``__introspect__`` and
    ``__numerics__`` stacks stay per replica; across processes each rank
    computes its slots' rows and the harvest's ``[K, N]`` view gathers
    them in slot order: both ranks equal the one-process four-slot
    wrapper bit for bit (the stacks, the facade's global slot 0 vectors,
    the params), and the JAX wrapper's per-replica harvest."""
    from deeplearning4j_tpu.observability import introspection as jintro
    from deeplearning4j_tpu.observability import numerics as jnum
    from tests._torch_parallel_common import jvec

    name = f"w_{mode}_{freq}"
    a, b = _both(runs, name)
    one = _one(runs, name)
    for r in (a, b):
        np.testing.assert_array_equal(r["params"], one["params"])
        _equal_observed(r["live"], one["live"])
        for k in ("__introspect__", "__numerics__"):
            np.testing.assert_array_equal(r["updater_state"][k]["packed"],
                                          one["updater_state"][k]["packed"])
    assert a["live"]["__introspect__"].shape[0] == K
    job = runs["jobs"][name]
    jn = _jax_wrapper(job)
    np.testing.assert_allclose(a["params"], jvec(jn), rtol=RTOL, atol=ATOL)
    h = _port_intro(a["live"]["__introspect__"], job["conf"])
    jh = jintro.harvest(jintro.latest(jn), jintro.plan_for(jn))
    assert h["replicas"] == jh["replicas"] == K
    _close_harvests(h, jh)
    if mode == "replicated":
        hn = _port_numerics(a["live"]["__numerics__"], job["conf"])
        jhn = jnum.harvest_model(jn)
        assert hn["iteration"] == jhn["iteration"]
        for comp in ("gradients", "moments", "activations"):
            for layer, e in hn[comp].items():
                np.testing.assert_allclose(
                    e["max_abs"], jhn[comp][layer]["max_abs"], rtol=1e-4)
                assert e["verdicts"] == jhn[comp][layer]["verdicts"]


@pytest.mark.parametrize("avg", LISTENED)
def test_wrapper_listener_on_one_rank_with_statistics(runs, avg):
    """A listener on rank 1 alone, both statistics policies on, updaters
    averaged or per replica (whose fold-back gathers global slot 0's):
    every rank folds back at the same windows, so neither hangs nor
    crosses a collective; both ranks equal the one-process four-slot
    run bit for bit, and only rank 1's listener heard the windows."""
    a, b = _both(runs, f"w_listener_{avg}")
    one = _one(runs, f"w_listener_{avg}")
    for r in (a, b):
        np.testing.assert_array_equal(r["params"], one["params"])
        _equal_observed(r["live"], one["live"])
        _equal_trees(r["updater_state"], one["updater_state"])
    assert "heard" not in a and b["heard"] == [1, 2, 3, 4]


# ------------------------------------------------------------ resilient fits
@pytest.mark.parametrize("master,mode", RESILIENT)
def test_resilient_fit_faulted_and_resumed(runs, master, mode):
    """A fatal fault on every rank at step 3 raises on both; a fresh net
    resumes from the last commit (step 2) on both, a retryable fault on
    rank 1 alone is retried on both, rank 1's preemption notice stops
    both at step 3 with a commit there; a fresh net resumes from it and
    ends bit for bit equal to the unfaulted run on both ranks."""
    a, b = _both(runs, f"res_{master}_{mode}")
    end = a["iterations"][0]
    for r in (a, b):
        assert r["fatal"] == "InjectedFault"
        # a wrapper that raised mid-fit leaves the facade at its last
        # fold-back (the commit at step 2)
        assert r["iterations"] == [end, 3 if master == "sync" else 2, 3,
                                   end]
        assert r["steps_after_fatal"] == [2]
        assert r["retries"] == 1
        assert r["latest"] == 3 and r["trigger"] in ("preempt", "priority")
        # the last run commits every step
        assert r["steps"] == [2, 3] + list(range(4, end + 1))
        np.testing.assert_array_equal(r["resumed"], r["unfaulted"])
    np.testing.assert_array_equal(a["unfaulted"], b["unfaulted"])
    assert a["injected"] == [] and b["injected"] == ["step_fault"]


@pytest.mark.parametrize("master,mode", RESILIENT)
def test_resilient_fit_agrees_once_a_step(runs, master, mode):
    """The resumed fit's host agreements on the training thread: the
    resume step, one a step (its stop, its fault and the save due after
    the step before), one after the last step, one a save (a failed
    snapshot anywhere fails it everywhere), and the wrapper's one on its
    listeners; a commit's three barriers too where it commits on the
    training thread (``async_save=False``)."""
    a, b = _both(runs, f"res_{master}_{mode}")
    steps = a["iterations"][-1] - 3
    inline = not runs["jobs"][f"res_{master}_{mode}"]["async"]
    want = 1 + steps + 1 + steps * (4 if inline else 1) + (
        master == "wrapper")
    assert a["agreements"] == b["agreements"] == want


@pytest.mark.parametrize("master,mode", RESILIENT)
def test_fault_on_one_rank_raises_on_every_rank_at_once(runs, master, mode):
    """A fatal fault planted on rank 1 alone before step 1: rank 1 raises
    it, rank 0 a ``PeerStepFault``, both before the step's exchange (so
    well within the group's 60 s timeout), at the same step."""
    a, b = _both(runs, f"res_{master}_{mode}")
    assert a["lone_fatal"][0] == "PeerStepFault"
    assert b["lone_fatal"][0] == "InjectedFault"
    assert a["lone_iteration"] == b["lone_iteration"]
    assert a["lone_fatal"][1] < 30 and b["lone_fatal"][1] < 30


@pytest.mark.parametrize("master,mode", [("sync", "zero"),
                                         ("wrapper", "replicated")])
def test_committed_directory_restores_in_jax_and_one_process(runs, master,
                                                             mode):
    """The two processes' last commit: every process's shards and
    manifest, one meta, and ``COMMIT`` over all of them; the JAX
    package's ``CheckpointManager`` finds and verifies it and restores it,
    and the port restores it in one process, both equal to the
    children's params bit for bit."""
    from deeplearning4j_tpu import parallel as jpar
    from deeplearning4j_tpu.resilience import (
        CheckpointManager as JaxCheckpointManager,
    )
    from deeplearning4j_tpu_torch import parallel as tpar
    from tests._torch_parallel_common import jmesh, pair, tvec

    name = f"res_{master}_{mode}"
    a, _ = _both(runs, name)
    end = a["iterations"][-1]
    d = runs["jobs"][name]["dir"]
    path = os.path.join(d, f"step-{end:08d}")
    assert sorted(os.listdir(path)) == [
        "COMMIT", "checkpoint.json", "manifest-0.json", "manifest-1.json",
        "shards-0.npz", "shards-1.npz"]
    assert not [n for n in os.listdir(d) if n.endswith(".tmp")]
    jcm = JaxCheckpointManager(d, auto_resume=False)
    assert jcm.latest_step() == end
    jn, tn = pair(updater="adam", lr=0.05, seed=99)
    jcm.restore(jn, mesh=jmesh(2))
    np.testing.assert_array_equal(
        np.asarray(jn.params_to_vector(), np.float32), a["resumed"])
    tpar.restore_checkpoint(path, tn)
    np.testing.assert_array_equal(tvec(tn).astype(np.float32), a["resumed"])
    assert tn.iteration == end
    jcm.close()


def test_children_load_no_jax(runs):
    for r in runs["group"].wait():
        assert r["jax_loaded"] is False
