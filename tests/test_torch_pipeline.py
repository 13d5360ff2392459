"""The port's pipeline master against the JAX package's: the cases of
``tests/test_pipeline_compiled.py`` and the pipeline cases of
``test_health.py``, ``test_resilience.py``, ``test_shardstats.py`` and
``test_stability.py``, each run through the JAX master on the conftest's
virtual CPU devices and the port's on CPU pipe slots, from the same
weights (carried across) and the same numpy batches.  Tolerances: the
reference's ``atol=2e-5`` (its sweep's 3e-5) against the single net,
``test_parallel.py``'s ``rtol=2e-5, atol=1e-6`` against the JAX
master."""

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import parallel as jpar
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.iterator import ListDataSetIterator as JIt
from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.models.sequential import MultiLayerNetwork as JNet
from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn.inputs import InputType as JInputType
from deeplearning4j_tpu.parallel.pipeline import (
    _layer_sig as jsig, find_periodic_run as jfind,
)

from deeplearning4j_tpu_torch import parallel as tpar
from deeplearning4j_tpu_torch.backend.mesh import P, Sharded
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterator import ListDataSetIterator
from deeplearning4j_tpu_torch.observability import (
    MetricsRegistry, get_flight_recorder, shardstats,
)
from deeplearning4j_tpu_torch.parallel.pipeline import (
    PipelineParallelTrainingMaster, _layer_sig, find_periodic_run,
    measure_bubble_fraction,
)

from tests._torch_parallel_common import jvec, port_of, tvec

ATOL_SERIAL = 2e-5                 # tests/test_pipeline_compiled.py
RTOL, ATOL = 2e-5, 1e-6            # tests/test_parallel.py


def block_mlp(n_blocks=4, width=16, seed=7, updater="sgd", lr=0.2, l2=0.0):
    b = (JConf.builder().seed(seed).updater(updater, learning_rate=lr).list()
         .layer(jl.DenseLayer(n_in=8, n_out=width, activation="tanh",
                              l2=l2)))
    for _ in range(n_blocks):
        b.layer(jl.DenseLayer(n_in=width, n_out=width, activation="tanh",
                              l2=l2))
    b.layer(jl.OutputLayer(n_in=width, n_out=4, l2=l2))
    return JNet(b.build()).init()


def hetero_mlp(seed=3, lr=0.1, updater="sgd"):
    return JNet(JConf.builder().seed(seed)
                .updater(updater, learning_rate=lr).list()
                .layer(jl.DenseLayer(n_in=8, n_out=16, activation="tanh"))
                .layer(jl.DenseLayer(n_in=16, n_out=12, activation="relu"))
                .layer(jl.DenseLayer(n_in=12, n_out=8, activation="tanh"))
                .layer(jl.OutputLayer(n_in=8, n_out=4)).build()).init()


def data(n=32, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.rand(n, 8).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rs.randint(0, 4, n)]
    return x, y


def _both(make, x, y, n_stages, n_micro, epochs=1, batch=None, **kw):
    """(JAX master's net, the port's net, the port's master) after
    ``epochs`` fits of the same batches."""
    jn = make()
    tn = port_of(jn)
    b = batch or len(x)
    jm = jpar.PipelineParallelTrainingMaster(
        n_stages=n_stages, n_microbatches=n_micro,
        devices=jax.devices()[:n_stages], **kw)
    jpar.DistributedNetwork(jn, jm).fit(JIt(JDataSet(x, y), b),
                                        epochs=epochs)
    tm = PipelineParallelTrainingMaster(
        n_stages=n_stages, n_microbatches=n_micro,
        devices=["cpu"] * n_stages, **kw)
    tpar.DistributedNetwork(tn, tm).fit(
        ListDataSetIterator(DataSet(x, y), b), epochs=epochs)
    return jn, tn, tm


def _serial(make, x, y, fits=1):
    net = port_of(make())
    for _ in range(fits):
        net.fit(x, y)
    return net


def _hold(tn, jn, serial, atol_serial=ATOL_SERIAL, score=1e-4):
    np.testing.assert_allclose(tvec(tn), tvec(serial), rtol=0,
                               atol=atol_serial)
    np.testing.assert_allclose(tvec(tn), jvec(jn), rtol=RTOL, atol=ATOL)
    assert abs(float(serial.score_value) - float(tn.score_value)) < score
    assert abs(float(jn.score_value) - float(tn.score_value)) < 1e-5


def test_find_periodic_run():
    jn = block_mlp(n_blocks=4)
    tn = port_of(jn)
    sigs = [_layer_sig(l) for l in tn.layers]
    assert sigs == [jsig(l) for l in jn.layers]
    assert find_periodic_run(sigs, 4) == (1, 1, 4) == jfind(sigs, 4)
    assert find_periodic_run(sigs, 2) == (1, 1, 4)
    assert find_periodic_run(sigs, 8) is None


@pytest.mark.parametrize("n_stages,n_micro", [(2, 4), (4, 2), (4, 4)])
def test_compiled_pipeline_matches_serial(n_stages, n_micro):
    x, y = data(32)
    serial = _serial(block_mlp, x, y, 2)
    jn, tn, tm = _both(block_mlp, x, y, n_stages, n_micro, epochs=2)
    assert tm._mode == "compiled" and tm._compiled_kind == "periodic"
    _hold(tn, jn, serial)


def test_compiled_pipeline_momentum_state_roundtrips():
    x, y = data(32)

    def make():
        return block_mlp(updater="nesterovs", lr=0.1)

    serial = _serial(make, x, y, 2)
    jn, tn, tm = _both(make, x, y, 4, 2, epochs=2)
    assert tm._mode == "compiled"
    _hold(tn, jn, serial)
    assert set(serial.updater_state["v"]) == set(tn.updater_state["v"])
    for ln, sub in tn.updater_state["v"].items():
        for pn, v in sub.items():
            np.testing.assert_allclose(
                v.numpy(), np.asarray(jn.updater_state["v"][ln][pn]),
                rtol=RTOL, atol=ATOL, err_msg=f"v/{ln}/{pn}")


def test_compiled_pipeline_regularization():
    x, y = data(16)

    def make():
        return block_mlp(l2=0.01, seed=9)

    serial = _serial(make, x, y)
    jn, tn, tm = _both(make, x, y, 2, 2)
    assert tm._mode == "compiled"
    _hold(tn, jn, serial, score=1e-5)


def test_compiled_pipeline_single_compile():
    """One step body for the configuration; three epochs reuse it and the
    master's holder (on the card: one captured graph, replayed)."""
    x, y = data(32)
    tn = port_of(block_mlp(seed=11))
    master = PipelineParallelTrainingMaster(
        n_stages=4, n_microbatches=4, devices=["cpu"] * 4)
    dn = tpar.DistributedNetwork(tn, master)
    dn.fit(ListDataSetIterator(DataSet(x, y), len(x)))
    h = master._h
    dn.fit(ListDataSetIterator(DataSet(x, y), len(x)), epochs=2)
    assert master._mode == "compiled"
    assert len(master._compiled_steps) == 1
    assert master._h is h


def test_compiled_pipeline_handles_batch_size_change():
    x, y = data(32)
    tn = port_of(block_mlp(seed=13))
    master = PipelineParallelTrainingMaster(
        n_stages=2, n_microbatches=2, devices=["cpu"] * 2)
    dn = tpar.DistributedNetwork(tn, master)
    dn.fit(ListDataSetIterator(DataSet(x, y), 32))
    dn.fit(ListDataSetIterator(DataSet(x[:16], y[:16]), 16))
    assert master._mode == "compiled"
    assert len(master._compiled_steps) == 2
    assert np.isfinite(float(tn.score_value))


@pytest.mark.parametrize("n_stages,n_micro", [(2, 4), (4, 2)])
def test_heterogeneous_compiles_and_matches_serial(n_stages, n_micro):
    x, y = data(32)
    serial = _serial(hetero_mlp, x, y, 2)
    jn, tn, tm = _both(hetero_mlp, x, y, n_stages, n_micro, epochs=2)
    assert tm._mode == "compiled" and tm._compiled_kind == "hetero"
    _hold(tn, jn, serial)


def conv_then_dense(seed=5, lr=0.05):
    return JNet(JConf.builder().seed(seed).updater("sgd", learning_rate=lr)
                .list()
                .layer(jl.ConvolutionLayer(n_out=4, kernel_size=(3, 3),
                                           activation="relu"))
                .layer(jl.SubsamplingLayer(kernel_size=(2, 2),
                                           stride=(2, 2)))
                .layer(jl.DenseLayer(n_out=16, activation="tanh"))
                .layer(jl.OutputLayer(n_out=4))
                .set_input_type(JInputType.convolutional(8, 8, 1))
                .build()).init()


def test_conv_then_dense_pipeline_compiles():
    rs = np.random.RandomState(0)
    x = rs.rand(16, 8, 8, 1).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rs.randint(0, 4, 16)]
    serial = _serial(conv_then_dense, x, y)
    jn, tn, tm = _both(conv_then_dense, x, y, 2, 2)
    assert tm._mode == "compiled" and tm._compiled_kind == "hetero"
    np.testing.assert_allclose(tvec(tn), tvec(serial), rtol=0,
                               atol=ATOL_SERIAL)
    np.testing.assert_allclose(tvec(tn), jvec(jn), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_orchestrated_schedules_match_serial(schedule):
    x, y = data(16)

    def make():
        return hetero_mlp(seed=21)

    serial = _serial(make, x, y)
    jn, tn, tm = _both(make, x, y, 2, 4, mode="orchestrated",
                       schedule=schedule)
    assert tm._mode == "orchestrated"
    _hold(tn, jn, serial)


def test_bubble_fraction_analytic_and_measured():
    m = PipelineParallelTrainingMaster(n_stages=4, n_microbatches=4,
                                       devices=["cpu"] * 4)
    assert abs(m.bubble_fraction() - 3 / 7) < 1e-9
    jm = jpar.PipelineParallelTrainingMaster(n_stages=4, n_microbatches=4,
                                             devices=jax.devices()[:4])
    assert m.bubble_fraction() == jm.bubble_fraction()

    def make_batch(n):
        return DataSet(*data(n))

    stats = measure_bubble_fraction(
        lambda: port_of(block_mlp(n_blocks=4, seed=17)), make_batch,
        n_stages=2, mb_size=8, m_small=2, m_large=4, iters=2,
        devices=["cpu"] * 2)
    assert stats["mode"] == "compiled"
    assert 0.0 <= stats["bubble_analytic"] < 1.0
    assert np.isfinite(stats["bubble_measured"])


def test_hetero_sharded_params_with_adam_matches_serial():
    x, y = data(32)

    def make():
        return JNet(JConf.builder().seed(17)
                    .updater("adam", learning_rate=0.01).list()
                    .layer(jl.DenseLayer(n_in=8, n_out=16, activation="tanh"))
                    .layer(jl.DenseLayer(n_in=16, n_out=12,
                                         activation="relu"))
                    .layer(jl.DenseLayer(n_in=12, n_out=8, activation="tanh"))
                    .layer(jl.OutputLayer(n_in=8, n_out=4)).build()).init()

    serial = _serial(make, x, y, 2)
    jn, tn, tm = _both(make, x, y, 2, 4, epochs=2)
    assert tm._compiled_kind == "hetero" and tm._hetero_sharded
    _hold(tn, jn, serial)
    for slot in ("m", "v"):
        for ln, sub in serial.updater_state[slot].items():
            for pn, v in sub.items():
                np.testing.assert_allclose(
                    v.numpy(), tn.updater_state[slot][ln][pn].numpy(),
                    rtol=0, atol=ATOL_SERIAL, err_msg=f"{slot}/{ln}/{pn}")
                np.testing.assert_allclose(
                    tn.updater_state[slot][ln][pn].numpy(),
                    np.asarray(jn.updater_state[slot][ln][pn]),
                    rtol=RTOL, atol=ATOL, err_msg=f"{slot}/{ln}/{pn}")


def test_hetero_params_actually_partitioned_per_slot():
    tn = port_of(hetero_mlp())
    total = sum(t.numel() * 4 for l in tn.params.values()
                for t in l.values())
    master = PipelineParallelTrainingMaster(
        n_stages=2, n_microbatches=4, devices=["cpu"] * 2)
    master._build(tn)
    assert master._hetero_sharded
    rows = master._hetero_flatten(tn.params)
    laid = Sharded(rows, P("pipe"), master._pipe, rows.shape)
    assert laid.splits() == [2, 1]
    assert laid.slot_bytes() == master._flat_pmax * 4 < total


def test_hetero_falls_back_to_replicated_with_lr_overrides(capsys):
    x, y = data(16)

    def make():
        return JNet(JConf.builder().seed(19)
                    .updater("sgd", learning_rate=0.1).list()
                    .layer(jl.DenseLayer(n_in=8, n_out=16, activation="tanh"))
                    .layer(jl.DenseLayer(n_in=16, n_out=12, activation="relu",
                                         learning_rate=0.05))
                    .layer(jl.OutputLayer(n_in=12, n_out=4)).build()).init()

    serial = _serial(make, x, y)
    with pytest.warns(RuntimeWarning, match="fast path DISABLED"):
        jn, tn, tm = _both(make, x, y, 2, 2)
    assert tm._compiled_kind == "hetero" and not tm._hetero_sharded
    assert "REPLICATED" in capsys.readouterr().err
    _hold(tn, jn, serial)


def test_hetero_refuses_the_float32_rows_for_other_types_loudly(capsys):
    """The reference casts every leaf into its float32 rows without a
    word; the port keeps a float64 net's params replicated and says so."""
    tn = port_of(hetero_mlp())
    tn.params = {k: {n: t.double() for n, t in v.items()}
                 for k, v in tn.params.items()}
    master = PipelineParallelTrainingMaster(
        n_stages=2, n_microbatches=2, devices=["cpu"] * 2)
    with pytest.warns(RuntimeWarning, match="non-float32 params"):
        master._build(tn)
    assert master._compiled_kind == "hetero" and not master._hetero_sharded
    assert "REPLICATED" in capsys.readouterr().err


def test_pipeline_rejects_net_without_output_tail_early():
    tn = port_of(JNet(JConf.builder().seed(23)
                      .updater("sgd", learning_rate=0.1).list()
                      .layer(jl.DenseLayer(n_in=8, n_out=16,
                                           activation="tanh"))
                      .layer(jl.DenseLayer(n_in=16, n_out=4,
                                           activation="identity"))
                      .build()).init())
    master = PipelineParallelTrainingMaster(
        n_stages=2, n_microbatches=2, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="score"):
        master._build(tn)


@pytest.mark.parametrize("maker", ["periodic", "hetero"])
def test_remat_pipeline_matches_serial(maker):
    x, y = data(32)

    def make():
        return block_mlp(seed=31) if maker == "periodic" \
            else hetero_mlp(seed=31)

    serial = _serial(make, x, y)
    jn, tn, tm = _both(make, x, y, 2, 4, remat=True)
    assert tm._mode == "compiled" and tm._compiled_kind == maker
    _hold(tn, jn, serial)


def test_remat_rejected_on_orchestrated_mode():
    with pytest.raises(ValueError, match="remat"):
        PipelineParallelTrainingMaster(n_stages=2, mode="orchestrated",
                                       remat=True, devices=["cpu"] * 2)


def test_hetero_sharded_randomized_config_sweep():
    rs = np.random.RandomState(77)
    for trial in range(4):
        depth = int(rs.randint(3, 7))
        widths = [int(rs.choice([6, 10, 14, 18, 22])) for _ in range(depth)]
        updater = ["sgd", "nesterovs", "adam", "rmsprop"][trial % 4]
        n_stages = int(rs.choice([2, 3, 4]))
        n_micro = int(rs.choice([2, 4]))
        acts = ["tanh", "relu", "sigmoid"]

        def make():
            b = (JConf.builder().seed(100 + trial)
                 .updater(updater, learning_rate=0.05).list())
            prev = 8
            for i, w in enumerate(widths):
                b.layer(jl.DenseLayer(n_in=prev, n_out=w,
                                      activation=acts[i % 3]))
                prev = w
            b.layer(jl.OutputLayer(n_in=prev, n_out=4))
            return JNet(b.build()).init()

        x, y = data(n_micro * 8, seed=trial)
        serial = _serial(make, x, y)
        jn, tn, tm = _both(make, x, y, n_stages, n_micro)
        cfg = (f"trial {trial}: widths={widths} updater={updater} "
               f"S={n_stages} M={n_micro}")
        assert tm._compiled_kind == "hetero" and tm._hetero_sharded, cfg
        np.testing.assert_allclose(tvec(tn), tvec(serial), rtol=0,
                                   atol=3e-5, err_msg=cfg)
        np.testing.assert_allclose(tvec(tn), jvec(jn), rtol=RTOL,
                                   atol=ATOL, err_msg=cfg)


def _ids(seed, vocab=11, b=8, t=8):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, vocab, (b, t))
    return (ids.astype(np.float32),
            np.eye(vocab, dtype=np.float32)[np.roll(ids, -1, 1)])


def test_auto_mode_sends_a_sequence_net_to_the_hetero_path():
    """Auto mode compiles any non-periodic net with a score() tail on the
    hetero path, RnnOutputLayer sequence nets included (the reference
    never tested that): embedding, causal attention, a dense layer and an
    RnnOutputLayer over [B, T] ids, against the JAX master and the single
    net."""
    x, y = _ids(4)

    def make():
        return JNet(JConf.builder().seed(9).updater("sgd", learning_rate=0.1)
                    .list()
                    .layer(jl.EmbeddingLayer(n_in=11, n_out=8,
                                             collapse_column=False))
                    .layer(jl.SelfAttentionLayer(n_in=8, n_out=8, n_heads=2,
                                                 causal=True))
                    .layer(jl.DenseLayer(n_in=8, n_out=12, activation="relu"))
                    .layer(jl.RnnOutputLayer(n_in=12, n_out=11, loss="mcxent",
                                             activation="softmax"))
                    .build()).init()

    serial = _serial(make, x, y)
    jn, tn, tm = _both(make, x, y, 2, 4)
    assert tm._compiled_kind == "hetero" and tm._hetero_sharded
    _hold(tn, jn, serial)


def test_hetero_char_lm_with_nested_block_params():
    """A char-LM of one block pair splits on the hetero path; its
    ResidualBlocks nest their sublayers' params, which the port's
    ``split_stages`` counts leaf by leaf (the reference's fails on the
    nested dicts, ROADMAP C2): held against the single net."""
    x, y = _ids(6)

    def make():
        return jzoo.transformer_char_lm(vocab_size=11, d_model=8, n_heads=2,
                                        layers=1, seed=9, updater="adam",
                                        lr=0.01)

    serial = _serial(make, x, y)
    tn = port_of(make())
    tm = PipelineParallelTrainingMaster(n_stages=2, n_microbatches=4,
                                        devices=["cpu"] * 2)
    tpar.DistributedNetwork(tn, tm).fit(ListDataSetIterator(DataSet(x, y),
                                                            8))
    assert tm._compiled_kind == "hetero" and tm._hetero_sharded
    np.testing.assert_allclose(tvec(tn), tvec(serial), rtol=0,
                               atol=ATOL_SERIAL)
    with pytest.raises(AttributeError):
        jpar.split_stages(make(), 2)


def test_periodic_char_lm_prefix_blocks_suffix():
    """The char-LM's pipeline split (the card's phase at full width):
    the embedding as prefix, attention/FFN block pairs as the period,
    LayerNorm and the RnnOutputLayer as suffix, against the JAX master
    and the single net."""
    x, y = _ids(5)

    def make():
        return jzoo.transformer_char_lm(vocab_size=11, d_model=8, n_heads=2,
                                        layers=4, seed=9, updater="sgd",
                                        lr=0.05)

    tn0 = port_of(make())
    assert find_periodic_run([_layer_sig(l) for l in tn0.layers], 2) \
        == (1, 2, 4)
    serial = _serial(make, x, y)
    jn, tn, tm = _both(make, x, y, 2, 4)
    assert tm._compiled_kind == "periodic"
    _hold(tn, jn, serial)


# ----------------------------------------- the other suites' pipeline cases
def _dense_net(n_in=6, seed=7, updater="sgd", lr=0.1, norm=None):
    b = JConf.builder().seed(seed).updater(updater, learning_rate=lr)
    if norm is not None:
        b = b.gradient_normalization(norm, 1.0)
    return JNet(b.list()
                .layer(jl.DenseLayer(n_in=n_in, n_out=8, activation="relu"))
                .layer(jl.DenseLayer(n_in=8, n_out=8, activation="relu"))
                .layer(jl.OutputLayer(n_in=8, n_out=3, loss="mcxent",
                                      activation="softmax"))
                .build()).init()


def _class_data(n, n_in=6, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.rand(n, n_in).astype(np.float32),
            np.eye(3, dtype=np.float32)[rs.randint(0, 3, n)])


def test_pipeline_master_publishes_stage_times():
    """test_health.py:306."""
    from deeplearning4j_tpu_torch.observability import (
        get_registry, set_registry,
    )

    prev = get_registry()
    reg = MetricsRegistry()
    set_registry(reg)
    try:
        tn = port_of(_dense_net())
        x, y = _class_data(16)
        master = PipelineParallelTrainingMaster(
            n_stages=2, n_microbatches=4, devices=["cpu"] * 2,
            mode="orchestrated")
        tpar.DistributedNetwork(tn, master).fit(
            ListDataSetIterator(DataSet(x, y), 16))
        fam = reg.get("dl4j_worker_step_seconds")
        stages = {dict(lp).get("worker") for lp, _c in fam.samples()
                  if dict(lp).get("component") == "pipeline_master"}
        assert stages == {"stage0", "stage1"}
        assert master.training_stats()["cluster"]["workers"] == 2
    finally:
        set_registry(prev)


def test_pipeline_master_crash_resume_equivalence(tmp_path):
    """test_resilience.py:443: an injected crash at step 2, a resume
    from the step-2 checkpoint, the same params as the uninterrupted run
    and as the JAX master's."""
    from deeplearning4j_tpu_torch.resilience import (
        CheckpointManager, FaultInjector, InjectedFault, inject_faults,
    )

    def build():
        return JNet(JConf.builder().seed(21)
                    .updater("sgd", learning_rate=0.1).list()
                    .layer(jl.DenseLayer(n_in=8, n_out=16,
                                         activation="relu"))
                    .layer(jl.OutputLayer(n_in=16, n_out=4)).build()).init()

    rs = np.random.RandomState(1)
    x = rs.rand(64, 8).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rs.randint(0, 4, 64)]

    def it():
        return ListDataSetIterator(DataSet(x, y), 16)

    def master(**kw):
        return PipelineParallelTrainingMaster(
            n_stages=2, n_microbatches=4, mode="orchestrated",
            devices=["cpu"] * 2, **kw)

    jref = build()
    ref = port_of(jref)
    master().execute_training(ref, it())
    jpar.PipelineParallelTrainingMaster(
        n_stages=2, n_microbatches=4, mode="orchestrated",
        devices=jax.devices()[:2]).execute_training(
        jref, JIt(JDataSet(x, y), 16))
    net = port_of(build())
    cm = CheckpointManager(str(tmp_path), save_every_steps=1,
                           async_save=False, registry=MetricsRegistry())
    with inject_faults(FaultInjector().fail_at_step(
            2, component="pipeline_master", transient=False)):
        with pytest.raises(InjectedFault):
            master(checkpoint_manager=cm).execute_training(net, it())
    assert cm.latest_step() == 2
    resumed = port_of(build())
    master(checkpoint_manager=cm).execute_training(resumed, it())
    assert resumed.iteration == ref.iteration == 4
    np.testing.assert_allclose(tvec(resumed), tvec(ref), atol=1e-6)
    np.testing.assert_allclose(tvec(ref), jvec(jref), rtol=RTOL, atol=ATOL)


def test_compiled_pipeline_checkpoint_saves_folded_params(tmp_path):
    """A save on the compiled path folds the stacked blocks back first:
    the step-2 checkpoint holds the params after two steps."""
    from deeplearning4j_tpu_torch.resilience import CheckpointManager

    x, y = data(64)
    ref = port_of(block_mlp(seed=3))
    for i in range(2):
        ref.fit(x[i * 16:(i + 1) * 16], y[i * 16:(i + 1) * 16])
    net = port_of(block_mlp(seed=3))
    cm = CheckpointManager(str(tmp_path), save_every_steps=2,
                           async_save=False, registry=MetricsRegistry())
    PipelineParallelTrainingMaster(
        n_stages=2, n_microbatches=2, devices=["cpu"] * 2,
        checkpoint_manager=cm).execute_training(
        net, ListDataSetIterator(DataSet(x[:32], y[:32]), 16))
    back = port_of(block_mlp(seed=3))
    cm.restore(back, step=2)
    np.testing.assert_allclose(tvec(back), tvec(ref), rtol=0,
                               atol=ATOL_SERIAL)


def test_pipeline_per_stage_ledger_sums_to_single_device_total():
    """test_shardstats.py:356."""
    jn = JNet(JConf.builder().seed(1).updater("sgd", learning_rate=0.1)
              .list()
              .layer(jl.DenseLayer(n_in=16, n_out=24, activation="relu"))
              .layer(jl.OutputLayer(n_in=24, n_out=4)).build()).init()
    tn = port_of(jn)
    single = sum(t.numel() * 4 for l in tn.params.values()
                 for t in l.values())
    master = PipelineParallelTrainingMaster(
        n_stages=2, n_microbatches=2, mode="orchestrated",
        devices=["cpu"] * 2)
    rs = np.random.RandomState(0)
    x = rs.rand(16, 16).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rs.randint(0, 4, 16)]
    master.execute_training(tn, ListDataSetIterator(DataSet(x, y), 8))
    led = shardstats.latest_ledgers()["pipeline_master"]
    rows = {k: v for k, v in led["trees"].items()
            if k.startswith("params_stage")}
    assert len(rows) == 2
    assert sum(r["logical_bytes"] for r in rows.values()) == single
    assert all(0 < r["per_device_bytes"] < single for r in rows.values())


def test_compiled_ledger_shards_the_blocks_over_the_pipe_slots():
    """The ledger's blocks over the pipe slots, the rest on each; the
    step's census, a ppermute a tick."""
    shardstats.clear_ledgers()
    tn = port_of(block_mlp())
    x, y = data(16)
    PipelineParallelTrainingMaster(
        n_stages=2, n_microbatches=2, devices=["cpu"] * 2).execute_training(
        tn, ListDataSetIterator(DataSet(x, y), 16))
    led = shardstats.latest_ledgers()["pipeline_master"]
    cp = shardstats.program_analysis("PipelineParallelTrainingMaster.step")[
        "collectives"]["collective-permute"]
    assert cp["count"] == 2 + 2 - 1 and cp["group_sizes"] == [2]
    blk = led["trees"]["params"]["subtrees"]["blk/0"]
    assert blk["per_device_bytes"] * 2 == blk["logical_bytes"]
    assert led["trees"]["params"]["subtrees"]["pfx/layer_0"][
        "replication_factor"] == 2


def test_pipeline_gradient_normalization_downgrade_is_loud():
    """test_stability.py:540."""
    tn = port_of(_dense_net(norm="clip_l2_per_layer"))
    master = PipelineParallelTrainingMaster(
        n_stages=2, n_microbatches=2, mode="compiled", devices=["cpu"] * 2)
    with pytest.warns(RuntimeWarning, match="fast path DISABLED"):
        master._build(tn)
    evs = [e for e in get_flight_recorder().events()
           if e.kind == "pipeline_fast_path_downgrade"
           and e.attrs.get("component") == "pipeline_master"]
    assert evs and "gradient_normalization='clip_l2_per_layer'" in \
        evs[-1].attrs["reasons"][0]


def test_pipeline_argument_checks_and_slots():
    with pytest.raises(ValueError, match="schedule"):
        PipelineParallelTrainingMaster(schedule="x", devices=["cpu"])
    with pytest.raises(ValueError, match="mode"):
        PipelineParallelTrainingMaster(mode="x", devices=["cpu"])
    with pytest.raises(ValueError, match="stages >"):
        PipelineParallelTrainingMaster(n_stages=3, devices=["cpu"] * 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            PipelineParallelTrainingMaster(n_stages=2)
    m = PipelineParallelTrainingMaster(n_stages=2,
                                       devices=["cpu", "meta"])
    with pytest.raises(NotImplementedError, match="A10"):
        m._build(port_of(block_mlp()))
