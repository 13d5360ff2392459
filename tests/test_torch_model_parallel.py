"""The port's tensor and expert parallelism against the JAX package's:
``tests/test_model_parallel.py``'s cases, each run through the JAX master
on the conftest's virtual CPU devices and through the port's on CPU
slots, from the same weights (carried across) and the same numpy
batches.  Where the reference asserts only finiteness, the port is held
to the JAX master.  Tolerances: the reference's ``atol=2e-5`` against
the single net, ``test_parallel.py``'s ``rtol=2e-5, atol=1e-6`` against
the JAX master."""

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import parallel as jpar
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.iterator import ListDataSetIterator as JIt
from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.models.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.models.sequential import MultiLayerNetwork as JNet
from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn.inputs import InputType as JInputType

from deeplearning4j_tpu_torch import parallel as tpar
from deeplearning4j_tpu_torch.backend import mesh as tmesh
from deeplearning4j_tpu_torch.backend import slots
from deeplearning4j_tpu_torch.backend.mesh import P
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterator import ListDataSetIterator
from deeplearning4j_tpu_torch.models.graph import GraphConfiguration
from deeplearning4j_tpu_torch.models.interop import graph_params_from_numpy
from deeplearning4j_tpu_torch.observability import shardstats

from tests._torch_parallel_common import (
    data, jmesh, jvec, port_of, tmesh_of, tvec,
)

ATOL_SERIAL = 2e-5                 # tests/test_model_parallel.py
RTOL, ATOL = 2e-5, 1e-6            # tests/test_parallel.py


def mlp(seed=3, updater="adam", lr=0.05, widths=(8, 16, 16, 4)):
    b = (JConf.builder().seed(seed).updater(updater, learning_rate=lr)
         .list())
    for i in range(len(widths) - 2):
        b = b.layer(jl.DenseLayer(n_in=widths[i], n_out=widths[i + 1],
                                  activation="tanh"))
    b = b.layer(jl.OutputLayer(n_in=widths[-2], n_out=widths[-1],
                               loss="mcxent", activation="softmax"))
    return JNet(b.build()).init()


def moe_net(updater="sgd", lr=0.1):
    conf = (JConf.builder().seed(5).updater(updater, learning_rate=lr).list()
            .layer(jl.DenseLayer(n_in=8, n_out=16, activation="relu"))
            .layer(jl.MoELayer(n_in=16, n_out=16, num_experts=4,
                               capacity_factor=2.0))
            .layer(jl.OutputLayer(n_in=16, n_out=4))
            .build())
    return JNet(conf).init()


def _specs_equal(tspec, jspec, path=""):
    assert set(tspec) == set(jspec), path
    for k in jspec:
        if isinstance(jspec[k], dict):
            _specs_equal(tspec[k], jspec[k], f"{path}/{k}")
        else:
            assert tuple(tspec[k]) == tuple(jspec[k]), (f"{path}/{k}",
                                                        tspec[k], jspec[k])


def _fit_both(jn, tn, x, y, batch, epochs=1, data_=4, model=2):
    """The JAX TP master and the port's over (data, model) slots."""
    jpar.DistributedNetwork(jn, jpar.TensorParallelTrainingMaster(
        mesh=jmesh(data_, model))).fit(JIt(JDataSet(x, y), batch),
                                       epochs=epochs)
    tpar.DistributedNetwork(tn, tpar.TensorParallelTrainingMaster(
        mesh=tmesh_of(data_, model))).fit(
        ListDataSetIterator(DataSet(x, y), batch), epochs=epochs)


def test_tensor_parallel_spec_alternates():
    jn = mlp()
    tn = port_of(jn)
    spec = tpar.tensor_parallel_spec(tn.params, tp=2)
    assert spec["layer_0"]["W"] == P(None, "model")
    assert spec["layer_1"]["W"] == P("model", None)
    assert spec["layer_2"]["W"] == P(None, "model")
    assert spec["layer_0"]["b"] == P()
    _specs_equal(spec, jpar.tensor_parallel_spec(jn.params, tp=2))


def test_tensor_parallel_matches_serial_and_jax():
    x, y = data(32)
    jn, serial = mlp(), mlp()
    tn, tserial = port_of(jn), port_of(serial)
    _fit_both(jn, tn, x, y, 16, epochs=2)
    tserial.fit(ListDataSetIterator(DataSet(x, y), 16), epochs=2)
    np.testing.assert_allclose(tvec(tn), tvec(tserial), rtol=0,
                               atol=ATOL_SERIAL)
    np.testing.assert_allclose(tvec(tn), jvec(jn), rtol=RTOL, atol=ATOL)


def test_split_stages_balanced_and_contiguous():
    jn = mlp(widths=(8, 32, 32, 32, 4))
    tn = port_of(jn)
    stages = tpar.split_stages(tn, 2)
    assert [i for s in stages for i in s] == list(range(len(tn.layers)))
    assert len(stages) == 2 and all(stages)
    assert stages == jpar.split_stages(jn, 2)


def test_pipeline_matches_serial_and_jax():
    x, y = data(32)
    jn, serial = mlp(updater="sgd", lr=0.5), mlp(updater="sgd", lr=0.5)
    tn, tserial = port_of(jn), port_of(serial)
    jpar.DistributedNetwork(jn, jpar.PipelineParallelTrainingMaster(
        n_stages=3, n_microbatches=4, devices=jax.devices()[:3])).fit(
        JIt(JDataSet(x, y), 16), epochs=2)
    tpar.DistributedNetwork(tn, tpar.PipelineParallelTrainingMaster(
        n_stages=3, n_microbatches=4, devices=["cpu"] * 3)).fit(
        ListDataSetIterator(DataSet(x, y), 16), epochs=2)
    tserial.fit(ListDataSetIterator(DataSet(x, y), 16), epochs=2)
    np.testing.assert_allclose(tvec(tn), tvec(tserial), rtol=0,
                               atol=ATOL_SERIAL)
    np.testing.assert_allclose(tvec(tn), jvec(jn), rtol=RTOL, atol=ATOL)
    assert abs(float(tserial.score_value) - float(tn.score_value)) < 1e-4
    assert abs(float(jn.score_value) - float(tn.score_value)) < 1e-5


def test_pipeline_rejects_stateful_layers():
    jn = JNet(JConf.builder().seed(1).updater("sgd").list()
              .layer(jl.DenseLayer(n_in=4, n_out=8))
              .layer(jl.BatchNormalization(n_out=8))
              .layer(jl.OutputLayer(n_in=8, n_out=2)).build()).init()
    tn = port_of(jn)
    master = tpar.PipelineParallelTrainingMaster(n_stages=2,
                                                 devices=["cpu"] * 2)
    x, y = data(8, 4, 2)
    with pytest.raises(ValueError, match="stateless"):
        tpar.DistributedNetwork(tn, master).fit(
            ListDataSetIterator(DataSet(x, y), 8))


def test_moe_expert_sharding_under_tp_equals_jax():
    """The reference asserts a finite score; the port's expert-parallel
    step is held to the JAX master's and to the single net's."""
    jn, serial = moe_net(), moe_net()
    tn, tserial = port_of(jn), port_of(serial)
    spec = tpar.tensor_parallel_spec(tn.params, tp=2)
    assert spec["layer_1"]["W_up"] == P("model", None, None)
    assert spec["layer_1"]["W_down"] == P("model", None, None)
    _specs_equal(spec, jpar.tensor_parallel_spec(jn.params, tp=2))
    x, y = data(32, 8, 4)
    _fit_both(jn, tn, x, y, 16)
    tserial.fit(ListDataSetIterator(DataSet(x, y), 16))
    assert np.isfinite(float(tn.score_value))
    np.testing.assert_allclose(tvec(tn), jvec(jn), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tvec(tn), tvec(tserial), rtol=0,
                               atol=ATOL_SERIAL)
    assert abs(float(tn.score_value) - float(jn.score_value)) < 1e-5


def test_tp_and_pp_with_paramless_layers_and_stateful_updater():
    def build():
        return JNet(JConf.builder().seed(4)
                    .updater("adam", learning_rate=0.02).list()
                    .layer(jl.DenseLayer(n_in=8, n_out=16))
                    .layer(jl.ActivationLayer(activation="relu"))
                    .layer(jl.OutputLayer(n_in=16, n_out=4)).build()).init()

    x, y = data(16, 8, 4)
    jn = build()
    tn = port_of(jn)
    _fit_both(jn, tn, x, y, 16)
    assert np.isfinite(float(tn.score_value))
    np.testing.assert_allclose(tvec(tn), jvec(jn), rtol=RTOL, atol=ATOL)
    jp = build()
    tp_ = port_of(jp)
    jpar.DistributedNetwork(jp, jpar.PipelineParallelTrainingMaster(
        n_stages=2, n_microbatches=2, devices=jax.devices()[:2])).fit(
        JIt(JDataSet(x, y), 16))
    tpar.DistributedNetwork(tp_, tpar.PipelineParallelTrainingMaster(
        n_stages=2, n_microbatches=2, devices=["cpu"] * 2)).fit(
        ListDataSetIterator(DataSet(x, y), 16))
    assert np.isfinite(float(tp_.score_value))
    np.testing.assert_allclose(tvec(tp_), jvec(jp), rtol=RTOL, atol=ATOL)


def test_split_stages_exact_stage_count():
    tn = port_of(mlp(widths=(8, 16, 16, 4)))
    assert tpar.split_stages(tn, 3) == [[0], [1], [2]]
    tn4 = port_of(mlp(widths=(8, 16, 16, 16, 4)))
    assert tpar.split_stages(tn4, 4) == [[0], [1], [2], [3]]


def test_pipeline_score_includes_regularization():
    def build():
        return JNet(JConf.builder().seed(4)
                    .updater("sgd", learning_rate=0.1).list()
                    .layer(jl.DenseLayer(n_in=8, n_out=16, l2=0.01))
                    .layer(jl.OutputLayer(n_in=16, n_out=4, l2=0.01))
                    .build()).init()

    x, y = data(16, 8, 4)
    serial = port_of(build())
    serial.fit(x, y)
    jn = build()
    tn = port_of(jn)
    jpar.DistributedNetwork(jn, jpar.PipelineParallelTrainingMaster(
        n_stages=2, n_microbatches=2, devices=jax.devices()[:2])).fit(
        JIt(JDataSet(x, y), 16))
    tpar.DistributedNetwork(tn, tpar.PipelineParallelTrainingMaster(
        n_stages=2, n_microbatches=2, devices=["cpu"] * 2)).fit(
        ListDataSetIterator(DataSet(x, y), 16))
    assert abs(float(serial.score_value) - float(tn.score_value)) < 1e-5
    assert abs(float(jn.score_value) - float(tn.score_value)) < 1e-5


def test_tensor_parallel_spec_attention_and_blocks():
    jn = jzoo.transformer_char_lm(vocab_size=8, d_model=8, n_heads=2,
                                  layers=2)
    tn = port_of(jn)
    spec = tpar.tensor_parallel_spec(tn.params, tp=2)
    for blk in (1, 3):
        attn = spec[f"layer_{blk}"]["sub1"]
        assert attn["Wq"] == P(None, "model")
        assert attn["Wk"] == P(None, "model")
        assert attn["Wv"] == P(None, "model")
        assert attn["Wo"] == P("model", None)
    for blk in (2, 4):
        ff = spec[f"layer_{blk}"]
        ws = [v["W"] for k, v in sorted(ff.items()) if "W" in v]
        assert ws == [P(None, "model"), P("model", None)], (blk, ws)
    _specs_equal(spec, jpar.tensor_parallel_spec(jn.params, tp=2))


def _lm_data(vocab=11, b=8, t=8, seed=0):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, vocab, (b, t))
    return (ids.astype(np.float32),
            np.eye(vocab, dtype=np.float32)[np.roll(ids, -1, 1)])


@pytest.mark.parametrize("kv", [None, 1])
def test_tensor_parallel_transformer_matches_serial_and_jax(kv):
    """The Megatron layout (embedding and head column-parallel, the
    head's softmax cross-entropy vocab-parallel, attention's head groups,
    the FFN's column/row pair) against the single net and the JAX master;
    with one kv head (GQA) the kv projection's blocks end inside the head
    and are gathered."""
    x, y = _lm_data()
    kw = dict(vocab_size=11, d_model=8, n_heads=2, layers=1, seed=9,
              updater="sgd", lr=0.1, n_kv_heads=kv)
    jn = jzoo.transformer_char_lm(**kw)
    tn, tserial = port_of(jn), port_of(jzoo.transformer_char_lm(**kw))
    tserial.fit(ListDataSetIterator(DataSet(x, y), 8), epochs=2)
    jpar.DistributedNetwork(jn, jpar.TensorParallelTrainingMaster(
        mesh=jmesh(4, 2))).fit(JIt(JDataSet(x, y), 8), epochs=2)
    shardstats.clear_ledgers()
    tpar.DistributedNetwork(tn, tpar.TensorParallelTrainingMaster(
        mesh=tmesh_of(4, 2))).fit(ListDataSetIterator(DataSet(x, y), 8),
                                  epochs=2)
    np.testing.assert_allclose(tvec(tn), tvec(tserial), rtol=0,
                               atol=ATOL_SERIAL)
    np.testing.assert_allclose(tvec(tn), jvec(jn), rtol=RTOL, atol=ATOL)
    prog = shardstats.program_analysis("TensorParallelTrainingMaster.step")
    col = prog["collectives"]
    # the model slots' psums (Wo, the FFN's row layer, the vocab-parallel
    # loss) beside the data slots' gradient all-reduce, and the gathers
    # before the LayerNorms of the embedding's column-sharded output
    assert 2 in col["all-reduce"]["group_sizes"]
    assert 4 in col["all-reduce"]["group_sizes"]
    assert col["all-gather"]["count"] >= 1
    led = shardstats.latest_ledgers()["sync_master"]
    # the sharded leaves hold one block a model slot
    assert led["trees"]["params"]["replication_factor"] < 8


def test_vocab_parallel_cross_entropy_equals_the_whole_softmax():
    rs = np.random.RandomState(3)
    z = torch.tensor(rs.randn(5, 7, 12) * 4.0)
    lab = torch.tensor(np.eye(12)[rs.randint(0, 12, (5, 7))])
    want = -(lab * torch.log_softmax(z, -1)).sum(-1)
    with slots.model_slots(4):
        got = slots.vocab_parallel_mcxent(lab, z)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                               atol=1e-12)


def test_tensor_parallel_computation_graph_matches_jax():
    """A ComputationGraph under the TP master: a column- and a
    row-parallel branch merged (the merge vertex reads the column branch's
    sharded output whole: one all-gather in the census, though the
    row-parallel branch ran after it), a column-parallel layer and the
    row-parallel head, against the JAX master."""
    from deeplearning4j_tpu.models.vertices import MergeVertex

    jn = JGraph(JConf.builder().seed(7).updater("adam", learning_rate=0.01)
                .graph().add_inputs("in")
                .add_layer("d0", jl.DenseLayer(n_in=6, n_out=8,
                                               activation="tanh"), "in")
                .add_layer("d1", jl.DenseLayer(n_in=6, n_out=8,
                                               activation="relu"), "in")
                .add_vertex("merge", MergeVertex(), "d0", "d1")
                .add_layer("d2", jl.DenseLayer(n_in=16, n_out=12,
                                               activation="tanh"), "merge")
                .add_layer("out", jl.OutputLayer(n_in=12, n_out=3), "d2")
                .set_outputs("out").build()).init()
    conf = GraphConfiguration.from_json(jn.conf.to_json())
    tn = graph_params_from_numpy(conf, jax.device_get(jn.params),
                                 jax.device_get(jn.net_state), device="cpu")
    spec = tpar.tensor_parallel_spec(tn.params, tp=2)
    _specs_equal(spec, jpar.tensor_parallel_spec(jn.params, tp=2))
    x, y = data(16, 6, 3)
    shardstats.clear_ledgers()
    _fit_both(jn, tn, x, y, 8, epochs=2, data_=2, model=2)
    np.testing.assert_allclose(tvec(tn), jvec(jn), rtol=RTOL, atol=ATOL)
    ag = shardstats.program_analysis("TensorParallelTrainingMaster.step")[
        "collectives"]["all-gather"]
    # d0's [8, 8] float32 output over the 2 model slots
    assert ag["count"] == 1 and ag["group_sizes"] == [2]
    assert ag["bytes"] == 8 * 8 * 4


def test_tensor_parallel_conv_net_matches_jax():
    """A conv layer sharded on its output channels (each slot convolves
    with its block; the pooling and the dense layer after it read all
    the channels), against the JAX master."""
    jn = JNet(JConf.builder().seed(7).updater("adam", learning_rate=0.01)
              .list()
              .layer(jl.ConvolutionLayer(n_out=4, kernel_size=(3, 3),
                                         activation="relu"))
              .layer(jl.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
              .layer(jl.DenseLayer(n_out=16, activation="tanh"))
              .layer(jl.OutputLayer(n_out=3))
              .set_input_type(JInputType.convolutional(6, 6, 2))
              .build()).init()
    tn = port_of(jn)
    spec = tpar.tensor_parallel_spec(tn.params, tp=2)
    assert spec["layer_0"]["W"] == P(None, None, None, "model")
    _specs_equal(spec, jpar.tensor_parallel_spec(jn.params, tp=2))
    rs = np.random.RandomState(2)
    x = rs.rand(16, 6, 6, 2).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, 16)]
    _fit_both(jn, tn, x, y, 8, epochs=2, data_=2, model=2)
    np.testing.assert_allclose(tvec(tn), jvec(jn), rtol=RTOL, atol=ATOL)


def test_tensor_parallel_master_refuses_zero_and_needs_model_axis():
    with pytest.raises(ValueError, match="zero"):
        tpar.TensorParallelTrainingMaster(mesh=tmesh_of(2, 2),
                                          update_sharding="zero")
    mesh = tmesh.Mesh(np.asarray(["cpu"] * 2, dtype=object), ("data",))
    with pytest.raises(ValueError, match="model axis"):
        tpar.TensorParallelTrainingMaster(mesh=mesh)


def test_tensor_parallel_views_write_the_nets_tensors():
    """The forward reads each sharded leaf as a ``[tp, ...]`` view of the
    net's own tensor: the step writes the net's weights in place (no copy
    to write back), and the sharded leaves reach the layers as stacks."""
    jn = mlp()
    tn = port_of(jn)
    before = [t for l in tn.params.values() for t in l.values()]
    master = tpar.TensorParallelTrainingMaster(mesh=tmesh_of(2, 2))
    x, y = data(16)
    tpar.DistributedNetwork(tn, master).fit(
        ListDataSetIterator(DataSet(x, y), 16))
    after = [t for l in tn.params.values() for t in l.values()]
    assert all(a is b for a, b in zip(before, after))
    master.net_ = tn
    seen = master._full(tn.params)
    assert seen["layer_0"]["W"].shape == (2, 8, 8)        # column blocks
    assert seen["layer_1"]["W"].shape == (2, 8, 16)       # row blocks
    assert seen["layer_0"]["b"] is tn.params["layer_0"]["b"]
    assert seen["layer_0"]["W"].untyped_storage().data_ptr() == \
        tn.params["layer_0"]["W"].untyped_storage().data_ptr()
    np.testing.assert_allclose(tvec(tn), jvec(_fitted_jax(x, y)),
                               rtol=RTOL, atol=ATOL)


def _fitted_jax(x, y):
    jn = mlp()
    jpar.DistributedNetwork(jn, jpar.TensorParallelTrainingMaster(
        mesh=jmesh(2, 2))).fit(JIt(JDataSet(x, y), 16))
    return jn
