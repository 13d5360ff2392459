"""The port's iterators (``datasets/iterator.py``), evaluation
(``evaluation/``) and the facades' ``evaluate`` on the CPU, against the
JAX package on the same arrays.

- Iterators: each one's batches equal the reference iterator's over the
  same DataSet (list, re-batching, multiple epochs, sampling with a
  seed, the async prefetch); ``AsyncDataSetIterator`` surfaces a
  producer error on the consumer side and resets cleanly; the native
  batcher (the port's own build since its A8 slice) gives the reference
  iterator's batches.  Both facades' ``fit`` take a ``DataSetIterator``.
- ``Evaluation`` (top-N, time-series masks, metadata) and
  ``RegressionEvaluation`` against the reference: counts exact, metrics
  to 1e-12.
- ``evaluate`` on both facades against the JAX facades on the committed
  ``mlp.zip``, ``cnn.zip`` and ``graph.zip``: accuracy equal.
"""

from pathlib import Path

import numpy as np
import pytest

from deeplearning4j_tpu.datasets import iterator as jit_mod
from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.evaluation import (
    Evaluation as JaxEvaluation,
    RegressionEvaluation as JaxRegressionEvaluation,
)
from deeplearning4j_tpu.models.serialization import (
    restore_computation_graph as jax_restore_graph,
    restore_multi_layer_network as jax_restore,
)
from deeplearning4j_tpu_torch.datasets import iterator as it_mod
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.evaluation import (
    ConfusionMatrix, Evaluation, RegressionEvaluation,
)
from deeplearning4j_tpu_torch.models import serialization

FIXTURES = Path(__file__).parent / "regression_fixtures"


def _data(n=23, f=5, c=3, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.rand(n, f).astype(np.float32)
    y = np.eye(c, dtype=np.float32)[rs.randint(0, c, n)]
    return x, y


def _batches(it):
    return [(np.asarray(d.features), np.asarray(d.labels)) for d in it]


def _same(a, b):
    assert len(a) == len(b)
    for (x1, y1), (x2, y2) in zip(a, b):
        np.testing.assert_array_equal(x1, x2)
        np.testing.assert_array_equal(y1, y2)


# --------------------------------------------------------------- iterators
@pytest.mark.parametrize("kind", ["list", "list_drop", "rebatch", "epochs",
                                  "sampling", "async"])
def test_iterators_match_the_reference(kind):
    x, y = _data()

    def make(mod, ds_cls):
        ds = ds_cls(x, y)
        if kind == "list":
            return mod.ListDataSetIterator(ds, 5)
        if kind == "list_drop":
            return mod.ListDataSetIterator(ds, 5, drop_last=True)
        if kind == "rebatch":
            singles = [ds.subset(slice(i, i + 1)) for i in range(len(ds))]
            return mod.IteratorDataSetIterator(singles, 4)
        if kind == "epochs":
            return mod.MultipleEpochsIterator(
                3, mod.ListDataSetIterator(ds, 6))
        if kind == "sampling":
            return mod.SamplingDataSetIterator(ds, 4, total_batches=5,
                                               seed=3)
        return mod.AsyncDataSetIterator(mod.ListDataSetIterator(ds, 7), 2)

    port, ref = make(it_mod, DataSet), make(jit_mod, JaxDataSet)
    _same(_batches(port), _batches(ref))
    # iterating again resets: the same batches
    _same(_batches(port), _batches(ref))


def test_list_iterator_counts():
    x, y = _data(n=10)
    it = it_mod.ListDataSetIterator(DataSet(x, y), 4)
    assert it.batch() == 4 and it.total_examples() == 10
    assert it.input_columns() == 5 and it.total_outcomes() == 3
    batches = list(it)
    # the short last batch is padded to the static shape, its padding
    # rows masked out of the loss
    assert [len(d) for d in batches] == [4, 4, 4]
    np.testing.assert_array_equal(batches[-1].labels_mask, [1, 1, 0, 0])


class _Exploding(it_mod.DataSetIterator):
    """Yields ``good`` batches, then raises in ``next``."""

    def __init__(self, good=2):
        self.good, self.i = good, 0

    def has_next(self):
        return True

    def next(self):
        self.i += 1
        if self.i > self.good:
            raise ValueError("bad shard")
        x, y = _data(n=2, seed=self.i)
        return DataSet(x, y)

    def reset(self):
        self.i = 0

    def batch(self):
        return 2


def test_async_iterator_surfaces_the_producer_error():
    it = it_mod.AsyncDataSetIterator(_Exploding(good=2), prefetch_size=1)
    got = []
    with pytest.raises(RuntimeError, match="producer failed") as err:
        while it.has_next():
            got.append(it.next())
    assert len(got) == 2
    assert isinstance(err.value.__cause__, ValueError)


def test_async_iterator_reset_replays_and_hands_out_numpy():
    x, y = _data(n=12)
    it = it_mod.AsyncDataSetIterator(
        it_mod.ListDataSetIterator(DataSet(x, y), 5), prefetch_size=1)
    first = _batches(it)
    it.reset()
    second = _batches(it)
    _same(first, second)
    assert all(isinstance(b[0], np.ndarray) for b in first)
    # a reset in the middle of an epoch drains the producer
    it = it_mod.AsyncDataSetIterator(
        it_mod.ListDataSetIterator(DataSet(x, y), 2), prefetch_size=1)
    it.next()
    it.reset()
    assert len(_batches(it)) == 6


def test_native_iterator_names_its_item():
    """Once a raise naming ROADMAP A8; the item is ported, so the port's
    native batcher gives the reference iterator's batches: 23 rows in 6
    batches of 4, the last padded under a labels mask of 3 rows."""
    x, y = _data()
    ours = list(it_mod.NativeBatchDataSetIterator(DataSet(x, y), 4, seed=2))
    theirs = list(jit_mod.NativeBatchDataSetIterator(JaxDataSet(x, y), 4,
                                                     seed=2))
    assert len(ours) == len(theirs) == 6
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a.features, b.features)
        np.testing.assert_array_equal(a.labels, b.labels)
    assert ours[-1].labels_mask.tolist() == [1.0, 1.0, 1.0, 0.0]
    np.testing.assert_array_equal(ours[-1].labels_mask,
                                  theirs[-1].labels_mask)


@pytest.mark.parametrize("facade", ["sequential", "graph"])
def test_fit_takes_a_dataset_iterator(facade):
    """``fit(DataSetIterator)`` steps once a batch, an async one too, and
    equals ``fit`` over the same batches as a list."""
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer

    def net():
        b = (NeuralNetConfiguration.builder().seed(3)
             .updater("sgd", learning_rate=0.1))
        if facade == "graph":
            from deeplearning4j_tpu_torch.models.graph import (
                ComputationGraph,
            )
            conf = (b.graph().add_inputs("in")
                    .add_layer("d", DenseLayer(n_in=5, n_out=4), "in")
                    .add_layer("out", OutputLayer(n_in=4, n_out=3), "d")
                    .set_outputs("out").build())
            return ComputationGraph(conf).init(device="cpu")
        from deeplearning4j_tpu_torch.models.sequential import (
            MultiLayerNetwork,
        )
        conf = (b.list().layer(DenseLayer(n_in=5, n_out=4))
                .layer(OutputLayer(n_in=4, n_out=3)).build())
        return MultiLayerNetwork(conf).init(device="cpu")

    x, y = _data(n=20)
    a, b = net(), net()
    a.fit(it_mod.AsyncDataSetIterator(
        it_mod.ListDataSetIterator(DataSet(x, y), 5)))
    b.fit([(x[i:i + 5], y[i:i + 5]) for i in range(0, 20, 5)])
    assert a.iteration == b.iteration == 4
    np.testing.assert_array_equal(a.params_to_vector(), b.params_to_vector())


# -------------------------------------------------------------- evaluation
def _metrics(ev, c):
    return ([ev.accuracy(), ev.top_n_accuracy(), ev.precision(),
             ev.recall(), ev.f1()]
            + [ev.precision(i) for i in range(c)]
            + [ev.recall(i) for i in range(c)]
            + [ev.f1(i) for i in range(c)]
            + [ev.false_positive_rate(i) for i in range(c)])


@pytest.mark.parametrize("top_n", [1, 3])
def test_evaluation_matches_the_reference(top_n):
    rs = np.random.RandomState(5)
    c = 6
    ev, jev = Evaluation(top_n=top_n), JaxEvaluation(top_n=top_n)
    for _ in range(4):
        y = np.eye(c)[rs.randint(0, c, 17)]
        p = rs.rand(17, c)
        meta = [f"row{i}" for i in range(17)]
        ev.eval(y, p, metadata=meta)
        jev.eval(y, p, metadata=meta)
    np.testing.assert_array_equal(ev.confusion.matrix, jev.confusion.matrix)
    assert ev.top_n_correct == jev.top_n_correct
    assert ev.prediction_errors == jev.prediction_errors
    np.testing.assert_allclose(_metrics(ev, c), _metrics(jev, c), rtol=0,
                               atol=1e-12)
    assert ev.stats() == jev.stats()


def test_evaluation_time_series_mask_matches_the_reference():
    rs = np.random.RandomState(6)
    y = np.eye(4)[rs.randint(0, 4, (3, 7))]
    p = rs.rand(3, 7, 4)
    mask = (rs.rand(3, 7) > 0.3).astype(np.float32)
    for m in (mask, None):
        ev, jev = Evaluation(), JaxEvaluation()
        ev.eval(y, p, mask=m)
        jev.eval(y, p, mask=m)
        np.testing.assert_array_equal(ev.confusion.matrix,
                                      jev.confusion.matrix)
        assert ev.accuracy() == jev.accuracy()
    cm = ConfusionMatrix(2)
    cm.add(0, 1)
    assert cm.count(0, 1) == 1


def test_regression_evaluation_matches_the_reference():
    rs = np.random.RandomState(7)
    ev, jev = RegressionEvaluation(), JaxRegressionEvaluation()
    for _ in range(3):
        y, p = rs.randn(11, 3), rs.randn(11, 3)
        ev.eval(y, p)
        jev.eval(y, p)
    for name in ("mean_squared_error", "mean_absolute_error",
                 "root_mean_squared_error", "relative_squared_error",
                 "correlation_r2"):
        for col in range(3):
            np.testing.assert_allclose(getattr(ev, name)(col),
                                       getattr(jev, name)(col), rtol=0,
                                       atol=1e-12)
    assert ev.stats() == jev.stats()


# ------------------------------------------------------------- evaluate
@pytest.mark.parametrize("name", ["mlp", "cnn"])
def test_sequential_evaluate_matches_jax(name):
    net = serialization.restore_multi_layer_network(
        FIXTURES / f"{name}.zip", device="cpu")
    jnet = jax_restore(FIXTURES / f"{name}.zip")
    x = np.load(FIXTURES / f"{name}_input.npy")
    c = np.load(FIXTURES / f"{name}_expected.npy").shape[-1]
    rs = np.random.RandomState(8)
    xs = np.concatenate([x, x[::-1], x * 0.5])
    ys = np.eye(c, dtype=np.float32)[rs.randint(0, c, len(xs))]
    ev = net.evaluate(it_mod.ListDataSetIterator(DataSet(xs, ys), 4))
    jev = jnet.evaluate(jit_mod.ListDataSetIterator(JaxDataSet(xs, ys), 4))
    np.testing.assert_array_equal(ev.confusion.matrix, jev.confusion.matrix)
    assert ev.accuracy() == jev.accuracy()


def test_graph_evaluate_matches_jax():
    net = serialization.restore_computation_graph(FIXTURES / "graph.zip",
                                                  device="cpu")
    jnet = jax_restore_graph(FIXTURES / "graph.zip")
    feats = {k: np.load(FIXTURES / f"graph_input_{k}.npy")
             for k in ("a", "b")}
    c = np.load(FIXTURES / "graph_expected.npy").shape[-1]
    ys = np.eye(c, dtype=np.float32)[[0, 1, 1, 0]]
    ev = net.evaluate([DataSet(feats, ys)])
    jev = jnet.evaluate([JaxDataSet(feats, ys)])
    np.testing.assert_array_equal(ev.confusion.matrix, jev.confusion.matrix)
    assert ev.accuracy() == jev.accuracy()
