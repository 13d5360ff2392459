"""The port's ``MultiDataSet`` and its iterators
(``deeplearning4j_tpu_torch/datasets/multidataset.py``) and the DataVec
bridge (``datavec.py``: CSV and sequence record readers, the record
iterators with their masks) against the JAX package's on the same
records, on the CPU.  Batches are equal array for array, masks included.
Then a two-input, two-output ``ComputationGraph`` fed by
``RecordReaderMultiDataSetIterator`` over a CSV for 3 steps against the
JAX graph, weights carried across, at ``rtol=1e-4, atol=1e-5``.
"""

import jax
import numpy as np
import pytest

from deeplearning4j_tpu.datasets import datavec as jdv
from deeplearning4j_tpu.datasets import multidataset as jmd
from deeplearning4j_tpu_torch.datasets import datavec as dv
from deeplearning4j_tpu_torch.datasets import multidataset as md

RTOL, ATOL = 1e-4, 1e-5


def _equal(a, b):
    return (a is None and b is None) or (
        a is not None and b is not None and a.dtype == b.dtype
        and a.shape == b.shape and np.array_equal(a, b))


def _tuples_equal(a, b):
    if a is None or b is None:
        return a is None and b is None
    return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))


def _mds_equal(a, b):
    assert _tuples_equal(a.features, b.features)
    assert _tuples_equal(a.labels, b.labels)
    assert _tuples_equal(a.features_masks, b.features_masks)
    assert _tuples_equal(a.labels_masks, b.labels_masks)


def _ds_equal(a, b):
    for f in ("features", "labels", "features_mask", "labels_mask"):
        assert _equal(getattr(a, f), getattr(b, f)), f


def _drain(it):
    out = []
    while it.has_next():
        out.append(it.next())
    return out


def _table(n=50, seed=0):
    """Rows of 4 + 3 features, a class id in [0, 3), two targets."""
    rs = np.random.RandomState(seed)
    return np.concatenate(
        [rs.randn(n, 7).round(4), rs.randint(0, 3, (n, 1)),
         rs.randn(n, 2).round(4)], 1)


def _csv(table):
    return "\n".join(",".join(repr(float(v)) for v in row)
                     for row in table).encode() + b"\n"


# ---------------------------------------------------------- MultiDataSet
def _mds(pkg, seed=1, n=11, masks=True):
    rs = np.random.RandomState(seed)
    f = (rs.rand(n, 3).astype(np.float32), rs.rand(n, 5, 2).astype(np.float32))
    l = (np.eye(4, dtype=np.float32)[rs.randint(0, 4, n)],)
    fm = (None, (rs.rand(n, 5) > 0.3).astype(np.float32)) if masks else None
    lm = ((rs.rand(n) > 0.2).astype(np.float32),) if masks else None
    return pkg.MultiDataSet(f, l, fm, lm)


@pytest.mark.parametrize("masks", [True, False])
def test_multidataset_operations_equal_the_reference(masks):
    a, b = _mds(md, masks=masks), _mds(jmd, masks=masks)
    assert len(a) == a.num_examples() == 11
    _mds_equal(a, b)
    idx = np.array([3, 0, 7, 7])
    _mds_equal(a.subset(idx), b.subset(idx))
    _mds_equal(a.shuffle(np.random.RandomState(4)),
               b.shuffle(np.random.RandomState(4)))
    for drop in (False, True):
        ba, bb = a.batch_by(4, drop), b.batch_by(4, drop)
        assert len(ba) == len(bb) == (2 if drop else 3)
        for x, y in zip(ba, bb):
            _mds_equal(x, y)
    _mds_equal(md.MultiDataSet.merge(a.batch_by(4)),
               jmd.MultiDataSet.merge(b.batch_by(4)))


@pytest.mark.parametrize("wrap", ["list", "async"])
def test_multidataset_iterators_equal_the_reference(wrap):
    a, b = _mds(md, seed=3, n=23), _mds(jmd, seed=3, n=23)
    ia, ib = md.ListMultiDataSetIterator(a, 5), \
        jmd.ListMultiDataSetIterator(b, 5)
    if wrap == "async":
        ia, ib = md.AsyncMultiDataSetIterator(ia, 2), \
            jmd.AsyncMultiDataSetIterator(ib, 2)
    for _ in range(2):                          # and again after a reset
        got, want = list(ia), list(ib)
        assert len(got) == len(want) == 5
        for x, y in zip(got, want):
            _mds_equal(x, y)
    assert ia.batch() == 5


def test_async_multidataset_iterator_surfaces_producer_errors():
    class Failing(md.MultiDataSetIterator):
        def has_next(self):
            return True

        def next(self):
            raise KeyError("boom")

        def reset(self):
            pass

    it = md.AsyncMultiDataSetIterator(Failing())
    with pytest.raises(RuntimeError, match="producer failed"):
        it.has_next()


def _record_mds(pkg, dvpkg, table, batch=16, source="csv"):
    if source == "csv":
        reader = dvpkg.CSVRecordReader().initialize(_csv(table))
    else:
        reader = dvpkg.CollectionRecordReader(table.tolist())
    return (pkg.RecordReaderMultiDataSetIterator.builder(batch)
            .add_reader("r", reader)
            .add_input("r", 0, 3).add_input("r", 4, 6)
            .add_output_one_hot("r", 7, 3).add_output("r", 8, 9)
            .build())


@pytest.mark.parametrize("source", ["csv", "collection"])
def test_record_reader_multidataset_equals_the_reference(source):
    table = _table(50)
    ia = _record_mds(md, dv, table, source=source)
    ib = _record_mds(jmd, jdv, table, source=source)
    for _ in range(2):
        got, want = list(ia), list(ib)
        assert [len(x) for x in got] == [16, 16, 16, 2]
        for x, y in zip(got, want):
            _mds_equal(x, y)
        assert [f.shape[1] for f in got[0].features] == [4, 3]
        assert [l.shape[1] for l in got[0].labels] == [3, 2]


def test_record_reader_multidataset_builder_guards():
    b = md.RecordReaderMultiDataSetIterator.builder(4)
    with pytest.raises(ValueError, match="unknown reader"):
        b.add_input("nope", 0, 1).build()
    b = md.RecordReaderMultiDataSetIterator.builder(4).add_reader(
        "r", dv.CollectionRecordReader([[1.0, 2.0]]))
    with pytest.raises(ValueError, match="at least one"):
        b.add_input("r", 0, 0).build()


# ----------------------------------------------------------------- datavec
def test_csv_record_reader_equals_the_reference(tmp_path):
    table = _table(9, seed=2)
    path = tmp_path / "t.csv"
    path.write_bytes(b"h0,h1,h2,h3,h4,h5,h6,h7,h8,h9\n" + _csv(table))
    a = dv.CSVRecordReader(skip_lines=1).initialize(path)
    b = jdv.CSVRecordReader(skip_lines=1).initialize(str(path))
    assert _equal(a.matrix(), b.matrix())
    assert a.matrix().shape == (9, 10)
    assert _drain_records(a) == _drain_records(b)
    with pytest.raises(FileNotFoundError):
        dv.CSVRecordReader().initialize(tmp_path / "missing.csv")
    with pytest.raises(ValueError, match="non-numeric"):
        dv.CSVRecordReader().initialize(b"1,2\n3,four\n")


def _drain_records(reader):
    out = []
    while reader.has_next():
        out.append([float(v) for v in reader.next_record()])
    return out


@pytest.mark.parametrize("kw", [
    dict(label_index=7, num_classes=3),
    dict(label_index=8, label_index_to=9, regression=True),
    dict()], ids=["classification", "regression", "unlabelled"])
def test_record_reader_dataset_iterator_equals_the_reference(kw):
    table = _table(21, seed=6)
    a = dv.RecordReaderDataSetIterator(
        dv.CSVRecordReader().initialize(_csv(table)), 8, **kw)
    b = jdv.RecordReaderDataSetIterator(
        jdv.CSVRecordReader().initialize(_csv(table)), 8, **kw)
    for _ in range(2):
        got, want = list(a), list(b)
        assert [len(d) for d in got] == [8, 8, 5]
        for x, y in zip(got, want):
            _ds_equal(x, y)


def _sequences(seed, lengths, width):
    rs = np.random.RandomState(seed)
    return [rs.randn(t, width).round(3).tolist() for t in lengths]


@pytest.mark.parametrize("alignment", [dv.ALIGN_START, dv.ALIGN_END,
                                       dv.EQUAL_LENGTH])
def test_sequence_iterator_masks_equal_the_reference(alignment):
    """Unequal feature and label lengths, aligned at the start or the end
    of the padded time axis: features, labels and both masks equal."""
    feats = _sequences(1, [5, 3, 7, 2, 6], 4)
    labs = [[[float(i % 3)] for i in range(t)] for t in [5, 1, 7, 2, 3]]

    def make(pkg):
        return pkg.SequenceRecordReaderDataSetIterator(
            pkg.CollectionSequenceRecordReader(feats),
            pkg.CollectionSequenceRecordReader(labs), batch_size=3,
            num_classes=3, alignment=alignment)

    got, want = list(make(dv)), list(make(jdv))
    assert len(got) == len(want) == 2
    for x, y in zip(got, want):
        _ds_equal(x, y)
    assert got[0].features.shape == (3, 7, 4)
    assert got[0].labels_mask is not None


def test_sequence_single_reader_and_csv_files_equal_the_reference(tmp_path):
    """One reader split at ``label_index`` (regression), and one CSV file
    a sequence through the native parser."""
    seqs = _sequences(4, [4, 6, 2], 3)
    paths = []
    for i, s in enumerate(seqs):
        p = tmp_path / f"seq_{i}.csv"
        p.write_bytes(_csv(np.asarray(s)))
        paths.append(p)

    def make(pkg):
        return pkg.SequenceRecordReaderDataSetIterator(
            pkg.CSVSequenceRecordReader().initialize(paths), batch_size=2,
            regression=True, label_index=1)

    got, want = list(make(dv)), list(make(jdv))
    assert len(got) == 2
    for x, y in zip(got, want):
        _ds_equal(x, y)
    assert got[0].features.shape == (2, 6, 2)
    assert got[0].labels.shape == (2, 6, 1)


# ---------------------------------------------------------------- training
def _graphs():
    from deeplearning4j_tpu.models.graph import ComputationGraph as JCG
    from deeplearning4j_tpu.models.vertices import MergeVertex
    from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.models.graph import GraphConfiguration
    from deeplearning4j_tpu_torch.models.interop import (
        graph_params_from_numpy,
    )

    conf = (NeuralNetConfiguration.builder().seed(17)
            .updater("adam", learning_rate=1e-2).graph()
            .add_inputs("a", "b")
            .add_layer("da", DenseLayer(n_in=4, n_out=8,
                                        activation="tanh"), "a")
            .add_layer("db", DenseLayer(n_in=3, n_out=8,
                                        activation="relu"), "b")
            .add_vertex("m", MergeVertex(), "da", "db")
            .add_layer("cls", OutputLayer(n_in=16, n_out=3, loss="mcxent",
                                          activation="softmax"), "m")
            .add_layer("reg", OutputLayer(n_in=16, n_out=2, loss="mse",
                                          activation="identity"), "m")
            .set_outputs("cls", "reg").build())
    jnet = JCG(conf).init()
    net = graph_params_from_numpy(
        GraphConfiguration.from_json(jnet.conf.to_json()),
        jax.device_get(jnet.params), jax.device_get(jnet.net_state),
        device="cpu")
    return jnet, net


def test_two_input_two_output_graph_fed_from_csv_matches_jax():
    table = _table(48, seed=9)
    jnet, net = _graphs()
    jnet.fit(_record_mds(jmd, jdv, table))
    net.fit(_record_mds(md, dv, table))
    assert net.iteration == jnet.iteration == 3
    np.testing.assert_allclose(net.score_value, jnet.score_value,
                               rtol=RTOL, atol=ATOL)
    for lname, sub in jax.device_get(jnet.params).items():
        for k, v in sub.items():
            np.testing.assert_allclose(net.params[lname][k].numpy(), v,
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"{lname}/{k}")
