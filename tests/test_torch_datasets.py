"""The port's dataset readers (``deeplearning4j_tpu_torch/datasets``:
mnist, cifar, lfw, curves, iris, export) against the JAX package's on the
same files and seeds, on the CPU.

Exact: every array equal (``np.array_equal``), the files each package
writes byte-equal.  The one place they part is the LFW repair: a PGM
header ending in ``\\r\\n`` reads the same pixels as one ending in ``\\n``
in the port, and shifted pixels in the reference.  Then LeNet fed by
``NativeBatchDataSetIterator`` for 3 steps (the last a padded batch under
its labels mask) against the JAX net, weights carried across, at
``rtol=1e-4, atol=1e-5``.
"""

import gzip
import logging

import jax
import numpy as np
import pytest

from deeplearning4j_tpu.datasets import cifar as jcifar
from deeplearning4j_tpu.datasets import curves as jcurves
from deeplearning4j_tpu.datasets import export as jexport
from deeplearning4j_tpu.datasets import iris as jiris
from deeplearning4j_tpu.datasets import lfw as jlfw
from deeplearning4j_tpu.datasets import mnist as jmnist
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.iterator import (
    ListDataSetIterator as JList, NativeBatchDataSetIterator as JNativeIt,
)
from deeplearning4j_tpu_torch.datasets import (
    cifar, curves, export, iris, lfw, mnist,
)
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterator import (
    ListDataSetIterator, NativeBatchDataSetIterator,
)

RTOL, ATOL = 1e-4, 1e-5


def _equal(a, b):
    return (a is None and b is None) or (
        a is not None and b is not None and a.dtype == b.dtype
        and a.shape == b.shape and np.array_equal(a, b))


def _same_fetch(a, b):
    assert a.is_synthetic == b.is_synthetic
    assert _equal(a.features, b.features)
    assert _equal(a.labels, b.labels)


def _batches_equal(ours, theirs):
    a, b = list(ours), list(theirs)
    assert len(a) == len(b)
    for da, db in zip(a, b):
        assert _equal(da.features, db.features)
        assert _equal(da.labels, db.labels)
        assert _equal(da.features_mask, db.features_mask)
        assert _equal(da.labels_mask, db.labels_mask)


# ----------------------------------------------------------------- MNIST
def _u8(a):
    return np.round(a * 255.0).astype(np.uint8)


def _write_mnist(root, write_idx, suffix="", n_train=200, n_test=48):
    imgs, labels = jmnist._synthetic_mnist(n_train, seed=123)
    timgs, tlabels = jmnist._synthetic_mnist(n_test, seed=124)
    root.mkdir(parents=True, exist_ok=True)
    write_idx(root / ("train-images-idx3-ubyte" + suffix), _u8(imgs))
    write_idx(root / ("train-labels-idx1-ubyte" + suffix),
              labels.astype(np.uint8))
    write_idx(root / ("t10k-images-idx3-ubyte" + suffix), _u8(timgs))
    write_idx(root / ("t10k-labels-idx1-ubyte" + suffix),
              tlabels.astype(np.uint8))


@pytest.mark.parametrize("suffix", ["", ".gz"], ids=["raw", "gz"])
def test_write_idx_writes_the_references_bytes(tmp_path, suffix):
    _write_mnist(tmp_path / "port", mnist.write_idx, suffix)
    _write_mnist(tmp_path / "jax", jmnist.write_idx, suffix)
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert len(names) == 4
    for name in names:
        a = (tmp_path / "port" / name).read_bytes()
        b = (tmp_path / "jax" / name).read_bytes()
        if suffix:           # gzip headers carry a timestamp
            a, b = gzip.decompress(a), gzip.decompress(b)
        assert a == b, name


@pytest.mark.parametrize("suffix", ["", ".gz"], ids=["raw", "gz"])
@pytest.mark.parametrize("train, num", [(True, None), (False, None),
                                        (True, 57)])
def test_mnist_idx_arrays_equal_the_references(tmp_path, suffix, train, num):
    _write_mnist(tmp_path, jmnist.write_idx, suffix)
    ours = mnist.MnistDataFetcher(train=train, data_dir=str(tmp_path),
                                  num_examples=num, allow_synthetic=False)
    theirs = jmnist.MnistDataFetcher(train=train, data_dir=str(tmp_path),
                                     num_examples=num, allow_synthetic=False)
    assert ours.is_synthetic is False
    _same_fetch(ours, theirs)
    _batches_equal(
        mnist.MnistDataSetIterator(32, num_examples=num, train=train,
                                   data_dir=str(tmp_path)),
        jmnist.MnistDataSetIterator(32, num_examples=num, train=train,
                                    data_dir=str(tmp_path)))


@pytest.mark.parametrize("train", [True, False])
def test_mnist_synthetic_glyphs_equal_the_references(tmp_path, train, caplog):
    with caplog.at_level(logging.WARNING):
        ours = mnist.MnistDataFetcher(train=train, data_dir=str(tmp_path),
                                      num_examples=96, seed=7)
    assert ours.is_synthetic is True
    assert "SYNTHETIC" in caplog.text
    theirs = jmnist.MnistDataFetcher(train=train, data_dir=str(tmp_path),
                                     num_examples=96, seed=7)
    _same_fetch(ours, theirs)
    with pytest.raises(FileNotFoundError):
        mnist.MnistDataFetcher(data_dir=str(tmp_path), allow_synthetic=False)


# ----------------------------------------------------------------- CIFAR
def _write_cifar(root, write_batch, sub=False):
    d = root / "cifar-10-batches-bin" if sub else root
    d.mkdir(parents=True, exist_ok=True)
    imgs, labels = jcifar._synthetic_cifar(40, seed=7)
    write_batch(d / "data_batch_1.bin", _u8(imgs[:24]), labels[:24])
    write_batch(d / "data_batch_2.bin", _u8(imgs[24:]), labels[24:])
    timgs, tlabels = jcifar._synthetic_cifar(12, seed=8)
    write_batch(d / "test_batch.bin", _u8(timgs), tlabels)


def test_cifar_batch_files_are_byte_equal(tmp_path):
    _write_cifar(tmp_path / "port", cifar.write_cifar_batch)
    _write_cifar(tmp_path / "jax", jcifar.write_cifar_batch)
    for name in ("data_batch_1.bin", "data_batch_2.bin", "test_batch.bin"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes()


@pytest.mark.parametrize("sub", [False, True], ids=["flat", "subdir"])
@pytest.mark.parametrize("train", [True, False])
def test_cifar_arrays_equal_the_references(tmp_path, sub, train):
    _write_cifar(tmp_path, jcifar.write_cifar_batch, sub)
    kw = dict(train=train, data_dir=str(tmp_path), allow_synthetic=False)
    ours, theirs = cifar.CifarDataFetcher(**kw), jcifar.CifarDataFetcher(**kw)
    assert ours.is_synthetic is False
    _same_fetch(ours, theirs)


def test_cifar_synthetic_equals_the_reference(tmp_path):
    kw = dict(num_examples=30, seed=3, data_dir=str(tmp_path))
    _same_fetch(cifar.CifarDataFetcher(**kw), jcifar.CifarDataFetcher(**kw))
    _batches_equal(cifar.CifarDataSetIterator(8, **kw),
                   jcifar.CifarDataSetIterator(8, **kw))


# ------------------------------------------------------------------- LFW
def _pgm(img, eol=b"\n"):
    h, w = img.shape
    return (b"P5" + eol + b"%d %d" % (w, h) + eol + b"255" + eol
            + img.tobytes())


def _write_lfw(root, eol=b"\n", people=3, per_person=4):
    faces, _ = jlfw._synthetic_faces(people * per_person, 1, seed=100)
    for p in range(people):
        d = root / f"person_{p:02d}"
        d.mkdir(parents=True)
        for i in range(per_person):
            img = _u8(faces[p * per_person + i]).reshape(jlfw.SIDE,
                                                         jlfw.SIDE)
            # a 2x image, so the resize to SIDE has work to do
            big = np.kron(img, np.ones((2, 2), np.uint8))
            (d / f"{i}.pgm").write_bytes(_pgm(big, eol))


def test_write_pgm_writes_the_references_bytes(tmp_path):
    img = np.arange(200, dtype=np.uint8).reshape(10, 20)
    lfw.write_pgm(tmp_path / "a.pgm", img)
    jlfw.write_pgm(tmp_path / "b.pgm", img)
    assert (tmp_path / "a.pgm").read_bytes() == \
        (tmp_path / "b.pgm").read_bytes()


def test_lfw_person_dirs_equal_the_reference(tmp_path):
    _write_lfw(tmp_path)
    kw = dict(data_dir=str(tmp_path), allow_synthetic=False)
    ours, theirs = lfw.LFWDataFetcher(**kw), jlfw.LFWDataFetcher(**kw)
    assert ours.is_synthetic is False and ours.num_classes == 3
    _same_fetch(ours, theirs)


def test_lfw_crlf_headers_read_the_same_pixels(tmp_path):
    """The port's repair: PGM headers ending in \\r\\n read the pixels of
    the \\n files; the reference shifts every pixel by one byte."""
    _write_lfw(tmp_path / "lf")
    _write_lfw(tmp_path / "crlf", eol=b"\r\n")
    kw = dict(allow_synthetic=False)
    ours = lfw.LFWDataFetcher(data_dir=str(tmp_path / "crlf"), **kw)
    want = jlfw.LFWDataFetcher(data_dir=str(tmp_path / "lf"), **kw)
    _same_fetch(ours, want)
    theirs = jlfw.LFWDataFetcher(data_dir=str(tmp_path / "crlf"), **kw)
    assert not np.array_equal(theirs.features, want.features)


def test_read_pgm_header_ends(tmp_path):
    """A lone \\r ending the header before a first pixel of 10 (\\n) reads
    that pixel; comments and runs of whitespace inside the header parse
    as in the reference; no whitespace after maxval, or too few bytes,
    raise."""
    img = np.array([[10, 13, 200], [0, 255, 7]], np.uint8)
    (tmp_path / "cr.pgm").write_bytes(b"P5\r3 2\r255\r" + img.tobytes())
    assert _equal(lfw.read_pgm(tmp_path / "cr.pgm"), img)
    (tmp_path / "c.pgm").write_bytes(b"P5\n# scanner\n3  2\n255\n"
                                     + img.tobytes())
    assert _equal(lfw.read_pgm(tmp_path / "c.pgm"),
                  jlfw.read_pgm(tmp_path / "c.pgm"))
    (tmp_path / "t.pgm").write_bytes(b"P5\n3 2\n255\n" + img.tobytes()[:-1])
    with pytest.raises(ValueError, match="truncated"):
        lfw.read_pgm(tmp_path / "t.pgm")
    (tmp_path / "w.pgm").write_bytes(b"P5\n3 2\n65535\n" + bytes(12))
    with pytest.raises(ValueError, match="16-bit"):
        lfw.read_pgm(tmp_path / "w.pgm")


def test_lfw_npy_and_synthetic_equal_the_reference(tmp_path):
    feats, labels = jlfw._synthetic_faces(12, 3, seed=5)
    (tmp_path / "npy").mkdir()
    np.save(tmp_path / "npy" / "faces.npy", feats)
    np.save(tmp_path / "npy" / "labels.npy", labels)
    kw = dict(data_dir=str(tmp_path / "npy"), allow_synthetic=False)
    _same_fetch(lfw.LFWDataFetcher(**kw), jlfw.LFWDataFetcher(**kw))
    kw = dict(num_examples=20, num_classes=4, seed=9,
              data_dir=str(tmp_path / "none"))
    ours = lfw.LFWDataFetcher(**kw)
    assert ours.is_synthetic is True
    _same_fetch(ours, jlfw.LFWDataFetcher(**kw))


# ---------------------------------------------------------- curves, iris
@pytest.mark.parametrize("n, seed", [(16, 123), (40, 5)])
def test_curves_equal_the_reference(n, seed):
    a, b = curves.curves(n, seed), jcurves.curves(n, seed)
    assert _equal(a[0], b[0]) and _equal(a[1], b[1])
    _batches_equal(curves.CurvesDataSetIterator(7, n, seed),
                   jcurves.CurvesDataSetIterator(7, n, seed))


@pytest.mark.parametrize("normalize", [True, False])
def test_iris_table_equals_scikit_learns(normalize):
    """The port's own copy of the table against the JAX package's, which
    reads scikit-learn's bundled copy."""
    ours = iris.iris_dataset(normalize)
    theirs = jiris.iris_dataset(normalize)
    assert ours.features.shape == (150, 4)
    assert _equal(ours.features, theirs.features)
    assert _equal(ours.labels, theirs.labels)


@pytest.mark.parametrize("kw", [dict(), dict(batch_size=32, shuffle_seed=3),
                                dict(batch_size=50, num_examples=120,
                                     shuffle_seed=8)])
def test_iris_iterator_equals_the_reference(kw):
    _batches_equal(iris.IrisDataSetIterator(**kw),
                   jiris.IrisDataSetIterator(**kw))


def test_iris_needs_no_scikit_learn():
    src = iris.__file__
    assert "sklearn" not in open(src).read().split('"""', 2)[2]


# ------------------------------------------------------------------ export
def test_exported_files_equal_the_reference(tmp_path):
    """5 + 5 + 3 examples in batches of 5 from a ``NativeBatchDataSetIterator``:
    the files and their ``.masks.npz`` sidecars of each package hold the
    same arrays (the ``.bin`` files byte-equal), and each package's
    ``FileDataSetIterator`` reads either's back."""
    rs = np.random.RandomState(3)
    x = rs.rand(13, 2, 3).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rs.randint(0, 4, 13)]
    ours = export.export_datasets(
        NativeBatchDataSetIterator(DataSet(x, y), 5, seed=2), tmp_path / "p")
    theirs = jexport.export_datasets(
        JNativeIt(JDataSet(x, y), 5, seed=2), tmp_path / "j")
    assert [p.name for p in ours] == [p.name for p in theirs] == \
        ["dataset_00000.bin", "dataset_00001.bin", "dataset_00002.bin"]
    for a, b in zip(ours, theirs):
        assert a.read_bytes() == b.read_bytes()
    assert sorted(p.name for p in (tmp_path / "p").glob("*.npz")) == \
        ["dataset_00002.masks.npz"]
    for d in ("p", "j"):
        _batches_equal(export.FileDataSetIterator(tmp_path / d),
                       jexport.FileDataSetIterator(tmp_path / d))
        it = export.FileDataSetIterator(tmp_path / d)
        assert it.batch() == 5
        last = list(it)[-1]
        assert last.labels_mask.tolist() == [1, 1, 1, 0, 0]
    with pytest.raises(FileNotFoundError):
        export.FileDataSetIterator(tmp_path / "none")


# ---------------------------------------------------------------- training
def test_lenet_fed_by_the_native_batcher_matches_jax():
    """Zoo LeNet, weights carried across, fed 40 MNIST-shaped examples in
    batches of 16 by each package's ``NativeBatchDataSetIterator`` (3
    steps: two full batches, then 8 rows padded to 16 under a labels
    mask): parameters, updater state and the last loss agree."""
    from deeplearning4j_tpu.models import zoo as jzoo
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.models.common import tree_leaves
    from deeplearning4j_tpu_torch.models.interop import params_from_numpy
    from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration

    imgs, labels = jmnist._synthetic_mnist(40, seed=11)
    x = imgs.reshape(40, 784)
    y = np.eye(10, dtype=np.float32)[labels]
    jnet = jzoo.lenet()
    conf = MultiLayerConfiguration.from_json(jnet.conf.to_json())
    net = params_from_numpy(conf, jax.device_get(jnet.params), device="cpu")
    assert zoo.lenet(device="cpu").conf.to_dict() == conf.to_dict()
    jnet.fit(JNativeIt(JDataSet(x, y), 16, seed=21))
    net.fit(NativeBatchDataSetIterator(DataSet(x, y), 16, seed=21))
    assert net.iteration == jnet.iteration == 3
    np.testing.assert_allclose(net.score_value, jnet.score_value,
                               rtol=RTOL, atol=ATOL)
    for lname, sub in jax.device_get(jnet.params).items():
        for k, v in sub.items():
            np.testing.assert_allclose(net.params[lname][k].numpy(), v,
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"{lname}/{k}")
    ours = [t.numpy() for t in tree_leaves(net.updater_state)]
    theirs = [np.asarray(t) for t in jax.tree_util.tree_leaves(
        jax.device_get(jnet.updater_state))]
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def test_list_iterator_hands_its_dataset_on():
    x = np.arange(12, dtype=np.float32).reshape(6, 2)
    it = ListDataSetIterator(DataSet(x, x), 4)
    assert it.dataset().features is x
    ours = NativeBatchDataSetIterator(it.dataset(), 4, shuffle=False)
    _batches_equal(ours, JNativeIt(JDataSet(x, x), 4, shuffle=False))
    assert len(list(JList(JDataSet(x, x), 4))) == 2
