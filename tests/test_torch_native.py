"""The port's native runtime core (``deeplearning4j_tpu_torch/native``)
against the JAX package's (``deeplearning4j_tpu/native``) on the same
numpy inputs, on the CPU with the port's library built by g++.

Exact throughout: CSV matrices, IDX images and labels, gathered rows and
batch orders are equal array for array (``np.array_equal``), and a
``D4JT`` file either package writes is byte-equal to the other's.  Each
of the port's native entry points is also held against its own
``force_python`` plain version.
"""

import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from deeplearning4j_tpu import native as jnative
from deeplearning4j_tpu.datasets import DataSet as JDataSet
from deeplearning4j_tpu.datasets import (
    NativeBatchDataSetIterator as JNativeIt,
)
from deeplearning4j_tpu_torch import native
from deeplearning4j_tpu_torch.datasets import (
    DataSet, NativeBatchDataSetIterator,
)
from deeplearning4j_tpu_torch.native import loader

REPO = Path(__file__).resolve().parent.parent


def _equal(a, b):
    return (a is None and b is None) or (
        a is not None and b is not None and a.dtype == b.dtype
        and a.shape == b.shape and np.array_equal(a, b))


# ------------------------------------------------------------------- CSV
CSV_CASES = {
    "header": (b"a,b,c\n1.5,2,3\n-4,5e-1,6\n7,8,9.25\n", ",", 1),
    "blank_lines_crlf": (b"1,2\r\n\r\n3,4\r\n  \n5,6", ",", 0),
    "spaces_and_signs": (b" 1.25 , -2 ,+3e2\n4,-0.0,1e-7\n", ",", 0),
    "semicolon": (b"x;y\nskip;me\n0.1;0.2\n0.3;0.4\n", ";", 2),
    "wide": (b"\n".join(b",".join(str(v).encode() for v in
                                  np.random.RandomState(0).randn(64))
                        for _ in range(9)), ",", 0),
}


@pytest.mark.parametrize("name", sorted(CSV_CASES))
def test_csv_matrix_equals_the_references(name):
    data, delim, skip = CSV_CASES[name]
    got = native.csv_to_matrix(data, delim, skip)
    assert got.dtype == np.float32 and got.ndim == 2
    for other in (native.csv_to_matrix(data, delim, skip, force_python=True),
                  jnative.csv_to_matrix(data, delim, skip),
                  jnative.csv_to_matrix(data, delim, skip, force_python=True)):
        assert _equal(got, other), name


@pytest.mark.parametrize("data", [b"1,2\n3,x\n", b"1,2\n3,4,5\n",
                                  b"1,2,3\n4,5\n", b"1.5abc,2\n"],
                         ids=["nonnumeric", "more_fields", "fewer_fields",
                              "trailing_text"])
def test_csv_refusal_raises_without_a_plain_reparse(data, monkeypatch):
    """The reference re-parses a refused buffer in Python; the port's
    native parser raises and runs no plain version."""
    def plain(*a, **k):
        raise AssertionError("the plain version ran")

    monkeypatch.setattr(native, "_csv_plain", plain)
    with pytest.raises(ValueError, match="non-numeric or ragged"):
        native.csv_to_matrix(data)
    with pytest.raises(ValueError):
        jnative.csv_to_matrix(data)


# ------------------------------------------------------------------- IDX
def _idx3(imgs):
    n, r, c = imgs.shape
    return struct.pack(">IIII", 0x803, n, r, c) + imgs.tobytes()


def _idx1(labels):
    return struct.pack(">II", 0x801, len(labels)) + bytes(labels)


@pytest.mark.parametrize("seed, shape", [(0, (4, 8, 8)), (1, (37, 28, 28)),
                                         (2, (3, 1, 5))])
def test_idx_images_equal_the_references(seed, shape):
    imgs = np.random.RandomState(seed).randint(0, 256, shape).astype(np.uint8)
    data = _idx3(imgs)
    got = native.parse_idx_images(data)
    assert got.shape == (shape[0], shape[1] * shape[2])
    assert _equal(got, native.parse_idx_images(data, force_python=True))
    assert _equal(got, jnative.parse_idx_images(data, force_python=True))
    # the reference's MNIST fetcher decodes with numpy the same way
    assert _equal(got, (imgs.astype(np.float32) / 255.0).reshape(
        shape[0], -1))


def test_reference_native_idx_scale_is_one_ulp_off():
    """Every byte value: the reference's native parse multiplies by
    1.0f / 255.0f and differs from its own Python version (a division) in
    126 of 256 values by one ulp; the port's native parse divides and
    equals both its plain version and the reference's."""
    data = _idx3(np.arange(256, dtype=np.uint8).reshape(1, 16, 16))
    ours = native.parse_idx_images(data)
    plain = jnative.parse_idx_images(data, force_python=True)
    theirs = jnative.parse_idx_images(data)
    assert _equal(ours, plain)
    off = theirs != plain
    assert int(off.sum()) == 126
    assert np.all(np.abs(theirs.view(np.int32) - plain.view(np.int32))
                  [off] == 1)


@pytest.mark.parametrize("n_classes", [10, 4])
def test_idx_labels_equal_the_references(n_classes):
    labels = [1, 0, 9, 5, 3, 3, 7]        # 9, 5 and 7 out of range at 4
    data = _idx1(labels)
    got = native.parse_idx_labels(data, n_classes)
    assert got.shape == (len(labels), n_classes)
    for other in (native.parse_idx_labels(data, n_classes, force_python=True),
                  jnative.parse_idx_labels(data, n_classes),
                  jnative.parse_idx_labels(data, n_classes,
                                           force_python=True)):
        assert _equal(got, other)
    assert got.sum() == sum(v < n_classes for v in labels)


def test_truncated_idx_raises(monkeypatch):
    monkeypatch.setattr(native, "_idx_images_plain", lambda *a: 1 / 0)
    monkeypatch.setattr(native, "_idx_labels_plain", lambda *a: 1 / 0)
    imgs = _idx3(np.zeros((4, 3, 3), np.uint8))
    with pytest.raises(ValueError, match="fewer than the 4 images"):
        native.parse_idx_images(imgs[:-1])
    with pytest.raises(ValueError, match="fewer than the 3 labels"):
        native.parse_idx_labels(_idx1([1, 2, 3])[:-1])
    with pytest.raises(ValueError, match="magic"):
        native.parse_idx_images(_idx1([1]) + bytes(8))


# ---------------------------------------------------------------- gather
@pytest.mark.parametrize("seed", [0, 1])
def test_gather_rows_equals_the_references(seed):
    rs = np.random.RandomState(seed)
    src = rs.randn(50, 13).astype(np.float32)
    idx = rs.randint(0, 50, 300)
    got = native.gather_rows(src, idx)
    for other in (native.gather_rows(src, idx, force_python=True),
                  jnative.gather_rows(src, idx), src[idx]):
        assert _equal(got, other)
    with pytest.raises(IndexError):
        native.gather_rows(src, np.array([50]))


# -------------------------------------------------------------- batching
def _drain(b):
    out = []
    while True:
        got = b.next()
        if got is None:
            return out
        out.append(got)


@pytest.mark.parametrize("seed", [0, 1, 9, 123456789])
@pytest.mark.parametrize("drop_last", [False, True], ids=["pad", "drop"])
@pytest.mark.parametrize("shuffle", [True, False], ids=["shuffle", "order"])
def test_batch_orders_equal_in_both_packages(seed, drop_last, shuffle):
    """Four batchers over 103 rows in batches of 16 (the native and plain
    ones of each package) give the same batches in the same order, for
    the first permutation and after a reset to another seed; a short
    final batch is zero-padded past its valid rows."""
    rs = np.random.RandomState(seed % 1000)
    f = rs.randn(103, 3, 2).astype(np.float32)
    l = np.eye(5, dtype=np.float32)[rs.randint(0, 5, 103)]
    kw = dict(shuffle=shuffle, seed=seed, drop_last=drop_last)
    batchers = [native.Batcher(f, l, 16, **kw),
                native.Batcher(f, l, 16, force_python=True, **kw),
                jnative.Batcher(f, l, 16, **kw),
                jnative.Batcher(f, l, 16, force_python=True, **kw)]
    for reseed in (None, seed + 17):
        if reseed is not None:
            for b in batchers:
                b.reset(reseed)
        runs = [_drain(b) for b in batchers]
        assert len(runs[0]) == (6 if drop_last else 7)
        for run in runs[1:]:
            assert len(run) == len(runs[0])
            for (fa, la, na), (fb, lb, nb) in zip(runs[0], run):
                assert na == nb and _equal(fa, fb) and _equal(la, lb)
        last_f, last_l, nv = runs[0][-1]
        assert last_f.shape == (16, 3, 2)
        if not drop_last:
            assert nv == 103 - 96
            assert not last_f[nv:].any() and not last_l[nv:].any()
        rows = np.concatenate([b[0][:b[2]] for b in runs[0]]).reshape(-1, 6)
        flat = f.reshape(103, 6)
        assert len(rows) == (96 if drop_last else 103)
        if not shuffle:
            assert _equal(rows, flat[:len(rows)])
        elif not drop_last:
            assert sorted(map(tuple, rows)) == sorted(map(tuple, flat))
    for b in batchers:
        b.close()


@pytest.mark.parametrize("force_python", [False, True],
                         ids=["native", "plain"])
def test_native_iterator_equals_the_reference(force_python):
    """Two epochs of ``NativeBatchDataSetIterator`` (each ``reset`` a new
    permutation) against the JAX iterator's: the same features, labels
    and labels masks; the padded final batch's mask marks its 5 rows."""
    rs = np.random.RandomState(4)
    x = rs.rand(37, 6).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, 37)]
    ours = NativeBatchDataSetIterator(DataSet(x, y), 8, seed=11,
                                      force_python=force_python)
    theirs = JNativeIt(JDataSet(x, y), 8, seed=11)
    epochs = []
    for _ in range(2):
        a, b = list(ours), list(theirs)
        assert len(a) == len(b) == 5
        for da, db in zip(a, b):
            assert _equal(da.features, db.features)
            assert _equal(da.labels, db.labels)
            assert _equal(da.labels_mask, db.labels_mask)
            assert da.features_mask is None
        assert a[-1].labels_mask.tolist() == [1.0] * 5 + [0.0] * 3
        assert all(d.labels_mask is None for d in a[:-1])
        epochs.append(np.concatenate([d.features for d in a]))
    assert not np.array_equal(epochs[0], epochs[1])
    ours.close()
    theirs.close()


def test_batcher_refuses_labels_of_another_length():
    """The producer gathers label rows by the features' permutation, so a
    shorter label array would be read past its end: both versions refuse
    it."""
    for force_python in (False, True):
        with pytest.raises(ValueError, match="9 label rows for 10"):
            native.Batcher(np.zeros((10, 2), np.float32),
                           np.zeros((9, 1), np.float32), 4,
                           force_python=force_python)


def test_native_iterator_refuses_masked_data():
    x = np.zeros((4, 2), np.float32)
    with pytest.raises(ValueError, match="masked"):
        NativeBatchDataSetIterator(
            DataSet(x, x, None, np.ones(4, np.float32)), 2)


# ---------------------------------------------------------- D4JT files
@pytest.mark.parametrize("with_labels", [True, False],
                         ids=["labels", "no_labels"])
def test_d4jt_files_are_byte_equal_and_read_in_both(tmp_path, with_labels):
    rs = np.random.RandomState(5)
    x = rs.randn(9, 4, 3).astype(np.float32)
    y = rs.rand(9, 2).astype(np.float32) if with_labels else None
    paths = {"port": tmp_path / "port.bin",
             "port_plain": tmp_path / "port_plain.bin",
             "jax": tmp_path / "jax.bin"}
    native.write_dataset(paths["port"], x, y)
    native.write_dataset(paths["port_plain"], x, y, force_python=True)
    jnative.write_dataset(paths["jax"], x, y)
    blobs = {k: p.read_bytes() for k, p in paths.items()}
    assert blobs["port"] == blobs["port_plain"] == blobs["jax"]
    assert len(blobs["port"]) == 32 + 4 * 9 * (12 + (2 if y is not None
                                                       else 0))
    for p in paths.values():
        assert native.dataset_header(p) == jnative.dataset_header(p) == \
            (9, 12, 2 if y is not None else 0)
        reads = [native.read_dataset(p),
                 native.read_dataset(p, force_python=True),
                 jnative.read_dataset(p)]
        for feat, lab in reads:
            assert _equal(feat, x.reshape(9, 12))
            assert _equal(lab, y)


def test_truncated_d4jt_raises(tmp_path):
    p = tmp_path / "t.bin"
    native.write_dataset(p, np.ones((4, 3), np.float32))
    p.write_bytes(p.read_bytes()[:-4])
    with pytest.raises(ValueError, match="truncated"):
        native.read_dataset(p)
    with pytest.raises(ValueError, match="truncated"):
        native.read_dataset(p, force_python=True)
    (tmp_path / "bad.bin").write_bytes(b"XXXX" + bytes(28))
    with pytest.raises(ValueError, match="magic"):
        native.read_dataset(tmp_path / "bad.bin")


# ----------------------------------------------------------------- build
def test_library_is_built_from_the_ports_own_source():
    built = native.build()
    assert built.path.parent == loader.BUILD_DIR
    assert loader.SOURCE == (REPO / "deeplearning4j_tpu_torch" / "native"
                             / "src" / "dl4j_tpu_native.cpp")
    assert loader.build_digest() in built.path.name
    assert built.lib.dl4j_native_abi_version() == loader.ABI_VERSION
    ignored = (REPO / ".gitignore").read_text().split()
    assert "deeplearning4j_tpu_torch/native/_build/" in ignored


@pytest.mark.parametrize("compiler", ["missing", "failing"])
def test_build_failure_raises_and_runs_no_plain_version(
        compiler, tmp_path, monkeypatch):
    """A compiler that does not exist, or one that fails, raises with its
    message; the entry points raise with it and no plain version runs."""
    if compiler == "missing":
        cxx = str(tmp_path / "no-such-g++")
        want = "could not run"
    else:
        cxx = tmp_path / "bad-g++"
        cxx.write_text("#!/bin/sh\necho 'fatal: no headers here' >&2\n"
                       "exit 3\n")
        cxx.chmod(0o755)
        cxx, want = str(cxx), "fatal: no headers here"
    monkeypatch.setenv("CXX", cxx)
    monkeypatch.setattr(loader, "BUILD_DIR", tmp_path / "build")
    for name in ("_csv_plain", "_idx_images_plain", "_idx_labels_plain"):
        monkeypatch.setattr(native, name, lambda *a: 1 / 0)
    with pytest.raises(RuntimeError, match=want):
        native.csv_to_matrix(b"1,2\n")
    with pytest.raises(RuntimeError, match=want):
        native.Batcher(np.zeros((4, 2), np.float32), None, 2)
    with pytest.raises(RuntimeError, match=want):
        NativeBatchDataSetIterator(
            DataSet(np.zeros((4, 2), np.float32),
                    np.zeros((4, 1), np.float32)), 2)
    assert not any((tmp_path / "build").glob("*.so"))


def test_concurrent_builds_agree_on_one_library(tmp_path):
    """Six processes build into one empty directory at once (as six test
    workers or fleet replicas do): all load, one library remains, no
    temporary file is left."""
    code = (
        "import sys\n"
        "from pathlib import Path\n"
        "from deeplearning4j_tpu_torch.native import loader as m\n"
        "m.BUILD_DIR = Path(sys.argv[1])\n"
        "b = m.build()\n"
        "assert b.lib.dl4j_native_abi_version() == 1\n"
        "print(b.path.name)\n")
    procs = [subprocess.Popen([sys.executable, "-c", code,
                               str(tmp_path / "build")],
                              cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(6)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0] * 6, outs
    names = {o.strip() for o, _ in outs}
    assert len(names) == 1
    assert sorted(x.name for x in (tmp_path / "build").iterdir()) == \
        sorted(names)
