"""Viterbi decoding and the torch interop (``deeplearning4j_tpu_torch/utils``)
against the JAX package's: the path and the score equal the reference's
bit for bit (the recursion adds and takes maxima in float32, operations
that are exact, and both argmaxes take the first maximum), the captured
chunks' schedule equal to the eager loop (the card's calls emulated),
the reference's cases (``tests/test_mixed_precision.py:111-125``,
``tests/test_provision_interop.py``) through the port, and the
package's exports."""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import utils as ju
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu_torch import utils as tu
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.utils import viterbi as tviterbi


def _hmm(T, S, seed, ties=False):
    """Log emissions and a log transition matrix; with ``ties``, values
    on a coarse grid so that scores tie often."""
    rs = np.random.RandomState(seed)
    if ties:
        em = -rs.randint(0, 4, (T, S)).astype(np.float32)
        tr = -rs.randint(0, 3, (S, S)).astype(np.float32)
        return em, tr
    em = np.log(rs.dirichlet(np.ones(S), T)).astype(np.float32)
    tr = np.log(rs.dirichlet(np.ones(S) * 0.5, S)).astype(np.float32)
    return em, tr


@pytest.mark.parametrize("T,S,seed,ties", [
    (1, 3, 0, False), (2, 2, 1, False), (50, 4, 2, False), (300, 16, 3, False),
    (200, 5, 4, True), (64, 2, 5, True)])
def test_viterbi_decode_equals_the_reference(T, S, seed, ties):
    em, tr = _hmm(T, S, seed, ties)
    jp, js = ju.viterbi_decode(em, tr)
    tp, ts = tu.viterbi_decode(em, tr, device="cpu")
    assert tp.dtype == jp.dtype and np.array_equal(tp, jp)
    assert ts == js


def test_viterbi_facade_equals_the_reference():
    rs = np.random.RandomState(6)
    truth = np.repeat(rs.randint(0, 3, 40), rs.randint(3, 15, 40))
    flicker = rs.rand(len(truth)) < 0.1
    obs = np.where(flicker, rs.randint(0, 3, len(truth)), truth)
    for stab, p in ((0.95, 0.9), (0.6, 0.99)):
        jl, js = ju.Viterbi(["a", "b", "c"], stab, p).decode(
            np.array(["a", "b", "c"])[obs])
        tl, ts = tu.Viterbi(["a", "b", "c"], stab, p, device="cpu").decode(
            np.array(["a", "b", "c"])[obs])
        assert tl.tolist() == jl.tolist() and ts == js


def test_viterbi_decode_prefers_transitions():
    em = np.log(np.array([[0.9, 0.1], [0.45, 0.55], [0.9, 0.1]], np.float32))
    tr = np.log(np.array([[0.95, 0.05], [0.05, 0.95]], np.float32))
    path, score = tu.viterbi_decode(em, tr, device="cpu")
    assert path.tolist() == [0, 0, 0]
    assert np.isfinite(score)


def test_viterbi_facade_smooths_flicker():
    v = tu.Viterbi([0, 1], meta_stability=0.95, p_correct=0.9, device="cpu")
    smoothed, _ = v.decode([0, 0, 1, 0, 0, 0])
    assert smoothed.tolist() == [0, 0, 0, 0, 0, 0]
    smoothed2, _ = v.decode([0, 0, 1, 1, 1, 1])
    assert smoothed2.tolist()[-3:] == [1, 1, 1]


def test_viterbi_rejects_bad_shapes_and_labels():
    with pytest.raises(ValueError, match="transition matrix"):
        tu.viterbi_decode(np.zeros((4, 3)), np.zeros((2, 2)), device="cpu")
    with pytest.raises(ValueError, match=">= 2 possible labels"):
        tu.Viterbi([0], device="cpu")


@pytest.mark.parametrize("T", [2, 9, 17, 40])
def test_captured_chunks_equal_the_eager_loop(monkeypatch, T):
    """The card's chunked schedule on the CPU (a chunk of 8 steps; the
    warm-up runs the first chunk, a capture records without running, a
    replay reruns): the same final scores and back-pointers as the eager
    loop, and one capture with a replay a whole chunk after the first."""
    em, tr = (torch.as_tensor(a) for a in _hmm(T, 6, T, ties=True))

    class Recorded:
        def __init__(self, fn):
            self.fn = fn

        def replay(self):
            self.fn()

    eager = tviterbi._forward(em, tr, capture=False)
    monkeypatch.setattr(tviterbi, "CHUNK", 8)
    monkeypatch.setattr(tviterbi, "warm_on_side_stream",
                        lambda fn, device: fn())
    monkeypatch.setattr(tviterbi, "capture_graph",
                        lambda fn, pool=None: (Recorded(fn), None))
    monkeypatch.setattr(tviterbi, "counts", {"captures": 0, "replays": 0})
    cap = tviterbi._forward(em, tr, capture=True)
    assert torch.equal(cap[0], eager[0]) and torch.equal(cap[1], eager[1])
    chunks = (T - 1) // 8
    assert tviterbi.counts == {"captures": int(chunks > 0),
                               "replays": max(chunks - 1, 0)}


@pytest.mark.skipif(torch.cuda.is_available(), reason="a GPU is present")
def test_viterbi_raises_without_a_gpu():
    em, tr = _hmm(5, 2, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tu.viterbi_decode(em, tr)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tu.Viterbi([0, 1])


# ------------------------------------------------------------------ interop

def test_torch_interop_roundtrip():
    x = np.random.RandomState(0).randn(5, 3).astype(np.float32)
    t = tu.to_torch(x)
    assert isinstance(t, torch.Tensor) and t.shape == (5, 3)
    np.testing.assert_array_equal(tu.from_torch(t), x)
    t[0, 0] = 42.0                      # shares memory with the array
    assert x[0, 0] == 42.0
    ds = DataSet(x, np.eye(3, dtype=np.float32)[[0, 1, 2, 0, 1]])
    back = tu.dataset_from_torch(tu.dataset_to_torch(ds))
    np.testing.assert_array_equal(back.features, ds.features)
    np.testing.assert_array_equal(back.labels, ds.labels)


def test_labeled_points_roundtrip():
    pts = [([1.0, 2.0], 0), ([3.0, 4.0], 2), ([5.0, 6.0], 1)]
    ds = tu.labeled_points_to_dataset(pts, num_classes=3)
    assert ds.labels.shape == (3, 3)
    back = tu.dataset_to_labeled_points(ds)
    assert [c for _, c in back] == [0, 2, 1]
    np.testing.assert_array_equal(back[1][0], [3.0, 4.0])


def test_interop_equals_the_reference():
    rs = np.random.RandomState(1)
    feats = rs.randn(6, 4).astype(np.float64)
    labels = np.eye(3)[rs.randint(0, 3, 6)]
    j = ju.dataset_from_torch(ju.dataset_to_torch(JDataSet(feats, labels)))
    t = tu.dataset_from_torch(tu.dataset_to_torch(DataSet(feats, labels)))
    for a, b in ((j.features, t.features), (j.labels, t.labels)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    pts = [(rs.randn(4), int(c)) for c in rs.randint(0, 5, 7)]
    j = ju.labeled_points_to_dataset(pts, 5)
    t = tu.labeled_points_to_dataset(pts, 5)
    assert np.array_equal(j.features, t.features)
    assert np.array_equal(j.labels, t.labels)
    assert [c for _, c in ju.dataset_to_labeled_points(j)] == \
        [c for _, c in tu.dataset_to_labeled_points(t)]


def test_the_exports_are_the_reference_s():
    import deeplearning4j_tpu.utils as jmod

    names = {n for n in vars(jmod) if not n.startswith("_")
             and callable(getattr(jmod, n))}
    assert names <= {n for n in vars(tu) if not n.startswith("_")}
    assert tu.sample_sequence.__module__ == \
        "deeplearning4j_tpu_torch.utils.sampling"
