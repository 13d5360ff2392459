"""The NLP stack's fits, queries and files (``deeplearning4j_tpu_torch/nlp``)
against the JAX package's, on the reference tests' corpora and Builder
settings (``tests/test_nlp.py``, ``tests/test_glove_streaming.py``).

Whole fits from one seed: the vocabulary, the Huffman tables, the seeded
initial weights and the host's pair stream are the same in both
packages, so the hierarchical-softmax fits' ``syn0`` must agree to
rounding.  JAX's negative-sampling draws cannot be reproduced in torch:
the negative-sampling, ParagraphVectors and ``infer_vector`` cases feed
both packages the same negatives from one numpy stream (the JAX class's
``sample_negatives`` replaced in the test only, the port's through its
seam).  GloVe's batch permutation comes from the same ``RandomState``
in both.  The port runs on the CPU; its captured path runs here with
the card's calls emulated."""

import json
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import nlp as jnlp
from deeplearning4j_tpu.nlp import lookup as jlookup
from deeplearning4j_tpu_torch import nlp as tnlp
from deeplearning4j_tpu_torch.models import capture
from deeplearning4j_tpu_torch.models.common import tree_leaves
from deeplearning4j_tpu_torch.nlp import learning, lookup as tlookup
from deeplearning4j_tpu_torch.nlp.serializer import lookup_from_numpy

from tests.test_glove_streaming import _cluster_purity
from tests.test_glove_streaming import synthetic_corpus as two_topic_corpus
from tests.test_nlp import synthetic_corpus
from tests.test_torch_tbptt import _ReplayGraph

ATOL = 1e-5
WEATHER = ["rain", "snow", "storm", "cloud", "wind", "sun"]
FINANCE = ["bank", "money", "stock", "market", "trade", "price"]


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def w2v(pkg, sentences, hs=True, negative=0, algo="skipgram", epochs=3,
        seed=1, **extra):
    """``tests/test_nlp.py::fit_w2v``'s Builder (three epochs: both sides
    run the same schedule and are compared to each other)."""
    b = (pkg.Word2Vec.Builder()
         .iterate(sentences)
         .layer_size(32)
         .window_size(3)
         .min_word_frequency(2)
         .use_hierarchic_softmax(hs)
         .negative_sample(negative)
         .elements_learning_algorithm(algo)
         .learning_rate(0.2)
         .epochs(epochs)
         .seed(seed)
         .batch_size(64))
    for k, v in extra.items():
        getattr(b, k)(v)
    if pkg is tnlp:
        b.device("cpu")
    return b.build()


@pytest.fixture
def same_negatives(monkeypatch):
    """Both packages draw their negatives from one numpy stream each, with
    the same seed: the JAX class's ``sample_negatives`` replaced here, the
    port's seam likewise."""
    rj, rt = np.random.RandomState(0), np.random.RandomState(0)

    def jax_draw(self, key, shape):
        return jnp.asarray(rj.randint(0, len(self.cache), shape)
                           .astype(np.int32))

    def port_draw(self, key, shape):
        return torch.as_tensor(rt.randint(0, len(self.cache), shape)
                               .astype(np.int32)).to(self.device)

    monkeypatch.setattr(jlookup.InMemoryLookupTable, "sample_negatives",
                        jax_draw)
    monkeypatch.setattr(tlookup.InMemoryLookupTable, "sample_negatives",
                        port_draw)


def _same_model(j, t, names=("syn0", "syn1", "syn1neg")):
    assert j.vocab.words() == t.vocab.words()
    for n in names:
        a, b = getattr(j.lookup, n), getattr(t.lookup, n)
        assert (a is None) == (b is None), n
        if a is not None:
            np.testing.assert_allclose(_np(b), np.asarray(a), atol=ATOL,
                                       rtol=0, err_msg=n)
    np.testing.assert_allclose(t.cum_loss, j.cum_loss, rtol=1e-5)


# --------------------------------------------------------------- the fits

@pytest.mark.parametrize("algo", ["skipgram", "cbow"])
def test_hierarchical_softmax_fit_matches_jax(algo):
    sentences = synthetic_corpus(60)
    j = w2v(jnlp, sentences, algo=algo).fit()
    t = w2v(tnlp, sentences, algo=algo).fit()
    _same_model(j, t)
    words = j.vocab.words()
    assert [t.vocab.word_for(w).codes for w in words] == \
        [j.vocab.word_for(w).codes for w in words]


@pytest.mark.parametrize("algo", ["skipgram", "cbow"])
def test_negative_sampling_fit_matches_jax(same_negatives, algo):
    sentences = synthetic_corpus(60)
    j = w2v(jnlp, sentences, hs=False, negative=5, algo=algo).fit()
    t = w2v(tnlp, sentences, hs=False, negative=5, algo=algo).fit()
    _same_model(j, t)


def test_subsampling_and_both_objectives_match_jax(same_negatives):
    """Subsampling draws from the host's RandomState (draw for draw) and a
    batch runs the negative-sampling step, then the hierarchical one."""
    sentences = synthetic_corpus(80)
    kw = dict(negative=3, sampling=2e-2, iterations=2, window_size=2)
    j = w2v(jnlp, sentences, **kw).fit()
    t = w2v(tnlp, sentences, **kw).fit()
    _same_model(j, t)


def test_a_sequence_shorter_than_the_window_gives_its_pairs():
    """The reference's ``_window_pairs`` indexes past the end for a
    sequence shorter than a drawn window (``m[:n - s]`` with n < s wraps
    round: ROADMAP C2); the port takes no pair there and keeps every
    other draw."""
    t = w2v(tnlp, ["a b"], window_size=5, min_word_frequency=1)
    j = w2v(jnlp, ["a b"], window_size=5, min_word_frequency=1)
    t._rs, j._rs = np.random.RandomState(4), np.random.RandomState(4)
    idx = np.array([7, 9], np.int32)
    with pytest.raises(IndexError):
        j._window_pairs(idx)
    pairs, _ = t._window_pairs(idx)
    assert sorted(map(tuple, pairs.tolist())) == [(7, 9), (9, 7)]


def _documents(pkg):
    rs = np.random.RandomState(11)
    docs = []
    for i in range(40):
        topic, tag = (WEATHER, "W") if i % 2 == 0 else (FINANCE, "F")
        docs.append(pkg.LabelledDocument(content=" ".join(rs.choice(topic, 8)),
                                         labels=[f"{tag}_{i}"]))
    return docs


def pv(pkg, seq_algo="dbow", hs=True, negative=0, elements=None):
    """``tests/test_nlp.py::test_paragraph_vectors_labels_cluster``'s
    Builder, four epochs."""
    b = (pkg.ParagraphVectors.Builder()
         .iterate(_documents(pkg))
         .layer_size(24)
         .window_size(3)
         .min_word_frequency(1)
         .use_hierarchic_softmax(hs)
         .negative_sample(negative)
         .learning_rate(0.2)
         .epochs(4)
         .seed(5)
         .batch_size(64)
         .sequence_learning_algorithm(seq_algo))
    if pkg is tnlp:
        b.device("cpu")
    model = b.build()
    if elements is not None:
        model.config.elements_algorithm = elements
    return model


@pytest.mark.parametrize("seq_algo,hs,negative,elements", [
    ("dbow", True, 0, None), ("dm", True, 0, None), ("dbow", False, 4, None),
    ("dm", True, 2, "cbow")])
def test_paragraph_vectors_match_jax(same_negatives, seq_algo, hs, negative,
                                     elements):
    j = pv(jnlp, seq_algo, hs, negative, elements).fit()
    t = pv(tnlp, seq_algo, hs, negative, elements).fit()
    _same_model(j, t)
    assert t.labels_source.labels == j.labels_source.labels
    text = "rain snow storm wind cloud sun rain storm"
    np.testing.assert_allclose(t.infer_vector(text), j.infer_vector(text),
                               atol=ATOL, rtol=0)
    assert t.predict(text) == j.predict(text)
    assert t.predict("bank money stock trade") == \
        j.predict("bank money stock trade")
    assert t.infer_vector("zzz qqq").shape == (24,)


@pytest.mark.parametrize("spill", [None, 64])
def test_glove_fit_matches_jax(spill):
    """``test_glove_streaming.py``'s settings, in RAM and spilled
    (``max_memory_pairs(64)``: the out-of-core merge feeds the batches)."""
    def glove(pkg):
        b = (pkg.Glove.Builder().iterate(two_topic_corpus(200))
             .layer_size(24).window_size(4).epochs(3).learning_rate(0.1)
             .min_word_frequency(2).seed(3))
        if spill:
            b.max_memory_pairs(spill)
        if pkg is tnlp:
            b.device("cpu")
        return b.build().fit()

    j, t = glove(jnlp), glove(tnlp)
    _same_model(j, t, names=("syn0",))


# ---------------------------------------------------------------- queries

def test_words_nearest_matches_jax():
    """On the JAX model's weights carried into the port: every word's
    neighbours, a query with a negative word, a raw vector, and rows tied
    in similarity (equal rows: the lower index first, as
    ``jax.lax.top_k``)."""
    j = w2v(jnlp, synthetic_corpus(60)).fit()
    syn0 = np.asarray(j.lookup.syn0).copy()
    syn0[5] = syn0[2]
    syn0[9] = syn0[2]
    j.lookup.syn0 = jnp.asarray(syn0)
    t = tnlp.StaticWord2Vec(j.vocab, lookup_from_numpy(j.vocab, syn0,
                                                       device="cpu"))
    for w in j.vocab.words():
        assert t.words_nearest(w, top_n=5) == j.words_nearest(w, top_n=5)
    assert t.words_nearest(["rain", "snow"], ["bank"], top_n=4) == \
        j.words_nearest(["rain", "snow"], ["bank"], top_n=4)
    assert t.words_nearest(syn0[2], top_n=4) == j.words_nearest(syn0[2],
                                                                top_n=4)
    top = t.words_nearest(syn0[2], top_n=3)
    labels = [j.vocab.element_at_index(i).label for i in (2, 5, 9)]
    assert top == labels
    assert t.similar_words_in_vocab_to("rain", 0.2) == \
        j.similar_words_in_vocab_to("rain", 0.2)
    np.testing.assert_allclose(t.similarity("rain", "snow"),
                               j.similarity("rain", "snow"), rtol=1e-6)


def test_quality_protocol_on_the_port():
    """``test_glove_streaming.py::test_embedding_quality_metric`` on the
    port: wordsNearest top-3 cluster purity above 0.8 for both."""
    corpus = two_topic_corpus(400)
    w = (tnlp.Word2Vec.Builder().iterate(corpus).layer_size(24)
         .window_size(4).epochs(8).min_word_frequency(2).seed(5)
         .device("cpu").build().fit())
    g = (tnlp.Glove.Builder().iterate(corpus).layer_size(24).window_size(4)
         .epochs(12).learning_rate(0.1).min_word_frequency(2).seed(3)
         .max_memory_pairs(64).device("cpu").build().fit())
    assert _cluster_purity(w, [WEATHER, FINANCE]) > 0.8
    assert _cluster_purity(g, [WEATHER, FINANCE]) > 0.8


# ------------------------------------------------------------------ files

def _pair_models():
    """The JAX model and the port's holding the same vectors."""
    j = w2v(jnlp, synthetic_corpus(60)).fit()
    t = w2v(tnlp, synthetic_corpus(60))
    t.vocab = j.vocab
    t.lookup = lookup_from_numpy(j.vocab, np.asarray(j.lookup.syn0),
                                 np.asarray(j.lookup.syn1), device="cpu")
    t.lookup.negative = j.lookup.negative
    return j, t


@pytest.mark.parametrize("fmt", ["text", "binary"])
def test_vector_files_are_byte_equal_and_read_across(tmp_path, fmt):
    write, read = {"text": ("write_word_vectors", "read_word_vectors"),
                   "binary": ("write_binary", "read_binary")}[fmt]
    j, t = _pair_models()
    pj, pt = tmp_path / "jax.vec", tmp_path / "port.vec"
    getattr(jnlp.WordVectorSerializer, write)(j, str(pj))
    getattr(tnlp.WordVectorSerializer, write)(t, str(pt))
    assert pj.read_bytes() == pt.read_bytes()
    from_jax = getattr(tnlp.WordVectorSerializer, read)(str(pj), device="cpu")
    from_port = getattr(jnlp.WordVectorSerializer, read)(str(pt))
    assert from_jax.vocab.words() == from_port.vocab.words() == \
        j.vocab.words()
    np.testing.assert_array_equal(_np(from_jax.lookup.syn0),
                                  np.asarray(from_port.lookup.syn0))
    assert from_jax.words_nearest("rain", top_n=3) == \
        from_port.words_nearest("rain", top_n=3)


def test_full_model_zip_crosses_both_ways(tmp_path):
    j, t = _pair_models()
    pj, pt = str(tmp_path / "jax.zip"), str(tmp_path / "port.zip")
    jnlp.WordVectorSerializer.write_full_model(j, pj)
    tnlp.WordVectorSerializer.write_full_model(t, pt)
    with zipfile.ZipFile(pj) as a, zipfile.ZipFile(pt) as b:
        assert sorted(a.namelist()) == sorted(b.namelist())
        for name in a.namelist():
            assert a.read(name) == b.read(name), name
    port_read = tnlp.WordVectorSerializer.read_full_model(pj, device="cpu")
    jax_read = jnlp.WordVectorSerializer.read_full_model(pt)
    for n in ("syn0", "syn1"):
        np.testing.assert_array_equal(_np(getattr(port_read.lookup, n)),
                                      np.asarray(getattr(j.lookup, n)))
        np.testing.assert_array_equal(np.asarray(getattr(jax_read.lookup, n)),
                                      np.asarray(getattr(j.lookup, n)))
    assert port_read.lookup.syn1neg is None and jax_read.lookup.syn1neg is None
    w = port_read.vocab.word_for("rain")
    assert w.codes == j.vocab.word_for("rain").codes
    assert json.loads(zipfile.ZipFile(pt).read("config.json"))["config"][
        "window"] == 3


def test_a_trained_port_model_is_read_by_jax(tmp_path):
    t = w2v(tnlp, synthetic_corpus(60), hs=False, negative=3).fit()
    p = str(tmp_path / "m.zip")
    tnlp.WordVectorSerializer.write_full_model(t, p)
    back = jnlp.WordVectorSerializer.read_full_model(p)
    np.testing.assert_array_equal(np.asarray(back.lookup.syn1neg),
                                  _np(t.lookup.syn1neg))
    assert back.words_nearest("rain", top_n=4) == t.words_nearest("rain",
                                                                  top_n=4)


# ----------------------------------------------------- device and capture

@pytest.mark.skipif(torch.cuda.is_available(), reason="a GPU is present")
def test_entry_points_raise_without_a_gpu(tmp_path):
    sentences = synthetic_corpus(20)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tnlp.Word2Vec.Builder().iterate(sentences).build()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tnlp.ParagraphVectors.Builder().iterate(_documents(tnlp)).build()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tnlp.Glove.Builder().iterate(sentences).build()
    from deeplearning4j_tpu_torch.nlp.distributed import (
        DistributedGlove, DistributedWord2Vec,
    )
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DistributedWord2Vec.Builder().iterate(sentences).build()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DistributedGlove.Builder().iterate(sentences).build()
    j = w2v(jnlp, sentences).fit()
    p = str(tmp_path / "m.zip")
    jnlp.WordVectorSerializer.write_full_model(j, p)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tnlp.WordVectorSerializer.read_full_model(p)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lookup_from_numpy(j.vocab, np.asarray(j.lookup.syn0))


def emulate_capture(monkeypatch):
    """The card's calls replaced for every ``StepPrograms``: the warm-up
    runs the body, the pinned staging is a plain copy, and the capture
    records the body without its effects (the holder's tensors and the
    programs' static inputs restored after it runs once), as a capture
    enqueues nothing; a replay reruns the body."""
    holders = []

    def captures(n):
        if isinstance(n, learning.StepPrograms) and n._capture:
            holders.append(n)
            return True
        return False

    def fake_capture(fn, pool=None):
        h = holders[-1]
        held = capture.state_leaves(h) + [
            t for p in h._step_graphs.programs.values()
            for t in tree_leaves(p.statics)]
        saved = [t.clone() for t in held]
        out = fn()
        for t, s in zip(held, saved):
            t.copy_(s)
        return _ReplayGraph(fn, out), out

    def put(self, dst, src, name):
        src = capture.host_or_device(src)
        if src is not dst:
            dst.copy_(src)

    monkeypatch.setattr(capture, "captures", captures)
    monkeypatch.setattr(capture, "warm_on_side_stream",
                        lambda fn, device: fn())
    monkeypatch.setattr(capture, "capture_graph", fake_capture)
    monkeypatch.setattr(capture.StepGraphs, "_pool", lambda self: None)
    monkeypatch.setattr(capture.StepGraphs, "put", put)


@pytest.mark.parametrize("algo,hs,negative", [
    ("skipgram", True, 3), ("cbow", True, 0), ("cbow", False, 4)])
def test_captured_fit_equals_eager(monkeypatch, algo, hs, negative):
    """The captured path (one program a padded batch shape, its inputs,
    key and lr staged into static tensors, the loss summed inside it)
    gives the eager fit's matrices and loss bit for bit."""
    sentences = synthetic_corpus(60)
    eager = w2v(tnlp, sentences, hs, negative, algo).fit()
    emulate_capture(monkeypatch)
    cap = w2v(tnlp, sentences, hs, negative, algo).fit()
    for n in ("syn0", "syn1", "syn1neg"):
        a, b = getattr(eager.lookup, n), getattr(cap.lookup, n)
        assert (a is None and b is None) or torch.equal(a, b), n
    assert cap.cum_loss == eager.cum_loss
    counts = cap.programs.counts()
    shapes = {k[1] for k in cap.programs._step_graphs.programs}
    assert counts["captures"] == len(shapes) >= 1
    assert counts["replays"] > counts["captures"]


def test_captured_glove_equals_eager(monkeypatch):
    def glove():
        return (tnlp.Glove.Builder().iterate(two_topic_corpus(100))
                .layer_size(16).window_size(3).epochs(2).learning_rate(0.1)
                .batch_size(128).seed(3).device("cpu").build().fit())

    eager = glove()
    emulate_capture(monkeypatch)
    cap = glove()
    assert torch.equal(eager.lookup.syn0, cap.lookup.syn0)
    assert cap.cum_loss == eager.cum_loss
    assert cap.programs.counts()["captures"] == 1


def test_use_adagrad_allocates_accumulators_no_step_reads():
    """The reference's ``use_adagrad`` allocates per-row accumulators that
    no step reads (ROADMAP C2): the port keeps the knob and its null
    effect."""
    sentences = synthetic_corpus(40)
    plain = w2v(tnlp, sentences).fit()
    ada = w2v(tnlp, sentences)
    ada.config.use_adagrad = True
    ada.fit()
    assert ada.lookup.syn0_hist is not None
    assert torch.equal(ada.lookup.syn0_hist, torch.zeros_like(ada.syn0))
    assert torch.equal(plain.syn0, ada.syn0)


def test_cum_loss_is_read_from_the_device_sum():
    t = w2v(tnlp, synthetic_corpus(40))
    assert t.cum_loss == 0.0
    t.fit()
    first = t.cum_loss
    assert first > 0 and t._loss_sum.dtype == torch.float64
    t.fit()
    assert t.cum_loss > first      # summed over fits, as the reference's
