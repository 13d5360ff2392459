"""Distributed embedding training over slot meshes
(``deeplearning4j_tpu_torch/nlp/distributed.py``) against the serial port
and the JAX package's ``shard_map`` versions on the conftest's eight
virtual devices, with the reference's Builder settings
(``tests/test_nlp_distributed.py``).  The negative-sampling cases feed
every model the same negatives from a numpy stream of one seed."""

from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.backend import device as jbackend
from deeplearning4j_tpu.nlp import distributed as jdist
from deeplearning4j_tpu.nlp import lookup as jlookup
from deeplearning4j_tpu_torch.backend import mesh as mesh_mod
from deeplearning4j_tpu_torch.nlp import distributed as tdist
from deeplearning4j_tpu_torch.nlp import lookup as tlookup
from deeplearning4j_tpu_torch.nlp.tokenization import DefaultTokenizerFactory
from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec as TWord2Vec

from tests.test_glove_streaming import synthetic_corpus as two_topic_corpus
from tests.test_nlp import synthetic_corpus
from tests.test_torch_nlp import emulate_capture


def _slots(k):
    return mesh_mod.default_mesh(data=k, devices=["cpu"] * k)


def builder(cls, sentences, hs=True, negative=0, algo="skipgram"):
    b = (cls.Builder()
         .iterate(sentences)
         .layer_size(32)
         .window_size(3)
         .min_word_frequency(2)
         .learning_rate(0.2)
         .epochs(3)
         .seed(1)
         .batch_size(64)
         .use_hierarchic_softmax(hs)
         .negative_sample(negative)
         .elements_learning_algorithm(algo))
    if cls is TWord2Vec:
        b.device("cpu")
    return b


@pytest.fixture
def negatives(monkeypatch):
    """``reset()`` restarts every model's negative stream at seed 0."""
    streams = {}

    def reset():
        streams["jax"] = np.random.RandomState(0)
        streams["port"] = np.random.RandomState(0)

    def jax_draw(self, key, shape):
        return jnp.asarray(streams["jax"].randint(0, len(self.cache), shape)
                           .astype(np.int32))

    def port_draw(self, key, shape):
        return torch.as_tensor(streams["port"].randint(
            0, len(self.cache), shape).astype(np.int32)).to(self.device)

    monkeypatch.setattr(jlookup.InMemoryLookupTable, "sample_negatives",
                        jax_draw)
    monkeypatch.setattr(tlookup.InMemoryLookupTable, "sample_negatives",
                        port_draw)
    reset()
    return reset


def test_parallel_vocab_count_matches_serial():
    sentences = synthetic_corpus(100)
    tf = DefaultTokenizerFactory()
    serial = Counter()
    for s in sentences:
        serial.update(tf.create(s).tokens())
    assert tdist.parallel_vocab_count(sentences, tf, n_threads=4) == serial


@pytest.mark.parametrize("algo", ["skipgram", "cbow"])
def test_one_slot_mesh_matches_serial_word2vec(algo):
    sentences = synthetic_corpus(60)
    serial = builder(TWord2Vec, sentences, algo=algo).build().fit()
    dist = (builder(tdist.DistributedWord2Vec, sentences, algo=algo)
            .mesh(_slots(1)).build().fit())
    np.testing.assert_allclose(serial.syn0.numpy(), dist.syn0.numpy(),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(serial.cum_loss, dist.cum_loss, rtol=1e-6)


@pytest.mark.parametrize("algo,hs,negative", [
    ("skipgram", True, 0), ("skipgram", False, 5), ("cbow", True, 0),
    ("cbow", False, 5)])
def test_eight_slot_mesh_matches_serial_and_jax(negatives, algo, hs,
                                                negative):
    """The count-weighted psum makes the sharded step compute the serial
    step's global-mean update (float reassociation aside): the eight-slot
    port against the serial port, and against JAX's eight-device
    ``DistributedWord2Vec`` on the same negatives."""
    sentences = synthetic_corpus(60)
    kw = dict(hs=hs, negative=negative, algo=algo)
    serial = builder(TWord2Vec, sentences, **kw).build().fit()
    negatives()
    with mesh_mod.census() as c:
        dist = (builder(tdist.DistributedWord2Vec, sentences, **kw)
                .mesh(_slots(8)).build().fit())
    ref = (builder(jdist.DistributedWord2Vec, sentences, **kw)
           .mesh(jbackend.default_mesh()).build().fit())
    np.testing.assert_allclose(dist.syn0.numpy(), serial.syn0.numpy(),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(dist.syn0.numpy(), np.asarray(ref.syn0),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(dist.cum_loss, ref.cum_loss, rtol=1e-5)
    reduce = c.counts["all-reduce"]
    assert reduce["group_sizes"] == [8] and reduce["count"] > 0


def test_distributed_word2vec_learns_structure():
    from tests.test_nlp import check_cluster_structure

    model = (builder(tdist.DistributedWord2Vec, synthetic_corpus())
             .mesh(_slots(8)).build())
    model.config.epochs = 8
    model.fit()
    check_cluster_structure(model)


def _glove(cls, mesh):
    b = (cls.Builder().iterate(two_topic_corpus(200)).layer_size(24)
         .window_size(4).epochs(4).learning_rate(0.1).min_word_frequency(2)
         .batch_size(100).seed(3).mesh(mesh))
    return b.build()


def test_distributed_glove_matches_jax():
    """Each slot's AdaGrad step on its shard and replica, then the plain
    ``pmean`` of the deltas (accumulators included): the port's eight
    slots against JAX's eight devices; the batch rounded up to a multiple
    of the mesh in both."""
    t = _glove(tdist.DistributedGlove, _slots(8))
    j = _glove(jdist.DistributedGlove, jbackend.default_mesh())
    assert t.batch_size == j.batch_size == 104
    with mesh_mod.census() as c:
        t.fit()
    j.fit()
    np.testing.assert_allclose(t.lookup.syn0.numpy(), np.asarray(j.lookup.syn0),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(t.cum_loss, j.cum_loss, rtol=1e-5)
    assert c.counts["all-reduce"]["group_sizes"] == [8]
    weather, finance = ["rain", "snow", "storm"], ["bank", "money", "stock"]
    within = np.mean([t.similarity(a, b) for a in weather for b in weather
                      if a != b])
    across = np.mean([t.similarity(a, b) for a in weather for b in finance])
    assert within > across + 0.1


def test_captured_distributed_fit_equals_eager(monkeypatch):
    """The whole sharded step as one program a padded shape (the port's
    own sampler, keyed by the staged device key) equals eager."""
    sentences = synthetic_corpus(60)
    eager = (builder(tdist.DistributedWord2Vec, sentences, negative=3)
             .mesh(_slots(4)).build().fit())
    emulate_capture(monkeypatch)
    cap = (builder(tdist.DistributedWord2Vec, sentences, negative=3)
           .mesh(_slots(4)).build().fit())
    assert torch.equal(eager.syn0, cap.syn0)
    assert cap.cum_loss == eager.cum_loss
    assert cap.programs.counts()["captures"] >= 1


def test_a_mesh_across_devices_raises():
    with pytest.raises(NotImplementedError, match="A10"):
        (builder(tdist.DistributedWord2Vec, synthetic_corpus(10))
         .mesh(mesh_mod.default_mesh(devices=["cpu", "cuda:0"])).build())
