"""Distributed Word2Vec and GloVe across processes: two CPU processes
joined in a gloo group, each holding two of the mesh's four data slots.

Each rank builds the same global batch, runs its own slots' steps and
gathers every slot's count-weighted deltas (GloVe: the state's deltas)
in slot order before the one-process formula, so the ranks agree bit
for bit and equal the one-process four-slot fit bit for bit; against
the JAX package's ``shard_map`` versions on ``jax.devices()[:4]``
(skip-gram and CBOW, each with hierarchical softmax and with negative
sampling, the negatives from one numpy stream; GloVe) at the reference
tests' tolerances (``tests/test_nlp_distributed.py:74``'s 1e-4 for
Word2Vec, ``tests/test_torch_nlp_distributed.py``'s 1e-5 for GloVe).
A rank whose corpus differs fails the vocabulary's agreement check on
every rank before the first batch.

One pair of children (``tests/_torch_distributed_child.py``, JAX never
loaded there) runs every job, started by a module fixture; the
one-process fits are the same job function called here."""

import contextlib
import gc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import _torch_distributed_child as xchild

NLP_DIST_ATOL = 1e-4        # tests/test_nlp_distributed.py:74
GLOVE_ATOL = 1e-5           # tests/test_torch_nlp_distributed.py
K = 4
W2V = [("skipgram", True, 0), ("skipgram", False, 5), ("cbow", True, 0),
       ("cbow", False, 5)]


def _w2v_settings(algo, hs, negative):
    """``tests/test_torch_nlp_distributed.py``'s Builder settings."""
    return dict(layer_size=32, window_size=3, min_word_frequency=2,
                learning_rate=0.2, epochs=3, seed=1, batch_size=64,
                use_hierarchic_softmax=hs, negative_sample=negative,
                elements_learning_algorithm=algo)


GLOVE = dict(layer_size=24, window=4, epochs=4, learning_rate=0.1,
             min_word_frequency=2, batch_size=100, seed=3)


@pytest.fixture(scope="module")
def runs():
    from tests.test_glove_streaming import synthetic_corpus as two_topics
    from tests.test_nlp import synthetic_corpus

    sentences = synthetic_corpus(60)
    jobs = {}
    for algo, hs, neg in W2V:
        name = f"w2v_{algo}_{hs}_{neg}"
        jobs[name] = dict(name=name, kind="nlp_fit", sentences=sentences,
                          w2v=_w2v_settings(algo, hs, neg),
                          numpy_negatives=neg > 0)
    jobs["glove"] = dict(name="glove", kind="nlp_fit",
                         sentences=two_topics(200), glove=GLOVE)
    jobs["differ"] = dict(name="differ", kind="nlp_fit",
                          sentences=sentences, differ_on=1,
                          w2v=_w2v_settings("skipgram", True, 0))
    group = xchild.Group(list(jobs.values()))
    out = {"group": group, "jobs": jobs}
    yield out
    out.clear()
    gc.collect()


def _both(runs, name):
    return tuple(r[name] for r in runs["group"].wait())


@contextlib.contextmanager
def _threads(n=2):
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def _one(runs, name):
    """The job's fit in this process: one process, four slots."""
    with _threads():
        return xchild.nlp_fit(runs["jobs"][name])


def _equal(a, b):
    assert set(a["tables"]) == set(b["tables"])
    for k in a["tables"]:
        np.testing.assert_array_equal(a["tables"][k], b["tables"][k],
                                      err_msg=k)
    assert a["cum_loss"] == b["cum_loss"]


@contextlib.contextmanager
def _jax_negatives(on):
    from deeplearning4j_tpu.nlp import lookup as jlookup

    if not on:
        yield
        return
    stream = np.random.RandomState(0)

    def draw(self, key, shape):
        return jnp.asarray(stream.randint(0, len(self.cache), shape)
                           .astype(np.int32))

    saved = jlookup.InMemoryLookupTable.sample_negatives
    jlookup.InMemoryLookupTable.sample_negatives = draw
    try:
        yield
    finally:
        jlookup.InMemoryLookupTable.sample_negatives = saved


@pytest.mark.parametrize("algo,hs,negative", W2V)
def test_distributed_word2vec_across_processes(runs, algo, hs, negative):
    """Both ranks' tables and summed loss bit for bit, equal to the
    one-process four-slot fit bit for bit and to the JAX four-device
    ``DistributedWord2Vec`` within 1e-4 on the same negatives; the steps
    ran eagerly (nothing captured across processes)."""
    from deeplearning4j_tpu.nlp import distributed as jdist
    from tests._torch_parallel_common import jmesh

    name = f"w2v_{algo}_{hs}_{negative}"
    a, b = _both(runs, name)
    _equal(a, b)
    _equal(a, _one(runs, name))
    assert a["captures"] == 0
    job = runs["jobs"][name]
    jb = jdist.DistributedWord2Vec.Builder().iterate(job["sentences"])
    for k, v in job["w2v"].items():
        getattr(jb, k)(v)
    with _jax_negatives(negative > 0):
        ref = jb.mesh(jmesh(K)).build().fit()
    np.testing.assert_allclose(a["tables"]["syn0"], np.asarray(ref.syn0),
                               atol=NLP_DIST_ATOL, rtol=0)
    np.testing.assert_allclose(a["cum_loss"], ref.cum_loss, rtol=1e-5)


def test_distributed_glove_across_processes(runs):
    """Each rank's slots' AdaGrad steps, the eight state tensors' deltas
    gathered in slot order and averaged: the ranks and the one-process
    four-slot fit bit for bit, the JAX four-device ``DistributedGlove``
    within 1e-5."""
    from deeplearning4j_tpu.nlp import distributed as jdist
    from tests._torch_parallel_common import jmesh

    a, b = _both(runs, "glove")
    _equal(a, b)
    _equal(a, _one(runs, "glove"))
    job = runs["jobs"]["glove"]
    from deeplearning4j_tpu.nlp.documents import (
        CollectionSentenceIterator as JIt,
    )

    j = jdist.DistributedGlove(sentence_iterator=JIt(job["sentences"]),
                               mesh=jmesh(K), **GLOVE)
    j.fit()
    np.testing.assert_allclose(a["tables"]["syn0"], np.asarray(j.lookup.syn0),
                               atol=GLOVE_ATOL, rtol=0)
    np.testing.assert_allclose(a["cum_loss"], j.cum_loss, rtol=1e-5)


def test_a_vocabulary_that_differs_raises_on_every_rank(runs):
    """Rank 1's corpus lacks a sentence: the vocabulary's hash differs,
    and every rank raises before the first batch, naming what differs."""
    for r in _both(runs, "differ"):
        assert "error" in r, r.keys()
        assert "vocabulary" in r["error"] and "ranks [1]" in r["error"]


def test_children_load_no_jax(runs):
    for r in runs["group"].wait():
        assert r["jax_loaded"] is False
