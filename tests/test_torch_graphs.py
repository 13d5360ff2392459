"""The graph module (``deeplearning4j_tpu_torch/graphs``) against the JAX
package's: the reference's cases (``tests/test_graphs.py``) through the
port, the walks and the dense neighbour table equal to the reference's
exactly (host numpy from one seed), and DeepWalk's fit within the
tolerance ``tests/test_torch_nlp.py`` holds SequenceVectors to (the same
vocabulary, Huffman tree, seeded weights and pair stream; hierarchical
softmax draws nothing on the device).  A DeepWalk trained by the JAX
package, carried across, answers the queries the same."""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import graphs as jg
from deeplearning4j_tpu_torch import graphs as tg

from tests.test_graphs import ring_graph as _ring, two_cliques as _cliques
from tests.test_torch_nlp import ATOL, emulate_capture


def ring_graph(pkg, n=10):
    g = pkg.Graph(n)
    for i in range(n):
        g.add_edge(i, (i + 1) % n)
    return g


def two_cliques(pkg, k=5):
    """``tests/test_graphs.py::two_cliques`` on either package's Graph."""
    g = pkg.Graph(2 * k)
    for base in (0, k):
        for i in range(k):
            for j in range(i + 1, k):
                g.add_edge(base + i, base + j)
    g.add_edge(0, k)
    return g


def random_graph(pkg, n=40, m=120, seed=3, weighted=False):
    """Random undirected edges (with weights), a few directed ones and a
    dead end."""
    rs = np.random.RandomState(seed)
    g = pkg.Graph(n)
    for _ in range(m):
        a, b = rs.randint(0, n - 1, 2)
        g.add_edge(int(a), int(b),
                   weight=float(rs.rand() * 3 + 0.1) if weighted else 1.0)
    g.add_edge(n - 2, n - 1, directed=True)     # n - 1 is a dead end
    return g


def test_the_reference_helpers_build_equal_graphs():
    for a, b in ((_ring(7), ring_graph(tg, 7)), (_cliques(4),
                                                  two_cliques(tg, 4))):
        assert [a.neighbors(i) for i in range(a.num_vertices)] == \
            [b.neighbors(i) for i in range(b.num_vertices)]


# ---------------------------------------------------- the reference's cases

def test_graph_basics():
    g = ring_graph(tg, 5)
    assert g.num_vertices == 5
    assert g.degree(0) == 2
    assert set(g.neighbors(0)) == {1, 4}
    assert g.num_edges() == 10


def test_directed_edges_and_range():
    g = tg.Graph(3)
    g.add_edge(0, 1, directed=True)
    assert g.neighbors(0) == [1]
    assert g.neighbors(1) == []
    with pytest.raises(ValueError, match="out of range"):
        g.add_edge(0, 3)
    single = tg.Graph(2, allow_multiple_edges=False)
    single.add_edge(0, 1)
    single.add_edge(0, 1)
    assert single.degree(0) == 1


def test_neighbor_table():
    g = ring_graph(tg, 4)
    table, weights, deg = g.neighbor_table()
    assert table.shape[0] == 4
    assert (deg == 2).all()
    assert set(table[0][:2]) == {1, 3}


@pytest.mark.parametrize("weighted", [False, True])
def test_neighbor_table_equals_the_reference(weighted):
    a = random_graph(jg, weighted=weighted).neighbor_table()
    b = random_graph(tg, weighted=weighted).neighbor_table()
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and np.array_equal(x, y)


def test_edge_list_loading(tmp_path):
    p = tmp_path / "edges.txt"
    p.write_text("# comment\n0,1\n1,2\n2,0\n")
    g = tg.load_delimited_edges(str(p), 3)
    assert g.num_edges() == 6
    assert set(g.neighbors(0)) == {1, 2}


def test_weighted_edge_loading(tmp_path):
    p = tmp_path / "edges.txt"
    p.write_text("0,1,0.5\n1,2,2.0\n")
    g = tg.load_weighted_edges(str(p), 3)
    assert g.edges_out(0)[0].weight == 0.5


def test_vertex_loading(tmp_path):
    p = tmp_path / "verts.txt"
    p.write_text("0,zero\n1,one\n")
    vs = tg.load_delimited_vertices(str(p))
    assert vs[0].value == "zero" and vs[1].idx == 1


def test_loaders_equal_the_reference(tmp_path):
    p = tmp_path / "e.txt"
    p.write_text("# x\n0;1;0.5\n\n1;2;2.0\n2;0;1.5\n3;1;0.25\n")
    for load in ("load_delimited_edges", "load_weighted_edges"):
        a = getattr(jg, load)(str(p), 4, delimiter=";")
        b = getattr(tg, load)(str(p), 4, delimiter=";")
        assert [[(e.dst, e.weight) for e in a.edges_out(i)] for i in range(4)] \
            == [[(e.dst, e.weight) for e in b.edges_out(i)] for i in range(4)]


def test_random_walk_iterator_structure():
    g = ring_graph(tg, 6)
    walks = list(tg.RandomWalkIterator(g, walk_length=8, seed=1))
    assert len(walks) == 6
    for i, w in enumerate(walks):
        assert w[0] == i and len(w) == 9
        for a, b in zip(w, w[1:]):
            assert b in g.neighbors(a)


def test_weighted_walk_prefers_heavy_edges():
    g = tg.Graph(3)
    g.add_edge(0, 1, weight=100.0)
    g.add_edge(0, 2, weight=0.01)
    it = tg.WeightedRandomWalkIterator(g, walk_length=1, seed=0)
    hops = [it._walk_from(0)[1] for _ in range(50)]
    assert hops.count(1) > 40


def test_dead_end_self_loops_or_raises():
    g = tg.Graph(2)
    g.add_edge(0, 1, directed=True)
    assert tg.RandomWalkIterator(g, walk_length=3, seed=0)._walk_from(0) \
        == [0, 1, 1, 1]
    it = tg.RandomWalkIterator(g, walk_length=3, seed=0,
                               no_edge_handling="exception")
    with pytest.raises(tg.api.NoEdges):
        it._walk_from(0)


def test_generate_walks_batch():
    g = ring_graph(tg, 6)
    walks = tg.generate_walks(g, walk_length=5, walks_per_vertex=3, seed=2)
    assert walks.shape == (18, 6)
    for w in walks:
        for a, b in zip(w, w[1:]):
            assert b in g.neighbors(int(a))


def test_generate_walks_weighted():
    g = tg.Graph(3)
    g.add_edge(0, 1, weight=100.0)
    g.add_edge(0, 2, weight=0.01)
    walks = tg.generate_walks(g, walk_length=1, walks_per_vertex=200, seed=0,
                              weighted=True)
    assert (walks[walks[:, 0] == 0][:, 1] == 1).mean() > 0.9


# ---------------------------------------------- walks equal the reference's

@pytest.mark.parametrize("cls", ["RandomWalkIterator",
                                 "WeightedRandomWalkIterator"])
def test_walk_iterators_equal_the_reference(cls):
    a = list(getattr(jg, cls)(random_graph(jg, weighted=True), 12, seed=5))
    b = list(getattr(tg, cls)(random_graph(tg, weighted=True), 12, seed=5))
    assert a == b


@pytest.mark.parametrize("weighted", [False, True])
def test_generate_walks_equal_the_reference(weighted):
    a = jg.generate_walks(random_graph(jg, weighted=True), 15, 3, seed=9,
                          weighted=weighted)
    b = tg.generate_walks(random_graph(tg, weighted=True), 15, 3, seed=9,
                          weighted=weighted)
    assert a.dtype == b.dtype and np.array_equal(a, b)


# ----------------------------------------------------------------- DeepWalk

def _deepwalk(pkg, **kw):
    kw = dict(dict(vector_size=16, window_size=3, walk_length=20,
                   walks_per_vertex=8, epochs=5, learning_rate=0.2,
                   batch_size=64, seed=4), **kw)
    if pkg is tg:
        kw["device"] = "cpu"
    return pkg.DeepWalk(**kw)


def test_deepwalk_learns_community_structure():
    dw = _deepwalk(tg).fit(two_cliques(tg))
    within = np.mean([dw.similarity(a, b)
                      for a in range(1, 5) for b in range(1, 5) if a != b])
    across = np.mean([dw.similarity(a, b)
                      for a in range(1, 5) for b in range(6, 10)])
    assert within > across, f"within={within:.3f} across={across:.3f}"
    near = dw.vertices_nearest(1, top_n=3)
    assert len(set(near) & {0, 2, 3, 4}) >= 2


def test_deepwalk_vertex_vector_shape():
    dw = tg.DeepWalk(vector_size=12, walk_length=10, walks_per_vertex=2,
                     seed=1, device="cpu").fit(ring_graph(tg, 8))
    assert dw.vertex_vector(0).shape == (12,)
    assert dw.num_vertices() == 8


@pytest.mark.parametrize("epochs,window", [(5, 3), (2, 5)])
def test_deepwalk_fit_matches_jax(epochs, window):
    j = _deepwalk(jg, epochs=epochs, window_size=window).fit(
        two_cliques(jg))
    t = _deepwalk(tg, epochs=epochs, window_size=window).fit(
        two_cliques(tg))
    assert j.vocab.words() == t.vocab.words()
    for n in ("syn0", "syn1"):
        np.testing.assert_allclose(getattr(t.lookup, n).numpy(),
                                   np.asarray(getattr(j.lookup, n)),
                                   atol=ATOL, rtol=0, err_msg=n)
    np.testing.assert_allclose(t.cum_loss, j._sv.cum_loss, rtol=1e-5)
    for v in range(10):
        assert t.vertices_nearest(v, top_n=4) == j.vertices_nearest(v, 4)


def test_a_jax_deepwalk_carried_across_answers_the_same():
    j = _deepwalk(jg).fit(two_cliques(jg))
    vocab = [(el.label, el.element_frequency) for el in j.vocab.vocab_words()]
    t = tg.DeepWalk.from_numpy(two_cliques(tg), vocab,
                               np.asarray(j.lookup.syn0),
                               np.asarray(j.lookup.syn1), device="cpu")
    assert t.vocab.words() == j.vocab.words()
    assert t.num_vertices() == 10
    for v in range(10):
        assert t.vertices_nearest(v, top_n=5) == j.vertices_nearest(v, 5)
        np.testing.assert_array_equal(t.vertex_vector(v), j.vertex_vector(v))
    for a, b in ((1, 2), (1, 7), (0, 5)):
        assert t.similarity(a, b) == pytest.approx(j.similarity(a, b),
                                                   rel=1e-6)


def test_deepwalk_given_walks_equals_its_own():
    g = two_cliques(tg)
    a = _deepwalk(tg).fit(g)
    walks = tg.generate_walks(g, 20, 8, seed=4)
    b = _deepwalk(tg).fit(g, walks=walks)
    assert torch.equal(a.lookup.syn0, b.lookup.syn0)


def test_captured_deepwalk_equals_eager(monkeypatch):
    g = two_cliques(tg)
    eager = _deepwalk(tg).fit(g)
    emulate_capture(monkeypatch)
    cap = _deepwalk(tg).fit(g)
    assert torch.equal(eager.lookup.syn0, cap.lookup.syn0)
    assert torch.equal(eager.lookup.syn1, cap.lookup.syn1)
    counts = cap.programs.counts()
    assert counts["captures"] >= 1 and counts["replays"] > counts["captures"]


@pytest.mark.skipif(torch.cuda.is_available(), reason="a GPU is present")
def test_deepwalk_raises_without_a_gpu():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tg.DeepWalk()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tg.DeepWalk.from_numpy(None, [("0", 1.0)], np.zeros((1, 4)))
