"""Clustering, the trees and t-SNE (``deeplearning4j_tpu_torch/clustering``)
against the JAX package's, on the same seeded numpy inputs: k-means'
initial centres, assignments, centres and inertia; the trees' queries
and forces and Barnes-Hut t-SNE exactly (host numpy copies); the exact
t-SNE step within ``atol=1e-5`` after 10 steps.  Also the reference's
cases (``tests/test_clustering.py``) through the port, and the two
reference faults the port does not copy (ROADMAP C2)."""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import clustering as jc
from deeplearning4j_tpu.clustering import kmeans as jkmeans, tsne as jtsne
from deeplearning4j_tpu_torch import clustering as tc
from deeplearning4j_tpu_torch.clustering import kmeans as tkmeans
from deeplearning4j_tpu_torch.clustering import tsne as ttsne

from tests.test_clustering import blobs, brute_knn, separation_score

KM_TOL = dict(rtol=1e-5, atol=1e-6)


def mixture(n=600, d=8, k=5, seed=0, spread=3.0):
    """Overlapping Gaussian classes: Lloyd needs several iterations."""
    rs = np.random.RandomState(seed)
    centers = rs.randn(k, d) * spread
    labels = rs.randint(0, k, n)
    return (centers[labels] + rs.randn(n, d)).astype(np.float32), labels


def _record_init(monkeypatch, module):
    """Wraps ``module._lloyd`` to keep the initial centres it is given."""
    seen = []
    lloyd = module._lloyd

    def wrapped(points, centers0, *a):
        seen.append(np.asarray(centers0.cpu() if torch.is_tensor(centers0)
                               else centers0))
        return lloyd(points, centers0, *a)

    monkeypatch.setattr(module, "_lloyd", wrapped)
    return seen


# ------------------------------------------------------------------ k-means

@pytest.mark.parametrize("data,k,kw", [
    ("blobs", 3, {}), ("mixture", 5, {}), ("mixture", 8, {"seed": 3}),
    ("mixture", 5, {"max_iterations": 2}), ("mixture", 5, {"tol": 1e-2})])
def test_kmeans_matches_jax(monkeypatch, data, k, kw):
    x = blobs()[0] if data == "blobs" else mixture()[0]
    j_init = _record_init(monkeypatch, jkmeans)
    t_init = _record_init(monkeypatch, tkmeans)
    j = jc.KMeansClustering(k, **kw).apply_to(x)
    t = tc.KMeansClustering(k, device="cpu", **kw).apply_to(x)
    np.testing.assert_array_equal(t_init[0], j_init[0])
    np.testing.assert_array_equal(t.assignments, j.assignments)
    np.testing.assert_allclose(t.centers, j.centers, **KM_TOL)
    np.testing.assert_allclose(t.inertia, j.inertia, **KM_TOL)


def test_kmeans_stops_where_the_reference_stops():
    """The iterations run: the first before the test, then while the
    shift exceeds tol, up to max_iterations (counted against a numpy
    loop of the reference's body)."""
    x, _ = mixture()
    km = tc.KMeansClustering(5, device="cpu")
    km.apply_to(x)
    pts = torch.as_tensor(x)
    centers = pts[torch.as_tensor(tkmeans._init_centers(x, 5, km.seed))]
    shifts = []
    for _ in range(km.max_iterations):
        centers, _, shift = tkmeans._lloyd_step(pts, centers)
        shifts.append(float(shift))
    want = 1
    while want < km.max_iterations and shifts[want - 1] > np.float32(km.tol):
        want += 1
    assert km.iterations_ == want > 2
    capped = tc.KMeansClustering(5, max_iterations=2, device="cpu")
    capped.apply_to(x)
    assert capped.iterations_ == 2


def test_kmeans_blocks_equal_the_whole_broadcast(monkeypatch):
    x, _ = mixture(n=301)
    pts = torch.as_tensor(x)
    c = pts[:7]
    whole = ((pts[:, None, :] - c[None]) ** 2).sum(-1)
    monkeypatch.setattr(tkmeans, "BLOCK_BYTES", 7 * 8 * 4 * 40)
    assert torch.equal(tkmeans._distances(pts, c), whole)


def test_kmeans_takes_a_tensor():
    x, _ = mixture()
    a = tc.KMeansClustering(5, device="cpu").apply_to(x)
    b = tc.KMeansClustering(5, device="cpu").apply_to(torch.as_tensor(x))
    np.testing.assert_array_equal(a.assignments, b.assignments)
    np.testing.assert_array_equal(a.centers, b.centers)


def test_kmeans_recovers_blobs():
    x, labels = blobs()
    cs = tc.KMeansClustering(k=3, seed=1, device="cpu").apply_to(x)
    mapping = {}
    for k in range(3):
        vals, counts = np.unique(cs.assignments[labels == k],
                                 return_counts=True)
        assert counts.max() / counts.sum() > 0.95
        mapping[k] = vals[counts.argmax()]
    assert len(set(mapping.values())) == 3
    assert cs.inertia < 200.0


def test_kmeans_nearest_cluster_and_members():
    x, _ = blobs()
    cs = tc.KMeansClustering(k=3, seed=1, device="cpu").apply_to(x)
    assert np.linalg.norm(cs.centers[cs.nearest_cluster([10, 10])]
                          - [10, 10]) < 1.0
    assert sum(len(cl.point_indices) for cl in cs.clusters) == len(x)


def test_kmeans_k_exceeds_points():
    with pytest.raises(ValueError, match="k=10 > number of points 3"):
        tc.KMeansClustering(k=10, device="cpu").apply_to(
            np.zeros((3, 2), np.float32))
    with pytest.raises(ValueError):
        jc.KMeansClustering(k=10).apply_to(np.zeros((3, 2), np.float32))


def test_kmeans_plus_plus_with_fewer_distinct_points_than_k():
    """ROADMAP C2: with two distinct points each given twice, the
    reference's k-means++ reaches all-zero probabilities and
    ``RandomState.choice`` raises; the port draws uniformly among the
    points not yet chosen there and returns K centres."""
    x = np.array([[0, 0], [0, 0], [5, 5], [5, 5]], np.float32)
    with pytest.raises(ValueError, match="probabilities"):
        jc.KMeansClustering(3).apply_to(x)
    cs = tc.KMeansClustering(3, device="cpu").apply_to(x)
    assert cs.centers.shape == (3, 2) and np.isfinite(cs.centers).all()
    chosen = tkmeans._init_centers(x, 3, 12345)
    assert len(set(chosen)) == 3
    assert sorted({tuple(x[i]) for i in chosen}) == [(0, 0), (5, 5)]
    assert cs.inertia == 0.0


def test_kmeans_plus_plus_draws_as_the_reference_otherwise(monkeypatch):
    """Every draw of a non-degenerate init equals the reference's."""
    x, _ = mixture(n=200, k=4)
    for k, seed in ((2, 1), (6, 7), (12, 12345)):
        j_init = _record_init(monkeypatch, jkmeans)
        jc.KMeansClustering(k, seed=seed, max_iterations=1).apply_to(x)
        monkeypatch.undo()
        idx = tkmeans._init_centers(x, k, seed)
        np.testing.assert_array_equal(x[idx], j_init[0])


# -------------------------------------------------------------------- trees

@pytest.mark.parametrize("name", ["KDTree", "VPTree"])
def test_tree_knn_equals_the_reference(name):
    rs = np.random.RandomState(3)
    pts = rs.rand(200, 4)
    a, b = getattr(jc, name)(pts), getattr(tc, name)(pts)
    for _ in range(10):
        q = rs.rand(4)
        got = b.knn(q, 5)
        assert got == a.knn(q, 5)
        want_idx, want_d = brute_knn(pts, q, 5)
        assert [i for i, _ in got] == want_idx
        np.testing.assert_allclose([d for _, d in got], want_d, rtol=1e-9)


def test_kdtree_nn():
    pts = np.array([[0, 0], [1, 1], [5, 5]], float)
    idx, d = tc.KDTree(pts).nn([0.9, 0.9])
    assert (idx, d) == jc.KDTree(pts).nn([0.9, 0.9])
    assert idx == 1 and d == pytest.approx(np.hypot(0.1, 0.1))


def test_quadtree_equals_the_reference():
    rs = np.random.RandomState(0)
    pts = np.concatenate([rs.rand(50, 2), [[0.5, 0.5]] * 3])
    a, b = jc.QuadTree.build(pts), tc.QuadTree.build(pts)
    assert b.n_points == a.n_points == 53
    assert b.depth() == a.depth()
    np.testing.assert_array_equal(b.com, a.com)
    np.testing.assert_allclose(tc.QuadTree.build(pts[:50]).com,
                               pts[:50].mean(0), atol=1e-9)


def test_quadtree_duplicate_points_no_infinite_recursion():
    pts = np.array([[0.5, 0.5]] * 5 + [[0.1, 0.1]])
    assert tc.QuadTree.build(pts).n_points == 6


@pytest.mark.parametrize("theta", [0.0, 0.5])
def test_sptree_forces_equal_the_reference(theta):
    rs = np.random.RandomState(1)
    pts = rs.randn(60, 3)
    a, b = jc.SpTree.build(pts), tc.SpTree.build(pts)
    np.testing.assert_array_equal(b.com, a.com)
    for i in range(0, 60, 7):
        fa, fb = np.zeros(3), np.zeros(3)
        za = a.compute_non_edge_forces(pts[i], theta, fa)
        zb = b.compute_non_edge_forces(pts[i], theta, fb)
        assert za == zb
        np.testing.assert_array_equal(fb, fa)


def test_sptree_3d_and_forces():
    rs = np.random.RandomState(1)
    pts = rs.randn(60, 3)
    sp = tc.SpTree.build(pts)
    assert sp.n_points == 60
    np.testing.assert_allclose(sp.com, pts.mean(0), atol=1e-9)
    target = pts[0]
    f = np.zeros(3)
    z = sp.compute_non_edge_forces(target, 0.0, f)
    diff = target[None, :] - pts[1:]
    q = 1.0 / (1.0 + (diff ** 2).sum(1))
    assert z == pytest.approx(q.sum(), rel=1e-9)
    np.testing.assert_allclose(f, ((q ** 2)[:, None] * diff).sum(0),
                               rtol=1e-9)


# -------------------------------------------------------------------- t-SNE

def _tsne_inputs(n=300, d=10, seed=0):
    """Ten Gaussian classes in ``d`` dimensions, their joint P at
    perplexity 30, and a start ``y`` as ``Tsne`` draws it."""
    rs = np.random.RandomState(seed)
    labels = rs.randint(0, 10, n)
    x = (rs.randn(10, d) * 3)[labels] + rs.randn(n, d)
    P = jtsne._joint_p(x, min(30.0, (n - 1) / 3.0))
    y = (np.random.RandomState(seed + 1).randn(n, 2) * 1e-2).astype(
        np.float32)
    return P, y, labels


# The first iterations blow y up from 1e-2 to about 3, and float32
# rounding grows with it: at lr 200 (the default) on N 1000 the float32
# and float64 trajectories part by 1.2e-5 in 10 steps, the reference's
# as much as the port's.  Ten steps are held to 1e-5 at learning rates
# of N / 12 (sklearn's "auto": N / exaggeration / 4), and the default's
# single step to 1e-6.
@pytest.mark.parametrize("n,lr,exaggeration,momentum,steps,atol", [
    (300, 25.0, 4.0, 0.5, 10, 1e-5), (300, 25.0, 1.0, 0.8, 10, 1e-5),
    (200, 200.0, 4.0, 0.5, 1, 1e-6), (300, 200.0, 12.0, 0.5, 1, 1e-6)])
def test_tsne_step_matches_jax(n, lr, exaggeration, momentum, steps, atol):
    P, y0, _ = _tsne_inputs(n)
    Pf = np.asarray(P * exaggeration, np.float32)
    jy, jv, jg = (jtsne.jnp.asarray(y0), jtsne.jnp.zeros_like(y0),
                  jtsne.jnp.ones_like(y0))
    ty = torch.as_tensor(y0.copy())
    tv, tg = torch.zeros_like(ty), torch.ones_like(ty)
    tP = torch.as_tensor(Pf)
    t_lr, t_mom = torch.tensor(lr), torch.tensor(momentum)
    for _ in range(steps):
        jy, jv, jg, jkl = jtsne._tsne_step(jtsne.jnp.asarray(Pf), jy, jv, jg,
                                           np.float32(lr),
                                           np.float32(momentum))
        tkl = ttsne.tsne_step_(tP, ty, tv, tg, t_lr, t_mom)
    for a, b in ((ty, jy), (tv, jv), (tg, jg)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=atol,
                                   rtol=0)
    np.testing.assert_allclose(float(tkl), float(jkl), rtol=1e-4)


def test_tsne_first_steps_of_a_fit_match_jax():
    """``Tsne.embed`` (its schedule: exaggeration, the momentum switch and
    the end of the exaggeration at iteration 3) against the JAX fit's
    first ten iterations from the same P."""
    P, _, _ = _tsne_inputs()
    kw = dict(n_iter=10, switch_momentum_iteration=3,
              stop_lying_iteration=3, learning_rate=25.0, seed=5)
    j = jc.Tsne(**kw)
    monkey_x = np.zeros((len(P), 1))
    orig = jtsne._joint_p
    jtsne._joint_p = lambda x, perplexity: P
    try:
        jy = j.fit_transform(monkey_x)
    finally:
        jtsne._joint_p = orig
    t = tc.Tsne(device="cpu", **kw)
    ty = t.embed(P)
    np.testing.assert_allclose(ty, jy, atol=1e-5, rtol=0)
    np.testing.assert_allclose(t.kl_divergence_, j.kl_divergence_, rtol=1e-4)


def test_captured_tsne_equals_eager(monkeypatch):
    """The captured schedule on the CPU, the card's calls emulated (the
    warm-up runs the step, a capture records it without running it, a
    replay reruns it): bit-equal to the eager loop."""
    P, _, _ = _tsne_inputs(60)
    kw = dict(n_iter=12, switch_momentum_iteration=4,
              stop_lying_iteration=6, device="cpu")
    eager = tc.Tsne(**kw)
    ye = eager.embed(P)

    class Recorded:
        def __init__(self, fn):
            self.fn = fn

        def replay(self):
            self.fn()

    monkeypatch.setattr(ttsne, "warm_on_side_stream",
                        lambda fn, device: fn())
    monkeypatch.setattr(ttsne, "capture_graph",
                        lambda fn, pool=None: (Recorded(fn), None))
    cap = tc.Tsne(**kw)
    cap._capture = True
    yc = cap.embed(P)
    np.testing.assert_array_equal(yc, ye)
    assert cap.kl_divergence_ == eager.kl_divergence_
    assert (cap.captures, cap.replays) == (1, 11)
    assert (eager.captures, eager.replays) == (0, 0)


def test_exact_tsne_separates_blobs():
    x, labels = blobs(n_per=30, scale=0.3)
    ts = tc.Tsne(perplexity=10, n_iter=300, learning_rate=100, seed=2,
                 device="cpu")
    emb = ts.fit_transform(x)
    assert emb.shape == (90, 2)
    assert np.isfinite(ts.kl_divergence_)
    assert separation_score(emb, labels) > 2.0


def test_barnes_hut_tsne_equals_the_reference_bit_for_bit():
    x, _ = blobs(n_per=12, scale=0.4, seed=3)
    kw = dict(theta=0.5, perplexity=6, n_iter=25, learning_rate=100, seed=2,
              stop_lying_iteration=10, switch_momentum_iteration=12)
    a = jc.BarnesHutTsne(**kw)
    b = tc.BarnesHutTsne(**kw)
    ya, yb = a.fit_transform(x), b.fit_transform(x)
    assert ya.dtype == yb.dtype and np.array_equal(ya, yb)
    assert a.kl_divergence_ == b.kl_divergence_


def test_barnes_hut_tsne_separates_blobs():
    x, labels = blobs(n_per=25, scale=0.3)
    ts = tc.BarnesHutTsne(theta=0.5, perplexity=8, n_iter=150,
                          learning_rate=100, seed=2)
    emb = ts.fit_transform(x)
    assert emb.shape == (75, 2)
    assert separation_score(emb, labels) > 2.0


def test_barnes_hut_theta0_equals_the_exact_step_gradient():
    """θ = 0 (every cell opened) against the port's exact gradient, in
    float64 on the CPU."""
    P = np.full((30, 30), 1.0 / (30 * 29))
    np.fill_diagonal(P, 0)
    y = np.random.RandomState(0).randn(30, 2) * 0.1
    g_bh = tc.BarnesHutTsne(theta=0.0, n_iter=1)._gradient(P, y)
    g_exact, _ = ttsne._tsne_grad(torch.as_tensor(P), torch.as_tensor(y))
    np.testing.assert_allclose(g_bh, g_exact.numpy(), atol=1e-6)


def test_joint_p_in_blocks_equals_the_reference_bit_for_bit(monkeypatch):
    """ROADMAP C2: the reference's ``_joint_p`` builds an ``[N, N, D]``
    float64 temporary; the port's row blocks give the same P bit for
    bit (several blocks forced here)."""
    rs = np.random.RandomState(4)
    x = rs.randn(97, 13)
    monkeypatch.setattr(ttsne, "BLOCK_BYTES", 97 * 13 * 8 * 10)
    whole = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    assert np.array_equal(ttsne._sq_dists(x), whole)
    assert np.array_equal(ttsne._joint_p(x, 20.0), jtsne._joint_p(x, 20.0))


@pytest.mark.skipif(torch.cuda.is_available(), reason="a GPU is present")
def test_entry_points_raise_without_a_gpu():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tc.KMeansClustering(3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tc.Tsne()
    assert tc.BarnesHutTsne().device.type == "cpu"
