"""The port's training dashboard (``deeplearning4j_tpu_torch/ui``:
``UIServer`` and ``RemoteStatsListener``, the components, the renders and
``ConvolutionalIterationListener``) against the JAX package's, on the
CPU.

For the same storage contents every endpoint of the two servers answers
the same status and the same JSON (``/memory``: the same keys, the
sharding ledger empty in the port until A10); ``write_png`` writes equal
bytes; components serialise to equal JSON.  The convolution listener on
a net whose ``fit`` is captured (the card's calls emulated on the CPU)
renders without a capture or a change to the step: the run equals one
without it bit for bit.
"""

import json
import struct
import threading
import urllib.error
import urllib.request
import zlib

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.observability.metrics import (
    MetricsRegistry as JRegistry,
)
from deeplearning4j_tpu.ui import components as jcomp
from deeplearning4j_tpu.ui import render as jrender
from deeplearning4j_tpu.ui.server import (
    RemoteStatsListener as JRemote, UIServer as JUIServer,
)
from deeplearning4j_tpu.ui.stats import StatsReport as JReport
from deeplearning4j_tpu.ui.storage import (
    FileStatsStorage as JFileStorage, InMemoryStatsStorage as JMemStorage,
)
from deeplearning4j_tpu_torch.observability.metrics import MetricsRegistry
from deeplearning4j_tpu_torch.ui import components as comp
from deeplearning4j_tpu_torch.ui import render
from deeplearning4j_tpu_torch.ui.server import RemoteStatsListener, UIServer
from deeplearning4j_tpu_torch.ui.stats import StatsReport
from deeplearning4j_tpu_torch.ui.storage import (
    FileStatsStorage, InMemoryStatsStorage,
)

LAYERS = ("layer_0", "layer_1")


def _numerics(it):
    """A harvested ledger's shape (``numerics._entry_host`` plus the
    verdicts) with one gradient entry."""
    from deeplearning4j_tpu_torch.observability.numerics import (
        FORMAT_NAMES, HIST_BINS,
    )

    hist = [0.0] * HIST_BINS
    hist[HIST_BINS // 2], hist[HIST_BINS // 2 + 3] = 5.0, 2.0
    entry = {"max_abs": 3.5 + it,
             "underflow": {n: 0.125 * i for i, n in enumerate(FORMAT_NAMES)},
             "overflow": {n: 0.0 for n in FORMAT_NAMES},
             "exponent_histogram": hist,
             "verdicts": {n: i != 1 for i, n in enumerate(FORMAT_NAMES)}}
    return {"iteration": it, "loss_scale": 2.0,
            "gradients": {"layer_0": entry}, "moments": {},
            "activations": {}}


def _reports(cls, sid, n=4, seed=0):
    """Reports with every field the endpoints read: scores (one NaN),
    times, memory, histograms, per-layer and per-replica introspection
    series (a NaN ratio), and a numerics ledger on the last."""
    rs = np.random.RandomState(seed)
    out = []
    for it in range(n):
        grad = {l: {"norm": float(rs.rand()),
                    "per_replica": [float(rs.rand()), float("nan")]}
                for l in LAYERS}
        upd = {l: {"norm": float(rs.rand()),
                   "ratio": float("nan") if it == 1 else float(rs.rand()),
                   "param_norm": float(rs.rand())} for l in LAYERS}
        act = {l: {"mean": float(rs.randn()), "std": float(rs.rand()),
                   "zero_fraction": float(rs.rand() * (it > 0))}
               for l in LAYERS}
        hist = {f"{l}/W": {"bins": [float(b) for b in np.linspace(-1, 1, 4)],
                           "counts": [int(c) for c in rs.randint(0, 9, 3)]}
                for l in LAYERS}
        out.append(cls(
            session_id=sid, iteration=it, timestamp=1000.0 + it,
            score=float("nan") if it == 2 else float(rs.rand()),
            iteration_time_ms=float(rs.rand() * 5),
            samples_per_second=float(rs.rand() * 1e4),
            memory={"device_0": {"bytes_in_use": int(rs.randint(1e6))}},
            param_histograms=hist, gradient_stats=grad, update_stats=upd,
            activation_stats=act, replicas=2,
            numerics=_numerics(it) if it == n - 1 else {}))
    return out


class _Engine:
    def cache_stats(self):
        return {"pages_used": 3, "pages_total": 17, "prefix": {"hits": 2}}


class _Fleet:
    def __init__(self, registry):
        self._reg = registry

    def fleet_table(self):
        return {"workers": {"w0": {"stale": False, "age_s": 0.5}}}

    def registry(self):
        return self._reg

    def evaluate_health(self, reg):
        return None


def _servers(tmp_path, file_storage):
    """Both packages' servers over the same reports, each with a fresh
    registry."""
    if file_storage:
        ours = FileStatsStorage(str(tmp_path / "ours.jsonl"))
        theirs = JFileStorage(str(tmp_path / "theirs.jsonl"))
    else:
        ours, theirs = InMemoryStatsStorage(), JMemStorage()
    for sid, seed in (("a", 0), ("b", 1)):
        for rep in _reports(StatsReport, sid, seed=seed):
            ours.put_update(rep)
        for rep in _reports(JReport, sid, seed=seed):
            theirs.put_update(rep)
    return (UIServer(ours, registry=MetricsRegistry()),
            JUIServer(theirs, registry=JRegistry()))


def _get(port, path, method="GET", body=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=body, method=method)
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, r.headers.get("Content-Type"), r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read().decode()


def _canon(text):
    """JSON text in a canonical form (NaN compares as text)."""
    return json.dumps(json.loads(text), sort_keys=True)


JSON_PATHS = [
    "/train/sessions", "/sessions", "/train/overview?sid=a", "/overview",
    "/train/compare?sids=a,b", "/compare?sids=a,b&metric=iteration_time_ms",
    "/train/compare?sids=a,b&metric=update_ratio:layer_1",
    "/train/compare?sids=a&metric=gradient_norm",
    "/train/compare?sids=a&metric=bogus",
    "/train/layer?sid=a&layer=layer_0", "/train/layer?sid=b",
    "/train/introspection?sid=b", "/train/numerics?sid=a",
    "/train/numerics?sid=missing", "/train/memory?sid=b", "/health",
    "/generation/cache", "/fleet", "/fleet/metrics", "/no/such/path",
]


@pytest.mark.parametrize("file_storage", [False, True],
                         ids=["memory", "file"])
def test_endpoints_answer_the_references_json(tmp_path, file_storage):
    ours, theirs = _servers(tmp_path, file_storage)
    po, pt = ours.start(), theirs.start()
    try:
        for path in JSON_PATHS:
            so, to, bo = _get(po, path)
            st, tt, bt = _get(pt, path)
            assert (so, to) == (st, tt), path
            assert _canon(bo) == _canon(bt), path
        # the scrape after /health: the same families and values
        assert _get(po, "/metrics")[1:] == _get(pt, "/metrics")[1:]
        page = _get(po, "/train/")[2]
        assert page == _get(pt, "/")[2].replace(
            "deeplearning4j_tpu training UI",
            "deeplearning4j_tpu_torch training UI")
        # /memory: the reference's keys; the ledger waits for shardstats
        mem = json.loads(_get(po, "/memory")[2])
        assert sorted(mem) == sorted(json.loads(_get(pt, "/memory")[2])) \
            == ["device_memory", "ledgers", "programs"]
        assert mem["ledgers"] == {} and mem["programs"] == {}
        assert mem["device_memory"] == {}        # no card here
        # the panels, once attached
        ours.attach_generation(_Engine())
        theirs.attach_generation(_Engine())
        ours.attach_fleet(_Fleet(MetricsRegistry()))
        theirs.attach_fleet(_Fleet(JRegistry()))
        for path in ("/generation/cache", "/fleet", "/fleet/metrics"):
            assert _get(po, path) == _get(pt, path), path
        # POST /collect ingests a report into each
        rep = _reports(StatsReport, "posted", n=1, seed=5)[0]
        body = rep.to_json().encode()
        assert _get(po, "/collect", "POST", body) == \
            _get(pt, "/collect", "POST", body)
        assert _get(po, "/train/sessions") == _get(pt, "/train/sessions")
        assert _get(po, "/train/overview?sid=posted") == \
            _get(pt, "/train/overview?sid=posted")
        assert _get(po, "/other", "POST", b"{}") == \
            _get(pt, "/other", "POST", b"{}")
    finally:
        ours.stop()
        theirs.stop()


def _sse_events(port, query, n, after=None):
    """The first ``n`` SSE events of ``/train/stream`` (heartbeats
    skipped); ``after(connected)`` runs once the stream is open."""
    events = []
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/train/stream{query}", timeout=10) as r:
        if after is not None:
            after()
        while len(events) < n:
            line = r.readline().decode()
            if line.startswith("data: "):
                events.append(json.loads(line[6:]))
    return events


def test_sse_stream_replays_and_follows_like_the_reference(tmp_path):
    """``replay=1`` replays the stored reports of a session in order, then
    a report stored while the client listens follows: the same events
    from both servers."""
    ours, theirs = _servers(tmp_path, False)
    po, pt = ours.start(), theirs.start()
    try:
        got = []
        for port, server, cls in ((po, ours, StatsReport),
                                  (pt, theirs, JReport)):
            live = _reports(cls, "a", n=5, seed=9)[4]
            got.append(_sse_events(
                port, "?sid=a&replay=1", 5,
                after=lambda s=server, r=live: threading.Timer(
                    0.3, s.storage.put_update, (r,)).start()))
        assert [e["iteration"] for e in got[0]] == [0, 1, 2, 3, 4]
        assert json.dumps(got[0]) == json.dumps(got[1])
    finally:
        ours.stop()
        theirs.stop()


def test_remote_listener_posts_like_the_reference():
    class Net:
        score_value = 0.25

    ours, theirs = UIServer(), JUIServer()
    po, pt = ours.start(), theirs.start()
    try:
        for listener in (RemoteStatsListener(f"http://127.0.0.1:{po}",
                                             "remote", frequency=2),
                         JRemote(f"http://127.0.0.1:{pt}", "remote",
                                 frequency=2)):
            for it in range(5):
                listener.iteration_done(Net(), it)
        a = ours.storage.get_updates("remote")
        b = theirs.storage.get_updates("remote")
        assert [(r.iteration, r.score) for r in a] == \
            [(r.iteration, r.score) for r in b] == [(0, .25), (2, .25),
                                                    (4, .25)]
    finally:
        ours.stop()
        theirs.stop()
    # a dead server never kills training
    RemoteStatsListener(f"http://127.0.0.1:{po}", timeout=0.2) \
        .iteration_done(Net(), 0)


# ------------------------------------------------------------- components
def _charts(pkg):
    style = pkg.StyleChart(width=300, height=200,
                           series_colors=["#111111", "#222222"])
    line = pkg.ChartLine("loss", style).add_series("a", [0, 1, 2],
                                                   [0.5, 0.25, 0.125])
    scatter = pkg.ChartScatter("pts").add_series("s", [1.5], [2])
    area = pkg.ChartStackedArea("area").add_series("x", [0, 1], [3, 4])
    hist = pkg.ChartHistogram("h").add_bin(-1, 0, 3).add_bin(0, 1, 5)
    table = pkg.ComponentTable(["k", "v"], [("a", 1)]).add_row("b", 2.5)
    text = pkg.ComponentText("hello")
    return [line, scatter, area, hist, table, text,
            pkg.ComponentDiv(line, pkg.ComponentDiv(hist, text), table)]


def test_components_serialise_to_the_references_json():
    for a, b in zip(_charts(comp), _charts(jcomp)):
        assert a.to_json() == b.to_json()
        back = comp.component_from_dict(json.loads(a.to_json()))
        assert back.to_json() == jcomp.component_from_dict(
            json.loads(b.to_json())).to_json()
    with pytest.raises(ValueError, match="Unknown componentType"):
        comp.component_from_dict({"componentType": "Nope"})


# ---------------------------------------------------------------- renders
@pytest.mark.parametrize("seed, shape, last", [
    (0, (6, 5, 3), True), (1, (4, 7, 7), False), (2, (9, 9, 1), True)])
def test_grids_and_pngs_equal_the_reference(tmp_path, seed, shape, last):
    a = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    grid = render.activation_grid(a, channels_last=last)
    assert np.array_equal(grid, jrender.activation_grid(
        a, channels_last=last))
    render.write_png(tmp_path / "a.png", grid)
    jrender.write_png(tmp_path / "b.png", grid)
    assert (tmp_path / "a.png").read_bytes() == \
        (tmp_path / "b.png").read_bytes()
    assert np.array_equal(_decode_png(tmp_path / "a.png"),
                          (np.clip(grid, 0, 1) * 255).astype(np.uint8))
    with pytest.raises(ValueError):
        render.write_png(tmp_path / "c.png", a)


def _decode_png(path):
    raw = path.read_bytes()
    assert raw[:8] == b"\x89PNG\r\n\x1a\n"
    w, h = struct.unpack(">II", raw[16:24])
    pos, data = 8, b""
    while pos < len(raw):
        n = struct.unpack(">I", raw[pos:pos + 4])[0]
        if raw[pos + 4:pos + 8] == b"IDAT":
            data += raw[pos + 8:pos + 8 + n]
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(data), np.uint8).reshape(h, w + 1)
    assert not rows[:, 0].any()         # filter type 0 on every row
    return rows[:, 1:]


def _lenet_pair():
    from deeplearning4j_tpu.models import zoo as jzoo
    from deeplearning4j_tpu_torch.models.interop import params_from_numpy
    from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration

    jnet = jzoo.lenet()
    conf = MultiLayerConfiguration.from_json(jnet.conf.to_json())
    make = lambda: params_from_numpy(conf, jax.device_get(jnet.params),  # noqa: E731
                                     device="cpu")
    return jnet, make


def test_convolution_listener_renders_like_the_reference(tmp_path):
    """The same LeNet weights, the same probe: the listener picks the same
    layer and writes the same grid (pixels within one level: the two
    convolutions round apart)."""
    jnet, make = _lenet_pair()
    probe = np.random.RandomState(0).rand(2, 784).astype(np.float32)
    ours = render.ConvolutionalIterationListener(probe, tmp_path / "p", 5)
    theirs = jrender.ConvolutionalIterationListener(probe, tmp_path / "j", 5)
    for it in (0, 3, 5):
        ours.iteration_done(make(), it)
        theirs.iteration_done(jnet, it)
    assert [p.name for p in ours.rendered] == \
        [p.name for p in theirs.rendered] == ["activations_iter0.png",
                                              "activations_iter5.png"]
    a = _decode_png(ours.rendered[0]).astype(int)
    b = _decode_png(theirs.rendered[0]).astype(int)
    assert a.shape == b.shape and np.abs(a - b).max() <= 1


def test_convolution_listener_leaves_the_captured_step_alone(monkeypatch,
                                                             tmp_path):
    """LeNet's captured ``fit`` (the card's calls emulated on the CPU,
    ``test_torch_tbptt._emulate_capture``) with the listener rendering
    every second step: one capture, every later step a replay, and the
    parameters, updater state and losses equal an eager run's without
    the listener bit for bit."""
    from tests.test_torch_tbptt import _emulate_capture

    from deeplearning4j_tpu_torch.models.common import tree_leaves

    _, make = _lenet_pair()
    net, eager = make(), make()
    _emulate_capture(monkeypatch, net)
    eager._capture = False
    probe = np.random.RandomState(1).rand(1, 784).astype(np.float32)
    listener = render.ConvolutionalIterationListener(probe, tmp_path, 2)
    net.set_listeners(listener)
    rs = np.random.RandomState(2)
    batches = [(rs.rand(16, 784).astype(np.float32),
                np.eye(10, dtype=np.float32)[rs.randint(0, 10, 16)])
               for _ in range(5)]
    for x, y in batches:
        net.fit(x, y)
        eager.fit(x, y)
        assert net.score_value == eager.score_value
    graphs = net._step_graphs
    assert graphs.captures == 1 and graphs.replays == 4
    assert [p.name for p in listener.rendered] == [
        "activations_iter2.png", "activations_iter4.png"]
    for a, b in zip(tree_leaves(net.params), tree_leaves(eager.params)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(net.updater_state),
                    tree_leaves(eager.updater_state)):
        assert torch.equal(a, b)
