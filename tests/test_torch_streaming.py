"""The port's streaming layer (``deeplearning4j_tpu_torch/streaming/``)
against the JAX package's on the CPU.

- serde: the NDArray and DataSet envelopes are byte-equal to the JAX
  ``serde``'s for the same arrays and DataSets, and a bad record is
  rejected with the same ``BadRecordError`` reason (reference
  ``tests/test_streaming.py``).
- pubsub: local and over HTTP; publishing never blocks on a slow
  consumer, and the drops are counted per topic.
- ``InferenceServer``: ``/predict`` on bench_serving's MLP equals the JAX
  server's on one zip checkpoint (``atol=1e-5``); ``/generate``, plain and
  SSE, gives greedy ids identical to the JAX server's on a small char-LM
  from one zip; the error statuses and bodies (400, 404, 429, 503, 504)
  match the JAX server's; ``/metrics`` shows the JAX server's families
  and label names; ``/health``, ``/healthz``, ``/models``,
  ``/generation/cache`` and pin/unpin answer as the JAX server's;
  ``POST /models/<name>`` and its rollback under load drop no request.
- ``StreamingPipeline`` trains and ``ServingPipeline`` round-trips.

Servers bind port 0 on localhost and are stopped in a ``finally``.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from deeplearning4j_tpu import generation as jax_generation
from deeplearning4j_tpu import serving as jax_serving
from deeplearning4j_tpu import streaming as jax_streaming
from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.models import serialization as jax_serialization
from deeplearning4j_tpu.models.sequential import (
    MultiLayerNetwork as JaxMultiLayerNetwork,
)
from deeplearning4j_tpu.models.zoo import transformer_char_lm as jax_lm
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu.observability import metrics as jax_metrics
from deeplearning4j_tpu_torch import generation as port_generation
from deeplearning4j_tpu_torch import serving as port_serving
from deeplearning4j_tpu_torch import streaming as port_streaming
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.models import serialization
from deeplearning4j_tpu_torch.observability import metrics
from deeplearning4j_tpu_torch.streaming import (
    BadRecordError, MessageBroker, NDArrayConsumer, NDArrayPublisher,
    ServingPipeline, StreamingPipeline, array_to_base64, base64_to_array,
    consume_dataset_json, dataset_from_json, dataset_to_json,
)
from deeplearning4j_tpu_torch.streaming.serde import record_to_dataset

VOCAB = 29
SERVE = {"jax": (jax_serving, jax_generation, jax_streaming),
         "torch": (port_serving, port_generation, port_streaming)}


def _mlp(n_in, hidden, n_out, seed):
    b = (NeuralNetConfiguration.builder().seed(seed)
         .updater("sgd", learning_rate=0.1).list())
    for i, h in enumerate(hidden):
        b = b.layer(DenseLayer(n_in=n_in if i == 0 else hidden[i - 1],
                               n_out=h, activation="relu"))
    return JaxMultiLayerNetwork(
        b.layer(OutputLayer(n_in=hidden[-1], n_out=n_out, loss="mcxent",
                            activation="softmax")).build()).init()


def _zip(jnet, tmp_path_factory, name):
    path = tmp_path_factory.mktemp("ckpt") / f"{name}.zip"
    jax_serialization.write_model(jnet, str(path))
    return path


def _http(url, body=None, headers=None, timeout=30):
    """(status, body bytes, headers) of one request; an HTTP error's
    status and body are returned, not raised."""
    data = None if body is None else (
        body if isinstance(body, bytes) else json.dumps(body).encode())
    req = urllib.request.Request(url, data=data, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def _sse(raw: bytes):
    return [json.loads(line[len("data: "):])
            for line in raw.decode().split("\n\n") if line.startswith("data: ")]


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """bench_serving's MLP (64 -> 256 -> 256 -> 10) and a second MLP of
    the same shape, and the char-LM, as zips; each with its JAX net and
    its port net restored on the CPU."""
    out = {}
    for name, jnet in (
            ("mlp", _mlp(64, (256, 256), 10, seed=12345)),
            ("mlp2", _mlp(64, (256, 256), 10, seed=777)),
            ("lm", jax_lm(vocab_size=VOCAB, d_model=32, n_heads=4, layers=2,
                          max_cache=128, seed=12345))):
        path = _zip(jnet, tmp_path_factory, name)
        out[name] = (jnet, serialization.load_model(path, device="cpu"),
                     path)
    return out


@pytest.fixture(scope="module")
def servers(models):
    """One ``InferenceServer`` a package over its ``ServingEngine`` (the
    MLP, buckets up to 8) and ``GenerationEngine`` (the char-LM, prefix
    cache on), each with registries of its own; {impl: (server, url)}."""
    old = metrics.get_registry(), jax_metrics.get_registry()
    started = []
    try:
        out = {}
        for impl, (srv, gen, stream) in SERVE.items():
            reg = (metrics if impl == "torch" else jax_metrics
                   ).MetricsRegistry()
            (metrics if impl == "torch" else jax_metrics).set_registry(reg)
            net = models["mlp"][1 if impl == "torch" else 0]
            lm = models["lm"][1 if impl == "torch" else 0]
            eng = srv.ServingEngine(net, max_batch=8, registry=reg)
            geng = gen.GenerationEngine(lm, slots=4, page_size=4,
                                        max_context=64, max_queue=64,
                                        deadline_s=30.0, registry=reg,
                                        prefill_buckets=(16,),
                                        prefix_cache=True)
            kw = {"device": "cpu"} if impl == "torch" else {}
            server = stream.InferenceServer(engine=eng, generation=geng,
                                            access_log=True, **kw)
            eng.start()
            started.append(eng)
            geng.start()
            started.append(geng)
            port = server.start()
            started.append(server)
            out[impl] = (server, f"http://127.0.0.1:{port}")
        yield out
    finally:
        for obj in reversed(started):
            obj.stop()
        metrics.set_registry(old[0])
        jax_metrics.set_registry(old[1])


# --------------------------------------------------------------------- serde
_ARRAYS = {
    "f32_3d": np.random.RandomState(0).rand(3, 4, 5).astype(np.float32),
    "f64": np.random.RandomState(1).randn(2, 3),
    "i32": np.arange(12, dtype=np.int32).reshape(3, 4),
    "f16_row": np.linspace(-1, 1, 7).astype(np.float16),
    "scalar": np.float32(2.5),
}


@pytest.mark.parametrize("name", sorted(_ARRAYS))
def test_array_envelope_is_byte_equal(name):
    a = _ARRAYS[name]
    env = array_to_base64(a)
    assert json.dumps(env) == json.dumps(jax_streaming.array_to_base64(a))
    back = base64_to_array(env)          # float64 travels as float32
    np.testing.assert_array_equal(back, np.asarray(a).astype(back.dtype))


@pytest.mark.parametrize("masks", ["none", "labels", "both"])
def test_dataset_envelope_is_byte_equal(masks):
    rs = np.random.RandomState(2)
    arrays = dict(features=rs.rand(2, 3).astype(np.float32),
                  labels=rs.rand(2, 1).astype(np.float32))
    if masks in ("labels", "both"):
        arrays["labels_mask"] = np.array([1.0, 0.0], np.float32)
    if masks == "both":
        arrays["features_mask"] = np.array([1.0, 1.0], np.float32)
    msg = dataset_to_json(DataSet(**arrays), meta={"ts": 1.0})
    assert msg == jax_streaming.dataset_to_json(JaxDataSet(**arrays),
                                                meta={"ts": 1.0})
    back = dataset_from_json(msg)
    np.testing.assert_array_equal(back.features, arrays["features"])
    assert (back.labels_mask is None) == ("labels_mask" not in arrays)
    got, meta = consume_dataset_json(msg)
    np.testing.assert_array_equal(got.labels, arrays["labels"])
    assert meta == {"ts": 1.0}


def _bad_records():
    """(name, message) of the reference's rejected records."""
    ds = DataSet(np.ones((2, 3), np.float32), np.zeros((2, 2), np.float32))
    msg = dataset_to_json(ds)
    out = []
    obj = json.loads(msg)
    data = obj["features"]["data"]
    i = next(idx for idx, c in enumerate(data) if c.islower())
    obj["features"]["data"] = (data[:i] + chr(ord(data[i]) ^ 0x60)
                               + data[i + 1:])
    out.append(("bit_flip", json.dumps(obj)))
    out.append(("nan", dataset_to_json(DataSet(
        np.full((1, 3), np.nan, np.float32), np.zeros((1, 2), np.float32)))))
    obj = json.loads(msg)
    obj["features"]["shape"] = [5, 7]
    out.append(("shape_lie", json.dumps(obj)))
    import base64 as b64
    obj = json.loads(msg)
    obj["features"] = {"shape": [], "dtype": "float32", "data": b64.b64encode(
        np.float32(1.0).tobytes()).decode()}
    out.append(("zero_d", json.dumps(obj)))
    obj = json.loads(msg)
    obj["features"]["dtype"] = "float64"
    out.append(("dtype_lie", json.dumps(obj)))
    obj = json.loads(msg)
    del obj["labels"]
    out.append(("no_labels", json.dumps(obj)))
    out.append(("not_json", "{{{not json"))
    obj = json.loads(dataset_to_json(
        DataSet(np.ones((3, 2), np.float32), np.zeros((3, 2), np.float32))))
    obj["labels"] = json.loads(msg)["labels"]
    out.append(("rows", json.dumps(obj)))
    masked = DataSet(np.ones((2, 3), np.float32),
                     np.zeros((2, 2), np.float32),
                     labels_mask=np.ones((2,), np.float32))
    obj = json.loads(dataset_to_json(masked))
    obj["labels_mask"] = json.loads(dataset_to_json(DataSet(
        np.ones((5, 1), np.float32),
        np.zeros((5, 1), np.float32))))["features"]
    out.append(("mask_lie", json.dumps(obj)))
    return out


@pytest.mark.parametrize("name,msg", _bad_records(),
                         ids=[n for n, _ in _bad_records()])
def test_bad_records_are_rejected_alike(name, msg):
    reasons = []
    for consume, err in ((consume_dataset_json, BadRecordError),
                         (jax_streaming.consume_dataset_json,
                          jax_streaming.BadRecordError)):
        with pytest.raises(err) as ei:
            consume(msg)
        reasons.append(ei.value.reason)
    assert reasons[0] == reasons[1]


@pytest.mark.parametrize("record,kw,match", [
    ([1.0, 2.0, 0.0], {"label_index": 2}, "num_classes"),
    ([1.0, 2.0, 9.0], {"label_index": 2, "num_classes": 3}, "outside")])
def test_record_to_dataset_validation(record, kw, match):
    from deeplearning4j_tpu.streaming.serde import (
        record_to_dataset as jax_record,
    )

    for fn in (record_to_dataset, jax_record):
        with pytest.raises(ValueError, match=match):
            fn(record, **kw)
    ok = record_to_dataset([1.0, 2.0, 1.0], label_index=2, num_classes=3)
    ref = jax_record([1.0, 2.0, 1.0], label_index=2, num_classes=3)
    np.testing.assert_array_equal(ok.labels, ref.labels)
    np.testing.assert_array_equal(ok.features, ref.features)


# -------------------------------------------------------------------- pubsub
def test_pubsub_local():
    broker = MessageBroker()
    consumer = NDArrayConsumer("t1", broker=broker)
    publisher = NDArrayPublisher("t1", broker=broker)
    arr = np.arange(6, dtype=np.float32).reshape(2, 3)
    publisher.publish(arr)
    np.testing.assert_array_equal(consumer.poll(timeout=2), arr)
    assert consumer.poll(timeout=0.05) is None


def test_pubsub_http():
    broker = MessageBroker()
    port = broker.serve()
    try:
        url = f"http://127.0.0.1:{port}"
        pub = NDArrayPublisher("t2", url=url)
        arr = np.array([[1.5, -2.0]], np.float32)
        consumer = NDArrayConsumer("t2", url=url, sub_id="a")
        assert consumer.poll(timeout=0.2) is None     # registers
        results = []
        t = threading.Thread(
            target=lambda: results.append(consumer.poll(timeout=3)))
        t.start()
        pub.publish(arr)
        t.join(timeout=5)
    finally:
        broker.stop()
    assert results and results[0] is not None
    np.testing.assert_array_equal(results[0], arr)


def test_publish_never_blocks_on_slow_consumer():
    broker = MessageBroker(queue_size=4)
    q = broker.subscribe("slow")
    for i in range(20):
        broker.publish("slow", str(i))
    got = [q.get_nowait() for _ in range(q.qsize())]
    assert got[-1] == "19" and len(got) == 4


def test_publish_counts_dropped_messages_per_topic():
    reg = metrics.MetricsRegistry()
    broker = MessageBroker(queue_size=2, registry=reg)
    q = broker.subscribe("hot")
    other = broker.subscribe("cold")
    for i in range(5):
        broker.publish("hot", str(i))
    broker.publish("cold", "x")
    assert [q.get_nowait() for _ in range(2)] == ["3", "4"]
    assert reg.get_value("dl4j_stream_dropped_total", topic="hot") == 3
    assert reg.get_value("dl4j_stream_dropped_total", topic="cold") is None
    assert other.get_nowait() == "x"


# ------------------------------------------------------------ the server
@pytest.mark.parametrize("body", ["envelope", "list"])
def test_predict_matches_jax_server(servers, body):
    x = np.random.RandomState(3).randn(5, 64).astype(np.float32)
    payload = array_to_base64(x) if body == "envelope" else x.tolist()
    outs = {}
    for impl, (_, url) in servers.items():
        status, raw, _ = _http(f"{url}/predict", payload,
                               {"X-Request-Id": f"req-{impl}"})
        assert status == 200, raw
        obj = json.loads(raw)
        assert obj["trace_id"] == f"req-{impl}"
        outs[impl] = base64_to_array(obj)
    assert outs["torch"].shape == (5, 10)
    np.testing.assert_allclose(outs["torch"], outs["jax"], atol=1e-5)


@pytest.mark.parametrize("stream", [False, True], ids=["plain", "sse"])
def test_generate_ids_match_jax_server(servers, stream):
    rs = np.random.RandomState(4)
    prompts = [rs.randint(0, VOCAB, size=n).tolist() for n in (3, 6, 9)]
    got = {}
    for impl, (_, url) in servers.items():
        got[impl] = []
        for p in prompts:
            status, raw, headers = _http(
                f"{url}/generate", {"prompt": p, "max_tokens": 12,
                                    "stream": stream})
            assert status == 200, raw
            if stream:
                assert headers["Content-Type"] == "text/event-stream"
                events = _sse(raw)
                assert events[-1]["done"] is True
                toks = [e["token"] for e in events[:-1]]
                assert [e["index"] for e in events[:-1]] == list(
                    range(len(toks)))
                assert events[-1]["tokens"] == len(toks)
            else:
                obj = json.loads(raw)
                toks = obj["tokens"]
                assert obj["finish_reason"] == "length"
            got[impl].append(toks)
    assert got["torch"] == got["jax"]
    assert all(len(t) == 12 for t in got["torch"])


def _error_cases():
    return {
        "predict_bad_json": ("/predict", b"{not json", 400),
        "predict_nan": ("/predict", [[float("nan")] * 64], 400),
        "predict_bad_envelope": ("/predict", {"data": "@@", "shape": [1, 64],
                                              "dtype": "float32"}, 400),
        "generate_no_prompt": ("/generate", {"max_tokens": 3}, 400),
        "generate_too_long": ("/generate", {"prompt": [1] * 200}, 400),
        "swap_no_path": ("/models/default", {"nope": 1}, 400),
        "swap_bad_file": ("/models/default", {"path": "/no/such.zip"}, 400),
        "rollback_unknown": ("/models/nothing/rollback", {}, 400),
        "unpin_unknown": ("/generation/unpin", {"pin_id": 123456}, 400),
        "unknown_post": ("/nowhere", {}, 404),
    }


@pytest.mark.parametrize("case", sorted(_error_cases()))
def test_error_bodies_and_statuses_match(servers, case):
    path, body, want = _error_cases()[case]
    seen = {}
    for impl, (_, url) in servers.items():
        status, raw, _ = _http(f"{url}{path}", body,
                               {"X-Request-Id": "err-1"})
        assert status == want, (impl, raw)
        seen[impl] = raw
    if want != 404:
        bodies = {k: json.loads(v) for k, v in seen.items()}
        assert set(bodies["torch"]) == set(bodies["jax"])
        assert bodies["torch"]["type"] == bodies["jax"]["type"]
        if "trace_id" in bodies["jax"]:
            assert bodies["torch"]["trace_id"] == "err-1"


class _SlowModel:
    """A model stub whose forward takes ``delay`` seconds."""

    def __init__(self, delay):
        self.delay = delay

    def output(self, x):
        time.sleep(self.delay)
        return np.asarray(x)[:, :4]


def _status_of(impl, make_engine, act, **server_kw):
    """(status, body) of ``act(url)`` on a server over a fresh engine of
    ``impl``, stopped afterwards."""
    srv, _, stream = SERVE[impl]
    eng = make_engine(srv)
    server = stream.InferenceServer(engine=eng, **server_kw)
    try:
        port = server.start()
        return act(eng, f"http://127.0.0.1:{port}")
    finally:
        server.stop()
        eng.stop(drain=False)


def _shed(eng, url):
    results = []

    def hit():
        results.append(_http(f"{url}/predict", [[0.0] * 4]))

    threads = [threading.Thread(target=hit) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    shed = [r for r in results if r[0] == 429]
    assert shed and any(r[0] == 200 for r in results)
    return 429, json.loads(shed[0][1])


def _deadline(eng, url):
    blocker = threading.Thread(
        target=lambda: _http(f"{url}/predict", [[0.0] * 4]))
    blocker.start()
    time.sleep(0.05)
    status, raw, _ = _http(f"{url}/predict", [[0.0] * 4])
    blocker.join(timeout=30)
    return status, json.loads(raw)


def _stopped(eng, url):
    eng.stop()
    status, raw, _ = _http(f"{url}/predict", [[0.0] * 4])
    return status, json.loads(raw)


def _no_generation(eng, url):
    status, raw, _ = _http(f"{url}/generation/cache")
    return status, json.loads(raw)


@pytest.mark.parametrize("case", ["429", "503", "504", "404"])
def test_admission_statuses_match(case):
    def engine(srv):
        kw = dict(max_batch=1, max_wait_ms=0.0,
                  policy=srv.BucketPolicy(max_batch=1))
        if case == "429":
            eng = srv.ServingEngine(_SlowModel(0.25), max_queue=2, **kw)
        elif case == "504":
            eng = srv.ServingEngine(_SlowModel(0.5), deadline_s=0.1, **kw)
        else:
            eng = srv.ServingEngine(_SlowModel(0.0), **kw)
        eng.start(warmup=False)
        return eng

    act = {"429": _shed, "503": _stopped, "504": _deadline,
           "404": _no_generation}[case]
    got = {impl: _status_of(impl, engine, act) for impl in SERVE}
    assert got["torch"][0] == got["jax"][0] == int(case)
    assert set(got["torch"][1]) == set(got["jax"][1])
    assert got["torch"][1]["type"] == got["jax"][1]["type"]


def _families(text):
    """{family: set of label names} of a Prometheus scrape."""
    fams = {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            fams.setdefault(line.split()[2], set())
        elif line and not line.startswith("#"):
            name = line.split("{")[0].split()[0]
            labels = set()
            if "{" in line:
                inner = line[line.index("{") + 1:line.rindex("}")]
                labels = {kv.split("=")[0] for kv in inner.split(",") if kv}
            for suffix in ("_bucket", "_sum", "_count"):
                if name.endswith(suffix) and name[:-len(suffix)] in fams:
                    name = name[:-len(suffix)]
                    labels.discard("le")
            fams.setdefault(name, set()).update(labels)
    return fams


def test_metrics_show_the_jax_servers_families(servers):
    for _, url in servers.values():            # some traffic on each
        _http(f"{url}/predict", [[0.1] * 64])
        _http(f"{url}/generate", {"prompt": [1, 2, 3], "max_tokens": 2})
    fams = {}
    for impl, (_, url) in servers.items():
        status, raw, headers = _http(f"{url}/metrics")
        assert status == 200
        assert headers["Content-Type"].startswith("text/plain")
        fams[impl] = _families(raw.decode())
    served = {f: l for f, l in fams["jax"].items()
              if f.startswith(("dl4j_serving_", "dl4j_generation_"))}
    assert served
    for fam, labels in served.items():
        assert fam in fams["torch"], fam
        assert labels <= fams["torch"][fam] | {"fn"}, fam


def test_health_models_and_cache_endpoints(servers):
    answers = {}
    for impl, (_, url) in servers.items():
        got = {}
        for path in ("/healthz", "/health", "/models", "/generation/cache"):
            status, raw, _ = _http(f"{url}{path}")
            assert status == 200, (impl, path, raw)
            got[path] = json.loads(raw)
        status, raw, _ = _http(f"{url}/generation/pin",
                               {"prompt": [1, 2, 3, 4, 5, 6, 7, 8]})
        assert status == 200
        pin = json.loads(raw)["pin_id"]
        status, raw, _ = _http(f"{url}/generation/unpin", {"pin_id": pin})
        assert status == 200 and json.loads(raw)["ok"] is True
        answers[impl] = got
    t, j = answers["torch"], answers["jax"]
    assert t["/healthz"] == j["/healthz"] == {"status": "ok",
                                              "dispatcher_alive": True}
    assert t["/health"]["healthy"] is True
    assert ({r["name"] for r in t["/health"]["rules"]}
            == {r["name"] for r in j["/health"]["rules"]})
    assert set(t["/models"]) == set(j["/models"])
    assert set(t["/generation/cache"]) == set(j["/generation/cache"])


def test_hot_swap_and_rollback_under_load(models, tmp_path):
    """``POST /models/default`` (retaining the old version) and
    ``POST /models/default/rollback`` while four clients post: every
    request answers 200 with the output of one of the two versions."""
    base, other = models["mlp"][1], models["mlp2"][1]
    x = np.random.RandomState(5).randn(3, 64).astype(np.float32)
    want = [base.output(x).numpy(), other.output(x).numpy()]
    eng = port_serving.ServingEngine(base, max_batch=8)
    server = port_streaming.InferenceServer(engine=eng, device="cpu")
    stop = threading.Event()
    results = []

    def client():
        while not stop.is_set():
            status, raw, _ = _http(f"{url}/predict", array_to_base64(x))
            results.append((status, raw))

    eng.start()
    try:
        url = f"http://127.0.0.1:{server.start()}"
        threads = [threading.Thread(target=client) for _ in range(4)]
        for t in threads:
            t.start()
        time.sleep(0.2)
        status, raw, _ = _http(f"{url}/models/default",
                               {"path": str(models["mlp2"][2]),
                                "retain_old": True})
        assert status == 200, raw
        assert json.loads(raw)["state"] == "active"
        time.sleep(0.2)
        status, raw, _ = _http(f"{url}/models/default/rollback", {})
        assert status == 200, raw
        time.sleep(0.2)
        stop.set()
        for t in threads:
            t.join(timeout=30)
        after = base64_to_array(json.loads(
            _http(f"{url}/predict", array_to_base64(x))[1]))
    finally:
        stop.set()
        server.stop()
        eng.stop()
    assert results and all(s == 200 for s, _ in results)
    for _, raw in results:
        out = base64_to_array(json.loads(raw))
        assert any(np.allclose(out, w, atol=1e-5) for w in want)
    np.testing.assert_allclose(after, want[0], atol=1e-5)


# ----------------------------------------------------------------- pipelines
def _small_port_net():
    from deeplearning4j_tpu_torch.models.sequential import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.conf import (
        NeuralNetConfiguration as PortNNC,
    )
    from deeplearning4j_tpu_torch.nn.layers import (
        DenseLayer as PDense, OutputLayer as POut,
    )

    conf = (PortNNC.builder().seed(7).updater("sgd", learning_rate=0.5)
            .list()
            .layer(PDense(n_in=2, n_out=8, activation="tanh"))
            .layer(POut(n_in=8, n_out=2, loss="mcxent",
                        activation="softmax"))
            .build())
    return MultiLayerNetwork(conf).init(device="cpu")


def test_streaming_pipeline_trains():
    net = _small_port_net()
    broker = MessageBroker()
    pipe = StreamingPipeline(net, broker, "records", label_index=2,
                             num_classes=2, batch_size=4)
    rs = np.random.RandomState(0)
    for _ in range(8):
        a, b = rs.rand(2)
        broker.publish("records", json.dumps([a, b, int(a + b > 1)]))
    pipe.run(max_batches=2, timeout=0.2)
    assert pipe.batches_trained == 2
    assert net.iteration == 2 and np.isfinite(net.score_value)


def test_serving_pipeline_round_trip():
    net = _small_port_net()
    broker = MessageBroker()
    out_q = broker.subscribe("preds")
    pipe = ServingPipeline(net, broker, "features", "preds")
    broker.publish("features", json.dumps([0.2, 0.7]))
    try:
        pipe.run(max_messages=1, timeout=1.0)
    finally:
        pipe.stop()
    pred = base64_to_array(json.loads(out_q.get(timeout=2)))
    np.testing.assert_allclose(
        pred, net.output(np.array([[0.2, 0.7]], np.float32)).numpy(),
        atol=1e-6)


def test_swap_of_a_graph_model_warms_on_the_served_rows(tmp_path):
    """``POST /models/<name>`` carries no example row, and a graph
    model's row shape cannot be read from its config: the incoming
    version warms on the example of the version it replaces, one
    capture-or-compile a bucket before the flip, and serves its rows."""
    from deeplearning4j_tpu_torch.models import zoo

    tiny = dict(height=16, width=16, channels=3, n_classes=4,
                blocks=(1, 1), stem_stride=1, init_channels=8,
                device="cpu")
    net, other = zoo.resnet50(**tiny), zoo.resnet50(**tiny, seed=99)
    other.save(tmp_path / "v2.zip", save_updater=False)
    eng = port_serving.ServingEngine(net, max_batch=4,
                                     example=np.zeros((16, 16, 3),
                                                      np.float32))
    server = port_streaming.InferenceServer(engine=eng, device="cpu")
    x = np.random.RandomState(6).rand(3, 16, 16, 3).astype(np.float32)
    eng.start()
    try:
        url = f"http://127.0.0.1:{server.start()}"
        status, raw, _ = _http(f"{url}/models/default",
                               {"path": str(tmp_path / "v2.zip")})
        assert status == 200, raw
        mv = eng.models.active("default")
        assert mv.version == 2
        assert mv.detector.compile_count == len(eng.policy.batch_buckets)
        status, raw, _ = _http(f"{url}/predict", array_to_base64(x))
        assert status == 200
        np.testing.assert_allclose(base64_to_array(json.loads(raw)),
                                   other.output(x).numpy(), atol=1e-5)
    finally:
        server.stop()
        eng.stop()
