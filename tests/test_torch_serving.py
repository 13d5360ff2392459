"""The port's batch ``ServingEngine`` (``deeplearning4j_tpu_torch/serving/``)
against the JAX package's on the CPU.

- ``predict`` equals the JAX ``ServingEngine``'s on bench_serving's MLP
  (64 -> 256 -> 256 -> 10, ``bench.py:1076-1085``) restored from one zip
  checkpoint, within atol 1e-5 (float32).
- The bucket policy (both packages), the batch-bucket padding and the
  seq-bucket padding are sliced off.
- The typed errors: 429 (queue full), 404 (unknown model), 503 (stopped),
  504 (deadline, in the queue and with a dead dispatcher); drain on stop.
- ``deploy``, ``rollback``, ``commit_swap`` and the canary under load
  drop no request; a checkpoint deploy pins the manifest's version.
- ``dl4j_compiles_total{fn="serving.default"}`` counts one compile a
  bucket at warm-up and does not move after it.
"""

import threading
import time

import numpy as np
import pytest

from deeplearning4j_tpu import serving as jax_serving
from deeplearning4j_tpu.models import serialization as jax_serialization
from deeplearning4j_tpu.models.sequential import (
    MultiLayerNetwork as JaxMultiLayerNetwork,
)
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu.observability import metrics as jax_metrics
from deeplearning4j_tpu_torch import serving as port_serving
from deeplearning4j_tpu_torch.models import serialization
from deeplearning4j_tpu_torch.observability import metrics
from deeplearning4j_tpu_torch.serving import (
    BucketPolicy, DeadlineExceededError, ModelNotFoundError, QueueFullError,
    ServingEngine, ShuttingDownError,
)

IMPLS = {"jax": jax_serving, "torch": port_serving}


@pytest.fixture(autouse=True)
def fresh_registry():
    """A fresh process registry in both packages; the port's is yielded."""
    old = metrics.get_registry(), jax_metrics.get_registry()
    reg = metrics.set_registry(metrics.MetricsRegistry())
    jax_metrics.set_registry(jax_metrics.MetricsRegistry())
    yield reg
    metrics.set_registry(old[0])
    jax_metrics.set_registry(old[1])


def _mlp(n_in, hidden, n_out, seed):
    b = (NeuralNetConfiguration.builder().seed(seed)
         .updater("sgd", learning_rate=0.1).list())
    for i, h in enumerate(hidden):
        b = b.layer(DenseLayer(n_in=n_in if i == 0 else hidden[i - 1],
                               n_out=h, activation="relu"))
    return JaxMultiLayerNetwork(
        b.layer(OutputLayer(n_in=hidden[-1], n_out=n_out, loss="mcxent",
                            activation="softmax")).build()).init()


def _zip(jnet, tmp_path_factory, name, **manifest):
    path = tmp_path_factory.mktemp("ckpt") / f"{name}.zip"
    jax_serialization.write_model(jnet, str(path),
                                  extra_manifest=manifest or None)
    return path


@pytest.fixture(scope="module")
def bench_mlp(tmp_path_factory):
    """bench_serving's MLP: (JAX net, port net) from one zip."""
    jnet = _mlp(64, (256, 256), 10, seed=12345)
    path = _zip(jnet, tmp_path_factory, "bench_mlp")
    return jnet, serialization.load_model(path, device="cpu")


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """Two small MLPs (4 -> 8 -> 3) of other seeds, port nets."""
    return [serialization.load_model(
        _zip(_mlp(4, (8,), 3, seed), tmp_path_factory, f"small{seed}"),
        device="cpu") for seed in (7, 99)]


def _out(net, x):
    return net.output(x).numpy()


class SlowModel:
    """Model stub with a tunable forward-pass duration (admission tests)."""

    def __init__(self, delay=0.2, width=4):
        self.delay = delay
        self.width = width
        self.calls = 0

    def output(self, x):
        self.calls += 1
        time.sleep(self.delay)
        return np.asarray(x)[:, : self.width]


# ------------------------------------------------------------ bucket policy
@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_bucket_policy(impl):
    P = IMPLS[impl].BucketPolicy
    p = P(max_batch=32)
    assert p.batch_buckets == (1, 2, 4, 8, 16, 32)
    assert [p.bucket_rows(r) for r in (1, 3, 5, 17, 32, 40)] == \
        [1, 4, 8, 32, 32, 32]
    p = P(max_batch=24)
    assert p.batch_buckets == (1, 2, 4, 8, 16, 24)
    assert P(max_batch=8, batch_buckets=(8,)).bucket_rows(1) == 8
    with pytest.raises(ValueError):
        P(max_batch=8, batch_buckets=(4,))
    p = P(max_batch=2, seq_buckets=(8, 16))
    assert p.bucket_seq(5) == 8 and p.bucket_seq(20) == 20
    assert p.warmup_shapes((8, 6)) == [(1, 8, 6), (2, 8, 6), (1, 16, 6),
                                       (2, 16, 6)]
    assert p.warmup_shapes((6,)) == [(1, 6), (2, 6)]


# ---------------------------------------------------------------- parity
def test_predict_equals_the_jax_engine_on_bench_mlp(bench_mlp):
    """bench_serving's traffic shape (1-16 rows a request, mixed) through
    both engines: the same probabilities within atol 1e-5."""
    jnet, pnet = bench_mlp
    example = np.zeros((64,), np.float32)
    jeng = jax_serving.ServingEngine(jnet, max_batch=64, max_wait_ms=1.0,
                                     example=example).start()
    peng = ServingEngine(pnet, max_batch=64, max_wait_ms=1.0,
                         example=example).start()
    try:
        rs = np.random.RandomState(1000)
        for rows in 1 + rs.randint(16, size=12):
            x = rs.rand(int(rows), 64).astype(np.float32)
            want = np.asarray(jeng.predict(x))
            got = peng.predict(x)
            assert got.shape == want.shape == (rows, 10)
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    finally:
        jeng.stop()
        peng.stop()


def test_warmup_then_zero_steady_state_compiles(small, fresh_registry):
    """Warm-up counts one compile a bucket (planned: no recompile);
    mixed-size traffic, oversized requests chunked, compiles nothing."""
    net = small[0]
    eng = ServingEngine(net, max_batch=8, max_wait_ms=1.0,
                        example=np.zeros((4,), np.float32)).start()
    try:
        compiles = fresh_registry.get_value("dl4j_compiles_total",
                                            fn="serving.default")
        assert compiles == 4               # buckets 1, 2, 4, 8
        assert fresh_registry.get_value("dl4j_recompiles_total",
                                        fn="serving.default") in (None, 0)
        rs = np.random.RandomState(0)
        for rows in (1, 2, 3, 5, 8, 11, 19):
            x = rs.rand(rows, 4).astype(np.float32)
            out = eng.predict(x)
            assert out.shape == (rows, 3)  # the bucket's padding sliced
            np.testing.assert_allclose(out, _out(net, x), rtol=1e-5,
                                       atol=1e-6)
        assert fresh_registry.get_value(
            "dl4j_compiles_total", fn="serving.default") == compiles
        mv = eng.models.active("default")
        assert mv.detector.compile_count == 4
    finally:
        eng.stop()
    util = fresh_registry.get("dl4j_serving_bucket_utilization").get()
    assert util is not None and util.count > 0


def test_seq_bucketing_pads_time_axis_and_slices_output():
    from deeplearning4j_tpu_torch.models.zoo import graves_lstm_char_lm

    vocab = 6
    net = graves_lstm_char_lm(vocab_size=vocab, hidden=8, layers=1,
                              tbptt=16, device="cpu")
    policy = BucketPolicy(max_batch=2, seq_buckets=(8, 16))
    eng = ServingEngine(net, policy=policy, max_wait_ms=1.0,
                        example=np.zeros((8, vocab), np.float32)).start()
    try:
        mv = eng.models.active("default")
        assert mv.detector.compile_count == 2 * 2
        x = np.random.RandomState(0).rand(1, 5, vocab).astype(np.float32)
        out = eng.predict(x)
        assert out.shape == (1, 5, vocab)
        # causal model: padded future steps cannot alter the real prefix
        np.testing.assert_allclose(out, _out(net, x), rtol=1e-4, atol=1e-5)
        assert mv.detector.compile_count == 4
    finally:
        eng.stop()


def test_concurrent_mixed_size_requests_deinterleave(small, fresh_registry):
    net = small[0]
    eng = ServingEngine(net, max_batch=16, max_wait_ms=2.0, max_queue=512,
                        example=np.zeros((4,), np.float32)).start()
    n_threads, per_thread = 8, 6
    errors, checked = [], [0]
    lock = threading.Lock()

    def client(tid):
        rs = np.random.RandomState(tid)
        for i in range(per_thread):
            x = rs.rand(1 + rs.randint(9), 4).astype(np.float32)
            try:
                np.testing.assert_allclose(eng.predict(x), _out(net, x),
                                           rtol=1e-5, atol=1e-6)
                with lock:
                    checked[0] += 1
            except Exception as e:
                with lock:
                    errors.append(f"t{tid}r{i}: {e!r}")

    threads = [threading.Thread(target=client, args=(t,))
               for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    eng.stop()
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:3]
    assert checked[0] == n_threads * per_thread
    assert fresh_registry.get_value("dl4j_serving_requests_total",
                                    status="ok") == n_threads * per_thread
    assert fresh_registry.get("dl4j_serving_batch_rows").get().count \
        < n_threads * per_thread


# -------------------------------------------------------------- admission
def test_queue_budget_sheds_429(fresh_registry):
    eng = ServingEngine(SlowModel(delay=0.25), max_batch=1, max_queue=2,
                        max_wait_ms=0.0)
    eng.start(warmup=False)
    results = [None] * 8

    def hit(i):
        try:
            results[i] = ("ok", eng.predict(np.zeros((1, 4), np.float32)))
        except QueueFullError as e:
            results[i] = ("shed", e)
        except Exception as e:
            results[i] = ("err", e)

    threads = [threading.Thread(target=hit, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    eng.stop()
    kinds = [r and r[0] for r in results]
    assert None not in kinds, "a shed request hung its waiter"
    assert "shed" in kinds and "ok" in kinds and "err" not in kinds
    assert all(r[1].http_status == 429 for r in results if r[0] == "shed")
    assert fresh_registry.get_value("dl4j_serving_shed_total",
                                    reason="queue_full") == kinds.count("shed")


def test_typed_errors_404_503_504(small, fresh_registry):
    dead = ServingEngine(SlowModel(delay=0.0), max_batch=2)
    with pytest.raises(DeadlineExceededError, match="dispatcher dead") as e:
        dead.predict(np.zeros((1, 4), np.float32), deadline_s=0.3)
    assert e.value.http_status == 504
    model = SlowModel(delay=0.4)
    eng = ServingEngine(model, max_batch=1, max_queue=16, max_wait_ms=0.0)
    eng.start(warmup=False)
    try:
        blocker = threading.Thread(
            target=lambda: eng.predict(np.zeros((1, 4), np.float32)))
        blocker.start()
        time.sleep(0.05)
        with pytest.raises(DeadlineExceededError):
            eng.predict(np.zeros((1, 4), np.float32), deadline_s=0.1)
        blocker.join(timeout=10)
        assert not blocker.is_alive()
        assert model.calls == 1  # the expired request never ran
        with pytest.raises(ModelNotFoundError) as e:
            eng.predict(np.zeros((1, 4), np.float32), model="nope")
        assert e.value.http_status == 404
    finally:
        eng.stop()
    with pytest.raises(ShuttingDownError) as e:
        eng.predict(np.zeros((1, 4), np.float32))
    assert e.value.http_status == 503


@pytest.mark.parametrize("drain", [True, False])
def test_stop_drains_or_fails_waiters(drain):
    eng = ServingEngine(SlowModel(delay=0.05 if drain else 0.3),
                        max_batch=1, max_queue=32,
                        max_wait_ms=50.0 if drain else 0.0)
    eng.start(warmup=False)
    results = [None] * 4

    def hit(i):
        try:
            results[i] = ("ok", eng.predict(np.zeros((1, 4), np.float32)))
        except ShuttingDownError as e:
            results[i] = ("shutdown", e)
        except Exception as e:
            results[i] = ("err", e)

    threads = [threading.Thread(target=hit, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    time.sleep(0.03)
    eng.stop(drain=drain, timeout=10.0)
    for t in threads:
        t.join(timeout=30)
    kinds = [r and r[0] for r in results]
    assert None not in kinds, "a waiter hung on shutdown"
    if drain:
        assert kinds == ["ok"] * 4
    else:
        assert "shutdown" in kinds and "err" not in kinds


# ------------------------------------------------ swap / rollback / canary
def test_deploy_rollback_commit_under_load_zero_drops(small):
    """A retaining deploy, a rollback, a second deploy and its commit,
    all under concurrent load: every reply is exactly one version's
    output and none fails."""
    net_a, net_b = small
    probe = np.linspace(0.0, 1.0, 8, dtype=np.float32).reshape(2, 4)
    out_a, out_b = _out(net_a, probe), _out(net_b, probe)
    assert not np.allclose(out_a, out_b)
    example = np.zeros((4,), np.float32)
    eng = ServingEngine(net_a, max_batch=8, max_wait_ms=1.0,
                        example=example).start()
    stop_flag = threading.Event()
    failures, served = [], [0]
    lock = threading.Lock()

    def client():
        while not stop_flag.is_set():
            try:
                out = eng.predict(probe)
                if not (np.allclose(out, out_a, atol=1e-5)
                        or np.allclose(out, out_b, atol=1e-5)):
                    with lock:
                        failures.append("blended output")
                with lock:
                    served[0] += 1
            except Exception as e:
                with lock:
                    failures.append(repr(e))

    threads = [threading.Thread(target=client) for _ in range(4)]
    for t in threads:
        t.start()
    try:
        time.sleep(0.1)
        mv_b = eng.deploy("default", net_b, retain_old=True, example=example)
        retained = eng.models.retained("default")
        assert retained.version == 1 and retained.model is net_a
        time.sleep(0.1)
        assert eng.rollback("default").version == 1
        time.sleep(0.1)
        mv_c = eng.deploy("default", net_b, retain_old=True, example=example)
        time.sleep(0.1)
        released = eng.commit_swap("default")
        assert released.version == 1 and released.model is None
        time.sleep(0.1)
        stop_flag.set()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        assert not failures, failures[:3]
        assert served[0] > 20
        np.testing.assert_allclose(eng.predict(probe), out_b, rtol=1e-5,
                                   atol=1e-6)
        assert eng.models.active("default") is mv_c
        retired = eng.stats()["models"]["retired"]
        assert any(r["version"] == mv_b.version and r["state"] == "retired"
                   for r in retired)
        with pytest.raises(ModelNotFoundError):
            eng.rollback("default")    # window closed
        # the probe above was one more
        assert eng.status_counts("default") == {"ok": served[0] + 1}
    finally:
        stop_flag.set()
        eng.stop()


def test_canary_routes_fraction_and_tears_down(small):
    net_a, net_b = small
    probe = np.linspace(0.0, 1.0, 8, dtype=np.float32).reshape(2, 4)
    out_a = _out(net_a, probe)
    example = np.zeros((4,), np.float32)
    eng = ServingEngine(net_a, max_batch=8, max_wait_ms=1.0,
                        example=example).start()
    try:
        eng.start_canary("default", net_b, fraction=0.5, seed=11,
                         example=example)
        assert "default:canary" in eng.models.names()
        hits = {"a": 0, "b": 0}
        for _ in range(30):
            out = eng.predict(probe)
            hits["a" if np.allclose(out, out_a, atol=1e-5) else "b"] += 1
        assert hits["a"] > 0 and hits["b"] > 0, hits
        stats = eng.canary_stats("default")
        assert stats["requests"] == hits["b"] == stats["ok"]
        assert stats["bad"] == 0
        final = eng.stop_canary("default")
        assert final["requests"] == hits["b"]
        assert "default:canary" not in eng.models.names()
        for _ in range(5):
            np.testing.assert_allclose(eng.predict(probe), out_a,
                                       rtol=1e-5, atol=1e-6)
        assert eng.models.active("default").version == 1
    finally:
        eng.stop()


def test_deploy_from_checkpoint_pins_manifest_version(small,
                                                      tmp_path_factory):
    """A checkpoint deploy restores onto the device asked for and takes
    the manifest's ``serving_version``; a broken model's warm-up aborts
    the swap and the old version serves on."""
    path = _zip(_mlp(4, (8,), 3, 5), tmp_path_factory, "pinned",
                serving_version=7)
    example = np.zeros((4,), np.float32)
    eng = ServingEngine(small[0], max_batch=4, max_wait_ms=1.0,
                        example=example).start()
    try:
        mv = eng.deploy("default", path, example=example, device="cpu")
        assert mv.version == 7 and eng.models.active("default") is mv
        x = np.ones((3, 4), np.float32)
        np.testing.assert_allclose(eng.predict(x), _out(mv.model, x),
                                   rtol=1e-5, atol=1e-6)
        with pytest.raises(RuntimeError):     # torch's shape error
            eng.deploy("default", small[0],
                       example=np.zeros((5,), np.float32))
        assert eng.models.active("default") is mv
        assert eng.stats()["batch_buckets"] == [1, 2, 4]
    finally:
        eng.stop()


def test_request_breakdown_and_status_counts(small):
    eng = ServingEngine(small[0], max_batch=4, max_wait_ms=1.0,
                        example=np.zeros((4,), np.float32)).start()
    try:
        eng.predict(np.ones((3, 4), np.float32), trace_id="req-1")
        b = eng.request_breakdown("req-1")
        assert b["status"] == "ok" and b["batch_rows"] == 3
        assert b["bucket"] == 4 and b["execute_ms"] >= 0.0
        assert eng.status_counts("default") == {"ok": 1}
    finally:
        eng.stop()
