"""Subprocess replica entry point: ``python -m deeplearning4j_tpu_torch.fleet.replica_main``.

One fleet replica = one process: a deterministic ``transformer_char_lm``
(same args + seed across the fleet → identical weights, drawn from a CPU
generator, so any replica can serve any request) behind a prefix-cached
``GenerationEngine``, HTTP-fronted by ``InferenceServer`` (which gets
the ``replica_id`` it echoes in every envelope and access line), with a
``fleet_publisher`` streaming snapshots to the fleet broker — the
liveness/health/load/cache-version feed the router's membership is
gated on.  Spawned and restarted by ``fleet.supervisor``; a restart is
a fresh process and therefore a fresh publisher epoch, which the fleet
aggregator re-bases exactly and the router reads as a rejoin.

Port of ``deeplearning4j_tpu/fleet/replica_main.py``.  The model and
the engine live on ``--device`` (``cuda`` unless ``--device cpu`` is
given; without a GPU the default raises), in ``--compute-dtype`` when
one is given.  On the card the engine captures its decode and prefill
graphs at start, before ``/healthz`` answers, so a replica takes no
traffic before its graphs exist.
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="deeplearning4j_tpu_torch fleet replica")
    ap.add_argument("--worker-id", required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--broker-url", default=None,
                    help="fleet pubsub broker base url (no publishing "
                    "when omitted)")
    ap.add_argument("--topic", default="fleet.telemetry")
    ap.add_argument("--interval-s", type=float, default=0.5)
    ap.add_argument("--vocab", type=int, default=77)
    ap.add_argument("--d-model", type=int, default=64)
    ap.add_argument("--n-heads", type=int, default=4)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--model-seed", type=int, default=12345)
    ap.add_argument("--compute-dtype", default=None,
                    help="bfloat16, float16 or float32 (the zoo default "
                    "when omitted)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--max-context", type=int, default=96)
    ap.add_argument("--max-queue", type=int, default=64)
    ap.add_argument("--deadline-s", type=float, default=60.0)
    ap.add_argument("--prefill-buckets", default="16",
                    help="comma-separated prompt buckets")
    ap.add_argument("--step-floor-ms", type=float, default=0.0,
                    help="decode_step_floor_s pacing in ms (0 = off)")
    args = ap.parse_args(argv)

    # imports AFTER argparse: --help must not pay for torch
    from deeplearning4j_tpu_torch.generation.engine import GenerationEngine
    from deeplearning4j_tpu_torch.models.sequential import MultiLayerNetwork
    from deeplearning4j_tpu_torch.models.zoo import transformer_char_lm
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.streaming.serving import InferenceServer

    lm = transformer_char_lm(
        vocab_size=args.vocab, d_model=args.d_model, n_heads=args.n_heads,
        layers=args.layers, max_cache=args.max_context,
        seed=args.model_seed, compute_dtype=args.compute_dtype,
        device=args.device)
    buckets = tuple(int(b) for b in args.prefill_buckets.split(","))
    engine = GenerationEngine(
        lm, slots=args.slots, page_size=args.page_size,
        max_context=args.max_context, max_queue=args.max_queue,
        deadline_s=args.deadline_s, prefill_buckets=buckets,
        prefix_cache=True,
        decode_step_floor_s=args.step_floor_ms / 1e3).start()

    # the server needs a predict net too; a 2-layer MLP keeps /predict
    # alive without costing warmup time
    conf = (NeuralNetConfiguration.builder().seed(1)
            .updater("sgd", learning_rate=0.1).list()
            .layer(DenseLayer(n_in=4, n_out=8, activation="relu"))
            .layer(OutputLayer(n_in=8, n_out=3, loss="mcxent",
                               activation="softmax")).build())
    pred = MultiLayerNetwork(conf).init(device=args.device)
    srv = InferenceServer(pred, generation=engine, access_log=True,
                          port=args.port, replica_id=args.worker_id,
                          device=args.device)
    port = srv.start()

    pub = None
    if args.broker_url:
        # the serving health rules read the predict engine as extra=
        # (exactly what GET /health passes); the publisher calls bare
        # evaluate(), so bind the extra here
        class _Health:
            def evaluate(self):
                return srv.health.evaluate(extra=srv.engine)

        # the scheduler state the router reads, and the kernel launches
        # the serving graphs' replays made (host counts)
        pub = engine.fleet_publisher(
            args.worker_id, url=args.broker_url, topic=args.topic,
            interval_s=args.interval_s, health=_Health(),
            state_fn=lambda: {
                "scheduler": engine.scheduler.as_dict(),
                "replayed_launches": engine.programs.replayed_launches()})
        pub.start()

    stop = threading.Event()

    def _term(signum, frame):
        stop.set()

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)
    # readiness marker AFTER engine warmup + server bind: the supervisor
    # treats a 200 /healthz as the warmup barrier, this line is for logs
    print(f"replica {args.worker_id} serving on :{port}", flush=True)
    stop.wait()
    if pub is not None:
        pub.stop()
    srv.stop()
    engine.stop(drain=False)
    return 0


if __name__ == "__main__":
    sys.exit(main())
