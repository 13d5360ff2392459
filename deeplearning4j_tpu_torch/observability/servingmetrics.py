"""Serving metric families — the one owner of their names/labels.

Copied from ``deeplearning4j_tpu/observability/servingmetrics.py`` with its
imports pointed at the port's own copies: the same family names, help
texts and labels, so both packages expose the same exposition.

The serving engine, the HTTP front-end, and the bench all record through
this bundle so the families can never be declared twice with diverging
label sets (the registry raises on that).  Names continue the first serving set
(``dl4j_serving_requests_total`` etc.) and add the engine-era families:
bucket utilization (how much of each dispatched tile was real rows),
shed counter by reason (queue_full / deadline / shutdown), model swap
counter, and AOT warmup timings.
"""

from __future__ import annotations

import itertools

from deeplearning4j_tpu_torch.observability.metrics import get_registry

_ENGINE_IDS = itertools.count()

_ROW_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)
_UTIL_BUCKETS = (0.0625, 0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0)


class ServingMetrics:
    """All serving families, plus this engine's per-instance gauge
    children (labeled ``server=`` with a process-unique id so a second
    engine neither clobbers nor zeroes the first's gauges)."""

    def __init__(self, registry=None, server_id: str = None):
        reg = registry if registry is not None else get_registry()
        self.registry = reg
        self.server_id = (server_id if server_id is not None
                          else f"s{next(_ENGINE_IDS)}")
        self.requests = reg.counter(
            "dl4j_serving_requests_total",
            "Predict requests by outcome", labels=("status",))
        self.latency = reg.histogram(
            "dl4j_serving_request_seconds",
            "End-to-end predict latency (enqueue -> response ready, "
            "including micro-batching wait)")
        self.queue_wait = reg.histogram(
            "dl4j_serving_queue_wait_seconds",
            "Time a request spent queued before its batch dispatched")
        self.request_rows = reg.histogram(
            "dl4j_serving_request_rows",
            "Rows per predict request", buckets=_ROW_BUCKETS)
        self.batch_rows = reg.histogram(
            "dl4j_serving_batch_rows",
            "Rows per dispatched micro-batch (padding excluded)",
            buckets=_ROW_BUCKETS)
        self.bucket_util = reg.histogram(
            "dl4j_serving_bucket_utilization",
            "Real rows / bucket rows per dispatched forward pass (1.0 = "
            "no padding FLOPs wasted)", buckets=_UTIL_BUCKETS)
        self.shed = reg.counter(
            "dl4j_serving_shed_total",
            "Requests shed by admission control, by reason",
            labels=("reason",))
        self.swaps = reg.counter(
            "dl4j_serving_model_swaps_total",
            "Completed model hot-swaps", labels=("model",))
        self.warmup_seconds = reg.histogram(
            "dl4j_serving_warmup_seconds",
            "Wall time of one model version's AOT bucket warmup")
        self.warmup_shapes = reg.gauge(
            "dl4j_serving_warmup_shapes",
            "Bucket shapes precompiled for the active version",
            labels=("model",))
        # per-instance children
        self.queue_depth = reg.gauge(
            "dl4j_serving_queue_depth",
            "Requests waiting for the micro-batch dispatcher",
            labels=("server",)).labels(server=self.server_id)
        self._max_batch_fam = reg.gauge(
            "dl4j_serving_max_batch",
            "Configured micro-batch row budget", labels=("server",))

    def set_max_batch(self, max_batch: int) -> None:
        self._max_batch_fam.set(max_batch, server=self.server_id)

    def bind_queue_depth(self, fn) -> None:
        """Live queue-depth gauge (the caller passes a weakref-safe
        callable so the registry never pins the engine)."""
        self.queue_depth.set_function(fn)

    def freeze_queue_depth(self) -> None:
        """Replace the live callback with 0 at engine stop (other engines'
        children are untouched)."""
        self.queue_depth.set(0.0)


_TTFT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                 1.0, 2.5, 5.0, 10.0)

# inter-token latency sits an order of magnitude below TTFT (one decode
# step vs queue+prefill), so the buckets start at the dispatch floor
_ITL_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                0.25, 0.5, 1.0, 2.5)


class GenerationMetrics:
    """Decode/continuous-batching families (``dl4j_decode_*``) — the one
    owner of their names/labels, same contract as ``ServingMetrics``.
    Per-instance gauges are labeled ``engine=`` with a process-unique id
    so a second generation engine neither clobbers nor zeroes the
    first's."""

    def __init__(self, registry=None, engine_id: str = None):
        reg = registry if registry is not None else get_registry()
        self.registry = reg
        self.engine_id = (engine_id if engine_id is not None
                          else f"g{next(_ENGINE_IDS)}")
        self.requests = reg.counter(
            "dl4j_decode_requests_total",
            "Generation requests by terminal outcome (length/stop = "
            "completed; cancelled/deadline/shutdown/error = not)",
            labels=("status",))
        self.tokens = reg.counter(
            "dl4j_decode_tokens_total",
            "Tokens generated and delivered to request streams",
            labels=("model",))
        self.steps = reg.counter(
            "dl4j_decode_steps_total",
            "Decode-step dispatches (one per running-batch iteration)")
        self.prefix_pages = reg.counter(
            "dl4j_decode_prefix_pages_total",
            "Prompt pages at admission by outcome: shared counts pages an "
            "identical prefix let the request reference instead of "
            "prefilling fresh — BOTH in-flight sharing (another running "
            "request owns the page) and persistent prefix-cache hits "
            "(the radix tree kept it alive past its last request) land "
            "here; dl4j_prefix_cache_* tells the two apart",
            labels=("outcome",))
        # persistent radix-tree prefix cache (generation/prefix_cache.py)
        self.prefix_cache_hits = reg.counter(
            "dl4j_prefix_cache_hits",
            "Admissions whose prompt matched >= 1 cached radix-tree page "
            "(prefill priced at the suffix instead of the whole prompt)")
        self.prefix_cache_misses = reg.counter(
            "dl4j_prefix_cache_misses",
            "Admissions that matched nothing in the radix tree")
        self.prefix_cache_offloads = reg.counter(
            "dl4j_prefix_cache_offload_total",
            "Cold cached pages spilled device -> host tier (page slice "
            "copied out, device page freed, prefix still cached)")
        self.prefix_cache_restores = reg.counter(
            "dl4j_prefix_cache_restore_total",
            "Host-tier pages restored into fresh device pages on a hit")
        self.prefix_cache_evictions = reg.counter(
            "dl4j_prefix_cache_evictions_total",
            "Radix-tree nodes dropped outright, by reason (capacity = "
            "device room with no host budget left, host_capacity = host "
            "tier over budget, swap = weights changed, pool_reset = "
            "pools reseeded, abort = admission's prefill failed)",
            labels=("reason",))
        self.ttft = reg.histogram(
            "dl4j_decode_ttft_seconds",
            "Time to first token: submit -> first sampled token delivered "
            "(queue wait + prefill)", buckets=_TTFT_BUCKETS)
        self.inter_token = reg.histogram(
            "dl4j_decode_inter_token_seconds",
            "Inter-token latency: gap between consecutive delivered "
            "tokens of one request (the streaming-smoothness half of the "
            "decode SLO; TTFT is the other)", buckets=_ITL_BUCKETS)
        self.shed = reg.counter(
            "dl4j_decode_shed_total",
            "Generation requests shed by admission control, by reason",
            labels=("reason",))
        self.evictions = reg.counter(
            "dl4j_decode_evicted_total",
            "Requests removed from the RUNNING batch mid-flight (pages "
            "freed before completion), by reason",
            labels=("reason",))
        self.swaps = reg.counter(
            "dl4j_decode_model_swaps_total",
            "Completed generation-model hot-swaps", labels=("model",))
        # per-instance children
        self.active_slots = reg.gauge(
            "dl4j_decode_active_slots",
            "Requests currently holding a decode slot",
            labels=("engine",)).labels(engine=self.engine_id)
        self.page_util = reg.gauge(
            "dl4j_decode_page_utilization",
            "Allocated fraction of the paged KV pool (trash page "
            "excluded)", labels=("engine",)).labels(engine=self.engine_id)
        self.fused_attention = reg.gauge(
            "dl4j_decode_fused_attention",
            "1 when decode attention runs the fused paged kernel "
            "(helpers/paged_attention.py, pool + block table streamed "
            "through an online-softmax accumulator), 0 on the legacy "
            "gather+softmax oracle (DL4J_TPU_PAGED_GATHER=1 or helpers "
            "disabled)", labels=("engine",)).labels(engine=self.engine_id)
        self.prefix_cache_resident = reg.gauge(
            "dl4j_prefix_cache_resident_pages",
            "Device pages the prefix-cache radix tree currently keeps "
            "alive", labels=("engine",)).labels(engine=self.engine_id)
        self.prefix_cache_pinned = reg.gauge(
            "dl4j_prefix_cache_pinned_pages",
            "Cached pages protected by at least one session pin",
            labels=("engine",)).labels(engine=self.engine_id)
        self.prefix_cache_host_bytes = reg.gauge(
            "dl4j_prefix_cache_host_tier_bytes",
            "Bytes of offloaded KV page payloads held in the host-RAM "
            "tier", labels=("engine",)).labels(engine=self.engine_id)
        self.batch_occupancy = reg.histogram(
            "dl4j_decode_batch_occupancy",
            "Active slots per dispatched decode step / total slots (1.0 = "
            "every lane did useful work)",
            buckets=_UTIL_BUCKETS)
