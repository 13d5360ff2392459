"""GenerationEngine: continuous-batching autoregressive serving —
counterpart of ``deeplearning4j_tpu/generation/engine.py``.

Ties the pieces together into the decode analog of the ``ServingEngine``:

- a ``PagedKVCache`` + ``DecodeScheduler`` (iteration-level batching:
  requests join/leave the RUNNING batch every step; prefix sharing;
  admission control with 429/503/504 instead of hangs),
- an optional persistent radix-tree ``PrefixCache`` (``prefix_cache=``:
  prompt pages outlive their request, pinning, a host tier),
- a ``ModelRegistry`` (named/versioned models; ``deploy`` is a
  zero-drop hot-swap BETWEEN decode steps — in-flight streams keep
  their KV and continue under the new weights),
- per-version ``GenerationPrograms`` (bucketed prefill + one decode
  step), warmed through the version's ``RecompileDetector`` before it
  serves; on the card each program is a CUDA graph captured then, over
  the engine's one set of KV pools, and every call is its replay,
- a ``GenerationMetrics`` bundle, an ``SLOTracker``, ``PhaseTimers`` and
  ``step_guard`` spans.

The engine owns the KV pools and every version's programs capture over
those same tensors, so a swap keeps the in-flight streams' KV; a pool
tensor is never replaced, only written in place (the graphs hold its
address).  A deploy builds and captures the incoming version on the
caller's thread while the decode thread goes on replaying the serving
version (captures run under ``backend.device.capture_lock`` in
``thread_local`` mode); a retired version's graphs are dropped under
that lock too.  A retained version (``retain_old=True``) keeps its
graphs, so ``rollback`` replays them without capturing.

One background decode thread owns the slot arrays and the page
allocator; clients only touch the admission queue and their own request
handles, so ``submit``/``stream`` are thread-safe.  No metric reads the
device: the gauges resolve when they are scraped.

Minimal use::

    engine = GenerationEngine(net, slots=8, page_size=16, max_context=128)
    engine.start()                      # warms prefill + decode once
    h = engine.submit([1, 2, 3], max_new_tokens=16)
    for tok in h.stream(): ...          # tokens as they decode
    engine.deploy("default", new_net)   # hot-swap between steps
    engine.stop()

``kv_numerics`` reads the pools' page ledger between decode steps;
``fleet_publisher`` streams the engine's host-side telemetry to a fleet
aggregator.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch import helpers
from deeplearning4j_tpu_torch.backend.device import capture_lock
from deeplearning4j_tpu_torch.generation.paged_cache import PagedKVCache
from deeplearning4j_tpu_torch.generation.prefix_cache import (
    PrefixCache, PrefixCacheConfig,
)
from deeplearning4j_tpu_torch.generation.programs import GenerationPrograms
from deeplearning4j_tpu_torch.generation.scheduler import (
    DecodeScheduler, GenerationRequest,
)
from deeplearning4j_tpu_torch.helpers import paged_attention as pa
from deeplearning4j_tpu_torch.models.common import tree_leaves, tree_paths
from deeplearning4j_tpu_torch.observability.flightrecorder import (
    get_flight_recorder, step_guard,
)
from deeplearning4j_tpu_torch.observability.fleet import SLOTracker
from deeplearning4j_tpu_torch.observability.phases import PhaseTimers
from deeplearning4j_tpu_torch.observability.servingmetrics import (
    GenerationMetrics,
)
from deeplearning4j_tpu_torch.observability.tracing import get_tracer
from deeplearning4j_tpu_torch.serving.buckets import _pow2_buckets
from deeplearning4j_tpu_torch.serving.registry import (
    ModelRegistry, ModelVersion,
)
from deeplearning4j_tpu_torch.utils.sampling import base_key

logger = logging.getLogger("deeplearning4j_tpu_torch.generation")

DEFAULT_MODEL = "default"

# finish reasons that count as a successful completion
_OK_REASONS = ("length", "stop")


class GenerationEngine:
    """See module docstring."""

    def __init__(self, model=None, *, slots: int = 8, page_size: int = 16,
                 max_context: int = 256, num_pages: Optional[int] = None,
                 max_queue: int = 64, deadline_s: float = 60.0,
                 prefill_buckets: Optional[Sequence[int]] = None,
                 models: Optional[ModelRegistry] = None, registry=None,
                 default_model: str = DEFAULT_MODEL,
                 prefix_cache=None, slo_targets: Optional[dict] = None,
                 decode_step_floor_s: float = 0.0):
        if max_context < 2:
            raise ValueError(f"max_context={max_context} must be >= 2")
        pages_per_slot = -(-int(max_context) // int(page_size))
        if num_pages is None:
            # default: full occupancy of every slot fits (+ trash page),
            # so admission only ever sheds on the queue budget
            num_pages = slots * pages_per_slot + 1
        self.metrics = GenerationMetrics(registry)
        # decode SLO attribution: TTFT/ITL attainment + goodput against
        # configurable targets (slo_targets={"ttft_target_s": ...,
        # "itl_target_s": ...})
        self.slo = SLOTracker(registry=self.metrics.registry,
                              engine_id=self.metrics.engine_id,
                              **(slo_targets or {}))
        # per-iteration phase breakdown of the decode loop (schedule /
        # page_gather / jitted_step / sample_harvest / stream_write)
        self.phases = PhaseTimers("generation_decode",
                                  registry=self.metrics.registry)
        self.busy_wall_s = 0.0          # decode-loop wall time, non-wait
        # host wall time of each decode step, dispatch to sampled tokens
        self.decode_step_s: "deque[float]" = deque(maxlen=65536)
        self.models = models or ModelRegistry(
            metrics_registry=self.metrics.registry)
        self.default_model = default_model
        self.cache = PagedKVCache(num_pages, page_size, pages_per_slot)
        # persistent radix-tree prefix cache (opt-in retention policy):
        # prefix_cache=True for defaults, a PrefixCacheConfig for knobs,
        # None/False keeps free-on-release behavior bit-identical
        self.prefix_cache: Optional[PrefixCache] = None
        if prefix_cache:
            cfg = (prefix_cache if isinstance(prefix_cache,
                                              PrefixCacheConfig)
                   else PrefixCacheConfig())
            self.prefix_cache = PrefixCache(
                self.cache, host_budget_bytes=cfg.host_budget_bytes,
                metrics=self.metrics)
            self.cache.retention = self.prefix_cache
        self.scheduler = DecodeScheduler(
            self.cache, slots=slots, max_queue=max_queue,
            default_deadline_s=deadline_s, metrics=self.metrics)
        self.scheduler.on_finish = self._on_finish
        if prefill_buckets is None:
            prefill_buckets = _pow2_buckets(int(max_context))
        self.prefill_buckets = tuple(sorted(set(int(b)
                                                for b in prefill_buckets)))
        if model is not None:
            self.models.register(default_model, model)
        self._programs: "dict[str, GenerationPrograms]" = {}
        self._pools = None              # the live KV pools, engine-owned
        # internal: False runs every version's programs eagerly on the
        # card (the smoke run's and the tests' comparison); None captures
        # on the card
        self._capture = None
        self._swap_lock = threading.Lock()
        # held by the decode thread across each iteration's prefill and
        # decode replays (they write the pools in place): a reader of the
        # pools (kv_numerics) takes it to read between two steps
        self._step_lock = threading.Lock()
        self._stop_event = threading.Event()
        self._drain = True
        self._thread: Optional[threading.Thread] = None
        self.steady_deliveries = 0      # tokens delivered since start
        # a minimum wall time per decode step (the reference's pacing of
        # replicas sharing a host); 0 disables and changes nothing
        self.decode_step_floor_s = float(decode_step_floor_s)

    @property
    def programs(self) -> GenerationPrograms:
        """The serving version's programs (built by ``start``)."""
        return self._programs[self.models.active(self.default_model).key]

    # ------------------------------------------------------------- lifecycle
    def start(self) -> "GenerationEngine":
        """Build and warm the active version's programs (on the card:
        capture their graphs over the live page pools, once), zero the
        pools, start the decode thread."""
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError("engine already started")
        mv = self.models.active(self.default_model)
        progs = self._programs.get(mv.key)
        if progs is None:
            progs = self._build_programs(mv)
        # a (re)start serves from zeroed pools, zeroed in place: the
        # graphs hold their addresses
        progs.reset_pools()
        if self.prefix_cache is not None:
            # zeroed pools mean every cached node points at garbage:
            # drop the tree, stamp the serving version, wire the page
            # transport + host-budget unit
            self.prefix_cache.invalidate("pool_reset")
            self.prefix_cache.set_version(mv.key)
            self.prefix_cache.attach(self, progs.page_nbytes())
        self.scheduler.reopen()   # a restart re-arms admission
        self.metrics.fused_attention.set(
            1.0 if helpers.enabled()
            and pa.paged_attention_mode() == "fused" else 0.0)
        self._stop_event.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="generation-decode")
        self._thread.start()
        return self

    def stop(self, drain: bool = True, timeout: float = 30.0) -> None:
        """With ``drain`` (default) every queued and running request is
        still served (bounded by ``timeout``); without, queued requests
        fail 503 now and running ones are evicted at the next step
        boundary.  Either way no waiter is left hanging."""
        self._drain = drain
        self.scheduler.begin_shutdown(drain_pending=drain)
        self._stop_event.set()
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                logger.warning(
                    "decode thread still draining after %.1fs; failing "
                    "the remaining requests", timeout)
                self._drain = False
                self._thread.join(5.0)
        self._thread = None
        self.scheduler.evict_all("shutdown")
        # anything still queued after the drain window failed because the
        # ENGINE stopped, not because its own deadline passed: 503
        self.scheduler.begin_shutdown(drain_pending=False)
        self._refresh_gauges()

    # ---------------------------------------------------------------- submit
    def submit(self, prompt: Sequence[int], max_new_tokens: int = 32, *,
               temperature: float = 0.0, top_k: Optional[int] = None,
               top_p: Optional[float] = None, seed: int = 0,
               deadline_s: Optional[float] = None,
               stop_token: Optional[int] = None,
               trace_id: Optional[str] = None) -> GenerationRequest:
        """Thread-safe enqueue; returns the request handle (``stream()``
        for tokens as they decode, ``result()`` to block).  Raises
        ``QueueFullError`` (429) on a full queue, ``ShuttingDownError``
        (503) during shutdown, ``ValueError`` for a request that could
        never fit."""
        deadline = self.scheduler.admission.deadline_for(deadline_s)
        req = GenerationRequest(
            prompt, max_new_tokens, temperature=temperature, top_k=top_k,
            top_p=top_p, seed=seed, deadline_s=deadline,
            stop_token=stop_token, trace_id=trace_id)
        # worst case (no prefix shared) the WHOLE prompt prefills in one
        # bucket; reject here with a clean error instead of detonating a
        # ValueError on the decode thread mid-batch
        if len(req.prompt) > max(self.prefill_buckets):
            raise ValueError(
                f"prompt of {len(req.prompt)} tokens exceeds the largest "
                f"prefill bucket {max(self.prefill_buckets)}")
        return self.scheduler.submit(req)

    def generate(self, prompt: Sequence[int], max_new_tokens: int = 32,
                 **kw) -> np.ndarray:
        """Blocking convenience: submit + wait; returns the generated ids
        as a 1-D array."""
        req = self.submit(prompt, max_new_tokens, **kw)
        return np.asarray(req.result(), np.int32)

    # -------------------------------------------------------- prefix pinning
    def pin_prefix(self, prompt: Sequence[int]) -> int:
        """Pin ``prompt``'s cached prefix pages against offload and
        eviction (multi-turn sessions pin their history after each turn
        so the next turn only prefills the new tokens); returns a pin id
        for ``unpin_prefix``.  Thread-safe."""
        if self.prefix_cache is None:
            raise RuntimeError(
                "pin_prefix requires the persistent prefix cache "
                "(GenerationEngine(..., prefix_cache=True))")
        return self.prefix_cache.pin(prompt)

    def unpin_prefix(self, pin_id: int) -> None:
        """Release one pin; an unknown or already-released id raises
        ``KeyError``."""
        if self.prefix_cache is None:
            raise RuntimeError(
                "unpin_prefix requires the persistent prefix cache")
        self.prefix_cache.unpin(pin_id)

    # ------------------------------------------------- prefix-cache transport
    # PrefixCache calls these on the decode thread (inside admission,
    # which the engine's single decode loop drives), so they are the
    # owner thread acting on the pools.
    def cache_read_page(self, page: int):
        return self.programs.read_page(page)

    def cache_write_page(self, page: int, payload) -> None:
        self.programs.write_page(page, payload)

    # ----------------------------------------------------------- model admin
    def deploy(self, name: str, model, *, retain_old: bool = False,
               drain_timeout: float = 30.0) -> ModelVersion:
        """Register ``model`` as the next version of ``name`` and hot-swap
        it in WITHOUT interrupting decode: the incoming version's
        programs are built and warmed first (on the card: captured over
        the live pools while the decode thread goes on replaying the old
        version; a model that fails its warm-up — or whose cache
        geometry differs from the live pools — aborts here with the old
        version intact), then the active pointer flips atomically; the
        decode loop leases per iteration, so the very next step runs the
        new weights while every in-flight stream keeps its slot, its
        pages, and its sampling state.  With ``retain_old`` the displaced
        version stays loaded, its graphs kept, as the ``rollback``
        target."""
        if name != self.default_model:
            raise ValueError(
                f"generation engine serves one model name "
                f"({self.default_model!r}); decode batches cannot mix "
                f"models")
        with self._swap_lock:
            mv = self.models.new_version(name, model)
            self._build_programs(mv)   # raises -> swap aborted, old intact
            self._commit_locked(name, drain_timeout)
            old = self.models.activate(mv, retain=retain_old)
            get_flight_recorder().record(
                "generation_swap", model=name, version=mv.version,
                replaced=old.version if old else None,
                retained=bool(retain_old and old is not None))
            if old is not None:
                self.metrics.swaps.inc(model=name)
                if not retain_old:
                    self._retire(old, drain_timeout)
            logger.info("generation: %s now serving (replaced %s%s)",
                        mv.key, old.key if old else "nothing",
                        ", retained for rollback"
                        if retain_old and old else "")
            return mv

    def rollback(self, name: Optional[str] = None, *,
                 drain_timeout: float = 30.0) -> ModelVersion:
        """Undo the last retaining swap: flip back to the retained
        version between decode steps (its graphs are still captured — a
        retained version's programs are only dropped at retire)."""
        name = name or self.default_model
        with self._swap_lock:
            restored, displaced = self.models.rollback(name)
            get_flight_recorder().record(
                "generation_rollback", model=name,
                restored=restored.version,
                displaced=displaced.version if displaced else None)
            self.metrics.swaps.inc(model=name)
            if displaced is not None:
                self._retire(displaced, drain_timeout)
            return restored

    def commit_swap(self, name: Optional[str] = None, *,
                    drain_timeout: float = 30.0) -> Optional[ModelVersion]:
        """Close the rollback window: retire the retained version."""
        with self._swap_lock:
            return self._commit_locked(name or self.default_model,
                                       drain_timeout)

    def _commit_locked(self, name: str, drain_timeout: float):
        mv = self.models.release_retained(name)
        if mv is not None:
            self._retire(mv, drain_timeout)
        return mv

    def _retire(self, mv: ModelVersion, timeout: float) -> None:
        if self.models.retire(mv, timeout=timeout):
            with capture_lock:     # its graphs go, never mid-capture
                self._programs.pop(mv.key, None)
        else:
            logger.warning("%s still leased after %.1fs; left un-retired",
                           mv.key, timeout)

    def _build_programs(self, mv: ModelVersion) -> GenerationPrograms:
        """Programs for one version over the engine's live pools (made
        here for the first version), warmed — on the card, captured —
        through the version's detector.  A version whose pool geometry
        (layer names, kv heads, head dims, page size, type or device)
        differs from the live pools cannot share the in-flight cache and
        is rejected before anything is captured."""
        progs = GenerationPrograms(
            mv.model, slots=self.scheduler.num_slots,
            pages_per_slot=self.cache.pages_per_slot,
            page_size=self.cache.page_size, num_pages=self.cache.num_pages,
            prefill_buckets=self.prefill_buckets, pools=self._pools,
            detector=mv.detector, capture=self._capture)
        if self._pools is None:
            self._pools = progs.pools = progs.fresh_pools()
        else:
            def geometry(pools):
                return [(path, tuple(t.shape), t.dtype)
                        for path, t in tree_paths(pools)]

            live, new = tree_leaves(self._pools)[0].device, progs.device
            if (geometry(self._pools)
                    != geometry(progs.fresh_pools("meta"))
                    or live.type != new.type
                    or None not in (live.index, new.index)
                    and live.index != new.index):
                raise ValueError(
                    f"cannot deploy {mv.key}: its paged-cache geometry "
                    "differs from the live pools (layer names / kv heads "
                    "/ head dims / type / device must match the serving "
                    "architecture)")
        progs.warm()
        self._programs[mv.key] = progs
        return progs

    # ------------------------------------------------------------ decode loop
    def _run(self) -> None:
        while True:
            stopping = self._stop_event.is_set()
            if stopping and (not self._drain
                             or not self.scheduler.has_work):
                break
            t_iter = time.perf_counter()
            with self.phases.phase("schedule"):
                self.scheduler.purge_pending()
            try:
                with self.models.lease(self.default_model) as mv, \
                        self._step_lock:
                    progs = self._programs[mv.key]
                    if (self.prefix_cache is not None
                            and self.prefix_cache.version != mv.key):
                        # hot-swap/rollback observed: cached KV was
                        # prefilled under the displaced weights — a
                        # stale hit would be silently wrong, so the
                        # whole tree goes before any admission runs
                        n = self.prefix_cache.invalidate("swap")
                        self.prefix_cache.set_version(mv.key)
                        logger.info("prefix cache invalidated on swap "
                                    "to %s (%d nodes dropped)",
                                    mv.key, n)
                    self._admit(progs, mv)
                    if self.scheduler.active_slots():
                        self._step(progs, mv)
                        self.busy_wall_s += time.perf_counter() - t_iter
                        continue
            except Exception as e:
                logger.exception("decode iteration failed; evicting the "
                                 "running batch and reseeding the pools")
                get_flight_recorder().record("generation_error",
                                             error=str(e)[:200])
                self.scheduler.evict_all("error", e)
                try:
                    # in place: the graphs hold the pools' addresses
                    for t in tree_leaves(self._pools):
                        t.zero_()
                    if self.prefix_cache is not None:
                        # the reseed just zeroed every cached page
                        self.prefix_cache.invalidate("pool_reset")
                except Exception:
                    logger.exception("pool reseed failed; decode thread "
                                     "exiting")
                    return
            self.busy_wall_s += time.perf_counter() - t_iter
            if not stopping and not self.scheduler.has_work:
                self.scheduler.wait_for_work(0.05)

    def _admit(self, progs: GenerationPrograms, mv: ModelVersion) -> None:
        while True:
            with self.phases.phase("schedule"):
                req = self.scheduler.next_admittable()
            if req is None:
                return
            try:
                self._prefill(progs, mv, req)
            except Exception as e:
                # the request holds pages but no slot yet: evict_all in
                # the outer handler cannot see it, so terminate it here
                # (pages freed, waiters released, stale prefix-index
                # entries for its never-written pages removed) and let
                # the outer handler reset the pools
                self.scheduler.fail_admitted(req, e)
                raise

    def _prefill(self, progs: GenerationPrograms, mv: ModelVersion,
                 req: GenerationRequest) -> None:
        with self.phases.phase("page_gather"):
            suffix = req.prompt[req.shared_len:]
            bucket = progs.bucket_for(len(suffix))
            tokens = np.zeros((1, bucket), np.int32)
            tokens[0, :len(suffix)] = suffix
            shared_pages = req.shared_len // self.cache.page_size
            key = base_key(req.seed)
            block = self.cache.block_row(req.pages)[None]
        with step_guard("decode_prefill", engine=self.metrics.engine_id,
                        bucket=bucket, shared_pages=shared_pages):
            with self.phases.phase("jitted_step"):
                tok = progs.prefill(
                    bucket, block, np.asarray([req.shared_len], np.int32),
                    len(suffix) - 1, tokens, key[None],
                    np.zeros(1, np.int32),
                    np.asarray([req.temperature], np.float32),
                    np.asarray([req.top_k], np.int32),
                    np.asarray([req.top_p], np.float32))
        with self.phases.phase("sample_harvest"):
            first = int(tok[0])
        with self.phases.phase("stream_write"):
            self.scheduler.install(req, first, key)
            self.metrics.ttft.observe(req.ttft_s)
            self.metrics.prefix_pages.inc(shared_pages, outcome="shared")
            self.metrics.prefix_pages.inc(len(req.pages) - shared_pages,
                                          outcome="fresh")
            self.metrics.tokens.inc(model=mv.name)
            self._refresh_gauges()

    def _step(self, progs: GenerationPrograms, mv: ModelVersion) -> None:
        s = self.scheduler
        active = len(s.active_slots())
        t_step0 = time.perf_counter()
        with step_guard("decode_step", engine=self.metrics.engine_id,
                        active=active):
            with self.phases.phase("jitted_step"):
                sampled = progs.decode(
                    s.block, s.pos, s.last_tok, s.keys, s.tok_idx,
                    s.temps, s.top_ks, s.top_ps)
        self.decode_step_s.append(time.perf_counter() - t_step0)
        with self.phases.phase("stream_write"):
            delivered = s.after_step(sampled)
            self.steady_deliveries += delivered
            self.metrics.steps.inc()
            self.metrics.tokens.inc(delivered, model=mv.name)
            self.metrics.batch_occupancy.observe(active / s.num_slots)
            self._refresh_gauges()
        if self.decode_step_floor_s > 0.0:
            # sleep (not spin) to the floor: the yielded core is what
            # lets sibling replica processes decode concurrently
            remain = self.decode_step_floor_s - (time.perf_counter()
                                                 - t_step0)
            if remain > 0:
                time.sleep(remain)

    def _refresh_gauges(self) -> None:
        self.metrics.active_slots.set(len(self.scheduler.active_slots()))
        self.metrics.page_util.set(self.cache.utilization())
        if self.prefix_cache is not None:
            # one locked snapshot — three separate reads could tear
            # across a concurrent eviction/offload
            st = self.prefix_cache.stats()
            self.metrics.prefix_cache_resident.set(st["resident_pages"])
            self.metrics.prefix_cache_pinned.set(st["pinned_pages"])
            self.metrics.prefix_cache_host_bytes.set(
                st["host_tier_bytes"])

    def _on_finish(self, req: GenerationRequest) -> None:
        """Terminal accounting for every request, whatever path ended it
        (completion, stop token, cancel, deadline, shutdown, error)."""
        status = req.finish_reason or "error"
        self.metrics.requests.inc(status=status)
        # SLO verdict BEFORE the waiters wake (scheduler calls on_finish
        # before releasing them), so req.as_dict() reads a settled slo_ok
        req.slo_ok = self.slo.observe_request(
            ttft_s=req.ttft_s, itl_s=req.itl_s,
            completed=status in _OK_REASONS)
        end_ns = time.perf_counter_ns()
        start_ns = int(req.submitted * 1e9)
        get_tracer().record_span(
            "generation_request", start_ns, end_ns,
            trace_id=req.trace_id, tokens=len(req.tokens), status=status,
            ttft_ms=(round(req.ttft_s * 1e3, 3)
                     if req.ttft_s is not None else None),
            itl_p50_ms=req.itl_p50_ms(), slo_ok=req.slo_ok)

    def kv_numerics(self, allocated_only: bool = True) -> dict:
        """Per-page dynamic-range ledger over the live KV pools
        (``observability.numerics.kv_page_ledger``): the int8-KV
        quantization-readiness evidence.  The port's replays write the
        pools in place, so they are read between two decode steps, under
        the engine's step lock (the copy to the host queues behind the
        last replay and before the next)."""
        from deeplearning4j_tpu_torch.observability import numerics

        if self._pools is None:
            return {}
        with self._step_lock:
            allocated = None
            if allocated_only:
                allocated = [p for p in range(1, self.cache.num_pages)
                             if self.cache.refcount(p) > 0]
            return numerics.kv_page_ledger(
                self._pools, self.cache.page_size, allocated=allocated)

    def fleet_publisher(self, worker_id: str, **kw):
        """A ``TelemetryPublisher`` pre-wired to this engine: local
        registry, SLO tracker, one-locked-snapshot prefix-cache stats,
        and the scheduler state dict.  Caller supplies the transport
        (``broker=`` or ``url=``) and calls ``start()``.  Reads only
        host-side state — publishing never touches the device."""
        from deeplearning4j_tpu_torch.observability.fleet import (
            TelemetryPublisher,
        )
        kw.setdefault("registry", self.metrics.registry)
        kw.setdefault("slo", self.slo)
        if self.prefix_cache is not None:
            kw.setdefault("prefix_cache", self.prefix_cache)
        kw.setdefault("state_fn",
                      lambda: {"scheduler": self.scheduler.as_dict()})
        return TelemetryPublisher(worker_id, **kw)

    # ----------------------------------------------------------------- stats
    def stats(self) -> dict:
        progs = self._programs.get(
            self.models.active(self.default_model).key)
        return {
            "model": self.default_model,
            "models": self.models.as_dict(),
            "scheduler": self.scheduler.as_dict(),
            "prefill_buckets": list(self.prefill_buckets),
            "decode_thread_alive": (self._thread is not None
                                    and self._thread.is_alive()),
            "phases": self.phases.as_dict(),
            "busy_wall_s": round(self.busy_wall_s, 6),
            "slo": self.slo.as_dict(),
            "prefill_calls": progs.prefill_calls if progs else 0,
            "decode_calls": progs.decode_calls if progs else 0,
            "captures": progs.captures if progs else 0,
            "replays": progs.replays if progs else 0,
        }

    def cache_stats(self) -> dict:
        """The ``GET /generation/cache`` payload: allocator occupancy
        plus the persistent prefix cache's tree/host-tier stats (null
        when running the free-on-release policy)."""
        return {
            "cache": self.cache.as_dict(),
            "prefix_cache": (self.prefix_cache.stats()
                             if self.prefix_cache is not None else None),
        }
