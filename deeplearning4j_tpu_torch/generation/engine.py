"""GenerationEngine: continuous-batching autoregressive serving —
counterpart of ``deeplearning4j_tpu/generation/engine.py``.

- a ``PagedKVCache`` + ``DecodeScheduler`` (iteration-level batching:
  requests join/leave the RUNNING batch every step; prefix sharing;
  admission control with 429/503/504 instead of hangs),
- a ``GenerationPrograms`` (bucketed prefill + one decode step), whose
  paged attention runs the CUDA kernel on the card; there every call is
  the replay of a CUDA graph captured when the engine starts.

One background decode thread owns the device pools, the slot arrays and
the page allocator; clients only touch the admission queue and their
own request handles, so ``submit``/``stream`` are thread-safe.

Minimal use::

    engine = GenerationEngine(net, slots=8, page_size=16, max_context=128)
    engine.start()                      # warms prefill + decode once
    h = engine.submit([1, 2, 3], max_new_tokens=16)
    for tok in h.stream(): ...          # tokens as they decode
    engine.stop()

Not ported yet: the persistent ``PrefixCache``, ``deploy``/``rollback``
and the model registry, the metrics, SLO and flight-recorder hooks, and
``fleet_publisher``.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch.generation.paged_cache import PagedKVCache
from deeplearning4j_tpu_torch.generation.programs import GenerationPrograms
from deeplearning4j_tpu_torch.generation.scheduler import (
    DecodeScheduler, GenerationRequest,
)
from deeplearning4j_tpu_torch.serving.buckets import _pow2_buckets
from deeplearning4j_tpu_torch.utils.sampling import base_key

logger = logging.getLogger("deeplearning4j_tpu_torch.generation")


class GenerationEngine:
    """See module docstring."""

    def __init__(self, model, *, slots: int = 8, page_size: int = 16,
                 max_context: int = 256, num_pages: Optional[int] = None,
                 max_queue: int = 64, deadline_s: float = 60.0,
                 prefill_buckets: Optional[Sequence[int]] = None):
        if max_context < 2:
            raise ValueError(f"max_context={max_context} must be >= 2")
        pages_per_slot = -(-int(max_context) // int(page_size))
        if num_pages is None:
            # default: full occupancy of every slot fits (+ trash page),
            # so admission only ever sheds on the queue budget
            num_pages = slots * pages_per_slot + 1
        self.model = model
        self.cache = PagedKVCache(num_pages, page_size, pages_per_slot)
        self.scheduler = DecodeScheduler(
            self.cache, slots=slots, max_queue=max_queue,
            default_deadline_s=deadline_s)
        if prefill_buckets is None:
            prefill_buckets = _pow2_buckets(int(max_context))
        self.prefill_buckets = tuple(sorted(set(int(b)
                                                for b in prefill_buckets)))
        self.programs = GenerationPrograms(
            model, slots=self.scheduler.num_slots,
            pages_per_slot=pages_per_slot, page_size=page_size,
            num_pages=num_pages, prefill_buckets=self.prefill_buckets)
        self._stop_event = threading.Event()
        self._drain = True
        self._thread: Optional[threading.Thread] = None
        self.busy_wall_s = 0.0          # decode-loop wall time, non-wait
        # host wall time of each decode step, dispatch to sampled tokens
        self.decode_step_s: "deque[float]" = deque(maxlen=65536)

    # ------------------------------------------------------------- lifecycle
    def start(self) -> "GenerationEngine":
        """Warm the programs (on the card: capture their graphs over the
        live page pools, once), start the decode thread."""
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError("engine already started")
        self.programs.warm()
        self.scheduler.reopen()   # a restart re-arms admission
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

    # ------------------------------------------------------------ decode loop
    def _run(self) -> None:
        progs = self.programs
        while True:
            stopping = self._stop_event.is_set()
            if stopping and (not self._drain
                             or not self.scheduler.has_work):
                break
            t_iter = time.perf_counter()
            self.scheduler.purge_pending()
            try:
                self._admit(progs)
                if self.scheduler.active_slots():
                    self._step(progs)
                    self.busy_wall_s += time.perf_counter() - t_iter
                    continue
            except Exception as e:
                logger.exception("decode iteration failed; evicting the "
                                 "running batch and reseeding the pools")
                self.scheduler.evict_all("error", e)
                try:
                    # in place: the captured graphs hold the pools'
                    # addresses
                    progs.reset_pools()
                except Exception:
                    logger.exception("pool reseed failed; decode thread "
                                     "exiting")
                    return
            self.busy_wall_s += time.perf_counter() - t_iter
            if not stopping and not self.scheduler.has_work:
                self.scheduler.wait_for_work(0.05)

    def _admit(self, progs: GenerationPrograms) -> None:
        while True:
            req = self.scheduler.next_admittable()
            if req is None:
                return
            try:
                self._prefill(progs, req)
            except Exception as e:
                # the request holds pages but no slot yet: terminate it
                # here and let the outer handler reset the pools
                self.scheduler.fail_admitted(req, e)
                raise

    def _prefill(self, progs: GenerationPrograms,
                 req: GenerationRequest) -> None:
        suffix = req.prompt[req.shared_len:]
        bucket = progs.bucket_for(len(suffix))
        tokens = np.zeros((1, bucket), np.int32)
        tokens[0, :len(suffix)] = suffix
        key = base_key(req.seed)
        block = self.cache.block_row(req.pages)[None]
        tok = progs.prefill(
            bucket, block,
            np.asarray([req.shared_len], np.int32), len(suffix) - 1,
            tokens, key[None], np.zeros(1, np.int32),
            np.asarray([req.temperature], np.float32),
            np.asarray([req.top_k], np.int32),
            np.asarray([req.top_p], np.float32))
        self.scheduler.install(req, int(tok[0]), key)

    def _step(self, progs: GenerationPrograms) -> None:
        s = self.scheduler
        t0 = time.perf_counter()
        sampled = progs.decode(
            s.block, s.pos, s.last_tok, s.keys, s.tok_idx,
            s.temps, s.top_ks, s.top_ps)
        self.decode_step_s.append(time.perf_counter() - t0)
        s.after_step(sampled)

    # ----------------------------------------------------------------- stats
    def stats(self) -> dict:
        return {
            "scheduler": self.scheduler.as_dict(),
            "prefill_buckets": list(self.prefill_buckets),
            "decode_thread_alive": (self._thread is not None
                                    and self._thread.is_alive()),
            "busy_wall_s": round(self.busy_wall_s, 6),
            "prefill_calls": self.programs.prefill_calls,
            "decode_calls": self.programs.decode_calls,
            "captures": self.programs.captures,
            "replays": self.programs.replays,
        }
