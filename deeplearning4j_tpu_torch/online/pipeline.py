"""The continuous-learning loop: stream -> windowed fit -> checkpoint ->
promotion -> serving, hardened at every stage.

One ``OnlineLearningPipeline`` closes the production loop the rest of
the stack provides the pieces for: it consumes DataSet messages from a
``streaming.pubsub`` topic (in-process broker or the HTTP transport),
trains the live model incrementally one WINDOW of messages at a time
(each window is an ``AsyncDataSetIterator`` mini-epoch through the real
fit loop, fault-injection hooks and all), snapshots every window
boundary through the ``CheckpointManager``, then walks the window's
candidate through the ``PromotionManager`` state machine — evaluate,
SLO gate, canary, zero-drop hot-swap, post-swap watch, automatic
rollback (docs/online.md).

Stage-by-stage failure containment:

- **bad records** never reach ``fit``: the ``StreamConsumer`` validates
  on consume and dead-letters offenders to the quarantine topic;
- **stream outages** ride the ``RetryPolicy`` (the HTTP transport
  resumes its subscription after a broker restart);
- **trainer crashes** mid-window restore the last committed window
  boundary from the ``CheckpointManager`` and replay the SAME window
  from memory — committed windows are never re-consumed from the
  stream, and the stream is never re-read;
- **regressed candidates** are refused by the gate (flight event names
  them) and — with ``revert_on_reject`` — the trainer itself is
  restored from the last accepted artifact, so one poisoned-but-valid
  window can't silently steer all later candidates;
- **post-swap regressions** roll serving back to the retained previous
  version automatically; the trainer reverts with it.

Port of ``deeplearning4j_tpu/online/pipeline.py``.  On the card the
trainer's windows replay its captured train step, so the pipeline keeps
the trainer's tensors: a revert writes the accepted artifact's values
into them (as ``CheckpointManager.restore`` does) and costs no new
capture.  A candidate is loaded onto the trainer's device; one that
leaves serving (rejected, or retired by the registry) gives its captured
graphs back at once (``models/capture.release``), so device memory does
not grow window over window.  Only a trainer crash (an injected fault, a
step whose state was lost, a transient error) is replayed; any other
error from ``fit`` — a kernel that fails to build or launch — fails the
run.  The revert's checkpoint replaces the rejected window's checkpoint
of the same step, so a crash in the next window replays from the
accepted weights (the reference keeps the rejected window's).  Each
window's record carries its split in milliseconds
(``split_ms``: fit, save, zip write, candidate load, and the promotion's
evaluate, canary, swap and watch).
"""

from __future__ import annotations

import logging
import os
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterator import (
    AsyncDataSetIterator, DataSetIterator,
)
from deeplearning4j_tpu_torch.models import capture
from deeplearning4j_tpu_torch.models.common import copy_tree_
from deeplearning4j_tpu_torch.observability.flightrecorder import (
    get_flight_recorder,
)
from deeplearning4j_tpu_torch.online.consumer import StreamConsumer
from deeplearning4j_tpu_torch.online.promotion import PromotionManager
from deeplearning4j_tpu_torch.resilience.faults import InjectedFault
from deeplearning4j_tpu_torch.resilience.integration import StepStateLost
from deeplearning4j_tpu_torch.resilience.retry import (
    RetryPolicy, TransientError,
)
from deeplearning4j_tpu_torch.serving.admission import ModelNotFoundError
from deeplearning4j_tpu_torch.serving.engine import DEFAULT_MODEL, ServingEngine

_WINDOWS = "dl4j_online_windows_total"

# what a trainer crash looks like: the window is restored and replayed;
# anything else from fit is a fault of the run and propagates
_TRAINER_CRASHES = (InjectedFault, StepStateLost, TransientError)

logger = logging.getLogger("deeplearning4j_tpu_torch.online")


class _WindowIterator(DataSetIterator):
    """Resettable iterator over one window's in-memory DataSets — the
    replayable unit the crash-resume path re-fits after a restore."""

    def __init__(self, datasets: List[DataSet]):
        self._datasets = list(datasets)
        self._i = 0

    def next(self) -> DataSet:
        ds = self._datasets[self._i]
        self._i += 1
        return ds

    def has_next(self) -> bool:
        return self._i < len(self._datasets)

    def reset(self) -> None:
        self._i = 0

    def batch(self) -> int:
        return len(self._datasets[0]) if self._datasets else 0

    def async_supported(self) -> bool:
        return True


class OnlineLearningPipeline:
    """See module docstring.  Minimal use::

        engine = ServingEngine(model, example=example).start()
        pipe = OnlineLearningPipeline(
            net, engine, topic="train", broker=broker,
            checkpoint_manager=CheckpointManager(dir),
            promotion=PromotionManager(engine, eval_set=holdout))
        summary = pipe.run(max_windows=10)   # or start()/stop()

    ``net`` is the TRAINING model (either fit-loop facade); the engine
    serves independent copies loaded from each window's candidate
    artifact, so training never mutates weights a request might be
    reading.
    """

    def __init__(self, net, engine: ServingEngine, *, topic: str,
                 broker=None, url: Optional[str] = None,
                 model_name: str = DEFAULT_MODEL,
                 checkpoint_manager=None,
                 retry_policy: Optional[RetryPolicy] = None,
                 promotion: Optional[PromotionManager] = None,
                 window_size: int = 4, prefetch: int = 2,
                 poll_timeout_s: float = 1.0,
                 max_window_retries: int = 2,
                 revert_on_reject: bool = True,
                 workdir: Optional[str] = None,
                 sub_id: str = "online", registry=None):
        self.net = net
        self.engine = engine
        self.model_name = model_name
        self.cm = checkpoint_manager
        self.retry = retry_policy if retry_policy is not None else \
            RetryPolicy(max_retries=2, base_delay_s=0.05, max_delay_s=1.0,
                        component="online", registry=registry)
        self.promotion = promotion if promotion is not None else \
            PromotionManager(engine, model_name, registry=registry)
        self.window_size = int(window_size)
        self.prefetch = int(prefetch)
        self.poll_timeout_s = float(poll_timeout_s)
        self.max_window_retries = int(max_window_retries)
        self.revert_on_reject = bool(revert_on_reject)
        self.consumer = StreamConsumer(
            topic, broker=broker, url=url, sub_id=sub_id,
            retry_policy=self.retry, registry=registry)
        if workdir is None:
            workdir = (os.path.join(self.cm.directory, "candidates")
                       if self.cm is not None
                       else tempfile.mkdtemp(prefix="dl4j-online-"))
        self.workdir = workdir
        os.makedirs(self.workdir, exist_ok=True)
        self._registry = registry
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._window_index = 0
        self._anchored = False
        self._last_good_zip: Optional[str] = None
        self.results: List[Dict[str, Any]] = []

    # -------------------------------------------------------------- plumbing
    def _reg(self):
        if self._registry is not None:
            return self._registry
        from deeplearning4j_tpu_torch.observability import get_registry

        return get_registry()

    def _count_window(self, status: str) -> None:
        self._reg().counter(
            _WINDOWS, "Online-learning training windows by outcome "
            "(mutually exclusive — the label sums to the window count): "
            "trained (clean fit + checkpoint committed), retried (a "
            "trainer crash restored the window boundary and the replay "
            "from memory succeeded), failed (retry budget exhausted — "
            "window dropped, trainer restored)", labels=("status",)
        ).inc(status=status)

    def _write_zip(self, tag: str) -> str:
        from deeplearning4j_tpu_torch.models import serialization

        path = os.path.join(self.workdir, f"candidate-{tag}.zip")
        serialization.write_model(self.net, path)
        return path

    def _load_candidate(self, path: str):
        from deeplearning4j_tpu_torch.models import serialization

        return serialization.load_model(path, device=self.net.device,
                                         load_updater=False)

    def _load_params_from(self, path: str) -> None:
        """Restore the TRAINER's weights/updater/state from an accepted
        artifact WITHOUT rewinding the iteration counter: step numbers
        stay monotonic, so window checkpoints never collide with a stale
        committed directory from a rejected timeline.  The values are
        written into the trainer's own tensors (read on the host), so its
        captured step replays on them."""
        from deeplearning4j_tpu_torch.models import serialization

        m = serialization.load_model(path, device="cpu", load_updater=True)
        with torch.no_grad():
            copy_tree_(self.net.params, m.params)
            copy_tree_(self.net.updater_state, m.updater_state)
            copy_tree_(self.net.net_state, m.net_state)

    # ----------------------------------------------------------------- setup
    def _ensure_anchor(self) -> None:
        """First-run duties: make sure serving has an active version of
        ``model_name`` (deploying the trainer's current state when not),
        keep its artifact as the revert target, and commit an anchor
        checkpoint so a crash in the FIRST window has a restore point."""
        if self._anchored:
            return
        anchor_zip = self._write_zip("anchor")
        try:
            self.engine.models.active(self.model_name)
        except ModelNotFoundError:
            self.engine.deploy(self.model_name, self._load_candidate(
                anchor_zip), example=self.promotion._example())
        self._last_good_zip = anchor_zip
        if self.cm is not None:
            self.cm.save(self.net, trigger="explicit", block=True)
        self._anchored = True

    # ------------------------------------------------------------ collection
    def _collect_window(self) -> List[Tuple[DataSet, Dict[str, Any]]]:
        items: List[Tuple[DataSet, Dict[str, Any]]] = []
        while len(items) < self.window_size and not self._stop.is_set():
            got = self.consumer.poll_dataset(timeout=self.poll_timeout_s)
            if got is None:
                break       # topic quiet: train the partial window, if any
            items.append(got)
        return items

    # -------------------------------------------------------------- training
    def _train_window(self, datasets: List[DataSet], wid: str) -> bool:
        """Fit one window through the real loop (retry policy + fault
        hooks inside).  A trainer crash (``_TRAINER_CRASHES``) restores
        the window boundary from the CheckpointManager and replays the
        SAME in-memory window — the stream is not re-consumed.  Returns
        False when the retry budget is exhausted (window dropped, trainer
        restored to the boundary)."""
        start_step = int(getattr(self.net, "iteration", 0))
        attempts = 0
        while True:
            it = AsyncDataSetIterator(_WindowIterator(datasets),
                                      self.prefetch)
            try:
                self.net.fit(it, retry_policy=self.retry)
                # statuses are mutually exclusive so the label sums to
                # the window count: a crash-recovered window is
                # "retried", a clean one "trained"
                self._count_window("retried" if attempts else "trained")
                return True
            except _TRAINER_CRASHES as e:
                attempts += 1
                get_flight_recorder().record(
                    "online_trainer_crash", window=wid, attempt=attempts,
                    error=repr(e))
                logger.warning(
                    "trainer crashed in %s (attempt %d/%d): %r", wid,
                    attempts, self.max_window_retries, e)
                self._restore_boundary(start_step)
                if attempts > self.max_window_retries:
                    self._count_window("failed")
                    get_flight_recorder().record(
                        "online_window_failed", window=wid, error=repr(e))
                    logger.error(
                        "window %s dropped after %d attempts", wid, attempts)
                    return False
            finally:
                self._drain(it)

    def _restore_boundary(self, step: int) -> None:
        """Auto-resume: restore the last committed window boundary (the
        exact ``step`` when its checkpoint survives retention, else the
        newest valid one)."""
        if self.cm is None:
            return      # no manager: replay on top (documented best-effort)
        try:
            self.cm.restore(self.net, step=step)
        except FileNotFoundError:
            try:
                self.cm.restore(self.net)
            except FileNotFoundError:
                logger.warning("no valid checkpoint to restore; replaying "
                               "window on the current state")

    @staticmethod
    def _drain(it: AsyncDataSetIterator) -> None:
        """Exhaust an abandoned window iterator so its producer thread
        exits instead of blocking on the bounded prefetch queue (the
        window's data lives in memory: the producer cannot fail)."""
        while it.has_next():
            it.next()

    # ------------------------------------------------------------ the window
    def process_window(
            self, items: List[Tuple[DataSet, Dict[str, Any]]]
    ) -> Dict[str, Any]:
        """Train one window and walk its candidate through promotion;
        returns the per-window record appended to ``results``."""
        self._ensure_anchor()
        self._window_index += 1
        wid = f"window-{self._window_index}"
        datasets = [ds for ds, _ in items]
        tss = [m.get("ts") for _, m in items
               if isinstance(m.get("ts"), (int, float))]
        event_ts = min(tss) if tss else None

        split: Dict[str, float] = {}
        t0 = time.perf_counter()
        if not self._train_window(datasets, wid):
            return self._record(wid, {"outcome": "window_failed"})
        t1 = time.perf_counter()
        if self.cm is not None:
            self.cm.save(self.net, trigger="explicit", block=True)
        t2 = time.perf_counter()

        tag = f"{self._window_index:05d}"
        zip_path = self._write_zip(tag)
        t3 = time.perf_counter()
        candidate = self._load_candidate(zip_path)
        t4 = time.perf_counter()
        split.update(fit=(t1 - t0) * 1e3, save=(t2 - t1) * 1e3,
                     zip_write=(t3 - t2) * 1e3, load=(t4 - t3) * 1e3)
        cid = f"{wid}@iter{int(getattr(self.net, 'iteration', 0))}"
        res = self.promotion.consider(candidate, cid, event_ts=event_ts)
        split.update(res.split_ms)

        if res.promoted:
            self._replace_good_zip(zip_path)
        else:
            # not serving: its captured graphs go back now
            capture.release(candidate)
            if self.revert_on_reject and self._last_good_zip is not None:
                self._load_params_from(self._last_good_zip)
                if self.cm is not None:
                    # anchor the reverted state so a crash in the next
                    # window restores GOOD weights, not the rejected ones:
                    # it replaces the rejected window's checkpoint of the
                    # same step (kept, the reference restores the rejected
                    # weights on that crash)
                    self.cm.save(self.net, trigger="explicit", block=True,
                                 replace=True)
                get_flight_recorder().record(
                    "online_training_reverted", window=wid,
                    to=os.path.basename(self._last_good_zip),
                    outcome=res.outcome)
            self._remove(zip_path)
        del candidate
        return self._record(wid, {"outcome": res.outcome,
                                  "promotion": res.as_dict(),
                                  "event_ts": event_ts,
                                  "freshness_s": res.freshness_s,
                                  "records": len(items),
                                  "split_ms": split})

    def _replace_good_zip(self, zip_path: str) -> None:
        old = self._last_good_zip
        self._last_good_zip = zip_path
        if old is not None and old != zip_path:
            self._remove(old)

    @staticmethod
    def _remove(path: str) -> None:
        try:
            os.remove(path)
        except OSError:
            pass

    def _record(self, wid: str, fields: Dict[str, Any]) -> Dict[str, Any]:
        rec = {"window": wid, **fields}
        self.results.append(rec)
        return rec

    # ------------------------------------------------------------------- run
    def run(self, max_windows: Optional[int] = None,
            stop_on_idle: bool = True) -> Dict[str, Any]:
        """Blocking consume-train-promote loop; returns after
        ``max_windows`` windows, when the topic stays quiet past
        ``poll_timeout_s`` (unless ``stop_on_idle=False`` — the
        continuous mode ``start()`` uses, where a traffic lull must NOT
        silently end the loop), or on ``stop()``.  The summary counts
        every outcome and carries the freshness of promoted windows."""
        self._ensure_anchor()
        processed = 0
        while not self._stop.is_set():
            items = self._collect_window()
            if not items:
                if stop_on_idle:
                    break
                continue    # _collect_window already waited poll_timeout_s
            self.process_window(items)
            processed += 1
            if max_windows is not None and processed >= max_windows:
                break
        return self.summary()

    def summary(self) -> Dict[str, Any]:
        outcomes: Dict[str, int] = {}
        freshness = []
        for r in self.results:
            outcomes[r["outcome"]] = outcomes.get(r["outcome"], 0) + 1
            if r.get("freshness_s") is not None:
                freshness.append(r["freshness_s"])
        return {
            "windows": len(self.results),
            "outcomes": outcomes,
            "promoted": outcomes.get("promoted", 0),
            "quarantined": self.consumer.quarantined,
            "records_delivered": self.consumer.delivered,
            "freshness_s": freshness,
            "active_version": self._active_version(),
        }

    def _active_version(self) -> Optional[int]:
        try:
            return self.engine.models.active(self.model_name).version
        except ModelNotFoundError:
            return None

    # -------------------------------------------------------------- threaded
    def start(self, max_windows: Optional[int] = None
              ) -> "OnlineLearningPipeline":
        """Run the loop on a background thread in CONTINUOUS mode: a
        traffic lull keeps polling instead of ending the loop — a
        pipeline the operator believes is live must never exit silently
        on a quiet second.  ``stop()`` ends it; any crash is logged and
        flight-recorded before the thread dies."""
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError("pipeline already running")
        self._stop.clear()

        def _run():
            try:
                self.run(max_windows=max_windows, stop_on_idle=False)
            except BaseException as e:   # noqa: BLE001 — last-resort visibility
                get_flight_recorder().record(
                    "online_pipeline_died", error=repr(e))
                logger.exception("online pipeline thread died")
                raise
            finally:
                logger.info("online pipeline thread exiting (%s)",
                            "stopped" if self._stop.is_set()
                            else "max_windows reached")

        self._thread = threading.Thread(
            target=_run, name="dl4j-online-pipeline", daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 30.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            if self._thread.is_alive():
                # join timed out mid-window: keep the handle so a later
                # start() refuses instead of reviving the OLD loop by
                # clearing the _stop event it still polls (two threads
                # on one net/consumer would interleave windows)
                logger.warning(
                    "pipeline thread still finishing its window after "
                    "%.1fs; start() will refuse until it exits", timeout)
            else:
                self._thread = None
