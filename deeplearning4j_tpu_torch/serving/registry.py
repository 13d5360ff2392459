"""Named/versioned model registry with atomic hot-swap.

Copied from ``deeplearning4j_tpu/serving/registry.py`` with its imports
pointed at the port's own copies.  On the card a version's compiles are
its graph captures, and retiring a version releases its model under
``backend.device.capture_lock``, so that its graphs are never freed
while another thread captures.

The reference redeploys a serving route by restarting it; here a new
checkpoint is loaded and WARMED while the old version keeps serving,
then the active pointer flips atomically.  Requests never reference a
version until the moment their batch executes (the batcher takes a
lease), so a swap drops zero requests: batches in flight on the old
version run to completion under their lease, every later batch sees the
new version, and ``retire`` blocks until the old version's in-flight
count drains to zero before it is marked retired.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Optional, Tuple

from deeplearning4j_tpu_torch.backend.device import capture_lock
from deeplearning4j_tpu_torch.models import capture as cap
from deeplearning4j_tpu_torch.observability.recompile import RecompileDetector
from deeplearning4j_tpu_torch.serving.admission import ModelNotFoundError

ACTIVE = "active"
PENDING = "pending"    # loaded + warming, not yet serving
RETAINED = "retained"  # displaced by a swap, kept loaded for rollback
RETIRED = "retired"


class ModelVersion:
    """One immutable (model object, version) pair plus its serving state.

    Each version owns its own ``RecompileDetector`` (named
    ``serving.<model>``): a fresh version has its own programs (graphs), so its
    warmup compiles are real compiles and must be counted."""

    def __init__(self, name: str, version: int, model,
                 example=None, metrics_registry=None):
        self.name = name
        self.version = int(version)
        self.model = model
        self.model_type = type(model).__name__   # survives model release
        self.example = example          # single-row ndarray for warmup
        self.state = PENDING
        self.created = time.time()
        self.inflight = 0               # batches currently executing
        self.detector = RecompileDetector(
            f"serving.{name}", registry=metrics_registry)

    @property
    def key(self) -> str:
        return f"{self.name}@v{self.version}"

    def as_dict(self) -> dict:
        return {"name": self.name, "version": self.version,
                "state": self.state, "inflight": self.inflight,
                "model_type": self.model_type,
                "compiled_signatures": self.detector.compile_count}


class ModelRegistry:
    """Thread-safe name -> active ModelVersion map (plus retired history).

    Retiring a version RELEASES its model reference (the weights are the
    memory cost; the history keeps only metadata) and the history itself
    is capped — a server hot-swapping for months must not leak one model
    per swap."""

    HISTORY_LIMIT = 16

    def __init__(self, metrics_registry=None):
        self._cv = threading.Condition()
        self._active: Dict[str, ModelVersion] = {}
        self._previous: Dict[str, ModelVersion] = {}   # rollback targets
        self._history: List[ModelVersion] = []
        self._next_version: Dict[str, int] = {}
        self._metrics_registry = metrics_registry

    # ------------------------------------------------------------ mutation
    def new_version(self, name: str, model, example=None,
                    version: Optional[int] = None) -> ModelVersion:
        """Build (but do not activate) the next version of ``name`` —
        the engine warms it up before calling ``activate``."""
        with self._cv:
            v = (self._next_version.get(name, 1)
                 if version is None else int(version))
            # a pinned (manifest) version must never rewind the counter,
            # or a later auto-assigned version would duplicate an old one
            self._next_version[name] = max(
                self._next_version.get(name, 1), v + 1)
            return ModelVersion(name, v, model, example,
                                self._metrics_registry)

    def activate(self, mv: ModelVersion,
                 retain: bool = False) -> Optional[ModelVersion]:
        """Atomically make ``mv`` the active version of its name;
        returns the displaced version (still counted in-flight by any
        executing batches) or None.

        With ``retain`` the displaced version is NOT moved to the retired
        history: it keeps its model loaded in state ``retained`` and
        becomes the ``rollback`` target — the post-swap watch window's
        undo button.  Callers that retain must eventually resolve the
        pair: ``rollback(name)`` to flip back, or ``release_retained``
        (then ``retire``) once the watch window closes cleanly.  An
        earlier retained version still unresolved when a new swap lands
        is returned to the history (model intact — the caller retires it
        to release the weights)."""
        with self._cv:
            old = self._active.get(mv.name)
            stale_retained = self._previous.pop(mv.name, None)
            mv.state = ACTIVE
            self._active[mv.name] = mv
            if old is not None:
                if retain:
                    old.state = RETAINED
                    self._previous[mv.name] = old
                else:
                    self._history.append(old)
            if stale_retained is not None and stale_retained is not old:
                self._history.append(stale_retained)
            del self._history[:-self.HISTORY_LIMIT]
            self._cv.notify_all()
            return old

    def rollback(self, name: str) -> "Tuple[ModelVersion, ModelVersion]":
        """Atomically flip the active pointer of ``name`` back to the
        version retained by the last ``activate(..., retain=True)``.
        Returns ``(restored, displaced)``: the restored previous version
        (now active again) and the displaced bad version — still serving
        its in-flight leased batches, so the caller ``retire``s it after
        the flip to drain and release it.  Raises ``ModelNotFoundError``
        when nothing is retained (rollback window already closed or no
        retaining swap happened).

        Like ``activate`` this is one atomic pointer flip under the
        registry lock: a request leasing concurrently gets either the bad
        version (its batch completes under the lease) or the restored
        one — never an error, never a dropped request."""
        with self._cv:
            prev = self._previous.pop(name, None)
            if prev is None:
                raise ModelNotFoundError(
                    f"no retained previous version of {name!r} to roll "
                    f"back to")
            displaced = self._active.get(name)
            prev.state = ACTIVE
            self._active[name] = prev
            if displaced is not None:
                self._history.append(displaced)
                del self._history[:-self.HISTORY_LIMIT]
            self._cv.notify_all()
            return prev, displaced

    def retained(self, name: str) -> Optional[ModelVersion]:
        with self._cv:
            return self._previous.get(name)

    def release_retained(self, name: str) -> Optional[ModelVersion]:
        """Close the rollback window: pop the retained previous version
        (watch window passed cleanly) and move it to the history.  The
        caller ``retire``s the returned version to drain its in-flight
        batches and release the model reference; returns None when
        nothing is retained."""
        with self._cv:
            mv = self._previous.pop(name, None)
            if mv is not None:
                self._history.append(mv)
                del self._history[:-self.HISTORY_LIMIT]
            return mv

    def remove(self, name: str) -> Optional[ModelVersion]:
        """Drop ``name`` from the active map entirely (canary teardown —
        the route name stops existing rather than being replaced).
        Returns the removed version, moved to the history with its model
        intact; the caller ``retire``s it to drain in-flight batches and
        release the weights.  None when the name was never registered."""
        with self._cv:
            mv = self._active.pop(name, None)
            stale = self._previous.pop(name, None)
            for m in (mv, stale):
                if m is not None:
                    self._history.append(m)
            del self._history[:-self.HISTORY_LIMIT]
            self._cv.notify_all()
            return mv

    def register(self, name: str, model, example=None,
                 version: Optional[int] = None) -> ModelVersion:
        """Shorthand: new version activated immediately (startup path —
        hot-swaps go through the engine so they warm up first)."""
        mv = self.new_version(name, model, example, version)
        self.activate(mv)
        return mv

    def retire(self, mv: ModelVersion, timeout: float = 30.0) -> bool:
        """Wait for ``mv``'s in-flight batches to drain, then mark it
        retired and release its model reference (weights freed; history
        keeps the metadata).  Returns False if the drain timed out
        (version left un-retired with its model intact; callers may
        retry)."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while mv.inflight > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cv.wait(remaining)
            mv.state = RETIRED
            model, mv.model = mv.model, None
        with capture_lock:
            # the version's captured graphs are freed here, never in the
            # middle of another thread's capture (and not left to the
            # cyclic collector: a program's body refers to its net)
            cap.release(model)
            del model
        return True

    # ------------------------------------------------------------- reading
    def active(self, name: str) -> ModelVersion:
        with self._cv:
            mv = self._active.get(name)
            if mv is None:
                raise ModelNotFoundError(
                    f"no model registered under {name!r} "
                    f"(have: {sorted(self._active)})")
            return mv

    def names(self) -> List[str]:
        with self._cv:
            return sorted(self._active)

    def as_dict(self) -> dict:
        with self._cv:
            return {
                "active": {n: mv.as_dict()
                           for n, mv in self._active.items()},
                "retained": {n: mv.as_dict()
                             for n, mv in self._previous.items()},
                "retired": [mv.as_dict() for mv in self._history],
            }

    # -------------------------------------------------------------- leases
    @contextlib.contextmanager
    def lease(self, name: str):
        """Pin the CURRENT active version for the duration of one batch
        execution.  The swap path never blocks on leases — it only waits
        in ``retire`` for them to drain."""
        with self._cv:
            mv = self._active.get(name)
            if mv is None:
                raise ModelNotFoundError(
                    f"no model registered under {name!r} "
                    f"(have: {sorted(self._active)})")
            mv.inflight += 1
        try:
            yield mv
        finally:
            with self._cv:
                mv.inflight -= 1
                self._cv.notify_all()


def load_version_from_checkpoint(registry: ModelRegistry, name: str, path,
                                 example=None, device=None) -> ModelVersion:
    """Build a PENDING version from a ``models/serialization.py``
    checkpoint zip, restored onto ``device`` (the card unless the caller
    asks for the CPU).  A ``serving_version`` entry in the checkpoint
    manifest (the reference's ``write_model(extra_manifest=...)``) pins
    the version number; otherwise the registry's per-name counter
    assigns one."""
    from deeplearning4j_tpu_torch.models import serialization

    model = serialization.load_model(path, device=device,
                                     load_updater=False)
    version = serialization.read_manifest(path).get("serving_version")
    return registry.new_version(name, model, example=example,
                                version=version)
