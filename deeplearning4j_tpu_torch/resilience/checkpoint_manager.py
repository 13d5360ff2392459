"""Async checkpointing with atomic commit, retention, and discovery.

The low-level ``parallel/checkpoint.py`` writes shard files straight into
the live directory — fine for an explicit, supervised save, fatal for a
production run where the writer can die mid-file.  ``CheckpointManager``
is the production path:

- **snapshot on the step boundary** — ``save()`` copies the device arrays
  to host on the calling (training) thread via ``snapshot_trees`` (the
  only part that must see a consistent step), then hands the plain host
  data to a background writer thread: training resumes while serialization
  and fsync happen off-thread;
- **atomic commit** — the writer stages all files in ``step-N.tmp/``,
  fsyncs them, writes a ``COMMIT`` manifest (per-file sizes + CRC32s)
  last, then renames ``step-N.tmp/`` -> ``step-N/`` and fsyncs the parent
  directory.  A crash at ANY point leaves either a previous committed
  checkpoint or an ignorable ``.tmp`` — never a torn ``step-N/``;
- **discovery** — ``latest()`` walks committed directories newest-first
  and returns the first that VERIFIES (every file listed in COMMIT
  present, sizes and CRCs matching), so truncated or bit-flipped
  snapshots are skipped, not served;
- **retention** — keep the newest ``keep`` checkpoints, plus (optionally)
  every ``archive_every_steps``-th step forever (the keep-every-H
  archival tier for post-hoc analysis);
- **triggers** — step interval, wall-clock interval, explicit call, or a
  priority request (what ``PreemptionHandler`` files from its signal
  handler).

Metric families (docs/observability.md): ``dl4j_checkpoint_saves_total``,
``dl4j_checkpoint_save_seconds``, ``dl4j_checkpoint_last_bytes``,
``dl4j_checkpoint_bytes_total``, ``dl4j_checkpoint_failures_total``,
``dl4j_checkpoint_restores_total`` and the
``dl4j_checkpoint_staleness_seconds`` gauge that the
``max_checkpoint_staleness`` HealthRule reads — a run that silently
stopped checkpointing fails ``/health`` before the loss of progress is
discovered the hard way.

Multi-host note: the reference's manager is the single-controller path
(every process's arrays visible to one process) and leaves a multi-host
commit to an external commit barrier over this file-based protocol; the
port adopts the protocol across processes itself (below).

Port: a copy of ``deeplearning4j_tpu/resilience/checkpoint_manager.py`` with its imports
rewritten to the port. It stages, commits and restores through
the port's ``parallel/checkpoint.py``, whose snapshot copies every
leaf to host memory on the training thread and whose restore writes
into the net's live tensors; with ``mesh=`` through the resharded
restore (``parallel/checkpoint.py``).

**Across processes** (a ``torch.distributed`` group is up; one process a
card, every rank sharing the run directory) a save is collective: every
rank calls it at the same step, the masters through ``FitResilience``.
Each process snapshots its own blocks (``snapshot_trees`` over the
``mesh`` that spans the processes: ``parallel/checkpoint.py``'s
per-process layout, process 0 the replicated leaves and the meta).
There is one commit, for one process and for many: the file-based
protocol above with barriers around process 0's rename: (1) process 0
clears ``step-N.tmp/`` (or finds the step already committed) and every
rank learns which, (2) every process stages its shard file and manifest
there, fsynced, (3) a barrier, then process 0 lists every process's
files in ``COMMIT``, renames ``step-N.tmp/`` to ``step-N/`` (the commit
point) and prunes (retention and stray ``.tmp`` dirs run on process 0
only), (4) a barrier.  Each barrier carries every rank's status, so a
failure anywhere fails the commit on every rank and none reports a step
that did not commit; in one process it passes the process's own status
through, and a failed staging's ``.tmp`` is removed there too.  The
barriers run on a gloo group of the manager's
own (``backend/mesh.host_group``, made by the first save on the
training thread, the same point on every rank), never on the group the
training thread's gradient exchange uses: the async writer thread's
barriers would otherwise be unordered against that exchange, and could
deadlock or cross its messages.  Being gloo, the group takes host
tensors under NCCL too (a world of one included).  ``resume`` and a
``restore`` that discovers its checkpoint first drain the writer, then
take process 0's choice of step, so no rank picks another step because
it listed the directory at another moment.  The result restores in the
JAX package and in one process like any two-process save.
"""

from __future__ import annotations

import json
import os
import queue
import shutil
import threading
import time
import weakref
import zlib
from typing import Any, Dict, List, Optional, Tuple

from deeplearning4j_tpu_torch.parallel.checkpoint import (
    restore_checkpoint, snapshot_trees, write_snapshot,
)

_SAVES = "dl4j_checkpoint_saves_total"
_SAVE_SECONDS = "dl4j_checkpoint_save_seconds"
_LAST_BYTES = "dl4j_checkpoint_last_bytes"
_BYTES_TOTAL = "dl4j_checkpoint_bytes_total"
_STALENESS = "dl4j_checkpoint_staleness_seconds"
_RESTORES = "dl4j_checkpoint_restores_total"
_FAILURES = "dl4j_checkpoint_failures_total"

COMMIT_FILE = "COMMIT"
_STEP_PREFIX = "step-"
_STEP_DIGITS = 8


def _crc32(path: str, chunk: int = 1 << 20) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            buf = f.read(chunk)
            if not buf:
                return crc
            crc = zlib.crc32(buf, crc)


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


class CheckpointError(RuntimeError):
    pass


class _Job:
    __slots__ = ("step", "snapshot", "trigger", "replace", "done", "error",
                 "bytes", "group")

    def __init__(self, step: int, snapshot: Dict[str, Any], trigger: str,
                 replace: bool = False, group=None):
        self.step = step
        self.snapshot = snapshot
        self.trigger = trigger
        self.replace = replace
        self.done = threading.Event()
        self.error: Optional[BaseException] = None
        self.bytes = 0
        self.group = group          # across processes: the commit's group

    def wait(self, timeout: Optional[float] = None) -> None:
        if not self.done.wait(timeout):
            raise CheckpointError(
                f"checkpoint step-{self.step} not committed within "
                f"{timeout}s")
        if self.error is not None:
            raise self.error


class CheckpointManager:
    """Async atomic checkpointing for one run directory (module docstring).

    Parameters: ``keep`` — committed checkpoints retained (newest-first);
    ``archive_every_steps`` — additionally keep every multiple of this
    step count forever; ``save_every_steps`` / ``save_every_seconds`` —
    ``maybe_save`` triggers; ``async_save=False`` makes every save commit
    on the calling thread (early stopping, tests); ``verify_crc`` — check
    CRC32s during ``latest()`` discovery (sizes are always checked);
    ``fault_injector`` — explicit injector for the writer hooks (defaults
    to the process-global one, see ``resilience.faults``).
    """

    def __init__(self, directory: str, *, keep: int = 3,
                 archive_every_steps: Optional[int] = None,
                 save_every_steps: Optional[int] = None,
                 save_every_seconds: Optional[float] = None,
                 async_save: bool = True, auto_resume: bool = True,
                 verify_crc: bool = True, fault_injector=None,
                 registry=None):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.directory = str(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep = int(keep)
        self.archive_every_steps = archive_every_steps
        self.save_every_steps = save_every_steps
        self.save_every_seconds = save_every_seconds
        self.async_save = bool(async_save)
        self.auto_resume = bool(auto_resume)
        self.verify_crc = bool(verify_crc)
        self._injector = fault_injector
        self._registry = registry
        self._lock = threading.Lock()
        self._priority = False
        self._start_mono = time.monotonic()
        self._last_commit_mono: Optional[float] = None
        self._last_mark_step = 0           # last step a save was TRIGGERED at
        self._last_mark_time = time.monotonic()
        self._last_queued_step: Optional[int] = None
        self.last_committed_step: Optional[int] = None
        self.last_error: Optional[BaseException] = None
        self._queue: "queue.Queue[Optional[_Job]]" = queue.Queue(maxsize=1)
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        self._register_staleness_gauge()

    # ------------------------------------------------------------- metrics
    def _reg(self):
        if self._registry is not None:
            return self._registry
        from deeplearning4j_tpu_torch.observability import get_registry

        return get_registry()

    def _register_staleness_gauge(self) -> None:
        ref = weakref.ref(self)

        def staleness() -> float:
            m = ref()
            if m is None:
                return float("nan")
            with m._lock:
                last = (m._last_commit_mono if m._last_commit_mono is not None
                        else m._start_mono)
            return time.monotonic() - last

        # the ABSOLUTE path: basenames collide (every CheckpointModelSaver
        # has a "best/" and a "latest/"), and a collision replaces the
        # other manager's gauge callback — blinding the staleness rule
        self.label = os.path.abspath(self.directory)
        self._reg().gauge(
            _STALENESS, "Seconds since this manager's last committed (or "
            "restored) checkpoint — counted from manager creation before "
            "the first commit, so a run that never checkpoints also trips "
            "the max_checkpoint_staleness health rule",
            labels=("directory",)
        ).set_function(staleness, directory=self.label)

    # ----------------------------------------------------------- discovery
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory,
                            f"{_STEP_PREFIX}{step:0{_STEP_DIGITS}d}")

    def _committed(self) -> List[Tuple[int, str]]:
        """(step, path) of committed (renamed) checkpoint dirs, ascending.
        Validity is NOT checked here — ``latest()`` does that on demand."""
        out = []
        try:
            names = os.listdir(self.directory)
        except FileNotFoundError:
            return []
        for name in names:
            if not name.startswith(_STEP_PREFIX) or name.endswith(".tmp"):
                continue
            try:
                step = int(name[len(_STEP_PREFIX):])
            except ValueError:
                continue
            out.append((step, os.path.join(self.directory, name)))
        return sorted(out)

    def read_commit(self, path: str) -> Optional[Dict[str, Any]]:
        try:
            with open(os.path.join(path, COMMIT_FILE)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _valid(self, path: str) -> bool:
        """A committed checkpoint verifies iff every file its COMMIT
        manifest lists exists with the recorded size (and CRC32, when
        ``verify_crc``)."""
        commit = self.read_commit(path)
        if not commit or not commit.get("files"):
            return False
        for name, info in commit["files"].items():
            p = os.path.join(path, name)
            try:
                if os.path.getsize(p) != info["size"]:
                    return False
                if self.verify_crc and _crc32(p) != info["crc32"]:
                    return False
            except OSError:
                return False
        return True

    def latest(self) -> Optional[str]:
        """Path of the newest VALID committed checkpoint (torn, truncated,
        or corrupted snapshots are skipped), or None."""
        for step, path in reversed(self._committed()):
            if self._valid(path):
                return path
        return None

    def latest_step(self) -> Optional[int]:
        path = self.latest()
        if path is None:
            return None
        commit = self.read_commit(path)
        return int(commit["step"]) if commit else None

    def _agreed_path(self, choose) -> Optional[str]:
        """``choose()``'s path (a committed step directory or None): in
        one process its own, across processes process 0's, handed to
        every rank as its step after the writer is drained."""
        from deeplearning4j_tpu_torch.backend import mesh as mesh_mod

        if not mesh_mod.processes_up():
            return choose()
        self.wait_idle()
        path = choose() if mesh_mod.process_index() == 0 else None
        step = -1
        if path is not None:
            step = int(os.path.basename(path)[len(_STEP_PREFIX):])
        step = mesh_mod.process_agree(step)
        return None if step < 0 else self._step_dir(step)

    def all_steps(self) -> List[int]:
        return [s for s, _ in self._committed()]

    # ------------------------------------------------------------- triggers
    def request_priority_save(self) -> None:
        """Flag a priority save (async-signal-safe: plain attribute set).
        The next ``maybe_save``/``due`` honors it regardless of
        intervals.  Deliberately lock-free: this runs inside the SIGTERM
        handler, which executes on the main thread — if that thread
        already holds ``_lock`` (mid-``save``), acquiring it here would
        self-deadlock.  A one-way bool flip is atomic under the GIL and
        ``save`` clears it under the lock afterwards."""
        # dl4jlint: disable-next-line=lock-discipline -- signal-handler path: taking _lock here can self-deadlock; atomic bool publish
        self._priority = True

    def due(self, step: Optional[int] = None) -> Optional[str]:
        """The trigger that makes a save due now, or None."""
        # dl4jlint: disable-next-line=lock-discipline -- atomic bool read of the signal-published flag; save() clears it under _lock
        if self._priority:
            return "priority"
        with self._lock:
            mark_step, mark_time = self._last_mark_step, self._last_mark_time
        if (self.save_every_steps is not None and step is not None
                and step - mark_step >= self.save_every_steps):
            return "step_interval"
        if (self.save_every_seconds is not None
                and time.monotonic() - mark_time >= self.save_every_seconds):
            return "time_interval"
        return None

    def maybe_save(self, net, block: bool = False) -> Optional[str]:
        """Save if a trigger is due; returns the trigger used or None.
        The fit loops call this once per step/window boundary."""
        trigger = self.due(int(getattr(net, "iteration", 0)))
        if trigger is None:
            return None
        self.save(net, trigger=trigger, block=block)
        return trigger

    def save_if_stale(self, net, trigger: str = "preempt",
                      block: bool = True, trees=None, mesh=None) -> bool:
        """Commit the current state unless a save at this step was already
        queued/committed; used on the preemption path so the stop never
        double-writes.  Always drains the writer when ``block``.  Across
        processes every rank reaches the same answer (they queue the same
        saves, and a commit's outcome is every rank's)."""
        step = int(getattr(net, "iteration", 0))
        with self._lock:
            covered = (self._last_queued_step is not None
                       and self._last_queued_step >= step)
        if covered and block:
            # a QUEUED save only covers the step if it actually COMMITS —
            # an async write failure (ENOSPC, IO error) must not skip the
            # last-chance preemption save
            self.wait_idle()
            with self._lock:
                covered = (self.last_committed_step is not None
                           and self.last_committed_step >= step)
        if not covered:
            self.save(net, trigger=trigger, block=block, trees=trees,
                      mesh=mesh)
            return True
        return False

    # ----------------------------------------------------------------- save
    def save(self, net, *, trigger: str = "explicit",
             block: Optional[bool] = None, trees=None,
             replace: bool = False, mesh=None) -> _Job:
        """Snapshot now (device->host on this thread), commit async (or
        inline when ``async_save=False`` / ``block=True`` waits).  A step
        already committed is kept as it is (the same step of one run holds
        the same state) unless ``replace``: a state written back over the
        run's (the online pipeline's revert of a rejected window) then
        takes the step's place.  While a process group is up the save is
        collective (module docstring): ``trees`` over ``mesh`` (a mesh
        that spans the processes; without one, the net's trees
        replicated, written by process 0)."""
        if self._closed:
            raise CheckpointError("CheckpointManager is closed")
        from deeplearning4j_tpu_torch.backend import mesh as mesh_mod

        group = None
        if mesh_mod.processes_up():
            if mesh is None or not mesh.spans_processes:
                w = mesh_mod.process_count()
                mesh = mesh_mod.default_mesh(data=w, devices=[net.device] * w)
            # made here, on the training thread, at the same save on
            # every rank; the writer thread's barriers use it alone
            group = mesh_mod.host_group(f"commit:{self.label}")
        try:
            snapshot = snapshot_trees(net, trees=trees, mesh=mesh)
            failed = None
        except BaseException as e:
            self._reg().counter(
                _FAILURES, "Checkpoint attempts that failed, by stage "
                "(snapshot = device->host copy on the training thread, "
                "write = staging/commit on the writer)",
                labels=("stage",)).inc(stage="snapshot")
            if group is None:
                raise
            failed = e
        if group is not None and mesh_mod.process_any(failed is not None):
            # one rank's failed snapshot fails the save on every rank
            raise failed if failed is not None else CheckpointError(
                f"checkpoint step-{int(getattr(net, 'iteration', 0))}: "
                "another rank's snapshot failed")
        job = _Job(snapshot["iteration"], snapshot, trigger, replace, group)
        with self._lock:
            self._last_mark_step = job.step
            self._last_mark_time = time.monotonic()
            self._last_queued_step = max(self._last_queued_step or 0,
                                         job.step)
            if trigger in ("priority", "preempt"):
                self._priority = False
        if not self.async_save:
            self._run_job(job)
            job.wait(0)
            return job
        self._ensure_thread()
        # maxsize-1 queue: if a previous save is still staging, this put
        # blocks — backpressure instead of a growing host-memory backlog
        self._queue.put(job)
        if block:
            job.wait()
        return job

    def wait_idle(self, timeout: Optional[float] = None) -> None:
        """Block until every queued save has committed (or failed)."""
        if self._thread is None:
            return
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._queue.mutex:
                idle = self._queue.unfinished_tasks == 0
            if idle:
                return
            if deadline is not None and time.monotonic() > deadline:
                raise CheckpointError(f"writer still busy after {timeout}s")
            time.sleep(0.005)

    def close(self) -> None:
        """Drain and stop the writer thread."""
        if self._closed:
            return
        self._closed = True
        if self._thread is not None:
            self._queue.put(None)
            self._thread.join(timeout=30)
            self._thread = None

    def __enter__(self) -> "CheckpointManager":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    # ------------------------------------------------------------ writer
    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._writer_loop, name="dl4j-checkpoint-writer",
                daemon=True)
            self._thread.start()

    def _writer_loop(self) -> None:
        while True:
            job = self._queue.get()
            try:
                if job is None:
                    return
                self._run_job(job)
            finally:
                self._queue.task_done()

    def _on_file(self, path: str) -> None:
        inj = self._injector
        if inj is None:
            from deeplearning4j_tpu_torch.resilience.faults import get_fault_injector

            inj = get_fault_injector()
        if inj is not None:
            inj.on_checkpoint_file(path)

    def _run_job(self, job: _Job) -> None:
        from deeplearning4j_tpu_torch.observability import get_flight_recorder

        reg = self._reg()
        t0 = time.perf_counter()
        try:
            job.bytes = self._commit(job)
        except BaseException as e:
            job.error = e
            self.last_error = e
            reg.counter(
                _FAILURES, "Checkpoint attempts that failed, by stage "
                "(snapshot = device->host copy on the training thread, "
                "write = staging/commit on the writer)",
                labels=("stage",)).inc(stage="write")
            get_flight_recorder().record(
                "checkpoint_error", step=job.step, trigger=job.trigger,
                error=repr(e))
            return
        finally:
            job.done.set()
        dt = time.perf_counter() - t0
        with self._lock:
            self._last_commit_mono = time.monotonic()
            self.last_committed_step = job.step
        reg.counter(
            _SAVES, "Committed checkpoint saves by trigger "
            "(step_interval / time_interval / priority / preempt / "
            "explicit / best / latest / final)",
            labels=("trigger",)).inc(trigger=job.trigger)
        reg.histogram(
            _SAVE_SECONDS, "Serialize + fsync + atomic-commit wall time "
            "per checkpoint (writer thread; excludes the on-thread "
            "device->host snapshot)").observe(dt)
        reg.gauge(_LAST_BYTES,
                  "Bytes of the most recently committed checkpoint"
                  ).set(float(job.bytes))
        reg.counter(_BYTES_TOTAL,
                    "Total checkpoint bytes committed by this process"
                    ).inc(float(job.bytes))
        get_flight_recorder().record(
            "checkpoint", directory=self.directory, step=job.step,
            trigger=job.trigger, bytes=job.bytes,
            seconds=round(dt, 4), committed=True)

    def _commit(self, job: _Job) -> int:
        """Stage, barrier, process 0's COMMIT and rename, barrier (module
        docstring).  Every barrier carries every rank's status (0 go, 1
        already committed, 2 failed) over ``job.group``; in one process
        (no group) it passes this process's own status through."""
        from deeplearning4j_tpu_torch.backend import mesh as mesh_mod

        final = self._step_dir(job.step)
        tmp = final + ".tmp"
        lead = job.group is None or mesh_mod.process_index() == 0
        error: Optional[BaseException] = None

        def barrier(code: int, stage: str) -> int:
            codes = ([code] if job.group is None else
                     mesh_mod.process_codes([code], job.group)[:, 0])
            bad = [r for r, c in enumerate(codes) if c == 2]
            if bad:
                if error is not None:
                    raise error
                raise CheckpointError(
                    f"checkpoint step-{job.step}: {stage} failed on "
                    f"rank(s) {bad}")
            return int(codes[0])

        code = 0
        if lead:
            try:
                if os.path.isdir(final):
                    if self._valid(final) and not job.replace:
                        code = 1    # an identical step is already committed
                    else:
                        shutil.rmtree(final)
                if code == 0:
                    if os.path.isdir(tmp):
                        shutil.rmtree(tmp)
                    os.makedirs(tmp)
            except BaseException as e:
                error, code = e, 2
        if barrier(code, "preparing") == 1:
            return 0
        nbytes = 0
        try:
            nbytes = write_snapshot(tmp, job.snapshot, fsync=True,
                                    on_file=self._on_file)
            code = 0
        except BaseException as e:
            error, code = e, 2
        try:
            barrier(code, "staging")
        except BaseException:
            if lead:
                shutil.rmtree(tmp, ignore_errors=True)
            raise
        if lead:
            try:
                nbytes += self._seal(job, tmp, final)
                code = 0
            except BaseException as e:
                error, code = e, 2
        barrier(code, "the commit")
        return nbytes

    def _seal(self, job: _Job, tmp: str, final: str) -> int:
        """COMMIT over every file staged in ``tmp``, then the rename (the
        commit point) and retention (process 0's); returns COMMIT's
        bytes."""
        files = {}
        for name in sorted(os.listdir(tmp)):
            p = os.path.join(tmp, name)
            files[name] = {"size": os.path.getsize(p), "crc32": _crc32(p)}
        commit = {
            "format_version": 1,
            "step": job.step,
            "iteration": job.snapshot["iteration"],
            "trigger": job.trigger,
            "wall_time": time.time(),
            "files": files,
        }
        commit_path = os.path.join(tmp, COMMIT_FILE)
        with open(commit_path, "w") as f:
            json.dump(commit, f)
            f.flush()
            os.fsync(f.fileno())
        self._on_file(commit_path)
        os.rename(tmp, final)          # the commit point
        _fsync_dir(self.directory)
        self._prune()
        return os.path.getsize(os.path.join(final, COMMIT_FILE))

    # ------------------------------------------------------------ retention
    def _prune(self) -> None:
        committed = self._committed()
        steps = [s for s, _ in committed]
        protect = set(steps[-self.keep:])
        if self.archive_every_steps:
            protect |= {s for s in steps
                        if s and s % self.archive_every_steps == 0}
        for step, path in committed:
            if step not in protect:
                shutil.rmtree(path, ignore_errors=True)
        # stray .tmp dirs from crashed writers are dead weight once a
        # newer commit exists (the single writer thread means none can be
        # in flight while we are here)
        for name in os.listdir(self.directory):
            if name.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.directory, name),
                              ignore_errors=True)

    # -------------------------------------------------------------- restore
    def restore(self, net=None, *, mesh=None, step: Optional[int] = None,
                path: Optional[str] = None):
        """Restore the newest valid checkpoint (or ``step=``) into ``net``
        (in place, incl. iteration + RNG stream).  Returns
        ``(params, updater_state, net_state, iteration)`` like the
        low-level API; raises ``FileNotFoundError`` when nothing valid is
        committed.  ``path=`` skips discovery for an ALREADY-VALIDATED
        directory (``resume()`` passes the one its ``latest()`` call just
        CRC-verified, so the full scan is not paid twice)."""
        from deeplearning4j_tpu_torch.backend import mesh as mesh_mod
        from deeplearning4j_tpu_torch.observability import get_flight_recorder

        if mesh_mod.processes_up():
            self.wait_idle()       # every rank's commits are in place
        if path is None:
            if step is not None:
                path = self._step_dir(step)
                if not self._valid(path):
                    raise FileNotFoundError(
                        f"no valid committed checkpoint for step {step} in "
                        f"{self.directory}")
            else:
                path = self._agreed_path(self.latest)
                if path is None:
                    raise FileNotFoundError(
                        f"no valid committed checkpoint in {self.directory}")
        out = restore_checkpoint(path, net, mesh=mesh)
        self._reg().counter(
            _RESTORES, "Checkpoint restores served by a CheckpointManager "
            "(explicit restore() plus fit-loop auto-resume)").inc()
        with self._lock:
            # a fresh restore is as good as a fresh commit for staleness:
            # the recoverable point IS this checkpoint
            self._last_commit_mono = time.monotonic()
            self._last_mark_step = out[3]
            self._last_mark_time = time.monotonic()
        attrs = {}
        if mesh is not None:
            # topology portability (parallel.checkpoint resharded restore):
            # record WHERE the snapshot landed — a resumed-on-a-new-mesh or
            # promoted-into-serving restore is visible in the post-mortem
            attrs["mesh"] = "x".join(
                str(mesh.shape[a]) for a in mesh.axis_names)
        get_flight_recorder().record(
            "checkpoint_restore", directory=self.directory,
            path=path, iteration=out[3], **attrs)
        return out

    def resume(self, net, *, mesh=None) -> Optional[int]:
        """Auto-resume: when a valid committed checkpoint is AHEAD of
        ``net`` (its iteration exceeds ``net.iteration``), restore it in
        place and return the restored iteration; otherwise leave ``net``
        untouched and return None.  The fit loops call this on entry when
        given a manager with ``auto_resume=True``.

        ``mesh`` need NOT match the topology that saved: the resharded
        restore (``parallel.checkpoint``) maps any saved layout onto any
        target mesh — a 2x4 checkpoint resumes on 1x8, a K=4 run resumes
        on K=2, a training snapshot promotes into a differently-sharded
        serving mesh — with no global host gather of a sharded leaf.

        Cost discipline: the cheap COMMIT manifest decides "is it ahead?"
        BEFORE the full size+CRC verification — a fit entry that has
        nothing to resume (the common case) never reads the checkpoint
        bytes.  Torn/invalid snapshots still fall through to older ones.
        Across processes process 0 chooses and every rank restores its
        choice."""
        entry = int(getattr(net, "iteration", 0))
        path = self._agreed_path(lambda: self._ahead(entry))
        if path is None:
            return None
        self.restore(net, mesh=mesh, path=path)
        return int(net.iteration)

    def _ahead(self, entry: int) -> Optional[str]:
        """The newest valid committed checkpoint ahead of iteration
        ``entry``, or None."""
        for step, path in reversed(self._committed()):
            commit = self.read_commit(path)
            if commit is None:
                continue               # torn: no COMMIT — try older
            if int(commit["iteration"]) <= entry:
                return None            # newest committed is not ahead
            if self._valid(path):
                return path
            # corrupt despite COMMIT: an older snapshot may still be ahead
        return None
