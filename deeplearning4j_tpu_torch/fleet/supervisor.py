"""ReplicaSupervisor: spawn / monitor / restart subprocess replicas.

The process-lifecycle quarter of the fleet control plane: port
assignment (bind-probe for a free port), warmup barrier (a replica
joins the fleet only after its ``/healthz`` answers 200, which in
``replica_main`` happens strictly after the engine warmed (on the card:
captured) every bucket — a cold replica must never take traffic), and
crash → restart → rejoin (a restarted replica is a new process, hence a fresh
publisher epoch that the fleet aggregator re-bases and the router's
death-mark logic reads as a rejoin).  Restarts are capped per replica;
a replica that keeps dying stays down and stays drained.

Stdlib-only on purpose (subprocess/socket/threading + the metrics
registry): the supervisor must keep working while the thing it
supervises is the part that is broken.

Copied from ``deeplearning4j_tpu/fleet/supervisor.py``; it spawns
``python -m deeplearning4j_tpu_torch.fleet.replica_main`` with
``subprocess`` (never a ``fork`` of a process that holds a CUDA
context).  Each replica is a process of its own with its own CUDA
context, weights, KV pools and captured graphs; on one card they share
the SMs.  The caller builds the kernels before it spawns a replica, so
that the replicas load the built libraries rather than each compiling
them (``helpers/cuda_build.py`` publishes a build atomically).
"""

from __future__ import annotations

import logging
import os
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from typing import Any, Dict, List, Optional

from deeplearning4j_tpu_torch.fleet.replica import HTTPReplica
from deeplearning4j_tpu_torch.observability.metrics import get_registry

logger = logging.getLogger("deeplearning4j_tpu_torch.fleet")

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class ReplicaProcess:
    """Bookkeeping for one supervised replica."""

    __slots__ = ("worker_id", "port", "proc", "args", "restarts",
                 "restartable", "log_path")

    def __init__(self, worker_id: str, port: int, proc, args: List[str],
                 log_path: str):
        self.worker_id = worker_id
        self.port = port
        self.proc = proc
        self.args = args
        self.restarts = 0
        self.restartable = True
        self.log_path = log_path

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def log_tail(self, n: int = 30) -> str:
        try:
            with open(self.log_path, "r", errors="replace") as f:
                return "".join(f.readlines()[-n:])
        except OSError:
            return "<no log>"


class ReplicaSupervisor:
    """See module docstring."""

    def __init__(self, *, broker_url: Optional[str] = None,
                 topic: str = "fleet.telemetry",
                 python: str = sys.executable,
                 warmup_timeout_s: float = 120.0,
                 restart: bool = True, max_restarts: int = 2,
                 poll_interval_s: float = 0.25,
                 registry=None, log_dir: Optional[str] = None,
                 replica_args: Optional[Dict[str, Any]] = None):
        self.broker_url = broker_url
        self.topic = topic
        self.python = python
        self.warmup_timeout_s = float(warmup_timeout_s)
        self.restart = bool(restart)
        self.max_restarts = int(max_restarts)
        self.poll_interval_s = float(poll_interval_s)
        self.log_dir = log_dir or tempfile.mkdtemp(prefix="dl4j_fleet_")
        # per-fleet replica_main defaults (slots, step-floor-ms, ...)
        self.replica_args = dict(replica_args or {})
        self.registry = registry or get_registry()
        self._m_restarts = self.registry.counter(
            "dl4j_fleet_supervisor_restarts_total",
            "Replica processes restarted after a crash",
            labels=("worker",))
        self._procs: Dict[str, ReplicaProcess] = {}
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._monitor: Optional[threading.Thread] = None
        self.on_restart = None     # hook(worker_id, ReplicaProcess)

    # ------------------------------------------------------------- spawning
    def _cmd(self, worker_id: str, port: int,
             overrides: Dict[str, Any]) -> List[str]:
        merged = dict(self.replica_args)
        merged.update(overrides)
        cmd = [self.python, "-m",
               "deeplearning4j_tpu_torch.fleet.replica_main",
               "--worker-id", worker_id, "--port", str(port)]
        if self.broker_url:
            cmd += ["--broker-url", self.broker_url, "--topic", self.topic]
        for k, v in sorted(merged.items()):
            cmd += [f"--{k.replace('_', '-')}", str(v)]
        return cmd

    def _spawn(self, worker_id: str, port: int,
               args: List[str]) -> ReplicaProcess:
        env = dict(os.environ)
        # the replica imports the package by name: make sure the repo
        # root wins however the parent was launched
        env["PYTHONPATH"] = _REPO_ROOT + os.pathsep + env.get(
            "PYTHONPATH", "")
        log_path = os.path.join(self.log_dir, f"{worker_id}.log")
        log_f = open(log_path, "ab")
        try:
            proc = subprocess.Popen(args, stdout=log_f, stderr=log_f,
                                    env=env, cwd=_REPO_ROOT)
        finally:
            log_f.close()   # the child holds its own fd now
        return ReplicaProcess(worker_id, port, proc, args, log_path)

    def _wait_ready(self, rp: ReplicaProcess) -> None:
        """Warmup barrier: block until /healthz answers 200 (the engine
        warmed first — see replica_main) or the process dies."""
        deadline = time.monotonic() + self.warmup_timeout_s
        while time.monotonic() < deadline:
            if not rp.alive():
                raise RuntimeError(
                    f"replica {rp.worker_id} died during warmup "
                    f"(rc={rp.proc.returncode}):\n{rp.log_tail()}")
            try:
                with urllib.request.urlopen(f"{rp.url}/healthz",
                                            timeout=2.0) as resp:
                    if resp.status == 200:
                        return
            except OSError:
                pass
            time.sleep(0.1)
        raise TimeoutError(
            f"replica {rp.worker_id} not ready after "
            f"{self.warmup_timeout_s}s:\n{rp.log_tail()}")

    def start_replica(self, worker_id: str, port: Optional[int] = None,
                      wait_ready: bool = True,
                      **overrides) -> ReplicaProcess:
        with self._lock:
            if worker_id in self._procs and self._procs[worker_id].alive():
                raise RuntimeError(f"replica {worker_id} already running")
            port = port or free_port()
            rp = self._spawn(worker_id, port,
                             self._cmd(worker_id, port, overrides))
            self._procs[worker_id] = rp
        if wait_ready:
            try:
                self._wait_ready(rp)
            except Exception:
                self.stop_replica(worker_id)
                raise
        return rp

    def handle(self, worker_id: str, timeout: float = 60.0) -> HTTPReplica:
        with self._lock:
            rp = self._procs[worker_id]
        return HTTPReplica(worker_id, rp.url, timeout=timeout)

    def handles(self, timeout: float = 60.0) -> Dict[str, HTTPReplica]:
        with self._lock:
            ids = list(self._procs)
        return {wid: self.handle(wid, timeout=timeout) for wid in ids}

    def processes(self) -> Dict[str, ReplicaProcess]:
        with self._lock:
            return dict(self._procs)

    # ----------------------------------------------------------- monitoring
    def start(self) -> "ReplicaSupervisor":
        """Start the crash monitor (restart-on-death loop)."""
        if self._monitor is not None and self._monitor.is_alive():
            return self
        self._stop.clear()
        self._monitor = threading.Thread(target=self._run,
                                         name="fleet-supervisor",
                                         daemon=True)
        self._monitor.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            with self._lock:
                dead = [rp for rp in self._procs.values()
                        if not rp.alive() and rp.restartable]
            for rp in dead:
                if self._stop.is_set():
                    return
                self._restart(rp)

    def _restart(self, rp: ReplicaProcess) -> None:
        if not self.restart or rp.restarts >= self.max_restarts:
            if rp.restartable:
                rp.restartable = False
                logger.warning(
                    "fleet supervisor: replica %s down for good "
                    "(rc=%s, restarts=%d)", rp.worker_id,
                    rp.proc.returncode, rp.restarts)
            return
        logger.warning("fleet supervisor: restarting replica %s "
                       "(rc=%s)", rp.worker_id, rp.proc.returncode)
        new = self._spawn(rp.worker_id, rp.port, rp.args)
        new.restarts = rp.restarts + 1
        with self._lock:
            self._procs[rp.worker_id] = new
        self._m_restarts.inc(worker=rp.worker_id)
        try:
            self._wait_ready(new)
        except Exception:
            logger.warning("fleet supervisor: replica %s failed warmup "
                           "after restart", rp.worker_id, exc_info=True)
            return
        hook = self.on_restart
        if hook is not None:
            try:
                hook(rp.worker_id, new)
            except Exception:
                logger.warning("fleet supervisor: on_restart hook failed",
                               exc_info=True)

    # ------------------------------------------------------------ lifecycle
    def kill(self, worker_id: str, sig: int = signal.SIGKILL,
             restart: Optional[bool] = None) -> None:
        """Send ``sig`` to a replica (the failover drill's hammer).
        ``restart=False`` pins it down; default keeps the monitor's
        restart policy."""
        with self._lock:
            rp = self._procs[worker_id]
            if restart is not None:
                rp.restartable = bool(restart)
        if rp.alive():
            rp.proc.send_signal(sig)

    def stop_replica(self, worker_id: str, timeout: float = 10.0) -> None:
        with self._lock:
            rp = self._procs.get(worker_id)
            if rp is None:
                return
            rp.restartable = False
        if rp.alive():
            rp.proc.terminate()
            try:
                rp.proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                rp.proc.kill()
                rp.proc.wait(timeout=timeout)

    def stop_all(self, timeout: float = 10.0) -> None:
        self._stop.set()
        if self._monitor is not None:
            self._monitor.join(timeout=timeout)
            self._monitor = None
        with self._lock:
            ids = list(self._procs)
        for wid in ids:
            self.stop_replica(wid, timeout=timeout)
