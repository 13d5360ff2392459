"""Stats persistence + routing.

Reference: ``deeplearning4j-ui-model/.../storage/{StatsStorage,
StatsStorageRouter,Persistable}.java`` and ``storage/mapdb/MapDBStatsStorage
.java`` — pluggable session stores with attach/listener fan-out.

The MapDB file store becomes a JSONL append file (self-describing records,
no native lib); in-memory store for tests/local UI.  ``FileStatsStorage``
is crash-safe: every committed report is flushed+fsynced, and a torn
trailing record (killed writer) is skipped and truncated on reload with a
warning instead of ``json.JSONDecodeError`` losing the whole history.

Port: a copy of ``deeplearning4j_tpu/ui/storage.py`` with its imports
rewritten.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
from collections import defaultdict
from typing import Callable, Dict, List, Optional

from deeplearning4j_tpu_torch.ui.stats import StatsInitializationReport, StatsReport

logger = logging.getLogger("deeplearning4j_tpu_torch.ui")

_INIT_FIELDS = {f.name for f in dataclasses.fields(StatsInitializationReport)}


class StatsStorage:
    """≙ ``storage/StatsStorage.java`` (router+query surface)."""

    def __init__(self):
        self._listeners: List[Callable[[StatsReport], None]] = []
        self._lock = threading.Lock()

    # -- router surface
    def put_init_report(self, rep: StatsInitializationReport) -> None:
        raise NotImplementedError

    def put_update(self, rep: StatsReport) -> None:
        raise NotImplementedError

    def add_listener(self, fn: Callable[[StatsReport], None]) -> None:
        with self._lock:
            self._listeners.append(fn)

    def remove_listener(self, fn: Callable[[StatsReport], None]) -> None:
        with self._lock:
            try:
                self._listeners.remove(fn)
            except ValueError:
                pass

    def _notify(self, rep: StatsReport) -> None:
        with self._lock:
            listeners = list(self._listeners)
        for fn in listeners:
            fn(rep)

    # -- query surface
    def list_session_ids(self) -> List[str]:
        raise NotImplementedError

    def get_init_report(self, session_id: str) -> Optional[StatsInitializationReport]:
        raise NotImplementedError

    def get_updates(self, session_id: str) -> List[StatsReport]:
        raise NotImplementedError

    def get_latest_update(self, session_id: str) -> Optional[StatsReport]:
        ups = self.get_updates(session_id)
        return ups[-1] if ups else None


class InMemoryStatsStorage(StatsStorage):
    """≙ ``storage/InMemoryStatsStorage.java``."""

    def __init__(self):
        super().__init__()
        self._inits: Dict[str, StatsInitializationReport] = {}
        self._updates: Dict[str, List[StatsReport]] = defaultdict(list)

    def put_init_report(self, rep) -> None:
        with self._lock:
            self._inits[rep.session_id] = rep

    def put_update(self, rep) -> None:
        with self._lock:
            self._updates[rep.session_id].append(rep)
        self._notify(rep)

    def list_session_ids(self) -> List[str]:
        return sorted(set(self._inits) | set(self._updates))

    def get_init_report(self, session_id):
        return self._inits.get(session_id)

    def get_updates(self, session_id) -> List[StatsReport]:
        with self._lock:
            return list(self._updates.get(session_id, []))


class FileStatsStorage(StatsStorage):
    """Append-only JSONL file store (replaces MapDB).
    ≙ ``storage/mapdb/MapDBStatsStorage.java`` role.

    Durability contract: ``put_update``/``put_init_report`` flush+fsync
    before returning, so every report a caller saw committed survives a
    crash; ``_load`` stops at the first torn/corrupt record, truncates
    the file back to the intact prefix (a new append must never glue
    onto a half-written line), and keeps everything before it."""

    def __init__(self, path: str):
        super().__init__()
        self.path = path
        self._mem = InMemoryStatsStorage()
        if os.path.exists(path):
            self._load()

    def _load(self) -> None:
        with open(self.path, "rb") as f:
            data = f.read()
        ok_bytes = 0
        repair_newline = False
        dropped = None
        lines = data.split(b"\n")
        for i, raw in enumerate(lines):
            terminated = i < len(lines) - 1
            line = raw.strip()
            if not line:
                if terminated:
                    ok_bytes += len(raw) + 1
                continue
            try:
                d = json.loads(line.decode("utf-8"))
                if not isinstance(d, dict):
                    raise ValueError(f"record is {type(d).__name__}, "
                                     "not an object")
            except Exception as e:
                dropped = f"line {i + 1}: {e}"
                break
            kind = d.pop("type", "update")
            if kind == "init":
                self._mem.put_init_report(StatsInitializationReport(
                    **{k: v for k, v in d.items() if k in _INIT_FIELDS}))
            else:
                self._mem.put_update(StatsReport.from_dict(d))
            if terminated:
                ok_bytes += len(raw) + 1
            else:
                # complete JSON without its trailing newline: the record
                # committed but the newline write was cut — keep it and
                # repair the terminator so the next append stays valid
                ok_bytes += len(raw)
                repair_newline = True
        if dropped is not None:
            logger.warning(
                "FileStatsStorage %s: dropping torn/corrupt tail (%s); "
                "keeping the %d intact byte(s) before it",
                self.path, dropped, ok_bytes)
        if ok_bytes < len(data):
            with open(self.path, "r+b") as f:
                f.truncate(ok_bytes)
                f.flush()
                os.fsync(f.fileno())
        if repair_newline:
            with open(self.path, "ab") as f:
                f.write(b"\n")
                f.flush()
                os.fsync(f.fileno())

    def _append(self, json_line: str) -> None:
        with self._lock:
            with open(self.path, "a", encoding="utf-8") as f:
                f.write(json_line + "\n")
                f.flush()
                # committed-means-durable: a report the caller saw
                # accepted must survive a crashed writer process
                os.fsync(f.fileno())

    def put_init_report(self, rep) -> None:
        self._mem.put_init_report(rep)
        self._append(rep.to_json())

    def put_update(self, rep) -> None:
        self._mem.put_update(rep)
        self._append(rep.to_json())
        self._notify(rep)

    def list_session_ids(self):
        return self._mem.list_session_ids()

    def get_init_report(self, session_id):
        return self._mem.get_init_report(session_id)

    def get_updates(self, session_id):
        return self._mem.get_updates(session_id)
