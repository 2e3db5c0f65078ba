"""Controller data store (paper §4: Redis with replication + periodic
checkpoints).  In-memory KV with versioning, snapshot/restore, and
synchronous replication to follower stores — the controller fail-over
path restores from the freshest follower.
"""

from __future__ import annotations

import copy
import json
import threading
from pathlib import Path
from typing import Any, Dict, List


class DataStore:
    def __init__(self, name: str = "primary"):
        self.name = name
        self._data: Dict[str, Any] = {}
        self._version = 0
        self._lock = threading.RLock()
        self._replicas: List["DataStore"] = []

    # -- kv -------------------------------------------------------------
    def put(self, key: str, value: Any):
        with self._lock:
            self._data[key] = copy.deepcopy(value)
            self._version += 1
            for r in self._replicas:
                r._apply(key, value, self._version)

    def get(self, key: str, default=None):
        with self._lock:
            return copy.deepcopy(self._data.get(key, default))

    def keys(self, prefix: str = ""):
        with self._lock:
            return [k for k in self._data if k.startswith(prefix)]

    def delete(self, key: str):
        with self._lock:
            self._data.pop(key, None)
            self._version += 1
            for r in self._replicas:
                r._apply(key, None, self._version, delete=True)

    @property
    def version(self) -> int:
        return self._version

    # -- replication ------------------------------------------------------
    def add_replica(self, replica: "DataStore"):
        with self._lock:
            replica._data = copy.deepcopy(self._data)
            replica._version = self._version
            self._replicas.append(replica)

    def _apply(self, key, value, version, delete=False):
        with self._lock:
            if delete:
                self._data.pop(key, None)
            else:
                self._data[key] = copy.deepcopy(value)
            self._version = version

    # -- checkpoints --------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"version": self._version,
                    "data": copy.deepcopy(self._data)}

    def restore(self, snap: Dict[str, Any]):
        with self._lock:
            self._data = copy.deepcopy(snap["data"])
            self._version = snap["version"]

    def checkpoint_to(self, path: Path):
        snap = self.snapshot()
        Path(path).write_text(json.dumps(snap, default=str))

    @classmethod
    def from_checkpoint(cls, path: Path) -> "DataStore":
        ds = cls()
        snap = json.loads(Path(path).read_text())
        ds._data = snap["data"]
        ds._version = snap["version"]
        return ds
