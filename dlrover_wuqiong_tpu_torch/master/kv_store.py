"""In-master KV store backing worker-side coordination bootstrap.

Parity: a copy of dlrover_wuqiong_tpu/master/kv_store.py:1-72 (no JAX),
kept in the port because the port imports nothing of the JAX package:
set, get, the atomic ascii counter add (torch ``Store`` semantics),
wait, multi-get and the journal snapshot pair.  Agents use it for
barriers and peer addresses.  (The JAX module's own parity: reference
`master/elastic_training/kv_store_service.py`.)
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional


class KVStoreService:
    def __init__(self):
        self._store: Dict[str, bytes] = {}
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)

    def set(self, key: str, value: bytes):
        with self._cond:
            self._store[key] = value
            self._cond.notify_all()

    def get(self, key: str) -> Optional[bytes]:
        with self._lock:
            return self._store.get(key)

    def add(self, key: str, amount: int = 1) -> int:
        """Atomic counter add; value stored as ascii int (torch Store semantics)."""
        with self._cond:
            cur = int(self._store.get(key, b"0"))
            cur += amount
            self._store[key] = str(cur).encode()
            self._cond.notify_all()
            return cur

    def wait(self, keys: List[str], timeout: float = 300.0) -> bool:
        deadline = time.monotonic() + timeout
        with self._cond:
            while not all(k in self._store for k in keys):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(remaining)
            return True

    def multi_get(self, keys: List[str]) -> List[Optional[bytes]]:
        with self._lock:
            return [self._store.get(k) for k in keys]

    def delete(self, key: str) -> bool:
        with self._lock:
            return self._store.pop(key, None) is not None

    def clear(self):
        with self._lock:
            self._store.clear()

    # ------------------------------------------------------- journal replay

    def export_state(self) -> Dict[str, bytes]:
        """Snapshot for the master journal (bytes values round-trip
        through common/serialize's hex encoding)."""
        with self._lock:
            return dict(self._store)

    def restore_state(self, data: Dict[str, bytes]):
        with self._cond:
            self._store.update(data)
            self._cond.notify_all()
