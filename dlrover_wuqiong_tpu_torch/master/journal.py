"""At-most-once replay of idempotency-keyed verbs.

Parity: `IdemCache` of dlrover_wuqiong_tpu/master/journal.py:660-709,
copied (stdlib only) without its `export_state` / `restore_state`: the
port's cache lives in memory, and a retry against the same master (a
lost ack, a torn frame) gets the recorded response.  The journal
(`MasterJournal`: group commit, snapshots, replay), which carries the
cache across a master restart and needs the two, comes with ROADMAP
item 15.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any


class IdemCache:
    """Bounded idempotency-key → response cache (at-most-once replay).

    Parity: no reference counterpart — the reference's gRPC verbs are
    retried against the SAME master process, where re-applying a task
    result is harmless; here a retry can cross a master restart, so
    mutating verbs carry keys and the journaled cache answers replays
    with the recorded response instead of re-applying the mutation.
    """

    def __init__(self, cap: int = 4096):
        self._cap = cap
        self._lock = threading.Lock()
        self._map: "OrderedDict[str, Any]" = OrderedDict()

    _MISS = object()

    def get(self, key: str) -> Any:
        """The cached response, or IdemCache.MISS."""
        with self._lock:
            if key in self._map:
                self._map.move_to_end(key)
                return self._map[key]
            return self._MISS

    @property
    def MISS(self):
        return self._MISS

    def put(self, key: str, resp: Any):
        with self._lock:
            self._map[key] = resp
            self._map.move_to_end(key)
            while len(self._map) > self._cap:
                self._map.popitem(last=False)

    def __len__(self):
        with self._lock:
            return len(self._map)
