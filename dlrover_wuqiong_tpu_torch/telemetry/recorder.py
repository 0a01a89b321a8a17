"""Flight recorder: bounded per-process event ring, flushed on faults.

Port: a copy of dlrover_wuqiong_tpu/telemetry/recorder.py (stdlib only),
kept in the port because the port imports nothing of the JAX package.
The dump schema is the same.  The port has no goodput ledger (ROADMAP
item 6a) and no perf observatory (item 15) yet, so a dump's ``ledger``
and ``perf`` are null; ``serve_ledger`` is the port's serving ledger.

Parity: reference `dlrover/python/master/node/event_callback.py` +
`diagnosis/diagnostician.py` (the reference reacts to faults with live
callbacks but keeps no bounded pre-fault history — post-mortems grep pod
logs).  An aircraft-FDR-style ring fixes that: the LAST N structured
events (spans, node events, ledger state transitions, free-form marks)
are always in memory, and a fault/SIGTERM/diagnosis-restart flushes them
to ``$ckpt_dir/flight/`` where they survive the process.

Dump layout (ADD-ONLY schema, pinned by tests/test_telemetry.py):

    $ckpt_dir/flight/<role>-<pid>-<reason>-<seq>.json
    {"schema": 1, "role", "pid", "reason", "flushed_at", "flushed_mono",
     "ledger": <ledger snapshot or null>,
     "serve_ledger": <serve-ledger snapshot or null>,
     "perf": <latest PerfSnapshot or null — telemetry/perf.py>,
     "events": [...]}

Events are ``{"t_wall", "t_mono", "kind", "name", "data"}``; ``kind`` is
one of span | node_event | state | mark.  Spans recorded here carry
their full trace fields, so one restore reconstructs as a single trace
tree across agent/master/saver dumps (tools/goodput_report.py --flight).

Clocks: each event carries BOTH the wall clock (cross-process alignment)
and the monotonic clock; the envelope's ``flushed_at``/``flushed_mono``
pair anchors the process's monotonic timeline to the wall at flush time,
so telemetry/timeline.py can order a process's own events immune to wall
steps (``wall = t_mono + (flushed_at - flushed_mono)``).  Dumps written
before the monotonic fields existed fall back to ``t_wall`` there.

Writes are write-tmp-then-rename (atomic publish); flushing is
best-effort and must never take down the faulting process's last words.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

FLIGHT_SCHEMA_VERSION = 1

#: ring capacity (drop-oldest); big enough for minutes of control-plane
#: activity, small enough to never matter for memory
_MAX_EVENTS = 4096


def flight_dir(ckpt_dir: str) -> str:
    return os.path.join(ckpt_dir, "flight")


class FlightRecorder:
    """Bounded ring of recent structured events for one process."""

    def __init__(self, max_events: int = _MAX_EVENTS):
        self._lock = threading.Lock()
        self._ring: "deque[Dict]" = deque(maxlen=max_events)
        self._seq = 0

    def record(self, kind: str, name: str, data: Optional[Dict] = None):
        # t_wall is a persisted cross-process timestamp (sanctioned wall
        # use); t_mono is the anchor-safe sibling timeline.py orders by
        evt = {"t_wall": time.time(), "t_mono": time.monotonic(),
               "kind": kind, "name": name, "data": data or {}}
        with self._lock:
            self._ring.append(evt)

    def snapshot(self) -> List[Dict]:
        with self._lock:
            return list(self._ring)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def flush(self, ckpt_dir: str, reason: str) -> Optional[str]:
        """Dump the ring to ``$ckpt_dir/flight/``; returns the path or
        None (flush failures are swallowed — last words, not a new
        fault)."""
        if not ckpt_dir:
            return None
        try:
            from .serving import get_serve_ledger
            from .spans import process_role

            out_dir = flight_dir(ckpt_dir)
            os.makedirs(out_dir, exist_ok=True)
            with self._lock:
                self._seq += 1
                seq = self._seq
            name = (f"{process_role()}-{os.getpid()}-"
                    f"{reason.replace('/', '_')}-{seq}.json")
            path = os.path.join(out_dir, name)
            payload = {
                "schema": FLIGHT_SCHEMA_VERSION,
                "role": process_role(),
                "pid": os.getpid(),
                "reason": reason,
                # the wall/monotonic PAIR is the anchor: both stamped
                # back to back so their difference maps this process's
                # t_mono values onto the shared wall timeline
                "flushed_at": time.time(),
                "flushed_mono": time.monotonic(),
                # no goodput ledger in the port yet (ROADMAP item 6a)
                "ledger": None,
                "serve_ledger": (get_serve_ledger().snapshot()
                                 if get_serve_ledger().started()
                                 else None),
                # no perf observatory in the port yet (ROADMAP item 15)
                "perf": None,
                "events": self.snapshot(),
            }
            tmp = f"{path}.tmp"
            with open(tmp, "w") as f:
                json.dump(payload, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            return path
        except Exception:  # noqa: BLE001 — never raise from a fault path
            return None


def load_flight_dumps(ckpt_dir: str) -> List[Dict]:
    """All parseable dumps under ``$ckpt_dir/flight/``, oldest first."""
    out_dir = flight_dir(ckpt_dir)
    dumps: List[Dict] = []
    if not os.path.isdir(out_dir):
        return dumps
    for name in sorted(os.listdir(out_dir)):
        if not name.endswith(".json") or ".tmp" in name:
            continue
        try:
            with open(os.path.join(out_dir, name)) as f:
                d = json.load(f)
            d["_file"] = name
            dumps.append(d)
        except (OSError, ValueError):
            continue
    dumps.sort(key=lambda d: d.get("flushed_at", 0.0))
    return dumps


_RECORDER: Optional[FlightRecorder] = None
_RECORDER_LOCK = threading.Lock()


def get_recorder() -> FlightRecorder:
    global _RECORDER
    with _RECORDER_LOCK:
        if _RECORDER is None:
            _RECORDER = FlightRecorder()
        return _RECORDER


def reset_recorder() -> FlightRecorder:
    global _RECORDER
    with _RECORDER_LOCK:
        _RECORDER = FlightRecorder()
        return _RECORDER
