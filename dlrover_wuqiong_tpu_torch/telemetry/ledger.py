"""Goodput ledger: every second of trainer wall time in exactly one state.

Parity: a whole copy of dlrover_wuqiong_tpu/telemetry/ledger.py:1-151
(stdlib only), kept in the port because the port imports nothing of the
JAX package.  The port's checkpoint engine credits ``ckpt_stage``,
``ckpt_persist`` and ``restore_*`` here; the trainer's credits come with
ROADMAP item 7a.  The flight recorder dumps its snapshot.

Parity: reference `dlrover/python/master/monitor/speed_monitor.py:24`
(SpeedMonitor derives a single global speed number from reported steps)
— the ledger is its attribution-complete counterpart: instead of one
rate, the trainer accounts *where* wall time went (productive fused
window, dispatch overhead, data stall, checkpoint stage/persist,
per-tier restore, compile, rework after rollback, master-outage
degraded), so downtime splits that previously only existed as chaos
drill artifacts (chaos.py timing_r*.json) are live runtime telemetry.

Accounting rules (enforced by call sites, asserted by tests):

- Credits happen at FUSION BOUNDARIES only (trainer/trainer.py) — never
  inside the jitted step, and never via a new device readback; the
  dispatch-overhead share of a fused window is estimated from the
  measured per-dispatch overhead (auto engine / DWT_DISPATCH_OVERHEAD_S),
  not from extra syncs.
- Durations are ``time.monotonic`` intervals; the snapshot's
  ``started_wall`` is the only wall-clock field (a human-facing
  timestamp).
- ``other`` is the residual: wall − sum(credited states).  It is
  computed, never credited, which is what makes the attribution
  total: states + other == wall by construction.

The snapshot dict is an ADD-ONLY schema pinned by tests/test_telemetry.py.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Optional

#: One entry per attributable state, in export order.  ADD-ONLY: the
#: master aggregation, /metrics export, goodput_report CLI and chaos
#: drill assertions all key on these names.
LEDGER_STATES = (
    "productive",        # fused-window device time doing real steps
    "dispatch_overhead",  # per-dispatch tunnel/runtime overhead share
    "data_stall",        # blocked on next(stager) / host input pipeline
    "ckpt_stage",        # blocked on D2H staging into shm
    "ckpt_persist",      # blocked waiting on a prior async persist
    "restore_shm",       # restore served from the local shm tier
    "restore_replica",   # restore served from a peer replica fetch
    "restore_storage",   # restore served from durable storage
    "compile",           # first dispatch of a fused program (trace+XLA)
    "rework",            # re-executing steps already done pre-rollback
    "degraded",          # blocked on master RPCs during an outage
    "profile",           # perf-observatory window overhead (trace
                         # start/stop + xplane parse — telemetry/perf.py)
)

LEDGER_SCHEMA_VERSION = 1


class GoodputLedger:
    """Thread-safe accumulator of wall seconds per ledger state."""

    def __init__(self, clock=time.monotonic):
        self._clock = clock
        self._lock = threading.Lock()
        self._states: Dict[str, float] = {s: 0.0 for s in LEDGER_STATES}
        self._t_start: Optional[float] = None
        self._started_wall = 0.0

    # ------------------------------------------------------------ lifecycle

    def start(self):
        """Open the wall-time window; idempotent (first call wins)."""
        with self._lock:
            if self._t_start is None:
                self._t_start = self._clock()
                self._started_wall = time.time()

    def started(self) -> bool:
        with self._lock:
            return self._t_start is not None

    # ------------------------------------------------------------ credits

    def account(self, state: str, seconds: float):
        """Credit `seconds` to `state` (unknown states raise — the state
        list is the schema)."""
        if state not in self._states:
            raise ValueError(f"unknown ledger state {state!r}; "
                             f"LEDGER_STATES is add-only")
        if seconds <= 0:
            return
        self.start()
        with self._lock:
            self._states[state] += seconds

    @contextlib.contextmanager
    def window(self, state: str):
        """Credit the wall time of the with-block to `state`."""
        self.start()
        t0 = self._clock()
        try:
            yield
        finally:
            self.account(state, self._clock() - t0)

    # ------------------------------------------------------------ snapshot

    def snapshot(self) -> Dict:
        """Cumulative totals — safe to resend (receiver keeps latest)."""
        with self._lock:
            wall = (self._clock() - self._t_start
                    if self._t_start is not None else 0.0)
            states = dict(self._states)
        credited = sum(states.values())
        # clamp: concurrent windows (saver thread vs train loop) can
        # credit more than wall; residual is never negative
        other = max(0.0, wall - credited)
        productive = states.get("productive", 0.0)
        total = max(wall, credited)
        return {
            "schema": LEDGER_SCHEMA_VERSION,
            "wall_s": wall,
            "states": states,
            "other_s": other,
            "goodput_fraction": (productive / total) if total > 0 else 0.0,
            "started_wall": self._started_wall,
        }

    def goodput_fraction(self) -> float:
        return self.snapshot()["goodput_fraction"]


_LEDGER: Optional[GoodputLedger] = None
_LEDGER_LOCK = threading.Lock()


def get_ledger() -> GoodputLedger:
    """Process-global ledger (trainer, checkpoint engine, master client
    and bench all credit the same instance)."""
    global _LEDGER
    with _LEDGER_LOCK:
        if _LEDGER is None:
            _LEDGER = GoodputLedger()
        return _LEDGER


def reset_ledger() -> GoodputLedger:
    """Fresh ledger (tests / bench runs); returns the new instance."""
    global _LEDGER
    with _LEDGER_LOCK:
        _LEDGER = GoodputLedger()
        return _LEDGER
