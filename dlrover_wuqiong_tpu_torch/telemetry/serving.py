"""Serving latency ledger: wall-time attribution + per-request latency.

Parity: a copy of dlrover_wuqiong_tpu/telemetry/serving.py (stdlib only),
kept in the port because the port imports nothing of the JAX package.
Every second of a serving process's wall time lands in exactly one
``SERVE_STATES`` bucket, and request lifecycle marks (admit -> first token
-> finish) feed bounded reservoirs for p50/p99 latency and time to first
token.

Accounting rules:

- Credits happen at WINDOW BOUNDARIES only: one ``decode`` window per
  K-token decode window and one ``prefill`` window per admission; never
  per token, never through a device readback of its own.
- Durations are ``time.monotonic`` intervals; ``started_wall`` is the
  only wall-clock field.

Snapshot keys, ``SERVE_STATES`` and ``SERVE_COUNTERS`` equal the JAX
package's (tests/test_torch_serving.py holds them equal): extend both
together, never rename.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Deque, Dict, Optional

#: One entry per attributable worker state, in export order.  ADD-ONLY.
SERVE_STATES = (
    "prefill",       # admission prefill scans (cache hydration)
    "decode",        # fused decode windows producing tokens
    "admission",     # host-side scheduling/slot bookkeeping
    "weight_sync",   # pulling refreshed weights from a live trainer
    "idle",          # no active slots, waiting for work
    "degraded",      # blocked on master RPCs during an outage
)

#: Monotonic request-lifecycle counters.  ADD-ONLY.
SERVE_COUNTERS = (
    "submitted",     # requests handed to this worker (leased)
    "admitted",      # requests that reached a KV slot
    "finished",      # requests fully decoded + result reported
    "requeued",      # in-flight requests re-admitted after a fault
    "tokens_out",    # generated tokens (excludes prompt)
)

SERVE_SCHEMA_VERSION = 1

#: Bounded latency reservoirs: enough for stable tails at drill/bench
#: scale without unbounded growth under production traffic.
_MAX_SAMPLES = 4096


def _percentile(samples, q: float) -> float:
    """Nearest-rank percentile of a sequence (0 when empty)."""
    if not samples:
        return 0.0
    xs = sorted(samples)
    idx = min(len(xs) - 1, max(0, int(round(q * (len(xs) - 1)))))
    return xs[idx]


class ServeLedger:
    """Thread-safe serving-plane wall-time + latency accumulator."""

    def __init__(self, clock=time.monotonic):
        self._clock = clock
        self._lock = threading.Lock()
        self._states: Dict[str, float] = {s: 0.0 for s in SERVE_STATES}
        self._counters: Dict[str, int] = {c: 0 for c in SERVE_COUNTERS}
        self._t_start: Optional[float] = None
        self._started_wall = 0.0
        # request_id -> (admit_t, first_token_t or None)
        self._inflight: Dict[str, list] = {}
        self._ttft_s: Deque[float] = collections.deque(maxlen=_MAX_SAMPLES)
        self._total_s: Deque[float] = collections.deque(maxlen=_MAX_SAMPLES)

    # ------------------------------------------------------------ lifecycle

    def start(self):
        """Open the wall-time window; idempotent (first call wins)."""
        with self._lock:
            if self._t_start is None:
                self._t_start = self._clock()
                self._started_wall = time.time()

    def started(self) -> bool:
        """True once `start()` opened the window (mirrors GoodputLedger —
        the flight recorder embeds a snapshot only from a started
        ledger, so an idle process dumps null, not an all-zero split)."""
        with self._lock:
            return self._t_start is not None

    # ------------------------------------------------------------ credits

    def account(self, state: str, seconds: float):
        if state not in self._states:
            raise ValueError(f"unknown serve state {state!r}; "
                             f"SERVE_STATES is add-only")
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

    def count(self, counter: str, n: int = 1):
        if counter not in self._counters:
            raise ValueError(f"unknown serve counter {counter!r}; "
                             f"SERVE_COUNTERS is add-only")
        self.start()
        with self._lock:
            self._counters[counter] += n

    # ------------------------------------------------------------ requests

    def note_admit(self, request_id: str):
        """Request reached a KV slot; latency clock starts here."""
        self.start()
        with self._lock:
            self._inflight[request_id] = [self._clock(), None]
            self._counters["admitted"] += 1

    def note_first_token(self, request_id: str):
        with self._lock:
            rec = self._inflight.get(request_id)
            if rec is not None and rec[1] is None:
                rec[1] = self._clock()
                self._ttft_s.append(rec[1] - rec[0])

    def note_finish(self, request_id: str, tokens: int = 0):
        now = self._clock()
        with self._lock:
            rec = self._inflight.pop(request_id, None)
            if rec is not None:
                self._total_s.append(now - rec[0])
            self._counters["finished"] += 1
            if tokens > 0:
                self._counters["tokens_out"] += tokens

    def note_requeued(self, n: int = 1):
        """A fault put `n` in-flight requests back on the queue."""
        self.count("requeued", n)

    # ------------------------------------------------------------ snapshot

    def snapshot(self) -> Dict:
        """Cumulative totals — safe to resend (receiver keeps latest)."""
        with self._lock:
            wall = (self._clock() - self._t_start
                    if self._t_start is not None else 0.0)
            states = dict(self._states)
            counters = dict(self._counters)
            ttft = list(self._ttft_s)
            total = list(self._total_s)
            active = len(self._inflight)
        credited = sum(states.values())
        return {
            "schema": SERVE_SCHEMA_VERSION,
            "wall_s": wall,
            "states": states,
            "other_s": max(0.0, wall - credited),
            "counters": counters,
            "active_requests": active,
            "latency": {
                "samples": len(total),
                "p50_ms": _percentile(total, 0.50) * 1e3,
                "p99_ms": _percentile(total, 0.99) * 1e3,
                "ttft_p50_ms": _percentile(ttft, 0.50) * 1e3,
                "ttft_p99_ms": _percentile(ttft, 0.99) * 1e3,
            },
            "started_wall": self._started_wall,
        }


_SERVE_LEDGER: Optional[ServeLedger] = None
_SERVE_LEDGER_LOCK = threading.Lock()


def get_serve_ledger() -> ServeLedger:
    """Process-global serving ledger (engine, worker, bench share it)."""
    global _SERVE_LEDGER
    with _SERVE_LEDGER_LOCK:
        if _SERVE_LEDGER is None:
            _SERVE_LEDGER = ServeLedger()
        return _SERVE_LEDGER


def reset_serve_ledger() -> ServeLedger:
    """Fresh ledger (tests / bench runs); returns the new instance."""
    global _SERVE_LEDGER
    with _SERVE_LEDGER_LOCK:
        _SERVE_LEDGER = ServeLedger()
        return _SERVE_LEDGER
