"""Master-backed decode worker: lease → decode windows → durable results.

Port: a copy of dlrover_wuqiong_tpu/serving/worker.py over the port's
engine, scheduler, MasterClient and flight recorder.  One addition:
`stop()` ends the loop at its next turn, for a caller that hosts the
worker in a thread and knows when the traffic is done (chip_smoke.py
phase 4d); `run(max_seconds)` bounds it as in the JAX worker.  One
difference: a failed lease credits the time it blocked to ``degraded``
(the JAX worker credits 0.0 there and leaves the blocked time to its
client's goodput-ledger credit, which the port does not have yet).

Parity: reference `dlrover/python/elastic_agent/master_client.py` task
loop (get_task → work → report_task_result) — the serving worker is the
same shape over the Serve* verb family: lease requests (CRITICAL +
idem, like get_task), run fused windows, report results (CRITICAL +
idem — the ack is what lets the master release the lease, so a SIGKILL
between decode and ack re-queues the requests via `recover_node` and
nothing is dropped).

Every control-plane touch goes through MasterClient (retry_call-routed);
a master outage degrades gracefully: the worker keeps decoding what it
holds, credits ``degraded`` on the serving ledger for the time it spent
blocked, and re-leases when the master answers again.

The span buffer is flushed to the flight recorder directory with every
stats push, so a worker killed mid-traffic leaves its request spans on
disk — the serve-drain drill reconstructs one trace tree per request
from the dumps of BOTH worker generations (trace ids are derived from
request ids, scheduler.request_trace_id).
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from ..common.comm import MasterUnreachableError, RpcError
from ..common.log import get_logger
from ..telemetry import spans as tspans
from ..telemetry.recorder import get_recorder
from .scheduler import SlotScheduler

logger = get_logger("serving.worker")


class ServingWorker:
    """One decode worker process driving one ServingEngine."""

    def __init__(self, client, engine, ckpt_dir: str = "",
                 stats_every: int = 4, idle_sleep_s: float = 0.05):
        self.client = client
        self.engine = engine
        self.scheduler = SlotScheduler(engine)
        self.ledger = self.scheduler.ledger
        self.ckpt_dir = ckpt_dir
        self.stats_every = max(1, stats_every)
        self.idle_sleep_s = idle_sleep_s
        self._windows = 0
        self._stop = threading.Event()

    # ------------------------------------------------------------ plumbing

    def _lease(self):
        free = len(self.engine.free_slots()) - self.scheduler.pending()
        if free <= 0:
            return
        t0 = time.monotonic()
        try:
            leased = self.client.lease_serve_requests(max_requests=free)
        except (RpcError, MasterUnreachableError) as e:
            # unreachable time is attributed, not hidden: the worker
            # keeps decoding what it already holds
            self.ledger.account("degraded", time.monotonic() - t0)
            logger.warning("lease failed (%s) — continuing with held "
                           "requests", type(e).__name__)
            return
        for req in leased:
            self.scheduler.submit(req)

    def _report_results(self):
        results = self.scheduler.take_results()
        if not results:
            return
        if self.ckpt_dir:
            # durability ORDER: spans hit disk before the master learns
            # the request finished — once a result is master-visible its
            # trace tree must be reconstructable even if a SIGKILL lands
            # on the very next instruction (serve-drain pins this)
            get_recorder().flush(self.ckpt_dir, "serve-results")
        t0 = time.monotonic()
        try:
            self.client.report_serve_results(results)
        except (RpcError, MasterUnreachableError):
            # results must not be lost: put them back for the next loop
            self.ledger.account("degraded", time.monotonic() - t0)
            self.scheduler.results.extend(results)
            logger.warning("result report failed — will retry %d results",
                           len(results))

    def _push_stats(self, force: bool = False):
        if not force and self._windows % self.stats_every:
            return
        try:
            self.client.report_serve_stats(
                self.ledger.snapshot(),
                active_slots=self.scheduler.active())
        except (RpcError, MasterUnreachableError):
            pass  # BUFFERED path already absorbs outages; belt+braces
        if self.ckpt_dir:
            # spans → disk so a SIGKILL cannot erase this worker's part
            # of the per-request trace trees
            get_recorder().flush(self.ckpt_dir, "serve-stats")

    # ------------------------------------------------------------ run loop

    def stop(self):
        """End `run` after the loop turn in flight (thread-safe)."""
        self._stop.set()

    def run(self, max_seconds: Optional[float] = None):
        """Serve until `max_seconds` (None = forever / until killed) or
        `stop()`."""
        tspans.set_process_role("serve-worker")
        self.ledger.start()
        t0 = time.monotonic()
        while not self._stop.is_set() and (
                max_seconds is None
                or time.monotonic() - t0 < max_seconds):
            self._lease()
            if self.scheduler.idle():
                with self.ledger.window("idle"):
                    time.sleep(self.idle_sleep_s)
            else:
                self.scheduler.step()
            self._report_results()
            self._windows += 1
            self._push_stats()
        self._report_results()
        self._push_stats(force=True)
