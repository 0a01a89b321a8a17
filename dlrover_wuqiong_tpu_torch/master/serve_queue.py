"""Serving request queue on the master: admission, leases, recovery.

Port: a copy of dlrover_wuqiong_tpu/master/serve_queue.py (stdlib only),
kept in the port because the port imports nothing of the JAX package.

Parity: reference `dlrover/python/master/shard/task_manager.py` (the
training-shard dispatch queue) — this is its serving counterpart.  The
same durability contract applies: every mutating verb is journaled
BEFORE the ack (servicer.py), so a master restart replays submissions,
leases and results and no in-flight request is ever dropped — the
property the `chaos serve-drain` drill pins.

Lifecycle: submitted → pending (FIFO) → leased (per worker) → done.
A worker death moves its leased requests back to the FRONT of the
pending queue (`recover_node`) and bumps ``requeued_total`` — recovery
is *attributed*, mirroring how `TaskManager.recover_tasks` re-queues
dispatched shards.  Submission is idempotent per ``request_id`` (replay
+ client retries both hit the dedupe).

`lease_exact`, `export_state` and `restore_state` are the journal's:
the master replays ``serve_lease`` frames through `lease_exact` and
snapshots the queue with `export_state` (master/master.py), and
tests/test_torch_serving_worker.py holds this copy's queue state equal
to the JAX package's.

Worker serving-ledger snapshots aggregate latest-SENT-wins per node,
exactly like the master's goodput collection (master.py
collect_goodput): reports ride the BUFFERED verb class and a drained
stale buffer must not overwrite a fresher snapshot.
"""

from __future__ import annotations

import collections
import threading
from typing import Dict, List, Optional

from ..common.messages import (
    ServeRequest,
    ServeResult,
    ServeStatsReport,
    ServeSummary,
)


class ServeQueueManager:
    """Thread-safe FIFO of serving requests with per-worker leases."""

    def __init__(self):
        self._lock = threading.Lock()
        self._pending: collections.deque = collections.deque()  # request_ids
        self._requests: Dict[str, ServeRequest] = {}
        self._leased: Dict[str, int] = {}          # request_id -> node_id
        self._done: Dict[str, ServeResult] = {}
        self._submitted_total = 0
        self._requeued_total = 0
        self._done_total = 0
        # BUFFERED-verb telemetry under its OWN lock: stats ingestion
        # (hundreds of workers, latest-wins) must never contend with the
        # journaled submit/lease/result path on the queue lock
        self._stats_lock = threading.Lock()
        self._stats: Dict[int, ServeStatsReport] = {}

    # ------------------------------------------------------------ mutations

    def submit(self, requests: List[ServeRequest]) -> int:
        """Enqueue; duplicates (by request_id) are ignored. Returns the
        number newly accepted."""
        accepted = 0
        with self._lock:
            for req in requests:
                rid = req.request_id
                if not rid or rid in self._requests or rid in self._done:
                    continue
                self._requests[rid] = req
                self._pending.append(rid)
                self._submitted_total += 1
                accepted += 1
        return accepted

    def lease(self, node_id: int, max_requests: int) -> List[ServeRequest]:
        """Pop up to `max_requests` from the queue front for `node_id`."""
        out: List[ServeRequest] = []
        with self._lock:
            while self._pending and len(out) < max(0, max_requests):
                rid = self._pending.popleft()
                req = self._requests.get(rid)
                if req is None:
                    continue
                self._leased[rid] = node_id
                out.append(req)
        return out

    def lease_exact(self, node_id: int, request_ids: List[str]):
        """Journal replay: re-assign these exact requests to `node_id`
        (the original lease order was journaled; replay must not re-pop
        a different set)."""
        with self._lock:
            for rid in request_ids:
                if rid in self._requests and rid not in self._done:
                    try:
                        self._pending.remove(rid)
                    except ValueError:
                        pass
                    self._leased[rid] = node_id

    def complete(self, results: List[ServeResult]) -> int:
        """Record finished results; releases the lease. Idempotent per
        request_id (worker retries / journal replay)."""
        n = 0
        with self._lock:
            for res in results:
                rid = res.request_id
                if not rid or rid in self._done:
                    continue
                self._done[rid] = res
                self._leased.pop(rid, None)
                self._requests.pop(rid, None)
                self._done_total += 1
                n += 1
        return n

    def recover_node(self, node_id: int) -> int:
        """A worker died: move its leased requests back to the queue
        FRONT (they were admitted first; re-admit them first)."""
        with self._lock:
            lost = [rid for rid, nid in self._leased.items()
                    if nid == node_id]
            for rid in reversed(lost):
                del self._leased[rid]
                self._pending.appendleft(rid)
            self._requeued_total += len(lost)
        return len(lost)

    def take_results(self, request_ids: List[str]
                     ) -> (List[ServeResult], int):
        """Pop finished results for these ids; returns (results,
        still-pending count among the queried ids)."""
        out: List[ServeResult] = []
        pending = 0
        with self._lock:
            for rid in request_ids:
                res = self._done.pop(rid, None)
                if res is not None:
                    out.append(res)
                elif rid in self._requests:
                    pending += 1
        return out, pending

    def collect_stats(self, report: ServeStatsReport):
        """Latest-SENT-wins per worker (BUFFERED verb class drains stale
        snapshots after reconnect)."""
        with self._stats_lock:
            prev = self._stats.get(report.node_id)
            if prev is None or report.sent_at >= prev.sent_at:
                self._stats[report.node_id] = report

    # ------------------------------------------------------------ queries

    def summary(self) -> ServeSummary:
        with self._stats_lock:
            stats = list(self._stats.values())
        with self._lock:
            summ = ServeSummary(
                queue_depth=len(self._pending),
                leased=len(self._leased),
                done=len(self._done),
                submitted_total=self._submitted_total,
                requeued_total=self._requeued_total,
                done_total=self._done_total,
                workers=len(stats),
            )
        counters: Dict[str, int] = {}
        states: Dict[str, float] = {}
        wall = 0.0
        finished = 0
        for rep in stats:
            summ.active_slots += rep.active_slots
            wall = max(wall, rep.wall_s)
            for k, v in rep.counters.items():
                counters[k] = counters.get(k, 0) + v
            for k, v in rep.states.items():
                states[k] = states.get(k, 0.0) + v
            finished += rep.counters.get("finished", 0)
        # recovery is attributed by the MASTER (workers cannot see their
        # own death): requeues land under the pinned `requeued` counter
        counters["requeued"] = (counters.get("requeued", 0)
                                + summ.requeued_total)
        summ.counters = counters
        summ.states = states
        # job-level tails: worst worker (a conservative upper bound —
        # exact job tails would need raw samples on the wire)
        summ.p50_ms = max((r.p50_ms for r in stats), default=0.0)
        summ.p99_ms = max((r.p99_ms for r in stats), default=0.0)
        summ.ttft_p50_ms = max((r.ttft_p50_ms for r in stats), default=0.0)
        summ.ttft_p99_ms = max((r.ttft_p99_ms for r in stats), default=0.0)
        summ.rps = (finished / wall) if wall > 0 else 0.0
        return summ

    # ------------------------------------------------------------ snapshot

    def export_state(self) -> Dict:
        """Journal-snapshot payload (master._journal_state)."""
        with self._lock:
            return {
                "pending": list(self._pending),
                "requests": dict(self._requests),
                "leased": dict(self._leased),
                "done": dict(self._done),
                "submitted_total": self._submitted_total,
                "requeued_total": self._requeued_total,
                "done_total": self._done_total,
            }

    def restore_state(self, state: Optional[Dict]):
        if not state:
            return
        with self._lock:
            self._pending = collections.deque(state.get("pending", []))
            self._requests = dict(state.get("requests", {}))
            # JSON object keys are strings; node ids are ints
            self._leased = {rid: int(nid) for rid, nid
                            in state.get("leased", {}).items()}
            self._done = dict(state.get("done", {}))
            self._submitted_total = int(state.get("submitted_total", 0))
            self._requeued_total = int(state.get("requeued_total", 0))
            self._done_total = int(state.get("done_total", 0))
