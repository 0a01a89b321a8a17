"""Typed client wrapper over the master's get/report RPCs.

Parity: dlrover_wuqiong_tpu/agent/master_client.py's `MasterClient`, copied
(stdlib only) with the three verb classes (`_call_critical` :165,
`_call_buffered` :216 with its bounded buffer, `_call_polling` :258),
`_account_degraded` (:242, the ledger's ``degraded`` credit for time
blocked on a dead master), `_maybe_flush`, `_next_idem`,
`_on_epoch_change` (re-registers the node), endpoint-list failover
dialing (:66-99, :140), and the verbs of the elastic trainer and of the
serving worker, each in its JAX verb class:

- rendezvous (:388-411): `join_rendezvous` (critical + idem),
  `get_comm_world` (critical), `num_nodes_waiting` (polling);
- lifecycle (:427-496): `register_node`, `report_failure` (critical);
  `report_heart_beat_full`, `report_global_step`, `report_node_event`,
  `report_custom_metric`, `report_goodput_ledger` (buffered);
  `get_goodput_summary` (polling);
- kv store (:663-719): `kv_store_set`, `kv_store_get`,
  `kv_store_multi_get` (critical), `kv_store_add` (critical + idem),
  `kv_store_wait` (fail-fast probes under the shared backoff);
- dataset sharding (:353-382): `report_dataset_shard_params`,
  `get_task` (critical + idem), `report_task_result` (critical + idem,
  kept for the epoch-bump re-sync), `get_shard_checkpoint`,
  `report_shard_checkpoint` (critical);
- the journal's gauges, `get_journal_stats` (polling, :512);
- serving (:585-648).

The network-check, policy, mesh-transition, perf, timeline, diagnosis
and config-tuner verbs come with ROADMAP items 7b, 13 and 15.

Master fault tolerance, as in the JAX client:

- **three verb classes**: CRITICAL verbs (rendezvous, kv, registration,
  failure, lease, results, submit) retry with backoff up to the outage
  grace deadline (global_context.master_outage_grace_s) — a master
  restart is invisible below that; BUFFERED fire-and-forget verbs
  (heartbeats, step, event, metric, ledger and serving-stats reports)
  never block the caller: on an unreachable master they land in a
  bounded in-memory queue that drains after reconnect; POLLING verbs
  (waiting-node count, summaries, result queries) fail fast and let
  their caller's own cadence retry.
- **idempotency keys** ride on get_task, report_task_result,
  join_rendezvous, kv_store_add, submit, lease and result report: a
  retry gets the master's recorded response instead of re-applying
  (master/servicer.py).
- **fencing epoch**: every response carries the master's epoch
  (common/comm.py); on a bump this client re-registers the node and
  re-syncs its recently acked task results under their original keys.
- **failover dialing**: ``master_addr`` may be a comma-separated ORDERED
  endpoint list ("primary,standby").  An unreachable endpoint or a
  ``NotLeaderError`` answer rotates to the next endpoint; CRITICAL verbs
  keep rotating inside the outage grace window.  (The port has no
  standby master yet; the dialing is ported, the standby is not.)
"""

from __future__ import annotations

import os
import threading
import time
import uuid
from collections import deque
from typing import Dict, List, Optional

from ..common import messages as msg
from ..common.comm import MasterUnreachableError, RpcClient, RpcError
from ..common.constants import RendezvousName
from ..common.global_context import get_context
from ..common.log import get_logger
from ..common.util import retry_call

logger = get_logger("master_client")


class MasterClient:
    #: bounded degraded-mode buffer (fire-and-forget frames per client)
    BUFFER_CAP = 512
    #: acked task results kept for epoch-bump re-sync
    RESYNC_CAP = 64

    def __init__(self, master_addr: str, node_id: int,
                 node_type: str = "worker",
                 outage_grace_s: Optional[float] = None):
        # ordered endpoint list ("primary,standby"): index 0 is dialed
        # first; _advance_endpoint rotates on unreachable/NotLeader.
        # The single-endpoint path is byte-for-byte the historical one.
        self._endpoints = [a.strip() for a in master_addr.split(",")
                           if a.strip()] or [master_addr]
        self._endpoint_idx = 0
        self._failover_lock = threading.Lock()
        self._failovers = 0
        self._client = RpcClient(self._endpoints[0], node_id, node_type)
        self._client.on_epoch_change = self._on_epoch_change
        self.master_addr = master_addr
        self.node_id = node_id
        self.node_type = node_type
        self._outage_grace_s = (
            outage_grace_s if outage_grace_s is not None
            else get_context().master_outage_grace_s)
        # degraded mode: bounded buffer of (verb, message) frames
        self._buffer: deque = deque()
        self._buffer_lock = threading.Lock()
        self._idem_prefix = f"{node_id}:{os.getpid()}:{uuid.uuid4().hex[:8]}"
        self._idem_seq = 0
        # epoch-bump resync state
        self._registration: Optional[msg.NodeMeta] = None
        self._recent_results: deque = deque(maxlen=self.RESYNC_CAP)
        # stats (chaos drills assert on these)
        self._buffered_total = 0
        self._flushed_total = 0
        self._dropped_total = 0
        self._reregistrations = 0
        self.epochs_seen: List[int] = []

    def close(self):
        self._client.close()

    # ------------------------------------------------------------ retry core

    @property
    def epoch(self) -> Optional[int]:
        """Last master fencing epoch observed on this client."""
        return self._client.epoch

    def _next_idem(self) -> str:
        self._idem_seq += 1
        return f"{self._idem_prefix}:{self._idem_seq}"

    @staticmethod
    def _is_not_leader(exc: Exception) -> bool:
        """An answered refusal from a standby/fenced master — the verb
        was NEVER applied there, so re-dialing the next endpoint is the
        one RpcError that is safe (and required) to re-send."""
        return isinstance(exc, RpcError) and \
            not isinstance(exc, MasterUnreachableError) and \
            "NotLeaderError" in str(exc)

    def _advance_endpoint(self, seen_client: Optional[RpcClient] = None):
        """Rotate to the next configured endpoint (failover dialing).

        The replacement connection is pre-seeded with the last observed
        fencing epoch: `_observe_epoch` only fires the bump callback
        when it has an old value to compare against, and the re-register
        + idem re-sync on promotion hangs off exactly that callback."""
        if len(self._endpoints) <= 1:
            return
        with self._failover_lock:
            if seen_client is not None and self._client is not seen_client:
                return  # another thread already advanced past it
            old = self._client
            self._endpoint_idx = (self._endpoint_idx + 1) \
                % len(self._endpoints)
            addr = self._endpoints[self._endpoint_idx]
            new = RpcClient(addr, self.node_id, self.node_type)
            new.epoch = old.epoch
            new.on_epoch_change = self._on_epoch_change
            self._client = new
            self._failovers += 1
        old.on_epoch_change = None
        old.close()
        logger.warning("failover dialing: master endpoint -> %s", addr)

    def _call_critical(self, verb: str, payload, idem: Optional[str] = None):
        """Blocking control-plane verb: ride a master outage with backoff
        up to the grace deadline, then raise MasterUnreachableError.

        With multiple endpoints the grace window is spent ROTATING
        (fail-fast inner calls) instead of parked on one address — the
        idem key makes the eventual landing exactly-once wherever the
        leader turned out to be."""
        t0 = time.monotonic()
        if len(self._endpoints) == 1:
            try:
                resp = self._client._call(  # noqa: SLF001 — typed facade
                    verb, payload, idem=idem,
                    deadline_s=self._outage_grace_s)
            except MasterUnreachableError:
                # wall time burned blocking on a dead master is the
                # master-outage-degraded ledger split (telemetry/ledger.py)
                self._account_degraded(time.monotonic() - t0)
                raise
            self._maybe_flush()
            return resp
        deadline = t0 + self._outage_grace_s
        backoff = 0.05
        degraded = False
        while True:
            client = self._client
            try:
                resp = client._call(verb, payload, idem=idem,  # noqa: SLF001
                                    attempts=2)
            except MasterUnreachableError:
                degraded = True
            except RpcError as e:
                if not self._is_not_leader(e):
                    raise
                degraded = True
            else:
                if degraded:
                    # the rotation time WAS blocked control-plane time
                    self._account_degraded(time.monotonic() - t0)
                self._maybe_flush()
                return resp
            if time.monotonic() >= deadline:
                self._account_degraded(time.monotonic() - t0)
                raise MasterUnreachableError(
                    f"no reachable leader among {self._endpoints} within "
                    f"{self._outage_grace_s:.0f}s grace")
            self._advance_endpoint(client)
            time.sleep(min(backoff,
                           max(0.0, deadline - time.monotonic())))
            backoff = min(1.0, backoff * 1.5)

    def _call_buffered(self, payload, default):
        """Fire-and-forget verb: never blocks training on a dead master —
        a short retry, then the frame parks in the bounded buffer (oldest
        dropped) and `default` is returned; the buffer drains on the next
        successful call (reconnect or new master).  A NotLeaderError
        answer buffers the SAME way (the standby never applied it) and
        additionally rotates the endpoint so the next beat lands on the
        leader — it must never crash the training loop."""
        t0 = time.monotonic()
        client = self._client
        try:
            resp = client._call(  # noqa: SLF001
                "report", payload, attempts=2)
        except (MasterUnreachableError, RpcError) as e:
            not_leader = self._is_not_leader(e)
            if not not_leader and not isinstance(e,
                                                 MasterUnreachableError):
                raise
            self._account_degraded(time.monotonic() - t0)
            with self._buffer_lock:
                if len(self._buffer) >= self.BUFFER_CAP:
                    self._buffer.popleft()
                    self._dropped_total += 1
                self._buffer.append(payload)
                self._buffered_total += 1
            self._advance_endpoint(client)
            return default
        self._maybe_flush()
        return resp

    @staticmethod
    def _account_degraded(seconds: float):
        """Credit retry time burned against an unreachable master; only
        seconds actually spent blocked count — training that continues
        through the outage stays productive in the ledger."""
        try:
            from ..telemetry.ledger import get_ledger

            get_ledger().account("degraded", seconds)
        except Exception:  # noqa: BLE001 — telemetry must never break rpc
            pass

    def _call_polling(self, verb: str, payload):
        """Advisory verb on a caller-owned cadence: fail fast (the caller's
        next poll is the retry) — but still rotate the endpoint on
        unreachable/NotLeader so the NEXT poll dials somewhere better."""
        client = self._client
        try:
            resp = client._call(verb, payload, attempts=2)  # noqa: SLF001
        except (MasterUnreachableError, RpcError) as e:
            if isinstance(e, MasterUnreachableError) or \
                    self._is_not_leader(e):
                self._advance_endpoint(client)
            raise
        self._maybe_flush()
        return resp

    def _maybe_flush(self):
        """Drain the degraded-mode buffer after a successful call."""
        if not self._buffer:
            return
        while True:
            with self._buffer_lock:
                if not self._buffer:
                    return
                payload = self._buffer.popleft()
            client = self._client
            try:
                client._call("report", payload,  # noqa: SLF001
                             attempts=1)
                self._flushed_total += 1
            except MasterUnreachableError:
                with self._buffer_lock:
                    self._buffer.appendleft(payload)
                return
            except RpcError as e:
                if self._is_not_leader(e):
                    # NOT a reject: the non-leader never applied it.
                    # Re-park the frame and rotate — the drain resumes
                    # against the real leader on the next success.
                    with self._buffer_lock:
                        self._buffer.appendleft(payload)
                    self._advance_endpoint(client)
                    return
                # a frame the new master rejects (stale semantics) is
                # dropped, not retried forever
                logger.warning("degraded-buffer frame rejected on flush",
                               exc_info=True)
                self._flushed_total += 1
            except Exception:  # noqa: BLE001 — same reject contract
                logger.warning("degraded-buffer frame rejected on flush",
                               exc_info=True)
                self._flushed_total += 1

    def _on_epoch_change(self, old: int, new: int):
        """A DIFFERENT master answered: re-register, re-sync in-flight
        task results (idempotent via their original keys), drain buffers.

        Fired by the RpcClient exactly once per bump, outside its socket
        lock (common/comm.py)."""
        self.epochs_seen.append(new)
        logger.warning("master epoch changed %d -> %d — re-registering "
                       "and re-syncing in-flight state", old, new)
        try:
            if self._registration is not None:
                self._client._call("report", self._registration,  # noqa: SLF001
                                   attempts=2)
            for dataset_name, task_id, err, idem in list(
                    self._recent_results):
                self._client._call(  # noqa: SLF001
                    "report",
                    msg.TaskResult(dataset_name=dataset_name,
                                   task_id=task_id, err_message=err),
                    idem=idem, attempts=2)
            self._reregistrations += 1
        except MasterUnreachableError:
            logger.warning("re-sync with epoch-%d master interrupted — "
                           "the next successful verb retries", new)
        self._maybe_flush()

    def degraded_stats(self) -> Dict:
        """Counters for drills/tests: buffer totals + epoch resync state."""
        with self._buffer_lock:
            pending = len(self._buffer)
        return {"buffered_total": self._buffered_total,
                "flushed_total": self._flushed_total,
                "dropped_total": self._dropped_total,
                "pending": pending,
                "reregistrations": self._reregistrations,
                "epochs_seen": list(self.epochs_seen),
                "epoch": self.epoch,
                # ADD-ONLY failover-dialing gauges
                "failovers": self._failovers,
                "endpoints": list(self._endpoints)}

    # ------------------------------------------------------------- dataset

    def report_dataset_shard_params(self, **kwargs):
        return self._call_critical("report", msg.DatasetShardParams(**kwargs))

    def get_task(self, dataset_name: str) -> msg.Task:
        # idem key per REQUEST (each poll is a distinct dispatch decision);
        # a retry of this one request across a master restart replays the
        # journaled Task instead of double-dispatching
        return self._call_critical(
            "get", msg.TaskRequest(dataset_name=dataset_name),
            idem=self._next_idem())

    def report_task_result(self, dataset_name: str, task_id: int,
                           err_message: str = ""):
        idem = self._next_idem()
        self._recent_results.append((dataset_name, task_id, err_message,
                                     idem))
        return self._call_critical("report", msg.TaskResult(
            dataset_name=dataset_name, task_id=task_id,
            err_message=err_message), idem=idem)

    def get_shard_checkpoint(self, dataset_name: str) -> str:
        resp = self._call_critical("get",
                                   msg.ShardCheckpointRequest(
                                       dataset_name=dataset_name))
        return resp.content

    def report_shard_checkpoint(self, content: str):
        return self._call_critical("report",
                                   msg.ShardCheckpoint(content=content))

    # ------------------------------------------------------------- rendezvous

    def join_rendezvous(self, node_rank: int, local_world_size: int,
                        rdzv_name: str = RendezvousName.ELASTIC_TRAINING,
                        node_ip: str = "127.0.0.1",
                        free_port: int = 0) -> int:
        resp = self._call_critical("report", msg.JoinRendezvousRequest(
            node_id=self.node_id, node_rank=node_rank,
            local_world_size=local_world_size, rdzv_name=rdzv_name,
            node_ip=node_ip, free_port=free_port,
            slice_id=os.getenv("DWT_SLICE_ID", "")),
            idem=self._next_idem())
        return resp.rdzv_round

    def get_comm_world(
        self, rdzv_name: str = RendezvousName.ELASTIC_TRAINING
    ) -> msg.RendezvousState:
        return self._call_critical("get", msg.CommWorldRequest(
            node_id=self.node_id, rdzv_name=rdzv_name))

    def num_nodes_waiting(
        self, rdzv_name: str = RendezvousName.ELASTIC_TRAINING
    ) -> int:
        resp = self._call_polling("get", msg.WaitingNodeNumRequest(
            node_id=self.node_id, rdzv_name=rdzv_name))
        return resp.waiting_num

    # ------------------------------------------------------------- lifecycle

    def register_node(self, node_rank: int, addr: str = "",
                      accelerator_type: str = "gpu",
                      accelerator_num: int = 0):
        meta = msg.NodeMeta(
            node_type=self.node_type, node_id=self.node_id,
            node_rank=node_rank, addr=addr,
            accelerator_type=accelerator_type,
            accelerator_num=accelerator_num)
        self._registration = meta  # replayed on every epoch bump
        return self._call_critical("report", meta)

    def report_heart_beat(self, global_step: int = 0) -> str:
        return self.report_heart_beat_full(global_step).action

    def report_heart_beat_full(self, global_step: int = 0
                               ) -> msg.HeartbeatResponse:
        """Full response — carries rollback_before_step for spike rollbacks.

        Degraded mode: on an unreachable master the beat buffers and a
        no-action response returns — training never blocks on heartbeats."""
        return self._call_buffered(
            msg.HeartBeat(node_id=self.node_id, timestamp=time.time(),
                          global_step=global_step),
            default=msg.HeartbeatResponse())

    def report_failure(self, error_data: str, restart_count: int = 0,
                       level: str = "process"):
        return self._call_critical("report", msg.NodeFailure(
            node_id=self.node_id, restart_count=restart_count,
            error_data=error_data, level=level))

    def report_global_step(self, step: int,
                           elapsed_time_per_step: float = 0.0):
        return self._call_buffered(
            msg.GlobalStep(step=step, timestamp=time.time(),
                           elapsed_time_per_step=elapsed_time_per_step),
            default=msg.OkResponse())

    def report_node_event(self, event_type: str, message: str = "",
                          level: str = "info"):
        return self._call_buffered(
            msg.NodeEventReport(node_id=self.node_id,
                                node_type=self.node_type,
                                event_type=event_type, message=message,
                                level=level),
            default=msg.OkResponse())

    def report_custom_metric(self, data):
        """Push {metric_name: value} to the master; dwt_* names land in the
        master's metric registry."""
        return self._call_buffered(msg.CustomMetric(data=dict(data)),
                                   default=msg.OkResponse())

    def report_goodput_ledger(self, snapshot: Dict):
        """Push a cumulative ledger snapshot (telemetry/ledger.py
        ``GoodputLedger.snapshot()``) — BUFFERED: cumulative totals make
        drops and replays harmless (master keeps latest per node)."""
        return self._call_buffered(
            msg.GoodputLedgerReport(
                node_id=self.node_id,
                wall_s=float(snapshot.get("wall_s", 0.0)),
                states={str(k): float(v)
                        for k, v in snapshot.get("states", {}).items()},
                other_s=float(snapshot.get("other_s", 0.0)),
                goodput_fraction=float(
                    snapshot.get("goodput_fraction", 0.0)),
                sent_at=time.time()),
            default=msg.OkResponse())

    def get_goodput_summary(self) -> msg.GoodputSummary:
        """Job-level ledger aggregation."""
        return self._call_polling("get", msg.GoodputQuery())

    def get_journal_stats(self) -> msg.JournalStats:
        """Journal group-commit gauges."""
        return self._call_polling("get", msg.JournalStatsQuery())

    # ------------------------------------------------------------- kv store

    def kv_store_set(self, key: str, value: bytes):
        return self._call_critical("report",
                                   msg.KVStoreSetRequest(key=key,
                                                         value=value))

    def kv_store_get(self, key: str) -> Optional[bytes]:
        resp = self._call_critical("get", msg.KVStoreGetRequest(key=key))
        return resp.value if resp.found else None

    def kv_store_multi_get(self, keys: List[str]) -> Optional[List[bytes]]:
        resp = self._call_critical("get",
                                   msg.KVStoreMultiGetRequest(keys=keys))
        return resp.values if resp.found else None

    def kv_store_add(self, key: str, amount: int = 1) -> int:
        resp = self._call_critical("get",
                                   msg.KVStoreAddRequest(key=key,
                                                         amount=amount),
                                   idem=self._next_idem())
        return resp.num

    class _KVNotReady(Exception):
        pass

    def kv_store_wait(self, keys: List[str], timeout: float = 300.0,
                      poll: float = 0.2) -> bool:
        """Block until every key exists; polls through the shared backoff
        helper (retry_call) instead of a fixed-interval spin, riding a
        master outage inside the window.  Raises TimeoutError (message
        carries the master's fencing epoch) on expiry."""
        def probe():
            # fail-fast inner call: a long per-probe deadline would let one
            # probe swallow the whole wait window during a master outage
            try:
                resp = self._client._call(  # noqa: SLF001
                    "get", msg.KVStoreMultiGetRequest(keys=keys),
                    attempts=2)
            except MasterUnreachableError as e:
                raise MasterClient._KVNotReady() from e
            if not resp.found:
                raise MasterClient._KVNotReady()
            return True

        try:
            return retry_call(
                probe, attempts=None, deadline_s=timeout,
                base_delay_s=poll, max_delay_s=2.0, jitter=0.25,
                retry_on=(MasterClient._KVNotReady,))
        except MasterClient._KVNotReady:
            raise TimeoutError(
                f"kv_store_wait({keys!r}) timed out after {timeout:.0f}s "
                f"(master epoch={self.epoch})") from None

    # ------------------------------------------------------------- serving

    def submit_serve_requests(self, requests: List[msg.ServeRequest]
                              ) -> msg.ServeSubmitAck:
        """Enqueue inference requests — CRITICAL + idem: a retry gets
        the recorded ack instead of double-enqueueing."""
        return self._call_critical(
            "report",
            msg.ServeSubmitRequest(node_id=self.node_id,
                                   requests=list(requests)),
            idem=self._next_idem())

    def lease_serve_requests(self, max_requests: int = 1
                             ) -> List[msg.ServeRequest]:
        """Lease pending requests for this decode worker — CRITICAL +
        idem (like get_task: a retried lease must return the SAME
        requests or they strand in `leased`)."""
        resp = self._call_critical(
            "get",
            msg.ServeLeaseRequest(node_id=self.node_id,
                                  max_requests=max_requests),
            idem=self._next_idem())
        return list(resp.requests)

    def report_serve_results(self, results: List[msg.ServeResult]):
        """Durable result hand-off — CRITICAL + idem (drain correctness:
        the worker may exit only after this ack)."""
        return self._call_critical(
            "report",
            msg.ServeResultReport(node_id=self.node_id,
                                  results=list(results)),
            idem=self._next_idem())

    def get_serve_results(self, request_ids: List[str]
                          ) -> msg.ServeResultResponse:
        """Poll for finished results (fail fast; the client's next poll
        is the retry — re-delivery is deduped by request_id)."""
        return self._call_polling(
            "get", msg.ServeResultQuery(request_ids=list(request_ids)))

    def report_serve_stats(self, snapshot: Dict, active_slots: int = 0):
        """Push a cumulative serving-ledger snapshot (telemetry/serving
        ``ServeLedger.snapshot()``) — BUFFERED like the goodput ledger:
        cumulative totals make drops/replays harmless."""
        lat = snapshot.get("latency", {})
        return self._call_buffered(
            msg.ServeStatsReport(
                node_id=self.node_id,
                wall_s=float(snapshot.get("wall_s", 0.0)),
                states={str(k): float(v)
                        for k, v in snapshot.get("states", {}).items()},
                counters={str(k): int(v)
                          for k, v in snapshot.get("counters",
                                                   {}).items()},
                active_slots=int(active_slots),
                p50_ms=float(lat.get("p50_ms", 0.0)),
                p99_ms=float(lat.get("p99_ms", 0.0)),
                ttft_p50_ms=float(lat.get("ttft_p50_ms", 0.0)),
                ttft_p99_ms=float(lat.get("ttft_p99_ms", 0.0)),
                sent_at=time.time()),
            default=msg.OkResponse())

    def get_serve_summary(self) -> msg.ServeSummary:
        """Job-level serving aggregation."""
        return self._call_polling("get", msg.ServeStatsQuery())
