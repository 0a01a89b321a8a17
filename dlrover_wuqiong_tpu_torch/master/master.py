"""Job master: the training and serving managers behind the RPC verbs.

Parity: dlrover_wuqiong_tpu/master/master.py (`JobMaster`), with:

- the elastic-training managers: the speed monitor, `LocalJobManager`
  (node table, heartbeats, error catalogue), the elastic-training
  rendezvous with ``min_nodes``, ``max_nodes`` and ``node_unit``
  (:56-82), the kv store, the dataset-sharding task manager, and the
  uniform failure cleanup callback (:105-121) without diagnosis;
- the journal (:149-196, :232-404): with ``journal_dir`` (or
  ``DWT_MASTER_JOURNAL_DIR``) every mutating verb is journaled before
  its ack (master/servicer.py); a master started on a journal replays
  it (`_replay_journal`: the snapshot, then each frame through
  `_apply_entry`), bumps the fencing epoch (`open_epoch`) and journals
  each world the rendezvous forms from then on; a clean `stop` compacts
  the journal into one snapshot frame; `journal_stats` answers the
  group-commit gauges.  Replay folds the kinds ``dataset``,
  ``dispatch``, ``task_result``, ``recover``, ``kv_set``, ``kv_add``,
  ``rdzv_join``, ``rdzv_world``, ``node``, ``shard_ckpt`` and the three
  ``serve_*`` kinds; a frame of a kind the port does not replay yet
  (``paral`` and ``policy``: item 15; ``mesh_transition``, ``lease`` and
  ``failover``: item 7b) logs a warning naming its item and replay goes
  on, as JAX's does for an unknown kind (:377-378);
- the telemetry the verbs carry: custom metrics (``dwt_*`` names observed
  into the registry, :561-576), node events (:578-591), the goodput
  ledger's latest-SENT-wins per node and its job summary (:593-637)
  without the exported gauges;
- the serving verbs' serve queue, `serve_summary` and
  `collect_serve_stats` (:701-720);
- `start` (the JAX master's `prepare`), `stop`, `port`, `addr`, and
  `run`, the main loop's compaction cadence, dead-node sweep, exit
  check and task-hang exit (:934-992); and `run_master_forever`
  (:1029-1079) without the standby branch, behind
  ``python -m dlrover_wuqiong_tpu_torch.master`` (master/__main__.py).

Not here yet, each with its ROADMAP item: standby masters, the
leadership lease, failover and the fence on a peer, the hot-swap mesh
transition (item 7b); the adaptive policy, the paral config and
diagnosis (item 15); the network-check rendezvous (item 13).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, Optional

from ..common import messages as msg
from ..common.constants import (
    JobExitReason,
    NodeEventType,
    NodeStatus,
    RendezvousName,
)
from ..common.global_context import get_context
from ..common.log import get_logger
from ..common.node import Node, NodeEvent
from .job_manager import JobManager, LocalJobManager, NodeEventCallback
from .journal import IdemCache, MasterJournal
from .kv_store import KVStoreService
from .metrics import JobMetricCollector
from .rendezvous import ElasticTrainingRendezvousManager
from .serve_queue import ServeQueueManager
from .servicer import create_master_service
from .speed_monitor import SpeedMonitor
from .task_manager import TaskManager

logger = get_logger("master")

#: journal frame kinds the port's master does not replay yet, with the
#: ROADMAP item that brings each
UNPORTED_KINDS = {"paral": "15", "policy": "15", "mesh_transition": "7b",
                  "lease": "7b", "failover": "7b"}


class JobMaster:
    """One master per job; owns control-plane state and the RPC service."""

    def __init__(self, port: int = 0, min_nodes: int = 1,
                 max_nodes: int = 1, node_unit: int = 1,
                 job_manager: Optional[JobManager] = None,
                 host: str = "0.0.0.0",
                 journal_dir: Optional[str] = None,
                 group_commit_max_frames: Optional[int] = None,
                 group_commit_max_wait_ms: Optional[float] = None):
        ctx = get_context()
        self.speed_monitor = SpeedMonitor(ctx.train_speed_record_num)
        self.job_manager = job_manager or LocalJobManager()
        self.task_manager = TaskManager()
        self.task_manager.speed_monitor = self.speed_monitor
        self.rdzv_managers = {
            RendezvousName.ELASTIC_TRAINING:
                ElasticTrainingRendezvousManager(),
        }
        for rdzv in self.rdzv_managers.values():
            rdzv.update_rdzv_params(
                min_nodes, max_nodes,
                waiting_timeout=5.0 if max_nodes > min_nodes else 0.5,
                join_timeout=ctx.rdzv_join_timeout,
                node_unit=node_unit)
        self.kv_store = KVStoreService()
        self.serve_queue = ServeQueueManager()
        # uniform failure cleanup regardless of which monitor detected it
        # (heartbeat sweep or explicit failure report)
        master = self

        class _CleanupCallback(NodeEventCallback):
            def on_node_failed(self, node):
                master.task_manager.recover_tasks(node.id)
                master.serve_queue.recover_node(node.id)
                for rdzv in master.rdzv_managers.values():
                    rdzv.remove_alive_node(node.id)
                master.speed_monitor.remove_running_worker(node.id)

            def on_node_deleted(self, node):
                self.on_node_failed(node)

        self.job_manager.add_node_event_callback(_CleanupCallback())
        # BUFFERED-verb telemetry rides its own lock
        self._telemetry_lock = threading.Lock()
        self._custom_metrics: Dict = {}
        self._node_events: list = []
        self._goodput: Dict[int, msg.GoodputLedgerReport] = {}
        # journal + fencing epoch (master/journal.py): with a journal dir,
        # this master replays any prior incarnation's control-plane state
        # and serves a bumped epoch so clients re-register; without one
        # it is epoch 1 forever (in-process and test masters)
        self.idem_cache = IdemCache()
        self.epoch = 1
        jd = journal_dir or os.getenv("DWT_MASTER_JOURNAL_DIR", "")
        self.journal = MasterJournal(
            jd, snapshot_every=ctx.journal_snapshot_every,
            group_commit_max_frames=group_commit_max_frames,
            group_commit_max_wait_ms=group_commit_max_wait_ms,
        ) if jd else None
        if self.journal is not None:
            self._replay_journal()
            self.epoch = self.journal.open_epoch()
            for rdzv in self.rdzv_managers.values():
                rdzv.on_world_formed = self._journal_world
        self.metric_collector = JobMetricCollector()
        self._server = create_master_service(self, host=host, port=port)
        self._exit_code = 0
        self._exit_reason = ""
        self._stopped = threading.Event()

    # --------------------------------------------------------------- service

    @property
    def port(self) -> int:
        return self._server.port

    @property
    def addr(self) -> str:
        return f"127.0.0.1:{self.port}"

    def start(self):
        self._server.start()
        logger.info("master ready on port %s", self.port)

    def stop(self):
        self._stopped.set()
        self._server.stop()
        if self.journal is not None:
            # clean shutdown: compact so the next incarnation boots from
            # one snapshot frame (crash paths never reach here — replay
            # covers them)
            self.snapshot_journal()
            self.journal.close()

    # ------------------------------------------------------- fault tolerance

    def _journal_world(self, name: str, state: Dict):
        if self.journal is not None:
            self.journal.append("rdzv_world", {"name": name,
                                               "state": state})

    def _replay_journal(self):
        """Reconstruct control-plane state from snapshot + event frames."""
        t0 = time.monotonic()
        snapshot, entries = self.journal.load()
        if snapshot:
            self._restore_snapshot(snapshot)
        applied = 0
        for frame in entries:
            try:
                self._apply_entry(frame.get("kind", ""),
                                  frame.get("data", {}))
                applied += 1
            except Exception:  # noqa: BLE001 — one bad frame must not
                # take down recovery of everything after it
                logger.exception("journal replay: frame %s failed",
                                 frame.get("seq"))
        if snapshot or applied:
            logger.info("journal replay: snapshot=%s + %d events "
                        "(last epoch %d) in %.6f s", bool(snapshot), applied,
                        self.journal.epoch, time.monotonic() - t0)

    def _restore_snapshot(self, state: Dict):
        if state.get("task_manager"):
            self.task_manager.restore_state(state["task_manager"])
        if state.get("kv"):
            self.kv_store.restore_state(state["kv"])
        for name, rstate in (state.get("rdzv") or {}).items():
            rdzv = self.rdzv_managers.get(name)
            if rdzv is not None:
                rdzv.restore_state(rstate)
        for node_type, node_id, rank, addr in state.get("nodes", []):
            self.job_manager.register_node(node_type, node_id,
                                           rank_index=rank, addr=addr)
        if state.get("idem"):
            self.idem_cache.restore_state(state["idem"])
        if state.get("serve"):
            self.serve_queue.restore_state(state["serve"])
        # a JAX master's snapshot also holds its policy decisions and its
        # hot-swap transitions, which the port does not replay yet
        mesh = state.get("mesh") or {}
        skipped = (["policy"] if state.get("policy") else []) + (
            ["mesh"] if mesh.get("active") or mesh.get("history") else [])
        if skipped:
            logger.warning("journal replay: snapshot parts %s are not "
                           "ported (ROADMAP items 15 and 7b) — skipped",
                           skipped)

    def _apply_entry(self, kind: str, data: Dict):
        data = dict(data)
        idem = data.pop("idem", None)
        resp = data.pop("resp", None)
        if kind == "dataset":
            self.task_manager.new_dataset(**data)
        elif kind == "dispatch":
            self.task_manager.replay_dispatch(
                data["dataset_name"], data["task_id"], data["node_id"],
                data["start"], data["end"], data.get("indices"))
        elif kind == "task_result":
            self.task_manager.replay_task_result(
                data["dataset_name"], data["task_id"], data["success"])
        elif kind == "recover":
            self.task_manager.recover_tasks(data["node_id"])
            self.serve_queue.recover_node(data["node_id"])
            for rdzv in self.rdzv_managers.values():
                rdzv.remove_alive_node(data["node_id"])
        elif kind == "kv_set":
            self.kv_store.set(data["key"], data["value"])
        elif kind == "kv_add":
            if "result" in data:  # absolute value — replay converges even
                # when the frame raced a concurrent snapshot
                self.kv_store.set(data["key"],
                                  str(int(data["result"])).encode())
            else:
                self.kv_store.add(data["key"], data["amount"])
        elif kind == "rdzv_join":
            rdzv = self.rdzv_managers.get(data["rdzv_name"])
            if rdzv is not None:
                rdzv.join_rendezvous(
                    data["node_id"], data["node_rank"],
                    data["local_world_size"], data.get("node_ip", ""),
                    data.get("free_port", 0), data.get("slice_id", ""))
            self.job_manager.register_node("worker", data["node_id"],
                                           rank_index=data["node_rank"])
        elif kind == "rdzv_world":
            rdzv = self.rdzv_managers.get(data["name"])
            if rdzv is not None:
                rdzv.restore_state(data["state"])
        elif kind == "node":
            node = self.job_manager.register_node(
                data["node_type"], data["node_id"],
                rank_index=data["node_rank"], addr=data.get("addr", ""))
            node.config_resource.accelerator_type = \
                data.get("accelerator_type", "")
            node.config_resource.accelerator_num = \
                data.get("accelerator_num", 0)
        elif kind == "shard_ckpt":
            self.task_manager.restore_dataset_from_checkpoint(
                data["content"])
        elif kind == "serve_submit":
            self.serve_queue.submit(data["requests"])
        elif kind == "serve_lease":
            self.serve_queue.lease_exact(data["node_id"],
                                         data["request_ids"])
        elif kind == "serve_result":
            self.serve_queue.complete(data["results"])
        elif kind in UNPORTED_KINDS:
            logger.warning("journal replay: %r frames are not replayed by "
                           "the port yet (ROADMAP item %s) — skipped", kind,
                           UNPORTED_KINDS[kind])
        else:
            logger.warning("journal replay: unknown frame kind %r", kind)
        if idem:
            self.idem_cache.put(idem, resp)

    def _journal_state(self) -> Dict:
        """Full snapshot payload (message objects ride the serialize
        codec natively — no second encoding)."""
        return {
            "task_manager": self.task_manager.export_state(),
            "kv": self.kv_store.export_state(),
            "rdzv": {name: r.export_state()
                     for name, r in self.rdzv_managers.items()},
            "nodes": [[n.type, n.id, n.rank_index, n.addr]
                      for n in self.job_manager.all_nodes()],
            "idem": self.idem_cache.export_state(),
            "serve": self.serve_queue.export_state(),
        }

    def snapshot_journal(self):
        if self.journal is not None:
            try:
                self.journal.snapshot(self._journal_state())
            except Exception:  # noqa: BLE001 — compaction must not kill
                logger.exception("journal snapshot failed")

    def journal_stats(self) -> msg.JournalStats:
        """Group-commit gauges (read-only poll, never journaled); the
        lease and leader fields keep their no-standby values."""
        if self.journal is None:
            return msg.JournalStats(enabled=False, epoch=self.epoch)
        return msg.JournalStats(enabled=True, epoch=self.epoch,
                                **self.journal.group_commit_stats())

    def rdzv_manager(self, name: str):
        """The rendezvous manager `name`; the network check's comes with
        ``agent/node_check`` (ROADMAP item 13)."""
        rdzv = self.rdzv_managers.get(name)
        if rdzv is None:
            raise ValueError(f"rendezvous {name!r} is not ported yet "
                             f"(ROADMAP item 13)")
        return rdzv

    # ------------------------------------------------------------ telemetry

    def collect_custom_data(self, payload):
        with self._telemetry_lock:
            self._custom_metrics[type(payload).__name__] = payload
        # CustomMetric entries named dwt_* flow into the registry — this is
        # how worker/agent-side timings (ckpt blocking/persist) reach the
        # master
        data = getattr(payload, "data", None)
        if isinstance(data, dict):
            for name, value in data.items():
                if isinstance(name, str) and name.startswith("dwt_"):
                    try:
                        self.metric_collector.reg.observe(
                            name, float(value),
                            {"job": self.metric_collector.job})
                    except (TypeError, ValueError):
                        pass

    def record_node_event(self, event: msg.NodeEventReport):
        with self._telemetry_lock:
            self._node_events.append(event)
            if len(self._node_events) > 1000:
                self._node_events = self._node_events[-500:]
        # node events are flight-recorder events on the master too — a
        # master-side dump carries the fault context workers reported
        from ..telemetry.recorder import get_recorder

        get_recorder().record("node_event", event.event_type, {
            "node_id": event.node_id, "reason": event.reason,
            "message": event.message, "level": event.level})

    def node_events(self) -> list:
        with self._telemetry_lock:
            return list(self._node_events)

    def collect_goodput(self, report: msg.GoodputLedgerReport):
        """Latest-wins per-node ledger snapshot (reports are cumulative,
        so drops/replays over the BUFFERED verb class are harmless).

        Latest means latest-SENT, not latest-arrived: the client's
        degraded buffer drains AFTER the frame that re-established the
        connection, so buffered (older) snapshots arrive last and must not
        overwrite the fresh one."""
        with self._telemetry_lock:
            prev = self._goodput.get(report.node_id)
            if prev is not None and getattr(prev, "sent_at", 0.0) > \
                    getattr(report, "sent_at", 0.0) > 0.0:
                return
            self._goodput[report.node_id] = report

    def goodput_summary(self) -> msg.GoodputSummary:
        """Job-level aggregation: sum the latest per-node snapshots."""
        states: Dict[str, float] = {}
        wall = other = 0.0
        with self._telemetry_lock:
            reports = list(self._goodput.values())
        for rep in reports:
            wall += rep.wall_s
            other += rep.other_s
            for state, secs in rep.states.items():
                states[state] = states.get(state, 0.0) + float(secs)
        productive = states.get("productive", 0.0)
        total = max(wall, sum(states.values()))
        return msg.GoodputSummary(
            states=states, wall_s=wall, other_s=other,
            goodput_fraction=(productive / total) if total > 0 else 0.0,
            nodes=len(reports))

    # --------------------------------------------------------------- serving

    def collect_serve_stats(self, report: msg.ServeStatsReport):
        """Latest-SENT-wins per-worker serving snapshot (BUFFERED verb: a
        drained stale buffer must not overwrite a fresher snapshot)."""
        self.serve_queue.collect_stats(report)

    def serve_summary(self) -> msg.ServeSummary:
        return self.serve_queue.summary()

    # ------------------------------------------------------------- main loop

    def run(self, poll_interval: float = 5.0,
            max_seconds: Optional[float] = None) -> int:
        """Main loop: compact the journal every `snapshot_every` events,
        sweep nodes whose heartbeat timed out, and stop when every worker
        exited, when every worker holding a shard has been silent for
        ``hang_detection_seconds``, or after `max_seconds`.  Returns the
        exit code."""
        ctx = get_context()
        start = time.monotonic()
        while not self._stopped.wait(poll_interval):
            if self.journal is not None and \
                    self.journal.entries_since_snapshot >= \
                    self.journal.snapshot_every:
                self.snapshot_journal()
            if max_seconds and time.monotonic() - start > max_seconds:
                self._exit_reason = JobExitReason.UNCOMPLETED_TIMEOUT
                self._exit_code = 1
                break
            for node in self.job_manager.get_dead_nodes():
                logger.warning("node %s heartbeat timeout — marking failed",
                               node.id)
                dead = Node(node.type, node.id, rank_index=node.rank_index)
                dead.status = NodeStatus.FAILED
                dead.exit_reason = "Hang"
                # the cleanup callback requeues the node's shards and
                # leases, leaves the rendezvous and the speed monitor
                self.job_manager.process_event(
                    NodeEvent(NodeEventType.MODIFIED, dead))
            if self.job_manager.all_workers_exited():
                if self.job_manager.all_workers_succeeded():
                    self._exit_reason = JobExitReason.SUCCEEDED
                    self._exit_code = 0
                else:
                    self._exit_reason = JobExitReason.WORKER_ERROR
                    self._exit_code = 1
                break
            if self.task_manager.task_hanged(ctx.hang_detection_seconds):
                self._exit_reason = JobExitReason.HANG_ERROR
                self._exit_code = 1
                break
        logger.info("master exiting: reason=%s code=%d", self._exit_reason,
                    self._exit_code)
        return self._exit_code

    @property
    def exit_reason(self) -> str:
        return self._exit_reason


def run_master_forever(port: int, min_nodes: int, max_nodes: int,
                       node_unit: int = 1,
                       journal_dir: Optional[str] = None,
                       poll_interval: float = 5.0,
                       max_seconds: Optional[float] = None,
                       group_commit_max_frames: Optional[int] = None,
                       group_commit_max_wait_ms: Optional[float] = None
                       ) -> int:
    """Entry for a standalone master process (parity
    dlrover_wuqiong_tpu/master/master.py:1029-1079, without the standby
    branch, the policy engine and the lease: items 7b and 15)."""
    master = JobMaster(port=port, min_nodes=min_nodes, max_nodes=max_nodes,
                       node_unit=node_unit, journal_dir=journal_dir,
                       group_commit_max_frames=group_commit_max_frames,
                       group_commit_max_wait_ms=group_commit_max_wait_ms)
    master.start()
    try:
        return master.run(poll_interval=poll_interval,
                          max_seconds=max_seconds)
    finally:
        master.stop()
