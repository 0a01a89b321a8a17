"""Job master: the training and serving managers behind the RPC verbs.

Parity: dlrover_wuqiong_tpu/master/master.py (`JobMaster`), with:

- the elastic-training managers: the speed monitor, `LocalJobManager`
  (node table, heartbeats, error catalogue), the elastic-training
  rendezvous with ``min_nodes``, ``max_nodes`` and ``node_unit``
  (:56-82), the kv store, and the uniform failure cleanup callback
  (:105-121) without diagnosis;
- the telemetry the verbs carry: custom metrics (``dwt_*`` names observed
  into the registry, :561-576), node events (:578-591), the goodput
  ledger's latest-SENT-wins per node and its job summary (:593-637)
  without the exported gauges;
- the serving verbs' serve queue, `serve_summary` and
  `collect_serve_stats` (:701-720);
- `start` (the JAX master's `prepare`), `stop`, `port`, `addr`, and
  `run`, the main loop's dead-node sweep and exit check (:934-992).

Not here yet, each with its ROADMAP item: the journal, so a master
restart loses the queue and the world (item 15); fencing-epoch bumps
(this master serves epoch 1 for its whole life), standby masters, the
adaptive policy, the hot-swap mesh transition and diagnosis (item 15);
the network-check rendezvous (item 13); dataset sharding (the task
manager, item 15); and ``python -m dlrover_wuqiong_tpu_torch.master``.
Host it in-process, as ``run --standalone``, `chaos.serve_drain` and
chip_smoke.py do.
"""

from __future__ import annotations

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
from .journal import IdemCache
from .kv_store import KVStoreService
from .metrics import JobMetricCollector
from .rendezvous import ElasticTrainingRendezvousManager
from .serve_queue import ServeQueueManager
from .servicer import create_master_service
from .speed_monitor import SpeedMonitor

logger = get_logger("master")


class JobMaster:
    """One master per job; owns control-plane state and the RPC service."""

    def __init__(self, port: int = 0, min_nodes: int = 1,
                 max_nodes: int = 1, node_unit: int = 1,
                 job_manager: Optional[JobManager] = None,
                 host: str = "0.0.0.0"):
        ctx = get_context()
        self.speed_monitor = SpeedMonitor(ctx.train_speed_record_num)
        self.job_manager = job_manager or LocalJobManager()
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
        self.idem_cache = IdemCache()
        self.epoch = 1
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
        """Main loop: sweep nodes whose heartbeat timed out, and stop when
        every worker exited or after `max_seconds`.  Returns the exit
        code."""
        start = time.monotonic()
        while not self._stopped.wait(poll_interval):
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
                # the cleanup callback requeues, leaves the rendezvous and
                # the speed monitor
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
        logger.info("master exiting: reason=%s code=%d", self._exit_reason,
                    self._exit_code)
        return self._exit_code

    @property
    def exit_reason(self) -> str:
        return self._exit_reason
