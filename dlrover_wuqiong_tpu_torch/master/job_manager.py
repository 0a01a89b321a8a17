"""Job/node management: registry, heartbeats, relaunch decisions.

Parity: dlrover_wuqiong_tpu/master/job_manager.py (no JAX), copied with
`NodeEventCallback`, `Scaler`, `NoopScaler`, `JobManager` (the node
table, the heartbeat sweep, `process_event` through the state machine and
the error catalogue, `_should_relaunch` with the repeated-class cutoff,
the failure callbacks) and `LocalJobManager`, which backs
``run --standalone``.  Left out, each with the ROADMAP item that brings
it: the warm-mesh scale policy (`WarmMeshPolicy`,
`make_warm_mesh_policy`, `devices_per_node`; :64-105, :288-305, item 13,
with the warm pool it reads), and the platform-backed `DistJobManager`
with its scheduler, scaler and watcher (:330-395, item 15).  (The JAX
module's own parity: reference `master/node/dist_job_manager.py` and
`local_job_manager.py`.)
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from ..common.constants import (
    NodeEventType,
    NodeExitReason,
    NodeStatus,
    NodeType,
)
from ..common.global_context import get_context
from ..common.log import get_logger
from ..common.node import Node, NodeEvent, NodeStateFlow
from .error_monitor import ErrorMonitor

logger = get_logger("job_manager")


class NodeEventCallback:
    """Parity: reference event_callback.py; hooks on node phase transitions."""

    def on_node_started(self, node: Node):
        pass

    def on_node_succeeded(self, node: Node):
        pass

    def on_node_failed(self, node: Node):
        pass

    def on_node_deleted(self, node: Node):
        pass


class Scaler:
    """Applies scale decisions to the platform (create/remove nodes)."""

    def scale_up(self, node: Node):
        raise NotImplementedError

    def scale_down(self, node: Node):
        raise NotImplementedError


class NoopScaler(Scaler):
    def scale_up(self, node: Node):
        logger.info("noop scaler: would launch %s", node)

    def scale_down(self, node: Node):
        logger.info("noop scaler: would remove %s", node)


class JobManager:
    """Tracks training nodes, processes events, decides relaunches."""

    def __init__(self, scaler: Optional[Scaler] = None,
                 max_relaunch_count: Optional[int] = None):
        ctx = get_context()
        self._lock = threading.Lock()
        self._nodes: Dict[int, Node] = {}
        self._scaler = scaler or NoopScaler()
        self._max_relaunch = (max_relaunch_count
                              if max_relaunch_count is not None
                              else ctx.max_relaunch_count)
        self._callbacks: List[NodeEventCallback] = []
        self._next_node_id = 0
        self._stopped = threading.Event()
        self._heartbeat_timeout = ctx.node_heartbeat_timeout
        self.error_monitor = ErrorMonitor()
        self._relaunch_listeners: List[Callable[[Node, Node], None]] = []

    # ------------------------------------------------------------- registry

    def add_node_event_callback(self, cb: NodeEventCallback):
        self._callbacks.append(cb)

    def register_node(self, node_type: str, node_id: Optional[int] = None,
                      rank_index: Optional[int] = None, addr: str = "") -> Node:
        with self._lock:
            if node_id is None:
                node_id = self._next_node_id
            self._next_node_id = max(self._next_node_id, node_id + 1)
            node = self._nodes.get(node_id)
            if node is None:
                node = Node(node_type, node_id, rank_index=rank_index,
                            max_relaunch_count=self._max_relaunch)
                self._nodes[node_id] = node
            node.addr = addr or node.addr
            node.heartbeat_time = time.time()
            return node

    def get_node(self, node_id: int) -> Optional[Node]:
        with self._lock:
            return self._nodes.get(node_id)

    def all_nodes(self) -> List[Node]:
        with self._lock:
            return list(self._nodes.values())

    def running_nodes(self) -> List[Node]:
        with self._lock:
            return [n for n in self._nodes.values()
                    if n.status == NodeStatus.RUNNING]

    # ------------------------------------------------------------- heartbeats

    def collect_heartbeat(self, node_id: int,
                          timestamp: Optional[float] = None) -> str:
        """Returns an action for the node ("" | "restart" | "stop")."""
        return self.collect_heartbeat_full(node_id, timestamp)[0]

    def collect_heartbeat_full(self, node_id: int,
                               timestamp: Optional[float] = None
                               ) -> tuple:
        """(action, rollback_before_step) — step is -1 unless a loss-spike
        rollback pinned a pre-spike resume ceiling on the node."""
        with self._lock:
            node = self._nodes.get(node_id)
            if node is None:
                return "", -1
            node.heartbeat_time = timestamp or time.time()
            if node.status in (NodeStatus.INITIAL, NodeStatus.PENDING):
                node.update_status(NodeStatus.RUNNING)
            if node.restart_training:
                node.restart_training = False
                rb, node.rollback_before_step = node.rollback_before_step, -1
                return "restart", rb
            return "", -1

    def get_dead_nodes(self) -> List[Node]:
        """Nodes whose heartbeat timed out (parity `_get_dead_node_event`)."""
        now = time.time()
        with self._lock:
            return [
                n for n in self._nodes.values()
                if n.status == NodeStatus.RUNNING
                and n.heartbeat_time > 0
                and now - n.heartbeat_time > self._heartbeat_timeout
            ]

    # ------------------------------------------------------------- events

    def process_event(self, event: NodeEvent):
        """Apply a platform event through the state machine; maybe relaunch.

        Parity: reference `_process_event` dist_job_manager.py:473.
        """
        node = self.register_node(event.node.type, event.node.id,
                                  event.node.rank_index)
        old_status = node.status
        new_status = event.node.status
        if event.event_type == NodeEventType.DELETED:
            new_status = NodeStatus.DELETED
        if not NodeStateFlow.can_transition(old_status, new_status):
            return
        node.update_status(new_status)
        node.exit_reason = event.node.exit_reason or node.exit_reason
        if node.exit_reason and \
                node.exit_reason not in NodeExitReason.KNOWN:
            # scheduler watchers report raw strings ("exit_code=137",
            # "actor_died") — run them through the error catalogue so the
            # relaunch table acts on a class and the rank accrues history
            reason, _ = self.error_monitor.process_error(
                node.rank_index, node.relaunch_count, node.exit_reason,
                node_id=node.id)
            node.exit_reason = reason
        self._fire_callbacks(node, old_status, new_status)
        if NodeStateFlow.should_relaunch(old_status, new_status):
            if self._should_relaunch(node):
                self._relaunch_node(node)
            else:
                node.relaunchable = False
                logger.warning("node %s not relaunchable (reason=%s count=%d)",
                               node.id, node.exit_reason, node.relaunch_count)

    def _fire_callbacks(self, node: Node, old: str, new: str):
        for cb in self._callbacks:
            try:
                if new == NodeStatus.RUNNING:
                    cb.on_node_started(node)
                elif new == NodeStatus.SUCCEEDED:
                    cb.on_node_succeeded(node)
                elif new in (NodeStatus.FAILED, NodeStatus.BREAKDOWN):
                    cb.on_node_failed(node)
                elif new == NodeStatus.DELETED:
                    cb.on_node_deleted(node)
            except Exception:  # noqa: BLE001
                logger.exception("node event callback error")

    def _should_relaunch(self, node: Node) -> bool:
        """Parity: reference `_should_relaunch` dist_job_manager.py:561 +
        the error-class catalogue (monitor/error_monitor.py)."""
        ctx = get_context()
        if node.is_released:
            return False
        if node.exit_reason == NodeExitReason.FATAL_ERROR and \
                not ctx.relaunch_always:
            return False
        if node.exit_reason == NodeExitReason.OOM:
            # bump memory ask and retry (resource optimizer refines it)
            node.config_resource.memory_mb *= 1.5
        # keyed by rank_index: node ids change across relaunches but the
        # rank's error history is what reveals a persistent failure
        repeated = self.error_monitor.repeated_class(node.rank_index)
        if repeated is not None and not ctx.relaunch_always:
            # the same error class on 3+ consecutive restarts: relaunching
            # is not fixing it — stop burning restarts
            logger.warning("node %s keeps failing with %r — not "
                           "relaunching", node.id, repeated)
            return False
        if node.relaunch_count >= node.max_relaunch_count:
            return False
        return True

    def _relaunch_node(self, old_node: Node):
        with self._lock:
            new_id = self._next_node_id
            self._next_node_id += 1
            new_node = old_node.get_relaunch_node_info(new_id)
            self._nodes[new_id] = new_node
            old_node.is_released = True
        logger.info("relaunching %s as node %s (attempt %d)", old_node,
                    new_id, new_node.relaunch_count)
        # a hung node (heartbeat timeout) is still RUNNING on the platform —
        # tear it down before its replacement, or both consume resources
        # (delete of an already-dead pod/process is an idempotent no-op)
        self._scaler.scale_down(old_node)
        self._scaler.scale_up(new_node)
        for listener in self._relaunch_listeners:
            listener(old_node, new_node)

    def add_relaunch_listener(self, fn: Callable[[Node, Node], None]):
        self._relaunch_listeners.append(fn)

    # ------------------------------------------------------------- status

    def all_workers_exited(self) -> bool:
        with self._lock:
            workers = [n for n in self._nodes.values()
                       if n.type == NodeType.WORKER and not n.is_released]
            return bool(workers) and all(n.exited() for n in workers)

    def all_workers_succeeded(self) -> bool:
        with self._lock:
            workers = [n for n in self._nodes.values()
                       if n.type == NodeType.WORKER and not n.is_released]
            return bool(workers) and all(
                n.status == NodeStatus.SUCCEEDED for n in workers)

    def has_failed_worker(self) -> bool:
        with self._lock:
            return any(n.type == NodeType.WORKER
                       and n.status == NodeStatus.FAILED
                       and not n.relaunchable
                       for n in self._nodes.values())


class LocalJobManager(JobManager):
    """Single-node manager backing `--standalone` (parity local_job_manager.py)."""

    def start(self, num_workers: int = 1):
        for i in range(num_workers):
            node = self.register_node(NodeType.WORKER, i, rank_index=i)
            node.update_status(NodeStatus.PENDING)

    def _relaunch_node(self, old_node: Node):
        # local processes keep their identity across restarts: reset in place
        with self._lock:
            old_node.inc_relaunch_count()
            old_node.status = NodeStatus.PENDING
            old_node.exit_reason = ""
            old_node.heartbeat_time = time.time()
        logger.info("local relaunch of %s (attempt %d)", old_node,
                    old_node.relaunch_count)
        for listener in self._relaunch_listeners:
            listener(old_node, old_node)
