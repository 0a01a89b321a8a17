"""Node model and status state machine.

Parity: a copy of dlrover_wuqiong_tpu/common/node.py:1-175 (no JAX),
kept in the port because the port imports nothing of the JAX package:
`Node`, `NodeEvent` and `NodeStateFlow` with the same fields, statuses
and transition table.  (The JAX module's own parity: reference
`dlrover/python/common/node.py` and `master/node/status_flow.py`.)
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Optional

from .constants import NodeEventType, NodeExitReason, NodeStatus


@dataclass
class NodeResource:
    cpu: float = 0.0
    memory_mb: float = 0.0
    accelerator_type: str = ""
    accelerator_num: int = 0

    def to_dict(self) -> Dict:
        return {
            "cpu": self.cpu,
            "memory_mb": self.memory_mb,
            "accelerator_type": self.accelerator_type,
            "accelerator_num": self.accelerator_num,
        }


@dataclass
class NodeGroupResource:
    count: int = 0
    node_resource: NodeResource = field(default_factory=NodeResource)


class Node:
    """A training node (pod / local process) tracked by the master."""

    def __init__(
        self,
        node_type: str,
        node_id: int,
        rank_index: Optional[int] = None,
        name: str = "",
        status: str = NodeStatus.INITIAL,
        config_resource: Optional[NodeResource] = None,
        max_relaunch_count: int = 3,
    ):
        self.type = node_type
        self.id = node_id
        self.rank_index = rank_index if rank_index is not None else node_id
        self.name = name or f"{node_type}-{node_id}"
        self.status = status
        self.config_resource = config_resource or NodeResource()
        self.used_resource = NodeResource()
        self.max_relaunch_count = max_relaunch_count

        self.relaunch_count = 0
        self.relaunchable = True
        self.is_released = False
        self.exit_reason = ""
        self.addr = ""
        self.create_time: Optional[float] = None
        self.start_time: Optional[float] = None
        self.finish_time: Optional[float] = None
        self.heartbeat_time: float = 0.0
        self.start_hang_time: float = 0.0
        self.hang = False
        self.reported_status = ""
        self.restart_training = False
        # set with restart_training by a loss-spike rollback: the restarted
        # worker must resume from a committed ckpt step BEFORE this
        self.rollback_before_step = -1
        self.paral_config_version = 0

    # ------------------------------------------------------------- transitions

    def update_status(self, status: str):
        if status and status != self.status:
            self.status = status
            if status == NodeStatus.RUNNING and self.start_time is None:
                self.start_time = time.time()
            if status in NodeStatus.terminal():
                self.finish_time = time.time()

    def update_info(self, name: str = "", addr: str = "",
                    create_time: Optional[float] = None):
        if name:
            self.name = name
        if addr:
            self.addr = addr
        if create_time:
            self.create_time = create_time

    def update_resource_usage(self, cpu: float, memory_mb: float,
                              accelerator_stats: Optional[Dict] = None):
        self.used_resource.cpu = cpu
        self.used_resource.memory_mb = memory_mb

    def inc_relaunch_count(self):
        self.relaunch_count += 1

    def exited(self) -> bool:
        return self.status in NodeStatus.terminal()

    def is_unrecoverable_failure(self) -> bool:
        if not self.relaunchable:
            return True
        if self.relaunch_count >= self.max_relaunch_count:
            return True
        if self.exit_reason == NodeExitReason.FATAL_ERROR:
            return True
        return False

    def get_relaunch_node_info(self, new_id: int) -> "Node":
        new_node = Node(
            self.type,
            new_id,
            rank_index=self.rank_index,
            config_resource=self.config_resource,
            max_relaunch_count=self.max_relaunch_count,
        )
        new_node.relaunch_count = self.relaunch_count + 1
        return new_node

    def __repr__(self):
        return (f"Node({self.type}-{self.id} rank={self.rank_index} "
                f"status={self.status})")


@dataclass
class NodeEvent:
    event_type: str  # NodeEventType
    node: Node


class NodeStateFlow:
    """Allowed status transitions and the relaunch decision they imply.

    Parity: reference `master/node/status_flow.py` transition table.
    """

    _FLOW = {
        (NodeStatus.INITIAL, NodeStatus.PENDING): False,
        (NodeStatus.INITIAL, NodeStatus.RUNNING): False,
        (NodeStatus.INITIAL, NodeStatus.FAILED): True,
        (NodeStatus.INITIAL, NodeStatus.DELETED): True,
        (NodeStatus.PENDING, NodeStatus.RUNNING): False,
        (NodeStatus.PENDING, NodeStatus.SUCCEEDED): False,
        (NodeStatus.PENDING, NodeStatus.FAILED): True,
        (NodeStatus.PENDING, NodeStatus.DELETED): True,
        (NodeStatus.RUNNING, NodeStatus.SUCCEEDED): False,
        (NodeStatus.RUNNING, NodeStatus.FAILED): True,
        (NodeStatus.RUNNING, NodeStatus.DELETED): True,
        (NodeStatus.RUNNING, NodeStatus.BREAKDOWN): True,
        (NodeStatus.UNKNOWN, NodeStatus.RUNNING): False,
        (NodeStatus.UNKNOWN, NodeStatus.FAILED): True,
        (NodeStatus.UNKNOWN, NodeStatus.DELETED): True,
    }

    @classmethod
    def can_transition(cls, from_status: str, to_status: str) -> bool:
        if from_status == to_status:
            return False
        if from_status in (NodeStatus.SUCCEEDED, NodeStatus.FAILED):
            # terminal except deletion bookkeeping
            return to_status == NodeStatus.DELETED
        return (from_status, to_status) in cls._FLOW or \
            from_status == NodeStatus.UNKNOWN

    @classmethod
    def should_relaunch(cls, from_status: str, to_status: str) -> bool:
        return cls._FLOW.get((from_status, to_status), False)
