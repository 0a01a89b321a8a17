"""Master-side rendezvous: the barrier that forms the elastic world.

Parity: dlrover_wuqiong_tpu/master/rendezvous.py (no JAX), copied with
`NodeSpec`, `RendezvousParameters`, the `RendezvousManager` barrier
(rounds, ``min/max_nodes``, ``node_unit``, the straggler grace and the
join timeout, topology-ordered ranks) and
`ElasticTrainingRendezvousManager`.  A completed rendezvous yields the
world — node_rank → (node_id, local device count, ip, port) — and the
coordinator address (rank 0's ip:free_port), which a port worker turns
into its ``torch.distributed`` group (trainer/elastic.py).  Left out,
each with the ROADMAP item that brings it: `NetworkCheckRendezvousManager`
(:349-464, item 13, with ``agent/node_check``); the warm-mesh formation
preference (`set_world_size_policy`, item 13); and the hot-swap
formation hold and `evict_from_world` (item 7b).  The journal's hooks
(:255-311) are here: `on_world_formed`, which the master sets after its
replay so each formed world is journaled as an ``rdzv_world`` frame, and
`export_state` / `restore_state`, with which a restarted master serves
the round and world its workers still train in.  (The JAX module's own
parity: reference
`dlrover/python/master/elastic_training/rdzv_manager.py`.)
"""

from __future__ import annotations

import threading
import time
from abc import ABC, abstractmethod
from typing import Dict, List, Optional, Tuple

from ..common.constants import RendezvousName
from ..common.log import get_logger

logger = get_logger("rendezvous")


class NodeSpec:
    """What a node declares when joining."""

    def __init__(self, node_id: int, node_rank: int, local_world_size: int,
                 node_ip: str = "", free_port: int = 0,
                 slice_id: str = ""):
        self.node_id = node_id
        self.node_rank = node_rank
        self.local_world_size = local_world_size
        self.node_ip = node_ip
        self.slice_id = slice_id
        self.free_port = free_port
        self.join_time = time.time()


class RendezvousParameters:
    def __init__(self, min_nodes: int, max_nodes: int,
                 waiting_timeout: float = 30.0,
                 join_timeout: float = 600.0):
        self.min_nodes = min_nodes
        self.max_nodes = max_nodes
        # extra seconds to wait for stragglers once min_nodes have joined
        self.waiting_timeout = waiting_timeout
        self.join_timeout = join_timeout


class RendezvousManager(ABC):
    """Barrier forming the elastic communication world."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._params = RendezvousParameters(1, 1)
        self._waiting_nodes: Dict[int, NodeSpec] = {}  # node_id -> spec
        self._rdzv_world: Dict[int, NodeSpec] = {}  # node_rank -> spec
        self._rdzv_round = 0
        self._latest_rdzv_nodes: List[int] = []
        self._start_rdzv_ts = 0.0
        self._alive_nodes: set = set()
        self._node_unit = 1
        # journal hook (master/master.py): fn(name, state) after every
        # world formation
        self.on_world_formed = None

    def update_rdzv_params(self, min_nodes: int, max_nodes: int,
                           waiting_timeout: float = 30.0,
                           join_timeout: float = 600.0, node_unit: int = 1):
        with self._lock:
            self._params = RendezvousParameters(min_nodes, max_nodes,
                                                waiting_timeout, join_timeout)
            self._node_unit = max(1, node_unit)

    def get_rdzv_round(self) -> int:
        return self._rdzv_round

    def add_alive_node(self, node_id: int):
        with self._lock:
            self._alive_nodes.add(node_id)

    def remove_alive_node(self, node_id: int):
        with self._lock:
            self._alive_nodes.discard(node_id)
            if node_id in self._waiting_nodes:
                del self._waiting_nodes[node_id]
                logger.info("%s: removed dead waiting node %s", self.name,
                            node_id)

    def join_rendezvous(self, node_id: int, node_rank: int,
                        local_world_size: int, node_ip: str = "",
                        free_port: int = 0, slice_id: str = "") -> int:
        """Register a node as waiting; returns the current round."""
        with self._lock:
            if node_id not in self._waiting_nodes:
                self._waiting_nodes[node_id] = NodeSpec(
                    node_id, node_rank, local_world_size, node_ip,
                    free_port, slice_id)
                if not self._start_rdzv_ts:
                    # monotonic: elapsed-wait math only, never persisted
                    self._start_rdzv_ts = time.monotonic()
                logger.info(
                    "%s: node %s (rank hint %s) joined; waiting=%d round=%d",
                    self.name, node_id, node_rank, len(self._waiting_nodes),
                    self._rdzv_round)
            self._alive_nodes.add(node_id)
            return self._rdzv_round

    def num_nodes_waiting(self) -> int:
        """Nonzero signals agents that a re-rendezvous is pending.

        Parity: reference agents poll this to trigger restart on membership
        change (`training.py:711 _membership_changed`).
        """
        with self._lock:
            # Only report when a *new* world could form (e.g. replacement node
            # arrived while training) — mirrors reference semantics where
            # waiting>0 triggers worker restart.
            return len(self._waiting_nodes)

    def _world_ready(self) -> bool:
        n = len(self._waiting_nodes)
        if n < self._params.min_nodes:
            return False
        if n >= self._params.max_nodes:
            return True
        # min reached but below max: give stragglers a grace window
        return (time.monotonic()
                - self._start_rdzv_ts) > self._params.waiting_timeout

    def _form_world(self):
        # topology-aware ordering: same-slice/subnet nodes get contiguous
        # ranks (master/net_topology.py)
        from .net_topology import DpTopologySorter, NodeTopologyMeta

        metas = [NodeTopologyMeta(node_id=s.node_id, node_rank=s.node_rank,
                                  ip=getattr(s, "node_ip", ""),
                                  slice_id=getattr(s, "slice_id", ""))
                 for s in self._waiting_nodes.values()]
        order = {m.node_id: i for i, m in
                 enumerate(DpTopologySorter().sort(metas))}
        specs = sorted(self._waiting_nodes.values(),
                       key=lambda s: order[s.node_id])
        n = len(specs)
        if n > self._params.max_nodes:
            specs = specs[: self._params.max_nodes]
            n = len(specs)
        # honor node_unit (e.g. a host's or an NVLink domain's granularity)
        usable = (n // self._node_unit) * self._node_unit
        specs = specs[:usable]
        self._rdzv_world = {rank: spec for rank, spec in enumerate(specs)}
        for spec in specs:
            del self._waiting_nodes[spec.node_id]
        self._latest_rdzv_nodes = [s.node_id for s in specs]
        wait_s = (time.monotonic() - self._start_rdzv_ts
                  if self._start_rdzv_ts else 0.0)
        self._start_rdzv_ts = 0.0
        self._rdzv_round += 1
        logger.info("%s: formed world round=%d nodes=%s", self.name,
                    self._rdzv_round, self._latest_rdzv_nodes)
        from ..telemetry import spans as tspans

        tspans.span_event(f"rdzv:{self.name}:world-formed",
                          {"round": self._rdzv_round,
                           "nodes": len(self._latest_rdzv_nodes),
                           "wait_s": wait_s})
        if self.on_world_formed is not None:
            try:
                # _form_world runs under self._lock — use the lock-free view
                self.on_world_formed(self.name, self._export_locked())
            except Exception:  # noqa: BLE001 — journaling is best-effort
                logger.exception("world-formed journal hook failed")

    # ------------------------------------------------------- journal replay

    @staticmethod
    def _spec_to_list(s: "NodeSpec") -> List:
        return [s.node_id, s.node_rank, s.local_world_size, s.node_ip,
                s.free_port, s.slice_id]

    @staticmethod
    def _spec_from_list(v: List) -> "NodeSpec":
        return NodeSpec(int(v[0]), int(v[1]), int(v[2]), v[3], int(v[4]),
                        v[5] if len(v) > 5 else "")

    def _export_locked(self) -> Dict:
        return {
            "round": self._rdzv_round,
            "world": {str(rank): self._spec_to_list(s)
                      for rank, s in self._rdzv_world.items()},
            "waiting": [self._spec_to_list(s)
                        for s in self._waiting_nodes.values()],
            "alive": sorted(self._alive_nodes),
            "latest": list(self._latest_rdzv_nodes),
        }

    def export_state(self) -> Dict:
        """Snapshot for the master journal (master/journal.py)."""
        with self._lock:
            return self._export_locked()

    def restore_state(self, data: Dict):
        """Install a journaled world: the restarted master serves the SAME
        round and membership the workers are still training in, so no
        re-rendezvous (and no world restart) is triggered by a master-only
        failure."""
        with self._lock:
            self._rdzv_round = max(self._rdzv_round,
                                   int(data.get("round", 0)))
            world = {int(r): self._spec_from_list(v)
                     for r, v in data.get("world", {}).items()}
            if world:
                self._rdzv_world = world
            self._latest_rdzv_nodes = list(data.get("latest", []))
            self._alive_nodes.update(data.get("alive", []))
            for v in data.get("waiting", []):
                spec = self._spec_from_list(v)
                self._waiting_nodes.setdefault(spec.node_id, spec)
            # members of the restored world are no longer waiting
            for spec in self._rdzv_world.values():
                self._waiting_nodes.pop(spec.node_id, None)

    @abstractmethod
    def get_comm_world(self, node_id: int) -> Tuple[int, int, Dict[int, NodeSpec]]:
        """Returns (round, group, world{node_rank: NodeSpec}); empty world if
        not yet formed."""

    def coordinator_addr(self) -> str:
        with self._lock:
            spec = self._rdzv_world.get(0)
            if spec is None:
                return ""
            return f"{spec.node_ip or '127.0.0.1'}:{spec.free_port}"

    def rdzv_timed_out(self) -> bool:
        with self._lock:
            return bool(
                self._start_rdzv_ts
                and time.monotonic() - self._start_rdzv_ts
                > self._params.join_timeout)


class ElasticTrainingRendezvousManager(RendezvousManager):
    """Parity: reference rdzv_manager.py:291."""

    def __init__(self):
        super().__init__(RendezvousName.ELASTIC_TRAINING)

    def get_comm_world(self, node_id: int):
        with self._lock:
            if self._world_ready():
                self._form_world()
            if node_id in [s.node_id for s in self._rdzv_world.values()]:
                return self._rdzv_round, 0, dict(self._rdzv_world)
            return self._rdzv_round, 0, {}

