"""Job master of the serving plane: the request queue behind the RPC verbs.

Parity: the part of dlrover_wuqiong_tpu/master/master.py (`JobMaster`)
that the serving verbs touch: the serve queue, the idem cache, a node
table, `serve_summary` and `collect_serve_stats` (:701-718, without the
Prometheus gauges, which come with `master/metrics.py` in ROADMAP item
6a), and `start` (the JAX master's `prepare`), `stop`, `port`, `addr`.

Not here yet (ROADMAP item 15): the journal, so a master restart loses
the queue (the JAX master replays it, `tests/test_serving.py`
TestServeJournalReplay); the fencing epoch's bumps (this master serves
epoch 1 for its whole life); standby masters; the training managers
(rendezvous, shards, kv store, diagnosis, policy); and
``python -m dlrover_wuqiong_tpu_torch.master``.  Host it in-process, as
`chaos.serve_drain` and chip_smoke.py do.
"""

from __future__ import annotations

import threading
from typing import Dict

from ..common import messages as msg
from ..common.log import get_logger
from .journal import IdemCache
from .serve_queue import ServeQueueManager
from .servicer import create_master_service

logger = get_logger("master")


class JobMaster:
    """One master per job; owns the serving queue and the RPC service."""

    def __init__(self, port: int = 0, host: str = "0.0.0.0"):
        self.serve_queue = ServeQueueManager()
        self.idem_cache = IdemCache()
        self.epoch = 1
        self._nodes_lock = threading.Lock()
        #: node_id -> its registration; failed nodes stay, marked
        self.nodes: Dict[int, msg.NodeMeta] = {}
        self.failed_nodes: Dict[int, msg.NodeFailure] = {}
        self._server = create_master_service(self, host=host, port=port)

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
        self._server.stop()

    # ----------------------------------------------------------------- nodes

    def register_node(self, meta: msg.NodeMeta):
        with self._nodes_lock:
            self.nodes[meta.node_id] = meta
            self.failed_nodes.pop(meta.node_id, None)

    def note_node_failure(self, failure: msg.NodeFailure) -> int:
        """A node died: requeue its leased requests to the queue front.
        Returns how many went back."""
        with self._nodes_lock:
            self.failed_nodes[failure.node_id] = failure
        n = self.serve_queue.recover_node(failure.node_id)
        logger.warning("node %d failed (%s): %d leased requests requeued",
                       failure.node_id, failure.error_data, n)
        return n

    # --------------------------------------------------------------- serving

    def collect_serve_stats(self, report: msg.ServeStatsReport):
        """Latest-SENT-wins per-worker serving snapshot (BUFFERED verb: a
        drained stale buffer must not overwrite a fresher snapshot)."""
        self.serve_queue.collect_stats(report)

    def serve_summary(self) -> msg.ServeSummary:
        return self.serve_queue.summary()
