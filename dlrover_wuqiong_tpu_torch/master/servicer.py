"""RPC dispatch: single get/report envelope over the master's services.

Parity: dlrover_wuqiong_tpu/master/servicer.py — `MasterServicer.handle`
(:61-82) with its idem replay, over the verbs the serving worker uses:
lease, result query and stats query (get, :211-232); submit, result
report and stats report (report, :446-475); `NodeMeta` registration
(:319); and `NodeFailure` (:345-360), reduced to requeueing the node's
leases.  `create_master_service` is :503-508.

Left out, with what brings them: the not-leader gate (standby masters),
the journal frames, NodeFailure's error classification and relaunch
table, and every other verb (ROADMAP items 6a, 7a and 15).  A message
this servicer does not know raises ValueError, as the JAX servicer's do
(:254, :500).

Verbs that arrive with an idempotency key (``idem``) are answered from
the master's in-memory idem cache when retried, so a retried lease gets
the SAME requests back and a retried submit or result report is applied
once.
"""

from __future__ import annotations

from typing import Any, Optional

from ..common import messages as msg
from ..common.comm import RpcServer
from ..common.log import get_logger

logger = get_logger("servicer")

_NOT_PORTED = ("the port's master answers the serving verbs only; the "
               "others come with ROADMAP items 6a, 7a and 15")


class MasterServicer:
    def __init__(self, job_master):
        self.m = job_master

    # --------------------------------------------------------------- dispatch

    def handle(self, verb: str, node_id: int, node_type: str,
               payload: Any, idem: Optional[str] = None) -> Any:
        cache = getattr(self.m, "idem_cache", None)
        if idem and cache is not None:
            hit = cache.get(idem)
            if hit is not cache.MISS:
                logger.info("idem replay for %s (%s) — returning the "
                            "recorded response", idem,
                            type(payload).__name__)
                return hit
        if verb == "get":
            resp = self._get(node_id, node_type, payload)
        else:
            resp = self._report(node_id, node_type, payload)
        if idem and cache is not None:
            cache.put(idem, resp)
        return resp

    def _get(self, node_id: int, node_type: str, payload: Any) -> Any:
        m = self.m
        if isinstance(payload, msg.ServeLeaseRequest):
            # a lease moves queue state: the idem cache (handle) gives a
            # retried lease the SAME requests back, or they would strand
            # in `leased`
            return msg.ServeLease(requests=m.serve_queue.lease(
                payload.node_id, payload.max_requests))

        if isinstance(payload, msg.ServeResultQuery):
            results, pending = m.serve_queue.take_results(
                payload.request_ids)
            return msg.ServeResultResponse(results=results,
                                           pending=pending)

        if isinstance(payload, msg.ServeStatsQuery):
            return m.serve_summary()

        raise ValueError(f"unknown get message: {type(payload).__name__} "
                         f"({_NOT_PORTED})")

    def _report(self, node_id: int, node_type: str, payload: Any) -> Any:
        m = self.m
        if isinstance(payload, msg.NodeMeta):
            m.register_node(payload)
            return msg.OkResponse()

        if isinstance(payload, msg.NodeFailure):
            # a dead worker's leases go back to the queue front; the
            # error classification and relaunch table are not ported
            m.note_node_failure(payload)
            return msg.OkResponse()

        if isinstance(payload, msg.ServeSubmitRequest):
            accepted = m.serve_queue.submit(payload.requests)
            return msg.ServeSubmitAck(
                accepted=accepted,
                queue_depth=m.serve_queue.summary().queue_depth)

        if isinstance(payload, msg.ServeResultReport):
            m.serve_queue.complete(payload.results)
            return msg.OkResponse()

        if isinstance(payload, msg.ServeStatsReport):
            # pure telemetry (cumulative snapshot, latest-wins)
            m.collect_serve_stats(payload)
            return msg.OkResponse()

        raise ValueError(f"unknown report message: "
                         f"{type(payload).__name__} ({_NOT_PORTED})")


def create_master_service(job_master, host: str = "0.0.0.0",
                          port: int = 0) -> RpcServer:
    """Parity: dlrover_wuqiong_tpu/master/servicer.py:503
    create_master_service."""
    servicer = MasterServicer(job_master)
    return RpcServer(servicer.handle, host=host, port=port,
                     epoch_provider=lambda: getattr(job_master, "epoch", 1))
