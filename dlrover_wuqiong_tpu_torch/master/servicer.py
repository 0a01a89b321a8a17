"""RPC dispatch: single get/report envelope over the master's services.

Parity: dlrover_wuqiong_tpu/master/servicer.py — `MasterServicer.handle`
(:61-82) with its idem replay, over the verbs of the elastic trainer and
of the serving worker:

- get (:100-232): comm world, waiting-node count, kv get, multi-get and
  add, the goodput summary, the serve lease, result and stats queries;
- report (:257-475): rendezvous join (which registers the node and
  counts as its first heartbeat), heartbeat, `NodeMeta`, global step,
  `NodeFailure` (classified by the error catalogue, the node's event
  processed, its serve leases requeued, its rendezvous membership
  dropped; the reply says whether a restart can fix the class, with the
  repeated-class cutoff unless ``relaunch_always``), node events, kv
  set, custom metrics and model info, the goodput ledger, and the serve
  submit, result and stats reports.

`create_master_service` is :503-508.  Left out, with what brings them:
the not-leader gate (standby masters) and the journal frames (item 15),
the network-check verbs (item 13), and the dataset-sharding, policy,
mesh-transition, diagnosis and perf verbs (item 15).  A message this
servicer does not know raises ValueError, as the JAX servicer's do
(:254, :500).

Verbs that arrive with an idempotency key (``idem``) are answered from
the master's in-memory idem cache when retried, so a retried lease gets
the SAME requests back and a retried join, kv add, submit or result
report is applied once.
"""

from __future__ import annotations

from typing import Any, Optional

from ..common import messages as msg
from ..common.comm import RpcServer
from ..common.constants import NodeEventType, NodeStatus
from ..common.global_context import get_context
from ..common.log import get_logger
from ..common.node import Node, NodeEvent

logger = get_logger("servicer")

_NOT_PORTED = ("the port's master answers the elastic-training and "
               "serving verbs; the others come with ROADMAP items 13 "
               "and 15")


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
        if isinstance(payload, msg.CommWorldRequest):
            rdzv = m.rdzv_manager(payload.rdzv_name)
            rdzv_round, group, world = rdzv.get_comm_world(payload.node_id)
            state = msg.RendezvousState(rdzv_round=rdzv_round, group=group)
            if world:
                state.world = {
                    str(rank): [s.node_id, s.local_world_size, s.node_ip,
                                s.free_port]
                    for rank, s in world.items()
                }
                state.coordinator_addr = rdzv.coordinator_addr()
                state.complete = True
            return state

        if isinstance(payload, msg.WaitingNodeNumRequest):
            rdzv = m.rdzv_manager(payload.rdzv_name)
            return msg.WaitingNodeNumResponse(
                waiting_num=rdzv.num_nodes_waiting())

        if isinstance(payload, msg.KVStoreGetRequest):
            value = m.kv_store.get(payload.key)
            return msg.KVStoreResponse(found=value is not None,
                                       value=value or b"")

        if isinstance(payload, msg.KVStoreMultiGetRequest):
            values = m.kv_store.multi_get(payload.keys)
            if any(v is None for v in values):
                return msg.KVStoreResponse(found=False)
            return msg.KVStoreResponse(found=True, values=values)

        if isinstance(payload, msg.KVStoreAddRequest):
            # counter adds are NOT naturally idempotent: the idem key
            # (handle) replays a retried add's answer
            num = m.kv_store.add(payload.key, payload.amount)
            return msg.KVStoreResponse(found=True, num=num)

        if isinstance(payload, msg.GoodputQuery):
            return m.goodput_summary()

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
        if isinstance(payload, msg.JoinRendezvousRequest):
            rdzv = m.rdzv_manager(payload.rdzv_name)
            rdzv_round = rdzv.join_rendezvous(
                payload.node_id, payload.node_rank, payload.local_world_size,
                payload.node_ip, payload.free_port, payload.slice_id)
            m.job_manager.register_node("worker", payload.node_id,
                                        rank_index=payload.node_rank)
            m.job_manager.collect_heartbeat(payload.node_id)
            return msg.RendezvousState(rdzv_round=rdzv_round)

        if isinstance(payload, msg.HeartBeat):
            action, rb = m.job_manager.collect_heartbeat_full(
                payload.node_id, payload.timestamp)
            if payload.global_step:
                m.speed_monitor.collect_global_step(payload.global_step,
                                                    payload.timestamp)
            return msg.HeartbeatResponse(action=action,
                                         rollback_before_step=rb)

        if isinstance(payload, msg.NodeMeta):
            node = m.job_manager.register_node(
                payload.node_type, payload.node_id,
                rank_index=payload.node_rank, addr=payload.addr)
            node.config_resource.cpu = payload.cpu
            node.config_resource.memory_mb = payload.memory_mb
            node.config_resource.accelerator_type = payload.accelerator_type
            node.config_resource.accelerator_num = payload.accelerator_num
            return msg.OkResponse()

        if isinstance(payload, msg.GlobalStep):
            m.speed_monitor.collect_global_step(payload.step,
                                                payload.timestamp)
            return msg.OkResponse()

        if isinstance(payload, msg.NodeFailure):
            live = m.job_manager.get_node(payload.node_id)
            rank = live.rank_index if live is not None else payload.node_id
            # error-class catalogue: raw error text → NodeExitReason that
            # the relaunch decision table understands
            reason, relaunchable = m.job_manager.error_monitor.process_error(
                rank, payload.restart_count, payload.error_data,
                payload.level, node_id=payload.node_id)
            node = Node("worker", payload.node_id)
            node.status = NodeStatus.FAILED
            node.exit_reason = reason
            m.job_manager.process_event(NodeEvent(NodeEventType.MODIFIED,
                                                  node))
            m.serve_queue.recover_node(payload.node_id)
            for rdzv in m.rdzv_managers.values():
                rdzv.remove_alive_node(payload.node_id)
            # tell the agent whether process restarts can fix this class —
            # a user-code error restarts into the same crash every time,
            # and a class repeating across restarts is equally unfixable.
            # relaunch_always overrides: on preemption-heavy pools a
            # SIGKILL storm classifies as host_oom (exit_code=137 is
            # ambiguous) and would otherwise strand the job after 3 kills
            repeated = m.job_manager.error_monitor.repeated_class(rank)
            if repeated is not None and not get_context().relaunch_always:
                relaunchable = False
                why = f"error class {repeated!r} repeats across restarts"
            else:
                why = f"error class not restartable ({reason})"
            return msg.OkResponse(success=relaunchable,
                                  reason="" if relaunchable else why)

        if isinstance(payload, msg.NodeEventReport):
            logger.info("node event from %s: %s %s", payload.node_id,
                        payload.event_type, payload.message)
            m.record_node_event(payload)
            return msg.OkResponse()

        if isinstance(payload, msg.KVStoreSetRequest):
            m.kv_store.set(payload.key, payload.value)
            return msg.OkResponse()

        if isinstance(payload, (msg.ModelInfo, msg.CustomMetric)):
            m.collect_custom_data(payload)
            return msg.OkResponse()

        if isinstance(payload, msg.GoodputLedgerReport):
            # pure telemetry (cumulative snapshot, latest-wins)
            m.collect_goodput(payload)
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
