"""RPC dispatch: single get/report envelope over the master's services.

Parity: dlrover_wuqiong_tpu/master/servicer.py — `NotLeaderError` and
`READ_ONLY_VERBS` (:30-51), `MasterServicer.handle` (:61-82) with its
not-leader gate and idem replay and the journaled ack `_journal`
(:84-100), over the verbs of the elastic trainer, of dataset sharding,
of the warm standby and of the serving worker:

- get (:100-252): task requests (a dispatch is journaled), comm world,
  waiting-node count, kv get, multi-get and add, the shard checkpoint,
  the goodput summary, the journal's gauges, a standby's journal fetch
  (:204), the serve lease, result and stats queries, and the incident
  timeline (:246);
- report (:257-475): rendezvous join (which registers the node and
  counts as its first heartbeat), task results, dataset shard params,
  heartbeat, `NodeMeta`, global step, `NodeFailure` (classified by the
  error catalogue, the node's event processed, its shards and serve
  leases requeued, its rendezvous membership dropped, the recovery
  journaled; the reply says whether a restart can fix the class, with
  the repeated-class cutoff unless ``relaunch_always``), node events, kv
  set, a shard checkpoint to restore, custom metrics and model info, the
  goodput ledger, and the serve submit, result and stats reports.

Every mutating verb is journaled (master/journal.py) after the managers
applied it and before its response leaves: the frame is queued and the
ack waits on the journal's durable watermark, so concurrent verbs share
one fsync and an acked mutation is a durable one.  A verb that arrives
with an idempotency key (``idem``) carries its response in its frame,
and a retry is answered from the idem cache, which replay rebuilds: a
retried task request or lease gets the SAME shard or requests back, and
a retried join, kv add, task result, submit or result report is applied
once, even when the retry lands on a freshly replayed master.

A master that is not the leader (a standby, or a corpse fenced by its
peer) answers only `READ_ONLY_VERBS` and raises `NotLeaderError` for
every other verb BEFORE the idem cache: a fenced corpse's replayed
cache can be stale against the promoted standby's, so a mutation is
answered by the leader alone.  The client reads the error's name as
"dial the next endpoint" (agent/master_client.py).  `READ_ONLY_VERBS`
is the JAX list less the verbs the port has no message for yet:
``NetworkReadyRequest`` and ``StragglerExistRequest`` (item 13),
``ParallelConfigRequest``, ``PerfQuery``, ``PolicyStateRequest`` and
``PolicyHistoryRequest`` (item 15), ``MeshTransitionQuery`` (item 7b
part 3).

`create_master_service` is :503-508.  Left out, with what brings them:
the mesh-transition verbs (item 7b part 3), the network-check verbs
(item 13), and the policy, paral-config, perf and diagnosis verbs (item
15).  A message this servicer does not know raises ValueError, as the
JAX servicer's do (:254, :500).
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

_NOT_PORTED = ("the port's master answers the elastic-training, "
               "dataset-sharding, journal, standby, timeline and serving "
               "verbs; the others come with ROADMAP items 13 and 15, the "
               "mesh-transition verbs with item 7b part 3")


class NotLeaderError(RuntimeError):
    """Mutating verb hit a standby or fenced master.

    Surfaces client-side as an RpcError whose text carries this class
    name — MasterClient treats it as "advance to the next endpoint",
    the ONE sanctioned re-dial of an answered RPC (the verb was never
    applied here, so re-sending it to the real leader is safe, and the
    original idem key keeps it exactly-once)."""


#: verbs a non-leader still answers: pure reads with no queue or state
#: movement.  Everything else gets NotLeaderError BEFORE the idem cache.
READ_ONLY_VERBS = (
    "CommWorldRequest", "WaitingNodeNumRequest", "KVStoreGetRequest",
    "KVStoreMultiGetRequest", "ShardCheckpointRequest", "GoodputQuery",
    "JournalStatsQuery", "FetchJournalRequest", "ServeResultQuery",
    "ServeStatsQuery", "TimelineQuery",
)


class MasterServicer:
    def __init__(self, job_master):
        self.m = job_master

    # --------------------------------------------------------------- dispatch

    def handle(self, verb: str, node_id: int, node_type: str,
               payload: Any, idem: Optional[str] = None) -> Any:
        if not getattr(self.m, "is_leader", True) and \
                type(payload).__name__ not in READ_ONLY_VERBS:
            raise NotLeaderError(
                f"not the leader (epoch {getattr(self.m, 'epoch', 0)}) — "
                f"{type(payload).__name__} must go to the active primary")
        cache = getattr(self.m, "idem_cache", None)
        if idem and cache is not None:
            hit = cache.get(idem)
            if hit is not cache.MISS:
                logger.info("idem replay for %s (%s) — returning the "
                            "recorded response", idem,
                            type(payload).__name__)
                return hit
        if verb == "get":
            resp = self._get(node_id, node_type, payload, idem=idem)
        else:
            resp = self._report(node_id, node_type, payload, idem=idem)
        if idem and cache is not None:
            cache.put(idem, resp)
        return resp

    def _journal(self, kind: str, data: dict, idem: Optional[str] = None,
                 resp: Any = None):
        """Append one event frame; idem-keyed events carry their response
        so replay rebuilds the at-most-once cache atomically with the
        mutation (a separate idem frame could be lost between appends).

        Group commit: the frame is enqueued and the ack gates on the
        journal's DURABLE WATERMARK covering its seq — concurrent verbs
        share one fsync, journal-before-ack holds per frame."""
        journal = getattr(self.m, "journal", None)
        if journal is None:
            return
        if idem:
            data = {**data, "idem": idem, "resp": resp}
        seq = journal.append_nowait(kind, data)
        journal.wait_durable(seq)

    def _get(self, node_id: int, node_type: str, payload: Any,
             idem: Optional[str] = None) -> Any:
        m = self.m
        if isinstance(payload, msg.TaskRequest):
            task = m.task_manager.get_dataset_task(node_id,
                                                   payload.dataset_name)
            if task is None:
                finished = m.task_manager.finished(payload.dataset_name)
                return msg.Task(
                    task_id=-1,
                    task_type="none" if finished else "wait",
                    dataset_name=payload.dataset_name)
            resp = msg.Task(
                task_id=task.task_id, task_type=task.task_type,
                shard=msg.ShardConfig(start=task.shard.start,
                                      end=task.shard.end,
                                      indices=task.shard.record_indices),
                dataset_name=payload.dataset_name)
            # idem matters here: a retried TaskRequest crossing a master
            # restart must get the SAME task back — a fresh dispatch would
            # strand the journaled one in `doing` forever
            self._journal("dispatch", {
                "dataset_name": payload.dataset_name,
                "task_id": task.task_id, "node_id": node_id,
                "start": task.shard.start, "end": task.shard.end,
                "indices": task.shard.record_indices},
                idem=idem, resp=resp)
            return resp

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
            num = m.kv_store.add(payload.key, payload.amount)
            resp = msg.KVStoreResponse(found=True, num=num)
            # counter adds are NOT naturally idempotent — the idem key and
            # response ride in the same frame so a cross-restart retry
            # replays the answer instead of drifting the counter; the
            # ABSOLUTE result is journaled (replay = set, last-writer-wins)
            # so a frame that races a concurrent snapshot converges instead
            # of double-adding
            self._journal("kv_add", {"key": payload.key,
                                     "amount": payload.amount,
                                     "result": num},
                          idem=idem, resp=resp)
            return resp

        if isinstance(payload, msg.ShardCheckpointRequest):
            content = m.task_manager.get_dataset_checkpoint(
                payload.dataset_name)
            return msg.ShardCheckpoint(content=content)

        if isinstance(payload, msg.GoodputQuery):
            return m.goodput_summary()

        if isinstance(payload, msg.JournalStatsQuery):
            # read-only gauge poll (never journaled): group-commit batch
            # sizes + durable watermark
            return m.journal_stats()

        if isinstance(payload, msg.FetchJournalRequest):
            # standby pull (POLLING class, read-only, NEVER journaled —
            # journaling a fetch would make shipping feed itself):
            # durable frames after from_seq verbatim, snapshot handoff
            # when compaction already truncated the range
            return m.fetch_journal(payload.from_seq, payload.max_frames)

        if isinstance(payload, msg.ServeLeaseRequest):
            leased = m.serve_queue.lease(payload.node_id,
                                         payload.max_requests)
            resp = msg.ServeLease(requests=leased)
            if not leased:
                return resp
            # a lease moves queue state: like TaskRequest dispatch, a
            # retried lease crossing a master restart must get the SAME
            # requests back or the originals strand in `leased` forever
            self._journal("serve_lease", {
                "node_id": payload.node_id,
                "request_ids": [r.request_id for r in leased]},
                idem=idem, resp=resp)
            return resp

        if isinstance(payload, msg.ServeResultQuery):
            results, pending = m.serve_queue.take_results(
                payload.request_ids)
            return msg.ServeResultResponse(results=results,
                                           pending=pending)

        if isinstance(payload, msg.ServeStatsQuery):
            return m.serve_summary()

        if isinstance(payload, msg.TimelineQuery):
            # read-only incident assembly from disk artifacts (never
            # journaled): the answer must stay byte-equal to the offline
            # reconstruction, so no in-memory state contributes
            return m.timeline_report(
                payload.ckpt_dir, journal_dirs=list(payload.journal_dirs))

        raise ValueError(f"unknown get message: {type(payload).__name__} "
                         f"({_NOT_PORTED})")

    def _report(self, node_id: int, node_type: str, payload: Any,
                idem: Optional[str] = None) -> Any:
        m = self.m
        if isinstance(payload, msg.JoinRendezvousRequest):
            rdzv = m.rdzv_manager(payload.rdzv_name)
            rdzv_round = rdzv.join_rendezvous(
                payload.node_id, payload.node_rank, payload.local_world_size,
                payload.node_ip, payload.free_port, payload.slice_id)
            m.job_manager.register_node("worker", payload.node_id,
                                        rank_index=payload.node_rank)
            m.job_manager.collect_heartbeat(payload.node_id)
            resp = msg.RendezvousState(rdzv_round=rdzv_round)
            self._journal("rdzv_join", {
                "rdzv_name": payload.rdzv_name, "node_id": payload.node_id,
                "node_rank": payload.node_rank,
                "local_world_size": payload.local_world_size,
                "node_ip": payload.node_ip, "free_port": payload.free_port,
                "slice_id": payload.slice_id}, idem=idem, resp=resp)
            return resp

        if isinstance(payload, msg.TaskResult):
            success = not payload.err_message
            m.task_manager.report_dataset_task(
                node_id, payload.dataset_name, payload.task_id, success)
            resp = msg.OkResponse()
            self._journal("task_result", {
                "dataset_name": payload.dataset_name,
                "task_id": payload.task_id, "node_id": node_id,
                "success": success}, idem=idem, resp=resp)
            return resp

        if isinstance(payload, msg.DatasetShardParams):
            created = m.task_manager.new_dataset(
                batch_size=payload.batch_size,
                dataset_size=payload.dataset_size,
                dataset_name=payload.dataset_name,
                num_epochs=payload.num_epochs,
                shuffle=payload.shuffle,
                num_minibatches_per_shard=payload.num_minibatches_per_shard,
                storage_type=payload.storage_type,
                task_type=payload.task_type)
            if created:
                self._journal("dataset", {
                    "batch_size": payload.batch_size,
                    "dataset_size": payload.dataset_size,
                    "dataset_name": payload.dataset_name,
                    "num_epochs": payload.num_epochs,
                    "shuffle": payload.shuffle,
                    "num_minibatches_per_shard":
                        payload.num_minibatches_per_shard,
                    "storage_type": payload.storage_type,
                    "task_type": payload.task_type})
            return msg.OkResponse()

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
            self._journal("node", {
                "node_type": payload.node_type, "node_id": payload.node_id,
                "node_rank": payload.node_rank, "addr": payload.addr,
                "accelerator_type": payload.accelerator_type,
                "accelerator_num": payload.accelerator_num})
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
            m.task_manager.recover_tasks(payload.node_id)
            m.serve_queue.recover_node(payload.node_id)
            for rdzv in m.rdzv_managers.values():
                rdzv.remove_alive_node(payload.node_id)
            # journal the shard recovery (not the classification — error
            # history is advisory): a replayed master must not keep the
            # dead node's shards parked in `doing` forever
            self._journal("recover", {"node_id": payload.node_id})
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
            self._journal("kv_set", {"key": payload.key,
                                     "value": payload.value})
            return msg.OkResponse()

        if isinstance(payload, msg.ShardCheckpoint):
            ok = m.task_manager.restore_dataset_from_checkpoint(
                payload.content)
            if ok:
                self._journal("shard_ckpt", {"content": payload.content})
            return msg.OkResponse(success=ok)

        if isinstance(payload, (msg.ModelInfo, msg.CustomMetric)):
            m.collect_custom_data(payload)
            return msg.OkResponse()

        if isinstance(payload, msg.GoodputLedgerReport):
            # pure telemetry (cumulative snapshot, latest-wins)
            m.collect_goodput(payload)
            return msg.OkResponse()

        if isinstance(payload, msg.ServeSubmitRequest):
            accepted = m.serve_queue.submit(payload.requests)
            resp = msg.ServeSubmitAck(
                accepted=accepted,
                queue_depth=m.serve_queue.summary().queue_depth)
            # a submitted request must survive this master: the ack is
            # the client's permission to stop retrying, so the frame is
            # durable first, and a retry crossing a restart replays the
            # ack instead of double-enqueueing
            self._journal("serve_submit",
                          {"requests": list(payload.requests)},
                          idem=idem, resp=resp)
            return resp

        if isinstance(payload, msg.ServeResultReport):
            m.serve_queue.complete(payload.results)
            resp = msg.OkResponse()
            # results release leases and are what drain waits on — the
            # same durability bar as task_result
            self._journal("serve_result",
                          {"results": list(payload.results),
                           "node_id": node_id},
                          idem=idem, resp=resp)
            return resp

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
