"""Wire messages between agents, workers, clients and the master.

Parity: dlrover_wuqiong_tpu/common/messages.py — `OkResponse` (:25),
the dataset-sharding records (:34-90, but `DatasetTaskEnd`, which no
verb of the port carries), the rendezvous records (:90-126), `NodeMeta` (:155), `HeartBeat` and its
reply (:166-181), `NodeEventReport` (:184), `NodeFailure` (:194),
`GlobalStep` (:205), `ModelInfo` and `CustomMetric` (:220-230), the
goodput ledger's records (:234-268), `JournalStatsQuery` and
`JournalStats` (:307-344), the ``KVStore*`` records
(:383-409) and every ``Serve*`` record (:561-686), copied with the same
names, fields, defaults and order, and registered under the same names
by ``@message``, so the port's frames are byte-equal to the JAX
package's (`analysis/schema.lock.json` pins the JAX side;
tests/test_torch_serving_worker.py and tests/test_torch_elastic.py hold
the two equal; tests/test_torch_master_restart.py the sharding and
journal records).  The other messages come with the verbs that carry
them (ROADMAP items 7b, 13 and 15).
"""

from __future__ import annotations

from dataclasses import field
from typing import Dict, List

from .serialize import message


@message
class OkResponse:
    success: bool = True
    reason: str = ""


# ---------------------------------------------------------------- dataset / sharding


@message
class DatasetShardParams:
    batch_size: int = 0
    num_epochs: int = 1
    dataset_size: int = 0
    shuffle: bool = False
    num_minibatches_per_shard: int = 2
    dataset_name: str = ""
    task_type: str = "training"
    storage_type: str = ""


@message
class ShardConfig:
    start: int = 0
    end: int = 0
    indices: List[int] = field(default_factory=list)


@message
class TaskRequest:
    dataset_name: str = ""


@message
class Task:
    task_id: int = -1
    task_type: str = "none"
    shard: ShardConfig = field(default_factory=ShardConfig)
    dataset_name: str = ""


@message
class TaskResult:
    dataset_name: str = ""
    task_id: int = -1
    err_message: str = ""


@message
class ShardCheckpointRequest:
    dataset_name: str = ""


@message
class ShardCheckpoint:
    content: str = ""  # JSON state of the dataset splitter / task queues


# ---------------------------------------------------------------- rendezvous


@message
class JoinRendezvousRequest:
    node_id: int = -1
    node_rank: int = -1
    local_world_size: int = 1  # local accelerator/process count
    rdzv_name: str = ""
    node_ip: str = ""
    free_port: int = 0
    slice_id: str = ""  # locality hint (DWT_SLICE_ID)


@message
class CommWorldRequest:
    node_id: int = -1
    rdzv_name: str = ""


@message
class RendezvousState:
    rdzv_round: int = 0
    group: int = 0
    # node_rank -> (node_id, local_world_size, node_ip, free_port)
    world: Dict[str, List] = field(default_factory=dict)
    coordinator_addr: str = ""
    complete: bool = False


@message
class WaitingNodeNumRequest:
    node_id: int = -1
    rdzv_name: str = ""


@message
class WaitingNodeNumResponse:
    waiting_num: int = 0


# ---------------------------------------------------------------- node lifecycle


@message
class NodeMeta:
    node_type: str = "worker"
    node_id: int = -1
    node_rank: int = -1
    addr: str = ""
    cpu: float = 0.0
    memory_mb: float = 0.0
    accelerator_type: str = ""
    accelerator_num: int = 0


@message
class HeartBeat:
    node_id: int = -1
    timestamp: float = 0.0
    # piggyback diagnosis payloads (step progress, resource usage)
    global_step: int = 0
    resource: Dict[str, float] = field(default_factory=dict)


@message
class HeartbeatResponse:
    action: str = ""  # "", "restart", "stop"
    # for action="restart" fired by a loss-spike rollback: resume from the
    # newest committed checkpoint whose step PRECEDES this (-1 = latest)
    rollback_before_step: int = -1


@message
class NodeEventReport:
    node_id: int = -1
    node_type: str = "worker"
    event_type: str = ""
    reason: str = ""
    message: str = ""
    level: str = "info"


@message
class NodeFailure:
    node_id: int = -1
    restart_count: int = 0
    error_data: str = ""
    level: str = "process"


@message
class GlobalStep:
    step: int = 0
    timestamp: float = 0.0
    elapsed_time_per_step: float = 0.0


@message
class ModelInfo:
    num_params: int = 0
    num_layers: int = 0
    hidden_size: int = 0
    seq_len: int = 0
    flops_per_step: float = 0.0


@message
class CustomMetric:
    data: Dict[str, float] = field(default_factory=dict)


@message
class GoodputLedgerReport:
    """Cumulative per-node goodput ledger snapshot (telemetry/ledger.py).

    Totals are cumulative since trainer start, so the report is drop- and
    replay-safe over the BUFFERED verb class: the master keeps the latest
    snapshot per node and sums across nodes.  ``states`` keys come from
    ``LEDGER_STATES`` (add-only schema).
    """

    node_id: int = -1
    wall_s: float = 0.0
    states: Dict[str, float] = field(default_factory=dict)
    other_s: float = 0.0
    goodput_fraction: float = 0.0
    # send-time wall-clock stamp (cross-process — time.time()): the
    # degraded-mode buffer drains AFTER the frame that reconnected, so
    # without it a stale buffered snapshot would overwrite the fresh one
    # on the new master (latest-SENT must win, not latest-arrived)
    sent_at: float = 0.0


@message
class GoodputQuery:
    """Pull the job-level ledger aggregation."""

    pass


@message
class GoodputSummary:
    states: Dict[str, float] = field(default_factory=dict)
    wall_s: float = 0.0
    other_s: float = 0.0
    goodput_fraction: float = 0.0
    nodes: int = 0


# ---------------------------------------------------------------- journal


@message
class JournalStatsQuery:
    """Pull the master's journal group-commit gauges (read-only, never
    journaled — the fleet bench and perf_probe poll it)."""

    pass


@message
class JournalStats:
    """Group-commit gauges for the master journal (master/journal.py).

    ``enabled`` is False on journal-less masters (standalone/test);
    ``group_commit`` is False when max_frames=1 (the per-frame-fsync
    baseline).  batch_mean/batch_max describe frames-per-fsync since
    the master started — the fleet bench's amortization evidence.
    """

    enabled: bool = False
    group_commit: bool = False
    max_frames: int = 0
    max_wait_ms: float = 0.0
    fsync_floor_ms: float = 0.0
    batches: int = 0
    frames: int = 0
    batch_mean: float = 0.0
    batch_max: int = 0
    durable_seq: int = 0
    epoch: int = 0
    # ADD-ONLY standby/failover gauges: shipped_seq is the
    # highest seq a standby holds or was served; standby_lag_frames is
    # durable_seq - shipped_seq (-1 = no standby ever fetched);
    # lease_epoch is the highest leadership-lease epoch this master has
    # journaled or observed — a revived primary compares it against its
    # own loaded epoch to self-fence instead of split-braining.
    shipped_seq: int = 0
    standby_lag_frames: int = -1
    lease_epoch: int = 0
    is_leader: bool = True


# ---------------------------------------------------------------- kv store


@message
class KVStoreSetRequest:
    key: str = ""
    value: bytes = b""


@message
class KVStoreGetRequest:
    key: str = ""


@message
class KVStoreMultiGetRequest:
    keys: List[str] = field(default_factory=list)


@message
class KVStoreAddRequest:
    key: str = ""
    amount: int = 1


@message
class KVStoreResponse:
    found: bool = False
    value: bytes = b""
    values: List[bytes] = field(default_factory=list)
    num: int = 0


# ---------------------------------------------------------------- serving


@message
class ServeRequest:
    """One inference request (serving/).  ADD-ONLY schema, pinned by
    tests/test_serving.py.

    ``prompt`` is the token-id list (the control plane carries ids, not
    text — tokenization is a client concern).  ``seed`` feeds the
    per-request PRNG key, which makes sampled tokens independent of the
    batch the request happens to share slots with (the continuous-
    batching equivalence invariant).  ``submitted_at`` is a cross-process
    wall-clock stamp.
    """

    request_id: str = ""
    prompt: List[int] = field(default_factory=list)
    max_new_tokens: int = 16
    temperature: float = 1.0
    seed: int = 0
    deadline_s: float = 0.0      # 0 = no deadline
    submitted_at: float = 0.0


@message
class ServeSubmitRequest:
    """Client → master: enqueue requests (journaled + idem)."""

    node_id: int = -1
    requests: List[ServeRequest] = field(default_factory=list)


@message
class ServeSubmitAck:
    accepted: int = 0
    queue_depth: int = 0


@message
class ServeLeaseRequest:
    """Decode worker → master: lease up to ``max_requests`` pending
    requests (journaled + idem — a lease moves queue state, and replay
    must re-assign the same requests to the same worker)."""

    node_id: int = -1
    max_requests: int = 1


@message
class ServeLease:
    requests: List[ServeRequest] = field(default_factory=list)


@message
class ServeResult:
    """Completed request: generated token ids (prompt excluded)."""

    request_id: str = ""
    tokens: List[int] = field(default_factory=list)
    finish_reason: str = "length"  # "length" | "deadline" | "error"
    latency_s: float = 0.0
    ttft_s: float = 0.0


@message
class ServeResultReport:
    """Worker → master: durable result hand-off (journaled + idem)."""

    node_id: int = -1
    results: List[ServeResult] = field(default_factory=list)


@message
class ServeResultQuery:
    """Client → master: poll for finished results (removes returned
    entries — but the poll itself is idempotent per request_id set)."""

    request_ids: List[str] = field(default_factory=list)


@message
class ServeResultResponse:
    results: List[ServeResult] = field(default_factory=list)
    pending: int = 0


@message
class ServeStatsReport:
    """Cumulative per-worker serving ledger snapshot (BUFFERED, like
    GoodputLedgerReport: latest-SENT-wins per node via ``sent_at``)."""

    node_id: int = -1
    wall_s: float = 0.0
    states: Dict[str, float] = field(default_factory=dict)
    counters: Dict[str, int] = field(default_factory=dict)
    active_slots: int = 0
    p50_ms: float = 0.0
    p99_ms: float = 0.0
    ttft_p50_ms: float = 0.0
    ttft_p99_ms: float = 0.0
    sent_at: float = 0.0


@message
class ServeStatsQuery:
    """Pull the job-level serving summary (tools/serve_report.py)."""

    pass


@message
class ServeSummary:
    queue_depth: int = 0
    leased: int = 0
    done: int = 0
    submitted_total: int = 0
    requeued_total: int = 0
    done_total: int = 0
    workers: int = 0
    active_slots: int = 0
    counters: Dict[str, int] = field(default_factory=dict)
    states: Dict[str, float] = field(default_factory=dict)
    p50_ms: float = 0.0
    p99_ms: float = 0.0
    ttft_p50_ms: float = 0.0
    ttft_p99_ms: float = 0.0
    rps: float = 0.0
