"""Wire messages between the serving worker, its clients and the master.

Parity: dlrover_wuqiong_tpu/common/messages.py — `OkResponse` (:25),
`NodeMeta` (:155), `NodeFailure` (:194) and every ``Serve*`` record
(:561-686), copied with the same names, fields, defaults and order, and
registered under the same names by ``@message``, so the port's frames are
byte-equal to the JAX package's (`analysis/schema.lock.json` pins the
JAX side; tests/test_torch_serving_worker.py holds the two equal).  The
other messages come with the verbs that carry them (ROADMAP items 6a, 7a
and 15).
"""

from __future__ import annotations

from dataclasses import field
from typing import Dict, List

from .serialize import message


@message
class OkResponse:
    success: bool = True
    reason: str = ""


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
class NodeFailure:
    node_id: int = -1
    restart_count: int = 0
    error_data: str = ""
    level: str = "process"


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
