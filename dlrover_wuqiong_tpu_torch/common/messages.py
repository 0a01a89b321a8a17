"""Serving request and result records.

Parity: dlrover_wuqiong_tpu/common/messages.py:561-620 (`ServeRequest`,
`ServeResult`), as plain dataclasses with the same fields and defaults.
The ``@message`` registry and the wire protocol come with the serving
worker, which is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List


@dataclass
class ServeRequest:
    """One inference request.  ``prompt`` holds token ids; ``seed`` keys the
    request's sampling noise, so its tokens do not depend on the batch it
    shares; ``submitted_at`` is a wall-clock stamp."""

    request_id: str = ""
    prompt: List[int] = field(default_factory=list)
    max_new_tokens: int = 16
    temperature: float = 1.0
    seed: int = 0
    deadline_s: float = 0.0      # 0 = no deadline
    submitted_at: float = 0.0


@dataclass
class ServeResult:
    """Completed request: generated token ids (prompt excluded)."""

    request_id: str = ""
    tokens: List[int] = field(default_factory=list)
    finish_reason: str = "length"  # "length" | "deadline" | "error"
    latency_s: float = 0.0
    ttft_s: float = 0.0
