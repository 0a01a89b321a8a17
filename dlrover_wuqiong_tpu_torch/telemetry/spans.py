"""Trace spans in a bounded in-memory buffer.

Parity: the subset of dlrover_wuqiong_tpu/telemetry/spans.py that the
serving scheduler uses — `extract` (:95), `span_event` (:159),
`spans_snapshot` (:165), `clear_spans` (:171), `set_process_role` (:56) —
with the same record schema.  The flight-recorder flush, the frame
injection and the child-process environment hand-off come with the
serving worker, which is not ported yet.

Clocks: span durations are ``time.monotonic`` intervals; span start stamps
are ``time.time`` so spans of different processes share one timeline.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
import uuid
from collections import deque
from typing import Dict, List, Optional

SPAN_SCHEMA_VERSION = 1

#: bounded process-local span buffer (drop-oldest)
_MAX_SPANS = 2048

_BUFFER: "deque[Dict]" = deque(maxlen=_MAX_SPANS)
_BUFFER_LOCK = threading.Lock()

_TLS = threading.local()

_ROLE = ""


def _new_id() -> str:
    return uuid.uuid4().hex[:16]


def set_process_role(role: str):
    """Name this process in span records (serve-worker, ...)."""
    global _ROLE
    _ROLE = role


def process_role() -> str:
    return _ROLE or "proc"


def _stack() -> List[Dict]:
    stack = getattr(_TLS, "stack", None)
    if stack is None:
        stack = []
        _TLS.stack = stack
    return stack


@contextlib.contextmanager
def extract(trace: Optional[Dict]):
    """Adopt a trace context ({"trace_id", "span_id"}) for the scope."""
    if not trace or not trace.get("trace_id"):
        yield
        return
    stack = _stack()
    stack.append({"trace_id": str(trace["trace_id"]),
                  "span_id": str(trace.get("span_id", ""))})
    try:
        yield
    finally:
        stack.pop()


@contextlib.contextmanager
def span(name: str, attrs: Optional[Dict] = None):
    """Open a span; nests under the active one."""
    stack = _stack()
    parent = stack[-1] if stack else None
    rec = {
        "schema": SPAN_SCHEMA_VERSION,
        "name": name,
        "trace_id": parent["trace_id"] if parent else _new_id(),
        "span_id": _new_id(),
        "parent_span": parent.get("span_id", "") if parent else "",
        "role": process_role(),
        "pid": os.getpid(),
        "t_wall": time.time(),
        "dur_s": 0.0,
        "attrs": dict(attrs or {}),
        "status": "ok",
    }
    stack.append({"trace_id": rec["trace_id"], "span_id": rec["span_id"]})
    t0 = time.monotonic()
    try:
        yield rec
    except BaseException:
        rec["status"] = "error"
        raise
    finally:
        rec["dur_s"] = time.monotonic() - t0
        stack.pop()
        with _BUFFER_LOCK:
            _BUFFER.append(rec)


def span_event(name: str, attrs: Optional[Dict] = None):
    """Zero-duration span for a point-in-time mark."""
    with span(name, attrs):
        pass


def spans_snapshot() -> List[Dict]:
    """Copy of the bounded buffer, oldest first."""
    with _BUFFER_LOCK:
        return list(_BUFFER)


def clear_spans():
    with _BUFFER_LOCK:
        _BUFFER.clear()
