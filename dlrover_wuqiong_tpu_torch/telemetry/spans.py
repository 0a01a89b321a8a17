"""Cross-process trace spans riding the typed JSON control-plane frames.

Parity: dlrover_wuqiong_tpu/telemetry/spans.py, kept in the port because
the port imports nothing of the JAX package: the same record schema,
`current_trace` / `inject` / `extract` for the frame envelope
(common/comm.py), `env_context` for a spawned child, the role from
``DWT_PROC_ROLE``, every span also recorded into the flight recorder
(recorder.py), so a worker's dump carries its request trees, and
`dump_chrome_trace`, the Chrome trace-event export the incident
timeline's Perfetto view writes through (telemetry/timeline.py).

Clocks: span *durations* are ``time.monotonic`` intervals; span *start
timestamps* are ``time.time`` so spans from different processes align on
one timeline (the one sanctioned cross-process use of wall clock).

Child processes spawned mid-span inherit the active context through
``DWT_TRACE_ID`` / ``DWT_TRACE_PARENT`` (see `env_context`); the spawned
side picks them up lazily on its first span.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
import uuid
from collections import deque
from typing import Dict, List, Optional

from .recorder import get_recorder

SPAN_SCHEMA_VERSION = 1

#: bounded process-local span buffer (drop-oldest)
_MAX_SPANS = 2048

_BUFFER: "deque[Dict]" = deque(maxlen=_MAX_SPANS)
_BUFFER_LOCK = threading.Lock()

_TLS = threading.local()

_ROLE = os.getenv("DWT_PROC_ROLE", "")


def _new_id() -> str:
    return uuid.uuid4().hex[:16]


def set_process_role(role: str):
    """Name this process in span/flight dumps (agent/master/saver/...)."""
    global _ROLE
    _ROLE = role


def process_role() -> str:
    return _ROLE or "proc"


def _stack() -> List[Dict]:
    stack = getattr(_TLS, "stack", None)
    if stack is None:
        stack = []
        # a spawned child joins the parent's trace lazily: the env
        # context seeds the root of this thread's stack once
        tid = os.getenv("DWT_TRACE_ID", "")
        if tid:
            stack.append({"trace_id": tid,
                          "span_id": os.getenv("DWT_TRACE_PARENT", "")})
        _TLS.stack = stack
    return stack


def current_trace() -> Optional[Dict[str, str]]:
    """Active {"trace_id", "span_id"} or None outside any span."""
    stack = _stack()
    if not stack:
        return None
    top = stack[-1]
    return {"trace_id": top["trace_id"], "span_id": top.get("span_id", "")}


def inject() -> Optional[Dict[str, str]]:
    """Trace fields for an outgoing frame envelope (None = untraced)."""
    return current_trace()


@contextlib.contextmanager
def extract(trace: Optional[Dict]):
    """Adopt an incoming frame's trace context for the handling scope."""
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
def env_context():
    """Env vars propagating the active context to a spawned child."""
    ctx = current_trace()
    env = {}
    if ctx:
        env["DWT_TRACE_ID"] = ctx["trace_id"]
        env["DWT_TRACE_PARENT"] = ctx["span_id"]
    yield env


def _record(rec: Dict):
    with _BUFFER_LOCK:
        _BUFFER.append(rec)
    # spans are flight-recorder events too: a fault dump carries the
    # recent trace tree without a separate flush path
    get_recorder().record("span", rec["name"], rec)


@contextlib.contextmanager
def span(name: str, attrs: Optional[Dict] = None):
    """Open a span; nests under the active one, propagates via frames."""
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
        _record(rec)


def span_event(name: str, attrs: Optional[Dict] = None):
    """Zero-duration span for point-in-time marks (world formed, ...)."""
    with span(name, attrs):
        pass


def spans_snapshot() -> List[Dict]:
    """Copy of the bounded buffer, oldest first."""
    with _BUFFER_LOCK:
        return list(_BUFFER)


def clear_spans():
    with _BUFFER_LOCK:
        _BUFFER.clear()


def dump_chrome_trace(path: str, extra_spans: Optional[List[Dict]] = None,
                      instant_events: Optional[List[Dict]] = None,
                      process_names: Optional[Dict[int, str]] = None,
                      include_buffer: bool = True):
    """Write the buffer (plus `extra_spans`, e.g. merged flight dumps) as
    Chrome trace-event JSON — load in chrome://tracing or Perfetto.

    Multi-process (add-only, telemetry/timeline.py export_perfetto):
    `process_names` emits one process_name metadata row per pid so each
    process gets a labelled track; `instant_events`
    (``{"name", "t_wall", "pid", "args"}``) become instant marks (journal
    frames, flight flushes); `include_buffer=False` exports ONLY the
    supplied events — a whole-incident export must not mix in whatever
    the exporting process's own span buffer happens to hold."""
    import json

    events = []
    for pid, pname in sorted((process_names or {}).items()):
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "tid": pid, "args": {"name": str(pname)}})
    for inst in instant_events or []:
        events.append({
            "name": inst.get("name", ""),
            "cat": "instant",
            "ph": "i", "s": "p",
            "ts": float(inst.get("t_wall", 0.0)) * 1e6,
            "pid": inst.get("pid", 0),
            "tid": inst.get("pid", 0),
            "args": dict(inst.get("args") or {}),
        })
    buffered = spans_snapshot() if include_buffer else []
    for rec in (extra_spans or []) + buffered:
        events.append({
            "name": rec["name"],
            "cat": rec.get("role", "proc"),
            "ph": "X",
            "ts": rec["t_wall"] * 1e6,
            "dur": max(rec.get("dur_s", 0.0), 0.0) * 1e6,
            "pid": rec.get("pid", 0),
            "tid": rec.get("pid", 0),
            "args": {
                "trace_id": rec.get("trace_id", ""),
                "span_id": rec.get("span_id", ""),
                "parent_span": rec.get("parent_span", ""),
                "status": rec.get("status", "ok"),
                **rec.get("attrs", {}),
            },
        })
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump({"traceEvents": events}, f)
    os.replace(tmp, path)
    return len(events)
