"""Continuous-batching inference: slot KV ring, admit / decode windows.

Parity: dlrover_wuqiong_tpu/serving/__init__.py.  The master-backed
serving worker (serving/worker.py, serving/__main__.py) is not ported yet.
"""

from .engine import ServeSpec, ServingEngine  # noqa: F401
from .scheduler import LocalServer, SlotScheduler, request_trace_id  # noqa: F401
