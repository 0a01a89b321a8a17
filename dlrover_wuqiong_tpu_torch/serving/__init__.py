"""Continuous-batching inference: slot KV ring, admit / decode windows,
and the master-backed decode worker.

Parity: dlrover_wuqiong_tpu/serving/__init__.py.  `ServingWorker`
(serving/worker.py) leases requests from a master over the framed-TCP
control plane; ``python -m dlrover_wuqiong_tpu_torch.serving`` runs one
(serving/__main__.py).
"""

from .engine import ServeSpec, ServingEngine  # noqa: F401
from .scheduler import LocalServer, SlotScheduler, request_trace_id  # noqa: F401
from .worker import ServingWorker  # noqa: F401
