"""Worker-process side of elastic training: the world from the agent's env.

Parity: dlrover_wuqiong_tpu/trainer/elastic.py — `WorldInfo`,
`get_world_info`, `ElasticContext` with `report_step`, `init_elastic`,
`reset_elastic_context` and `GradientAccumulator`, with the same env
contract (common/constants.py `NodeEnv`).

Where the JAX worker calls ``jax.distributed.initialize`` (:190-200),
`init_elastic` forms a ``torch.distributed`` group from the rendezvous:
``init_method="tcp://<DWT_COORDINATOR_ADDR>"`` (rank 0's ip and the free
port its agent reserved), ``rank=process_id``,
``world_size=num_processes``, NCCL for a CUDA device and gloo for the
CPU — and, as JAX does, only when the world has more than one process.
Not here, each with its ROADMAP item: the persistent compile cache
(:189) and `enable_warm_restarts` (:114-171), item 13 (the port's
counterpart is a pre-built CUDA-graph artifact); `report_loss` and
`report_op_profile`, which feed the master's diagnosis (:80-103), and
`sharding_client` (:105-112), item 15.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Optional

from ..agent.master_client import MasterClient
from ..common.constants import NodeEnv
from ..common.log import get_logger

logger = get_logger("elastic_trainer")


@dataclass
class WorldInfo:
    process_id: int = 0
    num_processes: int = 1
    coordinator_addr: str = ""
    node_id: int = 0
    node_rank: int = 0
    restart_count: int = 0


def get_world_info() -> WorldInfo:
    return WorldInfo(
        process_id=int(os.getenv(NodeEnv.PROCESS_ID, "0")),
        num_processes=int(os.getenv(NodeEnv.NUM_PROCESSES, "1")),
        coordinator_addr=os.getenv(NodeEnv.COORDINATOR_ADDR, ""),
        node_id=int(os.getenv(NodeEnv.NODE_ID, "0")),
        node_rank=int(os.getenv(NodeEnv.NODE_RANK, "0")),
        restart_count=int(os.getenv(NodeEnv.RESTART_COUNT, "0")),
    )


class ElasticContext:
    """Per-worker handle to the elastic world + master services."""

    def __init__(self, world: WorldInfo,
                 master_client: Optional[MasterClient]):
        self.world = world
        self.mc = master_client
        self._step_report_interval = 15.0
        self._last_report = 0.0

    @property
    def is_distributed(self) -> bool:
        return self.world.num_processes > 1

    @property
    def process_id(self) -> int:
        return self.world.process_id

    def report_step(self, step: int, force: bool = False):
        """Throttled global-step reporting feeding the SpeedMonitor."""
        if self.mc is None:
            return
        now = time.monotonic()
        if force or self._last_report == 0.0 or \
                now - self._last_report > self._step_report_interval:
            try:
                self.mc.report_global_step(step)
                self._last_report = now
            except Exception:  # noqa: BLE001
                logger.debug("step report failed", exc_info=True)

    def sharding_client(self, dataset_name: str, batch_size: int,
                        dataset_size: int, **kwargs):
        from ..agent.sharding_client import IndexShardingClient

        if self.mc is None:
            return None
        return IndexShardingClient(self.mc, dataset_name, batch_size,
                                   dataset_size, **kwargs)


_context: Optional[ElasticContext] = None


def init_elastic(connect_master: bool = True,
                 backend: Optional[str] = None) -> ElasticContext:
    """Join the world the agent's env describes; returns the context.

    Call once at the top of the training script.  With more than one
    process it forms the ``torch.distributed`` default group (`backend`:
    None means NCCL where CUDA is present, else gloo); with one it forms
    none.
    """
    global _context
    if _context is not None:
        return _context
    world = get_world_info()
    if world.num_processes > 1 and world.coordinator_addr:
        import torch
        import torch.distributed as dist

        if backend is None:
            backend = "nccl" if torch.cuda.is_available() else "gloo"
        logger.info("torch.distributed.init_process_group(%s, "
                    "tcp://%s, world_size=%d, rank=%d)", backend,
                    world.coordinator_addr, world.num_processes,
                    world.process_id)
        dist.init_process_group(
            backend, init_method=f"tcp://{world.coordinator_addr}",
            world_size=world.num_processes, rank=world.process_id)
    mc = None
    master_addr = os.getenv(NodeEnv.MASTER_ADDR, "")
    if connect_master and master_addr:
        mc = MasterClient(master_addr, world.node_id)
    _context = ElasticContext(world, mc)
    return _context


def reset_elastic_context():
    global _context
    if _context is not None and _context.mc is not None:
        _context.mc.close()
    if _context is not None and _context.is_distributed:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
    _context = None


class GradientAccumulator:
    """Keep the global batch fixed as world size changes.

    Parity: dlrover_wuqiong_tpu/trainer/elastic.py:219-238 (reference
    ElasticTrainer/GradientState): with `global_batch_size` fixed, each
    process accumulates ``global_batch_size / (num_processes *
    per_step_batch)`` micro-steps before applying the update
    (trainer/train_step.py `accumulate_grads`).
    """

    def __init__(self, global_batch_size: int, micro_batch_size: int,
                 num_processes: int):
        denom = micro_batch_size * max(1, num_processes)
        self.accum_steps = max(1, global_batch_size // denom)
        self.global_batch_size = global_batch_size
        self.micro_batch_size = micro_batch_size

    def __repr__(self):
        return (f"GradientAccumulator(accum={self.accum_steps}, "
                f"global={self.global_batch_size})")
