"""User-facing flash-checkpoint API.

Parity: dlrover_wuqiong_tpu/checkpoint/checkpointer.py:1-139 (the
reference's `trainer/torch/flash_checkpoint/checkpointer.py`): the same
`StorageType` and `FlashCheckpointer` methods.  The state is a tree of
tensors (a `TrainState`'s is ``state.tree()``); a restore writes into the
template's tensors in place (engine.py `restore_tree`), and a
`TrainState` or its tree restores through ``TrainState.load_tree``.
`replica_fetch`, `replica_manager`, `set_replica_count` and the
"replica" restore preference are JAX's (:41-61, :113-126): the middle
tier of the verified restore chain (checkpoint/replica.py).
"""

from __future__ import annotations

from enum import Enum
from typing import Any, Dict, Optional

from ..common.log import get_logger
from .engine import CheckpointEngine, restore_tree

logger = get_logger("checkpointer")


class StorageType(Enum):
    MEMORY = 0
    DISK = 1


class FlashCheckpointer:
    """Millisecond blocking saves of torch training state.

    Usage:
        ckpt = FlashCheckpointer("/ckpts/run1")
        ckpt.save_checkpoint(step, state.tree(),
                             storage_type=StorageType.DISK)
        ckpt.load_checkpoint(state.tree())   # into its tensors, in place
    """

    def __init__(self, checkpoint_dir: str, local_rank: int = 0,
                 job_name: str = "dwt", node_rank: int = 0,
                 local_shard_num: int = 1,
                 standalone: Optional[bool] = None,
                 wire_dtype: Optional[str] = None,
                 replica_fetch=None,
                 world_shard_num: Optional[int] = None):
        """`world_shard_num`: the shards of the whole world that a commit
        waits for (`CheckpointEngine`).

        `wire_dtype="bf16"` halves checkpoint bytes end to end (D2H
        staging, disk, restore H2D) by narrowing float32 leaves to bf16
        on the device; restore upcasts back on the device.  NOT bit-exact
        for float32 state (bf16/int leaves round-trip exactly) — for
        transfer-bound links where restore latency beats the last 16
        mantissa bits.

        `replica_fetch`: optional callable pulling this rank's staged
        segment from a peer replica holder into local shm (the engine
        tries it when the local segment fails verification — the middle
        tier of the verified restore chain)."""
        self.engine = CheckpointEngine(
            checkpoint_dir, local_rank=local_rank, job_name=job_name,
            node_rank=node_rank, local_shard_num=local_shard_num,
            standalone=standalone, wire_dtype=wire_dtype,
            replica_fetch=replica_fetch, world_shard_num=world_shard_num)
        self.checkpoint_dir = checkpoint_dir
        # optional CkptReplicaManager attachment so replica-count changes
        # have somewhere to land (the agent owns the ring; standalone
        # runs may attach their own)
        self.replica_manager = None

    @property
    def last_restore_report(self) -> Dict:
        """Which tier/generation served the last load, every fallback
        taken (with quarantine paths), and whether self-heal re-staged
        shm — {} before any load."""
        return self.engine.last_restore

    def save_checkpoint(self, step: int, state: Any,
                        storage_type: StorageType = StorageType.DISK,
                        path: Optional[str] = None,
                        extra_meta: Optional[Dict] = None) -> float:
        """Returns seconds training was blocked."""
        if storage_type == StorageType.MEMORY:
            return self.engine.save_to_memory(step, state, extra_meta)
        return self.engine.save_to_storage(step, state, path, extra_meta)

    def load_checkpoint(self, template: Any,
                        path: Optional[str] = None,
                        step: Optional[int] = None,
                        before_step: Optional[int] = None) -> Optional[Any]:
        """Restore into `template`'s tensors (in place, on their devices)
        and return it; None if there is no checkpoint.

        `before_step`: resume from the newest committed step strictly
        preceding it (loss-spike rollback — the tracker's latest commit can
        postdate spike onset).  Ignored when `step` is given explicitly.
        """
        if step is None and before_step is not None:
            prior = [s for s in self.engine.committed_steps(path)
                     if s < before_step]
            if not prior:
                logger.warning(
                    "rollback: no committed step precedes %d — "
                    "falling back to the latest checkpoint", before_step)
            else:
                step = prior[-1]
                logger.info("rollback: resuming from committed step %d "
                            "(< spike step %d)", step, before_step)
                # make the rollback durable: discard the post-spike
                # lineage so a crash BEFORE the rolled-back run commits
                # fresh cannot resume from a poisoned checkpoint
                self.engine.demote_steps_after(step, path)
        flat = self.engine.load(path, step)
        if flat is None:
            return None
        return restore_tree(template, flat)

    # ----------------------------------------------------------- restore route

    def set_preferred_tier(self, tier: str):
        """Restore-route hint: "" default verified chain,
        "shm"/"replica"/"storage" prefer that tier (the engine only ever
        SKIPS hot tiers — every tier stays digest-verified).  Effective
        on the next load."""
        if tier not in ("", "shm", "replica", "storage"):
            raise ValueError(f"unknown restore tier {tier!r}")
        if tier != self.engine.preferred_tier:
            logger.info("preferred restore tier -> %r", tier or "auto")
            self.engine.preferred_tier = tier

    def set_replica_count(self, count: int):
        """Forward a replica-count change to the attached ring manager
        (no-op without one); effective on the next backup."""
        if count >= 0 and self.replica_manager is not None:
            self.replica_manager.set_replica_count(count)

    def last_step(self) -> int:
        return self.engine.latest_step()

    def wait_staging(self, timeout: float = None):
        """Block until the in-flight async staging (if any) completes."""
        self.engine.wait_staging(timeout)

    def wait_latest_checkpoint(self, timeout: float = 600.0) -> bool:
        return self.engine.wait_saving_latest(timeout)

    def close(self):
        self.engine.close()
