"""Checkpoint constants and the environment names the checkpoint engine reads.

Parity: dlrover_wuqiong_tpu/common/constants.py — `CheckpointConstant`
(:128-137) whole, and of `NodeEnv` (:4-26) the names the checkpoint
engine reads (`JOB_NAME`, `MASTER_ADDR`, `NODE_RANK`: engine.py:116-118
and the job naming around it).  The other classes there come with the
modules that read them.
"""

from __future__ import annotations


class NodeEnv:
    """Environment variables that wire agents/workers to the master."""

    JOB_NAME = "DWT_JOB_NAME"
    MASTER_ADDR = "DWT_MASTER_ADDR"  # host:port of the job master RPC service
    NODE_RANK = "DWT_NODE_RANK"


class CheckpointConstant:
    CKPT_NAME_PREFIX = "checkpoint-"
    TRACKER_FILE = "latest_checkpointed_iteration.txt"
    MODEL_STATES_NAME = "model_states"
    OPTIM_STATES_NAME = "optim_states"
    DONE_DIR = ".done"
    # written inside a step dir when the tracker publishes it — the durable
    # "all shards landed" witness (done-files alone can be a partial set)
    COMMIT_MARKER = ".commit"
    SAVE_TIMEOUT = 600
