"""Constants and the environment names that wire agents, workers and the master.

Parity: dlrover_wuqiong_tpu/common/constants.py — `NodeEnv` (:13-35) but
`PARAL_CONFIG_PATH` (the config tuner's file, ROADMAP item 15) and
`COMPILE_CACHE_DIR` (the warm pool's cache, item 13); `NodeType`,
`NodeStatus`, `NodeEventType`, `NodeExitReason`, `JobExitReason`,
`RendezvousName`, `NetworkFailureReason`, `TaskType` (the dataset
sharding's, master/task_manager.py) and `CheckpointConstant` (:37-148)
whole; and `JobConstant` (:150-162).  The other classes there
(`TrainingExceptionLevel`, `PlatformType`, `DistributionStrategy`,
`ConfigPath`) come with the modules that read them.

The world contract keeps the JAX package's names: a port worker reads
``DWT_COORDINATOR_ADDR`` as the ``tcp://`` address of its
``torch.distributed`` group (trainer/elastic.py), where a JAX worker
reads it as the ``jax.distributed`` coordinator.
"""

from __future__ import annotations

import os


class NodeEnv:
    """Environment variables that wire agents/workers to the master."""

    JOB_NAME = "DWT_JOB_NAME"
    MASTER_ADDR = "DWT_MASTER_ADDR"  # host:port of the job master RPC service
    NODE_ID = "DWT_NODE_ID"
    NODE_RANK = "DWT_NODE_RANK"
    NODE_NUM = "DWT_NODE_NUM"
    # world contract (filled by the agent after rendezvous)
    COORDINATOR_ADDR = "DWT_COORDINATOR_ADDR"
    PROCESS_ID = "DWT_PROCESS_ID"
    NUM_PROCESSES = "DWT_NUM_PROCESSES"
    LOCAL_DEVICE_COUNT = "DWT_LOCAL_DEVICE_COUNT"
    # Restart bookkeeping
    RESTART_COUNT = "DWT_RESTART_COUNT"
    # loss-spike rollback: resume from the newest committed ckpt whose
    # step precedes this value (set one-shot by the agent on relaunch)
    ROLLBACK_BEFORE_STEP = "DWT_ROLLBACK_BEFORE_STEP"


class NodeType:
    MASTER = "master"
    WORKER = "worker"
    PS = "ps"  # kept for sparse-embedding (parameter-service) jobs
    EVALUATOR = "evaluator"


class NodeStatus:
    """Lifecycle states of a node (pod/process)."""

    INITIAL = "Initial"
    PENDING = "Pending"
    RUNNING = "Running"
    SUCCEEDED = "Succeeded"
    FAILED = "Failed"
    DELETED = "Deleted"
    UNKNOWN = "Unknown"
    BREAKDOWN = "Breakdown"  # failed hardware health-check

    @classmethod
    def terminal(cls) -> set:
        return {cls.SUCCEEDED, cls.FAILED, cls.DELETED}


class NodeEventType:
    ADDED = "ADDED"
    MODIFIED = "MODIFIED"
    DELETED = "DELETED"


class NodeExitReason:
    SUCCEEDED = "Succeeded"
    KILLED = "Killed"  # e.g. preemption / eviction — relaunchable
    OOM = "OOM"
    FATAL_ERROR = "FatalError"  # user-code error — not relaunchable
    HARDWARE_ERROR = "HardwareError"  # device/link failure — new node
    HANG = "Hang"
    UNKNOWN_ERROR = "UnknownError"

    RELAUNCHABLE = {KILLED, OOM, HARDWARE_ERROR, HANG, UNKNOWN_ERROR}
    KNOWN = {SUCCEEDED, KILLED, OOM, FATAL_ERROR, HARDWARE_ERROR, HANG,
             UNKNOWN_ERROR}


class JobExitReason:
    SUCCEEDED = "Succeeded"
    CODE_ERROR = "CodeError"
    WORKER_ERROR = "WorkerError"
    UNCOMPLETED_TIMEOUT = "UncompletedTimeout"
    HANG_ERROR = "HangError"
    UNKNOWN_ERROR = "UnknownError"


class RendezvousName:
    ELASTIC_TRAINING = "elastic-training"
    NETWORK_CHECK = "network-check"


class NetworkFailureReason:
    NO_INIT = "Not initialized"
    NODE_FAILURE = "Node failure"
    WAITING_NODE = "Waiting node"


class TaskType:
    """Dynamic-sharding task types. Parity: reference elastic_training.proto TaskType."""

    NONE = "none"
    TRAINING = "training"
    EVALUATION = "evaluation"
    PREDICTION = "prediction"
    WAIT = "wait"
    TRAIN_END_CALLBACK = "train_end_callback"


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


class JobConstant:
    RDZV_JOIN_TIMEOUT_DEFAULT = 600
    HEARTBEAT_INTERVAL_SECS = float(
        os.getenv("DWT_HEARTBEAT_INTERVAL_SECS", "15"))
    HEARTBEAT_TIMEOUT_SECS = 300
    MASTER_SERVICE_DEFAULT_PORT = 0  # 0 → pick a free port
    TRAINING_AGENT_LOOP_INTERVAL = 1
    NODE_CHECK_TIMEOUT_SECS = 300
    PENDING_NODE_TIMEOUT_SECS = 900
    # Min interval between two membership-driven restarts (env-overridable:
    # elasticity e2e tests need tighter loops than production)
    RESTART_DEBOUNCE_SECS = float(
        os.getenv("DWT_RESTART_DEBOUNCE_SECS", "30"))
