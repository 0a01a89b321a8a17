"""Global tunables singleton.

Parity: dlrover_wuqiong_tpu/common/global_context.py, holding only the
fields the port reads, with the JAX defaults: the heartbeat interval and
timeout (master/job_manager.py), the relaunch policy (`relaunch_always`,
`max_relaunch_count`: job_manager.py, master/servicer.py), the speed
monitor's window (`train_speed_record_num`) and the rendezvous join
timeout (master/master.py), `master_outage_grace_s`
(agent/master_client.py), `checkpoint_replica`, the ring fan-out of
the agent's replica backup (agent/elastic_agent.py
`_setup_replication`, 0 = off), `journal_snapshot_every` (the master
journal's compaction cadence) and `hang_detection_seconds` (the run
loop's task-hang exit, master/master.py).  The JAX module's other fields come with the
modules that read them (ROADMAP items 13 and 15).  Values may be
overridden from env vars prefixed ``DWT_CTX_``, as there.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, fields


@dataclass
class Context:
    node_heartbeat_interval: float = 15.0
    node_heartbeat_timeout: float = 300.0
    relaunch_always: bool = False
    max_relaunch_count: int = 3
    train_speed_record_num: int = 50
    rdzv_join_timeout: float = 600.0
    # copies of each node's staged checkpoint held by ring successors
    # (checkpoint/replica.py); 0 keeps the replica ring off
    checkpoint_replica: int = 0
    # how long a MasterClient rides a master outage before giving up on a
    # critical verb (retry backoff caps at ~2s between attempts); the
    # fire-and-forget verbs buffer instead of waiting (master_client.py)
    master_outage_grace_s: float = 120.0
    # events between journal compactions (master/journal.py)
    journal_snapshot_every: int = 1000
    # every worker with a shard in flight silent this long: the master's
    # run loop exits with a hang (master/task_manager.py `task_hanged`)
    hang_detection_seconds: float = 1800.0

    _singleton = None
    _lock = threading.Lock()

    @classmethod
    def singleton_instance(cls) -> "Context":
        if cls._singleton is None:
            with cls._lock:
                if cls._singleton is None:
                    ctx = cls()
                    ctx._load_env()
                    cls._singleton = ctx
        return cls._singleton

    def _load_env(self):
        for f in fields(self):
            if f.name.startswith("_"):
                continue
            env_key = "DWT_CTX_" + f.name.upper()
            raw = os.getenv(env_key)
            if raw is None:
                continue
            if f.type in ("int", int):
                setattr(self, f.name, int(raw))
            elif f.type in ("float", float):
                setattr(self, f.name, float(raw))
            elif f.type in ("bool", bool):
                setattr(self, f.name, raw.lower() in ("1", "true", "yes"))
            else:
                setattr(self, f.name, raw)


def get_context() -> Context:
    return Context.singleton_instance()
