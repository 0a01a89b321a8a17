"""Global tunables singleton.

Parity: dlrover_wuqiong_tpu/common/global_context.py, holding only the
fields the port reads so far (`master_outage_grace_s`, which
`MasterClient` reads).  The JAX module's other fields come with the
modules that read them.  Values may be overridden from env vars prefixed
``DWT_CTX_``, as there.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, fields


@dataclass
class Context:
    # how long a MasterClient rides a master outage before giving up on a
    # critical verb (retry backoff caps at ~2s between attempts); the
    # fire-and-forget verbs buffer instead of waiting (master_client.py)
    master_outage_grace_s: float = 120.0

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
