"""``python -m dlrover_wuqiong_tpu_torch.master`` — standalone master process.

Parity: dlrover_wuqiong_tpu/master/__main__.py, with its flags.  With
``--journal-dir`` the master journals every control-plane mutation
(master/journal.py); a replacement process started on the same directory
replays the state, bumps the fencing epoch, and the workers ride through
(`chaos.master_kill` is the drill).  The process imports no ``torch``
(the package's ``__init__`` defers it), so a restart pays the
interpreter and the journal's replay, not torch's import.

Left out, each raising with the ROADMAP item that brings it:
``--policy`` and ``--policy-prior`` (the adaptive policy engine, item
15), ``--standby-of``, ``--peer`` and ``--lease-ttl`` (warm standby and
fenced failover, item 7b).
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from .master import run_master_forever

#: the JAX master's flags this one does not take, with their items
UNPORTED_FLAGS = {"policy": "15", "policy_prior": "15", "standby_of": "7b",
                  "peer": "7b", "lease_ttl": "7b"}


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m dlrover_wuqiong_tpu_torch.master",
        description="standalone elastic-training job master")
    p.add_argument("--port", type=int, default=0,
                   help="RPC port (0 picks a free one)")
    p.add_argument("--min_nodes", type=int, default=1)
    p.add_argument("--max_nodes", type=int, default=1)
    p.add_argument("--node_unit", type=int, default=1)
    p.add_argument("--journal-dir", default="",
                   help="enable the control-plane journal here; a restarted "
                        "master on the same dir replays it")
    p.add_argument("--poll-interval", type=float, default=5.0)
    p.add_argument("--max-seconds", type=float, default=None,
                   help="abort the job after this much wall clock")
    p.add_argument("--group-commit-max-frames", type=int, default=None,
                   help="journal group-commit batch cap (1 = per-frame "
                        "fsync; default from DWT_JOURNAL_GROUP_MAX_FRAMES "
                        "/ DWT_JOURNAL_GROUP_COMMIT=0, else 256)")
    p.add_argument("--group-commit-max-wait-ms", type=float, default=None,
                   help="batch leader linger before fsync (default from "
                        "DWT_JOURNAL_GROUP_MAX_WAIT_MS, else 0: a single "
                        "writer pays no extra latency)")
    p.add_argument("--policy", action="store_true",
                   help="not ported (ROADMAP item 15)")
    p.add_argument("--policy-prior", default="",
                   help="not ported (ROADMAP item 15)")
    p.add_argument("--standby-of", default="",
                   help="not ported (ROADMAP item 7b)")
    p.add_argument("--peer", default="", help="not ported (ROADMAP item 7b)")
    p.add_argument("--lease-ttl", type=float, default=0.0,
                   help="not ported (ROADMAP item 7b)")
    args = p.parse_args(argv)
    given = [name for name in UNPORTED_FLAGS if getattr(args, name)]
    if given:
        raise ValueError(
            "the port's master does not take "
            + ", ".join(f"--{n.replace('_', '-')} (ROADMAP item "
                        f"{UNPORTED_FLAGS[n]})" for n in given))
    return run_master_forever(
        args.port, args.min_nodes, args.max_nodes, node_unit=args.node_unit,
        journal_dir=args.journal_dir or None,
        poll_interval=args.poll_interval, max_seconds=args.max_seconds,
        group_commit_max_frames=args.group_commit_max_frames,
        group_commit_max_wait_ms=args.group_commit_max_wait_ms)


if __name__ == "__main__":
    sys.exit(main())
