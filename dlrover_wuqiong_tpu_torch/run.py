"""`dwt-run` for the port: the elastic launcher CLI.

Parity: dlrover_wuqiong_tpu/run.py:1-113, with the same flags: start an
in-process port `JobMaster` when ``--standalone`` is given or no
``DWT_MASTER_ADDR`` is set (else dial that master), then run the elastic
agent supervising the training script until it succeeds, a restart
cannot fix its failure, or ``--max_restarts`` are spent.  The exit code
is the agent's.  ``--network-check`` raises until the node check is
ported (ROADMAP queue 1 item 13).

Usage:
    python -m dlrover_wuqiong_tpu_torch.run --standalone \\
        --nproc_per_node=1 --max_restarts=3 train.py [args...]
    DWT_MASTER_ADDR=host:port DWT_NODE_ID=1 DWT_NODE_RANK=1 \\
        python -m dlrover_wuqiong_tpu_torch.run --nnodes=2 train.py
"""

from __future__ import annotations

import argparse
import os
import sys
import threading
from typing import List, Optional, Tuple

from .agent.elastic_agent import ElasticLaunchConfig, launch_agent
from .common.comm import addr_connectable
from .common.constants import NodeEnv
from .common.log import get_logger
from .master.master import JobMaster

logger = get_logger("run")


def parse_nnodes(value: str) -> Tuple[int, int]:
    if ":" in value:
        lo, hi = value.split(":")
        return int(lo), int(hi)
    n = int(value)
    return n, n


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser("dwt-run",
                                description="elastic training launcher")
    p.add_argument("--nnodes", default="1",
                   help="N or MIN:MAX elastic node range")
    p.add_argument("--nproc_per_node", type=int,
                   default=int(os.getenv(NodeEnv.LOCAL_DEVICE_COUNT, "1")))
    p.add_argument("--standalone", action="store_true",
                   help="run a local in-process master")
    p.add_argument("--max_restarts", type=int, default=3)
    p.add_argument("--network-check", action="store_true",
                   dest="network_check")
    p.add_argument("--node_unit", type=int, default=1)
    p.add_argument("--rdzv_timeout", type=float, default=600.0)
    p.add_argument("--log_dir", default="")
    p.add_argument("training_script", help="script to run")
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def _launch_local_master(min_nodes: int, max_nodes: int,
                         node_unit: int) -> JobMaster:
    """The master in this process, its main loop on a daemon thread."""
    master = JobMaster(port=0, min_nodes=min_nodes, max_nodes=max_nodes,
                       node_unit=node_unit)
    master.start()
    t = threading.Thread(target=master.run, daemon=True,
                         name="dwt-local-master")
    t.start()
    return master


def run(args: argparse.Namespace) -> int:
    min_nodes, max_nodes = parse_nnodes(args.nnodes)
    master_addr = os.getenv(NodeEnv.MASTER_ADDR, "")
    local_master = None
    use_standalone = args.standalone or not master_addr
    if use_standalone:
        local_master = _launch_local_master(min_nodes, max_nodes,
                                            args.node_unit)
        master_addr = local_master.addr
        os.environ[NodeEnv.MASTER_ADDR] = master_addr
        logger.info("standalone: local master at %s", master_addr)
    elif not addr_connectable(master_addr):
        logger.error("master %s not reachable", master_addr)
        return 2

    config = ElasticLaunchConfig(
        min_nodes=min_nodes, max_nodes=max_nodes,
        nproc_per_node=args.nproc_per_node,
        max_restarts=args.max_restarts,
        network_check=args.network_check,
        node_unit=args.node_unit,
        rdzv_timeout=args.rdzv_timeout,
        log_dir=args.log_dir)

    entrypoint = [sys.executable, "-u", args.training_script]
    entrypoint += [a for a in args.training_script_args if a != "--"]

    node_id = int(os.getenv(NodeEnv.NODE_ID, "0"))
    node_rank = int(os.getenv(NodeEnv.NODE_RANK, "0"))
    try:
        return launch_agent(config, entrypoint, master_addr, node_id,
                            node_rank)
    finally:
        if local_master is not None:
            local_master.stop()


def main(argv: Optional[List[str]] = None) -> int:
    return run(parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
