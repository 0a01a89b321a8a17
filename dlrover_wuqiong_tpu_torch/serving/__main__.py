"""Standalone decode-worker entrypoint.

Parity: dlrover_wuqiong_tpu/serving/__main__.py, with the same flags and
one more, ``--device`` (default ``cuda``; the JAX file forces the CPU,
the port's entry points run on the card unless asked otherwise):

    python -m dlrover_wuqiong_tpu_torch.serving --master HOST:PORT \
        --node-id N [--slots 4] [--max-len 64] [--max-prompt-len 16] \
        [--fused-tokens 4] [--quant int8] [--seconds 30] \
        [--ckpt-dir DIR] [--model-seed 0] [--stats-every 2] \
        [--device cuda]

Builds a GPTConfig.nano() model with seed-deterministic params, then runs
the ServingWorker loop against the master's Serve* verbs.  The weights
are drawn on a CPU generator and then moved to ``--device``, so every
worker generation, and any reference engine built the same way, holds
the same values: a request re-admitted after a worker kill continues
bit-identically (the serve-drain drill depends on this).  Without a GPU,
the default ``--device cuda`` raises.
"""

from __future__ import annotations

import sys


def main(argv) -> int:
    args = {"master": "", "node_id": 1, "slots": 4, "max_len": 64,
            "max_prompt_len": 16, "fused_tokens": 4, "quant": "",
            "seconds": 0.0, "ckpt_dir": "", "model_seed": 0,
            "stats_every": 2, "device": "cuda"}
    it = iter(argv)
    for a in it:
        key = a.lstrip("-").replace("-", "_")
        if key in args:
            raw = next(it)
            cur = args[key]
            args[key] = type(cur)(raw) if not isinstance(cur, str) \
                else raw
        else:
            print(f"unknown arg {a}", file=sys.stderr)
            return 2
    if not args["master"]:
        print("--master HOST:PORT is required", file=sys.stderr)
        return 2

    from ..agent.master_client import MasterClient
    from ..common.comm import RpcError
    from ..models.gpt import GPTConfig, init_params
    from .engine import ServeSpec, ServingEngine
    from .worker import ServingWorker

    cfg = GPTConfig.nano()
    params = init_params(cfg, args["model_seed"], device="cpu")
    spec = ServeSpec(max_slots=args["slots"], max_len=args["max_len"],
                     max_prompt_len=args["max_prompt_len"],
                     fused_tokens=args["fused_tokens"],
                     quant=args["quant"])
    engine = ServingEngine(cfg, params, spec, device=args["device"])
    client = MasterClient(args["master"], node_id=args["node_id"],
                          node_type="serve-worker")
    try:
        client.register_node(node_rank=args["node_id"])
    except RpcError:
        # registration is best-effort for standalone drills; leases work
        # without it
        pass
    worker = ServingWorker(client, engine, ckpt_dir=args["ckpt_dir"],
                           stats_every=args["stats_every"])
    try:
        worker.run(max_seconds=args["seconds"] or None)
    finally:
        client.close()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
