#!/usr/bin/env python3
"""GPT-2 XL's training state through the flash checkpoint on one H100.

Run from the root of a checkout, on a machine with an NVIDIA H100:

    python3 ckpt_profile.py

Builds GPT-2 XL (``GPTConfig.gpt2_xl()``: 48 layers, width 1600,
1,557,686,400 parameters) through ``auto_accelerate(...,
optimizer=adamw(3e-4))`` with remat "full", takes one step at B = 1,
T = 1024 so that AdamW's moments exist, and puts its training state
(float32 params, mu and nu: 18.69 GB) through the flash checkpoint as
``chip_smoke.py`` phase 7.2 does for GPT-2 124M, with its functions:
5 saves in turns with steps alone and steps during a drain (the blocked
seconds, the snapshot's device time, the drain, the persist; each
generation is pruned once the next commits, so at most two, 34.8 GiB,
lie on disk at once), one save chained behind another, and 5 restores
from shm and from storage (the verified load and the copy into the
state apart), each beside its bound at the rates measured in the same
run.  Run it in a call of its own: its disk writes come near the 45 GiB
that a measuring machine allows a call.  The reference's one GPU figure
for this model is a blocking save "of the order of seconds" on 2×A100
(BASELINE.md); this script measures the port's own.

It fails, naming the sizes, when /dev/shm, the host's memory or the
checkpoint directory cannot hold the state: the state is never shrunk.
Prints the card's ``nvidia-smi`` line and one JSON object; the same
object goes to ``chiprun_out/ckpt_profile.json``.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPEATS = 5


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ckpt_profile: FAILED: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke as cs

    # the checkpoint directory (the last generation alone is 17.4 GiB),
    # the sockets and the segment go, whatever happens
    with cs.ckpt_workspace("dwt-ckpt-xl-") as (ckpt_dir, opened):
        out = profile(torch, cs, ckpt_dir, opened)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "ckpt_profile.json"),
              "w") as f:
        json.dump(out, f, indent=1)
    print(out["card"])
    print(json.dumps(out))
    return 0


def profile(torch, cs, ckpt_dir: str, opened: list) -> dict:
    """The measurements, in `ckpt_dir`; each checkpointer goes in
    `opened`, which the caller's workspace closes."""
    from dlrover_wuqiong_tpu_torch import _build
    from dlrover_wuqiong_tpu_torch.auto.accelerate import auto_accelerate
    from dlrover_wuqiong_tpu_torch.checkpoint.checkpointer import (
        FlashCheckpointer,
    )
    from dlrover_wuqiong_tpu_torch.checkpoint.ckpt_saver import (
        AsyncCheckpointSaver,
    )
    from dlrover_wuqiong_tpu_torch.checkpoint.drill import fixed_batch
    from dlrover_wuqiong_tpu_torch.models.gpt import GPT, GPTConfig
    from dlrover_wuqiong_tpu_torch.trainer.train_step import adamw

    t_start = time.monotonic()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    cfg = dataclasses.replace(GPTConfig.gpt2_xl(), remat=True)
    out = {"card": card, "model": "gpt2_xl", "params": cfg.num_params(),
           "batch": 1, "seq": 1024, "remat": "full",
           "host": cs.ckpt_host(ckpt_dir)}
    state_bytes = cfg.num_params() * 12 + 8 + 4
    # the segment, the pinned drain buffer (reused by a restore), the
    # shard file read back and the self-heal's verified copy
    cs.ckpt_fits(out["host"], state_bytes, "GPT-2 XL")
    seg = state_bytes + (1 << 20)
    cs.check(out["host"]["mem_available_bytes"] >= 4 * seg,
             f"GPT-2 XL: the host has {out['host']['mem_available_bytes']} "
             f"bytes available; a storage restore needs {4 * seg}")
    res = auto_accelerate(GPT(cfg), optimizer=adamw(3e-4), seed=0)
    batch = fixed_batch(50257, 1, 1024, "cuda")
    res.state, m = res.train_step(res.state, batch)
    loss = float(m["loss"])
    cs.check(loss == loss, "GPT-2 XL: non-finite loss")
    cs.check(cs.tree_bytes(torch, res.state.tree()) == state_bytes,
             "GPT-2 XL: the training state is not 12 B a parameter")
    out["state_bytes"] = state_bytes
    out["rates_bytes_per_s"] = rates = cs.ckpt_rates(torch, ckpt_dir)
    out["bounds"] = cs.ckpt_bounds(state_bytes, rates)
    out["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()

    job = f"dwt-xl-{os.getpid()}"
    AsyncCheckpointSaver.reset()
    ck = FlashCheckpointer(ckpt_dir, job_name=job, standalone=True)
    opened.append(ck)
    rows = cs.time_saves(torch, ck, res, batch, REPEATS)
    out["saves"] = rows
    snapshot_ms = cs.time_snapshot(torch, ck.engine, res.state.tree(),
                                   REPEATS)
    out["chain"] = cs.time_chain(torch, ck, res, batch)
    # restores through a second checkpointer on the same saver: closing
    # the first releases its pinned drain buffer, which torch's pinned
    # allocator then hands to the restore
    ck.close()
    ck = FlashCheckpointer(ckpt_dir, job_name=job)
    opened.append(ck)
    restores = {t: [cs.timed_restore(torch, ck, res.state, t)
                    for _ in range(REPEATS)] for t in ("shm", "storage")}
    out["restores"] = restores
    ck.close()
    AsyncCheckpointSaver.reset()
    out["summary"] = cs.summarize(rows, restores, snapshot_ms)
    out["wall_s"] = time.monotonic() - t_start
    return out


if __name__ == "__main__":
    sys.exit(main())
