"""The SIGKILL drill of the flash checkpoint: restore from a dead trainer's shm.

A trainer process trains, stages its state into shared memory
(``save_to_memory``, no disk), takes one more step so that its live
state differs from the staged one, and is SIGKILLed.  No saver survives
the kill.  A second process of the same job restores from the dead one's
segment (the ``shm`` tier) and trains on; its first step must equal, bit
for bit, the step the dead trainer took after its save.

    python -m dlrover_wuqiong_tpu_torch.checkpoint.drill --role save ...
    python -m dlrover_wuqiong_tpu_torch.checkpoint.drill --role resume ...

`sigkill_drill` runs both and returns the report.  Each child prints one
JSON line.  The segment carries the drill's own pid as its owner,
standing in for the agent that owns a launched job's segments (ROADMAP
item 7a): another job's stale-segment sweeper spares it while the drill
runs, and the drill unlinks it at the end.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import select
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from typing import Dict, List

import torch

SAVE_STEP = 5
#: tokens are drawn below GPT-2's own vocabulary (its embedding is padded
#: to 50304), as chip_smoke.py's training phase draws them
VOCAB = {"gpt2": 50257, "nano": 512}


def fixed_batch(vocab: int, batch: int, seq: int, device, seed: int = 0):
    """Seeded random tokens on `device`: (batch, seq) ids and next-token
    labels from one draw of (batch, seq + 1)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randint(0, vocab, (batch, seq + 1), generator=gen,
                      device=device)
    return {"input_ids": x[..., :-1], "labels": x[..., 1:]}


def _train(args, seed: int):
    from ..auto.accelerate import auto_accelerate
    from ..models.gpt import GPT, GPTConfig
    from ..trainer.train_step import adamw

    base = GPTConfig.gpt2() if args.model == "gpt2" else GPTConfig.nano()
    cfg = dataclasses.replace(base, remat=False)
    res = auto_accelerate(GPT(cfg), optimizer=adamw(3e-4), seed=seed,
                          device=args.device)
    batch = fixed_batch(VOCAB[args.model], args.batch, args.seq, res.device)
    return res, batch


def _steps(res, batch, n: int) -> List[float]:
    losses = []
    for _ in range(n):
        res.state, m = res.train_step(res.state, batch)
        losses.append(m["loss"])
    return [float(x) for x in losses]


def _child(args) -> Dict:
    from .checkpointer import FlashCheckpointer, StorageType

    t_main = time.time()
    res, batch = _train(args, seed=0 if args.role == "save" else 1)
    ck = FlashCheckpointer(args.ckpt_dir, job_name=args.job,
                           standalone=True)
    if args.role == "save":
        losses = _steps(res, batch, SAVE_STEP)
        ck.save_checkpoint(SAVE_STEP, res.state.tree(), StorageType.MEMORY,
                           extra_meta={"_pid": args.owner_pid})
        ck.wait_staging()
        losses += _steps(res, batch, 1)  # live state now past the save
        return {"losses": losses}
    t_restore = time.time()
    ck.load_checkpoint(res.state)
    t_restored = time.time()
    report = dict(ck.last_restore_report)
    ck.close()
    return {"t_main": t_main, "t_restore": t_restore,
            "t_restored": t_restored, "tier": report.get("tier"),
            "restored_step": report.get("step"),
            "state_step": int(res.state.step),
            "losses": _steps(res, batch, 2)}


def _spawn(role: str, ckpt_dir: str, job: str, model: str, device: str,
           batch: int, seq: int, env: Dict) -> subprocess.Popen:
    with open(os.path.join(ckpt_dir, f"{role}.log"), "w") as log:
        return subprocess.Popen(
            [sys.executable, "-m",
             "dlrover_wuqiong_tpu_torch.checkpoint.drill", "--role", role,
             "--ckpt-dir", ckpt_dir, "--job", job, "--model", model,
             "--device", device, "--batch", str(batch), "--seq", str(seq),
             "--owner-pid", str(os.getpid())],
            stdout=subprocess.PIPE, stderr=log, text=True, env=env)


def _json_line(proc: subprocess.Popen, role: str, ckpt_dir: str,
               timeout_s: float) -> Dict:
    ready, _, _ = select.select([proc.stdout], [], [], timeout_s)
    line = proc.stdout.readline() if ready else ""
    if not line:
        proc.kill()
        proc.wait(timeout=60)
        with open(os.path.join(ckpt_dir, f"{role}.log")) as log:
            raise RuntimeError(f"the {role} trainer gave no result within "
                               f"{timeout_s} s (exit {proc.returncode}): "
                               f"{log.read()[-4000:]}")
    return json.loads(line)


def sigkill_drill(model: str = "gpt2", device: str = "cuda",
                  batch: int = 24, seq: int = 1024,
                  timeout_s: float = 600.0) -> Dict:
    """Run the drill; returns the saver's 6 losses, the resumer's 2, the
    tier it restored from, and the seconds from the SIGKILL to the
    restored state, split into the second process's start (python,
    imports, device context, model build) and the restore itself.  Each
    child has `timeout_s` to print its result."""
    from .shm_handler import SharedMemoryHandler

    job = f"dwt-drill-{os.getpid()}"
    ckpt_dir = tempfile.mkdtemp(prefix="dwt-drill-")
    sock_dir = tempfile.mkdtemp(prefix="dwt-drill-sock-")
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, DWT_SOCKET_DIR=sock_dir,
               PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    procs = []
    try:
        saver = _spawn("save", ckpt_dir, job, model, device, batch, seq, env)
        procs.append(saver)
        saved = _json_line(saver, "save", ckpt_dir, timeout_s)
        t_kill = time.time()
        saver.send_signal(signal.SIGKILL)
        saver.wait(timeout=60)
        resumer = _spawn("resume", ckpt_dir, job, model, device, batch, seq,
                         env)
        procs.append(resumer)
        resumed = _json_line(resumer, "resume", ckpt_dir, timeout_s)
        rc = resumer.wait(timeout=timeout_s)
        if rc != 0:
            raise RuntimeError(f"the resume trainer exited {rc}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=60)
        SharedMemoryHandler(0, job).unlink()
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        shutil.rmtree(sock_dir, ignore_errors=True)
    return {
        "job": job, "saver_rc": saver.returncode,
        "saved_losses": saved["losses"], "resumed_losses": resumed["losses"],
        "tier": resumed["tier"], "restored_step": resumed["restored_step"],
        "state_step_after_restore": resumed["state_step"],
        "kill_to_restored_s": resumed["t_restored"] - t_kill,
        "start_s": resumed["t_restore"] - t_kill,
        "start_to_main_s": resumed["t_main"] - t_kill,
        "restore_s": resumed["t_restored"] - resumed["t_restore"],
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--role", choices=("save", "resume"), required=True)
    p.add_argument("--ckpt-dir", required=True)
    p.add_argument("--job", required=True)
    p.add_argument("--model", choices=("gpt2", "nano"), default="gpt2")
    p.add_argument("--device", default="cuda")
    p.add_argument("--batch", type=int, default=24)
    p.add_argument("--seq", type=int, default=1024)
    p.add_argument("--owner-pid", type=int, default=os.getpid())
    args = p.parse_args(argv)
    out = _child(args)
    print(json.dumps(out), flush=True)
    if args.role == "save":
        signal.pause()  # staged and stepped on: wait for the SIGKILL
    return 0


if __name__ == "__main__":
    sys.exit(main())
