"""The elastic drill: ``run --standalone`` supervises a Trainer through
SIGKILLs.

The port's counterpart of the JAX package's ``chaos.py`` drills
``preempt`` (:455) and ``pod_kill`` (:127), on the port's launcher:

    python -m dlrover_wuqiong_tpu_torch.run --standalone --max_restarts=3 \\
        dlrover_wuqiong_tpu_torch/trainer/drill.py --marker-dir ... [knobs]

This file is both the worker script (run by the agent, one process per
generation) and the drill itself (`elastic_drill`).  The worker builds
``Trainer(GPT(cfg), TrainingArgs(...), data_fn)`` on its device, with a
shm stage every step and a disk save every ``save_steps``;
``data_fn(step)`` draws the step's tokens from ``(SEED, step)``, so a
resumed generation sees the batches the uninterrupted run saw.  A
callback at every step appends the step's loss to the generation's
marker file.  At its kill step (one a generation) the worker waits out
its in-flight staging, writes a ready marker and waits; `elastic_drill`
SIGKILLs it there, so the killed generation's last staged step is the
one before its kill step and its segment is whole.
The agent notices the exit, persists the staged generation, reports the
failure, re-rendezvouses and relaunches; the new generation resumes from
the ``shm`` tier and trains on to ``max_steps``.

`elastic_drill` returns, for every generation, its start step, restore
tier and per-step losses, the flash-kernel launch counts its process
made, its goodput ledger; the master's goodput summary as the last
worker read it; and for each kill the split of the time from the SIGKILL
to the first resumed step: the agent noticing the exit, the persist, the
failure report, the rendezvous, the worker process's start (interpreter,
imports, device context, model build), the restore, and the first step.
The agent's part comes from its spans in the flight dump it writes when
it ends (agent/elastic_agent.py), the worker's from its markers.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import random
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from typing import Dict, List

#: tokens are drawn below GPT-2's own vocabulary (its embedding is padded
#: to 50304), as chip_smoke.py's training phases draw them
VOCAB = {"gpt2": 50257, "nano": 512}
#: the SIGKILLs a drill lands, at steps drawn from this seed (which also
#: seeds the data)
KILLS, SEED = 2, 0


def data_fn(vocab: int, batch: int, seq: int):
    """``step -> {input_ids, labels}`` host batch of seeded tokens, the
    same for a step in every process."""
    import numpy as np

    def batch_at(step: int):
        x = np.random.default_rng([SEED, step]).integers(
            0, vocab, (batch, seq + 1), dtype=np.int64)
        return {"input_ids": x[:, :-1], "labels": x[:, 1:]}

    return batch_at


def training_args(out_dir: str, max_steps: int, warmup: int,
                  save_steps: int, batch: int, seq: int):
    """The drill's `TrainingArgs`: a shm stage and one loss readback a
    step (the losses are the drill's evidence), warmup then cosine."""
    from dlrover_wuqiong_tpu_torch.trainer.trainer import TrainingArgs

    return TrainingArgs(
        output_dir=out_dir, max_steps=max_steps, warmup_steps=warmup,
        save_steps=save_steps, flash_stage_steps=1, logging_steps=1,
        global_batch_size=batch, seq_len=seq, fused_steps=1)


def gpt_config(model: str):
    import dataclasses

    from dlrover_wuqiong_tpu_torch.models.gpt import GPTConfig

    base = GPTConfig.gpt2() if model == "gpt2" else GPTConfig.nano()
    return dataclasses.replace(base, remat=False)


# ------------------------------------------------------------------ worker


def _write_json(path: str, obj: Dict):
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def worker_main(argv=None) -> int:
    t_main = time.time()
    p = argparse.ArgumentParser(description="the elastic drill's worker")
    p.add_argument("--marker-dir", required=True)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--model", choices=tuple(VOCAB), default="gpt2")
    p.add_argument("--device", default=None)
    p.add_argument("--batch", type=int, default=24)
    p.add_argument("--seq", type=int, default=1024)
    p.add_argument("--max-steps", type=int, default=60)
    p.add_argument("--warmup", type=int, default=10)
    p.add_argument("--save-steps", type=int, default=20)
    p.add_argument("--kill-steps", default="",
                   help="comma-separated: generation g waits for its "
                        "SIGKILL at the g-th step")
    a = p.parse_args(argv)

    from dlrover_wuqiong_tpu_torch.models.gpt import GPT
    from dlrover_wuqiong_tpu_torch.ops import flash_attention as tfa
    from dlrover_wuqiong_tpu_torch.ops import quantization as tq
    from dlrover_wuqiong_tpu_torch.telemetry.ledger import get_ledger
    from dlrover_wuqiong_tpu_torch.trainer.elastic import get_world_info
    from dlrover_wuqiong_tpu_torch.trainer.trainer import Trainer

    gen = get_world_info().restart_count
    kills = [int(s) for s in a.kill_steps.split(",") if s]
    kill_at = kills[gen] if gen < len(kills) else -1
    losses_path = os.path.join(a.marker_dir, f"losses_g{gen}.jsonl")
    info = {"gen": gen, "pid": os.getpid(), "t_main": t_main}
    _write_json(os.path.join(a.marker_dir, f"start_g{gen}.json"), info)

    def on_step(step: int, m: Dict):
        with open(losses_path, "a") as f:
            f.write(json.dumps({"step": step, "loss": m["loss"],
                                "t": time.time()}) + "\n")
        if "t_first_step" not in info:
            info["t_first_step"] = time.time()
        if step == kill_at:
            trainer.ckpt.wait_staging()
            _write_json(os.path.join(a.marker_dir, f"ready_g{gen}.json"),
                        dict(info, step=step, resumed=trainer.resumed,
                             launches={**tfa.LAUNCHES, **tq.LAUNCHES},
                             ledger=get_ledger().snapshot()))
            while True:  # elastic_drill's SIGKILL ends this process
                time.sleep(60)

    trainer = Trainer(
        GPT(gpt_config(a.model)),
        training_args(a.out_dir, a.max_steps, a.warmup, a.save_steps,
                      a.batch, a.seq),
        data_fn(VOCAB[a.model], a.batch, a.seq),
        callbacks=[on_step], device=a.device)
    info["t_built"] = time.time()
    tfa.reset_launches()
    tq.reset_launches()
    out = trainer.train()
    summary = None
    if trainer.ctx.mc is not None:
        s = trainer.ctx.mc.get_goodput_summary()
        summary = {"goodput_fraction": s.goodput_fraction,
                   "wall_s": s.wall_s, "states": s.states,
                   "nodes": s.nodes}
    _write_json(os.path.join(a.marker_dir, f"done_g{gen}.json"),
                dict(info, result=out, resumed=trainer.resumed,
                     launches={**tfa.LAUNCHES, **tq.LAUNCHES},
                     ledger=get_ledger().snapshot(),
                     master_goodput=summary))
    return 0


# ------------------------------------------------------------------ drill


def kill_steps(lo: int, hi: int) -> List[int]:
    """`KILLS` distinct kill steps in [lo, hi] drawn from `SEED`,
    ascending."""
    return sorted(random.Random(SEED).sample(range(lo, hi + 1), KILLS))


def _read_jsonl(path: str) -> List[Dict]:
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _wait_for(path: str, proc: subprocess.Popen, timeout_s: float,
              log_path: str) -> Dict:
    deadline = time.monotonic() + timeout_s
    while not os.path.exists(path):
        if proc.poll() is not None or time.monotonic() > deadline:
            with open(log_path, errors="replace") as f:
                tail = f.read()[-4000:]
            raise RuntimeError(f"no {os.path.basename(path)} (launcher "
                               f"exit {proc.poll()}): {tail}")
        time.sleep(0.05)
    with open(path) as f:
        return json.load(f)


def _agent_spans(ckpt_dir: str) -> List[Dict]:
    """The agent's restart spans from its flight dumps, by start time."""
    from dlrover_wuqiong_tpu_torch.telemetry.recorder import (
        load_flight_dumps,
    )

    seen, out = set(), []
    for dump in load_flight_dumps(ckpt_dir):
        if dump.get("role") != "agent":
            continue
        for ev in dump.get("events", []):
            rec = ev.get("data") or {}
            key = rec.get("span_id")
            if ev.get("kind") == "span" and key not in seen:
                seen.add(key)
                out.append(rec)
    return sorted(out, key=lambda r: r["t_wall"])


def _split(kill_t: float, spans: List[Dict], done: Dict) -> Dict:
    """Seconds from one SIGKILL to the next generation's first step."""
    after = [s for s in spans if s["t_wall"] >= kill_t]

    def first(name):
        return next(s for s in after if s["name"] == name)

    exit_ = first("agent:worker-exit")
    persist = first("agent:persist")
    report = first("agent:report-failure")
    rdzv = first("rdzv:elastic-training:join")
    launch = first("agent:launch")
    restore_s = done["resumed"]["seconds"]
    return {
        "notice_s": exit_["t_wall"] - kill_t,
        "persist_s": persist["dur_s"],
        "report_s": report["dur_s"],
        "rendezvous_s": rdzv["dur_s"],
        "process_start_s": done["t_built"] - launch["t_wall"],
        "restore_s": restore_s,
        "first_step_s": done["t_first_step"] - done["t_built"] - restore_s,
        "kill_to_first_step_s": done["t_first_step"] - kill_t,
    }


def elastic_drill(model: str = "gpt2", device: str = "cuda",
                  batch: int = 24, seq: int = 1024, max_steps: int = 60,
                  warmup: int = 10, save_steps: int = 20,
                  kill_range=(10, 50), timeout_s: float = 900.0) -> Dict:
    """Run the drill under ``run --standalone --max_restarts=3`` in a
    workspace of its own (checkpoint, socket and marker directories, job
    name), removed with the shm segment whether it passes or fails.
    `KILLS` SIGKILLs land at seeded steps in `kill_range`.  Each
    generation has `timeout_s` to reach its marker."""
    from dlrover_wuqiong_tpu_torch.checkpoint.shm_handler import (
        SharedMemoryHandler,
    )
    from dlrover_wuqiong_tpu_torch.common.constants import CheckpointConstant

    steps = kill_steps(*kill_range)
    if steps and not 1 < steps[0] and steps[-1] < max_steps:
        raise ValueError(f"kill steps {steps} must lie in (1, {max_steps})")
    job = f"dwt-el-{os.getpid()}"
    # short: the sockets under it must stay within the AF_UNIX limit
    root = tempfile.mkdtemp(prefix="dwt-el-")
    out_dir, markers = os.path.join(root, "out"), os.path.join(root, "m")
    ckpt_dir = os.path.join(out_dir, "checkpoints")
    sock_dir = os.path.join(root, "sockets")
    for d in (markers, sock_dir):
        os.makedirs(d)
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, DWT_JOB_NAME=job, DWT_SOCKET_DIR=sock_dir,
               DWT_CKPT_DIR=ckpt_dir,
               PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    env.pop("DWT_MASTER_ADDR", None)
    cmd = [sys.executable, "-m", "dlrover_wuqiong_tpu_torch.run",
           "--standalone", "--nproc_per_node=1", "--max_restarts=3",
           "--log_dir", os.path.join(root, "logs"),
           os.path.abspath(__file__),
           "--marker-dir", markers, "--out-dir", out_dir, "--model", model,
           "--batch", str(batch), "--seq", str(seq),
           "--max-steps", str(max_steps), "--warmup", str(warmup),
           "--save-steps", str(save_steps), "--device", device,
           "--kill-steps", ",".join(map(str, steps))]
    log_path = os.path.join(root, "launcher.log")
    launcher = None
    kills_out, killed = [], set()
    try:
        t0 = time.time()
        with open(log_path, "w") as log:
            launcher = subprocess.Popen(cmd, env=env, stdout=log,
                                        stderr=subprocess.STDOUT)
        for gen, step in enumerate(steps):
            ready = _wait_for(os.path.join(markers, f"ready_g{gen}.json"),
                              launcher, timeout_s, log_path)
            kill_t = time.time()
            os.kill(ready["pid"], signal.SIGKILL)
            killed.add(gen)
            # the segment the dead worker staged (before the next
            # generation, ~seconds away, can stage over it)
            header = SharedMemoryHandler(0, job).load_header() or {}
            kills_out.append({"step": step, "t_kill": kill_t,
                              "staged_step": header.get("step")})
        rc = launcher.wait(timeout=timeout_s)
        wall_s = time.time() - t0
        gens = []
        for gen in range(len(steps) + 1):
            rec = dict(_read_json_any(markers, gen))
            rec["losses"] = _read_jsonl(
                os.path.join(markers, f"losses_g{gen}.jsonl"))
            gens.append(rec)
        tracker = os.path.join(ckpt_dir, CheckpointConstant.TRACKER_FILE)
        committed = (open(tracker).read().strip()
                     if os.path.exists(tracker) else "")
        spans = _agent_spans(ckpt_dir)
        final = gens[-1]
        splits = [_split(k["t_kill"], spans, g)
                  for k, g in zip(kills_out, gens[1:])
                  if "t_built" in g and "resumed" in g]
        productive = sum(g.get("ledger", {}).get("states", {}).get(
            "productive", 0.0) for g in gens)
        return {
            "job": job, "rc": rc, "wall_s": wall_s,
            "kill_steps": steps, "kills": kills_out,
            "committed_step": committed,
            "generations": [{
                "gen": g.get("gen"), "start_step":
                    (g.get("resumed") or {}).get("step", 0),
                "tier": (g.get("resumed") or {}).get("tier"),
                "launches": g.get("launches"),
                "steps": [r["step"] for r in g["losses"]],
                "losses": [r["loss"] for r in g["losses"]],
                "ledger": g.get("ledger")} for g in gens],
            "splits": splits,
            "master_goodput": final.get("master_goodput"),
            "final_ledger_goodput": (final.get("ledger") or {}).get(
                "goodput_fraction"),
            # the productive seconds of every generation's ledger over
            # the launcher's wall time: what the restarts cost this run
            "drill_goodput": productive / wall_s if wall_s > 0 else 0.0,
        }
    finally:
        if launcher is not None and launcher.poll() is None:
            launcher.kill()
            launcher.wait(timeout=60)
        # a worker the drill did not kill and that did not finish (the
        # drill failed) leads its own process group, which the launcher's
        # end left running
        for path in glob.glob(os.path.join(markers, "start_g*.json")):
            gen = int(os.path.basename(path)[len("start_g"):-len(".json")])
            if gen in killed or os.path.exists(
                    os.path.join(markers, f"done_g{gen}.json")):
                continue
            try:
                with open(path) as f:
                    os.killpg(json.load(f)["pid"], signal.SIGKILL)
            except (OSError, ValueError, KeyError):
                pass
        SharedMemoryHandler(0, job).unlink()
        shutil.rmtree(root, ignore_errors=True)


def _read_json_any(markers: str, gen: int) -> Dict:
    """A generation's done marker, else its ready marker."""
    for kind in ("done", "ready"):
        path = os.path.join(markers, f"{kind}_g{gen}.json")
        if os.path.exists(path):
            with open(path) as f:
                return json.load(f)
    return {"gen": gen}


if __name__ == "__main__":
    sys.exit(worker_main())
