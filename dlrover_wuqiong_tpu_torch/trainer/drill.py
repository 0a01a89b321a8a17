"""The elastic drills: ``run --standalone`` supervises a Trainer through
SIGKILLs, and a 2-node job loses a node and resumes it from the replica
ring.

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

`node_loss_drill` is the drive of the agent's replica ring
(`_setup_replication`; the JAX package has no end-to-end test that
turns it on through the agent, so this harness is the port's own):

    node_loss_drill(model="nano", device="cpu", batch=2, seq=32)

Two ``run --nnodes=2`` launchers, each a node with its own job name and
socket directory, against one in-process port master, with
``DWT_CTX_CHECKPOINT_REPLICA=1``.  Each worker (`node_worker_main`, this
file with ``--node-loss``) trains its own GPT on its rank's tokens, in a
gloo world the worker chooses up front (the drill's two ranks share one
card, where NCCL refuses two ranks; the model and its kernels stay on
the device).  Once step 20 is committed and node 1's segment of it is
held by node 0's ReplicaServer, node 1 is lost (agent and worker
SIGKILLed, its segment unlinked) and a fresh node-1 launcher restores
the segment from the ring before its worker resumes from shm.
`node_loss_checks` names what must hold, and `uninterrupted_losses`
gives each rank's reference run.
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


def data_fn(vocab: int, batch: int, seq: int, rank=None):
    """``step -> {input_ids, labels}`` host batch of seeded tokens, the
    same for a step in every process; with `rank`, drawn from (seed,
    step, rank), so ranks train on different data."""
    import numpy as np

    def batch_at(step: int):
        seed = [SEED, step] if rank is None else [SEED, step, rank]
        x = np.random.default_rng(seed).integers(
            0, vocab, (batch, seq + 1), dtype=np.int64)
        return {"input_ids": x[:, :-1], "labels": x[:, 1:]}

    return batch_at


def training_args(out_dir: str, max_steps: int, warmup: int,
                  save_steps: int, batch: int, seq: int,
                  stage_steps: int = 1):
    """The drill's `TrainingArgs`: a shm stage every `stage_steps` and
    one loss readback a step (the losses are the drill's evidence),
    warmup then cosine."""
    from dlrover_wuqiong_tpu_torch.trainer.trainer import TrainingArgs

    return TrainingArgs(
        output_dir=out_dir, max_steps=max_steps, warmup_steps=warmup,
        save_steps=save_steps, flash_stage_steps=stage_steps,
        logging_steps=1, global_batch_size=batch, seq_len=seq,
        fused_steps=1)


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


def kill_steps(lo: int, hi: int, kills: int = KILLS) -> List[int]:
    """`kills` distinct kill steps in [lo, hi] drawn from `SEED`,
    ascending."""
    return sorted(random.Random(SEED).sample(range(lo, hi + 1), kills))


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
            raise RuntimeError(f"no {os.path.basename(path)} (launcher "
                               f"exit {proc.poll()}): {_tail(log_path)}")
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
                  kill_range=(10, 50), timeout_s: float = 900.0,
                  kills: int = KILLS) -> Dict:
    """Run the drill under ``run --standalone --max_restarts=3`` in a
    workspace of its own (checkpoint, socket and marker directories, job
    name), removed with the shm segment whether it passes or fails.
    `kills` SIGKILLs land at seeded steps in `kill_range`.  Each
    generation has `timeout_s` to reach its marker."""
    from dlrover_wuqiong_tpu_torch.checkpoint.shm_handler import (
        SharedMemoryHandler,
    )
    from dlrover_wuqiong_tpu_torch.common.constants import CheckpointConstant

    steps = kill_steps(*kill_range, kills)
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
            rec = {"gen": gen, **_read_marker(markers, f"g{gen}")}
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


# --------------------------------------------------------- node-loss drill

#: the node-loss drill's run: a shm stage every 5 steps, a disk save (the
#: persist, then the ring backup) every 10, node 1 lost after step 20
NODE_LOSS = dict(max_steps=30, warmup=5, save_steps=10, stage_steps=5,
                 lose_after=20)


def node_worker_main(argv=None) -> int:
    """The node-loss drill's worker: rank r of a 2-process world trains a
    GPT of its own on (seed, step, r) tokens.  Its first launch waits at
    step ``--pause-step``, after the callback of which nothing was staged
    since the save before it: SIGKILLed there on the lost node; on the
    surviving node it exits at its agent's SIGTERM (the membership
    change), without the Trainer's exit save, which would stage the
    pause step and wait for a commit the lost rank cannot join."""
    t_main = time.time()
    p = argparse.ArgumentParser(description="the node-loss drill's worker")
    p.add_argument("--marker-dir", required=True)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--model", choices=tuple(VOCAB), default="gpt2")
    p.add_argument("--device", default=None)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=1024)
    p.add_argument("--max-steps", type=int, default=30)
    p.add_argument("--warmup", type=int, default=5)
    p.add_argument("--save-steps", type=int, default=10)
    p.add_argument("--stage-steps", type=int, default=5)
    p.add_argument("--pause-step", type=int, required=True)
    a = p.parse_args(argv)

    import torch
    import torch.distributed as dist

    from dlrover_wuqiong_tpu_torch.models.gpt import GPT
    from dlrover_wuqiong_tpu_torch.ops import flash_attention as tfa
    from dlrover_wuqiong_tpu_torch.ops import quantization as tq
    from dlrover_wuqiong_tpu_torch.telemetry.ledger import get_ledger
    from dlrover_wuqiong_tpu_torch.trainer.elastic import init_elastic
    from dlrover_wuqiong_tpu_torch.trainer.trainer import Trainer

    # the world's group, chosen here before the Trainer joins it: the
    # drill puts both ranks on one card, where NCCL refuses two ranks.
    # The model and its kernels stay on the device
    ctx = init_elastic(backend="gloo")
    rank = ctx.process_id
    launch = len(glob.glob(os.path.join(a.marker_dir,
                                        f"start_r{rank}_*.json")))
    tag = f"r{rank}_{launch}"
    losses_path = os.path.join(a.marker_dir, f"losses_{tag}.jsonl")
    info = {"rank": rank, "launch": launch, "pid": os.getpid(),
            "t_main": t_main, "world": ctx.world.num_processes,
            "backend": dist.get_backend() if dist.is_initialized() else ""}
    _write_json(os.path.join(a.marker_dir, f"start_{tag}.json"), info)
    saves: Dict[int, tuple] = {}  # id(snapshot) -> (step, snapshot)

    def note_save(step: int):
        snap = trainer.ckpt.engine.last_snapshot
        if snap is not None and id(snap) not in saves:
            saves[id(snap)] = (step, snap)

    def record(**extra) -> Dict:
        cuda = trainer.res.device.type == "cuda"
        return dict(info, **extra, resumed=trainer.resumed,
                    launches={**tfa.LAUNCHES, **tq.LAUNCHES},
                    ledger=get_ledger().snapshot(),
                    saves=sorted(({"step": st, **snap.timing}
                                  for st, snap in saves.values()),
                                 key=lambda r: r["step"]),
                    peak_bytes=torch.cuda.max_memory_allocated(
                        trainer.res.device) if cuda else None)

    def on_step(step: int, m: Dict):
        with open(losses_path, "a") as f:
            f.write(json.dumps({"step": step, "loss": m["loss"],
                                "t": time.time()}) + "\n")
        if "t_first_step" not in info:
            info["t_first_step"] = time.time()
        note_save(step - 1)  # a save lands after its step's callback
        if launch == 0 and step == a.pause_step:
            trainer.ckpt.wait_staging()
            _write_json(os.path.join(a.marker_dir, f"ready_{tag}.json"),
                        record(step=step))
            while not trainer._preempted:  # the drill's SIGKILL, or the
                time.sleep(0.05)           # agent's SIGTERM
            os._exit(0)

    trainer = Trainer(
        GPT(gpt_config(a.model)),
        training_args(a.out_dir, a.max_steps, a.warmup, a.save_steps,
                      a.batch, a.seq, a.stage_steps),
        data_fn(VOCAB[a.model], a.batch, a.seq, rank),
        callbacks=[on_step], device=a.device)
    info["t_built"] = time.time()
    tfa.reset_launches()
    tq.reset_launches()
    out = trainer.train()
    note_save(a.max_steps)
    _write_json(os.path.join(a.marker_dir, f"done_{tag}.json"),
                record(result=out))
    return 0


def uninterrupted_losses(rank: int, out_dir: str, model: str = "gpt2",
                         device: str = "cuda", batch: int = 8,
                         seq: int = 1024, max_steps: int = 30,
                         warmup: int = 5, **_) -> Dict[int, float]:
    """{step: loss} of rank `rank`'s data trained in this process with
    the drill's model, data and schedule, and no fault: the drill's
    reference.  It stages and saves nothing (the drill's other knobs,
    its cadences and loss step, are taken and ignored): a save copies
    the state and leaves the arithmetic alone, so the drill's losses
    equal these bitwise.  The Trainer hosts its saver in this process,
    named by ``DWT_JOB_NAME`` under ``DWT_SOCKET_DIR``: give the process
    names of its own."""
    import dataclasses

    from dlrover_wuqiong_tpu_torch.checkpoint.ckpt_saver import (
        AsyncCheckpointSaver,
    )
    from dlrover_wuqiong_tpu_torch.models.gpt import GPT
    from dlrover_wuqiong_tpu_torch.telemetry.ledger import reset_ledger
    from dlrover_wuqiong_tpu_torch.trainer.trainer import Trainer

    losses: Dict[int, float] = {}
    AsyncCheckpointSaver.reset()
    try:
        args = dataclasses.replace(
            training_args(out_dir, max_steps, warmup, 0, batch, seq, 0),
            save_on_exit=False)
        tr = Trainer(GPT(gpt_config(model)), args,
                     data_fn(VOCAB[model], batch, seq, rank),
                     callbacks=[lambda s, m: losses.__setitem__(
                         s, m["loss"])], device=device)
        tr.train()
        tr.ckpt.close()
    finally:
        AsyncCheckpointSaver.reset()
        reset_ledger()
    return losses


def _held_step(addr: str, owner: int) -> int:
    """The step of `owner`'s backup that the ReplicaServer at `addr`
    holds (its ``query`` verb), -1 for none."""
    import socket

    from dlrover_wuqiong_tpu_torch.checkpoint.replica import (
        _recv_msg,
        _send_msg,
    )

    host, port = addr.rsplit(":", 1)
    with socket.create_connection((host, int(port)), timeout=30) as sock:
        _send_msg(sock, {"op": "query", "owner": owner})
        resp, _ = _recv_msg(sock)
    return int(resp.get("step", -1)) if resp.get("found") else -1


def _first(spans: List[Dict], name: str) -> Dict:
    found = [s for s in spans if s["name"] == name]
    if not found:
        raise RuntimeError(f"no {name} span among "
                           f"{sorted({s['name'] for s in spans})}")
    return found[0]


def _node_split(kill_t: float, spans: List[Dict], done: Dict) -> Dict:
    """Seconds from the node's loss to its new worker's first step, by
    part: the replacement agent's start (the lost segment's unlink, the
    launcher's interpreter and imports, its saver), the rendezvous (the
    survivor's agent noticing the waiting node and stopping its worker),
    the peer exchange in the kv store, the ring restore, the launch, the
    worker process's start, its restore from shm, its first step."""
    rdzv = _first(spans, "rdzv:elastic-training:join")
    ring = _first(spans, "agent:replica-restore")
    launch = _first(spans, "agent:launch")
    restore_s = done["resumed"]["seconds"]
    return {
        "agent_start_s": rdzv["t_wall"] - kill_t,
        "rendezvous_s": rdzv["dur_s"],
        "peer_exchange_s": ring["t_wall"] - rdzv["t_wall"] - rdzv["dur_s"],
        "ring_restore_s": ring["dur_s"],
        "launch_s": launch["t_wall"] - ring["t_wall"] - ring["dur_s"],
        "process_start_s": done["t_built"] - launch["t_wall"],
        "restore_s": restore_s,
        "first_step_s": done["t_first_step"] - done["t_built"] - restore_s,
        "kill_to_first_step_s": done["t_first_step"] - kill_t,
    }


def node_loss_drill(model: str = "gpt2", device: str = "cuda",
                    batch: int = 8, seq: int = 1024, max_steps: int = 30,
                    warmup: int = 5, save_steps: int = 10,
                    stage_steps: int = 5, lose_after: int = 20,
                    timeout_s: float = 900.0) -> Dict:
    """Lose a whole node of a 2-node job and resume it from the replica
    ring.

    An in-process port `JobMaster` (min = max = 2 nodes) and two
    ``python -m dlrover_wuqiong_tpu_torch.run --nnodes=2
    --nproc_per_node=1`` launchers with ``DWT_CTX_CHECKPOINT_REPLICA=1``,
    each a node of its own: its own job name and socket directory (a
    segment is named ``{job}_ckpt_shm_{local_rank}``, so two nodes on one
    host must not share a job name), one checkpoint directory for both
    (the shared storage the commit needs every rank's shards in).  Each
    worker (`node_worker_main`) trains its own GPT of `model` on its
    rank's data.  Once both wait at step ``lose_after + 1``, step
    `lose_after` is committed, and node 0's ReplicaServer holds node 1's
    segment of that step, node 1 is lost: its agent and worker are
    SIGKILLed, its segment is unlinked (a lost host takes its /dev/shm
    along), and a fresh node-1 launcher starts with the same node rank.
    Its agent restores the segment from the ring before its worker
    starts; node 0's agent, seeing a node waiting, restarts its worker
    into the new world.  Both train on to `max_steps`.

    Returns every launch's record (start step, tier, losses, launches,
    ledger, saves with their lock waits, peak memory), the ring restore's
    span and log line, the backups' spans, and the split of node 1's time
    from the loss to its first resumed step (`_node_split`).  The
    workspace and both segments go whether it passes or fails."""
    from dlrover_wuqiong_tpu_torch.checkpoint.shm_handler import (
        SharedMemoryHandler,
    )
    from dlrover_wuqiong_tpu_torch.common.constants import CheckpointConstant
    from dlrover_wuqiong_tpu_torch.master.master import JobMaster

    if lose_after % save_steps or not 0 < lose_after < max_steps - 1:
        raise ValueError(f"lose_after={lose_after} must be a save step "
                         f"(every {save_steps}) before step {max_steps - 1}")
    pause = lose_after + 1
    base = f"dwt-nl-{os.getpid()}"
    jobs = [f"{base}-n0", f"{base}-n1"]
    # short: the sockets under it must stay within the AF_UNIX limit
    root = tempfile.mkdtemp(prefix="dwt-nl-")
    out_dir, markers = os.path.join(root, "out"), os.path.join(root, "m")
    ckpt_dir = os.path.join(out_dir, "checkpoints")
    os.makedirs(markers)
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    tracker = os.path.join(ckpt_dir, CheckpointConstant.TRACKER_FILE)
    master = JobMaster(port=0, min_nodes=2, max_nodes=2, host="127.0.0.1")
    master.start()
    procs: Dict[tuple, subprocess.Popen] = {}
    logs: Dict[tuple, str] = {}

    def start(node: int, n: int):
        sock_dir = os.path.join(root, f"s{node}")
        os.makedirs(sock_dir, exist_ok=True)
        env = dict(os.environ, DWT_MASTER_ADDR=master.addr,
                   DWT_NODE_ID=str(node), DWT_NODE_RANK=str(node),
                   DWT_JOB_NAME=jobs[node], DWT_SOCKET_DIR=sock_dir,
                   DWT_CKPT_DIR=ckpt_dir, DWT_CTX_CHECKPOINT_REPLICA="1",
                   PYTHONPATH=repo + os.pathsep + os.environ.get(
                       "PYTHONPATH", ""))
        cmd = [sys.executable, "-m", "dlrover_wuqiong_tpu_torch.run",
               "--nnodes=2", "--nproc_per_node=1", "--max_restarts=3",
               "--log_dir", os.path.join(root, f"logs-n{node}-{n}"),
               os.path.abspath(__file__), "--node-loss",
               "--marker-dir", markers, "--out-dir", out_dir,
               "--model", model, "--batch", str(batch), "--seq", str(seq),
               "--max-steps", str(max_steps), "--warmup", str(warmup),
               "--save-steps", str(save_steps),
               "--stage-steps", str(stage_steps),
               "--pause-step", str(pause), "--device", device]
        logs[node, n] = os.path.join(root, f"launcher-n{node}-{n}.log")
        with open(logs[node, n], "w") as log:
            procs[node, n] = subprocess.Popen(
                cmd, env=env, stdout=log, stderr=subprocess.STDOUT)

    def wait_until(cond, what: str):
        deadline = time.monotonic() + timeout_s
        while not cond():
            for key, proc in procs.items():
                if proc.poll() is not None:
                    raise RuntimeError(f"launcher {key} exited "
                                       f"{proc.returncode} waiting for "
                                       f"{what}: {_tail(logs[key])}")
            if time.monotonic() > deadline:
                raise TimeoutError(f"no {what} within {timeout_s} s")
            time.sleep(0.05)

    def committed() -> str:
        if not os.path.exists(tracker):
            return ""
        with open(tracker) as f:
            return f.read().strip()

    try:
        t0 = time.time()
        for node in (0, 1):
            start(node, 0)
        ready = [_wait_for(os.path.join(markers, f"ready_r{r}_0.json"),
                           procs[r, 0], timeout_s, logs[r, 0])
                 for r in (0, 1)]
        t_ready = time.time()
        rdzv_round = master.rdzv_manager(
            "elastic-training").get_rdzv_round()
        holder = (master.kv_store.get(f"replica/{rdzv_round}/0")
                  or b"").decode()
        wait_until(lambda: committed() == str(lose_after)
                   and _held_step(holder, 1) == lose_after,
                   f"step {lose_after} committed and backed up")
        backed_up_wait_s = time.time() - t_ready
        staged = (SharedMemoryHandler(0, jobs[1]).load_header()
                  or {}).get("step")
        # lose node 1: its agent first (so it never sees its worker die
        # and persists nothing), then the worker, then its segment
        kill_t = time.time()
        procs[1, 0].kill()
        os.kill(ready[1]["pid"], signal.SIGKILL)
        procs[1, 0].wait(timeout=60)
        SharedMemoryHandler(0, jobs[1]).unlink()
        segment_gone = not os.path.exists(f"/dev/shm/{jobs[1]}_ckpt_shm_0")
        start(1, 1)
        rcs = {0: procs[0, 0].wait(timeout=timeout_s),
               1: procs[1, 1].wait(timeout=timeout_s)}
        wall_s = time.time() - t0
        launches = {}
        for r in (0, 1):
            for n in (0, 1):
                rec = dict(_read_marker(markers, f"r{r}_{n}"))
                rec["losses_rec"] = _read_jsonl(
                    os.path.join(markers, f"losses_r{r}_{n}.jsonl"))
                launches[f"r{r}_{n}"] = {
                    "rank": r, "launch": n,
                    "start_step": (rec.get("resumed") or {}).get("step", 0),
                    "tier": (rec.get("resumed") or {}).get("tier"),
                    "restore_s": (rec.get("resumed") or {}).get("seconds"),
                    "backend": rec.get("backend"), "world": rec.get("world"),
                    "launches": rec.get("launches"),
                    "steps": [x["step"] for x in rec["losses_rec"]],
                    "losses": [x["loss"] for x in rec["losses_rec"]],
                    "ledger_states": (rec.get("ledger") or {}).get(
                        "states", {}),
                    "saves": rec.get("saves"),
                    "peak_bytes": rec.get("peak_bytes"),
                    "done": "result" in rec}
        spans = _agent_spans(ckpt_dir)
        new_agent = [s for s in spans if s.get("pid") == procs[1, 1].pid]
        ring = [s for s in new_agent if s["name"] == "agent:replica-restore"]
        backups = [dict(s["attrs"], s=s["dur_s"],
                        node=0 if s.get("pid") == procs[0, 0].pid else 1)
                   for s in spans if s["name"] == "agent:replica-backup"]
        with open(logs[1, 1], errors="replace") as f:
            new_log = f.read()
        line = f"replica restore: staged step {lose_after} recovered"
        split = None
        if launches["r1_1"]["done"]:
            split = _node_split(kill_t, new_agent, _read_marker(
                markers, "r1_1"))
        return {
            "jobs": jobs, "rcs": rcs, "wall_s": wall_s,
            "max_steps": max_steps, "save_steps": save_steps,
            "stage_steps": stage_steps, "lose_after": lose_after,
            "pause_step": pause,
            "committed_step": committed(),
            "backed_up_wait_s": backed_up_wait_s,
            "staged_step_at_loss": staged, "segment_unlinked": segment_gone,
            "launches": launches,
            "ring_restore": [{"step": s["attrs"].get("step"),
                              "holder": s["attrs"].get("holder"),
                              "s": s["dur_s"]} for s in ring],
            "ring_restore_logged": line in new_log,
            "backups": backups, "split": split,
        }
    except Exception as e:
        raise RuntimeError(f"node-loss drill failed: {e}\n"
                           f"{_log_tails(root)}") from e
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
        # a worker that neither finished nor was killed by the drill (the
        # drill failed) leads its own process group, which its launcher's
        # end left running
        for path in glob.glob(os.path.join(markers, "start_r*.json")):
            tag = os.path.basename(path)[len("start_"):-len(".json")]
            if os.path.exists(os.path.join(markers, f"done_{tag}.json")):
                continue
            try:
                with open(path) as f:
                    os.killpg(json.load(f)["pid"], signal.SIGKILL)
            except (OSError, ValueError, KeyError):
                pass
        for job in jobs:
            SharedMemoryHandler(0, job).unlink()
        master.stop()
        shutil.rmtree(root, ignore_errors=True)


def node_loss_checks(r: Dict, reference: Dict[int, Dict[int, float]],
                     launches_per_step: int) -> Dict[str, bool]:
    """The drill's checks, by name: `reference` holds each rank's
    uninterrupted losses; `launches_per_step` the forward and fused
    backward launches a step (12 for GPT-2 on the card, 0 on the CPU,
    where the kernels' plain versions run)."""
    n = r["lose_after"]
    ls = r["launches"]
    out = {
        "launchers_exit_0": r["rcs"] == {0: 0, 1: 0},
        "last_step_committed": r["committed_step"] == str(r["max_steps"]),
        "node1_staged_the_lost_step": r["staged_step_at_loss"] == n,
        "node1_segment_unlinked": r["segment_unlinked"],
        "ring_restore_spanned": [(x["step"], x["holder"])
                                 for x in r["ring_restore"]] == [(n, 0)],
        "ring_restore_logged": r["ring_restore_logged"],
        "node1_resumed_from_shm": (ls["r1_1"]["start_step"],
                                   ls["r1_1"]["tier"]) == (n, "shm"),
        "node1_read_no_storage": ls["r1_1"]["ledger_states"].get(
            "restore_storage", 0.0) == 0.0,
        "node0_resumed_from_own_shm": (ls["r0_1"]["start_step"],
                                       ls["r0_1"]["tier"]) == (n, "shm"),
        "gloo_world_of_two": all((v["backend"], v["world"]) == ("gloo", 2)
                                 for v in ls.values()),
        "split_measured": r["split"] is not None,
    }
    bitwise = True
    for key, v in ls.items():
        want = [reference[v["rank"]].get(s) for s in v["steps"]]
        first = n + 1 if v["launch"] else 1
        bitwise = bitwise and v["losses"] == want and v["steps"] == list(
            range(first, first + len(v["steps"])))
        flash = {k: c for k, c in (v["launches"] or {}).items()
                 if k.startswith("flash_")}
        per = launches_per_step * len(v["steps"])
        out[f"{key}_launches"] = (
            flash.get("flash_attention_fwd") == per
            and flash.get("flash_attention_bwd_fused") == per
            and not any(c for k, c in flash.items() if k not in (
                "flash_attention_fwd", "flash_attention_bwd_fused")))
    out["every_loss_bitwise"] = bitwise
    out["ranks_differ"] = reference[0] != reference[1]
    return out


def _tail(path: str, n: int = 4000) -> str:
    with open(path, errors="replace") as f:
        return f.read()[-n:]


def _log_tails(root: str, n: int = 1500) -> str:
    """The end of every launcher's and worker's log under `root`."""
    out = []
    for path in sorted(glob.glob(os.path.join(root, "**", "*.log"),
                                 recursive=True)):
        out.append(f"--- {os.path.relpath(path, root)}\n{_tail(path, n)}")
    return "\n".join(out)


def _read_marker(markers: str, tag: str) -> Dict:
    """A generation's or launch's done marker, else its ready marker, else
    {}."""
    for kind in ("done", "ready"):
        path = os.path.join(markers, f"{kind}_{tag}.json")
        if os.path.exists(path):
            with open(path) as f:
                return json.load(f)
    return {}


if __name__ == "__main__":
    if sys.argv[1:2] == ["--node-loss"]:
        sys.exit(node_worker_main(sys.argv[2:]))
    sys.exit(worker_main())
