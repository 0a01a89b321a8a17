"""Chaos drills against the port.

Parity: four drills of dlrover_wuqiong_tpu/chaos.py, pointed at the port.

- `serve_drain` (:2914-3100): its master is the port's `JobMaster`,
  hosted in this process, and its decode workers are
  ``python -m dlrover_wuqiong_tpu_torch.serving`` subprocesses on
  ``device``.  The JAX drill's journal, group-commit and
  incident-timeline gates are left out: this drill's master is
  in-process and journal-less.
- `ckpt_corrupt` (:1364-1747): the checkpoint trust boundary's fault
  matrix on a live flash-checkpoint job (engine, in-process saver,
  replica ring), its state a torch tree on ``device`` and its resumed
  step a torch step there.  The JAX drill's last gate runs
  ``tools/ckpt_doctor.py``, which imports the JAX package; here the same
  verification (`checkpoint.integrity.verify_storage_step` over every
  generation, as the doctor walks them) runs in this process
  (`doctor_verdict`).
- `master_kill` (:1688-2025): ``python -m dlrover_wuqiong_tpu_torch.master``
  on a journal is SIGKILLed while a worker under the port's launcher
  trains a GPT on ``device`` from the shards the master hands out, and a
  successor replays the journal; every step's loss is held bitwise
  against an uninterrupted run (`master_kill_reference`), and the
  incident timeline is held live against offline.
- `master_failover` (:2030-2400): the same worker against a primary
  with a leadership lease and a warm standby tailing its journal; the
  primary is SIGKILLed, the standby promotes fenced, the revived corpse
  fences itself, and the timeline over both journals narrates the
  takeover.

The other drills (preempt, pod-kill, hot-swap, ...) come with items 7b
part 3 and 13.  The elastic trainer's SIGKILL drill under the port's
launcher is `trainer.drill.elastic_drill`, and its node-loss drill
through the replica ring `trainer.drill.node_loss_drill`.

    python -m dlrover_wuqiong_tpu_torch.chaos serve-drain [--device cpu]
    python -m dlrover_wuqiong_tpu_torch.chaos ckpt-corrupt [--device cpu]
    python -m dlrover_wuqiong_tpu_torch.chaos master-kill [--device cpu]
    python -m dlrover_wuqiong_tpu_torch.chaos master-failover [--device cpu]

prints each drill's one-line JSON report and exits 0 when ``ok``
(``master-kill`` and ``master-failover`` train GPT nano;
``model="gpt2"`` is GPT-2 124M, as chip_smoke.py's phases 10 and 11 run
them).
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Dict, List

from .common.log import get_logger

logger = get_logger("chaos")

#: how often the drill reads the master's summary: a nano decode on the
#: card finishes a request in tens of ms, and the kill must land while
#: some requests are done and others are leased
POLL_S = 0.01

#: the decode workers' geometry (2 slots, 2 fused tokens: the JAX drill's)
WORKER_SPEC = dict(max_slots=2, max_len=64, max_prompt_len=8,
                   fused_tokens=2)
#: the JAX drill's reference geometry (3 slots, 4 fused tokens)
JAX_REFERENCE_SPEC = dict(max_slots=3, max_len=64, max_prompt_len=8,
                          fused_tokens=4)


def drill_requests(n_requests: int, max_new_tokens: int) -> List:
    """The JAX drill's requests: short prompts, temperature 1.0, distinct
    seeds."""
    from .common import messages as msg

    return [msg.ServeRequest(
                request_id=f"req-{i:02d}",
                prompt=[1 + i, 7, 13, 2 + i][:3 + i % 2],
                max_new_tokens=max_new_tokens, temperature=1.0,
                seed=1000 + i, submitted_at=time.time())
            for i in range(n_requests)]


def alone_decode(reqs, spec: Dict, device, model_seed: int = 0
                 ) -> Dict[str, List[int]]:
    """Tokens of `reqs` decoded on a fresh local engine of geometry
    `spec`, over the worker's model (serving/__main__.py builds it the
    same way: GPTConfig.nano(), seeded on the CPU, then moved)."""
    from .models.gpt import GPTConfig, init_params
    from .serving import LocalServer, ServeSpec, ServingEngine

    cfg = GPTConfig.nano()
    params = init_params(cfg, model_seed, device="cpu")
    srv = LocalServer(ServingEngine(cfg, params, ServeSpec(**spec),
                                    device=device))
    for r in reqs:
        srv.submit(r.request_id, list(r.prompt),
                   max_new_tokens=r.max_new_tokens, seed=r.seed,
                   temperature=r.temperature)
    return srv.drain()


def trace_trees(ckpt_dir: str, request_ids: List[str]) -> Dict:
    """One trace tree per request, rebuilt from the flight dumps under
    `ckpt_dir`: {"complete": every request's trace holds serve:admit and
    serve:finish, "cross_generation": requests whose spans come from
    more than one process, "flight_dumps": dumps read, "first_span_wall":
    {pid: wall-clock start of that process's first span}}."""
    from .serving.scheduler import request_trace_id
    from .telemetry.recorder import load_flight_dumps

    dumps = load_flight_dumps(ckpt_dir)
    seen = set()  # (trace, span) — the ring re-flushes cumulatively
    names_by_trace: Dict = {}
    pids_by_trace: Dict = {}
    first: Dict = {}
    for d in dumps:
        for evt in d.get("events", []):
            if evt.get("kind") != "span":
                continue
            rec = evt.get("data", {})
            key = (rec.get("trace_id", ""), rec.get("span_id", ""))
            if key in seen:
                continue
            seen.add(key)
            tid = rec.get("trace_id", "")
            names_by_trace.setdefault(tid, set()).add(rec.get("name", ""))
            pids_by_trace.setdefault(tid, set()).add(rec.get("pid"))
            pid = rec.get("pid")
            first[pid] = min(first.get(pid, rec["t_wall"]), rec["t_wall"])
    complete = True
    cross = 0
    for rid in request_ids:
        tid = request_trace_id(rid)
        if not {"serve:admit", "serve:finish"} <= \
                names_by_trace.get(tid, set()):
            complete = False
        if len(pids_by_trace.get(tid, set())) > 1:
            cross += 1
    return {"complete": complete, "cross_generation": cross,
            "flight_dumps": len(dumps), "first_span_wall": first}


def serve_drain(n_requests: int = 8, max_new_tokens: int = 24,
                kill_after_done: int = 2, timeout: float = 300.0,
                device: str = "cuda") -> Dict:
    """SIGKILL a decode WORKER mid-traffic; drain to a replacement.

    Submits the requests to an in-process master, starts a worker
    subprocess, SIGKILLs it once some requests are done and others are
    leased, reports the failure (the master requeues the dead worker's
    leases), starts a second worker and drains.  Invariants, the JAX
    drill's:

    - zero dropped: every request gets exactly `max_new_tokens` tokens;
    - bit-identical: the results equal an alone-decode of the same
      (weights, prompt, seed) on a fresh engine of the workers' geometry
      (``bit_identical``); the JAX drill's other geometry (3 slots, 4
      fused tokens) is decoded too and its differing requests counted
      (``mismatched_jax_geometry``): on the card, cuBLAS picks its kernel
      by row count, so equality across slot counts is not promised there;
    - recovery is ATTRIBUTED: ``requeued_total`` > 0 in the serve
      summary, and it shows under the ``requeued`` counter;
    - one trace tree per request (serve:admit + serve:finish) rebuilt
      from the flight dumps of BOTH worker generations.

    ``recovery_s`` is the time from the SIGKILL to the master holding the
    last result; ``replacement_start_s``, of it, the time until the
    second worker's first span (its registration, once its model is
    built), from the flight dumps' wall clock.
    """
    from .agent.master_client import MasterClient
    from .master.master import JobMaster

    work = tempfile.mkdtemp(prefix="dwt-torch-servedrain-")
    # ONE flight-dump dir shared by both worker generations: the trace
    # reconstruction must join spans across the kill
    ckpt_dir = os.path.join(work, "ckpt")
    os.makedirs(ckpt_dir)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    master = JobMaster(port=0, host="127.0.0.1")
    master.start()
    addr = master.addr

    def spawn_worker(node_id: int):
        log = open(os.path.join(work, f"worker{node_id}.log"), "w")
        try:
            return subprocess.Popen(
                [sys.executable, "-m", "dlrover_wuqiong_tpu_torch.serving",
                 "--master", addr, "--node-id", str(node_id),
                 "--slots", str(WORKER_SPEC["max_slots"]),
                 "--max-len", str(WORKER_SPEC["max_len"]),
                 "--max-prompt-len", str(WORKER_SPEC["max_prompt_len"]),
                 "--fused-tokens", str(WORKER_SPEC["fused_tokens"]),
                 "--stats-every", "1", "--model-seed", "0",
                 "--ckpt-dir", ckpt_dir, "--device", device],
                env=env, cwd=work, stdout=log, stderr=subprocess.STDOUT)
        finally:
            log.close()

    report: Dict = {"scenario": "serve-drain", "requests": n_requests,
                    "max_new_tokens": max_new_tokens, "device": device,
                    "ok": False}
    workers = {}
    cli = None
    try:
        cli = MasterClient(addr, node_id=90, node_type="chaos")
        reqs = drill_requests(n_requests, max_new_tokens)
        report["accepted"] = cli.submit_serve_requests(reqs).accepted

        workers["w1"] = w1 = spawn_worker(1)
        # wait for MID-TRAFFIC: some requests done AND some leased (the
        # kill must land on held leases, or there is nothing to recover)
        deadline = time.monotonic() + timeout / 2
        done_at_kill = -1
        while time.monotonic() < deadline and w1.poll() is None:
            summ = cli.get_serve_summary()
            if summ.done_total >= kill_after_done and summ.leased > 0:
                done_at_kill = summ.done_total
                break
            time.sleep(POLL_S)
        report["done_at_kill"] = done_at_kill
        if not (0 <= done_at_kill < n_requests):
            report.update(w1_rc=w1.poll(),
                          error="never reached mid-traffic kill point")
            return report
        t_kill = time.monotonic()
        t_kill_wall = time.time()  # the flight dumps' spans are on it
        w1.kill()  # SIGKILL — admitted requests die with their slots
        w1.wait(timeout=10)
        logger.info("serve-drain: SIGKILLed worker pid=%d at done=%d",
                    w1.pid, done_at_kill)
        failed_cli = MasterClient(addr, node_id=1,
                                  node_type="serve-worker")
        try:
            failed_cli.report_failure("chaos serve-drain SIGKILL",
                                      level="process")
        finally:
            failed_cli.close()

        workers["w2"] = w2 = spawn_worker(2)
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline and w2.poll() is None:
            if cli.get_serve_summary().done_total >= n_requests:
                break
            time.sleep(POLL_S)
        report["recovery_s"] = time.monotonic() - t_kill
        resp = cli.get_serve_results([r.request_id for r in reqs])
        got = {r.request_id: [int(t) for t in r.tokens]
               for r in resp.results}
        summ = cli.get_serve_summary()
        report["results"] = len(got)
        report["requeued_total"] = summ.requeued_total
        report["requeued_counter"] = int(summ.counters.get("requeued", 0))
        report["zero_dropped"] = bool(
            len(got) == n_requests
            and all(len(t) == max_new_tokens for t in got.values()))
        # freeze the flight dumps before reading them: w2 re-flushes its
        # ring on every loop
        w2.kill()
        w2.wait(timeout=10)

        expected = alone_decode(reqs, WORKER_SPEC, device)
        mismatched = [rid for rid in expected if got.get(rid) != expected[rid]]
        report["bit_identical"] = not mismatched
        if mismatched:
            report["mismatched"] = mismatched[:4]
        other = alone_decode(reqs, JAX_REFERENCE_SPEC, device)
        report["mismatched_jax_geometry"] = sum(
            got.get(rid) != other[rid] for rid in other)

        trees = trace_trees(ckpt_dir, [r.request_id for r in reqs])
        report["flight_dumps"] = trees["flight_dumps"]
        report["trace_trees_complete"] = trees["complete"]
        # requests admitted by gen-1 and re-admitted by gen-2 join one
        # tree with spans from two pids (informational: lease timing
        # decides whether a killed request was already admitted)
        report["trace_trees_cross_generation"] = trees["cross_generation"]
        if w2.pid in trees["first_span_wall"]:
            report["replacement_start_s"] = \
                trees["first_span_wall"][w2.pid] - t_kill_wall

        report["ok"] = bool(
            report["zero_dropped"] and report["bit_identical"]
            and report["requeued_total"] > 0
            and report["requeued_counter"] > 0 and trees["complete"])
        return report
    finally:
        for p in workers.values():
            if p.poll() is None:
                p.kill()
            p.wait(timeout=10)
        if cli is not None:
            cli.close()
        master.stop()
        if report.get("ok"):
            shutil.rmtree(work, ignore_errors=True)
        else:
            tails = {}
            for name in ("worker1", "worker2"):
                path = os.path.join(work, f"{name}.log")
                if os.path.exists(path):
                    with open(path) as f:
                        tails[name] = f.read()[-2000:]
            report["worker_tails"] = tails
            report["workdir"] = work


# ----------------------------------------------------------- ckpt corrupt


_CKPT_CORRUPT_SAVER = r"""
import os, sys
import torch

from dlrover_wuqiong_tpu_torch.checkpoint.checkpointer import (
    FlashCheckpointer, StorageType)

ckpt_dir = sys.argv[1]
ck = FlashCheckpointer(ckpt_dir, job_name=os.environ["DWT_JOB_NAME"],
                       standalone=True)
ck.save_checkpoint(2, {"w": torch.full((16, 16), 2.0),
                       "step": torch.tensor(2, dtype=torch.int64)},
                   storage_type=StorageType.DISK)
assert ck.wait_latest_checkpoint(60)
# arm the crash: the NEXT persist hard-exits right after the shard file
# write, before meta/manifest — the SIGKILL-mid-persist moment
os.environ["DWT_CKPT_CRASH_POINT"] = "after-bin"
ck.save_checkpoint(4, {"w": torch.full((16, 16), 4.0),
                       "step": torch.tensor(4, dtype=torch.int64)},
                   storage_type=StorageType.DISK)
ck.wait_latest_checkpoint(60)  # unreachable: the saver dies mid-persist
"""

_drill_seq = 0


def _drill_job(prefix: str) -> str:
    """A job name of this process's own (segments and sockets are named
    by it)."""
    global _drill_seq
    _drill_seq += 1
    return f"{prefix}{os.getpid()}n{_drill_seq}"


def doctor_verdict(ckpt_dir: str) -> Dict:
    """What ``tools/ckpt_doctor.py`` reports of a checkpoint directory,
    through the port's own integrity module: every generation verified
    against its manifest, newest first, and the rc the doctor would
    exit with (1 when any fails)."""
    from .checkpoint.integrity import verify_storage_step
    from .common.constants import CheckpointConstant
    from .common.storage import get_checkpoint_storage

    storage = get_checkpoint_storage(path_hint=ckpt_dir)
    prefix = CheckpointConstant.CKPT_NAME_PREFIX
    steps = sorted((int(n[len(prefix):]) for n in storage.listdir(ckpt_dir)
                    if n.startswith(prefix)
                    and n[len(prefix):].isdigit()), reverse=True)
    gens = []
    for s in steps:
        v = verify_storage_step(storage, ckpt_dir, s)
        gens.append({"step": s, "ok": v["ok"], "reason": v["reason"]})
    ok = bool(gens) and all(g["ok"] for g in gens)
    return {"rc": 0 if ok else 1, "generations": gens,
            "flagged_steps": [g["step"] for g in gens if not g["ok"]]}


def ckpt_corrupt(timeout: float = 180.0, device: str = "cuda") -> Dict:
    """Checkpoint trust-boundary drill: the full corruption fault matrix.

    Runs a live flash-checkpoint job (engine + in-process async saver +
    replica ring), commits generations {2, 4, 6}, then injects each fault
    and asserts three invariants per case: (1) zero silent restores — the
    corruption is DETECTED (it appears in the restore report's fallbacks,
    or the torn generation is invisible by construction); (2) the
    restore selects the best healthy tier and the resumed state, and one
    step taken from it on `device`, are BIT-IDENTICAL to the uncorrupted
    baseline for the step it claims; (3) after a degraded restore the
    recovered state is re-staged into shm (self-heal), so the next load
    takes the fast tier again.

    Faults: flipped byte in shm; flipped byte in storage; truncated
    shard file; missing manifest; stale-generation-only; corrupt replica
    blob (falls through to storage); SIGKILL mid-persist (subprocess
    saver hard-killed between shard write and manifest publish — restore
    falls back to generation N-1 and the doctor's verification flags the
    torn dir).

    The drill also proves the telemetry contract: a degraded restore
    must reconstruct as ONE trace tree (`ckpt:restore` root + per-tier
    children) from a flight-recorder dump alone, and the goodput ledger
    must carry nonzero `restore_replica`/`restore_storage` credits.
    """
    import glob as _glob

    import torch

    from . import resolve_device
    from .checkpoint.checkpointer import FlashCheckpointer, StorageType
    from .checkpoint.ckpt_saver import AsyncCheckpointSaver
    from .checkpoint.integrity import QUARANTINE_DIR
    from .checkpoint.replica import CkptReplicaManager, ReplicaServer
    from .common.constants import CheckpointConstant
    from .telemetry.ledger import get_ledger
    from .telemetry.recorder import get_recorder, load_flight_dumps

    dev = resolve_device(device)
    work = tempfile.mkdtemp(prefix="dwt-chaos-ckptcorrupt-")
    job = _drill_job("ckc")
    ckpt_dir = os.path.join(work, "ckpt")
    cases: List[Dict] = []
    report: Dict = {"scenario": "ckpt-corrupt", "device": str(dev),
                    "cases": cases}

    def expected(step):
        return {"w": torch.full((16, 16), float(step), device=dev),
                "step": torch.tensor(step, dtype=torch.int64, device=dev)}

    def resume_step(w):
        # one deterministic "training step" — bit-identical resume means
        # this produces equal bits from restored vs. baseline
        return w * 1.0001 + 1.0

    def check(name, restored, rep, want_step, want_tier, extra_ok=True):
        exp = expected(want_step)
        identical = bool(
            restored is not None
            and torch.equal(restored["w"], exp["w"])
            and int(restored["step"]) == want_step
            and torch.equal(resume_step(restored["w"]),
                            resume_step(exp["w"])))
        case = {"fault": name, "tier": rep.get("tier"),
                "step": rep.get("step"),
                "fallbacks": rep.get("fallbacks", []),
                "healed": rep.get("healed", False),
                "bit_identical": identical,
                "ok": bool(identical and rep.get("tier") == want_tier
                           and rep.get("step") == want_step and extra_ok)}
        cases.append(case)
        return case["ok"]

    def template():
        return {"w": torch.zeros((16, 16), device=dev),
                "step": torch.tensor(0, dtype=torch.int64, device=dev)}

    AsyncCheckpointSaver.reset()
    srv = ReplicaServer(host="127.0.0.1")
    srv.start()
    mgr = None
    ck = None
    try:
        addr = f"127.0.0.1:{srv.port}"
        # rank 1 is the REMOTE peer holding our backups (rank 0 itself
        # has no server entry: the ring walk refuses to ship a segment
        # back to its creator's own address)
        mgr = CkptReplicaManager(rank=0, peers={1: addr},
                                 job_name=job, replica_count=1)
        ck = FlashCheckpointer(ckpt_dir, job_name=job, standalone=True,
                               replica_fetch=mgr.restore)
        for s in (2, 4, 6):
            ck.save_checkpoint(s, expected(s),
                               storage_type=StorageType.DISK)
            if not ck.wait_latest_checkpoint(60):
                raise RuntimeError(f"commit of step {s} timed out")
        mgr.backup()  # peer now holds the verified step-6 segment

        shm = ck.engine._shm_handler  # noqa: SLF001 — drill injects faults

        def flip_shm():
            buf = shm._buf.buf  # noqa: SLF001
            buf[1 << 20] = (buf[1 << 20] + 1) % 256

        # --- 1) flipped byte in shm, valid replica -> replica tier serves
        flip_shm()
        restored = ck.load_checkpoint(template())
        rep = ck.last_restore_report
        ok1 = check("shm-flip->replica", restored, rep, 6, "replica",
                    extra_ok=any(f["tier"] == "shm"
                                 for f in rep["fallbacks"]))
        # self-heal: the fetched segment re-verifies, next load is shm
        restored = ck.load_checkpoint(template())
        ok1 = ok1 and ck.last_restore_report["tier"] == "shm"
        cases[-1]["ok"] = ok1

        # --- 2) flipped byte in shm AND in the replica blob -> storage
        flip_shm()
        with srv._lock:  # noqa: SLF001 — corrupt the held backup
            step6, blob = srv._store[0]  # noqa: SLF001
            bad = bytearray(blob)
            bad[1 << 20] ^= 0xFF
            srv._store[0] = (step6, bytes(bad))  # noqa: SLF001
        restored = ck.load_checkpoint(template())
        rep = ck.last_restore_report
        check("shm+replica-flip->storage", restored, rep, 6, "storage",
              extra_ok=(any(f["tier"] == "shm" for f in rep["fallbacks"])
                        and rep["healed"]))

        # --- 3) flipped byte in the newest storage generation
        shm.mark_empty()
        bin6 = _glob.glob(os.path.join(
            ckpt_dir, "checkpoint-6", "shards_rank*.bin"))[0]
        with open(bin6, "rb") as f:
            raw = bytearray(f.read())
        raw[64] ^= 0x01
        with open(bin6, "wb") as f:
            f.write(raw)
        restored = ck.load_checkpoint(template())
        rep = ck.last_restore_report
        qdir = os.path.join(ckpt_dir, QUARANTINE_DIR)
        check("storage-flip->older-gen", restored, rep, 4, "storage",
              extra_ok=(any(f.get("step") == 6 and f.get("quarantined")
                            for f in rep["fallbacks"])
                        and os.path.isdir(qdir)))

        # --- 4) truncated shard file in the (now newest) generation
        shm.mark_empty()
        bin4 = _glob.glob(os.path.join(
            ckpt_dir, "checkpoint-4", "shards_rank*.bin"))[0]
        with open(bin4, "rb+") as f:
            f.truncate(100)
        restored = ck.load_checkpoint(template())
        rep = ck.last_restore_report
        check("truncated-leaf->older-gen", restored, rep, 2, "storage",
              extra_ok=any(f.get("reason") == "truncated-shard-file"
                           for f in rep["fallbacks"]))

        # --- 5) missing manifest on a committed generation
        shm.mark_empty()
        # rebuild a fresh committed gen 8, then rip its manifest out
        ck.save_checkpoint(8, expected(8), storage_type=StorageType.DISK)
        if not ck.wait_latest_checkpoint(60):
            raise RuntimeError("commit of step 8 timed out")
        shm.mark_empty()
        os.remove(os.path.join(ckpt_dir, "checkpoint-8", "manifest.json"))
        restored = ck.load_checkpoint(template())
        rep = ck.last_restore_report
        check("missing-manifest->older-gen", restored, rep, 2, "storage",
              extra_ok=any(f.get("reason") == "missing-manifest"
                           for f in rep["fallbacks"]))

        # --- 6) stale generation only: tracker names a vanished gen,
        # only an OLDER committed generation survives on storage
        shm.mark_empty()
        shutil.rmtree(os.path.join(ckpt_dir, "checkpoint-2"))
        ck.save_checkpoint(1, expected(1), storage_type=StorageType.DISK)
        # wait on the generation's OWN manifest: the tracker still says 2
        # (repointed by the earlier quarantine), so the step-agnostic
        # wait_latest_checkpoint would return before the persist lands
        manifest1 = os.path.join(ckpt_dir, "checkpoint-1", "manifest.json")
        deadline = time.monotonic() + 60
        while not os.path.exists(manifest1) and \
                time.monotonic() < deadline:
            time.sleep(0.05)
        if not os.path.exists(manifest1):
            raise RuntimeError("step-1 persist never committed")
        shm.mark_empty()
        # the drill forges a stale tracker on purpose
        with open(os.path.join(ckpt_dir,
                               CheckpointConstant.TRACKER_FILE), "w") as f:
            f.write("2")  # retention ate checkpoint-2; tracker is stale
        restored = ck.load_checkpoint(template())
        rep = ck.last_restore_report
        check("stale-generation-only", restored, rep, 1, "storage",
              extra_ok=any(f.get("reason") == "missing-generation"
                           for f in rep["fallbacks"]))
    finally:
        if ck is not None:
            try:
                ck.close()
            except Exception:  # noqa: BLE001
                pass
        AsyncCheckpointSaver.reset()
        if mgr is not None:
            mgr.close()
        srv.stop()

    # flight recorder: every restore above recorded a `ckpt:restore`
    # span with per-tier children (telemetry/spans.py via engine.load).
    # Flush the ring next to the checkpoints and prove a DEGRADED
    # restore reconstructs as one trace tree from the dump alone —
    # root + >1 distinct tier children sharing its trace_id/span_id.
    get_recorder().flush(ckpt_dir, "drill")
    dumps = load_flight_dumps(ckpt_dir)
    spans = [e["data"] for d in dumps for e in d.get("events", [])
             if e.get("kind") == "span"]
    roots = [s for s in spans if s.get("name") == "ckpt:restore"]
    trees = 0
    for root in roots:
        tiers = {s["name"] for s in spans
                 if s.get("trace_id") == root.get("trace_id")
                 and s.get("parent_span") == root.get("span_id")
                 and s.get("name", "").startswith("ckpt:restore:")}
        if len(tiers) > 1 and root.get("attrs", {}).get("fallbacks", 0):
            trees += 1
    led_states = get_ledger().snapshot()["states"]
    report["flight"] = {
        "dumps": len(dumps), "restore_spans": len(roots),
        "degraded_trace_trees": trees,
        "ledger": {k: round(led_states.get(k, 0.0), 4)
                   for k in ("restore_shm", "restore_replica",
                             "restore_storage")},
    }
    flight_ok = bool(dumps and trees > 0
                     and led_states.get("restore_replica", 0.0) > 0
                     and led_states.get("restore_storage", 0.0) > 0)

    # --- 7) SIGKILL mid-persist (subprocess saver, crash between shard
    # write and manifest publish) -> restore serves generation N-1.  The
    # subprocess stages host tensors, as the JAX drill's runs on the CPU
    sub_work = os.path.join(work, "midpersist")
    os.makedirs(sub_work)
    sub_ckpt = os.path.join(sub_work, "ckpt")
    sub_job = _drill_job("ckm")
    env = dict(os.environ, DWT_JOB_NAME=sub_job,
               DWT_SOCKET_DIR=os.path.join(sub_work, "sockets"),
               PYTHONPATH=os.path.dirname(os.path.dirname(
                   os.path.abspath(__file__))) + os.pathsep +
               os.environ.get("PYTHONPATH", ""))
    env.pop("DWT_MASTER_ADDR", None)
    script = os.path.join(sub_work, "saver.py")
    with open(script, "w") as f:
        f.write(_CKPT_CORRUPT_SAVER)
    proc = subprocess.run([sys.executable, script, sub_ckpt], env=env,
                          cwd=sub_work, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True,
                          timeout=timeout)
    AsyncCheckpointSaver.reset()
    ck2 = FlashCheckpointer(sub_ckpt, job_name=_drill_job("ckv"),
                            standalone=True)
    try:
        restored = ck2.load_checkpoint(template())
        rep = ck2.last_restore_report
        # the dead saver's shm segment must have been reaped on startup
        # (stale-segment sweeper) — its creator pid is gone
        swept = not os.path.exists(f"/dev/shm/{sub_job}_ckpt_shm_0")
        torn_dir = os.path.join(sub_ckpt, "checkpoint-4")
        torn_detectable = (os.path.isdir(torn_dir) and not os.path.exists(
            os.path.join(torn_dir, "manifest.json")))
        identical = bool(
            restored is not None
            and torch.equal(restored["w"],
                            torch.full((16, 16), 2.0, device=dev))
            and int(restored["step"]) == 2)
        cases.append({
            "fault": "sigkill-mid-persist", "tier": rep.get("tier"),
            "step": rep.get("step"), "saver_rc": proc.returncode,
            "bit_identical": identical, "swept_stale_shm": swept,
            "torn_gen_detectable": torn_detectable,
            "ok": bool(proc.returncode == 137 and identical
                       and rep.get("step") == 2 and swept
                       and torn_detectable)})
    finally:
        ck2.close()
        AsyncCheckpointSaver.reset()

    # the doctor's verification must independently flag the torn
    # generation
    verdict = doctor_verdict(sub_ckpt)
    report["doctor"] = {"rc": verdict["rc"],
                        "flagged_steps": verdict["flagged_steps"]}
    doctor_ok = verdict["rc"] == 1 and 4 in verdict["flagged_steps"]

    report["silent_restores"] = sum(
        1 for c in cases if not c.get("bit_identical"))
    report["ok"] = bool(all(c["ok"] for c in cases) and doctor_ok
                        and flight_ok and len(cases) == 7)
    if report["ok"]:
        shutil.rmtree(work, ignore_errors=True)
    else:
        report["workdir"] = work
        if proc.stdout:
            report["saver_tail"] = proc.stdout[-1500:]
    return report


# -------------------------------------------------------------- master kill

#: the drill's dataset geometry by model: on the card GPT-2 124M at
#: B = 8, T = 1024, 768 samples in 3 shards of 32 minibatches (the kill
#: lands mid-shard 2, whose 28 steps left outlast the outage); on the
#: CPU GPT nano at the JAX drill's 576 samples, B = 4 and 24 minibatches
#: a shard
MASTER_KILL = {
    "gpt2": dict(dataset_size=768, batch=8, minibatches=32, seq=1024),
    "nano": dict(dataset_size=576, batch=4, minibatches=24, seq=128),
}
#: the seed of every sample's tokens and of the model's weights
MASTER_KILL_SEED = 0
#: the master dies after this fetch and this many of its steps: the
#: worker is then provably mid-shard through the outage
KILL_AFTER_FETCHES, KILL_AFTER_STEPS = 2, 4


def master_kill_trainer(model: str, device):
    """The drill's trainer: ``auto_accelerate(GPT(cfg with remat=False),
    optimizer=adamw(3e-4), seed=0)`` on `device`."""
    from .auto.accelerate import auto_accelerate
    from .models.gpt import GPT
    from .trainer.drill import gpt_config
    from .trainer.train_step import adamw

    return auto_accelerate(GPT(gpt_config(model)), optimizer=adamw(3e-4),
                           device=device, seed=MASTER_KILL_SEED)


def sample_batch(indices, model: str, seq: int) -> Dict:
    """Host batch of the samples `indices`: each sample is one row of
    ``seq + 1`` tokens drawn with numpy from (seed, sample index), so a
    sample is the same wherever and whenever it is trained."""
    import numpy as np

    from .trainer.drill import VOCAB

    x = np.stack([np.random.default_rng([MASTER_KILL_SEED, int(i)]).integers(
        0, VOCAB[model], seq + 1, dtype=np.int64) for i in indices])
    return {"input_ids": x[:, :-1], "labels": x[:, 1:]}


def train_on(res, indices, model: str, seq: int) -> float:
    """One train step on the samples `indices`; the loss, read back."""
    res.state, m = res.train_step(res.state, res.place_batch(
        sample_batch(indices, model, seq)))
    return float(m["loss"])


def master_kill_reference(model: str = "nano", device: str = "cuda"
                          ) -> Dict:
    """The uninterrupted run the drill is held to: the same trainer in
    this process over the sample ranges [0, dataset_size) of
    `MASTER_KILL[model]` in order, `batch` samples a step.  Returns
    {"losses": each step's loss as ``float.hex()``, "step_s": the median
    step's seconds, "steps_s": every step's}."""
    from .telemetry.serving import _percentile

    dataset_size, batch, seq = (MASTER_KILL[model][k] for k in
                                ("dataset_size", "batch", "seq"))
    res = master_kill_trainer(model, device)
    losses, steps_s = [], []
    for start in range(0, dataset_size - batch + 1, batch):
        t0 = time.monotonic()
        loss = train_on(res, range(start, start + batch), model, seq)
        steps_s.append(time.monotonic() - t0)
        losses.append(loss.hex())
    del res
    return {"losses": losses, "steps_s": steps_s,
            "step_s": _percentile(steps_s, 0.5)}


_MASTER_KILL_WORKER = r"""
import json, os, sys, time

(marker_dir, ckpt_dir, model, device, dataset_size, batch, minibatches,
 seq) = (sys.argv[1], sys.argv[2], sys.argv[3], sys.argv[4],
         int(sys.argv[5]), int(sys.argv[6]), int(sys.argv[7]),
         int(sys.argv[8]))
from dlrover_wuqiong_tpu_torch import chaos
from dlrover_wuqiong_tpu_torch.ops import flash_attention as tfa
from dlrover_wuqiong_tpu_torch.ops import quantization as tq
from dlrover_wuqiong_tpu_torch.telemetry import spans as tspans
from dlrover_wuqiong_tpu_torch.telemetry.ledger import get_ledger
from dlrover_wuqiong_tpu_torch.telemetry.recorder import get_recorder
from dlrover_wuqiong_tpu_torch.trainer.elastic import init_elastic

ctx = init_elastic()
restart = ctx.world.restart_count
# the outage's cost surfaces in the GOODPUT LEDGER: master_client
# credits `degraded` for every second a verb burned blocked on the dead
# master, while training through the outage stays `productive`
led = get_ledger()
led.start()
with open(os.path.join(marker_dir, f"start_r{restart}"), "w") as f:
    f.write(str(os.getpid()))
res = chaos.master_kill_trainer(model, device)
tfa.reset_launches()
tq.reset_launches()
# dynamic sharding straight off the master: every fetched range, every
# step's loss and every completed range is logged so the drill can prove
# the journal replayed EXACTLY (no range lost, none handed out twice)
sc = ctx.sharding_client("chaos-mk", batch_size=batch,
                         dataset_size=dataset_size,
                         num_minibatches_per_shard=minibatches)
log = open(os.path.join(marker_dir, "shards.log"), "a")
step = 0
while True:
    task = sc.fetch_shard(wait=True, timeout=120.0)
    if task is None:
        break
    log.write(f"fetch {time.time():.6f} {task.task_id} "
              f"{task.shard.start} {task.shard.end}\n")
    log.flush()
    idx = task.shard.indices or list(range(task.shard.start,
                                           task.shard.end))
    for i in range(len(idx) // batch):
        with led.window("productive"):
            loss = chaos.train_on(res, idx[i * batch:(i + 1) * batch],
                                  model, seq)
        step += 1
        # per-step heartbeat: these are the frames that must buffer (not
        # block, not crash) while the master is dead, then drain
        ctx.mc.report_heart_beat(step)
        log.write(f"step {time.time():.6f} {step} {loss.hex()}\n")
        log.flush()
    sc.report_shard_done(task.task_id)
    log.write(f"done {time.time():.6f} {task.task_id} "
              f"{task.shard.start} {task.shard.end}\n")
    log.flush()
# the host time of the journaled task verbs, from this process's spans
rpc = [{"msg": r["attrs"].get("msg"), "t_wall": r["t_wall"],
        "dur_s": r["dur_s"]} for r in tspans.spans_snapshot()
       if r["name"].startswith("rpc:")
       and r["attrs"].get("msg") in ("TaskRequest", "TaskResult")]
stats = ctx.mc.degraded_stats()
ledger = led.snapshot()
# the flight dump carries this worker's ledger and spans into the
# incident timeline the drill gates on (telemetry/timeline.py)
get_recorder().flush(ckpt_dir, "drill-end")
with open(os.path.join(marker_dir, "done.tmp"), "w") as f:
    json.dump({"steps": step, "stats": stats, "ledger": ledger,
               "launches": {**tfa.LAUNCHES, **tq.LAUNCHES},
               "rpc": rpc}, f)
os.replace(os.path.join(marker_dir, "done.tmp"),
           os.path.join(marker_dir, "done"))
"""


def _replay_line(log_path: str) -> Dict:
    """The replay the master logged: {"frames", "seconds"}."""
    import re

    try:
        with open(log_path) as f:
            text = f.read()
    except OSError:
        return {}
    m = re.search(r"journal replay: snapshot=\w+ \+ (\d+) events "
                  r"\(last epoch \d+\) in ([0-9.]+) s", text)
    return {"frames": int(m.group(1)), "seconds": float(m.group(2))} \
        if m else {}


def worker_goodput(stamps: List[float], n_steps: int,
                   outage: tuple) -> tuple:
    """(ideal step s, wall-clock goodput) of the drill worker.

    The ideal step is the median interval between the worker's own
    consecutive step stamps, leaving out every interval that touches the
    outage ``(t0, t1)`` (wall clock, as the stamps): the same process,
    the same card and the same moment as the steps it is held to, where
    a reference run elsewhere drifts with what ran before it.  The
    goodput is ``n_steps`` ideal steps over the span of the stamps plus
    one ideal step."""
    from .telemetry.serving import _percentile

    t0, t1 = outage
    gaps = [b - a for a, b in zip(stamps, stamps[1:])
            if b < t0 or a > t1]
    if not gaps:
        return 0.0, 0.0
    ideal = _percentile(gaps, 0.5)
    return ideal, n_steps * ideal / (max(stamps) - min(stamps) + ideal)


def _shards_log(path: str) -> tuple:
    """(fetched ranges, completed ranges, step stamps, step losses as
    ``float.hex()``) from the worker's shards.log."""
    fetched, completed, stamps, losses = [], [], [], []
    try:
        with open(path) as f:
            for ln in f:
                parts = ln.split()
                if parts[0] == "fetch":
                    fetched.append((int(parts[3]), int(parts[4])))
                elif parts[0] == "done":
                    completed.append((int(parts[3]), int(parts[4])))
                elif parts[0] == "step":
                    stamps.append(float(parts[1]))
                    losses.append(parts[3])
    except OSError:
        pass
    return fetched, completed, stamps, losses


def _tiled(fetched, completed, dataset_size: int) -> bool:
    """Completed ranges cover [0, dataset_size) once, as many fetched."""
    covered = sorted(completed)
    return bool(covered and covered[0][0] == 0
                and covered[-1][1] == dataset_size
                and sum(e - s for s, e in covered) == dataset_size
                and all(covered[i][1] == covered[i + 1][0]
                        for i in range(len(covered) - 1))
                and len(fetched) == len(completed))


def _wait_shards(shards_log: str, cli, deadline_s: float) -> bool:
    """Wait until the worker is mid-shard: after fetch
    `KILL_AFTER_FETCHES` and `KILL_AFTER_STEPS` of its steps."""
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline and cli.poll() is None:
        try:
            with open(shards_log) as f:
                lines = f.read().splitlines()
        except OSError:
            lines = []
        fetches = [i for i, ln in enumerate(lines)
                   if ln.startswith("fetch ")]
        if len(fetches) >= KILL_AFTER_FETCHES and sum(
                1 for ln in lines[fetches[KILL_AFTER_FETCHES - 1]:]
                if ln.startswith("step ")) >= KILL_AFTER_STEPS:
            return True
        time.sleep(0.005)
    return False


def _wait_up(addr: str, deadline_s: float) -> bool:
    from .common.comm import addr_connectable

    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        if addr_connectable(addr, timeout=0.2):
            return True
        time.sleep(0.02)
    return False


def _worker_report(report: Dict, marker: str, reference: Dict,
                   dataset_size: int, outage: tuple) -> Dict:
    """The worker-side invariants both master drills share; returns the
    worker's done payload."""
    report["worker_generations"] = sum(
        1 for f in os.listdir(marker) if f.startswith("start_r"))
    done_path = os.path.join(marker, "done")
    report["completed"] = os.path.exists(done_path)
    payload: Dict = {}
    if report["completed"]:
        with open(done_path) as f:
            payload = json.load(f)
    stats = payload.get("stats", {})
    report["degraded"] = stats
    led = payload.get("ledger", {})
    states = led.get("states", {})
    report["ledger"] = {
        "degraded_s": float(states.get("degraded", 0.0)),
        "productive_s": float(states.get("productive", 0.0)),
        "goodput_fraction": float(led.get("goodput_fraction", 0.0))}
    report["launches"] = payload.get("launches", {})
    fetched, completed, stamps, losses = _shards_log(
        os.path.join(marker, "shards.log"))
    report["shards_fetched"] = len(fetched)
    report["shards_completed"] = len(completed)
    report["no_shard_lost_or_double"] = _tiled(fetched, completed,
                                               dataset_size)
    report["steps"] = len(losses)
    report["steps_in_outage"] = sum(
        1 for t in stamps if outage[0] <= t <= outage[1])
    ref = reference["losses"]
    report["losses_bitwise"] = losses == ref
    if losses != ref:
        report["first_loss_mismatch"] = next(
            (i for i, (a, b) in enumerate(zip(losses, ref)) if a != b),
            min(len(losses), len(ref)))
    report["ideal_step_s"], report["goodput_wall"] = worker_goodput(
        stamps, len(ref), outage)
    report["reference_step_s"] = reference["step_s"]
    report["heartbeats_buffered"] = stats.get("buffered_total", 0)
    report["buffer_drained"] = (stats.get("pending", 1) == 0
                                and stats.get("dropped_total", 1) == 0)
    report["reregistered"] = stats.get("reregistrations", 0) >= 1
    return payload


def live_timeline(addr: str, ckpt_dir: str, journal_dirs: List[str]
                  ) -> tuple:
    """(live TimelineResponse, the offline report, byte-equal) for the
    master at `addr` over ``journal_dirs`` (its own first) and the
    flight dumps under `ckpt_dir`.  A leader with a lease appends a
    frame every ttl / 3, so the offline assembly runs before and after
    the query and the two are compared only when no frame landed in
    between."""
    from .agent.master_client import MasterClient
    from .telemetry import timeline as tl

    mc = MasterClient(addr, node_id=-1, outage_grace_s=5.0)
    try:
        for _ in range(5):
            before = tl.assemble_incident(
                journal_dir=journal_dirs[0], ckpt_dir=ckpt_dir,
                journal_dirs=journal_dirs[1:])
            live = mc.get_timeline(ckpt_dir=ckpt_dir,
                                   journal_dirs=journal_dirs[1:])
            after = tl.assemble_incident(
                journal_dir=journal_dirs[0], ckpt_dir=ckpt_dir,
                journal_dirs=journal_dirs[1:])
            if tl.incident_json(before) == tl.incident_json(after):
                break
    finally:
        mc.close()
    return live, after, live.content == tl.incident_json(after)


def _causal(offline: Dict, standby_dir: str = "",
            primary_dir: str = "") -> bool:
    """Every journal event once, in (epoch, seq) order: JAX's gate.

    After a failover (`standby_dir` and the old `primary_dir` given) one
    collision is allowed: the old primary's durable but unshipped tail,
    at the ``failover`` frame's ``from_epoch`` and above its
    ``last_shipped_seq``, shares an (epoch, seq) with the standby's
    ``failover`` frame.  Any other shared (epoch, seq), a divergence
    inside the mirrored prefix among them, fails."""
    from .telemetry import timeline as tl

    jevents = [e for e in offline["events"]
               if e["source"] == "journal" and e["kind"] != "flush"]
    jkeys = [(e["epoch"], e["seq"]) for e in jevents]
    if jkeys != sorted(jkeys) or \
            len(jkeys) != offline["counts"]["journal_events"]:
        return False
    if len(jkeys) == len(set(jkeys)):
        return True
    if not (standby_dir and primary_dir):
        return False
    standby = tl.read_journal_events(standby_dir)
    failovers = [e for e in standby if e["kind"] == "failover"]
    if len(failovers) != 1:
        return False
    fo = failovers[0]
    fo_key = (fo["epoch"], fo["seq"], "failover")
    mirror = {(e["epoch"], e["seq"], e["kind"]) for e in standby}
    corpse = {(e["epoch"], e["seq"], e["kind"])
              for e in tl.read_journal_events(primary_dir)}
    groups: Dict[tuple, List[tuple]] = {}
    for e in jevents:
        groups.setdefault((e["epoch"], e["seq"]), []).append(
            (e["epoch"], e["seq"], e["kind"]))
    for (epoch, seq), keys in groups.items():
        if len(keys) == 1:
            continue
        if len(keys) != 2 or fo_key not in keys \
                or epoch != int(fo["data"]["from_epoch"]) \
                or seq <= int(fo["data"]["last_shipped_seq"]):
            return False
        (tail,) = [k for k in keys if k != fo_key]
        if tail not in corpse or tail in mirror:
            return False
    return True


def master_kill(model: str = "nano", device: str = "cuda",
                outage_s: float = 1.5, target: float = 0.5,
                timeout: float = 240.0, reference: Dict = None) -> Dict:
    """SIGKILL the job MASTER mid-shard; restart it on the same journal.

    Parity: dlrover_wuqiong_tpu/chaos.py `master_kill` (:1748-2025), on
    the port: ``python -m dlrover_wuqiong_tpu_torch.master`` journals
    every control-plane mutation, ``python -m dlrover_wuqiong_tpu_torch.run
    --nnodes=1`` dials it and runs the drill's worker, which trains the
    drill's GPT (`master_kill_trainer`) on `device` on the shards the
    master hands out (`MASTER_KILL[model]`); after fetch
    `KILL_AFTER_FETCHES` and `KILL_AFTER_STEPS` of its steps the master
    is SIGKILLed and, after
    `outage_s`, a new one starts on the same journal and port.  Where the
    JAX drill's step is a sleep, each step here trains on the samples
    the shard names, and each step's loss is held bitwise against
    `reference` (`master_kill_reference`, run in this process when not
    given): only an exact replay hands out the same ranges in the same
    order.  Invariants, the JAX drill's:

    - the worker never crashes or restarts (one generation), and the
      launcher exits 0;
    - dataset ranges tile exactly, with as many fetched as completed;
    - training steps land inside the outage (heartbeats buffer);
    - the heartbeat buffer drains after reconnect, and the client saw
      the fencing epoch reach 2 and re-registered;
    - the worker's goodput ledger shows `degraded` > 0 and `productive`
      > 0;
    - the wall-clock goodput is at least `target` and at most 1, its
      ideal step the worker's own (`worker_goodput`);
    - the restarted master runs the group-commit journal;
    - the incident timeline: the live `TimelineQuery` answer of the
      restarted master is byte-equal to the offline assembly over its
      journal and the worker's flight dump (``timeline_byte_equal``),
      every journal event appears once in (epoch, seq) order
      (``timeline_causal``) across epochs [1, 2], the narrative's
      degraded seconds agree with the worker's ledger within 0.05 s
      (``timeline_attribution_ok``), and the offline CLI
      (``python -m dlrover_wuqiong_tpu_torch.telemetry.incident_report``)
      hashes to the live bytes (``incident_report_sha_match``).

    The report also carries the measured outage, the restart gap (spawn,
    imports and replay until the new master answers), the frames and
    seconds of the replay (from the new master's log), the journal's
    gauges, the host ms p50 / p99 of the journaled `get_task` and
    `report_task_result` before the kill and after the restart (the
    worker's ``rpc:`` spans), and the worker's kernel launches.  The
    work directory, both masters and the launcher go away whether the
    drill passes or fails.
    """
    from .agent.master_client import MasterClient
    from .common.comm import find_free_port
    from .telemetry import timeline as tl
    from .telemetry.serving import _percentile

    geo = MASTER_KILL[model]
    dataset_size, batch, minibatches, seq = (
        geo[k] for k in ("dataset_size", "batch", "minibatches", "seq"))
    if reference is None:
        reference = master_kill_reference(model, device)
    work = tempfile.mkdtemp(prefix="dwt-torch-masterkill-")
    marker = os.path.join(work, "markers")
    ckpt_dir = os.path.join(work, "ckpt")
    journal_dir = os.path.join(work, "journal")
    os.makedirs(marker)
    script = os.path.join(work, "worker.py")
    with open(script, "w") as f:
        f.write(_MASTER_KILL_WORKER)
    job = _drill_job("masterkill")
    port = find_free_port()
    addr = f"127.0.0.1:{port}"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, DWT_JOB_NAME=job,
               DWT_SOCKET_DIR=os.path.join(work, "sockets"),
               PYTHONPATH=repo + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    env.pop("DWT_MASTER_ADDR", None)
    masters: List = []

    def spawn_master():
        log = open(os.path.join(work, f"master{len(masters) + 1}.log"), "w")
        try:
            masters.append(subprocess.Popen(
                [sys.executable, "-m", "dlrover_wuqiong_tpu_torch.master",
                 f"--port={port}", "--min_nodes=1", "--max_nodes=1",
                 f"--journal-dir={journal_dir}", "--poll-interval=0.5"],
                env=env, cwd=work, stdout=log, stderr=subprocess.STDOUT))
        finally:
            log.close()
        return masters[-1]

    report: Dict = {"scenario": "master-kill", "model": model,
                    "device": device, "dataset_size": dataset_size,
                    "batch": batch, "minibatches": minibatches, "seq": seq,
                    "outage_s": outage_s, "ok": False}
    cli = None
    cli_log = os.path.join(work, "launcher.log")
    try:
        spawn_master()
        if not _wait_up(addr, 30.0):
            report["error"] = "master never came up"
            return report
        with open(cli_log, "w") as log:
            cli = subprocess.Popen(
                [sys.executable, "-m", "dlrover_wuqiong_tpu_torch.run",
                 "--nnodes=1", "--nproc_per_node=1", "--max_restarts=2",
                 script, marker, ckpt_dir, model, device,
                 str(dataset_size), str(batch), str(minibatches), str(seq)],
                env=dict(env, DWT_MASTER_ADDR=addr), cwd=work, stdout=log,
                stderr=subprocess.STDOUT)

        # kill the master inside a mid-run shard: after its fetch and
        # some of its steps, so the worker is provably mid-shard through
        # the outage window
        if not _wait_shards(os.path.join(marker, "shards.log"), cli,
                            timeout / 2):
            report.update(error="worker never reached the kill point",
                          cli_rc=cli.poll())
            return report
        masters[0].kill()  # SIGKILL — no snapshot, no goodbye
        masters[0].wait(timeout=10)
        # kill_t / restart_t stay WALL clock: they bracket the step
        # stamps the worker logs with time.time() in another process
        kill_t = time.time()
        time.sleep(outage_s)
        spawn_master()
        if not _wait_up(addr, 60.0):
            report["error"] = "the restarted master never came up"
            return report
        restart_t = time.time()
        report["measured_outage_s"] = restart_t - kill_t
        # process spawn + imports + journal replay until it answers
        report["restart_gap_s"] = restart_t - kill_t - outage_s
        try:
            cli.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            cli.kill()
            cli.wait()

        # ------------------------------------------------------ invariants
        report["cli_rc"] = cli.returncode
        payload = _worker_report(report, marker, reference, dataset_size,
                                 (kill_t, restart_t))
        report["epoch_bumped"] = 2 in report["degraded"].get(
            "epochs_seen", [])
        # the journaled task verbs' host time, before the kill and after
        # the restart (a call the outage held is in neither)
        rpc: Dict = {}
        for r in payload.get("rpc", []):
            end = r["t_wall"] + r["dur_s"]
            when = ("before_kill" if end < kill_t else
                    "after_restart" if r["t_wall"] > restart_t else
                    "across_outage")
            rpc.setdefault(f"{r['msg']}:{when}", []).append(
                r["dur_s"] * 1e3)
        report["rpc_ms"] = {k: {"calls": len(v), "p50": _percentile(v, 0.5),
                                "p99": _percentile(v, 0.99), "max": max(v)}
                            for k, v in sorted(rpc.items())}
        report["replay"] = _replay_line(os.path.join(work, "master2.log"))

        mc = MasterClient(addr, node_id=-1, outage_grace_s=5.0)
        try:
            # the restarted master must run the group-commit journal:
            # the exactly-once claims hold UNDER batched fsync
            js = mc.get_journal_stats()
            report["journal_group_commit"] = {
                "enabled": js.enabled, "group_commit": js.group_commit,
                "max_frames": js.max_frames, "batches": js.batches,
                "frames": js.frames, "batch_mean": js.batch_mean,
                "batch_max": js.batch_max, "durable_seq": js.durable_seq,
                "epoch": js.epoch}
        finally:
            mc.close()

        # -------------------------------------------- incident timeline
        live, offline, equal = live_timeline(addr, ckpt_dir, [journal_dir])
        report["timeline_events"] = live.events
        report["timeline_byte_equal"] = equal
        report["timeline_causal"] = _causal(offline)
        report["timeline_epochs"] = offline["counts"]["epochs"]
        deg_lost = sum(float(i.get("lost_s", 0.0))
                       for i in offline["narrative"]["incidents"]
                       if i.get("attributed_state") == "degraded")
        report["timeline_degraded_s"] = deg_lost
        report["timeline_attribution_ok"] = abs(
            deg_lost - report["ledger"]["degraded_s"]) <= 0.05
        # the offline CLI on the same artifacts must hash to the live bytes
        p = subprocess.run(
            [sys.executable, "-m",
             "dlrover_wuqiong_tpu_torch.telemetry.incident_report",
             "--journal", journal_dir, "--flight", ckpt_dir],
            capture_output=True, text=True, env=env, cwd=work, timeout=120)
        try:
            cli_line = json.loads(p.stdout)
        except ValueError:
            cli_line = {}
        report["incident_report_rc"] = p.returncode
        report["incident_report_sha_match"] = bool(
            p.returncode == 0 and cli_line.get("timeline_sha256")
            == tl.incident_sha256(live.content))

        report["ok"] = bool(
            report["completed"] and cli.returncode == 0
            and report["worker_generations"] == 1
            and report["no_shard_lost_or_double"]
            and report["losses_bitwise"]
            and report["steps_in_outage"] > 0
            and report["heartbeats_buffered"] > 0
            and report["buffer_drained"]
            and report["epoch_bumped"] and report["reregistered"]
            and report["ledger"]["degraded_s"] > 0
            and report["ledger"]["productive_s"] > 0
            and target <= report["goodput_wall"] <= 1.0
            and report["journal_group_commit"]["enabled"]
            and report["journal_group_commit"]["group_commit"]
            and report["timeline_byte_equal"]
            and report["timeline_causal"]
            and report["timeline_epochs"] == [1, 2]
            and report["timeline_attribution_ok"]
            and report["incident_report_sha_match"])
        return report
    finally:
        _teardown(report, work, job,
                  masters + ([cli] if cli is not None else []),
                  ("master1.log", "master2.log", "launcher.log"))


def _teardown(report: Dict, work: str, job: str, procs: List,
              logs: tuple):
    """Kill what is left of a drill's processes, keep the logs' tails in
    a failed report, unlink the job's segments, remove the work dir."""
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
        proc.wait(timeout=10)
    if not report.get("ok"):
        for name in logs:
            try:
                with open(os.path.join(work, name)) as f:
                    report[f"{name[:-4]}_tail"] = f.read()[-2000:]
            except OSError:
                pass
    for seg in os.listdir("/dev/shm") if os.path.isdir("/dev/shm") else []:
        if seg.startswith(f"{job}_"):
            try:
                os.unlink(os.path.join("/dev/shm", seg))
            except OSError:
                pass
    shutil.rmtree(work, ignore_errors=True)


#: the failover drill's lease ttl: the primary heartbeats a lease frame
#: every ttl / 3 and the standby promotes after ttl of silence.  One
#: lease append is one fsync (1-3.5 ms host time on the chip host's disk,
#: PERF.md), so a 1.0 s ttl leaves ~100 fsyncs of slack per beat and
#: cannot expire spuriously, while detection stays under the ~1.5 s the
#: master-kill drill's outage costs
FAILOVER_LEASE_TTL = 1.0


def _folded_line(log_path: str) -> Dict:
    """What the standby logged at its promotion: {"frames_folded",
    "snapshots", "last_seq", "epoch"}."""
    import re

    try:
        with open(log_path) as f:
            text = f.read()
    except OSError:
        return {}
    out: Dict = {}
    m = re.search(r"standby folded (\d+) frames \((\d+) snapshots\)", text)
    if m:
        out.update(frames_folded=int(m.group(1)),
                   snapshots=int(m.group(2)))
    m = re.search(r"PROMOTED to leader: epoch (\d+) .* last mirrored seq "
                  r"(\d+)", text)
    if m:
        out.update(epoch=int(m.group(1)), last_seq=int(m.group(2)))
    return out


def master_failover(model: str = "nano", device: str = "cuda",
                    lease_ttl: float = FAILOVER_LEASE_TTL,
                    target: float = 0.5, timeout: float = 240.0,
                    reference: Dict = None) -> Dict:
    """SIGKILL the PRIMARY master; a warm standby takes over, fenced.

    Parity: dlrover_wuqiong_tpu/chaos.py `master_failover` (:2030-2400),
    on the port, with `master_kill`'s worker: the primary
    (``python -m dlrover_wuqiong_tpu_torch.master --lease-ttl --peer``)
    heartbeats a lease into its journal, a standby (``--standby-of``)
    tails that journal over the fetch verb, and the worker, under the
    port's launcher with the endpoint list ``"primary,standby"``, trains
    the drill's GPT on `device` from the shards the masters hand out.
    After fetch `KILL_AFTER_FETCHES` and `KILL_AFTER_STEPS` of its steps
    the primary is SIGKILLed; after ``lease_ttl`` of lease silence the
    standby journals a ``failover`` frame and promotes at epoch old + 2.
    Invariants, the JAX drill's:

    - the worker never restarts (one generation), the launcher exits 0,
      and the worker's endpoint list rotated at least once;
    - dataset ranges tile exactly across the takeover, and every one of
      the losses is bitwise `reference`'s (only the same ranges in the
      same order give that; idem-keyed retries apply once under the new
      epoch);
    - the buffer drains (pending 0, dropped 0), the worker saw the
      promoted epoch (old + 2) and re-registered; its ledger shows
      degraded and productive seconds;
    - the standby fetched before the kill (lag >= 0);
    - the promotion gap (SIGKILL to the standby answering as leader) is
      below the restart baseline measured in THIS run — the corpse
      revived on its own journal, spawn to serving — plus the same
      lease-ttl detection floor (no supervisor restarts a master it has
      not yet declared dead).  No fixed number;
    - the revived corpse fences itself through ``--peer``: it answers
      read verbs, and a mutating verb bounces with ``NotLeaderError``;
    - the live timeline of the promoted master over both journal dirs
      is byte-equal to the offline assembly, every journal event
      appears once in (epoch, seq) order, and the takeover narrates as
      a ``failover`` incident;
    - the wall-clock goodput lies in [`target`, 1], its ideal step the
      worker's own (`worker_goodput`).

    The report also carries the primary's shipping gauges just before
    the kill, what the standby folded before it promoted (from its
    log), the steps inside the failover and the worker's launches.
    """
    from .common import messages as msg
    from .common.comm import RpcClient, RpcError, find_free_port

    geo = MASTER_KILL[model]
    dataset_size, batch, minibatches, seq = (
        geo[k] for k in ("dataset_size", "batch", "minibatches", "seq"))
    if reference is None:
        reference = master_kill_reference(model, device)
    work = tempfile.mkdtemp(prefix="dwt-torch-failover-")
    marker = os.path.join(work, "markers")
    ckpt_dir = os.path.join(work, "ckpt")
    jd_primary = os.path.join(work, "journal-primary")
    jd_standby = os.path.join(work, "journal-standby")
    os.makedirs(marker)
    script = os.path.join(work, "worker.py")
    with open(script, "w") as f:
        f.write(_MASTER_KILL_WORKER)
    job = _drill_job("failover")
    port_p, port_sb = find_free_port(), find_free_port()
    addr_p, addr_sb = f"127.0.0.1:{port_p}", f"127.0.0.1:{port_sb}"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, DWT_JOB_NAME=job,
               DWT_SOCKET_DIR=os.path.join(work, "sockets"),
               PYTHONPATH=repo + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    env.pop("DWT_MASTER_ADDR", None)
    procs: List = []

    def spawn(log_name: str, port: int, jd: str, *flags):
        with open(os.path.join(work, log_name), "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "dlrover_wuqiong_tpu_torch.master",
                 f"--port={port}", "--min_nodes=1", "--max_nodes=1",
                 f"--journal-dir={jd}", "--poll-interval=0.5",
                 f"--lease-ttl={lease_ttl}", *flags],
                env=env, cwd=work, stdout=log, stderr=subprocess.STDOUT))
        return procs[-1]

    def probe(addr: str, timeout_s: float = 2.0):
        """One JournalStatsQuery, None on any failure."""
        client = RpcClient(addr, node_id=-4, node_type="probe",
                           timeout=timeout_s, retries=1,
                           base_delay_s=0.02, max_delay_s=0.05)
        try:
            return client.get(msg.JournalStatsQuery())
        except RpcError:
            return None
        finally:
            client.close()

    report: Dict = {"scenario": "master-failover", "model": model,
                    "device": device, "dataset_size": dataset_size,
                    "batch": batch, "minibatches": minibatches, "seq": seq,
                    "lease_ttl": lease_ttl, "ok": False}
    cli = None
    try:
        primary = spawn("primary.log", port_p, jd_primary,
                        f"--peer={addr_sb}")
        if not _wait_up(addr_p, 30.0):
            report["error"] = "primary never came up"
            return report
        spawn("standby.log", port_sb, jd_standby, f"--standby-of={addr_p}")
        if not _wait_up(addr_sb, 30.0):
            report["error"] = "standby never came up"
            return report
        # gate the start on the mirror flowing: the primary's shipping
        # gauges go live on the standby's first fetch
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            s = probe(addr_p)
            if s is not None and s.standby_lag_frames >= 0:
                break
            time.sleep(0.05)
        else:
            report["error"] = "standby never fetched"
            return report
        with open(os.path.join(work, "launcher.log"), "w") as log:
            cli = subprocess.Popen(
                [sys.executable, "-m", "dlrover_wuqiong_tpu_torch.run",
                 "--nnodes=1", "--nproc_per_node=1", "--max_restarts=2",
                 script, marker, ckpt_dir, model, device,
                 str(dataset_size), str(batch), str(minibatches), str(seq)],
                env=dict(env, DWT_MASTER_ADDR=f"{addr_p},{addr_sb}"),
                cwd=work, stdout=log, stderr=subprocess.STDOUT)
        procs.append(cli)
        if not _wait_shards(os.path.join(marker, "shards.log"), cli,
                            timeout / 2):
            report.update(error="worker never reached the kill point",
                          cli_rc=cli.poll())
            return report
        pre = probe(addr_p)
        report["pre_kill"] = {
            "durable_seq": getattr(pre, "durable_seq", -1),
            "shipped_seq": getattr(pre, "shipped_seq", -1),
            "standby_lag_frames": getattr(pre, "standby_lag_frames", -2),
            "epoch": getattr(pre, "epoch", -1)}
        primary.kill()  # SIGKILL — no snapshot, no goodbye
        primary.wait(timeout=10)
        # wall clock: it brackets the step stamps the worker logs
        kill_t = time.time()
        promoted_t = -1.0
        deadline = time.monotonic() + lease_ttl * 10 + 60.0
        while time.monotonic() < deadline:
            s = probe(addr_sb, timeout_s=1.0)
            if s is not None and s.is_leader:
                promoted_t = time.time()
                report["promoted_epoch"] = s.epoch
                break
            time.sleep(0.01)
        if promoted_t < 0:
            report["error"] = "standby never promoted"
            return report
        report["promotion_gap_s"] = promoted_t - kill_t
        try:
            cli.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            cli.kill()
            cli.wait()

        # ------------------------------------------------------ invariants
        report["cli_rc"] = cli.returncode
        _worker_report(report, marker, reference, dataset_size,
                       (kill_t, promoted_t))
        stats = report["degraded"]
        report["client_failovers"] = stats.get("failovers", 0)
        report["epoch_fenced"] = (
            report["promoted_epoch"] == report["pre_kill"]["epoch"] + 2
            and report["promoted_epoch"] in stats.get("epochs_seen", []))
        report["standby"] = _folded_line(os.path.join(work, "standby.log"))

        # ------------------------------------ restart-the-world baseline
        # revive the corpse on its own journal: spawn to serving is the
        # restart gap master_kill measures, in the SAME run; the whole
        # restart-the-world cost adds the same detection floor the
        # standby waited out, so the measured mechanics (promote in place
        # against spawn + import + replay) decide
        spawn_t = time.monotonic()
        spawn("corpse.log", port_p, jd_primary, f"--peer={addr_sb}")
        if not _wait_up(addr_p, 60.0):
            report["error"] = "corpse never came back"
            return report
        report["restart_gap_s"] = time.monotonic() - spawn_t
        report["restart_the_world_s"] = report["restart_gap_s"] + lease_ttl
        report["promotion_beats_restart"] = (
            report["promotion_gap_s"] < report["restart_the_world_s"])

        # ------------------------------------------------ split-brain gate
        cs = probe(addr_p)
        report["corpse_fenced"] = bool(
            cs is not None and not cs.is_leader
            and cs.epoch < report["promoted_epoch"])
        corpse = RpcClient(addr_p, node_id=-4, node_type="probe",
                           timeout=2.0, retries=1)
        try:
            report["corpse_read_ok"] = not corpse.get(
                msg.KVStoreGetRequest(key="chaos-fo")).found
            try:
                corpse.report(msg.KVStoreSetRequest(key="chaos-fo",
                                                    value=b"split"))
                report["corpse_mutation_refused"] = False
            except RpcError as e:
                report["corpse_mutation_refused"] = \
                    "NotLeaderError" in str(e)
        finally:
            corpse.close()

        # ---------------------------------------- incident timeline gate
        live, offline, equal = live_timeline(addr_sb, ckpt_dir,
                                             [jd_standby, jd_primary])
        report["timeline_events"] = live.events
        report["timeline_byte_equal"] = equal
        report["timeline_causal"] = _causal(offline, jd_standby,
                                            jd_primary)
        report["timeline_incidents"] = [
            i["kind"] for i in offline["narrative"]["incidents"]]
        report["timeline_failover_incident"] = \
            "failover" in report["timeline_incidents"]

        report["ok"] = bool(
            report["completed"] and cli.returncode == 0
            and report["worker_generations"] == 1
            and report["no_shard_lost_or_double"]
            and report["losses_bitwise"]
            and report["heartbeats_buffered"] > 0
            and report["buffer_drained"]
            and report["client_failovers"] >= 1
            and report["epoch_fenced"] and report["reregistered"]
            and report["ledger"]["degraded_s"] > 0
            and report["ledger"]["productive_s"] > 0
            and target <= report["goodput_wall"] <= 1.0
            and report["pre_kill"]["standby_lag_frames"] >= 0
            and report["promotion_beats_restart"]
            and report["corpse_fenced"]
            and report["corpse_read_ok"]
            and report["corpse_mutation_refused"]
            and report["timeline_byte_equal"]
            and report["timeline_causal"]
            and report["timeline_failover_incident"])
        return report
    finally:
        _teardown(report, work, job, procs,
                  ("primary.log", "standby.log", "corpse.log",
                   "launcher.log"))


SCENARIOS = {"serve-drain": serve_drain, "ckpt-corrupt": ckpt_corrupt,
             "master-kill": master_kill, "master-failover": master_failover}


def main(argv=None) -> int:
    argv = list(argv if argv is not None else sys.argv[1:])
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    names = argv or list(SCENARIOS)
    ok = True
    for name in names:
        fn = SCENARIOS.get(name)
        if fn is None:
            raise ValueError(
                f"scenario {name!r} is not ported: the port has "
                f"{list(SCENARIOS)}; the other drills come with ROADMAP "
                f"items 7b part 3 and 13")
        report = fn(device=device)
        print(json.dumps(report))
        ok = ok and report.get("ok", False)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
