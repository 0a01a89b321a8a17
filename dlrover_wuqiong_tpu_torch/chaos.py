"""Chaos drills against the port.

Parity: `serve_drain` of dlrover_wuqiong_tpu/chaos.py (:2914-3100),
pointed at the port: its master is the port's `JobMaster`, hosted in
this process, and its decode workers are
``python -m dlrover_wuqiong_tpu_torch.serving`` subprocesses on
``device``.  The JAX drill's journal, group-commit and incident-timeline
gates need the master journal, which the port does not have yet (ROADMAP
item 15); the other drills (preempt, pod-kill, master-kill, hot-swap,
...) come with item 13.  The elastic trainer's SIGKILL drill under the
port's launcher is `trainer.drill.elastic_drill`.

    python -m dlrover_wuqiong_tpu_torch.chaos serve-drain [--device cpu]

prints the drill's one-line JSON report and exits 0 when ``ok``.
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


SCENARIOS = {"serve-drain": serve_drain}


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
                f"item 13")
        report = fn(device=device)
        print(json.dumps(report))
        ok = ok and report.get("ok", False)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
