"""Elastic training agent: the node-level supervisor of a worker process.

Parity: dlrover_wuqiong_tpu/agent/elastic_agent.py — `ElasticLaunchConfig`
(:37-57), `ElasticAgent` and `launch_agent` (:590-605), with:

- the rendezvous (:116-170): join with a free port, poll the comm world
  until it forms in a round newer than the last one this agent ran in
  and than the round the master had formed when the join landed (a
  difference from JAX: a fresh agent that replaces a lost node under
  the same node id would otherwise take the old world the master still
  lists it in, and launch its worker at the old coordinator); rank 0's
  ip:port becomes the world's coordinator address;
- the checkpoint saver (:172-179), hosted here so that a staged shm
  generation outlives its worker, with its `metric_hook` forwarding each
  persist's seconds to the master;
- the replica ring (`_setup_replication`, :181-231, and the saver's
  `post_save_hook` = `backup`, :441-449) when ``DWT_CTX_CHECKPOINT_REPLICA``
  is above 0: one `ReplicaServer` per agent, kept across rendezvous
  rounds, peer addresses exchanged under ``replica/{round}/{rank}`` in
  the master's kv store, a ``ckpt-health`` node event for a corrupt
  holder, and a restore of the staged segment from a peer when (only
  when) the local segment is missing — a replacement node's worker then
  resumes from shm without reading storage.  The restored segment is
  stamped with this agent as its owner (replica.py), and the restore is
  the span ``agent:replica-restore``.  The server stops and the manager
  closes when the agent stops (the JAX agent leaves both to the
  process's end);
- the heartbeat (:359-387), the worker launch (:233-306: the world
  contract in env vars, the package on ``PYTHONPATH``, stderr to a tail
  file the master's error catalogue classifies), the monitor (:546-573)
  and the restart and failure paths of `run` (:417-494): on a failed
  worker, flush the flight recorder, persist the staged shm generation
  (`save_shm_to_storage`) BEFORE reporting the failure and relaunching,
  report the exit code (a signal death as its shell code, -9 → 137) with
  the stderr tail, and stop when the master says a restart cannot fix
  the class or `max_restarts` is spent.

Each phase of a restart is a span (telemetry/spans.py): the worker's
exit as ``agent:worker-exit`` (its exit code), the persist as
``agent:persist``, the report as ``agent:report-failure``, the
rendezvous as ``rdzv:elastic-training:join`` and the launch as
``agent:launch``; the flight recorder dumps them with the ring on every
worker fault and when the agent ends (`launch_agent`).

The agent never initialises CUDA: it imports the saver, the client and
the telemetry, none of which touches ``torch.cuda``; the worker owns the
card.  Left out, each named where it would sit and in ROADMAP: the warm
pool (`_kick_warm_pool`, :496-545) and the compile-cache env (:262), item
13; the config tuner (:424-428) and the policy knobs (:389-405, among
them the replica count), item 15; ``--network-check`` (:597), item 13,
which raises.
"""

from __future__ import annotations

import os
import signal
import subprocess
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

from ..checkpoint.ckpt_saver import AsyncCheckpointSaver, CheckpointEvent
from ..common.comm import find_free_port
from ..common.constants import JobConstant, NodeEnv, RendezvousName
from ..common.log import get_logger
from ..telemetry import spans as tspans
from .master_client import MasterClient

logger = get_logger("elastic_agent")


@dataclass
class ElasticLaunchConfig:
    """Parity: dlrover_wuqiong_tpu/agent/elastic_agent.py:37-57."""

    min_nodes: int = 1
    max_nodes: int = 1
    nproc_per_node: int = 1
    max_restarts: int = 3
    network_check: bool = False
    node_unit: int = 1
    rdzv_timeout: float = 600.0
    monitor_interval: float = 1.0
    log_dir: str = ""

    def auto_configure_params(self):
        self.network_check = self.network_check or (
            os.getenv("DWT_NETWORK_CHECK", "") == "1")
        if self.max_nodes >= 4 and os.getenv(
                "DWT_NETWORK_CHECK", "auto") == "auto":
            self.network_check = True


class WorkerContext:
    """One launched training process + its world assignment."""

    def __init__(self, proc: subprocess.Popen, process_id: int,
                 num_processes: int, restart_count: int,
                 log_path: str = ""):
        self.proc = proc
        self.process_id = process_id
        self.num_processes = num_processes
        self.restart_count = restart_count
        self.log_path = log_path  # captures stderr for error classification


class RendezvousOutcome:
    def __init__(self, rdzv_round: int, process_id: int, num_processes: int,
                 coordinator_addr: str, local_world_size: int):
        self.rdzv_round = rdzv_round
        self.process_id = process_id
        self.num_processes = num_processes
        self.coordinator_addr = coordinator_addr
        self.local_world_size = local_world_size


class ElasticAgent:
    def __init__(self, config: ElasticLaunchConfig,
                 master_client: MasterClient, node_id: int, node_rank: int,
                 entrypoint: Optional[List[str]] = None,
                 worker_env: Optional[Dict[str, str]] = None):
        self.config = config
        self.mc = master_client
        self.node_id = node_id
        self.node_rank = node_rank
        self.entrypoint = entrypoint or []
        self.worker_env = worker_env or {}
        self._worker: Optional[WorkerContext] = None
        self._restart_count = 0
        self._rollback_before = -1  # loss-spike resume ceiling (one-shot)
        self._stopped = threading.Event()
        self._saver: Optional[AsyncCheckpointSaver] = None
        self._replica_server = None
        self._replica_manager = None
        self._heartbeat_thread: Optional[threading.Thread] = None
        self._last_restart_ts = 0.0
        # last rendezvous round this agent ran in, PER rendezvous name: a
        # re-join after failure must wait for a NEWER round — accepting
        # the stale completed world hands out a dead coordinator and the
        # restarted workers split across two worlds
        self._last_rdzv_round: Dict[str, int] = {}

    # ------------------------------------------------------------- rendezvous

    def rendezvous(self,
                   name: str = RendezvousName.ELASTIC_TRAINING
                   ) -> RendezvousOutcome:
        """Join + poll until the master forms the world."""
        with tspans.span(f"rdzv:{name}:join", {"node": self.node_id}) as rec:
            out = self._rendezvous_poll(name, rec)
        return out

    def _rendezvous_poll(self, name: str, span_rec) -> RendezvousOutcome:
        free_port = find_free_port()
        joined = self.mc.join_rendezvous(
            self.node_rank, self.config.nproc_per_node, rdzv_name=name,
            node_ip=os.getenv("DWT_NODE_IP", "127.0.0.1"),
            free_port=free_port)
        deadline = time.monotonic() + self.config.rdzv_timeout
        while time.monotonic() < deadline:
            state = self.mc.get_comm_world(rdzv_name=name)
            if state.complete and state.rdzv_round <= max(
                    joined, self._last_rdzv_round.get(name, -1)):
                # stale world from before our (re-)join — wait for the
                # next.  `joined`, the round the master had formed when
                # this join landed, covers a fresh agent replacing a lost
                # node under the same node id: the master still lists
                # that node in the old world, which the JAX agent (its
                # `_last_rdzv_round` empty) would take
                time.sleep(0.5)
                continue
            if state.complete:
                my_rank = None
                total_procs = 0
                for rank in sorted(int(r) for r in state.world):
                    nid, lws, ip, port = state.world[str(rank)]
                    if nid == self.node_id:
                        my_rank = rank
                    total_procs += 1
                if my_rank is None:
                    # we were not included (e.g. over max_nodes) — rejoin
                    time.sleep(1.0)
                    joined = self.mc.join_rendezvous(
                        self.node_rank, self.config.nproc_per_node,
                        rdzv_name=name,
                        node_ip=os.getenv("DWT_NODE_IP", "127.0.0.1"),
                        free_port=free_port)
                    continue
                self._last_rdzv_round[name] = state.rdzv_round
                span_rec["attrs"]["round"] = state.rdzv_round
                span_rec["attrs"]["world"] = total_procs
                return RendezvousOutcome(
                    state.rdzv_round, my_rank, total_procs,
                    state.coordinator_addr, self.config.nproc_per_node)
            time.sleep(0.5)
        raise TimeoutError(f"rendezvous {name} did not complete")

    # ------------------------------------------------------------- lifecycle

    def _start_saver(self):
        if self._saver is None:
            self._saver = AsyncCheckpointSaver.start_async_saving_ckpt(
                job_name=os.getenv(NodeEnv.JOB_NAME, "dwt"),
                local_shard_num=1, node_rank=self.node_rank)
            self._saver.metric_hook = lambda kind, s: \
                self.mc.report_custom_metric(
                    {f"dwt_ckpt_{kind}_seconds": s})

    def _setup_replication(self, outcome: RendezvousOutcome):
        """Ring replication of staged checkpoints over agent TCP.

        Parity: dlrover_wuqiong_tpu/agent/elastic_agent.py:181-231 —
        peer addresses rendezvous through the master KV store; a
        replacement node restores its staged segment from a peer before
        touching storage.
        """
        from ..checkpoint.replica import CkptReplicaManager, ReplicaServer
        from ..common.global_context import get_context

        replicas = get_context().checkpoint_replica
        if replicas <= 0:
            return
        job = os.getenv(NodeEnv.JOB_NAME, "dwt")
        if self._replica_server is None:
            self._replica_server = ReplicaServer()
            self._replica_server.start()
        my_ip = os.getenv("DWT_NODE_IP", "127.0.0.1")
        my_addr = f"{my_ip}:{self._replica_server.port}"
        rdzv = outcome.rdzv_round
        self.mc.kv_store_set(f"replica/{rdzv}/{outcome.process_id}",
                             my_addr.encode())
        peers = {}
        keys = [f"replica/{rdzv}/{r}" for r in range(outcome.num_processes)]
        try:
            self.mc.kv_store_wait(keys, timeout=60.0)
            vals = self.mc.kv_store_multi_get(keys) or []
            for r, v in enumerate(vals):
                if v:
                    peers[r] = v.decode() if isinstance(v, bytes) else v
        except TimeoutError as e:
            # replication is best-effort: run with the peers that showed up
            logger.warning("replica peer rendezvous incomplete: %s", e)
        self._replica_manager = CkptReplicaManager(
            rank=outcome.process_id, peers=peers, job_name=job,
            replica_count=replicas,
            # holder corruption must reach the master's event stream —
            # the agent is the process that owns the mc here
            health_hook=lambda reason: self.mc.report_node_event(
                "ckpt-health", f"replica: {reason}", level="warning"))
        if not self._replica_manager.has_local_segment():
            # replacement node (or first boot after a node swap): the
            # staged checkpoint exists only on a peer — pull it into local
            # shm so the worker restores in-memory instead of re-reading
            # storage.  Gating on the MISSING local segment (not restart
            # counts, which reset with the agent process) also guarantees
            # we never clobber a newer local segment with a peer's older
            # copy.
            with tspans.span("agent:replica-restore",
                             {"rank": outcome.process_id}) as rec:
                restored = self._replica_manager.restore()
                rec["attrs"]["step"] = -1 if restored is None else restored
                rec["attrs"]["holder"] = self._replica_manager.restored_from
            if restored is not None:
                logger.info("replica restore: staged step %d recovered "
                            "from a peer", restored)

    def _replica_backup(self, step: int):
        """The saver's `post_save_hook`: ship the persisted segment to the
        ring (span ``agent:replica-backup``: the step, the copies that
        landed and the seconds of each part, `last_backup`)."""
        manager = self._replica_manager
        with tspans.span("agent:replica-backup", {"step": step}) as rec:
            rec["attrs"]["copies"] = manager.backup()
            rec["attrs"].update(manager.last_backup)

    def _launch_worker(self, outcome: RendezvousOutcome) -> WorkerContext:
        env = dict(os.environ)
        env.update(self.worker_env)
        # make this framework importable in the worker regardless of its cwd
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        pythonpath = env.get("PYTHONPATH", "")
        if pkg_root not in pythonpath.split(os.pathsep):
            env["PYTHONPATH"] = (f"{pkg_root}{os.pathsep}{pythonpath}"
                                 if pythonpath else pkg_root)
        env.update({
            NodeEnv.MASTER_ADDR: self.mc.master_addr,
            NodeEnv.NODE_ID: str(self.node_id),
            NodeEnv.NODE_RANK: str(self.node_rank),
            NodeEnv.COORDINATOR_ADDR: outcome.coordinator_addr,
            NodeEnv.PROCESS_ID: str(outcome.process_id),
            NodeEnv.NUM_PROCESSES: str(outcome.num_processes),
            NodeEnv.LOCAL_DEVICE_COUNT: str(outcome.local_world_size),
            NodeEnv.RESTART_COUNT: str(self._restart_count),
        })
        # trace context crosses the process boundary via env: the worker's
        # spans (restore tiers, rpc verbs) parent under this agent's trace
        with tspans.env_context() as trace_env:
            env.update(trace_env)
        env.setdefault("DWT_PROC_ROLE", "trainer")
        # (the warm pool's compile-cache dir would be exported here:
        # ROADMAP item 13)
        if self._rollback_before >= 0:
            # one-shot: the relaunched worker resumes from the newest
            # committed ckpt BEFORE the spike step, then the ceiling clears
            env[NodeEnv.ROLLBACK_BEFORE_STEP] = str(self._rollback_before)
            self._rollback_before = -1
        stdout = None
        if self.config.log_dir:
            os.makedirs(self.config.log_dir, exist_ok=True)
            prune_prefix = f"worker_{self.node_rank}_"
            log_path = os.path.join(
                self.config.log_dir,
                f"{prune_prefix}r{self._restart_count}.log")
            stdout = open(log_path, "ab")
            stderr = subprocess.STDOUT
        else:
            # stderr always lands in a file: its tail (the traceback) is
            # what the master's error catalogue classifies on failure
            import tempfile

            log_dir = os.path.join(tempfile.gettempdir(), "dwt-worker-logs")
            os.makedirs(log_dir, exist_ok=True)
            prune_prefix = f"worker_{os.getpid()}_{self.node_rank}_"
            log_path = os.path.join(
                log_dir, f"{prune_prefix}r{self._restart_count}.stderr")
            stderr = open(log_path, "ab")
        proc = subprocess.Popen(
            self.entrypoint, env=env, stdout=stdout, stderr=stderr,
            start_new_session=True)
        # the child holds its own dups — close the parent copies, or the
        # agent leaks one fd per restart over a long elastic job
        for fh in (stdout, stderr):
            if hasattr(fh, "close"):
                fh.close()
        self._prune_worker_logs(os.path.dirname(log_path), prune_prefix,
                                keep=5)
        tspans.span_event("agent:launch", {
            "pid": proc.pid, "restart": self._restart_count,
            "process_id": outcome.process_id,
            "world": outcome.num_processes})
        logger.info("launched worker pid=%d process_id=%d/%d coord=%s "
                    "(log %s)", proc.pid, outcome.process_id,
                    outcome.num_processes, outcome.coordinator_addr,
                    log_path)
        return WorkerContext(proc, outcome.process_id,
                             outcome.num_processes, self._restart_count,
                             log_path=log_path)

    def _prune_worker_logs(self, log_dir: str, prefix: str, keep: int = 5):
        """Cap this agent's per-restart worker logs (oldest deleted),
        ordered by mtime, not by name (r10 sorts before r2)."""
        try:
            mine = sorted(
                (f for f in os.listdir(log_dir) if f.startswith(prefix)),
                key=lambda f: os.path.getmtime(os.path.join(log_dir, f)))
            for stale in mine[:-keep]:
                os.unlink(os.path.join(log_dir, stale))
        except OSError:
            pass

    def _worker_log_tail(self, max_bytes: int = 4000) -> str:
        """Last bytes of the failed worker's captured output — the
        traceback the master's error catalogue classifies."""
        path = getattr(self._worker, "log_path", "")
        if not path:
            return ""
        try:
            with open(path, "rb") as f:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                f.seek(max(0, size - max_bytes))
                return f.read().decode("utf-8", "replace")
        except OSError:
            return ""

    def _stop_worker(self, timeout: float = 30.0):
        if self._worker is None:
            return
        proc = self._worker.proc
        if proc.poll() is None:
            try:
                os.killpg(proc.pid, signal.SIGTERM)
            except ProcessLookupError:
                pass
            try:
                proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                try:
                    os.killpg(proc.pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
                proc.wait(timeout=10)
        self._worker = None

    def _start_heartbeat(self):
        def _loop():
            while not self._stopped.wait(JobConstant.HEARTBEAT_INTERVAL_SECS):
                try:
                    resp = self.mc.report_heart_beat_full()
                    if resp.action == "restart":
                        # capture the ceiling BEFORE the worker-liveness
                        # check: the master clears it one-shot
                        if resp.rollback_before_step >= 0:
                            self._rollback_before = resp.rollback_before_step
                        if self._worker is not None:
                            logger.info("master requested worker restart"
                                        " (rollback_before=%d)",
                                        resp.rollback_before_step)
                            self._stop_worker()
                except Exception:  # noqa: BLE001
                    logger.warning("heartbeat failed", exc_info=True)
                # (the policy knobs are picked up here: ROADMAP item 15)

        self._heartbeat_thread = threading.Thread(
            target=_loop, daemon=True, name="dwt-agent-heartbeat")
        self._heartbeat_thread.start()

    # --------------------------------------------------------------- run loop

    def _flush_flight(self, reason: str):
        """Dump the flight-recorder ring next to the checkpoints (best
        effort — the saver's latest persist path is the anchor)."""
        from ..telemetry.recorder import get_recorder

        path = (getattr(self._saver, "_latest_path", "") or
                os.getenv("DWT_CKPT_DIR", ""))
        if path:
            get_recorder().flush(path, reason)

    def run(self) -> int:
        """Supervisor loop. Parity: reference `_invoke_run` (:580)."""
        tspans.set_process_role("agent")
        self._start_saver()
        self._start_heartbeat()
        # (the config tuner starts here: ROADMAP item 15)
        self.mc.register_node(self.node_rank,
                              accelerator_num=self.config.nproc_per_node)
        while not self._stopped.is_set():
            outcome = self.rendezvous()
            if self._saver is not None:
                # commit must wait for EVERY rank's done-file: tell the
                # saver the current world size, through its event queue so
                # it applies on the saver thread, never racing a save
                self._saver._event_queue.put(CheckpointEvent.update_world(
                    outcome.num_processes, outcome.process_id))
            try:
                self._setup_replication(outcome)
                if self._replica_manager is not None:
                    self._saver.post_save_hook = self._replica_backup
            except Exception:  # noqa: BLE001 — replication is best-effort
                logger.exception("checkpoint replication setup failed")
            self._worker = self._launch_worker(outcome)
            # (the warm pool is kicked here: ROADMAP item 13)
            exit_code = self._monitor_worker()
            if exit_code == 0:
                logger.info("worker succeeded")
                return 0
            if exit_code is None:
                # membership change → restart workers into a new world
                logger.info("membership change — restarting worker")
                self._stop_worker()
                continue
            # failure path
            # normalize Python's negative signal codes to shell style
            # (-9 → 137) so the master's error catalogue can classify
            # signal deaths (SIGKILL=OOM-kill, SIGTERM=preemption)
            report_code = 128 - exit_code if exit_code < 0 else exit_code
            tspans.span_event("agent:worker-exit", {
                "exit_code": report_code, "restart": self._restart_count})
            logger.warning("worker failed with exit code %s", exit_code)
            self._flush_flight("worker-fault")
            if self._saver is not None:
                with tspans.span("agent:persist"):
                    try:
                        self._saver.save_shm_to_storage()
                    except Exception:  # noqa: BLE001
                        logger.exception("failure-save failed")
            error_data = f"exit_code={report_code}"
            tail = self._worker_log_tail()
            if tail:
                error_data += "\n" + tail
                # stderr is captured to a file — echo the tail so local
                # runs still show the traceback on the console
                logger.error("worker stderr tail:\n%s", tail[-1500:])
            with tspans.span("agent:report-failure"):
                resp = self.mc.report_failure(
                    error_data, restart_count=self._restart_count)
            if resp is not None and not getattr(resp, "success", True):
                # master's error catalogue says restarts can't fix this
                # class (e.g. user-code error) — stop burning restarts
                logger.error("master: %s — not restarting",
                             getattr(resp, "reason", ""))
                return exit_code
            self._restart_count += 1
            if self._restart_count > self.config.max_restarts:
                logger.error("max restarts (%d) exhausted",
                             self.config.max_restarts)
                return exit_code
            self._stop_worker()
        return 1

    def _monitor_worker(self) -> Optional[int]:
        """Wait for worker exit or membership change.

        Returns exit code, or None when a re-rendezvous is needed.
        """
        proc = self._worker.proc
        while not self._stopped.is_set():
            code = proc.poll()
            if code is not None:
                return code
            if self._membership_changed():
                return None
            time.sleep(self.config.monitor_interval)
        return proc.poll() if proc.poll() is not None else 1

    def _membership_changed(self) -> bool:
        """Parity: reference `_membership_changed` :711 (debounced)."""
        now = time.monotonic()
        debounce = JobConstant.RESTART_DEBOUNCE_SECS
        if self._last_restart_ts and now - self._last_restart_ts < debounce:
            return False
        try:
            waiting = self.mc.num_nodes_waiting()
        except Exception:  # noqa: BLE001
            return False
        if waiting > 0:
            self._last_restart_ts = now
            return True
        return False

    def stop(self):
        self._stopped.set()
        self._stop_worker()
        if self._saver is not None:
            AsyncCheckpointSaver.reset()
            self._saver = None
        if self._replica_server is not None:
            self._replica_server.stop()
            self._replica_server = None
        if self._replica_manager is not None:
            self._replica_manager.close()
            self._replica_manager = None


def launch_agent(config: ElasticLaunchConfig, entrypoint: List[str],
                 master_addr: str, node_id: int, node_rank: int) -> int:
    """Parity: reference launch_agent (training.py:734)."""
    config.auto_configure_params()
    if config.network_check:
        raise ValueError("--network-check: the node check is not ported "
                         "yet (ROADMAP queue 1 item 13)")
    mc = MasterClient(master_addr, node_id)
    agent = ElasticAgent(config, mc, node_id, node_rank, entrypoint)
    try:
        return agent.run()
    finally:
        # the restart spans of the whole run, beside the checkpoints
        agent._flush_flight("agent-exit")
        agent.stop()
        mc.close()
