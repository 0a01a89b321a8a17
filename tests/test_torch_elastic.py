"""Port parity: the elastic launch path — master, rendezvous, agent, ``run``.

Held against the JAX package on the CPU, every comparison exact:

- rendezvous: the port's `ElasticTrainingRendezvousManager` and JAX's run
  each sequence of ``tests/test_master.py::TestElasticRendezvous`` (and
  a few more: the straggler grace, the max-nodes cut, topology order, an
  excluded node), giving equal worlds, rounds, coordinators and waiting
  counts;
- the error catalogue classifies a table of failure texts as JAX's does,
  and the card's hardware faults (ECC, Xid, "GPU is lost", NVLink) as
  ``hardware``; its classes, order and relaunchable flags are JAX's;
- wire: each training message's frame is byte-equal to JAX's, each side
  loads the other's, and its fields equal
  ``dlrover_wuqiong_tpu/analysis/schema.lock.json``;
- RPC: rendezvous, kv and heartbeat verbs from a JAX `MasterClient` to the
  port's master, and from the port's client to a JAX master;
- ``run --standalone`` on the CPU with a GPT nano `Trainer` worker that
  ``os._exit``s after a committed step: restarted, resumed from a
  checkpoint, ends at ``max_steps`` (JAX ``tests/test_elastic_e2e.py``
  ``test_crash_restart_resume``);
- the elastic drill at nano (`trainer.drill.elastic_drill`): two
  SIGKILLs, each resumed generation from the ``shm`` tier at its
  predecessor's staged step + 1, every step's loss bitwise equal to an
  uninterrupted in-process run of the same Trainer;
- two agents form a 2-process gloo world (an ``all_reduce`` of the
  ranks), one worker crashes, and both re-form a world in a later round.

No wall-clock assertions.  Every master binds port 0, and every client
that may dial a dead master has a short `outage_grace_s`.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from dlrover_wuqiong_tpu.agent.master_client import (
    MasterClient as JaxMasterClient,
)
from dlrover_wuqiong_tpu.common import messages as jmsg
from dlrover_wuqiong_tpu.common import serialize as jser
from dlrover_wuqiong_tpu.master import error_monitor as jerr
from dlrover_wuqiong_tpu.master.rendezvous import (
    ElasticTrainingRendezvousManager as JaxRdzv,
)
from dlrover_wuqiong_tpu_torch.agent.master_client import MasterClient
from dlrover_wuqiong_tpu_torch.common import messages as tmsg
from dlrover_wuqiong_tpu_torch.common import serialize as tser
from dlrover_wuqiong_tpu_torch.master import error_monitor as terr
from dlrover_wuqiong_tpu_torch.master.master import JobMaster
from dlrover_wuqiong_tpu_torch.master.rendezvous import (
    ElasticTrainingRendezvousManager,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOCK = os.path.join(REPO, "dlrover_wuqiong_tpu", "analysis",
                    "schema.lock.json")
GRACE_S = 0.5

TRAINING = (
    "JoinRendezvousRequest", "CommWorldRequest", "RendezvousState",
    "WaitingNodeNumRequest", "WaitingNodeNumResponse", "HeartBeat",
    "HeartbeatResponse", "NodeEventReport", "GlobalStep", "ModelInfo",
    "CustomMetric", "GoodputLedgerReport", "GoodputQuery", "GoodputSummary",
    "KVStoreSetRequest", "KVStoreGetRequest", "KVStoreMultiGetRequest",
    "KVStoreAddRequest", "KVStoreResponse")


# ------------------------------------------------------------ rendezvous

#: tests/test_master.py TestElasticRendezvous, as op lists, and more
RDZV_SEQUENCES = {
    "world_forms_at_min_nodes": [
        ("params", 2, 4, 0.0, 1),
        ("join", 0, 0, 4, "10.0.0.1", 1234), ("world", 0),
        ("join", 1, 1, 4, "10.0.0.2", 1235), ("sleep",), ("world", 0),
        ("coord",), ("world", 1)],
    "rejoin_advances_round": [
        ("params", 2, 2, 0.0, 1),
        ("join", 0, 0, 1, "", 0), ("join", 1, 1, 1, "", 0), ("world", 0),
        ("remove", 1), ("join", 2, 1, 1, "", 0), ("waiting",),
        ("join", 0, 0, 1, "", 0), ("world", 0), ("round",)],
    "node_unit_truncates": [
        ("params", 2, 8, 0.0, 2),
        ("join", 0, 0, 1, "", 0), ("join", 1, 1, 1, "", 0),
        ("join", 2, 2, 1, "", 0), ("world", 0), ("world", 2),
        ("waiting",)],
    "straggler_grace_holds_the_world": [
        ("params", 1, 3, 60.0, 1),
        ("join", 0, 0, 1, "", 0), ("join", 1, 1, 1, "", 0), ("world", 0),
        ("waiting",), ("join", 2, 2, 1, "", 0), ("world", 1), ("round",)],
    "max_nodes_cuts_and_excludes": [
        ("params", 1, 2, 0.0, 1),
        ("join", 5, 2, 1, "", 0), ("join", 3, 0, 1, "", 0),
        ("join", 4, 1, 1, "", 0), ("world", 3), ("world", 5),
        ("waiting",), ("coord",)],
    "topology_orders_ranks": [
        ("params", 4, 4, 0.0, 1),
        ("join", 0, 0, 1, "10.0.1.5", 7000),
        ("join", 1, 1, 1, "10.0.2.5", 7001),
        ("join", 2, 2, 1, "10.0.1.6", 7002),
        ("join", 3, 3, 1, "10.0.2.6", 7003), ("world", 1), ("coord",)],
}


def _run_rdzv(rdzv, ops):
    out = []
    for op in ops:
        kind = op[0]
        if kind == "params":
            _, lo, hi, wait, unit = op
            rdzv.update_rdzv_params(lo, hi, waiting_timeout=wait,
                                    node_unit=unit)
        elif kind == "join":
            _, nid, rank, lws, ip, port = op
            out.append(("join", rdzv.join_rendezvous(
                nid, rank, lws, node_ip=ip, free_port=port)))
        elif kind == "sleep":
            time.sleep(0.01)
        elif kind == "world":
            rnd, grp, world = rdzv.get_comm_world(op[1])
            out.append(("world", rnd, grp, sorted(
                (r, s.node_id, s.node_rank, s.local_world_size, s.node_ip,
                 s.free_port) for r, s in world.items())))
        elif kind == "remove":
            rdzv.remove_alive_node(op[1])
        elif kind == "waiting":
            out.append(("waiting", rdzv.num_nodes_waiting()))
        elif kind == "coord":
            out.append(("coord", rdzv.coordinator_addr()))
        elif kind == "round":
            out.append(("round", rdzv.get_rdzv_round(),
                        rdzv.rdzv_timed_out()))
    return out


@pytest.mark.parametrize("name", sorted(RDZV_SEQUENCES))
def test_rendezvous_matches_jax(name):
    ops = RDZV_SEQUENCES[name]
    got = _run_rdzv(ElasticTrainingRendezvousManager(), ops)
    want = _run_rdzv(JaxRdzv(), ops)
    assert got == want
    assert any(r[0] == "world" and r[3] for r in got)


# ------------------------------------------------------------ errors

#: failure texts both catalogues must classify alike
ERROR_TABLE = [
    "exit_code=137",
    "exit_code=143",
    "exit_code=1",
    "",
    "Traceback (most recent call last):\n  File \"w.py\", line 3\n"
    "RuntimeError: RESOURCE_EXHAUSTED: Out of memory while trying to "
    "allocate 2.0G",
    "Traceback (most recent call last):\n  File \"w.py\", line 9\n"
    "torch.OutOfMemoryError: CUDA out of memory. Tried to allocate "
    "2.00 GiB. GPU 0 has a total capacity of 79.19 GiB",
    "MemoryError",
    "ConnectionResetError: [Errno 104] Connection reset by peer",
    "Traceback (most recent call last):\n  File \"socket.py\", line 1\n"
    "TypeError: unsupported operand",
    "ValueError: bad shape (3, 4)",
    "ModuleNotFoundError: No module named 'foo'",
    "watchdog: the training loop stalled for 600 s",
    "preempted by the scheduler (SIGTERM)",
    "DATA_LOSS: uncorrectable memory error on the device",
    "KeyError: 'w'",
]

#: the card's faults: the port's hardware row names them
CUDA_HARDWARE = [
    "RuntimeError: CUDA error: uncorrectable ECC error encountered",
    "NVRM: Xid (PCI:0000:18:00): 79, pid=1234, GPU has fallen off the bus.",
    "Unable to determine the device handle for GPU0000:18:00.0: GPU is lost."
    "  Reboot the system to recover this GPU",
    "torch.distributed.DistBackendError: NCCL error: NVLink error "
    "detected on link 3",
]


@pytest.mark.parametrize("text", ERROR_TABLE)
def test_error_catalogue_matches_jax(text):
    assert terr.classify_error(text) == jerr.classify_error(text)


@pytest.mark.parametrize("text", CUDA_HARDWARE)
def test_error_catalogue_classifies_card_faults(text):
    from dlrover_wuqiong_tpu_torch.common.constants import NodeExitReason

    assert terr.classify_error(text) == (
        "hardware", NodeExitReason.HARDWARE_ERROR, True)


def test_error_catalogue_rows_equal_jax_but_hardware_terms():
    rows = [(n, r, f) for n, r, f, _ in terr._CATALOG]  # noqa: SLF001
    assert rows == [(n, r, f) for n, r, f, _ in jerr._CATALOG]  # noqa: SLF001
    assert terr.TRANSIENT_CLASSES == jerr.TRANSIENT_CLASSES
    # the TPU's own terms left the hardware row
    assert terr.classify_error("libtpu: TPU halted")[0] == "unknown"
    assert jerr.classify_error("libtpu: TPU halted")[0] == "hardware"


def test_repeated_class_cutoff_matches_jax():
    t, j = terr.ErrorMonitor(), jerr.ErrorMonitor()
    for rc in range(3):
        for mon in (t, j):
            mon.process_error(0, rc, "ValueError: boom")
            mon.process_error(1, rc, "exit_code=137")
            mon.process_error(2, rc, "exit_code=143")
        assert [t.repeated_class(r) for r in range(3)] == \
            [j.repeated_class(r) for r in range(3)]
    assert t.repeated_class(1) == "host_oom"
    assert t.repeated_class(2) is None  # preemption is what restarts are for


# ------------------------------------------------------------ wire


def _sample(mod, name: str):
    """An instance of message `name` with every field away from its
    default."""
    cls = getattr(mod, name)
    kw = {}
    for i, f in enumerate(dataclasses.fields(cls)):
        t = str(f.type)
        kw[f.name] = {
            "str": f"{f.name}-{i}", "bool": True, "int": 7 + i,
            "float": 0.25 + i, "bytes": bytes([i, 255, 0]),
            "List[str]": ["a", f"b{i}"],
            "List[bytes]": [b"x", bytes([i])],
            "Dict[str, float]": {"productive": 1.5 + i, "idle": 0.125},
            "Dict[str, List]": {"0": [3, 8, "10.0.0.1", 1234],
                                "1": [4, 8, "10.0.0.2", 1235]},
        }[t]
    return cls(**kw)


@pytest.mark.parametrize("name", TRAINING)
def test_frames_byte_equal_and_cross_load(name):
    jobj, tobj = _sample(jmsg, name), _sample(tmsg, name)
    jframe, tframe = jser.dumps(jobj), tser.dumps(tobj)
    assert tframe == jframe
    back_t, back_j = tser.loads(jframe), jser.loads(tframe)
    assert type(back_t) is getattr(tmsg, name)
    assert type(back_j) is getattr(jmsg, name)
    assert back_t == tobj and back_j == jobj
    assert tser.dumps(getattr(tmsg, name)()) == \
        jser.dumps(getattr(jmsg, name)())


@pytest.mark.parametrize("name", TRAINING)
def test_fields_equal_schema_lock(name):
    with open(LOCK) as f:
        lock = json.load(f)["messages"][name]["fields"]
    cls = getattr(tmsg, name)
    got = []
    for f in dataclasses.fields(cls):
        if f.default_factory is not dataclasses.MISSING:
            default = f"factory:{f.default_factory.__name__}"
        else:
            default = repr(f.default)
        got.append({"default": default, "name": f.name})
    assert got == [{"default": e["default"], "name": e["name"]}
                   for e in lock]
    assert [(f.name, str(f.type)) for f in dataclasses.fields(cls)] == \
        [(f.name, str(f.type))
         for f in dataclasses.fields(getattr(jmsg, name))]


# ------------------------------------------------------------ RPC


def _drive(c, world_cls, hb_cls, summary_cls):
    """Rendezvous, kv and heartbeat verbs through client `c` (either
    package's) against a one-node master."""
    rnd = c.join_rendezvous(node_rank=0, local_world_size=1,
                            node_ip="127.0.0.1", free_port=4321)
    assert rnd == 0
    world = c.get_comm_world()
    assert type(world) is world_cls
    assert (world.complete, world.rdzv_round, world.coordinator_addr) == \
        (True, 1, "127.0.0.1:4321")
    assert world.world == {"0": [c.node_id, 1, "127.0.0.1", 4321]}
    assert c.num_nodes_waiting() == 0
    c.kv_store_set("a", b"\x00\x01")
    assert c.kv_store_get("a") == b"\x00\x01"
    assert c.kv_store_get("missing") is None
    assert c.kv_store_add("n", 2) == 2 and c.kv_store_add("n", 3) == 5
    assert c.kv_store_multi_get(["a", "n"]) == [b"\x00\x01", b"5"]
    assert c.kv_store_multi_get(["a", "missing"]) is None
    assert c.kv_store_wait(["a", "n"], timeout=5.0)
    resp = c.report_heart_beat_full(global_step=3)
    assert type(resp) is hb_cls
    assert (resp.action, resp.rollback_before_step) == ("", -1)
    c.report_global_step(4)
    c.report_goodput_ledger({"wall_s": 2.0, "states": {"productive": 1.5},
                             "other_s": 0.5, "goodput_fraction": 0.75})
    summ = c.get_goodput_summary()
    assert type(summ) is summary_cls
    assert (summ.nodes, summ.wall_s, summ.goodput_fraction) == (1, 2.0, 0.75)
    assert c.report_failure("exit_code=137").success


def test_port_master_answers_jax_client():
    m = JobMaster(port=0, host="127.0.0.1")
    m.start()
    c = JaxMasterClient(m.addr, node_id=2, outage_grace_s=GRACE_S)
    try:
        _drive(c, jmsg.RendezvousState, jmsg.HeartbeatResponse,
               jmsg.GoodputSummary)
        assert m.speed_monitor.completed_global_step == 4
        assert m.job_manager.error_monitor.error_class_history(0) == [
            (0, "host_oom")]
    finally:
        c.close()
        m.stop()


def test_port_client_drives_jax_master():
    from dlrover_wuqiong_tpu.master.master import JobMaster as JaxJobMaster

    jm = JaxJobMaster(port=0)
    jm.prepare()
    c = MasterClient(f"127.0.0.1:{jm.port}", node_id=2,
                     outage_grace_s=GRACE_S)
    try:
        _drive(c, tmsg.RendezvousState, tmsg.HeartbeatResponse,
               tmsg.GoodputSummary)
        assert jm.speed_monitor.completed_global_step == 4
    finally:
        c.close()
        jm.stop()


def test_custom_metric_and_node_event_reach_the_master():
    m = JobMaster(port=0, host="127.0.0.1")
    m.start()
    c = MasterClient(m.addr, node_id=1, outage_grace_s=GRACE_S)
    try:
        c.report_custom_metric({"dwt_ckpt_persist_seconds": 4.5,
                                "other": 1.0})
        c.report_node_event("ckpt-health", "shm: digest", level="warning")
        assert m.metric_collector.reg.get_samples(
            "dwt_ckpt_persist_seconds", {"job": "dwt"})[-1] == 4.5
        ev = m.node_events()[-1]
        assert (ev.event_type, ev.message, ev.level) == (
            "ckpt-health", "shm: digest", "warning")
    finally:
        c.close()
        m.stop()


#: each verb's JAX class on a dead master: a critical verb raises
#: MasterUnreachableError once its grace is spent, a buffered one parks
#: its frame and returns its default, a polling one raises at once
VERB_CLASSES = [
    ("critical", lambda c: c.join_rendezvous(0, 1)),
    ("critical", lambda c: c.get_comm_world()),
    ("polling", lambda c: c.num_nodes_waiting()),
    ("critical", lambda c: c.kv_store_set("k", b"v")),
    ("critical", lambda c: c.kv_store_get("k")),
    ("critical", lambda c: c.kv_store_multi_get(["k"])),
    ("critical", lambda c: c.kv_store_add("k", 1)),
    ("buffered", lambda c: c.report_heart_beat_full(1)),
    ("buffered", lambda c: c.report_global_step(1)),
    ("buffered", lambda c: c.report_node_event("e", "m")),
    ("buffered", lambda c: c.report_goodput_ledger({})),
    ("buffered", lambda c: c.report_custom_metric({"dwt_x": 1.0})),
    ("polling", lambda c: c.get_goodput_summary()),
]


@pytest.mark.parametrize("i", range(len(VERB_CLASSES)))
def test_verb_keeps_its_jax_class_on_a_dead_master(i):
    from dlrover_wuqiong_tpu_torch.common.comm import (
        MasterUnreachableError,
        find_free_port,
    )
    from dlrover_wuqiong_tpu_torch.telemetry.ledger import reset_ledger

    kind, call = VERB_CLASSES[i]
    c = MasterClient(f"127.0.0.1:{find_free_port()}", node_id=1,
                     outage_grace_s=GRACE_S)
    try:
        if kind == "buffered":
            resp = call(c)
            assert resp is not None
            assert c.degraded_stats()["pending"] == 1
        else:
            with pytest.raises(MasterUnreachableError):
                call(c)
            assert c.degraded_stats()["pending"] == 0
    finally:
        c.close()
        reset_ledger()  # the client credits `degraded` to the ledger


def test_checkpoint_forwards_reach_the_master(tmp_path):
    """The engine's blocking-save metric and health event, and the
    saver's `metric_hook`, reach the master through the elastic
    context's client, as the JAX engine's and agent's do."""
    import torch

    from dlrover_wuqiong_tpu_torch.checkpoint.checkpointer import (
        FlashCheckpointer,
        StorageType,
    )
    from dlrover_wuqiong_tpu_torch.checkpoint.ckpt_saver import (
        AsyncCheckpointSaver,
    )
    from dlrover_wuqiong_tpu_torch.telemetry.ledger import reset_ledger
    from dlrover_wuqiong_tpu_torch.trainer import elastic

    m = JobMaster(port=0, host="127.0.0.1")
    m.start()
    c = MasterClient(m.addr, node_id=1, outage_grace_s=GRACE_S)
    prev = elastic._context
    elastic._context = elastic.ElasticContext(elastic.WorldInfo(), c)
    AsyncCheckpointSaver.reset()
    ck = FlashCheckpointer(str(tmp_path), job_name=f"tfwd{os.getpid()}",
                           standalone=True)
    try:
        hooked = []
        AsyncCheckpointSaver.get_ckpt_saver().metric_hook = \
            lambda kind, s: (hooked.append(kind),
                             c.report_custom_metric(
                                 {f"dwt_ckpt_{kind}_seconds": s}))
        ck.save_checkpoint(1, {"w": torch.ones(4)}, StorageType.DISK)
        assert ck.wait_latest_checkpoint(30)
        ck.engine._report_ckpt_health("shm", "digest mismatch")
        reg, job = m.metric_collector.reg, {"job": "dwt"}
        assert reg.get_samples("dwt_ckpt_blocking_seconds", job)
        assert hooked == ["persist"]
        assert reg.get_samples("dwt_ckpt_persist_seconds", job)
        ev = m.node_events()[-1]
        assert (ev.event_type, ev.message) == ("ckpt-health",
                                               "shm: digest mismatch")
    finally:
        ck.close()
        AsyncCheckpointSaver.reset()
        elastic._context = prev
        c.close()
        m.stop()
        reset_ledger()


_STAGING_WORKER = r"""
import os, sys, torch
from dlrover_wuqiong_tpu_torch.checkpoint.checkpointer import (
    FlashCheckpointer, StorageType)
ck = FlashCheckpointer(sys.argv[1], job_name=os.environ["DWT_JOB_NAME"])
ck.save_checkpoint(3, {"w": torch.ones(8)}, StorageType.MEMORY)
ck.wait_staging()
os._exit(9)  # dies holding nothing; its segment stays behind
"""


def test_launched_worker_segment_survives_another_jobs_sweep(tmp_path):
    """A worker attached to its agent's saver stamps the agent (its
    parent) as the segment's owner, so another job's saver, reaping the
    segments of dead creators at its start, leaves a killed worker's
    segment for the agent to persist."""
    from dlrover_wuqiong_tpu_torch.checkpoint.ckpt_saver import (
        AsyncCheckpointSaver,
    )
    from dlrover_wuqiong_tpu_torch.checkpoint.shm_handler import (
        SharedMemoryHandler,
        sweep_stale_segments,
    )

    job = f"tsweep-{os.getpid()}"
    AsyncCheckpointSaver.reset()
    saver = AsyncCheckpointSaver.start_async_saving_ckpt(job)
    try:
        env = _env("unused")
        env.update(DWT_JOB_NAME=job, DWT_MASTER_ADDR="127.0.0.1:1")
        out = subprocess.run([sys.executable, "-c", _STAGING_WORKER,
                              str(tmp_path)], env=env, cwd=REPO,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 9, out.stderr[-3000:]
        header = SharedMemoryHandler(0, job).load_header()
        assert (header["step"], header["extra"]["_pid"]) == (3, os.getpid())
        assert f"{job}_ckpt_shm_0" not in sweep_stale_segments("other-job")
        saver.save_shm_to_storage()
        tracker = tmp_path / "latest_checkpointed_iteration.txt"
        assert tracker.read_text().strip() == "3"
    finally:
        AsyncCheckpointSaver.reset()  # unlinks the job's segment


def test_servicer_network_check_names_its_item():
    m = JobMaster(port=0, host="127.0.0.1")
    with pytest.raises(ValueError, match="item 13"):
        m.rdzv_manager("network-check")


# ------------------------------------------------------------ end to end

WORKER = r"""
import json, os, sys
import numpy as np

ckpt_dir, marker_dir = sys.argv[1], sys.argv[2]
import dataclasses
import torch
from dlrover_wuqiong_tpu_torch.models.gpt import GPT, GPTConfig
from dlrover_wuqiong_tpu_torch.trainer.elastic import get_world_info
from dlrover_wuqiong_tpu_torch.trainer.trainer import Trainer, TrainingArgs

restart = get_world_info().restart_count


def data(step):
    x = np.random.default_rng([3, step]).integers(0, 512, (2, 33))
    return {"input_ids": x[:, :-1], "labels": x[:, 1:]}


def on_step(step, m):
    if restart == 0 and step == 6:
        assert tr.ckpt.wait_latest_checkpoint(60)  # step 4 committed
        os._exit(17)


cfg = dataclasses.replace(GPTConfig.nano(), dtype=torch.float32,
                          remat=False)
tr = Trainer(GPT(cfg), TrainingArgs(
    output_dir=ckpt_dir, max_steps=12, warmup_steps=2, save_steps=4,
    logging_steps=2, global_batch_size=2, seq_len=32), data,
    callbacks=[on_step], device="cpu")
out = tr.train()
with open(os.path.join(marker_dir, f"done_r{restart}.json"), "w") as f:
    json.dump({"resumed": tr.resumed, "stopped_at": out["stopped_at"]}, f)
"""


def _env(job):
    """A launcher's env: its own job name (the savers' sockets and
    segments are named by it, under the suite's short DWT_SOCKET_DIR: a
    socket path under pytest's tmp_path can pass the AF_UNIX limit), and
    one CPU thread a process (the suite runs several workers at once)."""
    env = dict(os.environ)
    env.update({"DWT_JOB_NAME": f"{job}-{os.getpid()}",
                "DWT_CTX_NODE_HEARTBEAT_TIMEOUT": "600",
                "DWT_CTX_MASTER_OUTAGE_GRACE_S": "10",
                "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO})
    env.pop("DWT_MASTER_ADDR", None)
    return env


def test_run_standalone_restarts_and_resumes(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    markers = tmp_path / "markers"
    markers.mkdir()
    out = tmp_path / "out"
    proc = subprocess.run(
        [sys.executable, "-m", "dlrover_wuqiong_tpu_torch.run",
         "--standalone", "--nproc_per_node=1", "--max_restarts=2",
         "--log_dir", str(tmp_path / "logs"), str(script), str(out),
         str(markers)],
        env=_env("te2e"), capture_output=True, text=True,
        timeout=240, cwd=REPO)
    assert proc.returncode == 0, (proc.stdout[-3000:], proc.stderr[-3000:])
    assert not (markers / "done_r0.json").exists()
    done = json.loads((markers / "done_r1.json").read_text())
    assert done["stopped_at"] == 12
    assert done["resumed"]["step"] >= 4, done
    tracker = out / "checkpoints" / "latest_checkpointed_iteration.txt"
    assert tracker.read_text().strip() == "12"
    assert "worker failed with exit code 17" in proc.stderr


def test_elastic_drill_resumes_bitwise_at_nano(tmp_path, monkeypatch):
    """Two SIGKILLs under ``run --standalone``; every step's loss equals
    the uninterrupted in-process run's, bit for bit.  Every process runs
    torch on one CPU thread: the same reduction order in the reference
    and in the workers, and no oversubscription beside the suite's other
    workers."""
    import torch

    from dlrover_wuqiong_tpu_torch.checkpoint.ckpt_saver import (
        AsyncCheckpointSaver,
    )
    from dlrover_wuqiong_tpu_torch.models.gpt import GPT
    from dlrover_wuqiong_tpu_torch.telemetry.ledger import reset_ledger
    from dlrover_wuqiong_tpu_torch.trainer import drill
    from dlrover_wuqiong_tpu_torch.trainer.trainer import Trainer

    knobs = dict(batch=2, seq=32, max_steps=16, warmup=3, save_steps=5)
    losses = {}
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("DWT_JOB_NAME", f"tdrill-ref-{os.getpid()}")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    AsyncCheckpointSaver.reset()
    try:
        tr = Trainer(GPT(drill.gpt_config("nano")),
                     drill.training_args(
                         str(tmp_path / "ref"), knobs["max_steps"],
                         knobs["warmup"], knobs["save_steps"],
                         knobs["batch"], knobs["seq"]),
                     drill.data_fn(drill.VOCAB["nano"], knobs["batch"],
                                   knobs["seq"]),
                     callbacks=[lambda s, m: losses.__setitem__(
                         s, m["loss"])], device="cpu")
        tr.train()
        tr.ckpt.close()
    finally:
        AsyncCheckpointSaver.reset()
        reset_ledger()
        torch.set_num_threads(threads)
    r = drill.elastic_drill(model="nano", device="cpu", kill_range=(3, 13),
                            timeout_s=300, **knobs)
    assert r["rc"] == 0 and r["committed_step"] == "16"
    gens = r["generations"]
    assert len(gens) == 3 and gens[-1]["steps"][-1] == 16
    for kill, prev_gen, gen in zip(r["kills"], gens, gens[1:]):
        assert prev_gen["steps"][-1] == kill["step"]
        assert kill["staged_step"] == kill["step"] - 1
        assert (gen["start_step"], gen["tier"]) == (kill["step"] - 1, "shm")
        assert gen["steps"][0] == kill["step"]
    for gen in gens:
        assert gen["losses"] == [losses[s] for s in gen["steps"]]
    assert len(r["splits"]) == 2
    for split in r["splits"]:
        assert all(v >= 0 for v in split.values()), split
    assert r["master_goodput"]["nodes"] == 1
    assert not os.path.exists(f"/dev/shm/{r['job']}_ckpt_shm_0")


GLOO_WORKER = r"""
import glob, json, os, sys, time
import torch
import torch.distributed as dist
from dlrover_wuqiong_tpu_torch.trainer.elastic import init_elastic

markers = sys.argv[1]
node = os.environ["DWT_NODE_ID"]
gen = len(glob.glob(os.path.join(markers, f"world_n{node}_g*.json")))
ctx = init_elastic(connect_master=False)
x = torch.tensor([float(ctx.process_id + 1)])
dist.all_reduce(x)
with open(os.path.join(markers, f"world_n{node}_g{gen}.json"), "w") as f:
    json.dump({"rank": ctx.process_id, "world": ctx.world.num_processes,
               "sum": float(x), "coord": ctx.world.coordinator_addr,
               "backend": dist.get_backend()}, f)
if gen == 0:
    if ctx.process_id == 0:
        time.sleep(1.0)
        os._exit(13)  # the crash: its agent re-joins, the peer's follows
    time.sleep(120)   # stopped by its agent on the membership change
dist.barrier()
dist.destroy_process_group()
"""


def test_two_agents_form_and_reform_a_gloo_world(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(GLOO_WORKER)
    markers = tmp_path / "markers"
    markers.mkdir()
    m = JobMaster(port=0, min_nodes=2, max_nodes=2, host="127.0.0.1")
    m.start()
    agents = []
    try:
        for nid in (0, 1):
            env = _env(f"tgloo-n{nid}")
            env.update({"DWT_MASTER_ADDR": m.addr, "DWT_NODE_ID": str(nid),
                        "DWT_NODE_RANK": str(nid)})
            agents.append(subprocess.Popen(
                [sys.executable, "-m", "dlrover_wuqiong_tpu_torch.run",
                 "--nnodes=2", "--nproc_per_node=1", "--max_restarts=2",
                 "--log_dir", str(tmp_path / f"logs-n{nid}"), str(script),
                 str(markers)],
                env=env, cwd=REPO, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        for a in agents:
            out, _ = a.communicate(timeout=240)
            assert a.returncode == 0, out[-4000:]
        recs = {}
        for nid in (0, 1):
            for gen in (0, 1):
                recs[nid, gen] = json.loads(
                    (markers / f"world_n{nid}_g{gen}.json").read_text())
        for (nid, gen), rec in recs.items():
            assert (rec["rank"], rec["world"], rec["sum"],
                    rec["backend"]) == (nid, 2, 3.0, "gloo")
        assert recs[0, 0]["coord"] == recs[1, 0]["coord"]
        assert recs[0, 1]["coord"] == recs[1, 1]["coord"]
        assert m.rdzv_manager("elastic-training").get_rdzv_round() == 2
    finally:
        for a in agents:
            if a.poll() is None:
                a.kill()
                a.wait()
        m.stop()
