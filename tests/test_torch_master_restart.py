"""Port parity: the journaled master and dataset sharding.

Held against the JAX package on the CPU:

- the journal: ``tests/test_master_restart.py``'s TestJournal and
  TestGroupCommit cases run against both packages' `MasterJournal`
  (append / load round trip, torn tails, compaction, the idem cache,
  group commit, the compaction fence, the knobs), and the same appends
  and snapshot give byte-equal ``journal.frames`` and ``snapshot.frame``
  (the wall clock pinned);
- cross replay: a JAX master driven through a verb sequence and dropped
  without a stop is replayed by the port's master, and the port's
  journal by JAX's: each part of the state and the epoch (2) equal what
  the writing package's own master replays;
- restart semantics: TestMasterRestartReplay's three cases and
  ``tests/test_serving.py`` TestServeJournalReplay's two, on both
  packages;
- the splitters and the task manager give JAX's shard sequences,
  checkpoint strings and journal exports, for the table, text and
  streaming splitters;
- a journal holding kinds the port does not replay (``paral``,
  ``policy``, ``mesh_transition``; a JAX snapshot's policy and mesh)
  replays the rest, and warns; its ``lease`` frame replays into the
  fencing baseline;
- the wire: the sharding and journal records' frames are byte-equal to
  JAX's and their fields equal ``schema.lock.json``;
- ``python -m dlrover_wuqiong_tpu_torch.master`` SIGKILLed mid-stream: a
  successor on the same journal serves the replayed state at epoch 2,
  the client rides through, and no task is handed out twice; the flags
  the port does not take raise, and the standby flags reach the master;
- the sharding clients hand out JAX's sample indices;
- `chaos.master_kill` on the CPU with GPT nano: ``ok``, every loss
  bitwise an uninterrupted run's, the timeline gates held, and the
  goodput's ideal step the worker's own (a slower reference no longer
  lifts it above 1).

Every master binds port 0 (the subprocess one a free port), every client
has a short `outage_grace_s` but the ones that must ride a restart, and
every server is stopped.
"""

import dataclasses
import json
import logging
import os
import shutil
import signal
import subprocess
import sys
import threading
import time

import pytest

from dlrover_wuqiong_tpu.agent import sharding_client as jsc
from dlrover_wuqiong_tpu.agent.master_client import (
    MasterClient as JaxMasterClient,
)
from dlrover_wuqiong_tpu.common import messages as jmsg
from dlrover_wuqiong_tpu.common import serialize as jser
from dlrover_wuqiong_tpu.master import dataset_splitter as jds
from dlrover_wuqiong_tpu.master import journal as jjournal
from dlrover_wuqiong_tpu.master import task_manager as jtm
from dlrover_wuqiong_tpu.master.master import JobMaster as JaxJobMaster
from dlrover_wuqiong_tpu_torch.agent import sharding_client as tsc
from dlrover_wuqiong_tpu_torch.agent.master_client import MasterClient
from dlrover_wuqiong_tpu_torch.common import comm as tcomm
from dlrover_wuqiong_tpu_torch.common import messages as tmsg
from dlrover_wuqiong_tpu_torch.common import serialize as tser
from dlrover_wuqiong_tpu_torch.master import dataset_splitter as tds
from dlrover_wuqiong_tpu_torch.master import journal as tjournal
from dlrover_wuqiong_tpu_torch.master import task_manager as ttm
from dlrover_wuqiong_tpu_torch.master.__main__ import main as master_main
from dlrover_wuqiong_tpu_torch.master.master import JobMaster
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOCK = os.path.join(REPO, "dlrover_wuqiong_tpu", "analysis",
                    "schema.lock.json")
GRACE_S = 0.5

#: each package's (MasterJournal, IdemCache)
JOURNALS = {"jax": (jjournal.MasterJournal, jjournal.IdemCache),
            "torch": (tjournal.MasterJournal, tjournal.IdemCache)}


class _Pkg:
    """One package's master, client and messages, for cases whose body
    applies to both."""

    def __init__(self, name):
        self.name = name
        self.msg = jmsg if name == "jax" else tmsg
        self.ser = jser if name == "jax" else tser

    def master(self, jd):
        if self.name == "jax":
            m = JaxJobMaster(port=0, journal_dir=jd)
            m.prepare()
        else:
            m = JobMaster(port=0, host="127.0.0.1", journal_dir=jd)
            m.start()
        return m

    def client(self, m, node_id=0, node_type="worker"):
        cls = JaxMasterClient if self.name == "jax" else MasterClient
        return cls(f"127.0.0.1:{m.port}", node_id=node_id,
                   node_type=node_type, outage_grace_s=GRACE_S)


PKGS = ("jax", "torch")


@pytest.fixture(params=PKGS)
def pkg(request):
    return _Pkg(request.param)


@pytest.fixture(params=PKGS)
def journal_cls(request):
    return JOURNALS[request.param]


# ------------------------------------------------------------ the journal
# tests/test_master_restart.py:338-546, on both packages


class TestJournal:
    def test_append_load_roundtrip(self, tmp_path, journal_cls):
        MasterJournal, _ = journal_cls
        j = MasterJournal(str(tmp_path))
        j.load()
        j.open_epoch()
        j.append("kv_set", {"key": "a", "value": b"\x00\x01"})
        j.append("kv_add", {"key": "c", "amount": 2})
        j.close()
        j2 = MasterJournal(str(tmp_path))
        snapshot, entries = j2.load()
        assert snapshot is None
        assert [e["kind"] for e in entries] == ["kv_set", "kv_add"]
        assert entries[0]["data"]["value"] == b"\x00\x01"
        assert j2.epoch == 1
        assert j2.open_epoch() == 2

    def test_torn_tail_dropped(self, tmp_path, journal_cls):
        MasterJournal, _ = journal_cls
        j = MasterJournal(str(tmp_path))
        j.load()
        j.append("kv_add", {"key": "a", "amount": 1})
        j.append("kv_add", {"key": "a", "amount": 1})
        j.close()
        # master SIGKILLed mid-append: torn trailing frame
        with open(os.path.join(str(tmp_path), "journal.frames"), "ab") as f:
            f.write(b'{"seq": 99, "kind": "kv_a')
        _, entries = MasterJournal(str(tmp_path)).load()
        assert len(entries) == 2  # torn frame dropped, intact ones kept

    def test_snapshot_compacts_and_seq_skips_replayed_prefix(
            self, tmp_path, journal_cls):
        MasterJournal, _ = journal_cls
        j = MasterJournal(str(tmp_path))
        j.load()
        j.open_epoch()
        for _ in range(5):
            j.append("kv_add", {"key": "a", "amount": 1})
        j.snapshot({"kv": {"a": b"5"}})
        j.append("kv_add", {"key": "a", "amount": 1})
        j.close()
        snapshot, entries = MasterJournal(str(tmp_path)).load()
        assert snapshot == {"kv": {"a": b"5"}}
        # only the post-snapshot event replays (no double-apply)
        assert len(entries) == 1

    def test_idem_cache_bounded_lru(self, journal_cls):
        _, IdemCache = journal_cls
        c = IdemCache(cap=3)
        for i in range(5):
            c.put(f"k{i}", i)
        assert len(c) == 3
        assert c.get("k0") is c.MISS
        assert c.get("k4") == 4

    def test_idem_cache_export_restore(self, journal_cls):
        _, IdemCache = journal_cls
        c = IdemCache(cap=3)
        for i in range(3):
            c.put(f"k{i}", i)
        d = IdemCache(cap=2)
        d.restore_state(c.export_state())
        assert len(d) == 2 and d.get("k0") is d.MISS
        assert d.export_state() == {"k1": 1, "k2": 2}


class TestGroupCommit:
    def test_batch_coalesces_queued_frames_one_commit(self, tmp_path,
                                                      journal_cls):
        MasterJournal, _ = journal_cls
        j = MasterJournal(str(tmp_path))
        j.load()
        seqs = [j.append_nowait("kv_add", {"key": "a", "amount": i})
                for i in range(7)]
        assert j.wait_durable(seqs[-1]) == seqs[-1]
        st = j.group_commit_stats()
        assert st["batches"] == 1 and st["frames"] == 7
        assert st["batch_max"] == 7
        assert st["durable_seq"] == seqs[-1]
        j.close()
        _, entries = MasterJournal(str(tmp_path)).load()
        assert [e["data"]["amount"] for e in entries] == list(range(7))

    def test_concurrent_appends_all_durable_and_ordered(self, tmp_path,
                                                        journal_cls):
        MasterJournal, _ = journal_cls
        j = MasterJournal(str(tmp_path))
        j.load()
        n_threads, per = 8, 25
        done = []

        def writer(t):
            for i in range(per):
                done.append(j.append("kv_add",
                                     {"key": f"t{t}", "amount": i}))

        ts = [threading.Thread(target=writer, args=(t,))
              for t in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        j.close()
        _, entries = MasterJournal(str(tmp_path)).load()
        got = [e["seq"] for e in entries]
        assert got == sorted(done)
        assert len(got) == n_threads * per

    def test_append_races_compaction_no_frame_lost(self, tmp_path,
                                                   journal_cls):
        MasterJournal, _ = journal_cls
        j = MasterJournal(str(tmp_path), snapshot_every=1_000_000)
        j.load()
        appended = []
        stop = threading.Event()

        def writer(t):
            i = 0
            while not stop.is_set():
                appended.append(
                    j.append("kv_add", {"key": f"t{t}", "amount": i}))
                i += 1

        ts = [threading.Thread(target=writer, args=(t,)) for t in range(4)]
        for t in ts:
            t.start()
        snap_seqs = []
        for k in range(6):
            time.sleep(0.02)
            j.snapshot({"round": k})
            snap_seqs.append(j._seq)  # noqa: SLF001
        stop.set()
        for t in ts:
            t.join()
        j.close()
        snapshot, entries = MasterJournal(str(tmp_path)).load()
        assert snapshot == {"round": 5}
        covered = snap_seqs[-1]
        live = {e["seq"] for e in entries}
        assert all(s <= covered or s in live for s in appended)
        seq_order = [e["seq"] for e in entries]
        assert seq_order == sorted(seq_order)

    def test_torn_batch_tail_drops_whole_frames_only(self, tmp_path,
                                                     journal_cls):
        MasterJournal, _ = journal_cls
        j = MasterJournal(str(tmp_path))
        j.load()
        for i in range(5):
            j.append_nowait("kv_add", {"key": "a", "amount": i})
        j.wait_durable(5)
        j.close()
        path = os.path.join(str(tmp_path), "journal.frames")
        with open(path, "rb") as f:
            raw = f.read()
        with open(path, "wb") as f:
            f.write(raw[:-9])  # shear the last frame mid-JSON
        _, entries = MasterJournal(str(tmp_path)).load()
        assert [e["data"]["amount"] for e in entries] == [0, 1, 2, 3]

    def test_disabled_mode_is_per_frame_fsync(self, tmp_path, monkeypatch,
                                              journal_cls):
        MasterJournal, _ = journal_cls
        monkeypatch.setenv("DWT_JOURNAL_GROUP_COMMIT", "0")
        j = MasterJournal(str(tmp_path))
        assert j.group_commit_max_frames == 1
        j.load()
        for i in range(3):
            j.append_nowait("kv_add", {"key": "a", "amount": i})
        j.wait_durable(3)
        st = j.group_commit_stats()
        assert st["batches"] == 3 and st["batch_max"] == 1
        assert st["group_commit"] is False
        j.close()

    def test_knob_defaults_and_env_overrides(self, tmp_path, monkeypatch,
                                             journal_cls):
        MasterJournal, _ = journal_cls
        j = MasterJournal(str(tmp_path / "a"))
        assert j.group_commit_max_frames == 256
        assert j.group_commit_max_wait_ms == 0.0
        assert j.fsync_floor_ms == 0.0
        monkeypatch.setenv("DWT_JOURNAL_GROUP_MAX_FRAMES", "32")
        monkeypatch.setenv("DWT_JOURNAL_GROUP_MAX_WAIT_MS", "2")
        monkeypatch.setenv("DWT_JOURNAL_FSYNC_FLOOR_MS", "1")
        j = MasterJournal(str(tmp_path / "b"))
        assert j.group_commit_max_frames == 32
        assert j.group_commit_max_wait_ms == 2.0
        assert j.fsync_floor_ms == 1.0
        j = MasterJournal(str(tmp_path / "c"), group_commit_max_frames=4,
                          group_commit_max_wait_ms=0)
        assert j.group_commit_max_frames == 4
        assert j.group_commit_max_wait_ms == 0.0
        monkeypatch.setenv("DWT_JOURNAL_GROUP_MAX_FRAMES", "lots")
        assert MasterJournal(
            str(tmp_path / "d")).group_commit_max_frames == 256

    def test_leader_linger_extends_batch(self, tmp_path, journal_cls):
        MasterJournal, _ = journal_cls
        j = MasterJournal(str(tmp_path), group_commit_max_wait_ms=100.0)
        j.load()
        s1 = j.append_nowait("kv_add", {"key": "a", "amount": 1})

        def late_follower():
            time.sleep(0.02)
            j.append("kv_add", {"key": "a", "amount": 2})

        t = threading.Thread(target=late_follower)
        t.start()
        j.wait_durable(s1)
        t.join()
        st = j.group_commit_stats()
        assert st["frames"] == 2
        assert st["batch_max"] == 2  # the linger caught the follower
        j.close()


def test_group_commit_stats_keys_equal_jax(tmp_path):
    jst = jjournal.MasterJournal(str(tmp_path / "j")).group_commit_stats()
    tst = tjournal.MasterJournal(str(tmp_path / "t")).group_commit_stats()
    assert list(tst) == list(jst)
    assert tst == jst  # no standby: the shipping gauges at rest


def _write_journal(MasterJournal, msg, jd):
    j = MasterJournal(jd)
    j.load()
    j.open_epoch()
    j.append("kv_set", {"key": "a", "value": b"\x00\xff"})
    seqs = [j.append_nowait("dispatch", {
        "dataset_name": "ds", "task_id": i, "node_id": 3, "start": 8 * i,
        "end": 8 * i + 8, "indices": [], "idem": f"3:x:{i}",
        "resp": msg.Task(task_id=i, task_type="training",
                         shard=msg.ShardConfig(start=8 * i, end=8 * i + 8),
                         dataset_name="ds")}) for i in range(3)]
    j.wait_durable(seqs[-1])
    j.snapshot({"kv": {"a": b"\x00\xff"}, "idem": {
        "3:x:0": msg.OkResponse(reason="r")}})
    j.append("kv_add", {"key": "n", "amount": 2, "result": 2})
    j.close()


def test_frames_and_snapshot_byte_equal(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1700000000.25)
    for name, (MasterJournal, _) in JOURNALS.items():
        _write_journal(MasterJournal, jmsg if name == "jax" else tmsg,
                       str(tmp_path / name))
    for f in ("journal.frames", "snapshot.frame"):
        with open(tmp_path / "jax" / f, "rb") as a, \
                open(tmp_path / "torch" / f, "rb") as b:
            ja, tb = a.read(), b.read()
        assert ja and tb == ja
    with open(tmp_path / "torch" / "journal.frames", "rb") as f:
        first = json.loads(f.readline())
    assert first == {"seq": 6, "kind": "epoch", "ts": 1700000000.25,
                     "data": {"epoch": 1}}


# ------------------------------------------------------------ cross replay


def _drive_verbs(c, msg):
    """The verb sequence the journal must carry across packages."""
    c.report_dataset_shard_params(batch_size=2, dataset_size=24,
                                  dataset_name="ds",
                                  num_minibatches_per_shard=2)
    t1, t2 = c.get_task("ds"), c.get_task("ds")
    c.report_task_result("ds", t1.task_id)
    c.kv_store_set("boot", b"coord")
    c.kv_store_add("counter", 3)
    c.join_rendezvous(node_rank=0, local_world_size=1, node_ip="127.0.0.1",
                      free_port=4321)
    assert c.get_comm_world().complete
    c.register_node(node_rank=0, addr="10.0.0.9", accelerator_num=1)
    c.submit_serve_requests([msg.ServeRequest(request_id=r, prompt=[1, 2])
                             for r in ("a", "b", "c")])
    leased = c.lease_serve_requests(max_requests=2)
    c.report_serve_results([msg.ServeResult(request_id=leased[0].request_id,
                                            tokens=[5, 6])])
    return t1, t2


def _parts(m, ser):
    """Each replayed part of master `m`, encoded by its package."""
    state = m._journal_state()  # noqa: SLF001
    out = {k: ser.dumps(state[k]) for k in ("task_manager", "kv", "nodes",
                                            "idem", "serve")}
    out["rdzv"] = ser.dumps(state["rdzv"]["elastic-training"])
    out["epoch"] = m.epoch
    return out


@pytest.mark.parametrize("writer", PKGS)
def test_cross_replay_between_packages(tmp_path, writer):
    w = _Pkg(writer)
    jd = str(tmp_path / "written")
    m = w.master(jd)
    c = w.client(m, node_id=0)
    try:
        _drive_verbs(c, w.msg)
    finally:
        c.close()
        m._server.stop()  # noqa: SLF001 — a crash: no snapshot
    parts = {}
    for reader in PKGS:
        d = str(tmp_path / reader)
        shutil.copytree(jd, d)
        r = _Pkg(reader)
        rm = r.master(d)
        try:
            parts[reader] = _parts(rm, r.ser)
        finally:
            rm.stop()
    assert parts["torch"]["epoch"] == parts["jax"]["epoch"] == 2
    for key in parts["jax"]:
        assert parts["torch"][key] == parts["jax"][key], key
    tm = json.loads(parts["torch"]["task_manager"])["ds"]
    assert [d[0] for d in tm["doing"]] == [1]  # t2 in flight, t1 done
    assert json.loads(parts["torch"]["serve"])["done_total"] == 1


# ------------------------------------------------------------ restart
# tests/test_master_restart.py:556-640 and tests/test_serving.py:450-530,
# on both packages


class TestMasterRestartReplay:
    def test_state_survives_crash_and_epoch_bumps(self, tmp_path, pkg):
        jd = str(tmp_path / "journal")
        m1 = pkg.master(jd)
        mc = pkg.client(m1)
        mc.report_dataset_shard_params(
            batch_size=4, dataset_size=64, dataset_name="ds",
            num_minibatches_per_shard=2)
        t1 = mc.get_task("ds")
        t2 = mc.get_task("ds")
        mc.report_task_result("ds", t1.task_id)
        mc.kv_store_set("boot", b"coord")
        assert mc.kv_store_add("counter", 2) == 2
        mc.join_rendezvous(node_rank=0, local_world_size=1)
        world = mc.get_comm_world()
        assert world.complete
        assert mc.epoch == 1
        mc.close()
        m1._server.stop()  # noqa: SLF001 — a crash: no final snapshot

        m2 = pkg.master(jd)
        mc2 = pkg.client(m2)
        try:
            assert m2.epoch == 2
            assert mc2.kv_store_get("boot") == b"coord"
            assert mc2.kv_store_add("counter", 1) == 3  # cursor exact
            world2 = mc2.get_comm_world()
            assert world2.complete
            assert world2.rdzv_round == world.rdzv_round
            t3 = mc2.get_task("ds")
            assert t3.task_id not in (t1.task_id, t2.task_id)
            mgr = m2.task_manager._datasets["ds"]  # noqa: SLF001
            assert t2.task_id in mgr.doing
            assert t1.task_id not in mgr.doing  # done stayed done
        finally:
            mc2.close()
            m2.stop()

    def test_idempotent_replay_of_mutating_verbs(self, tmp_path, pkg):
        jd = str(tmp_path / "journal")
        m1 = pkg.master(jd)
        mc = pkg.client(m1)
        idem = "node0:test:1"
        resp = mc._client.get(  # noqa: SLF001 — fixed idem on purpose
            pkg.msg.KVStoreAddRequest(key="ct", amount=5), idem=idem)
        assert resp.num == 5
        mc.close()
        m1._server.stop()  # noqa: SLF001

        m2 = pkg.master(jd)
        mc2 = pkg.client(m2)
        try:
            replay = mc2._client.get(  # noqa: SLF001
                pkg.msg.KVStoreAddRequest(key="ct", amount=5), idem=idem)
            assert replay.num == 5  # the journaled answer, not re-applied
            assert mc2.kv_store_add("ct", 1) == 6
        finally:
            mc2.close()
            m2.stop()

    def test_clean_stop_snapshot_then_restart(self, tmp_path, pkg):
        jd = str(tmp_path / "journal")
        m1 = pkg.master(jd)
        mc = pkg.client(m1)
        mc.kv_store_set("k", b"v")
        mc.close()
        m1.stop()  # clean: compacts into one snapshot frame
        with open(os.path.join(jd, "journal.frames"), "rb") as f:
            assert len(f.read().splitlines()) == 1  # the epoch marker
        m2 = pkg.master(jd)
        mc2 = pkg.client(m2)
        try:
            assert m2.epoch == 2
            assert mc2.kv_store_get("k") == b"v"
        finally:
            mc2.close()
            m2.stop()


def _req(pkg, rid):
    return pkg.msg.ServeRequest(request_id=rid, prompt=[1, 2, 3],
                                max_new_tokens=4)


def _res(pkg, rid):
    return pkg.msg.ServeResult(request_id=rid, tokens=[7, 8, 9, 10],
                               finish_reason="length")


class TestServeJournalReplay:
    def test_queue_state_survives_master_crash(self, tmp_path, pkg):
        jd = str(tmp_path / "journal")
        m1 = pkg.master(jd)
        front = pkg.client(m1, node_id=90)
        wrk = pkg.client(m1, node_id=7, node_type="serve-worker")
        ack = front.submit_serve_requests(
            [_req(pkg, "a"), _req(pkg, "b"), _req(pkg, "c")])
        assert ack.accepted == 3
        leased = wrk.lease_serve_requests(max_requests=2)
        assert [r.request_id for r in leased] == ["a", "b"]
        wrk.report_serve_results([_res(pkg, "a")])
        for c in (front, wrk):
            c.close()
        m1._server.stop()  # noqa: SLF001

        m2 = pkg.master(jd)
        clients = []
        try:
            front2 = pkg.client(m2, node_id=90)
            clients.append(front2)
            summ = front2.get_serve_summary()
            assert summ.submitted_total == 3
            assert summ.done_total == 1
            assert summ.leased == 1      # "b" still assigned to node 7
            assert summ.queue_depth == 1  # "c" still pending
            resp = front2.get_serve_results(["a"])
            assert [r.request_id for r in resp.results] == ["a"]
            assert resp.results[0].tokens == [7, 8, 9, 10]
            wrk2 = pkg.client(m2, node_id=7, node_type="serve-worker")
            clients.append(wrk2)
            wrk2.report_failure("drill: node lost", level="process")
            summ2 = front2.get_serve_summary()
            assert summ2.requeued_total >= 1
            assert summ2.counters.get("requeued", 0) >= 1
            relief = pkg.client(m2, node_id=8, node_type="serve-worker")
            clients.append(relief)
            got = relief.lease_serve_requests(max_requests=1)
            assert [r.request_id for r in got] == ["b"]
        finally:
            for c in clients:
                c.close()
            m2.stop()

    def test_submit_retry_across_restart_is_idempotent(self, tmp_path, pkg):
        jd = str(tmp_path / "journal")
        m1 = pkg.master(jd)
        mc = pkg.client(m1, node_id=90)
        idem = "node90:serve-submit:1"
        payload = pkg.msg.ServeSubmitRequest(node_id=90,
                                             requests=[_req(pkg, "a")])
        ack = mc._client.report(payload, idem=idem)  # noqa: SLF001
        assert ack.accepted == 1
        mc.close()
        m1._server.stop()  # noqa: SLF001

        m2 = pkg.master(jd)
        mc2 = pkg.client(m2, node_id=90)
        try:
            replay = mc2._client.report(payload, idem=idem)  # noqa: SLF001
            assert replay.accepted == 1  # the JOURNALED response
            summ = mc2.get_serve_summary()
            assert summ.submitted_total == 1
            assert summ.queue_depth == 1
        finally:
            mc2.close()
            m2.stop()


def test_failure_report_recovers_shards_across_restart(tmp_path):
    """A node's failure is journaled as ``recover``: its in-flight shard
    goes back to the queue's head, also on a replayed master."""
    jd = str(tmp_path / "journal")
    p = _Pkg("torch")
    m1 = p.master(jd)
    mc = p.client(m1, node_id=3)
    mc.report_dataset_shard_params(batch_size=2, dataset_size=8,
                                   dataset_name="ds",
                                   num_minibatches_per_shard=2)
    t0 = mc.get_task("ds")
    mc.report_failure("exit_code=137")
    mc.close()
    m1._server.stop()  # noqa: SLF001
    m2 = p.master(jd)
    mc2 = p.client(m2, node_id=4)
    try:
        t = mc2.get_task("ds")
        assert (t.task_id, t.shard.start, t.shard.end) == (
            t0.task_id, t0.shard.start, t0.shard.end)
    finally:
        mc2.close()
        m2.stop()


# ------------------------------------------------------------ splitters


SPLITTERS = [("table", False), ("table", True), ("text", False),
             ("text", True), ("streaming", False)]


@pytest.mark.parametrize("storage,shuffle", SPLITTERS)
def test_splitter_shards_and_checkpoints_equal_jax(storage, shuffle):
    seqs = {}
    for name, mod in (("jax", jds), ("torch", tds)):
        sp = mod.new_dataset_splitter(storage, shuffle, 103, 4, 2, 3,
                                      f"ds-{storage}")
        out = []
        for _ in range(2):
            sp.create_shards()
            out.append([(s.start, s.end, list(s.record_indices))
                        for s in sp.get_shards()])
            out.append(json.dumps(sp.to_checkpoint()))
        back = mod.DatasetSplitter.from_checkpoint(sp.to_checkpoint())
        out.append(json.dumps(back.to_checkpoint()))
        out.append(sp.epoch_finished())
        seqs[name] = out
    assert seqs["torch"] == seqs["jax"]


@pytest.mark.parametrize("storage,shuffle", SPLITTERS)
def test_task_manager_equal_jax(storage, shuffle):
    """One sequence of dispatches, results (a failure), a node's recovery,
    checkpoint and restore on both task managers."""
    seen = {}
    for name, mod in (("jax", jtm), ("torch", ttm)):
        tm = mod.TaskManager()
        assert tm.new_dataset(batch_size=4, dataset_size=50,
                              dataset_name="ds", num_epochs=2,
                              shuffle=shuffle, num_minibatches_per_shard=2,
                              storage_type=storage)
        assert not tm.new_dataset(batch_size=4, dataset_size=50,
                                  dataset_name="ds")
        out = []
        for step in range(9):
            task = tm.get_dataset_task(step % 3, "ds")
            out.append(None if task is None else (
                task.task_id, task.task_type, task.shard.start,
                task.shard.end, list(task.shard.record_indices)))
            if task is not None and step % 3 == 0:
                out.append(tm.report_dataset_task(step % 3, "ds",
                                                  task.task_id,
                                                  step % 2 == 0))
        tm.recover_tasks(1)
        out.append(json.dumps(tm.export_state(), sort_keys=True))
        ck = tm.get_dataset_checkpoint("ds")
        out.append(ck)
        out.append(tm.finished("ds"))
        tm2 = mod.TaskManager()
        assert tm2.restore_dataset_from_checkpoint(ck)
        out.append(json.dumps(tm2.export_state(), sort_keys=True))
        tm3 = mod.TaskManager()
        tm3.restore_state(tm.export_state())
        tm3.replay_dispatch("ds", 99, 5, 0, 8, [])
        tm3.replay_task_result("ds", 99, True)
        out.append(json.dumps(tm3.export_state(), sort_keys=True))
        seen[name] = out
    assert seen["torch"] == seen["jax"]


# ------------------------------------------------------------ wire

SHARDING = ("DatasetShardParams", "ShardConfig", "TaskRequest", "Task",
            "TaskResult", "ShardCheckpointRequest", "ShardCheckpoint",
            "JournalStatsQuery", "JournalStats")


def _sample(mod, name: str):
    """An instance of message `name` with every field away from its
    default."""
    cls = getattr(mod, name)
    kw = {}
    for i, f in enumerate(dataclasses.fields(cls)):
        t = str(f.type)
        kw[f.name] = {
            "str": f"{f.name}-{i}", "bool": True, "int": 7 + i,
            "float": 0.25 + i, "List[int]": [i, 3, 5],
            "ShardConfig": mod.ShardConfig(start=i, end=i + 4,
                                           indices=[i, i + 1]),
        }[t]
    return cls(**kw)


@pytest.mark.parametrize("name", SHARDING)
def test_frames_byte_equal_and_cross_load(name):
    jobj, tobj = _sample(jmsg, name), _sample(tmsg, name)
    jframe, tframe = jser.dumps(jobj), tser.dumps(tobj)
    assert tframe == jframe
    back_t, back_j = tser.loads(jframe), jser.loads(tframe)
    assert type(back_t) is getattr(tmsg, name)
    assert back_t == tobj and back_j == jobj
    assert tser.dumps(getattr(tmsg, name)()) == \
        jser.dumps(getattr(jmsg, name)())


@pytest.mark.parametrize("name", SHARDING)
def test_fields_equal_schema_lock(name):
    with open(LOCK) as f:
        lock = json.load(f)["messages"][name]["fields"]
    got = []
    for f in dataclasses.fields(getattr(tmsg, name)):
        if f.default_factory is not dataclasses.MISSING:
            default = f"factory:{f.default_factory.__name__}"
        else:
            default = repr(f.default)
        got.append({"default": default, "name": f.name})
    assert got == [{"default": e["default"], "name": e["name"]}
                   for e in lock]


def test_lenient_loads_keeps_unknown_messages():
    raw = jser.dumps({"config": jmsg.ParallelConfig()})
    with pytest.raises(ValueError, match="unknown message type"):
        tser.loads(raw)
    got = tser.loads(raw, strict=False)
    assert got["config"]["__msg__"] == "ParallelConfig"


# ------------------------------------------------------------ unported kinds


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


@pytest.fixture
def master_warnings():
    h = _Records()
    log = logging.getLogger("dwt.master")
    log.addHandler(h)
    try:
        yield h.messages
    finally:
        log.removeHandler(h)


def test_unported_kinds_replay_the_rest_and_warn(tmp_path,
                                                 master_warnings):
    jd = str(tmp_path / "journal")
    j = jjournal.MasterJournal(jd)
    j.load()
    j.open_epoch()
    j.append("kv_set", {"key": "a", "value": b"1"})
    j.append("paral", {"config": jmsg.ParallelConfig(restart_version=1)})
    j.append("policy", {"decision": jmsg.PolicyDecision(decision_id=1)})
    j.append("mesh_transition", {"tid": 1, "event": "propose"})
    j.append("kv_add", {"key": "n", "amount": 4, "result": 4})
    j.append("lease", {"holder": "1", "lease_epoch": 1, "ttl_s": 1.0})
    j.close()
    m = JobMaster(port=0, host="127.0.0.1", journal_dir=jd)
    m.start()
    try:
        assert (m.kv_store.get("a"), m.kv_store.get("n")) == (b"1", b"4")
        assert m.epoch == 2
        assert m.journal_stats().lease_epoch == 1  # the lease replayed
    finally:
        m.stop()
    for kind, item in (("paral", "15"), ("policy", "15"),
                       ("mesh_transition", "7b part 3")):
        assert any(repr(kind) in w and f"item {item}" in w
                   for w in master_warnings), (kind, master_warnings)
    assert not any("'lease'" in w for w in master_warnings)


def test_jax_snapshot_with_policy_and_mesh_replays(tmp_path,
                                                   master_warnings):
    jd = str(tmp_path / "journal")
    j = jjournal.MasterJournal(jd)
    j.load()
    j.open_epoch()
    j.snapshot({"kv": {"k": b"v"}, "paral": jmsg.ParallelConfig(),
                "policy": [jmsg.PolicyDecision(decision_id=3)],
                "mesh": {"seq": 1, "active": None,
                         "history": [{"tid": 1}]}})
    j.close()
    m = JobMaster(port=0, host="127.0.0.1", journal_dir=jd)
    m.start()
    try:
        assert m.kv_store.get("k") == b"v"
        assert m.epoch == 2
    finally:
        m.stop()
    assert any("['policy', 'mesh']" in w for w in master_warnings)


# ------------------------------------------------------------ subprocess


def _spawn_master(port, jd, log):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    return subprocess.Popen(
        [sys.executable, "-m", "dlrover_wuqiong_tpu_torch.master",
         f"--port={port}", "--min_nodes=1", "--max_nodes=1",
         f"--journal-dir={jd}", "--poll-interval=0.2"],
        env=env, cwd=REPO, stdout=log, stderr=subprocess.STDOUT,
        start_new_session=True)


def test_sigkill_master_restart_on_same_journal(tmp_path):
    """tests/test_master_restart.py:654-713 on the port's ``python -m``
    master: SIGKILLed mid-stream, a successor on the same journal and
    port serves the replayed state at epoch 2."""
    jd = str(tmp_path / "journal")
    port = tcomm.find_free_port()
    addr = f"127.0.0.1:{port}"
    procs = []
    log = open(tmp_path / "master.log", "w")
    mc = None
    try:
        procs.append(_spawn_master(port, jd, log))
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and \
                not tcomm.addr_connectable(addr):
            time.sleep(0.05)
        # this client must ride the restart: a grace longer than it
        mc = MasterClient(addr, node_id=0, outage_grace_s=30.0)
        mc.register_node(node_rank=0)
        mc.report_dataset_shard_params(
            batch_size=2, dataset_size=16, dataset_name="ds",
            num_minibatches_per_shard=2)
        t1 = mc.get_task("ds")
        mc.kv_store_set("k", b"v")
        assert mc.epoch == 1
        os.killpg(procs[0].pid, signal.SIGKILL)  # no snapshot, no goodbye
        procs[0].wait(timeout=10)
        procs.append(_spawn_master(port, jd, log))
        # the client's own retry rides through the restart window
        assert mc.kv_store_get("k") == b"v"
        assert mc.epoch == 2
        rest = [mc.get_task("ds") for _ in range(3)]
        ids = [t1.task_id] + [t.task_id for t in rest]
        assert -1 not in ids and len(set(ids)) == 4  # none handed out twice
        assert sorted((t.shard.start, t.shard.end)
                      for t in [t1] + rest) == [(i, i + 4)
                                                for i in range(0, 16, 4)]
        assert mc.get_task("ds").task_id == -1  # all in flight: wait
        st = mc.degraded_stats()
        assert st["epochs_seen"] == [2] and st["reregistrations"] == 1
        js = mc.get_journal_stats()
        assert (js.enabled, js.group_commit, js.epoch) == (True, True, 2)
    finally:
        if mc is not None:
            mc.close()
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
            p.wait(timeout=10)
        log.close()


@pytest.mark.parametrize("flag", ["--policy", "--policy-prior=p.json"])
def test_unported_master_flags_raise(flag):
    with pytest.raises(ValueError, match="item 15"):
        master_main([flag])


@pytest.mark.parametrize("flag,kw", [
    ("--standby-of=127.0.0.1:1", {"standby_of": "127.0.0.1:1"}),
    ("--peer=127.0.0.1:1", {"peer": "127.0.0.1:1"}),
    ("--lease-ttl=1", {"lease_ttl_s": 1.0})])
def test_standby_flags_reach_the_master(flag, kw, monkeypatch):
    from dlrover_wuqiong_tpu_torch.master import __main__ as entry

    seen = {}
    monkeypatch.setattr(entry, "run_master_forever",
                        lambda *a, **k: seen.update(k) or 0)
    assert master_main([flag]) == 0
    want = {"standby_of": "", "peer": "", "lease_ttl_s": 0.0, **kw}
    assert {k: seen[k] for k in want} == want


def test_master_process_imports_no_torch():
    code = ("import sys\n"
            "import dlrover_wuqiong_tpu_torch.master.__main__\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'numpy', 'jax', 'dlrover_wuqiong_tpu')]\n"
            "print(bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


# ------------------------------------------------------------ sharding


@pytest.fixture(scope="module")
def jax_master():
    m = JaxJobMaster(port=0)
    m.prepare()
    yield m
    m.stop()


def test_index_sharding_client_indices_equal_jax(jax_master):
    m = JobMaster(port=0, host="127.0.0.1")
    m.start()
    got = {}
    try:
        for name, mod, cls, addr in (
                ("jax", jsc, JaxMasterClient, f"127.0.0.1:{jax_master.port}"),
                ("torch", tsc, MasterClient, m.addr)):
            c = cls(addr, node_id=5, outage_grace_s=GRACE_S)
            try:
                sc = mod.IndexShardingClient(
                    c, "idx-ds", batch_size=3, dataset_size=29,
                    shuffle=True, storage_type="text",
                    num_minibatches_per_shard=2)
                seq, ckpts = [], []
                while True:
                    i = sc.fetch_sample_index()
                    if i is None:
                        break
                    seq.append(i)
                    # each sample done as it is consumed: a shard is
                    # reported once its last sample is
                    sc.report_batch_done(1)
                    if len(seq) == 12:
                        ckpts.append(sc.get_checkpoint())
                got[name] = (seq, ckpts, sc.get_checkpoint())
            finally:
                c.close()
        assert got["torch"] == got["jax"]
        assert sorted(got["torch"][0]) == list(range(29))
        assert m.task_manager.finished("idx-ds")
    finally:
        m.stop()


def test_sharding_client_from_the_elastic_context(monkeypatch):
    from dlrover_wuqiong_tpu_torch.trainer import elastic

    m = JobMaster(port=0, host="127.0.0.1")
    m.start()
    monkeypatch.setenv("DWT_MASTER_ADDR", m.addr)
    monkeypatch.setenv("DWT_CTX_MASTER_OUTAGE_GRACE_S", "0.5")
    elastic.reset_elastic_context()
    try:
        ctx = elastic.init_elastic()
        sc = ctx.sharding_client("ctx-ds", batch_size=2, dataset_size=8,
                                 num_minibatches_per_shard=2)
        assert isinstance(sc, tsc.IndexShardingClient)
        task = sc.fetch_shard()
        assert (task.shard.start, task.shard.end) == (0, 4)
        sc.report_shard_done()
        assert ctx.mc.get_shard_checkpoint("ctx-ds")
        assert elastic.ElasticContext(ctx.world, None).sharding_client(
            "x", 1, 1) is None
    finally:
        elastic.reset_elastic_context()
        m.stop()


# ------------------------------------------------------------ the drill


#: torch threads of a drill's processes on the CPU.  Under a parallel
#: test run (several xdist workers on a few cores) a drill's trainer at
#: torch's default (one OpenMP thread a core, spinning while it waits)
#: in the test process and in its worker subprocess oversubscribes the
#: cores so far that a nano drill of ~25 s ran for minutes.  The
#: reference and the worker both take this count, so their losses stay
#: bitwise equal.
DRILL_THREADS = 2


@pytest.fixture
def few_threads(monkeypatch):
    """`DRILL_THREADS` torch threads here and in every subprocess the
    test starts; OpenMP threads that sleep rather than spin."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(DRILL_THREADS)
    monkeypatch.setenv("OMP_NUM_THREADS", str(DRILL_THREADS))
    monkeypatch.setenv("OMP_WAIT_POLICY", "PASSIVE")
    try:
        yield
    finally:
        torch.set_num_threads(before)


def test_master_kill_drill_at_nano_on_cpu(few_threads):
    from dlrover_wuqiong_tpu_torch import chaos

    # a reference whose median step is 10x the worker's: the old rule
    # (n x the reference's step over the worker's span) read far above 1
    ref = chaos.master_kill_reference("nano", "cpu")
    slow = dict(ref, step_s=10 * ref["step_s"])
    r = chaos.master_kill(model="nano", device="cpu", reference=slow)
    assert r["ok"], {k: v for k, v in r.items() if k != "degraded"}
    assert r["losses_bitwise"] and r["steps"] == 144
    assert r["worker_generations"] == 1 and r["cli_rc"] == 0
    assert r["steps_in_outage"] > 0 and r["epoch_bumped"]
    assert r["replay"]["frames"] > 0
    assert 0.5 <= r["goodput_wall"] <= 1.0
    assert r["ideal_step_s"] < r["reference_step_s"]
    assert r["timeline_byte_equal"] and r["timeline_causal"]
    assert r["timeline_epochs"] == [1, 2]
    assert r["timeline_attribution_ok"] and r["incident_report_sha_match"]
    assert sum(r["launches"].values()) == 0  # the CPU runs plain versions


def test_worker_goodput_takes_the_ideal_step_from_the_worker():
    """256 steps of 50 ms with a 0.3 s stall between steps 100 and 101:
    the ideal step is the worker's own 50 ms, whatever a reference read,
    and the goodput stays at most 1 (the old rule, n x a 68 ms reference
    step over the span, read 1.33, as run 15B's 68.11 ms one read
    1.0628)."""
    from dlrover_wuqiong_tpu_torch import chaos

    stamps = [100.0 + 0.05 * i for i in range(100)]
    stamps += [stamps[-1] + 0.3 + 0.05 * i for i in range(1, 157)]
    outage = (stamps[99] + 0.1, stamps[100] - 0.1)
    ideal, goodput = chaos.worker_goodput(stamps, 256, outage)
    assert ideal == pytest.approx(0.05)
    span = max(stamps) - min(stamps)
    assert goodput == pytest.approx(256 * 0.05 / (span + 0.05))
    assert goodput <= 1.0 < 256 * 0.068 / (span + 0.068)
    assert chaos.worker_goodput([], 256, outage) == (0.0, 0.0)
