"""Port parity: the warm standby master, journal shipping, fenced failover.

Held against the JAX package on the CPU:

- ``tests/test_standby.py``'s cases on both packages: the shipping plane
  (`fetch_batch` serves durable frames verbatim from the ring, pages,
  hands the snapshot and its tail over once the ring is outrun; the
  gauges), `ingest_frames` / `ingest_snapshot` (a byte prefix of the
  primary's log, whole frames only, a gap stops the ingest), the tailer
  (mirror and fold, the not-leader gate, a fetch never journaled, a
  primary without a lease makes a pure mirror, a fresh lease mid-drain
  disarms) and the failover (promotion at old + 2, the client fails
  over, idem replays once, the corpse fences itself through ``peer``,
  and the timeline over both journals is byte-equal live and offline
  with a ``failover`` incident);
- shipped frames and the shipping records are byte-equal to JAX's for
  the same appends, through a compaction handoff too;
- a JAX `StandbyTailer` tails a port primary and promotes, and the
  port's tailer a JAX primary; the port standby ingests a JAX primary's
  ``paral`` / ``policy`` frames verbatim;
- the servicer bounces a mutating verb on a non-leader BEFORE its idem
  cache, and the client rotates to the next endpoint on that answer;
- lease and failover frames replay into the fencing baseline;
- ``python -m dlrover_wuqiong_tpu_torch.master --standby-of`` promotes
  after its primary is SIGKILLed.

The failover drill at nano is in tests/test_torch_failover_drill.py.

Every master binds port 0, every client has a short grace, every wait
and poll is bounded, and every server, client and tailer is stopped.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import pytest

from dlrover_wuqiong_tpu.agent.master_client import (
    MasterClient as JaxMasterClient,
)
from dlrover_wuqiong_tpu.common import comm as jcomm
from dlrover_wuqiong_tpu.common import messages as jmsg
from dlrover_wuqiong_tpu.common import serialize as jser
from dlrover_wuqiong_tpu.master import journal as jjournal
from dlrover_wuqiong_tpu.master import standby as jstandby
from dlrover_wuqiong_tpu.master.master import JobMaster as JaxJobMaster
from dlrover_wuqiong_tpu.telemetry import timeline as jtl
from dlrover_wuqiong_tpu_torch.agent.master_client import MasterClient
from dlrover_wuqiong_tpu_torch.common import comm as tcomm
from dlrover_wuqiong_tpu_torch.common import messages as tmsg
from dlrover_wuqiong_tpu_torch.common import serialize as tser
from dlrover_wuqiong_tpu_torch.master import journal as tjournal
from dlrover_wuqiong_tpu_torch.master import standby as tstandby
from dlrover_wuqiong_tpu_torch.master.master import JobMaster
from dlrover_wuqiong_tpu_torch.master.servicer import (
    READ_ONLY_VERBS,
    MasterServicer,
    NotLeaderError,
)
from dlrover_wuqiong_tpu_torch.telemetry import timeline as ttl
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TTL = 0.5
GRACE_S = 5.0


class _Pkg:
    """One package's journal, master, tailer, clients and messages."""

    def __init__(self, name):
        self.name = name
        jax = name == "jax"
        self.msg = jmsg if jax else tmsg
        self.ser = jser if jax else tser
        self.comm = jcomm if jax else tcomm
        self.MasterJournal = (jjournal if jax else tjournal).MasterJournal
        self.StandbyTailer = (jstandby if jax else tstandby).StandbyTailer
        self.tl = jtl if jax else ttl

    def master(self, jd, **kw):
        if self.name == "jax":
            m = JaxJobMaster(port=0, journal_dir=jd, **kw)
            m.prepare()
        else:
            m = JobMaster(port=0, host="127.0.0.1", journal_dir=jd, **kw)
            m.start()
        return m

    def client(self, addr, node_id=0):
        cls = JaxMasterClient if self.name == "jax" else MasterClient
        return cls(addr, node_id=node_id, outage_grace_s=GRACE_S)

    def rpc(self, addr, node_id=7):
        return self.comm.RpcClient(addr, node_id=node_id, retries=1,
                                   timeout=2.0)


PKGS = ("jax", "torch")


@pytest.fixture(params=PKGS)
def pkg(request):
    return _Pkg(request.param)


# ------------------------------------------------------- shipping plane
# tests/test_standby.py:43-195, on both packages


def _mkjournal(pkg, tmp_path, name):
    j = pkg.MasterJournal(str(tmp_path / name))
    j.load()
    return j


def _raw_lines(journal):
    with open(journal._path, "rb") as f:  # noqa: SLF001
        return [ln for ln in f.read().split(b"\n") if ln.strip()]


class TestFetchBatch:
    def test_ring_serves_durable_frames_verbatim(self, tmp_path, pkg):
        j = _mkjournal(pkg, tmp_path, "src")
        for i in range(3):
            j.append("kv", {"key": f"k{i}"})
        snap, snap_seq, frames, durable = j.fetch_batch(0)
        assert (snap, snap_seq) == (b"", 0)
        assert durable == 3
        assert frames == _raw_lines(j)  # verbatim bytes, not re-encoded
        assert j.fetch_batch(3)[2] == []  # caught up: nothing to ship
        st = j.group_commit_stats()
        assert st["shipped_seq"] == 3
        assert st["standby_lag_frames"] == 0
        j.close()

    def test_unfetched_journal_reports_no_standby(self, tmp_path, pkg):
        j = _mkjournal(pkg, tmp_path, "src")
        j.append("kv", {})
        assert j.group_commit_stats()["standby_lag_frames"] == -1
        j.close()

    def test_max_frames_paginates(self, tmp_path, pkg):
        j = _mkjournal(pkg, tmp_path, "src")
        for i in range(5):
            j.append("kv", {"i": i})
        _, _, page1, durable = j.fetch_batch(0, max_frames=2)
        assert len(page1) == 2 and durable == 5
        next_seq = int(pkg.ser.loads(page1[-1])["seq"])
        _, _, page2, _ = j.fetch_batch(next_seq, max_frames=10)
        assert len(page2) == 3
        j.close()

    def test_snapshot_tail_handoff_when_ring_outrun(self, tmp_path, pkg):
        j = _mkjournal(pkg, tmp_path, "src")
        for i in range(4):
            j.append("kv", {"i": i})
        j.snapshot({"kv": {"x": 1}})
        j.append("kv", {"i": 99})  # tail after compaction
        j._ship_ring.clear()  # noqa: SLF001 — a long-dead standby
        snap, snap_seq, frames, durable = j.fetch_batch(0)
        assert snap and snap_seq > 0
        assert pkg.ser.loads(snap)["state"]["kv"] == {"x": 1}
        # the tail resumes past the snapshot: the marker + the new frame
        seqs = [int(pkg.ser.loads(f)["seq"]) for f in frames]
        assert seqs == list(range(snap_seq + 1, durable + 1))
        j.close()

    def test_handoff_skips_snapshot_standby_already_covers(self, tmp_path,
                                                           pkg):
        j = _mkjournal(pkg, tmp_path, "src")
        for i in range(3):
            j.append("kv", {"i": i})
        j.snapshot({"kv": {}})
        j.append("kv", {"i": 3})
        j._ship_ring.clear()  # noqa: SLF001
        snap, snap_seq, frames, _ = j.fetch_batch(4)
        assert (snap, snap_seq) == (b"", 0)
        assert len(frames) >= 1
        j.close()

    def test_compaction_marker_rides_the_ring(self, tmp_path, pkg):
        """The marker bypasses the batch commit: without it in the ring
        a tailing standby would find a seq gap and spin."""
        j = _mkjournal(pkg, tmp_path, "src")
        j.append("kv", {"i": 0})
        j.snapshot({"kv": {}})
        j.append("kv", {"i": 1})
        _, _, frames, durable = j.fetch_batch(1)
        kinds = [pkg.ser.loads(f)["kind"] for f in frames]
        assert kinds == ["epoch", "kv"] and durable == 3
        j.close()


class TestIngest:
    def test_mirror_is_byte_prefix_of_primary(self, tmp_path, pkg):
        src = _mkjournal(pkg, tmp_path, "src")
        dst = _mkjournal(pkg, tmp_path, "dst")
        for i in range(4):
            src.append("kv", {"i": i})
        _, _, frames, _ = src.fetch_batch(0)
        adopted = dst.ingest_frames(frames)
        assert [f["seq"] for f in adopted] == [1, 2, 3, 4]
        assert _raw_lines(dst) == _raw_lines(src)
        assert dst.group_commit_stats()["durable_seq"] == 4
        src.close()
        dst.close()

    def test_torn_batch_tail_whole_frames_only(self, tmp_path, pkg):
        src = _mkjournal(pkg, tmp_path, "src")
        dst = _mkjournal(pkg, tmp_path, "dst")
        for i in range(3):
            src.append("kv", {"i": i})
        _, _, frames, _ = src.fetch_batch(0)
        adopted = dst.ingest_frames(frames[:2] + [frames[2][:10]])
        assert [f["seq"] for f in adopted] == [1, 2]
        assert _raw_lines(dst) == frames[:2]
        adopted = dst.ingest_frames(frames[2:])
        assert [f["seq"] for f in adopted] == [3]
        assert _raw_lines(dst) == frames
        src.close()
        dst.close()

    def test_gap_stops_ingest_and_refetch_heals(self, tmp_path, pkg):
        src = _mkjournal(pkg, tmp_path, "src")
        dst = _mkjournal(pkg, tmp_path, "dst")
        for i in range(4):
            src.append("kv", {"i": i})
        _, _, frames, _ = src.fetch_batch(0)
        adopted = dst.ingest_frames([frames[0], frames[2], frames[3]])
        assert [f["seq"] for f in adopted] == [1]  # gap at 2: stop
        adopted = dst.ingest_frames(frames)  # re-fetch overlap
        assert [f["seq"] for f in adopted] == [2, 3, 4]
        src.close()
        dst.close()

    def test_ingest_snapshot_resets_log_and_primes_seq(self, tmp_path, pkg):
        src = _mkjournal(pkg, tmp_path, "src")
        dst = _mkjournal(pkg, tmp_path, "dst")
        dst.append("stale", {"old": True})  # pre-handoff garbage
        for i in range(3):
            src.append("kv", {"i": i})
        src.snapshot({"kv": {"a": 1}})
        src.append("kv", {"i": 9})
        src._ship_ring.clear()  # noqa: SLF001
        snap, snap_seq, frames, _ = src.fetch_batch(0)
        state, seq, _epoch = dst.ingest_snapshot(snap)
        assert state["kv"] == {"a": 1}
        assert seq == snap_seq
        assert _raw_lines(dst) == []  # local log reset
        adopted = dst.ingest_frames(frames)
        assert adopted and adopted[-1]["kind"] == "kv"
        assert dst.group_commit_stats()["durable_seq"] == \
            src.group_commit_stats()["durable_seq"]
        with open(dst._snap_path, "rb") as a, \
                open(src._snap_path, "rb") as b:  # noqa: SLF001
            assert a.read() == b.read()  # the snapshot adopted verbatim
        src.close()
        dst.close()


# ------------------------------------------------------- byte equality


def _ship(MasterJournal, msg, jd):
    """The same appends, compaction and tail on one package's journal;
    returns (ring pull, disk pull after the ring is outrun)."""
    j = MasterJournal(jd)
    j.load()
    j.open_epoch()
    j.append("kv_set", {"key": "a", "value": b"\x00\xff"})
    j.append("dispatch", {
        "dataset_name": "ds", "task_id": 0, "node_id": 3, "start": 0,
        "end": 8, "indices": [], "idem": "3:x:0",
        "resp": msg.Task(task_id=0, task_type="training",
                         shard=msg.ShardConfig(start=0, end=8),
                         dataset_name="ds")})
    j.append("lease", {"holder": "1", "lease_epoch": 1, "ttl_s": 1.0})
    ring = j.fetch_batch(0)
    j.snapshot({"kv": {"a": b"\x00\xff"}})
    j.append("failover", {"from_epoch": 1, "new_epoch": 3,
                          "last_shipped_seq": 4, "holder": "2"})
    j._ship_ring.clear()  # noqa: SLF001
    disk = j.fetch_batch(0)
    j.close()
    return ring, disk


def test_shipped_frames_byte_equal_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1700000000.25)
    got = {}
    for name in PKGS:
        p = _Pkg(name)
        got[name] = _ship(p.MasterJournal, p.msg, str(tmp_path / name))
    assert got["torch"] == got["jax"]
    (ring, disk) = got["torch"]
    assert len(ring[2]) == 4 and ring[3] == 4
    assert disk[0] and disk[1] == 4 and len(disk[2]) == 2  # marker + tail
    # the verb's answer, wrapped in its record, is the same bytes too
    for name in PKGS:
        p = _Pkg(name)
        snap, snap_seq, frames, durable = got[name][1]
        got[name] = p.ser.dumps(p.msg.FetchJournalResponse(
            snapshot=snap, snapshot_seq=snap_seq, frames=frames,
            durable_seq=durable, epoch=3, lease_epoch=3))
    assert got["torch"] == got["jax"]


@pytest.mark.parametrize("name", ["FetchJournalRequest",
                                  "FetchJournalResponse", "TimelineQuery",
                                  "TimelineResponse", "JournalStats"])
def test_records_byte_equal_and_cross_load(name):
    def sample(mod):
        return {
            "FetchJournalRequest": lambda: mod.FetchJournalRequest(
                node_id=-3, from_seq=9, max_frames=17),
            "FetchJournalResponse": lambda: mod.FetchJournalResponse(
                snapshot=b"\x00s", snapshot_seq=4, frames=[b"a", b"\xff"],
                durable_seq=11, epoch=3, lease_epoch=2),
            "TimelineQuery": lambda: mod.TimelineQuery(
                node_id=2, ckpt_dir="/c", journal_dirs=["/a", "/b"]),
            "TimelineResponse": lambda: mod.TimelineResponse(
                content="{}", events=5),
            "JournalStats": lambda: mod.JournalStats(
                enabled=True, shipped_seq=4, standby_lag_frames=2,
                lease_epoch=3, is_leader=False),
        }[name]()

    jobj, tobj = sample(jmsg), sample(tmsg)
    assert tser.dumps(tobj) == jser.dumps(jobj)
    assert tser.loads(jser.dumps(jobj)) == tobj
    assert jser.loads(tser.dumps(tobj)) == jobj
    assert tser.dumps(getattr(tmsg, name)()) == \
        jser.dumps(getattr(jmsg, name)())


def test_port_standby_ingests_jax_only_frames_verbatim(tmp_path):
    """A JAX primary's ``paral`` / ``policy`` frames hold message types
    the port lacks: the port's ingest decodes leniently and keeps them
    byte for byte instead of stopping there as at a torn frame."""
    src = jjournal.MasterJournal(str(tmp_path / "jax"))
    src.load()
    src.append("paral", {"config": jmsg.ParallelConfig(restart_version=1)})
    src.append("policy", {"decision": jmsg.PolicyDecision(decision_id=2)})
    src.append("kv_set", {"key": "k", "value": b"v"})
    _, _, frames, _ = src.fetch_batch(0)
    dst = tjournal.MasterJournal(str(tmp_path / "port"))
    dst.load()
    adopted = dst.ingest_frames(frames)
    assert [f["kind"] for f in adopted] == ["paral", "policy", "kv_set"]
    assert _raw_lines(dst) == _raw_lines(src)
    src.close()
    dst.close()


# ------------------------------------------------- tailer + failover e2e
# tests/test_standby.py:198-384, on both packages


def _hard_kill(master, client=None):
    """In-process stand-in for SIGKILL: stop the server, mark the
    leadership dead, and sever the client's persistent connection (a real
    process death resets the TCP stream; the server's stop only closes
    the accept loop)."""
    master._stopped.set()  # noqa: SLF001
    master._server.stop()  # noqa: SLF001
    master.is_leader = False
    if client is not None:
        client._client.close()  # noqa: SLF001


def _pair(tmp_path, primary: _Pkg, standby: _Pkg):
    m1 = primary.master(str(tmp_path / "j1"), lease_ttl_s=TTL)
    m1.start_lease_heartbeat()
    m2 = standby.master(str(tmp_path / "j2"), standby=True,
                        lease_ttl_s=TTL)
    tailer = standby.StandbyTailer(m2, f"127.0.0.1:{m1.port}",
                                   lease_ttl_s=TTL, poll_interval_s=0.05)
    return m1, m2, tailer


@pytest.fixture()
def ha_pair(tmp_path, pkg):
    """Primary (leased) + standby + armed tailer, torn down in order."""
    m1, m2, tailer = _pair(tmp_path, pkg, pkg)
    yield pkg, m1, m2, tailer
    tailer.close()
    # each stop waits out its server's poll (~0.5 s): stop both at once
    t = threading.Thread(target=m2.stop)
    t.start()
    m1.stop()
    t.join(timeout=10)
    assert not t.is_alive()


def _mirror_until_leased(m1, m2, tailer):
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        tailer.poll_once()
        if tailer._last_lease_mono and \
                m2.journal_stats().durable_seq >= \
                m1.journal_stats().durable_seq:  # noqa: SLF001
            return
        time.sleep(0.02)
    raise AssertionError("mirror never caught up / lease never armed")


def _timeline_equal(mc, tl, jd_live, jd_other):
    """Live (the answering master's dir first) against offline over the
    same ordered dirs; a leader appends a lease frame every ttl / 3, so
    the two are compared only when no frame landed around the query."""
    for _ in range(10):
        before = tl.incident_json(tl.assemble_incident(
            journal_dir=jd_live, ckpt_dir="", journal_dirs=[jd_other]))
        resp = mc.get_timeline(journal_dirs=[jd_other])
        after = tl.incident_json(tl.assemble_incident(
            journal_dir=jd_live, ckpt_dir="", journal_dirs=[jd_other]))
        if before == after:
            return resp.content, after
    raise AssertionError("the journal never held still around a query")


class TestStandbyTailer:
    def test_mirror_folds_state_and_reports_lag(self, ha_pair):
        pkg, m1, m2, tailer = ha_pair
        mc = pkg.client(f"127.0.0.1:{m1.port}")
        mc.kv_store_set("boot", b"coord")
        assert mc.kv_store_add("ctr", 2) == 2
        _mirror_until_leased(m1, m2, tailer)
        s1, s2 = m1.journal_stats(), m2.journal_stats()
        assert s1.standby_lag_frames == 0
        assert s1.shipped_seq == s1.durable_seq
        assert s2.epoch == s1.epoch  # mirrored, no spurious bump
        assert not s2.is_leader and s1.is_leader
        # folded through the SAME apply path: state readable on the mirror
        mc_sb = pkg.client(f"127.0.0.1:{m2.port}", node_id=1)
        assert mc_sb.kv_store_get("boot") == b"coord"
        mc_sb.close()
        mc.close()

    def test_standby_refuses_mutations_until_promoted(self, ha_pair):
        pkg, m1, m2, tailer = ha_pair
        rc = pkg.rpc(f"127.0.0.1:{m2.port}")
        try:
            with pytest.raises(pkg.comm.RpcError, match="NotLeaderError"):
                rc.get(pkg.msg.KVStoreSetRequest(key="nope", value=b"x"))
            # read-only verbs answer (a fenced master still reports)
            assert rc.get(pkg.msg.JournalStatsQuery()).is_leader is False
        finally:
            rc.close()

    def test_fetch_journal_is_never_journaled(self, ha_pair):
        """The fetch verb must not feed the journal it ships: idle polls
        leave the primary's seq flat (the lease thread aside)."""
        pkg, m1, m2, tailer = ha_pair
        _mirror_until_leased(m1, m2, tailer)
        m1._stopped.set()  # noqa: SLF001 — park the lease thread
        time.sleep(TTL / 3 + 0.05)
        before = m1.journal_stats().durable_seq
        for _ in range(5):
            tailer.poll_once()
        assert tailer.poll_once() == 0
        assert m1.journal_stats().durable_seq == before

    def test_no_lease_primary_makes_pure_mirror(self, tmp_path, pkg):
        """A primary that never heartbeats a lease: the standby mirrors
        and NEVER promotes (its ttl clock stays unarmed)."""
        m1 = pkg.master(str(tmp_path / "j1"))
        m2 = pkg.master(str(tmp_path / "j2"), standby=True,
                        lease_ttl_s=0.2)
        tailer = pkg.StandbyTailer(m2, f"127.0.0.1:{m1.port}",
                                   lease_ttl_s=0.2, poll_interval_s=0.02)
        try:
            mc = pkg.client(f"127.0.0.1:{m1.port}")
            mc.kv_store_set("k", b"v")
            mc.close()
            assert not tailer.run(threading.Event(), max_seconds=0.8)
            assert not m2.is_leader
            assert m2.journal_stats().durable_seq == \
                m1.journal_stats().durable_seq
        finally:
            tailer.close()
            m2.stop()
            m1.stop()

    def test_fresh_lease_mid_drain_disarms(self, ha_pair):
        """A stalled tailer whose clock reads expired must NOT promote
        while the primary still heartbeats: the final drain adopts a
        fresh lease frame and disarms."""
        pkg, m1, m2, tailer = ha_pair
        _mirror_until_leased(m1, m2, tailer)
        tailer._last_lease_mono = (  # noqa: SLF001 — forge expiry
            time.monotonic() - 10 * tailer.lease_ttl_s)
        time.sleep(tailer.lease_ttl_s)  # let the primary heartbeat
        assert not tailer.run(threading.Event(), max_seconds=1.0)
        assert not m2.is_leader
        assert m1.is_leader


class TestFailover:
    def test_promotion_fence_exactly_once_and_corpse(self, ha_pair,
                                                     tmp_path):
        pkg, m1, m2, tailer = ha_pair
        mc = pkg.client(f"127.0.0.1:{m1.port},127.0.0.1:{m2.port}")
        mc.report_dataset_shard_params(
            batch_size=4, dataset_size=64, dataset_name="ds",
            num_minibatches_per_shard=2)
        t1 = mc.get_task("ds")
        mc.kv_store_set("boot", b"coord")
        idem = "node0:add:1"
        assert mc._client.get(  # noqa: SLF001 — a fixed idem on purpose
            pkg.msg.KVStoreAddRequest(key="ctr", amount=5),
            idem=idem).num == 5
        _mirror_until_leased(m1, m2, tailer)

        old_epoch = m1.epoch
        _hard_kill(m1, mc)
        assert tailer.run(threading.Event(), max_seconds=10)
        # fenced promotion: above what a revived corpse's naive restart
        # bump (+1) could ever reach
        assert m2.is_leader
        assert m2.epoch == old_epoch + 2

        # the client fails over on its next critical verb; state intact
        t2 = mc.get_task("ds")
        assert t2.task_id != t1.task_id  # the dispatch cursor is exact
        assert mc.kv_store_get("boot") == b"coord"
        assert mc.degraded_stats()["failovers"] >= 1
        # exactly once: the original idem key replays the journaled answer
        assert mc._client.get(  # noqa: SLF001
            pkg.msg.KVStoreAddRequest(key="ctr", amount=5),
            idem=idem).num == 5
        assert mc.kv_store_add("ctr", 1) == 6

        # the corpse revives on its old journal with a peer: it observes
        # the higher epoch and fences itself read-only
        m3 = pkg.master(str(tmp_path / "j1"), peer=f"127.0.0.1:{m2.port}",
                        lease_ttl_s=TTL)
        rc = pkg.rpc(f"127.0.0.1:{m3.port}", node_id=9)
        try:
            assert not m3.is_leader
            assert m3.epoch < m2.epoch
            with pytest.raises(pkg.comm.RpcError, match="NotLeaderError"):
                rc.get(pkg.msg.KVStoreAddRequest(key="q", amount=1))
        finally:
            rc.close()
            m3.stop()
            mc.close()

    def test_timeline_merges_both_journals_byte_equal(self, ha_pair,
                                                      tmp_path):
        pkg, m1, m2, tailer = ha_pair
        jd1, jd2 = str(tmp_path / "j1"), str(tmp_path / "j2")
        mc = pkg.client(f"127.0.0.1:{m1.port},127.0.0.1:{m2.port}")
        try:
            mc.kv_store_set("k", b"v")
            _mirror_until_leased(m1, m2, tailer)
            _hard_kill(m1, mc)
            assert tailer.run(threading.Event(), max_seconds=10)
            mc.kv_store_set("after", b"failover")
            live, offline = _timeline_equal(mc, pkg.tl, jd2, jd1)
            assert live == offline  # live == offline, byte-equal
        finally:
            mc.close()
        rep = json.loads(offline)
        kinds = [i["kind"] for i in rep["narrative"]["incidents"]]
        assert "failover" in kinds
        # the merge dedups shipped frames: (epoch, seq, kind) unique and
        # (epoch, seq)-ordered across both dirs
        keys = [(e["epoch"], e["seq"], e["kind"]) for e in rep["events"]
                if e["source"] == "journal"]
        assert keys == sorted(keys, key=lambda k: k[:2])
        assert len(keys) == len(set(keys))


# ------------------------------------------------------- across packages


@pytest.mark.parametrize("primary,standby", [("torch", "jax"),
                                             ("jax", "torch")])
def test_cross_package_tailing_and_promotion(tmp_path, primary, standby):
    """A JAX standby tails a port primary and promotes, and the port's
    standby a JAX primary: the mirror is a byte prefix, the fold gives
    the same state, the epoch lands at old + 2, and a client of either
    package rides the failover."""
    p, s = _Pkg(primary), _Pkg(standby)
    m1, m2, tailer = _pair(tmp_path, p, s)
    mc = p.client(f"127.0.0.1:{m1.port},127.0.0.1:{m2.port}")
    try:
        mc.report_dataset_shard_params(
            batch_size=2, dataset_size=16, dataset_name="ds",
            num_minibatches_per_shard=2)
        t1 = mc.get_task("ds")
        mc.kv_store_set("boot", b"coord")
        assert mc.kv_store_add("ctr", 3) == 3
        _mirror_until_leased(m1, m2, tailer)
        # the mirror is a byte prefix of the primary's log
        with open(tmp_path / "j1" / "journal.frames", "rb") as a, \
                open(tmp_path / "j2" / "journal.frames", "rb") as b:
            prim, mirror = a.read(), b.read()
        assert mirror and prim.startswith(mirror)
        old = m1.epoch
        _hard_kill(m1, mc)
        assert tailer.run(threading.Event(), max_seconds=10)
        assert m2.is_leader and m2.epoch == old + 2
        t2 = mc.get_task("ds")
        assert t2.task_id not in (-1, t1.task_id)
        assert (t2.shard.start, t2.shard.end) == (4, 8)
        assert mc.kv_store_get("boot") == b"coord"
        assert mc.kv_store_add("ctr", 1) == 4
        assert m2.epoch in mc.degraded_stats()["epochs_seen"]
    finally:
        mc.close()
        tailer.close()
        m2.stop()
        m1.stop()


# ------------------------------------------------- gate, client, replay


class _CountingCache:
    """An idem cache that records every lookup."""

    MISS = object()

    def __init__(self):
        self.gets = []

    def get(self, key):
        self.gets.append(key)
        return self.MISS

    def put(self, key, resp):
        pass


class _FakeMaster:
    is_leader = False
    epoch = 4

    def __init__(self):
        self.idem_cache = _CountingCache()


def test_not_leader_bounces_before_the_idem_cache():
    """A fenced corpse's replayed cache can be stale against the new
    leader's: a mutation must bounce before any lookup."""
    m = _FakeMaster()
    svc = MasterServicer(m)
    with pytest.raises(NotLeaderError, match="epoch 4"):
        svc.handle("report", 0, "worker",
                   tmsg.KVStoreSetRequest(key="k", value=b"v"),
                   idem="0:x:1")
    assert m.idem_cache.gets == []
    jax_verbs = {"CommWorldRequest", "WaitingNodeNumRequest",
                 "KVStoreGetRequest", "KVStoreMultiGetRequest",
                 "ShardCheckpointRequest", "GoodputQuery",
                 "JournalStatsQuery", "FetchJournalRequest",
                 "ServeResultQuery", "ServeStatsQuery", "TimelineQuery"}
    from dlrover_wuqiong_tpu.master.servicer import (
        READ_ONLY_VERBS as JAX_READ_ONLY,
    )
    # the port's list is JAX's, less the verbs the port has no message for
    assert set(READ_ONLY_VERBS) == jax_verbs <= set(JAX_READ_ONLY)
    assert all(hasattr(tmsg, v) for v in READ_ONLY_VERBS)
    assert not any(hasattr(tmsg, v)
                   for v in set(JAX_READ_ONLY) - set(READ_ONLY_VERBS))


def test_client_rotates_on_a_real_not_leader_answer(tmp_path):
    """The endpoint list "standby,primary": the first dial lands on the
    standby, whose NotLeaderError answer rotates the client to the
    primary, and the verb applies there once."""
    m1 = JobMaster(port=0, host="127.0.0.1",
                   journal_dir=str(tmp_path / "j1"))
    m1.start()
    m2 = JobMaster(port=0, host="127.0.0.1",
                   journal_dir=str(tmp_path / "j2"), standby=True)
    m2.start()
    mc = MasterClient(f"{m2.addr},{m1.addr}", node_id=0,
                      outage_grace_s=GRACE_S)
    try:
        mc.kv_store_set("k", b"v")
        assert mc.degraded_stats()["failovers"] == 1
        assert m1.kv_store.get("k") == b"v"
        assert m2.kv_store.get("k") is None
        # a polling verb answers on the standby too (read-only)
        js = MasterClient(m2.addr, node_id=1,
                          outage_grace_s=0.5)
        try:
            assert js.get_journal_stats().is_leader is False
        finally:
            js.close()
    finally:
        mc.close()
        m2.stop()
        m1.stop()


def test_lease_and_failover_frames_replay_the_fence(tmp_path):
    """Replay folds ``lease`` and ``failover`` into the fencing baseline
    (no longer skipped), and a clean stop of a mirror leaves its log a
    verbatim prefix (no compaction)."""
    jd = str(tmp_path / "j")
    j = jjournal.MasterJournal(jd)
    j.load()
    j.open_epoch()
    j.append("lease", {"holder": "1", "lease_epoch": 1, "ttl_s": 1.0})
    j.append("failover", {"from_epoch": 1, "new_epoch": 3,
                          "last_shipped_seq": 2, "holder": "2"})
    j.close()
    m = JobMaster(port=0, host="127.0.0.1", journal_dir=jd, standby=True)
    m.start()
    try:
        assert m.journal_stats().lease_epoch == 3
        assert (m.epoch, m.is_leader) == (1, False)
    finally:
        m.stop()
    assert not os.path.exists(os.path.join(jd, "snapshot.frame"))


def test_restarted_promoted_standby_fences_the_corpse(tmp_path, pkg):
    """After a failover a supervisor restarts both masters with their
    original flags: the promoted standby comes back as a standby (not
    leading) but replays its ``failover`` frame to lease epoch 3, and the
    old primary, back on its epoch-1 journal with ``peer``, fences itself
    on both packages instead of leading beside it."""
    jp, js = str(tmp_path / "jp"), str(tmp_path / "js")
    p = pkg.MasterJournal(jp)
    p.load()
    p.open_epoch()
    p.append("lease", {"holder": "1", "lease_epoch": 1, "ttl_s": TTL})
    _, _, frames, _ = p.fetch_batch(0)
    p.close()
    s = pkg.MasterJournal(js)
    s.load()
    s.ingest_frames(frames)
    s.append("failover", {"from_epoch": 1, "new_epoch": 3,
                          "last_shipped_seq": 2, "holder": "2"})
    s.epoch = 2
    s.open_epoch()
    s.close()
    m2 = pkg.master(js, standby=True, lease_ttl_s=TTL)
    m1 = None
    try:
        st = m2.journal_stats()
        assert (st.is_leader, st.lease_epoch) == (False, 3)
        m1 = pkg.master(jp, peer=f"127.0.0.1:{m2.port}", lease_ttl_s=TTL)
        assert m1.is_leader is False
        rc = pkg.rpc(f"127.0.0.1:{m1.port}", node_id=9)
        try:
            with pytest.raises(pkg.comm.RpcError, match="NotLeaderError"):
                rc.get(pkg.msg.KVStoreAddRequest(key="q", amount=1))
        finally:
            rc.close()
    finally:
        if m1 is not None:
            m1.stop()
        m2.stop()


def test_fresh_primary_leads_beside_an_early_standby(tmp_path):
    """A deliberate difference from the JAX master: a standby that is up
    before its fresh primary answers epoch 1 against the empty journal's
    0 with lease epoch 0; a booting master fences only on a peer that
    leads or has a lease epoch above its own, so this primary leads
    (JAX's would stay fenced, and no lease frame would ever reach the
    standby)."""
    m2 = JobMaster(port=0, host="127.0.0.1",
                   journal_dir=str(tmp_path / "j2"), standby=True,
                   lease_ttl_s=TTL)
    m2.start()
    m1 = None
    try:
        m1 = JobMaster(port=0, host="127.0.0.1",
                       journal_dir=str(tmp_path / "j1"), peer=m2.addr,
                       lease_ttl_s=TTL)
        m1.start()
        assert (m1.is_leader, m1.epoch) == (True, 1)
        jax_m1 = JaxJobMaster(port=0, journal_dir=str(tmp_path / "jj"),
                              peer=m2.addr, lease_ttl_s=TTL)
        jax_m1.prepare()
        try:
            assert jax_m1.is_leader is False  # JAX's rule, for the record
        finally:
            jax_m1.stop()
    finally:
        if m1 is not None:
            m1.stop()
        m2.stop()


# ------------------------------------------------------------ processes


def _spawn(args, log):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    return subprocess.Popen(
        [sys.executable, "-m", "dlrover_wuqiong_tpu_torch.master",
         "--min_nodes=1", "--max_nodes=1", "--poll-interval=0.2", *args],
        env=env, cwd=REPO, stdout=log, stderr=subprocess.STDOUT,
        start_new_session=True)


def test_python_m_standby_promotes_after_sigkill(tmp_path):
    """``--standby-of`` / ``--peer`` / ``--lease-ttl`` on the port's
    ``python -m`` master: the standby promotes after the primary's
    SIGKILL, and the revived primary fences itself."""
    pp, ps = tcomm.find_free_port(), tcomm.find_free_port()
    ap, asb = f"127.0.0.1:{pp}", f"127.0.0.1:{ps}"
    log = open(tmp_path / "masters.log", "w")
    procs = []
    mc = None
    try:
        procs.append(_spawn([f"--port={pp}", "--lease-ttl=0.5",
                             f"--peer={asb}",
                             f"--journal-dir={tmp_path / 'jp'}"], log))
        procs.append(_spawn([f"--port={ps}", "--lease-ttl=0.5",
                             f"--standby-of={ap}",
                             f"--journal-dir={tmp_path / 'js'}"], log))
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and not (
                tcomm.addr_connectable(ap) and tcomm.addr_connectable(asb)):
            time.sleep(0.05)
        mc = MasterClient(f"{ap},{asb}", node_id=0, outage_grace_s=20.0)
        mc.kv_store_set("k", b"v")
        probe = tcomm.RpcClient(asb, node_id=1, retries=1, timeout=2.0)
        try:
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:  # the standby holds a lease
                if probe.get(tmsg.JournalStatsQuery()).lease_epoch == 1:
                    break
                time.sleep(0.05)
        finally:
            probe.close()
        os.killpg(procs[0].pid, signal.SIGKILL)
        procs[0].wait(timeout=10)
        assert mc.kv_store_get("k") == b"v"  # rides the failover
        mc.kv_store_set("k2", b"w")
        assert mc.epoch == 3
        procs.append(_spawn([f"--port={pp}", "--lease-ttl=0.5",
                             f"--peer={asb}",
                             f"--journal-dir={tmp_path / 'jp'}"], log))
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and \
                not tcomm.addr_connectable(ap):
            time.sleep(0.05)
        rc = tcomm.RpcClient(ap, node_id=9, retries=1, timeout=2.0)
        try:
            js = rc.get(tmsg.JournalStatsQuery())
            assert (js.is_leader, js.epoch) == (False, 1)
            with pytest.raises(tcomm.RpcError, match="NotLeaderError"):
                rc.report(tmsg.KVStoreSetRequest(key="x", value=b"y"))
        finally:
            rc.close()
    finally:
        if mc is not None:
            mc.close()
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
            p.wait(timeout=10)
        log.close()
