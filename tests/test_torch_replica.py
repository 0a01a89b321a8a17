"""Port parity: the checkpoint replica ring (checkpoint/replica.py).

The port's ring against the JAX package's (a jax-free module on both
sides):

- a frame the port's `_send_msg` writes is byte-equal to JAX's;
- ring successors equal JAX's for 1-8 ranks and fan-outs 0-3, with one
  server a rank and with two ranks an agent;
- the blob helpers (`verify_segment_blob`, `blob_state_dict`) give JAX's
  answers on the same blob, whole and faulted;
- a port manager backs up to a JAX `ReplicaServer` and a JAX manager
  restores the blob, and the other way round: the restored segments are
  byte-equal to the staged one;
- tests/test_replica.py's `TestReplica` cases hold on the port;
- GPT nano resumes bitwise from tier "replica", and a corrupt blob falls
  through to storage; `on_degraded_restore` and the saver's
  `post_save_hook` fire; a segment the ring restores in an agent carries
  the agent as its owner, so another job's sweep spares it;
- a segment re-created larger under a saver's mapping (ROADMAP queue 3):
  the saver re-attaches and commits the new step;
- ``chaos ckpt-corrupt --device cpu`` passes, and the node-loss drill
  (trainer/drill.py) resumes a lost node of a 2-agent gloo world from the
  ring, bitwise, at nano.

Every server binds 127.0.0.1 port 0 and is stopped; every segment is
unlinked; the port's saver singleton and ledger are reset around each
test.
"""

import dataclasses
import os
import socket

import numpy as np
import pytest
import torch

from dlrover_wuqiong_tpu.checkpoint import replica as jrep
from dlrover_wuqiong_tpu.checkpoint import shm_handler as jshm
from dlrover_wuqiong_tpu_torch.checkpoint import replica as trep
from dlrover_wuqiong_tpu_torch.checkpoint import shm_handler as tshm
from dlrover_wuqiong_tpu_torch.checkpoint.checkpointer import (
    FlashCheckpointer,
    StorageType,
)
from dlrover_wuqiong_tpu_torch.checkpoint.ckpt_saver import (
    AsyncCheckpointSaver,
    read_last_step,
)
from dlrover_wuqiong_tpu_torch.checkpoint.shm_handler import (
    SharedMemoryHandler,
    flatten_state_dict,
)
from dlrover_wuqiong_tpu_torch.convert import load_params
from dlrover_wuqiong_tpu_torch.models import gpt as tgpt
from dlrover_wuqiong_tpu_torch.telemetry.ledger import (
    get_ledger,
    reset_ledger,
)
from dlrover_wuqiong_tpu_torch.trainer.train_step import (
    TrainState,
    adamw,
    make_lm_loss,
    make_train_step,
)
from torch_threads import one_torch_thread  # noqa: F401

HEADER = 1 << 20
VOCAB, SEQ, BATCH = 512, 32, 4
#: a manager's dial of the segment's lock where no saver hosts it (the
#: backup then copies unlocked, as the JAX manager does)
LOCK_S = 0.1


def _job(tag: str) -> str:
    return f"tr{os.getpid()}-{tag}"


@pytest.fixture(autouse=True)
def _fresh_saver():
    AsyncCheckpointSaver.reset()
    reset_ledger()
    yield
    AsyncCheckpointSaver.reset()
    reset_ledger()


@pytest.fixture
def jobs():
    """Job names for a test; their segments are unlinked after it."""
    made = []

    def make(tag):
        made.append(_job(tag))
        return made[-1]

    yield make
    for job in made:
        SharedMemoryHandler(0, job).unlink()


@pytest.fixture
def servers():
    """``servers(pkg, n)`` starts n ReplicaServers of the port ("t") or
    of JAX ("j") on 127.0.0.1; each is stopped after the test."""
    started = []

    def make(pkg="t", n=1):
        mod = trep if pkg == "t" else jrep
        out = []
        for _ in range(n):
            s = mod.ReplicaServer(host="127.0.0.1")
            s.start()
            started.append(s)
            out.append(s)
        return out

    yield make
    for s in started:
        try:
            s.stop()
        except Exception:  # noqa: BLE001 — a test may stop one itself
            pass


def _addr(server) -> str:
    return f"127.0.0.1:{server.port}"


def _state(step: float = 1.0):
    """A torch tree with a bfloat16 leaf (numpy lacks the dtype)."""
    return {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8) * step,
            "b": torch.ones(8, dtype=torch.bfloat16) * step,
            "step": torch.tensor(int(step), dtype=torch.int64)}


def _segment_bytes(handler) -> bytes:
    header = handler.load_header()
    end = max(m["offset"] + m["nbytes"] for m in header["metas"])
    return bytes(handler._buf.buf[:end])


# ------------------------------------------------------------------ frames


def _frame(mod, header, payload) -> bytes:
    a, b = socket.socketpair()
    with a, b:
        mod._send_msg(a, header, payload)
        a.shutdown(socket.SHUT_WR)
        out = bytearray()
        while True:
            chunk = b.recv(1 << 16)
            if not chunk:
                return bytes(out)
            out.extend(chunk)


@pytest.mark.parametrize("header,payload", [
    ({"op": "query", "owner": 3}, b""),
    ({"op": "put", "owner": 0, "step": 20}, bytes(range(256)) * 9),
    ({"found": True, "step": 7, "note": "é"}, b"\x00" * 5)])
def test_frames_byte_equal_to_jax(header, payload):
    port = _frame(trep, header, payload)
    assert port == _frame(jrep, header, payload)
    a, b = socket.socketpair()
    with a, b:
        a.sendall(port)
        got_header, got_payload = trep._recv_msg(b)
    assert (got_header, bytes(got_payload)) == (header, payload)


# -------------------------------------------------------------- successors


@pytest.mark.parametrize("n", range(1, 9))
@pytest.mark.parametrize("count", range(4))
def test_successors_equal_jax(n, count):
    """Every owner's walk, with one server a rank and with two ranks an
    agent (a shared address), through `_successors_of` and through
    `_successors` at the fan-out."""
    layouts = [{r: f"h:{r}" for r in range(n)},
               {r: f"h:{r // 2}" for r in range(n)}]
    for peers in layouts:
        for owner in range(n):
            t = trep.CkptReplicaManager(owner, peers, job_name="ts",
                                        replica_count=count)
            j = jrep.CkptReplicaManager(owner, peers, job_name="js",
                                        replica_count=count)
            try:
                assert t._successors_of(owner, count) == \
                    j._successors_of(owner, count)
                assert t._successors_of(owner) == j._successors_of(owner)
                assert t._successors() == j._successors()
            finally:
                t.close()
                j.close()


# ---------------------------------------------------------------- blobs


def _blob(job):
    h = SharedMemoryHandler(0, job)
    h.save_state_dict(_state(3.0), step=3)
    return _segment_bytes(h)


def _faulted(blob: bytes, fault: str) -> bytes:
    raw = bytearray(blob)
    if fault == "header-flip":
        raw[20] ^= 0x01
    elif fault == "leaf-flip":
        raw[HEADER] ^= 0x01
    elif fault == "truncated":
        raw = raw[:-8]
    elif fault == "empty-length":
        raw[0:8] = bytes(8)
    return bytes(raw)


@pytest.mark.parametrize("fault", ["none", "header-flip", "leaf-flip",
                                   "truncated", "empty-length"])
def test_blob_helpers_match_jax(fault, jobs):
    """Verification gives JAX's (step, reason); decoding, which callers
    run only on a verified blob, gives JAX's arrays, or raises as JAX's
    does where a leaf runs past the blob's end."""
    blob = _faulted(_blob(jobs("blob")), fault)
    assert tshm.verify_segment_blob(blob) == jshm.verify_segment_blob(blob)
    if fault == "truncated":
        for mod in (tshm, jshm):
            with pytest.raises(ValueError):
                mod.blob_state_dict(blob)
        return
    port, ref = tshm.blob_state_dict(blob), jshm.blob_state_dict(blob)
    assert (port is None) == (ref is None)
    if port is None:
        return
    assert port[0] == ref[0] and port[2] == ref[2]
    assert sorted(port[1]) == sorted(ref[1])
    for name, arr in port[1].items():
        # JAX reads bfloat16 as ml_dtypes' bfloat16, the port as uint16
        assert arr.shape == ref[1][name].shape
        assert arr.tobytes() == ref[1][name].tobytes()


# ------------------------------------------------- across the two packages


@pytest.mark.parametrize("direction", ["port-to-jax", "jax-to-port"])
def test_cross_package_backup_and_restore(direction, jobs, servers):
    """The writer's manager backs up to the other package's server; the
    other package's manager restores it: the segment is byte-equal."""
    job = jobs(f"x{direction[:4]}")
    if direction == "port-to-jax":
        writer, reader, holder = trep, jrep, servers("j")[0]
        SharedMemoryHandler(0, job).save_state_dict(_state(5.0), step=5)
    else:
        writer, reader, holder = jrep, trep, servers("t")[0]
        jshm.SharedMemoryHandler(0, job).save_state_dict(
            {"w": np.arange(64, dtype=np.float32).reshape(8, 8),
             "step": np.int64(5)}, step=5)
    staged = _segment_bytes(SharedMemoryHandler(0, job))
    peers = {1: _addr(holder)}
    m = writer.CkptReplicaManager(0, peers, job_name=job, timeout=10.0,
                                  lock_timeout=LOCK_S)
    try:
        assert m.backup() == 1
    finally:
        m.close()
    SharedMemoryHandler(0, job).unlink()
    r = reader.CkptReplicaManager(0, peers, job_name=job, timeout=10.0)
    try:
        assert r.restore() == 5
    finally:
        r.close()
    assert _segment_bytes(SharedMemoryHandler(0, job)) == staged


# ------------------------------------------- tests/test_replica.py, ported


class TestReplica:
    def _pair(self, servers, jobs, tag, n=2):
        srvs = servers("t", n)
        peers = {r: _addr(s) for r, s in enumerate(srvs)}
        names = [jobs(f"{tag}{r}") for r in range(n)]
        mgrs = [trep.CkptReplicaManager(r, peers, job_name=names[r],
                                        timeout=5.0, lock_timeout=LOCK_S)
                for r in range(n)]
        return srvs, peers, names, mgrs

    def test_ring_backup_and_peer_restore(self, servers, jobs):
        _, peers, names, (m0, m1) = self._pair(servers, jobs, "br")
        state = _state(7.0)
        SharedMemoryHandler(0, names[0]).save_state_dict(state, step=7)
        assert m0.backup() == 1  # shipped to rank 1's server
        # node 0 dies: wipe its shm; a replacement manager restores from
        # the peer WITHOUT any storage involved
        SharedMemoryHandler(0, names[0]).unlink()
        m0b = trep.CkptReplicaManager(0, peers, job_name=names[0])
        try:
            assert m0b.restore() == 7
            assert m0b.restored_from == 1
        finally:
            m0b.close()
            m0.close()
            m1.close()
        rstep, flat, _, _ = SharedMemoryHandler(
            0, names[0]).load_state_dict()
        assert rstep == 7
        for name, t in flatten_state_dict(state).items():
            want = t.reshape(-1).view(torch.uint8).numpy() \
                if t.dtype == torch.bfloat16 else t.numpy()
            assert flat[name].tobytes() == np.ascontiguousarray(
                want).tobytes()

    def test_restore_without_backup_returns_none(self, servers, jobs):
        _, _, _, (m0, m1) = self._pair(servers, jobs, "nb")
        assert m0.restore() is None
        m0.close()
        m1.close()

    def test_backup_skips_empty_shm(self, servers, jobs):
        _, _, _, (m0, m1) = self._pair(servers, jobs, "em")
        assert m0.backup() == 0
        m0.close()
        m1.close()

    def test_never_ships_to_own_server(self, servers, jobs):
        """Successors skip the owner's own address (two ranks an agent),
        and a backup whose every peer is its own server sends nothing."""
        peers = {0: "a", 1: "a", 2: "b", 3: "b"}
        m = trep.CkptReplicaManager(0, peers, job_name="t-shared",
                                    replica_count=4)
        assert m._successors() == [2]
        assert m._successors(count=len(peers)) == [2]
        m.close()
        (server,) = servers("t")
        job = jobs("own")
        own = {0: _addr(server), 1: _addr(server)}
        m0 = trep.CkptReplicaManager(0, own, job_name=job,
                                     lock_timeout=LOCK_S)
        try:
            SharedMemoryHandler(0, job).save_state_dict(_state(), step=3)
            assert m0.backup() == 0
            assert server._get(0) is None
        finally:
            m0.close()

    def test_restore_fails_over_corrupt_holder(self, servers, jobs,
                                               tmp_path):
        srvs, peers, names, mgrs = self._pair(servers, jobs, "co", n=3)
        health = []
        mgrs[0].replica_count = 2
        state = _state(5.0)
        SharedMemoryHandler(0, names[0]).save_state_dict(state, step=5)
        assert mgrs[0].backup() == 2
        step, blob = srvs[1]._store[0]
        srvs[1]._store[0] = (step, blob[:-4] + b"\x00\x00\x00\x00")
        SharedMemoryHandler(0, names[0]).unlink()
        m0b = trep.CkptReplicaManager(0, peers, job_name=names[0],
                                      replica_count=2,
                                      health_hook=health.append,
                                      quarantine_dir=str(tmp_path))
        try:
            assert m0b.restore() == 5
            assert m0b.restored_from == 2
        finally:
            m0b.close()
            for m in mgrs:
                m.close()
        _, flat, _, _ = SharedMemoryHandler(0, names[0]).load_state_dict()
        assert flat["w"].tobytes() == state["w"].numpy().tobytes()
        # the skipped holder was reported and its bytes kept as evidence
        assert health and "holder rank 1" in health[0]
        assert list(tmp_path.glob("owner0-holder1.*.blob"))
        assert list(tmp_path.glob("owner0-holder1.*.reason"))

    def test_restore_fails_over_dead_holder(self, servers, jobs):
        srvs, peers, names, mgrs = self._pair(servers, jobs, "de", n=3)
        mgrs[0].replica_count = 2
        SharedMemoryHandler(0, names[0]).save_state_dict(_state(9.0),
                                                         step=9)
        assert mgrs[0].backup() == 2
        srvs[1].stop()  # the nearest holder dies with its node
        SharedMemoryHandler(0, names[0]).unlink()
        m0b = trep.CkptReplicaManager(0, peers, job_name=names[0],
                                      replica_count=2)
        try:
            assert m0b.restore() == 9
            assert m0b.restored_from == 2
        finally:
            m0b.close()
            for m in mgrs:
                m.close()

    def test_fetch_peer_returns_verified_blob(self, servers, jobs):
        """A survivor pulls a dead rank's segment from its holders
        without touching its own shm; the blob decodes as JAX's helper
        decodes it."""
        _, _, names, mgrs = self._pair(servers, jobs, "fp", n=3)
        SharedMemoryHandler(0, names[0]).save_state_dict(_state(11.0),
                                                         step=11)
        staged = _segment_bytes(SharedMemoryHandler(0, names[0]))
        assert mgrs[0].backup() == 1  # held by rank 1
        try:
            step, blob = mgrs[2].fetch_peer(0)
            assert step == 11 and bytes(blob) == staged
            pstep, flat, _ = tshm.blob_state_dict(blob)
            jstep, jflat, _ = jshm.blob_state_dict(bytes(blob))
            assert pstep == jstep == 11
            assert {k: v.tobytes() for k, v in flat.items()} == \
                {k: v.tobytes() for k, v in jflat.items()}
            assert not mgrs[2].has_local_segment()
        finally:
            for m in mgrs:
                m.close()

    def test_newer_backup_replaces_older(self, servers, jobs):
        _, peers, names, (m0, m1) = self._pair(servers, jobs, "nw")
        shm0 = SharedMemoryHandler(0, names[0])
        shm0.save_state_dict({"x": torch.zeros(4)}, step=1)
        m0.backup()
        shm0.save_state_dict({"x": torch.full((4,), 9.0)}, step=2)
        m0.backup()
        shm0.unlink()
        m0b = trep.CkptReplicaManager(0, peers, job_name=names[0])
        try:
            assert m0b.restore() == 2
        finally:
            m0b.close()
            m0.close()
            m1.close()
        _, flat, _, _ = SharedMemoryHandler(0, names[0]).load_state_dict()
        np.testing.assert_array_equal(flat["x"], np.full(4, 9.0))


# ------------------------------------------------ the engine's replica tier


def _cfg():
    return dataclasses.replace(tgpt.GPTConfig.nano(), dtype=torch.float32,
                               remat=False)


_STEP = make_train_step(make_lm_loss())


def _steps(state, steps):
    losses = []
    for i in steps:
        x = np.random.default_rng(i).integers(0, VOCAB, (BATCH, SEQ + 1))
        batch = {"input_ids": torch.from_numpy(x[:, :-1]),
                 "labels": torch.from_numpy(x[:, 1:])}
        state, m = _STEP(state, batch)
        losses.append(m["loss"].item())
    return losses


def _nano(seed):
    params = tgpt.init_params(_cfg(), seed=seed, device="cpu")
    return TrainState.create(load_params(tgpt.GPT(_cfg()), params, "cpu"),
                             adamw(3e-4))


@pytest.mark.parametrize("held", ["whole", "corrupt"])
def test_resume_from_replica_tier_at_nano(held, tmp_path, servers, jobs):
    """GPT nano: 3 steps, a committed save, its segment backed up, 2 more
    steps; then a byte of the local segment is flipped and a model from
    another seed restores.  A whole blob serves it (tier "replica", the
    degraded hook fired, no storage read); a corrupt one falls through
    to storage, lists the replica fallback and fires the health hook.
    Either way the resumed steps are bitwise the uninterrupted ones."""
    (holder,) = servers("t")
    job = jobs(f"nano{held}")
    health, degraded = [], []
    mgr = trep.CkptReplicaManager(0, {1: _addr(holder)}, job_name=job,
                                  health_hook=health.append,
                                  quarantine_dir=str(tmp_path / "q"))
    ck = FlashCheckpointer(str(tmp_path / "ck"), job_name=job,
                           standalone=True, replica_fetch=mgr.restore)
    ck.replica_manager = mgr
    ck.engine.on_degraded_restore = degraded.append
    try:
        state = _nano(0)
        _steps(state, range(3))
        ck.save_checkpoint(3, state.tree(), StorageType.DISK)
        assert ck.wait_latest_checkpoint(30)
        assert mgr.backup() == 1
        want = _steps(state, [3, 4])
        if held == "corrupt":
            with holder._lock:
                step, blob = holder._store[0]
                bad = bytearray(blob)
                bad[HEADER + 1] ^= 0x10
                holder._store[0] = (step, bytes(bad))
        ck.engine._shm_handler._buf.buf[HEADER] ^= 0xFF
        other = _nano(1)
        assert ck.load_checkpoint(other) is other
        rep = ck.last_restore_report
        ck.set_replica_count(3)  # one peer: the manager holds it at 0
        assert mgr.replica_count == 0
    finally:
        ck.close()
        mgr.close()
    states = get_ledger().snapshot()["states"]
    assert states.get("restore_replica", 0.0) > 0
    if held == "whole":
        assert (rep["tier"], rep["step"], rep["healed"]) == \
            ("replica", 3, True)
        assert states.get("restore_storage", 0.0) == 0.0
        assert health == []
    else:
        assert (rep["tier"], rep["step"]) == ("storage", 3)
        assert {"tier": "replica", "reason": "no-verified-copy"} in \
            rep["fallbacks"]
        assert len(health) == 1 and "leaf-digest-mismatch" in health[0]
    assert rep["fallbacks"][0]["tier"] == "shm"
    assert degraded == [3]
    assert _steps(other, [3, 4]) == want


def test_post_save_hook_fires_after_each_persist(tmp_path, jobs):
    """The saver calls its hook with the step after a committed persist
    (the agent's ring backup); a hook that raises is only logged."""
    job = jobs("hook")
    ck = FlashCheckpointer(str(tmp_path / "ck"), job_name=job,
                           standalone=True)
    seen = []

    def hook(step):
        seen.append(step)
        raise RuntimeError("a backup failed")

    ck.engine._saver.post_save_hook = hook
    try:
        for step in (2, 4):
            ck.save_checkpoint(step, _state(step), StorageType.DISK)
            assert ck.wait_latest_checkpoint(30)
        ck.save_checkpoint(5, _state(5), StorageType.MEMORY)
        ck.wait_staging()
    finally:
        ck.close()
    assert seen == [2, 4]
    assert read_last_step(str(tmp_path / "ck")) == 4


def test_restored_segment_owner_survives_another_jobs_sweep(servers, jobs):
    """The blob names its staging process, which died with its node: the
    port's restore stamps the restoring process (the agent) as the
    owner, so the segment survives another job's sweep of dead
    creators' segments; the JAX manager's restore, which writes the blob
    as it is, leaves one the sweep reaps.

    The staging process is a live subprocess until both restores are
    done, and dies just before this test's sweep: no segment in
    /dev/shm names a dead pid while another test's saver, starting
    beside this one, may sweep."""
    import subprocess
    import sys

    stager = subprocess.Popen([sys.executable, "-c",
                               "import time; time.sleep(600)"])
    try:
        (holder,) = servers("t")
        kept, reaped = jobs("keep"), jobs("reap")
        for job, restorer in ((kept, trep), (reaped, jrep)):
            SharedMemoryHandler(0, job).save_state_dict(
                _state(), step=6, extra_meta={"_pid": stager.pid})
            m = trep.CkptReplicaManager(0, {1: _addr(holder)},
                                        job_name=job, lock_timeout=LOCK_S)
            assert m.backup() == 1
            m.close()
            SharedMemoryHandler(0, job).unlink()
            r = restorer.CkptReplicaManager(0, {1: _addr(holder)},
                                            job_name=job,
                                            lock_timeout=LOCK_S)
            assert r.restore() == 6
            r.close()
            with holder._lock:
                holder._store.clear()
    finally:
        stager.kill()
        stager.wait()
    header = SharedMemoryHandler(0, kept).load_header()
    assert header["extra"]["_pid"] == os.getpid()
    assert SharedMemoryHandler(0, kept).verify() == (True, "")
    swept = tshm.sweep_stale_segments(jobs("sweeper"))
    assert f"{reaped}_ckpt_shm_0" in swept
    assert f"{kept}_ckpt_shm_0" not in swept
    assert SharedMemoryHandler(0, kept).load_header()["step"] == 6


def test_saver_follows_a_segment_recreated_larger(tmp_path, jobs):
    """A segment re-created for a larger state (another inode, another
    size) under the saver's mapping: the saver re-attaches and commits
    the new step (its old mapping held the old step: "shm holds step 2,
    expected 4")."""
    job = jobs("grow")
    ckpt_dir = str(tmp_path / "ck")
    ck = FlashCheckpointer(ckpt_dir, job_name=job, standalone=True)
    saver = ck.engine._saver
    try:
        ck.save_checkpoint(2, {"w": torch.ones(16)}, StorageType.DISK)
        assert ck.wait_latest_checkpoint(30)
        old = os.stat(f"/dev/shm/{job}_ckpt_shm_0")
        # another writer (a replacement process, the ring) re-creates the
        # segment for a state that does not fit the old one
        big = SharedMemoryHandler(0, job)
        big.save_state_dict({"w": torch.full((1 << 19,), 4.0)}, step=4,
                            extra_meta={"_ckpt_dir": ckpt_dir})
        new = os.stat(f"/dev/shm/{job}_ckpt_shm_0")
        assert (new.st_ino, new.st_size) != (old.st_ino, old.st_size)
        big.close()
        saver.save_step_checkpoint(4, ckpt_dir, commit_timeout=10)
        assert read_last_step(ckpt_dir) == 4
        flat = ck.engine.load_from_storage(ckpt_dir, 4)
        assert np.array_equal(np.asarray(flat["w"]),
                              np.full(1 << 19, 4.0, np.float32))
    finally:
        ck.close()


def test_checkpoint_replica_context_field(monkeypatch):
    """``DWT_CTX_CHECKPOINT_REPLICA`` sets the ring's fan-out; the
    default keeps the ring off, as JAX's context does."""
    from dlrover_wuqiong_tpu.common.global_context import Context as JCtx
    from dlrover_wuqiong_tpu_torch.common.global_context import Context

    assert Context().checkpoint_replica == JCtx().checkpoint_replica == 0
    monkeypatch.setenv("DWT_CTX_CHECKPOINT_REPLICA", "2")
    ctx = Context()
    ctx._load_env()
    assert ctx.checkpoint_replica == 2


def test_replacement_agent_waits_for_a_new_world():
    """A fresh agent replacing a lost node under the same node id does
    not take the world the master still lists that node in (round 1,
    whose coordinator is gone): it waits for the world its join starts,
    which forms when the survivor re-joins."""
    import threading
    import time

    from dlrover_wuqiong_tpu_torch.agent.elastic_agent import (
        ElasticAgent,
        ElasticLaunchConfig,
    )
    from dlrover_wuqiong_tpu_torch.agent.master_client import MasterClient
    from dlrover_wuqiong_tpu_torch.master.master import JobMaster

    m = JobMaster(port=0, min_nodes=2, max_nodes=2, host="127.0.0.1")
    m.start()
    mc = MasterClient(m.addr, 1, outage_grace_s=0.5)
    try:
        rdzv = m.rdzv_manager("elastic-training")
        for nid in (0, 1):
            rdzv.join_rendezvous(nid, nid, 1, "127.0.0.1", 1000 + nid)
        assert rdzv.get_comm_world(0)[0] == 1
        agent = ElasticAgent(ElasticLaunchConfig(min_nodes=2, max_nodes=2,
                                                 rdzv_timeout=30),
                             mc, node_id=1, node_rank=1)
        out = {}
        t = threading.Thread(target=lambda: out.update(w=agent.rendezvous()))
        t.start()
        deadline = time.monotonic() + 10
        while rdzv.num_nodes_waiting() < 1 and time.monotonic() < deadline:
            time.sleep(0.05)
        time.sleep(1.2)  # the agent polls the comm world twice a second
        assert "w" not in out, vars(out["w"])
        rdzv.join_rendezvous(0, 0, 1, "127.0.0.1", 2000)  # the survivor
        t.join(timeout=30)
        w = out["w"]
        assert (w.rdzv_round, w.process_id, w.num_processes) == (2, 1, 2)
        assert w.coordinator_addr == "127.0.0.1:2000"
    finally:
        mc.close()
        m.stop()


# ------------------------------------------------------------------ drills


def test_chaos_ckpt_corrupt_on_cpu():
    from dlrover_wuqiong_tpu_torch import chaos

    report = chaos.ckpt_corrupt(device="cpu")
    assert report["ok"], report
    assert [c["fault"] for c in report["cases"]] == [
        "shm-flip->replica", "shm+replica-flip->storage",
        "storage-flip->older-gen", "truncated-leaf->older-gen",
        "missing-manifest->older-gen", "stale-generation-only",
        "sigkill-mid-persist"]
    assert report["silent_restores"] == 0
    assert report["doctor"]["flagged_steps"] == [4]


def test_node_loss_drill_at_nano(monkeypatch, tmp_path):
    """Two agents of a gloo world, node 1 lost after step 20: its new
    agent restores the segment from node 0's holder, its worker resumes
    from shm with no storage read, node 0 from its own shm, and every
    loss of both ranks is bitwise its uninterrupted run's.  Every process
    runs torch on one CPU thread (the same reduction order everywhere,
    no oversubscription beside the suite's other workers)."""
    from dlrover_wuqiong_tpu_torch.trainer import drill

    knobs = dict(model="nano", device="cpu", batch=2, seq=32,
                 **drill.NODE_LOSS)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ref = {}
        for rank in (0, 1):
            monkeypatch.setenv("DWT_JOB_NAME", _job(f"nlref{rank}"))
            ref[rank] = drill.uninterrupted_losses(
                rank, str(tmp_path / f"ref{rank}"), **knobs)
    finally:
        torch.set_num_threads(threads)
    monkeypatch.delenv("DWT_JOB_NAME")
    r = drill.node_loss_drill(timeout_s=180, **knobs)
    checks = drill.node_loss_checks(r, ref, 0)
    assert all(checks.values()), (checks, r)
    assert r["split"]["ring_restore_s"] > 0
    for job in r["jobs"]:
        assert not os.path.exists(f"/dev/shm/{job}_ckpt_shm_0")
