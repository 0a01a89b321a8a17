"""Cross-node in-memory checkpoint replication (flash-ckpt replica tier).

Parity: dlrover_wuqiong_tpu/checkpoint/replica.py:1-440 (no JAX), copied
whole: the same frames (``DWTR``, big-endian header and payload lengths,
a JSON header, the raw segment as payload), the same `ReplicaServer`
verbs (put, get, query), and the same `CkptReplicaManager`: ring
successors deduplicated by address, `backup` of the verified staged
segment, `restore` into local shm with per-holder failover, `fetch_peer`
newest-first with digest verification before any decode, quarantine of
a corrupt holder's blob with a ``ckpt-health`` hook, `_rpc` under the
repo's retry policy (common/util.py `retry_call`).  A port agent and a
JAX agent can back each other up: the segment format is byte-equal
(shm_handler.py).

The JAX module's own parity: reference
`trainer/torch/flash_checkpoint/replica.py` — `CkptReplicaManger` (:28),
`ShardCkptReplicaManager.backup` (:114, ring backup of local shm via
gloo broadcast) and `.gather` (:191, pull a lost shard from its backup
holder on node replacement).  As there, no process group is used:
replication is a direct TCP exchange between agents, length-prefixed
binary frames (segments are hundreds of MB; the JSON control-plane
framing is wrong for bulk bytes).  Each node ships its staged segment to
`replica_count` ring successors after a save; a replacement node
restores its segment from any holder WITHOUT touching persistent
storage.

Two differences.  `_recv_exact` reads into one buffer of the frame's
size (``recv_into``) and returns it, where the JAX function grows a
``bytearray`` and copies it into ``bytes`` — for GPT-2 124M's 1.49 GB
segment that is one copy of the state less per transfer; the frames are
the same.  And `restore` stamps the restoring process as the segment's
owner (``extra._pid``): the blob carries the pid of the process that
staged it on the lost node, and another job's saver, sweeping the
segments of dead creators, would reap it.  In an agent that is the
agent, as a launched worker stamps its agent (engine.py).  The JAX
manager writes the blob as it is.
"""

from __future__ import annotations

import json
import os
import socket
import socketserver
import struct
import tempfile
import threading
import time
from typing import Dict, Optional, Tuple

from ..common.log import get_logger
from .shm_handler import SharedMemoryHandler, verify_segment_blob

logger = get_logger("ckpt_replica")

_MAGIC = b"DWTR"
_CHUNK = 1 << 20


def _send_msg(sock: socket.socket, header: Dict, payload=b""):
    h = json.dumps(header).encode()
    sock.sendall(_MAGIC + struct.pack(">II", len(h), len(payload)))
    sock.sendall(h)
    if payload:
        sock.sendall(payload)


def _recv_exact(sock: socket.socket, n: int) -> bytearray:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], min(_CHUNK, n - got))
        if not k:
            raise ConnectionError("peer closed")
        got += k
    return buf


def _recv_msg(sock: socket.socket) -> Tuple[Dict, bytearray]:
    head = _recv_exact(sock, 12)
    if head[:4] != _MAGIC:
        raise ConnectionError("bad magic")
    hlen, plen = struct.unpack(">II", head[4:])
    header = json.loads(_recv_exact(sock, hlen).decode())
    payload = _recv_exact(sock, plen) if plen else bytearray()
    return header, payload


class ReplicaServer:
    """Holds backup segments for peer nodes; serves put/get/query."""

    def __init__(self, host: str = "0.0.0.0", port: int = 0,
                 max_bytes: int = 8 << 30):
        self._store: Dict[int, Tuple[int, bytes]] = {}  # owner → (step, blob)
        self._lock = threading.Lock()
        self._max_bytes = max_bytes
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                try:
                    header, payload = _recv_msg(self.request)
                except (ConnectionError, ValueError, json.JSONDecodeError):
                    return
                op = header.get("op")
                if op == "put":
                    stored = outer._put(int(header["owner"]),
                                        int(header["step"]), payload)
                    _send_msg(self.request, {"ok": stored})
                elif op == "get":
                    entry = outer._get(int(header["owner"]))
                    if entry is None:
                        _send_msg(self.request, {"found": False})
                    else:
                        step, blob = entry
                        _send_msg(self.request,
                                  {"found": True, "step": step}, blob)
                elif op == "query":
                    entry = outer._get(int(header["owner"]))
                    _send_msg(self.request, {
                        "found": entry is not None,
                        "step": entry[0] if entry else -1})

        class Server(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._server = Server((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def _put(self, owner: int, step: int, blob) -> bool:
        with self._lock:
            total = sum(len(b) for o, (s, b) in self._store.items()
                        if o != owner)
            if total + len(blob) > self._max_bytes:
                logger.warning("replica store full — rejecting backup of "
                               "rank %d", owner)
                return False
            self._store[owner] = (step, blob)
        logger.info("holding backup of rank %d step %d (%.1f MB)", owner,
                    step, len(blob) / 1e6)
        return True

    def _get(self, owner: int) -> Optional[Tuple[int, bytes]]:
        with self._lock:
            return self._store.get(owner)

    def start(self):
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True,
                                        name="dwt-replica-server")
        self._thread.start()

    def stop(self):
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None


class CkptReplicaManager:
    """Node-side replication driver.

    backup(): ship my staged shm segment to the ring successor(s).
    restore(): repopulate my shm segment from whichever peer holds my
    backup — called by a replacement node before falling back to storage.
    """

    def __init__(self, rank: int, peers: Dict[int, str],
                 job_name: str = "dwt", local_rank: int = 0,
                 replica_count: int = 1, timeout: float = 120.0,
                 lock_timeout: float = 2.0, health_hook=None,
                 quarantine_dir: str = ""):
        """peers: rank → "host:port" of every node's ReplicaServer.

        `timeout` bounds peer TRANSFERS (big blobs between hosts);
        `lock_timeout` bounds the shm staging-lock acquire separately — a
        missing lock server (no saver running: standalone replica use,
        tests) must cost seconds, not the full transfer budget, or every
        backup() waits out a 150s dial to a unix socket that will never
        exist.

        `health_hook(reason)` is called on every verification failure of
        a pulled blob (the agent wires it to a ckpt-health node event —
        corruption in a holder's store must be REPORTED, never silently
        absorbed); `quarantine_dir` overrides where corrupt-blob evidence
        is kept (defaults to a job-scoped tempdir sidecar)."""
        from ..common.multi_process import SharedLock
        from .ckpt_saver import shm_lock_name

        self.rank = rank
        self.peers = dict(peers)
        self.job_name = job_name
        self.replica_count = max(0, replica_count)
        self.timeout = timeout
        self.lock_timeout = lock_timeout
        self.health_hook = health_hook
        # the holder rank the last successful restore() pulled from
        self.restored_from: Optional[int] = None
        # seconds of the last backup() by part: the wait for the
        # segment's lock, the copy made under it, the digest check, the
        # transfers
        self.last_backup: Dict[str, float] = {}
        self.quarantine_dir = quarantine_dir or os.path.join(
            tempfile.gettempdir(), f"dwt-{job_name}-replica.quarantine")
        self._shm = SharedMemoryHandler(local_rank, job_name)
        # same lock the saver/engine use: a concurrent drain restaging the
        # segment must not tear the copy we ship
        self._seg_lock = SharedLock(shm_lock_name(job_name, local_rank),
                                    master=False)

    def has_local_segment(self) -> bool:
        return self._shm.load_header() is not None

    def set_replica_count(self, count: int):
        """Adaptive-policy knob: effective on the NEXT backup() —
        in-flight transfers finish at the old fan-out."""
        count = max(0, min(int(count), max(0, len(self.peers) - 1)))
        if count != self.replica_count:
            logger.info("replica count %d -> %d", self.replica_count,
                        count)
            self.replica_count = count

    # ---------------------------------------------------------------- backup

    def _segment_bytes(self) -> Optional[Tuple[int, bytes]]:
        acquired = False
        t0 = time.monotonic()
        try:
            acquired = self._seg_lock.acquire(timeout=self.lock_timeout)
        except Exception:  # noqa: BLE001 — lock service gone: copy unlocked
            acquired = False
        t1 = time.monotonic()
        self.last_backup = {"lock_wait_s": t1 - t0}
        try:
            header = self._shm.load_header()
            if header is None:
                return None
            # raw segment copy: header region + payload to the last tensor
            end = max((m["offset"] + m["nbytes"] for m in header["metas"]),
                      default=0)
            buf = self._shm._buf.buf  # noqa: SLF001 — same package
            blob = bytes(buf[:end])
            self.last_backup["copy_s"] = time.monotonic() - t1
            return header.get("step", 0), blob
        finally:
            if acquired:
                try:
                    self._seg_lock.release()
                except Exception:  # noqa: BLE001
                    pass

    def _successors_of(self, owner: int,
                       count: Optional[int] = None):
        """Ring members after `owner`, nearest first, deduped by ADDRESS.

        One ReplicaServer runs per AGENT, so with several ranks per node
        (or replica_count >= len(peers)) a naive rank walk revisits the
        same server — worst case it ships a segment to its own creator's
        node, a "backup" that dies with it.  The walk therefore skips any
        rank whose server address equals the owner's own, and visits each
        distinct address at most once.  `count=None` walks the whole ring.
        """
        ranks = sorted(set(self.peers) | {owner})
        idx = ranks.index(owner)
        own_addr = self.peers.get(owner)
        seen_addrs = {own_addr} if own_addr else set()
        out = []
        for k in range(1, len(ranks)):
            peer = ranks[(idx + k) % len(ranks)]
            if peer == owner:
                continue
            addr = self.peers.get(peer)
            if addr:
                if addr in seen_addrs:
                    continue
                seen_addrs.add(addr)
            out.append(peer)
            if count is not None and len(out) >= count:
                break
        return out

    def _successors(self, count: Optional[int] = None):
        """My ring successors, nearest first (up to `count`)."""
        limit = self.replica_count if count is None else count
        if limit <= 0:
            return []
        return self._successors_of(self.rank, limit)

    def backup(self) -> int:
        """Ship the staged segment to ring successor(s); returns #copies.

        A peer that rejects (store full) or is unreachable is skipped and
        the next ring member is tried, so replica_count copies land
        whenever that many peers can hold them.
        Parity: ShardCkptReplicaManager.backup (replica.py:114).
        """
        seg = self._segment_bytes()
        if seg is None:
            return 0
        step, blob = seg
        # trust boundary: never replicate a segment that fails its own
        # digests — shipping corruption would poison the peers' tier
        t0 = time.monotonic()
        vstep, why = verify_segment_blob(blob)
        t1 = time.monotonic()
        self.last_backup["verify_s"] = t1 - t0
        if vstep is None:
            logger.error("refusing to replicate local segment of step %d:"
                         " %s", step, why)
            return 0
        sent = 0
        for peer in self._successors(count=len(self.peers)):
            if sent >= self.replica_count:
                break
            addr = self.peers.get(peer)
            if not addr:
                continue
            try:
                resp, _ = self._rpc(addr, {"op": "put", "owner": self.rank,
                                           "step": step}, blob)
                if resp.get("ok"):
                    sent += 1
                else:
                    logger.warning("rank %d rejected backup (store full)",
                                   peer)
            except OSError as e:
                logger.warning("backup to rank %d (%s) failed: %s", peer,
                               addr, e)
        self.last_backup["send_s"] = time.monotonic() - t1
        return sent

    # --------------------------------------------------------------- restore

    def restore(self) -> Optional[int]:
        """Pull my segment from a backup holder into local shm.

        Holders are walked in RING-SUCCESSOR order (where backup() put
        the copies, nearest first) with per-holder failover: a dead
        holder (connection refused after retries) skips to the next ring
        successor, and a holder serving corrupt bytes is QUARANTINED as
        evidence + reported as a ckpt-health event before the walk moves
        on — a partial ring never fails the whole replica tier.  Every
        pulled blob is digest-verified (header crc + per-leaf digests,
        shm_handler.verify_segment_blob) BEFORE it overwrites the local
        segment, so the replica tier can never clobber local state with
        garbage.

        Returns the restored step, or None when no peer holds a valid
        backup.  Parity: ShardCkptReplicaManager.gather (replica.py:191).
        """
        for holder in self._successors_of(self.rank):
            payload = self._pull_verified(holder, self.rank)
            if payload is None:
                continue
            step, blob = payload
            self._shm._ensure_size(len(blob))  # noqa: SLF001
            self._shm._buf.buf[:len(blob)] = blob  # noqa: SLF001
            self._shm.restamp_owner(os.getpid())
            self.restored_from = holder
            logger.info("restored staged checkpoint step %d from rank %d "
                        "(%.1f MB, verified, no storage read)", step,
                        holder, len(blob) / 1e6)
            return step
        return None

    def fetch_peer(self, owner: int) -> Optional[Tuple[int, bytes]]:
        """Verified copy of ANOTHER rank's staged segment, no shm touch.

        The hot-swap hydration path (master mesh_transition): a survivor
        pulls the DEAD rank's segment from its ring holders so the
        degraded mesh can absorb the lost shards from peer memory instead
        of storage.  Holders are queried first (cheap step probe) and
        tried newest-step first — after a partial backup round the
        freshest copy wins; dead/corrupt holders fail over exactly like
        restore().  Returns (step, blob) digest-verified, never bytes
        that failed verification.
        """
        candidates = []
        for holder in self._successors_of(owner):
            addr = self.peers.get(holder)
            if not addr:
                continue
            try:
                resp, _ = self._rpc(addr, {"op": "query", "owner": owner})
            except OSError:
                continue
            if resp.get("found"):
                candidates.append((int(resp.get("step", -1)), holder))
        for _, holder in sorted(candidates, reverse=True):
            payload = self._pull_verified(holder, owner)
            if payload is not None:
                return payload
        return None

    def _pull_verified(self, holder: int,
                       owner: int) -> Optional[Tuple[int, bytes]]:
        """One holder attempt: get + digest-verify, evidence on failure."""
        addr = self.peers.get(holder)
        if not addr:
            return None
        try:
            header, blob = self._rpc(addr, {"op": "get", "owner": owner})
        except OSError as e:
            logger.warning("replica holder rank %d (%s) unreachable (%s) "
                           "— failing over to next ring successor",
                           holder, addr, e)
            return None
        if not header.get("found") or not blob:
            return None
        step, why = verify_segment_blob(blob)
        if step is None:
            self._note_corrupt_holder(holder, owner, blob, why)
            return None
        return step, blob

    def _note_corrupt_holder(self, holder: int, owner: int, blob,
                             why: str):
        """Corrupt bytes in a holder's store: evidence + report, then skip.

        Mirrors the storage tier's quarantine discipline
        (integrity.quarantine_step): the bytes are kept, never deleted,
        and the failure surfaces as a ckpt-health event + the
        dwt_ckpt_integrity_events metric — a bit flip inside one node's
        replica store must be operator-visible, not a silent failover.
        """
        logger.error("replica of rank %d from holder rank %d fails "
                     "verification (%s) — quarantining + trying next "
                     "holder", owner, holder, why)
        try:
            os.makedirs(self.quarantine_dir, exist_ok=True)
            base = os.path.join(self.quarantine_dir,
                                f"owner{owner}-holder{holder}")
            n = 0
            while os.path.exists(f"{base}.{n}.blob"):
                n += 1
            with open(f"{base}.{n}.blob", "wb") as f:
                f.write(blob)
            with open(f"{base}.{n}.reason", "w") as f:
                json.dump({"reason": why, "holder": holder,
                           "owner": owner,
                           # persisted cross-process timestamp (not a
                           # duration) — wall clock is the right clock
                           "time": time.time()}, f)
        except OSError:
            logger.exception("could not quarantine corrupt replica blob")
        try:
            from ..master.metrics import get_registry

            get_registry().inc(
                "dwt_ckpt_integrity_events",
                labels={"job": self.job_name, "tier": "replica"})
        except Exception:  # noqa: BLE001 — metrics never break a restore
            pass
        if self.health_hook is not None:
            try:
                self.health_hook(f"holder rank {holder}: {why}")
            except Exception:  # noqa: BLE001 — reporting never breaks it
                logger.exception("replica health hook failed")

    def _rpc(self, addr: str, header: Dict,
             payload=b"") -> Tuple[Dict, bytearray]:
        from ..common.util import retry_call

        host, port = addr.rsplit(":", 1)

        def attempt() -> Tuple[Dict, bytearray]:
            # raw dial sanctioned: the attempt runs under retry_call — a
            # peer agent mid-restart answers on the second or third try
            # instead of being skipped for the whole backup round
            with socket.create_connection((host, int(port)),
                                          timeout=self.timeout) as sock:
                _send_msg(sock, header, payload)
                return _recv_msg(sock)

        return retry_call(attempt, attempts=3, base_delay_s=0.2,
                          max_delay_s=1.0, retry_on=(OSError,))

    def close(self):
        self._shm.close()
        try:
            self._seg_lock.close()
        except Exception:  # noqa: BLE001 — a client lock holds no server
            pass
