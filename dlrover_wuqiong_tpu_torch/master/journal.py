"""Append-only control-plane journal: the master's state survives the master.

Parity: dlrover_wuqiong_tpu/master/journal.py — `MasterJournal` (:141-657)
and `IdemCache` (:660-709), copied (stdlib only) with the same frame
format, file names and knobs, so either package's master replays the
other's journal, and either package's standby tails the other's:

- one frame per line of ``journal.frames`` (`serialize.dumps`, compact
  JSON with no raw newline): ``{"seq", "kind", "ts", "data"}``, ``seq``
  rising, ``ts`` a wall-clock stamp kept for the record and never used
  for durations; ``snapshot.frame`` one frame ``{"epoch", "seq", "ts",
  "state"}``;
- `load` reads the snapshot, then the frames past its seq, and drops a
  torn tail (a SIGKILL mid-append: never acknowledged, because every
  ack waits on the durable watermark).  It decodes leniently
  (`serialize.loads(strict=False)`): an intact frame holding a message
  type the port has no copy of (a JAX master's ``paral`` or ``policy``
  frame) is loaded, not taken for a torn tail, and the master skips its
  kind with a warning.  `open_epoch` bumps and journals
  the fencing epoch every RPC response carries (common/comm.py);
- group commit: `append_nowait` assigns the seq and queues the encoded
  frame under the lock, `wait_durable` elects the first waiter with a
  queue and no writer in flight as the batch leader, which writes and
  fsyncs up to ``group_commit_max_frames`` frames with the lock released
  and then publishes the watermark; `append` is the two in one;
- compaction (`snapshot`) fences the queue (`_acquire_fence`), drains
  every queued frame durably (`_drain_fenced`), writes the snapshot
  (tmp + rename) and only then truncates the log to one epoch marker, so
  a frame that has a seq can never vanish with the truncated file;
- the knobs' defaults: ``DWT_JOURNAL_GROUP_COMMIT=0`` is per-frame fsync,
  ``DWT_JOURNAL_GROUP_MAX_FRAMES`` (256), ``DWT_JOURNAL_GROUP_MAX_WAIT_MS``
  (0: a lone writer pays no linger) and the benchmark-only
  ``DWT_JOURNAL_FSYNC_FLOOR_MS`` (0).

- shipping to a warm standby (master/standby.py, :384-561): each
  committed batch is mirrored into an in-memory ring
  (``DWT_JOURNAL_SHIP_RING`` frames, 4096); `fetch_batch` serves the
  durable frames after a standby's seq VERBATIM from the ring, or from
  the log file and the snapshot once compaction or the ring outran it;
  `ingest_frames` appends shipped frames verbatim (whole frames only,
  contiguous seqs), so a standby's log is a byte prefix of its
  primary's; `ingest_snapshot` adopts the primary's snapshot frame
  after a compaction; `group_commit_stats` reports ``shipped_seq`` and
  ``standby_lag_frames`` (-1 until a standby fetched).  Every decode
  here is lenient too: a port standby mirrors a JAX primary's
  ``paral`` / ``policy`` frames byte for byte instead of stopping at
  them.

Layout under ``dir``:
  journal.frames   append-only event log (truncated at each compaction)
  snapshot.frame   single frame: {"epoch": int, "seq": int, "state": {...}}
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Deque, Dict, List, Optional, Tuple

from ..common import serialize
from ..common.log import get_logger

logger = get_logger("journal")

JOURNAL_FILE = "journal.frames"
SNAPSHOT_FILE = "snapshot.frame"


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "")
    if not raw:
        return default
    try:
        return int(raw)
    except ValueError:
        logger.warning("journal: ignoring non-integer %s=%r", name, raw)
        return default


def _default_group_commit_max_frames() -> int:
    """Env-derived default batch cap: DWT_JOURNAL_GROUP_COMMIT=0 disables
    batching entirely (cap 1 = historical per-frame fsync), otherwise
    DWT_JOURNAL_GROUP_MAX_FRAMES caps the batch (default 256)."""
    if os.environ.get("DWT_JOURNAL_GROUP_COMMIT", "1") == "0":
        return 1
    return max(1, _env_int("DWT_JOURNAL_GROUP_MAX_FRAMES", 256))


def _default_group_commit_max_wait_ms() -> float:
    """Env-derived default leader linger (ms).  0 (the default) means the
    leader syncs immediately with whatever is queued — a single writer
    pays no added latency over the historical per-frame path."""
    return max(0.0, float(_env_int("DWT_JOURNAL_GROUP_MAX_WAIT_MS", 0)))


def _default_fsync_floor_ms() -> float:
    """BENCHMARK-ONLY storage emulation: DWT_JOURNAL_FSYNC_FLOOR_MS pads
    every commit sync to at least this many milliseconds.  Local NVMe
    fsyncs in ~0.1ms, but the deployment this master targets journals to
    network-attached disks (cloud PD-class: 1-5ms per sync) — the fleet
    bench sets the floor so the per-frame-vs-grouped A/B measures the
    production regime, and reports the floor it used.  Default 0 = off;
    never set this on a real job."""
    return max(0.0, float(_env_int("DWT_JOURNAL_FSYNC_FLOOR_MS", 0)))


def _default_ship_ring_frames() -> int:
    """Ship-ring capacity (frames).  The ring only has to cover the
    standby's poll interval worth of traffic; a fetch that outruns it
    falls back to the log file (and the snapshot after compaction), so
    a small ring is a perf knob, never a correctness one."""
    return max(16, _env_int("DWT_JOURNAL_SHIP_RING", 4096))


class MasterJournal:
    """Event log + snapshot/compaction for one master's control plane."""

    def __init__(self, journal_dir: str, fsync: bool = True,
                 snapshot_every: int = 1000,
                 group_commit_max_frames: Optional[int] = None,
                 group_commit_max_wait_ms: Optional[float] = None):
        self.dir = journal_dir
        os.makedirs(journal_dir, exist_ok=True)
        self._path = os.path.join(journal_dir, JOURNAL_FILE)
        self._snap_path = os.path.join(journal_dir, SNAPSHOT_FILE)
        self._fsync = fsync
        self.snapshot_every = max(1, snapshot_every)
        if group_commit_max_frames is None:
            group_commit_max_frames = _default_group_commit_max_frames()
        if group_commit_max_wait_ms is None:
            group_commit_max_wait_ms = _default_group_commit_max_wait_ms()
        self.group_commit_max_frames = max(1, int(group_commit_max_frames))
        self.group_commit_max_wait_ms = max(0.0,
                                            float(group_commit_max_wait_ms))
        self.fsync_floor_ms = _default_fsync_floor_ms()
        self._lock = threading.Lock()
        # group-commit state: queue of (seq, encoded frame) awaiting the
        # leader, the durable watermark acks gate on, and a fence that
        # parks appenders while compaction swaps the log.
        self._cond = threading.Condition(self._lock)
        self._queue: List[Tuple[int, bytes]] = []
        self._durable_seq = 0
        self._writer_active = False
        self._fenced = False
        self._batches = 0
        self._frames_committed = 0
        self._batch_max = 0
        # journal shipping: committed frames mirrored for standby pulls
        # (fetch_batch).  _shipped_seq tracks the highest seq a standby
        # has confirmed holding (its from_seq) or been served;
        # _ship_fetches==0 means no standby ever attached (lag gauge -1).
        self._ship_ring: Deque[Tuple[int, bytes]] = deque(
            maxlen=_default_ship_ring_frames())
        self._shipped_seq = 0
        self._ship_fetches = 0
        self._fh = None
        self._seq = 0
        self.epoch = 0
        self.entries_since_snapshot = 0

    # ----------------------------------------------------------------- load

    def load(self) -> Tuple[Optional[Dict], List[Dict]]:
        """Read (snapshot_state, replay_entries) and prime seq/epoch.

        `replay_entries` excludes frames already covered by the snapshot's
        seq.  Must be called before `open_epoch()`/`append()`.
        """
        snapshot: Optional[Dict] = None
        snap_seq = 0
        last_epoch = 0
        if os.path.exists(self._snap_path):
            try:
                with open(self._snap_path, "rb") as f:
                    frame = serialize.loads(f.read(), strict=False)
                snapshot = frame.get("state")
                snap_seq = int(frame.get("seq", 0))
                last_epoch = int(frame.get("epoch", 0))
            except (OSError, ValueError, json.JSONDecodeError) as e:
                logger.error("snapshot unreadable (%s) — replaying the "
                             "full journal", e)
                snapshot, snap_seq = None, 0
        entries: List[Dict] = []
        max_seq = snap_seq
        if os.path.exists(self._path):
            with open(self._path, "rb") as f:
                lines = f.read().split(b"\n")
            for i, line in enumerate(lines):
                if not line.strip():
                    continue
                try:
                    frame = serialize.loads(line, strict=False)
                except (ValueError, json.JSONDecodeError):
                    # torn tail from a hard kill mid-append: never acked,
                    # safe to drop.  A torn line mid-file would shadow
                    # later intact frames — stop there and say so.
                    dropped = sum(1 for l in lines[i + 1:] if l.strip())
                    logger.warning(
                        "journal: dropping torn frame at line %d (+%d "
                        "after it)", i + 1, dropped)
                    break
                seq = int(frame.get("seq", 0))
                max_seq = max(max_seq, seq)
                if frame.get("kind") == "epoch":
                    last_epoch = max(last_epoch,
                                     int(frame["data"]["epoch"]))
                    continue
                if seq <= snap_seq:
                    continue  # already inside the snapshot
                entries.append(frame)
        self._seq = max_seq
        self._durable_seq = max_seq
        self.epoch = last_epoch
        return snapshot, entries

    # --------------------------------------------------------------- append

    def open_epoch(self) -> int:
        """Bump + persist the fencing epoch for this master incarnation."""
        self.epoch += 1
        self.append("epoch", {"epoch": self.epoch})
        logger.info("journal %s: epoch %d open (seq=%d)", self.dir,
                    self.epoch, self._seq)
        return self.epoch

    def append(self, kind: str, data: Dict[str, Any]) -> int:
        """Append one event frame, DURABLE before return, so an acked RPC
        implies a durable record.  Equivalent to
        ``wait_durable(append_nowait(...))`` — under concurrency the frame
        shares its fsync with every other frame in the same batch."""
        return self.wait_durable(self.append_nowait(kind, data))

    def append_nowait(self, kind: str, data: Dict[str, Any]) -> int:
        """Assign a seq and enqueue the encoded frame for the next batch.

        Returns the seq; the frame is NOT durable yet — the caller must
        gate its ack on ``wait_durable(seq)``.  Seq assignment and
        enqueue happen under one lock, so file order equals seq order.
        """
        with self._cond:
            while self._fenced:
                self._cond.wait(0.05)
            self._seq += 1
            seq = self._seq
            # ts is a PERSISTED cross-process timestamp for the incident
            # timeline, never duration math — causal order stays
            # (epoch, seq)  # graftlint: disable=wall-clock-duration -- persisted cross-process timestamp (timeline interleaving), not elapsed-time math
            frame = serialize.dumps({"seq": seq, "kind": kind,
                                     "ts": time.time(), "data": data})
            self._queue.append((seq, frame))
            if kind != "epoch":
                self.entries_since_snapshot += 1
            self._cond.notify_all()
            return seq

    def wait_durable(self, seq: int) -> int:
        """Block until the durable watermark covers ``seq``; returns it.

        The first waiter that finds queued frames and no writer in
        flight elects itself the batch leader and commits up to
        ``group_commit_max_frames`` frames with the lock RELEASED —
        followers keep enqueueing behind the in-flight batch and are
        woken when the watermark advances past their seq.
        """
        while True:
            batch: List[Tuple[int, bytes]] = []
            with self._cond:
                if self._durable_seq >= seq:
                    return seq
                if self._queue and not (self._writer_active or self._fenced):
                    self._writer_active = True
                    n = self.group_commit_max_frames
                    batch = self._queue[:n]
                    del self._queue[:n]
                else:
                    self._cond.wait(0.05)
            if batch:
                self._commit_batch(batch)

    def _commit_batch(self, batch: List[Tuple[int, bytes]]):
        """Leader path: write+fsync the batch unlocked, then publish the
        durable watermark and wake followers.  Caller must hold the
        writer claim (``_writer_active``); this always releases it."""
        if self.group_commit_max_wait_ms > 0 and \
                len(batch) < self.group_commit_max_frames:
            # optional linger: give followers one window to join the batch
            with self._cond:
                self._cond.wait(self.group_commit_max_wait_ms / 1000.0)
                n = self.group_commit_max_frames - len(batch)
                if n > 0 and self._queue:
                    batch.extend(self._queue[:n])
                    del self._queue[:n]
        payload = b"".join(frame + b"\n" for _, frame in batch)
        try:
            try:
                t0 = time.monotonic()
                if self._fh is None:
                    self._fh = open(self._path, "ab")
                self._fh.write(payload)
                self._fh.flush()
                if self._fsync:
                    os.fsync(self._fh.fileno())
                if self.fsync_floor_ms > 0:
                    # benchmark-only slow-storage emulation: pad the SYNC
                    # (one per batch, like a real device) to the floor
                    rem = self.fsync_floor_ms / 1000.0 - (time.monotonic()
                                                          - t0)
                    if rem > 0:
                        time.sleep(rem)
            except OSError:
                # durability degraded, availability preserved: the master
                # keeps serving (a full disk must not take training down).
                # The watermark still advances — same contract as before.
                logger.exception("journal commit failed (%d frames)",
                                 len(batch))
        finally:
            # watermark + writer claim ALWAYS release, or every later
            # append would park forever behind a dead leader
            with self._cond:
                self._durable_seq = max(self._durable_seq, batch[-1][0])
                self._writer_active = False
                self._batches += 1
                self._frames_committed += len(batch)
                self._batch_max = max(self._batch_max, len(batch))
                # mirror the now-durable frames for standby pulls: a
                # deque extend of already-encoded bytes — shipping never
                # adds I/O or waiting to the commit path
                self._ship_ring.extend(batch)
                self._cond.notify_all()

    def group_commit_stats(self) -> Dict[str, Any]:
        """ADD-ONLY stats dict for JournalStats / the fleet bench."""
        with self._cond:
            batches = self._batches
            frames = self._frames_committed
            return {
                "group_commit": self.group_commit_max_frames > 1,
                "max_frames": self.group_commit_max_frames,
                "max_wait_ms": self.group_commit_max_wait_ms,
                "fsync_floor_ms": self.fsync_floor_ms,
                "batches": batches,
                "frames": frames,
                "batch_mean": (frames / batches) if batches else 0.0,
                "batch_max": self._batch_max,
                "durable_seq": self._durable_seq,
                # shipped_seq is the highest seq a standby holds or was
                # served; lag is the frame gap a failover right now
                # would lose from THIS journal's view (-1 = no standby
                # ever fetched)
                "shipped_seq": self._shipped_seq,
                "standby_lag_frames": (
                    self._durable_seq - self._shipped_seq
                    if self._ship_fetches else -1),
            }

    # ------------------------------------------------------------- shipping

    def fetch_batch(self, from_seq: int, max_frames: int = 256
                    ) -> Tuple[bytes, int, List[bytes], int]:
        """Serve one standby pull: frames AFTER ``from_seq``, verbatim.

        Returns ``(snapshot_raw, snapshot_seq, frames, durable_seq)``.
        ``snapshot_raw`` is non-empty only when compaction already
        truncated the requested range — the standby must apply the
        snapshot state first, then the tail frames (which resume at the
        compaction epoch marker).  Only durable frames are ever shipped:
        the standby must never be AHEAD of what the primary acked.

        Fast path is the in-memory ring (no I/O, one lock hop); the
        disk fallback reads outside the lock and tolerates a torn tail
        and a concurrent compaction swap (worst case: a gap the standby
        detects and re-fetches — the next pull sees the new snapshot).
        """
        max_frames = max(1, min(int(max_frames), 4096))
        with self._cond:
            durable = self._durable_seq
            self._ship_fetches += 1
            self._shipped_seq = max(self._shipped_seq, from_seq)
            if from_seq >= durable:
                return b"", 0, [], durable
            ring = list(self._ship_ring)
        frames: List[bytes] = []
        if ring and ring[0][0] <= from_seq + 1:
            for seq, raw in ring:
                if seq <= from_seq or seq > durable:
                    continue
                frames.append(raw)
                if len(frames) >= max_frames:
                    break
            self._note_shipped(frames)
            return b"", 0, frames, durable
        # ring outrun: disk fallback (snapshot + tail after compaction)
        snap_raw, snap_seq = b"", 0
        try:
            with open(self._snap_path, "rb") as f:
                snap_raw = f.read()
            snap_seq = int(serialize.loads(snap_raw, strict=False)
                           .get("seq", 0))
        except (OSError, ValueError, json.JSONDecodeError):
            snap_raw, snap_seq = b"", 0
        if snap_seq <= from_seq:
            snap_raw, snap_seq = b"", 0  # the standby already covers it
        floor = max(from_seq, snap_seq)
        try:
            with open(self._path, "rb") as f:
                lines = f.read().split(b"\n")
        except OSError:
            lines = []
        for line in lines:
            if not line.strip():
                continue
            try:
                seq = int(serialize.loads(line, strict=False).get("seq", 0))
            except (ValueError, json.JSONDecodeError):
                break  # torn tail: whole frames only, never a partial
            if seq <= floor or seq > durable:
                continue
            frames.append(line)
            if len(frames) >= max_frames:
                break
        self._note_shipped(frames, extra=snap_seq)
        return snap_raw, snap_seq, frames, durable

    def _note_shipped(self, frames: List[bytes], extra: int = 0):
        """Advance the shipped watermark past what this pull served."""
        last = extra
        if frames:
            try:
                last = max(last, int(serialize.loads(
                    frames[-1], strict=False).get("seq", 0)))
            except (ValueError, json.JSONDecodeError):
                pass
        if last:
            with self._cond:
                self._shipped_seq = max(self._shipped_seq, last)

    def ingest_snapshot(self, raw: bytes) -> Tuple[Optional[Dict], int, int]:
        """Standby bootstrap: adopt the primary's snapshot frame VERBATIM.

        Publishes atomically (tmp + os.replace — a torn snapshot would
        poison every later standby restart), resets the local log to
        empty (the shipped tail resumes at the compaction marker), and
        primes seq/epoch from the frame.  Returns ``(state, seq, epoch)``
        for the caller to fold through ``_restore_snapshot``.
        """
        frame = serialize.loads(raw, strict=False)
        seq = int(frame.get("seq", 0))
        epoch = int(frame.get("epoch", 0))
        self._acquire_fence()
        try:
            self._drain_fenced()
            with self._lock:
                tmp = f"{self._snap_path}.tmp.{os.getpid()}"
                with open(tmp, "wb") as f:
                    f.write(raw)
                    f.flush()
                    os.fsync(f.fileno())  # graftlint: disable=blocking-under-lock -- standby bootstrap critical section: the fence already excludes appends, and the snapshot must be durable before it replaces the old one
                os.replace(tmp, self._snap_path)
                if self._fh is not None:
                    self._fh.close()
                    self._fh = None
                jtmp = self._path + ".tmp"
                with open(jtmp, "wb") as f:
                    f.flush()
                    os.fsync(f.fileno())  # graftlint: disable=blocking-under-lock -- same bootstrap critical section: the emptied log must be durable before the swap
                os.replace(jtmp, self._path)
                self._seq = max(self._seq, seq)
                self._durable_seq = self._seq
                self.epoch = max(self.epoch, epoch)
                self.entries_since_snapshot = 0
        finally:
            self._release_fence()
        return frame.get("state"), seq, epoch

    def ingest_frames(self, frames: List[bytes]) -> List[Dict]:
        """Standby tail-fold: append shipped frames VERBATIM, durably.

        Contiguity discipline: duplicates (seq already held) are
        skipped, the first gap or torn frame STOPS the ingest — whole
        frames only, and the tailer re-fetches from its durable seq, so
        a torn batch tail shipped mid-batch can never corrupt the local
        log.  Returns the parsed frames actually adopted, in order, for
        the caller to fold through ``_apply_entry``.
        """
        accepted: List[Dict] = []
        raws: List[bytes] = []
        with self._cond:
            while self._writer_active or self._fenced:
                self._cond.wait(0.05)
            for raw in frames:
                try:
                    frame = serialize.loads(raw, strict=False)
                except (ValueError, json.JSONDecodeError):
                    break  # torn frame shipped mid-batch: drop the rest
                seq = int(frame.get("seq", 0))
                if seq <= self._seq:
                    continue  # re-fetch overlap: already durable here
                if seq != self._seq + 1:
                    break  # gap (compaction raced the pull): re-fetch
                raws.append(raw)
                accepted.append(frame)
                self._seq = seq
                if frame.get("kind") == "epoch":
                    self.epoch = max(self.epoch,
                                     int(frame.get("data", {})
                                         .get("epoch", 0)))
                else:
                    self.entries_since_snapshot += 1
            if not raws:
                return accepted
            self._writer_active = True
        payload = b"".join(r + b"\n" for r in raws)
        try:
            try:
                if self._fh is None:
                    self._fh = open(self._path, "ab")
                self._fh.write(payload)
                self._fh.flush()
                if self._fsync:
                    os.fsync(self._fh.fileno())
            except OSError:
                logger.exception("standby ingest write failed (%d frames)",
                                 len(raws))
        finally:
            with self._cond:
                self._durable_seq = max(self._durable_seq, self._seq)
                self._writer_active = False
                self._cond.notify_all()
        return accepted

    # ----------------------------------------------------------- fencing

    def _acquire_fence(self):
        """Park new appenders and leader elections behind the fence."""
        with self._cond:
            while self._fenced:
                self._cond.wait(0.05)
            self._fenced = True
            self._cond.notify_all()

    def _release_fence(self):
        with self._cond:
            self._fenced = False
            self._cond.notify_all()

    def _drain_fenced(self):
        """Commit every queued frame durably.  Caller holds the fence, so
        no new frames arrive; an in-flight leader finishes first."""
        while True:
            batch: List[Tuple[int, bytes]] = []
            with self._cond:
                if self._writer_active:
                    self._cond.wait(0.05)
                    continue
                if not self._queue:
                    return
                self._writer_active = True
                batch = self._queue[:]
                del self._queue[:]
            self._commit_batch(batch)

    def snapshot(self, state: Dict[str, Any]):
        """Write a full-state snapshot and truncate the event log.

        Group-commit interaction: the fence stops new appends and leader
        elections, then every queued frame is drained DURABLY into the
        old log before the swap — a frame assigned a seq can never land
        in (or vanish with) the truncated file.

        Crash-safe ordering: tmp-write + rename the snapshot FIRST, then
        truncate the journal.  A crash in between replays seq-duplicated
        frames, which `load()` skips via the snapshot's seq watermark.
        """
        self._acquire_fence()
        try:
            self._drain_fenced()
            with self._lock:
                frame = serialize.dumps({"epoch": self.epoch,
                                         "seq": self._seq,
                                         "ts": time.time(), "state": state})
                tmp = self._snap_path + ".tmp"
                try:
                    with open(tmp, "wb") as f:
                        f.write(frame)
                        f.flush()
                        os.fsync(f.fileno())  # graftlint: disable=blocking-under-lock -- compaction critical section: the fence already excludes appends; fsync inside the lock is the crash-safe ordering
                    os.replace(tmp, self._snap_path)
                    if self._fh is not None:
                        self._fh.close()
                        self._fh = None
                    # fresh journal holding only the current epoch marker
                    jtmp = self._path + ".tmp"
                    with open(jtmp, "wb") as f:
                        self._seq += 1
                        self._durable_seq = self._seq
                        marker = serialize.dumps(
                            {"seq": self._seq, "kind": "epoch",
                             "ts": time.time(),
                             "data": {"epoch": self.epoch}})
                        f.write(marker + b"\n")
                        f.flush()
                        os.fsync(f.fileno())  # graftlint: disable=blocking-under-lock -- same compaction critical section: the fresh journal must be durable before the swap
                    os.replace(jtmp, self._path)
                    # the marker bypasses _commit_batch: mirror it by
                    # hand or the ship ring would carry a seq gap and a
                    # tailing standby would spin on it forever
                    self._ship_ring.append((self._seq, marker))
                except OSError:
                    logger.exception("journal compaction failed")
                    return
                self.entries_since_snapshot = 0
                logger.info("journal %s: snapshot at seq=%d epoch=%d",
                            self.dir, self._seq, self.epoch)
        finally:
            self._release_fence()

    def close(self):
        """Drain pending frames durably, then close the file handle."""
        self._acquire_fence()
        try:
            self._drain_fenced()
            with self._lock:
                if self._fh is not None:
                    self._fh.close()
                    self._fh = None
        finally:
            self._release_fence()


class IdemCache:
    """Bounded idempotency-key → response cache (at-most-once replay).

    Parity: no reference counterpart — the reference's gRPC verbs are
    retried against the SAME master process, where re-applying a task
    result is harmless; here a retry can cross a master restart, so
    mutating verbs carry keys and the journaled cache answers replays
    with the recorded response instead of re-applying the mutation.
    """

    def __init__(self, cap: int = 4096):
        self._cap = cap
        self._lock = threading.Lock()
        self._map: "OrderedDict[str, Any]" = OrderedDict()

    _MISS = object()

    def get(self, key: str) -> Any:
        """The cached response, or IdemCache.MISS."""
        with self._lock:
            if key in self._map:
                self._map.move_to_end(key)
                return self._map[key]
            return self._MISS

    @property
    def MISS(self):
        return self._MISS

    def put(self, key: str, resp: Any):
        with self._lock:
            self._map[key] = resp
            self._map.move_to_end(key)
            while len(self._map) > self._cap:
                self._map.popitem(last=False)

    def export_state(self) -> Dict[str, Any]:
        with self._lock:
            return dict(self._map)

    def restore_state(self, data: Dict[str, Any]):
        with self._lock:
            for k, v in data.items():
                self._map[k] = v
            while len(self._map) > self._cap:
                self._map.popitem(last=False)

    def __len__(self):
        with self._lock:
            return len(self._map)
