"""Warm-standby master: tail the primary's journal, promote on lease expiry.

Parity: dlrover_wuqiong_tpu/master/standby.py (`StandbyTailer`,
`run_standby`), copied (stdlib only); the leader half (lease heartbeat,
peer fence, promotion) lives on the port's `JobMaster`
(master/master.py).  A port standby tails a JAX primary and a JAX
standby a port primary: the verb, its records and the frames are the
same bytes (tests/test_torch_standby.py).

- **Shipping is a PULL** over the normal typed-JSON RPC plane: the
  tailer polls the POLLING-class `FetchJournalRequest` verb (never
  journaled, never idem — a fetch that journaled would make shipping
  feed itself) from its OWN durable seq, so a lost response, a torn
  batch tail or a compaction race all resolve the same way: re-fetch.
  Frames are ingested VERBATIM (`MasterJournal.ingest_frames`: whole
  frames only, contiguity enforced), so the standby's log is a byte
  prefix of the primary's, which makes the merged incident timeline's
  (epoch, seq) dedup exact.
- **State folds through the SAME replay path** a restarted master
  uses: every adopted frame goes through `JobMaster._apply_entry`, the
  snapshot handoff (compaction outran the fetch) through
  `_restore_snapshot`.  There is no second state machine to drift.
- **Liveness is a journal artifact**: the leader heartbeats ``lease``
  frames into its own journal; the standby arms its expiry clock only
  after the FIRST lease frame arrives (a primary run without a lease
  ttl makes the standby a pure mirror that never promotes).  Expiry is
  measured on the local monotonic clock from the moment a lease frame
  is ADOPTED, never on the frame's wall ``ts`` (clock skew must not
  fail over).
- **Promotion is fenced**: a final drain narrows the lost-tail window,
  then `JobMaster.promote_to_leader` journals the ``failover`` frame and
  re-opens the epoch at observed + 2 (a naively revived corpse lands at
  + 1).  If the final drain adopts a FRESH lease frame the primary is
  alive after all: the tailer disarms and keeps mirroring.

Acked-but-unshipped tail frames are lost to the standby, but every
client retries them against the new leader under the ORIGINAL idem key,
so they re-apply exactly once under the new epoch.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional

from ..common import messages as msg
from ..common.comm import MasterUnreachableError, RpcClient, RpcError
from ..common.log import get_logger
from .master import JobMaster

logger = get_logger("standby")


def _default_poll_s() -> float:
    try:
        return max(0.01, float(os.getenv("DWT_STANDBY_POLL_S", "0.05")))
    except ValueError:
        return 0.05


class StandbyTailer:
    """Fetch→ingest→fold loop against one primary, plus the lease clock."""

    def __init__(self, master: JobMaster, primary_addr: str,
                 lease_ttl_s: float = 0.0,
                 poll_interval_s: Optional[float] = None,
                 max_frames: int = 512):
        if master.journal is None:
            raise ValueError("a standby needs a journal dir to mirror into")
        self.m = master
        self.primary_addr = primary_addr
        self.lease_ttl_s = float(lease_ttl_s)
        self.poll_interval_s = (poll_interval_s if poll_interval_s
                                is not None else _default_poll_s())
        self.max_frames = max(1, int(max_frames))
        # one persistent connection; retries stay SHORT — an unreachable
        # primary is a normal state here, the lease clock decides what it
        # means
        self._client = RpcClient(primary_addr, node_id=-3,
                                 node_type="standby", timeout=2.0,
                                 retries=2, base_delay_s=0.02,
                                 max_delay_s=0.1)
        # monotonic instant the last lease frame was ADOPTED (0 = never:
        # expiry unarmed, pure-mirror mode)
        self._last_lease_mono = 0.0
        self.frames_folded = 0
        self.snapshots_adopted = 0

    def close(self):
        self._client.close()

    # ------------------------------------------------------------------ poll

    def poll_once(self) -> int:
        """One fetch→ingest→fold round.

        Returns frames adopted this round, or -1 when the primary did
        not answer.  All recovery is "re-fetch from our durable seq":
        duplicates are skipped and the first gap or torn frame stops the
        ingest (journal.ingest_frames), so a torn batch tail or a
        compaction racing the pull self-heals on the next round.
        """
        from_seq = self.m.journal.group_commit_stats()["durable_seq"]
        try:
            resp = self._client.get(msg.FetchJournalRequest(
                node_id=-3, from_seq=from_seq,
                max_frames=self.max_frames))
        except MasterUnreachableError:
            return -1
        except RpcError:
            logger.exception("fetch_journal answered with an error")
            return -1
        adopted = 0
        snap = bytes(resp.snapshot or b"")
        if snap and int(resp.snapshot_seq) > from_seq:
            # compaction outran the ring AND our seq: adopt the snapshot
            # verbatim, fold its state, then the tail resumes behind it
            try:
                state, seq, _epoch = self.m.journal.ingest_snapshot(snap)
            except (ValueError, OSError):
                logger.exception("snapshot handoff unreadable — refetch")
                return adopted
            if state:
                self.m._restore_snapshot(state)
            self.snapshots_adopted += 1
            adopted += 1
            logger.info("adopted primary snapshot at seq %d", seq)
        for frame in self.m.journal.ingest_frames(
                [bytes(f) for f in (resp.frames or [])]):
            kind = frame.get("kind", "")
            data = frame.get("data", {}) or {}
            if kind == "lease":
                self._last_lease_mono = time.monotonic()
            if kind == "epoch":
                # ingest_frames already advanced journal.epoch; mirror it
                # so our response envelopes match the primary's and a
                # worker probing us pre-promotion sees no spurious bump
                self.m.epoch = max(self.m.epoch,
                                   int(data.get("epoch", 0)))
            else:
                try:
                    self.m._apply_entry(kind, data)
                except Exception:  # noqa: BLE001 — one bad frame must not
                    # stop the mirror (same contract as replay)
                    logger.exception("standby fold: frame kind %r failed",
                                     kind)
            adopted += 1
            self.frames_folded += 1
        return adopted

    def lease_expired(self) -> bool:
        """True once the armed lease clock ran past ttl of silence."""
        if self.lease_ttl_s <= 0 or not self._last_lease_mono:
            return False
        return time.monotonic() - self._last_lease_mono > self.lease_ttl_s

    # ------------------------------------------------------------------- run

    def run(self, stopped: threading.Event,
            max_seconds: Optional[float] = None) -> bool:
        """Tail until promoted or stopped.  Returns True when promoted."""
        start = time.monotonic()
        logger.info("standby tailing %s (poll %.3fs, lease ttl %.2fs)",
                    self.primary_addr, self.poll_interval_s,
                    self.lease_ttl_s)
        while not stopped.wait(self.poll_interval_s):
            if max_seconds and time.monotonic() - start > max_seconds:
                return False
            self.poll_once()
            if not self.lease_expired():
                continue
            # final drain: narrow the lost-tail window to whatever the
            # dying primary never acked (those clients retry to us)
            before = self._last_lease_mono
            for _ in range(16):
                if self.poll_once() <= 0:
                    break
            if self._last_lease_mono > before:
                # a FRESH lease arrived mid-drain — the primary lives;
                # disarm and keep mirroring
                continue
            logger.info("standby folded %d frames (%d snapshots) before "
                        "promotion", self.frames_folded,
                        self.snapshots_adopted)
            self.m.promote_to_leader()
            return True
        return False


def run_standby(primary_addr: str, port: int, min_nodes: int,
                max_nodes: int, node_unit: int = 1,
                journal_dir: Optional[str] = None,
                poll_interval: float = 5.0,
                max_seconds: Optional[float] = None,
                lease_ttl_s: float = 0.0,
                group_commit_max_frames: Optional[int] = None,
                group_commit_max_wait_ms: Optional[float] = None) -> int:
    """Standby process entry (``python -m dlrover_wuqiong_tpu_torch.master
    --standby-of HOST:PORT``): mirror, maybe promote, then lead."""
    jd = journal_dir or os.getenv("DWT_MASTER_JOURNAL_DIR", "")
    if not jd:
        raise ValueError("--standby-of requires --journal-dir (the mirror)")
    master = JobMaster(port=port, min_nodes=min_nodes,
                       max_nodes=max_nodes, node_unit=node_unit,
                       journal_dir=jd,
                       group_commit_max_frames=group_commit_max_frames,
                       group_commit_max_wait_ms=group_commit_max_wait_ms,
                       standby=True, lease_ttl_s=lease_ttl_s)
    master.start()
    tailer = StandbyTailer(master, primary_addr, lease_ttl_s=lease_ttl_s)
    start = time.monotonic()
    try:
        promoted = tailer.run(master._stopped, max_seconds=max_seconds)
        if not promoted:
            return 0
        remaining = None
        if max_seconds:
            # the budget covers the whole process, not each phase
            remaining = max(1.0,
                            max_seconds - (time.monotonic() - start))
        return master.run(poll_interval=poll_interval,
                          max_seconds=remaining)
    finally:
        tailer.close()
        master.stop()
