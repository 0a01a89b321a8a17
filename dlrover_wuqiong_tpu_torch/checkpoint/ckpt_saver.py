"""Agent-side async checkpoint persistence daemon.

Parity: a copy of dlrover_wuqiong_tpu/checkpoint/ckpt_saver.py:1-598
(no JAX), kept in the port because the port imports nothing of the JAX
package: the same on-disk layout, commit order, digests and
``DWT_CKPT_CRASH_POINT`` fault points, so a generation either package
commits restores in the other.  Under ``run`` the elastic agent hosts
the saver (agent/elastic_agent.py) and sets its `metric_hook`, which
forwards each persist's seconds to the master; a trainer with no agent
hosts it in-process (engine.py).  The agent's other hook after a
persist, `post_save_hook` (the replica backup), comes with ROADMAP item
6b.

Parity: reference `elastic_agent/torch/ckpt_saver.py` (`AsyncCheckpointSaver`
:344, `_save_shard` :544, `save_shm_to_storage` :634, `CommonDirCheckpointSaver`
:773 commit protocol with done-files + tracker file).

Flow (SURVEY.md §3.3): training procs stage shards in shm via
`SharedMemoryHandler` and enqueue a `CheckpointEvent` on the shared queue; this
daemon (running in the agent process) drains events, streams shm → storage with
a threadpool, then atomically commits the step by writing done-files and the
tracker file.  On worker failure the agent calls `save_shm_to_storage` so the
last in-memory checkpoint survives the restart.

Directory layout per step:
    {path}/checkpoint-{step}/meta_rank{r}.json       (per-leaf digests)
    {path}/checkpoint-{step}/shards_rank{r}.bin
    {path}/checkpoint-{step}/.done/rank{r}.done
    {path}/checkpoint-{step}/manifest.json           (integrity commit)
    {path}/checkpoint-{step}/.commit                 (marker)
    {path}/latest_checkpointed_iteration.txt         (tracker)

Trust boundary (checkpoint/integrity.py): every shard's bytes are
digested while streaming out of shm — a mismatch against the staged
digest ABORTS the persist (a bit flip in the segment must not become a
committed generation).  The commit then publishes, in order: done-files →
manifest.json (per-rank file digests, step, world shape, atomic
write-tmp+fsync+rename) → .commit marker → tracker.  A crash anywhere in
that sequence leaves a generation that is detectably torn (marker without
manifest, manifest whose digests miss) and therefore never restored.
"""

from __future__ import annotations

import json
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

from ..common.constants import CheckpointConstant
from ..common.log import get_logger
from ..common.multi_process import SharedLock, SharedQueue
from ..common.storage import CheckpointStorage, get_checkpoint_storage
from ..master.metrics import get_registry
from .integrity import DIGEST_ALGO, build_manifest, digest_bytes, \
    write_manifest
from .shm_handler import SharedMemoryHandler, sweep_stale_segments

logger = get_logger("ckpt_saver")

# fault-injection hook for the SIGKILL-mid-persist drill/tests: the saver
# hard-exits (os._exit — no cleanup, same as a SIGKILL landing there) at
# the named point.  Values: "after-bin" (shard file written, no meta/done),
# "before-manifest" (done-files written, manifest not yet).  Only ever set
# by tests/chaos subprocesses.
_CRASH_POINT_ENV = "DWT_CKPT_CRASH_POINT"


def _maybe_crash(point: str):
    if os.getenv(_CRASH_POINT_ENV) == point:
        logger.error("fault injection: hard-exit at %s", point)
        os._exit(137)

_SAVE_EVENT = "save"
_UPDATE_SHARDS_EVENT = "update_shards"
_UPDATE_WORLD_EVENT = "update_world"
_EXIT_EVENT = "exit"


def shm_lock_name(job_name: str, local_rank: int) -> str:
    """Cross-process lock serializing shm staging (engine drain thread)
    against shm→disk streaming (saver) for one segment."""
    return f"{job_name}-ckpt-shm-{local_rank}"


def step_dir(path: str, step: int) -> str:
    return os.path.join(path, f"{CheckpointConstant.CKPT_NAME_PREFIX}{step}")


class _ViewsReader:
    """Read-only file object over a list of shm memoryviews (zero-copy
    until the storage backend's own chunking)."""

    def __init__(self, views):
        self._views = views
        self._i = 0
        self._off = 0

    def read(self, n: int = -1) -> bytes:
        if self._i >= len(self._views):
            return b""
        view = self._views[self._i]
        if n is None or n < 0:
            n = len(view) - self._off
        chunk = bytes(view[self._off:self._off + n])
        self._off += len(chunk)
        if self._off >= len(view):
            self._i += 1
            self._off = 0
        return chunk


class CheckpointEvent:
    @staticmethod
    def save(step: int, path: str) -> Dict:
        return {"type": _SAVE_EVENT, "step": step, "path": path}

    @staticmethod
    def update_shards(num: int, world_num: Optional[int] = None) -> Dict:
        return {"type": _UPDATE_SHARDS_EVENT, "num": num,
                "world_num": world_num}

    @staticmethod
    def update_world(world_num: int, node_rank: int) -> Dict:
        """Re-rendezvous outcome: new world size + this node's new rank.
        Routed through the event queue so it serializes with saves."""
        return {"type": _UPDATE_WORLD_EVENT, "world_num": world_num,
                "node_rank": node_rank}

    @staticmethod
    def exit() -> Dict:
        return {"type": _EXIT_EVENT}


class AsyncCheckpointSaver:
    """Singleton daemon inside the agent process."""

    _instance: Optional["AsyncCheckpointSaver"] = None
    _cls_lock = threading.Lock()

    def __init__(self, job_name: str = "dwt", local_shard_num: int = 1,
                 node_rank: int = 0,
                 storage: Optional[CheckpointStorage] = None,
                 world_shard_num: Optional[int] = None):
        self.job_name = job_name
        self.node_rank = node_rank
        self.local_shard_num = local_shard_num
        # total shards across ALL nodes — commit must wait for every rank's
        # done-file, not just this node's (reference ckpt_saver.py:863)
        self.world_shard_num = world_shard_num or local_shard_num
        self.storage = storage or get_checkpoint_storage()
        # hard-killed runs leak their POSIX segments until reboot — reap
        # the ones whose creator pid is dead before allocating our own
        try:
            sweep_stale_segments(job_name)
        except Exception:  # noqa: BLE001 — sweeping must never block startup
            logger.exception("stale shm sweep failed")
        self._event_queue = SharedQueue(f"{job_name}-ckpt-events", master=True)
        self._shm_handlers: Dict[int, SharedMemoryHandler] = {
            r: SharedMemoryHandler(r, job_name)
            for r in range(local_shard_num)
        }
        # per-segment writer/reader locks (master side lives here; training
        # processes connect as clients via shm_lock_name)
        self._shm_locks: Dict[int, SharedLock] = {
            r: SharedLock(shm_lock_name(job_name, r), master=True)
            for r in range(local_shard_num)
        }
        self._executor = ThreadPoolExecutor(
            max_workers=max(4, local_shard_num), thread_name_prefix="ckpt-io")
        self._thread: Optional[threading.Thread] = None
        self._inflight: List = []  # shard-write futures of the current save
        self._inflight_lock = threading.Lock()
        self._stopped = threading.Event()
        self._last_persisted_step = -1
        self._latest_shm_step = -1
        self._latest_path = ""
        # invoked with (kind, seconds) per persist — the agent forwards to
        # the master's metric registry (the agent's own registry is local)
        self.metric_hook = None

    # ---------------------------------------------------------------- factory

    @classmethod
    def start_async_saving_ckpt(cls, job_name: str = "dwt",
                                local_shard_num: int = 1,
                                node_rank: int = 0,
                                storage: Optional[CheckpointStorage] = None,
                                world_shard_num: Optional[int] = None
                                ) -> "AsyncCheckpointSaver":
        """Parity: reference ckpt_saver.py:410."""
        with cls._cls_lock:
            if cls._instance is None:
                cls._instance = cls(job_name, local_shard_num, node_rank,
                                    storage, world_shard_num)
                cls._instance.start()
            return cls._instance

    @classmethod
    def get_ckpt_saver(cls) -> Optional["AsyncCheckpointSaver"]:
        return cls._instance

    @classmethod
    def reset(cls):
        with cls._cls_lock:
            if cls._instance is not None:
                cls._instance.stop()
                cls._instance = None

    # ------------------------------------------------------------------ loop

    def start(self):
        self._thread = threading.Thread(target=self._sync_shm_to_storage,
                                        daemon=True, name="dwt-ckpt-saver")
        self._thread.start()

    def stop(self):
        self._stopped.set()
        try:
            self._event_queue.put(CheckpointEvent.exit())
        except Exception:  # noqa: BLE001
            pass
        if self._thread is not None:
            self._thread.join(timeout=10)
        clean_exit = self._thread is None or not self._thread.is_alive()
        with self._inflight_lock:
            inflight = list(self._inflight)
        if clean_exit and inflight:
            # bounded wait for in-flight shard writes (a hung storage backend
            # must not wedge agent teardown — mirror the thread-join bound)
            from concurrent.futures import wait as futures_wait

            done, not_done = futures_wait(inflight, timeout=30)
            clean_exit = not not_done
        if clean_exit:
            # a MEMORY-only checkpoint newer than the last persisted step
            # would be lost with the segment — flush it first (reference
            # save_shm_to_storage-on-teardown, ckpt_saver.py:634)
            try:
                self.save_shm_to_storage()
            except Exception:  # noqa: BLE001
                logger.exception("teardown flush of staged checkpoint failed")
        self._executor.shutdown(wait=False)
        for h in self._shm_handlers.values():
            h.close()
            if clean_exit:
                # drop the segment: a future job must not restore it.  If the
                # loop is wedged mid-save, keep it so the bytes survive for a
                # post-mortem flush (the _ckpt_dir tag guards cross-job reuse).
                h.unlink()
        for lk in self._shm_locks.values():
            lk.close()
        self._event_queue.close()

    def _sync_shm_to_storage(self):
        """Parity: reference `_sync_shm_to_storage` :517."""
        while not self._stopped.is_set():
            try:
                event = self._event_queue.get(timeout=1.0)
            except Exception:  # queue.Empty
                continue
            etype = event.get("type")
            if etype == _EXIT_EVENT:
                return
            if etype == _UPDATE_SHARDS_EVENT:
                self._update_shard_num(event["num"], event.get("world_num"))
                continue
            if etype == _UPDATE_WORLD_EVENT:
                # applied on this thread → never races an in-flight save
                self.world_shard_num = event["world_num"]
                self.node_rank = event["node_rank"]
                continue
            if etype == _SAVE_EVENT:
                try:
                    self.save_step_checkpoint(event["step"], event["path"])
                except Exception:  # noqa: BLE001
                    logger.exception("async save of step %s failed",
                                     event.get("step"))

    def _update_shard_num(self, num: int, world_num: Optional[int] = None):
        for h in self._shm_handlers.values():
            h.close()
        for lk in self._shm_locks.values():
            lk.close()
        self.local_shard_num = num
        # without explicit world info, keep the known world size (never
        # shrink to the local count — that re-opens the premature-commit bug)
        self.world_shard_num = world_num or max(self.world_shard_num, num)
        self._shm_handlers = {
            r: SharedMemoryHandler(r, self.job_name) for r in range(num)
        }
        self._shm_locks = {
            r: SharedLock(shm_lock_name(self.job_name, r), master=True)
            for r in range(num)
        }

    # ------------------------------------------------------------------ save

    def save_step_checkpoint(self, step: int, path: str,
                             commit_timeout: Optional[float] = None):
        """Persist all local shards of `step` then commit."""
        start = time.monotonic()
        sdir = step_dir(path, step)
        self.storage.safe_makedirs(os.path.join(sdir,
                                                CheckpointConstant.DONE_DIR))
        futures = []
        for local_rank, handler in self._shm_handlers.items():
            futures.append(self._executor.submit(
                self._save_shard, handler, step, sdir, local_rank))
        with self._inflight_lock:
            self._inflight = futures
        ok = all(f.result() for f in futures)
        with self._inflight_lock:
            self._inflight = []
        if ok:
            ok = self.commit_checkpoint(
                step, path, expected_shards=self.world_shard_num,
                timeout=commit_timeout or CheckpointConstant.SAVE_TIMEOUT)
        if ok:
            # only a committed step counts as persisted — a commit timeout
            # (e.g. a peer never wrote its done-file) must leave the staged
            # checkpoint eligible for the teardown/failure flush retry
            self._last_persisted_step = step
            self._latest_path = path
            elapsed = time.monotonic() - start
            logger.info("persisted checkpoint step=%d to %s in %.2fs", step,
                        sdir, elapsed)
            try:
                get_registry().observe(
                    "dwt_ckpt_seconds", elapsed,
                    {"job": self.job_name, "kind": "persist"})
            except Exception:  # noqa: BLE001 — metrics must never break IO
                pass
            if self.metric_hook is not None:
                try:
                    self.metric_hook("persist", elapsed)
                except Exception:  # noqa: BLE001
                    pass
        else:
            logger.error("failed to persist checkpoint step=%d", step)

    def _save_shard(self, handler: SharedMemoryHandler, step: int,
                    sdir: str, local_rank: int) -> bool:
        """Parity: reference `_save_shard` :544 — stream one shm segment.

        Holds the segment's shared lock so a concurrent engine drain can't
        overwrite the payload mid-stream (torn shard with a done-file)."""
        lock = self._shm_locks.get(local_rank)
        acquired = False
        if lock is not None:
            try:
                acquired = lock.acquire(timeout=CheckpointConstant.
                                        SAVE_TIMEOUT)
            except Exception:  # noqa: BLE001 — degraded: stream unlocked
                acquired = False
        try:
            # stream-while-locked IS the design: the shm SharedLock must
            # cover the disk stream or an engine drain overwrites the
            # payload mid-save (torn shard under a done-file); the dead-pid
            # reaper bounds a holder's crash.
            return self._save_shard_locked(handler, step, sdir, local_rank)  # graftlint: disable=blocking-under-lock -- shm lock must span the verified stream to storage; see comment above
        finally:
            if acquired:
                try:
                    lock.release()
                except Exception:  # noqa: BLE001
                    pass

    def _save_shard_locked(self, handler: SharedMemoryHandler, step: int,
                           sdir: str, local_rank: int) -> bool:
        header = handler.load_header()
        if header is None:
            logger.warning("no shm data for local rank %d", local_rank)
            return False
        if header.get("step") != step:
            logger.warning("shm holds step %s, expected %s",
                           header.get("step"), step)
            return False
        global_rank = self._global_rank(local_rank)
        meta_path = os.path.join(sdir, f"meta_rank{global_rank}.json")
        bin_path = os.path.join(sdir, f"shards_rank{global_rank}.bin")
        metas_out: List[Dict] = []
        from ..common.storage import PosixDiskStorage

        # digest-while-streaming: each shard's bytes are checked against
        # the digest staged with them; a mismatch means the segment was
        # corrupted AFTER staging (bit flip, torn concurrent write) and
        # the persist ABORTS — a corrupt generation must never commit
        bin_digest = 0
        offset = 0

        def _digest_view(meta, view) -> bool:
            nonlocal bin_digest
            chunk = bytes(view)
            if meta.digest is not None and int(meta.digest) >= 0 and \
                    digest_bytes(chunk) != int(meta.digest):
                logger.error(
                    "shm shard %s of step %d fails its staged digest — "
                    "aborting persist (segment corrupted after staging)",
                    meta.name, step)
                return False
            bin_digest = digest_bytes(chunk, bin_digest)
            return True

        if isinstance(self.storage, PosixDiskStorage):
            # fast path: stream shm → file with an atomic rename commit
            tmp = f"{bin_path}.tmp.{os.getpid()}"
            os.makedirs(os.path.dirname(bin_path), exist_ok=True)
            with open(tmp, "wb") as f:
                for meta, view in handler.iter_shards():
                    if not _digest_view(meta, view):
                        return False
                    f.write(view)
                    d = meta.to_dict()
                    d["file_offset"] = offset
                    offset += meta.nbytes
                    metas_out.append(d)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, bin_path)
        else:
            # object store (gs://...): stream shm views straight into the
            # object writer — no host-RAM copy of the (possibly tens-of-GB)
            # shard set; commit-by-done-file keeps atomicity (object writes
            # are already atomic)
            views = []
            for meta, view in handler.iter_shards():
                if not _digest_view(meta, view):
                    return False
                views.append(view)
                d = meta.to_dict()
                d["file_offset"] = offset
                offset += meta.nbytes
                metas_out.append(d)
            self.storage.write_fileobj(_ViewsReader(views), bin_path,
                                       offset)
        _maybe_crash("after-bin")
        self.storage.write(json.dumps({
            "step": step,
            "algo": DIGEST_ALGO,
            "bin_nbytes": offset,
            "bin_digest": bin_digest,
            "extra": header.get("extra", {}),
            "tensors": metas_out,
        }), meta_path)
        done = os.path.join(sdir, CheckpointConstant.DONE_DIR,
                            f"rank{global_rank}.done")
        self.storage.write(str(step), done)
        return True

    def _global_rank(self, local_rank: int) -> int:
        return self.node_rank * self.local_shard_num + local_rank

    def commit_checkpoint(self, step: int, path: str,
                          expected_shards: Optional[int] = None,
                          timeout: float = CheckpointConstant.SAVE_TIMEOUT
                          ) -> bool:
        """Write the tracker file once all ranks' done-files exist.

        Parity: reference `commit_checkpoint` :863 — rank-0 agent waits for
        done files of every shard then atomically publishes the step.
        Returns False on timeout (step NOT published).
        """
        if self.node_rank != 0:
            return True  # this node's shards are flushed; rank 0 publishes
        sdir = step_dir(path, step)
        done_dir = os.path.join(sdir, CheckpointConstant.DONE_DIR)
        expected = expected_shards or self.local_shard_num
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if len(self.storage.listdir(done_dir)) >= expected:
                _maybe_crash("before-manifest")
                # commit order: manifest (digests over everything) →
                # marker → tracker.  Each is an atomic publish; a crash
                # between any two leaves a generation that is detectably
                # torn (marker implies manifest; tracker implies marker),
                # never a silently-restorable one.
                if not self._write_step_manifest(step, sdir):
                    return False
                # marker BEFORE tracker: a step is only selectable by
                # rollback's committed_steps() once every shard landed —
                # done-files alone can be a partial set (crash mid-flush)
                self.storage.write(str(step), os.path.join(
                    sdir, CheckpointConstant.COMMIT_MARKER))
                tracker = os.path.join(path,
                                       CheckpointConstant.TRACKER_FILE)
                self.storage.write(str(step), tracker)
                self.storage.commit(step, True)
                return True
            time.sleep(0.2)
        logger.error("commit timeout for step %d (%d/%d done)", step,
                     len(self.storage.listdir(done_dir)), expected)
        return False

    def _write_step_manifest(self, step: int, sdir: str) -> bool:
        """Aggregate every rank's meta into the generation manifest.

        Per-rank shard-file digests come from the meta jsons (each saver
        computed its own while streaming); the manifest seals the metas
        themselves with a digest of their bytes, so any later bit flip —
        in a shard file OR in a meta — breaks the chain."""
        ranks: Dict[int, Dict] = {}
        extra: Dict = {}
        for fname in self.storage.listdir(sdir):
            if not (fname.startswith("meta_rank")
                    and fname.endswith(".json")):
                continue
            rank = int(fname[len("meta_rank"):-len(".json")])
            raw = self.storage.read(os.path.join(sdir, fname))
            if raw is None:
                logger.error("commit of step %d: meta for rank %d "
                             "vanished", step, rank)
                return False
            raw = raw.encode() if isinstance(raw, str) else bytes(raw)
            try:
                meta = json.loads(raw.decode())
            except ValueError:
                logger.error("commit of step %d: meta for rank %d is "
                             "torn", step, rank)
                return False
            ranks[rank] = {
                "bin_nbytes": int(meta.get("bin_nbytes", -1)),
                "bin_digest": int(meta.get("bin_digest", -1)),
                "meta_digest": digest_bytes(raw),
                "n_tensors": len(meta.get("tensors", [])),
            }
            extra = extra or meta.get("extra", {})
        if not ranks:
            logger.error("commit of step %d: no rank metas found", step)
            return False
        manifest = build_manifest(
            step, ranks,
            world={"world_shard_num": self.world_shard_num,
                   "local_shard_num": self.local_shard_num,
                   "node_rank": self.node_rank},
            extra=extra)
        write_manifest(self.storage, sdir, manifest)
        return True

    # ------------------------------------------------------- failure handling

    def save_shm_to_storage(self, timeout: float = 120.0):
        """Persist whatever is staged in shm — called on worker failure.

        Parity: reference `save_shm_to_storage` :634.
        """
        steps = set()
        tagged_dir = ""
        for handler in self._shm_handlers.values():
            header = handler.load_header()
            if header is not None:
                steps.add(header.get("step"))
                tagged_dir = (header.get("extra") or {}).get(
                    "_ckpt_dir", tagged_dir)
        if not steps:
            return
        step = max(s for s in steps if s is not None)
        path = self._latest_path or tagged_dir
        if step <= self._last_persisted_step or not path:
            return
        logger.info("failure-save of staged step %d", step)
        self.save_step_checkpoint(step, path, commit_timeout=timeout)

    def register_path(self, path: str):
        self._latest_path = path


# -------------------------------------------------------------------- restore


def read_last_step(path: str,
                   storage: Optional[CheckpointStorage] = None) -> int:
    storage = storage or get_checkpoint_storage()
    content = storage.read(
        os.path.join(path, CheckpointConstant.TRACKER_FILE), "r")
    if not content:
        return -1
    try:
        return int(str(content).strip())
    except ValueError:
        return -1


def load_step_metas(path: str, step: int,
                    storage: Optional[CheckpointStorage] = None) -> Dict[int, Dict]:
    """Read every rank's meta json for a committed step."""
    storage = storage or get_checkpoint_storage()
    sdir = step_dir(path, step)
    out = {}
    for fname in storage.listdir(sdir):
        if fname.startswith("meta_rank") and fname.endswith(".json"):
            rank = int(fname[len("meta_rank"):-len(".json")])
            content = storage.read(os.path.join(sdir, fname), "r")
            if content:
                out[rank] = json.loads(content)
    return out
