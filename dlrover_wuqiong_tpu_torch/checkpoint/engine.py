"""Checkpoint engine: training-process side of flash checkpointing, for torch.

Parity: dlrover_wuqiong_tpu/checkpoint/engine.py:1-898 (the reference's
`trainer/torch/flash_checkpoint/engine.py`), with the same tiers but the replica (shm → storage generations, newest
committed first), the same
quarantine, self-heal and `last_restore` report, the same
``ckpt:save`` / ``ckpt:restore`` spans and ledger credits, and the same
chain of at most two snapshots in device memory.  Three parts touch the
device and are torch here:

- `_device_snapshot` (JAX :173-212, one jitted tree copy): every CUDA
  leaf is copied into fresh device memory on the current stream, after
  the step's last kernel and before the next step's first, so the copy
  holds the state between them although the step updates its tensors in
  place.  The copies of one dtype share one buffer (a "slab"), filled by
  one ``torch._foreach_copy_``; ``wire_dtype="bf16"`` narrows float32
  leaves on the device within that copy.  CPU leaves get a host copy.  An
  allocation that does not fit raises ``torch.cuda.OutOfMemoryError``
  here, where `_start_save` falls back to staging synchronously, as JAX's
  does (torch raises at allocation, so no readback is needed to surface
  it).
- `_drain` (the background half of a save): on its own CUDA stream, which
  waits on an event recorded after the snapshot, each slab is copied
  to a pinned host buffer kept for the next save (one copy a slab), the
  stream synchronised, the slabs released, and the host views staged into
  shm.  The slabs go back to the caching allocator only after that
  stream's copies finished, because the drain holds them until then.
- `restore_tree` (JAX's `restore_pytree` :807-898): each verified host
  array is copied into the template's tensor in place, on that tensor's
  device: through one pinned buffer per dtype to a CUDA tensor, with a
  narrower stored dtype (bf16 wire) upcast on the device.  XLA:CPU's
  donation launder has no torch counterpart.  A `TrainState` template
  restores through its own `load_tree`.

`_record_blocking_metric` and `_report_ckpt_health` write the process's
metric registry (master/metrics.py) and, in a worker launched by the
elastic agent, forward to the master through the elastic context
(trainer/elastic.py ``_context``), as JAX's do (:321-361): a blocking
save's seconds as the custom metric ``dwt_ckpt_blocking_seconds``, a
health event as a ``ckpt-health`` node event.  Not here yet: the
replica tier between shm and storage (JAX's `replica_fetch`, the
`on_degraded_restore` re-replication hook and the "replica" restore
preference) comes with the replica ring, item 6b.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..common.constants import CheckpointConstant
from ..common.log import get_logger
from ..common.multi_process import SharedLock, SharedQueue
from ..common.storage import CheckpointStorage, get_checkpoint_storage
from ..master.metrics import get_registry
from ..telemetry import spans as tspans
from ..telemetry.ledger import get_ledger
from .ckpt_saver import (
    AsyncCheckpointSaver,
    CheckpointEvent,
    read_last_step,
    shm_lock_name,
    step_dir,
)
from .integrity import (
    VerifyFailure,
    quarantine_step,
    read_manifest,
    verify_meta_bytes,
    verify_rank_bytes,
    verify_segment_entries,
)
from .shm_handler import (
    TORCH_ONLY_DTYPES,
    SharedMemoryHandler,
    _np_dtype,
    flatten_state_dict,
)

logger = get_logger("ckpt_engine")

# fallback reasons that mean CORRUPTION (reported to the master as
# checkpoint-health events) vs. benign tier misses (cold shm, a segment
# from another job/step, a single rank of a multi-process world)
_BENIGN_REASONS = ("stale", "foreign-segment", "step-mismatch",
                   "partial-local-coverage")


def _is_corruption(reason: str) -> bool:
    return bool(reason) and reason not in _BENIGN_REASONS


class CheckpointEngine:
    def __init__(self, checkpoint_dir: str, local_rank: int = 0,
                 job_name: str = "dwt", standalone: Optional[bool] = None,
                 storage: Optional[CheckpointStorage] = None,
                 local_shard_num: int = 1, node_rank: int = 0,
                 wire_dtype: Optional[str] = None):
        """`wire_dtype="bf16"`: f32 float leaves are cast to bf16 ON
        DEVICE during the snapshot — halving D2H staging, disk bytes, and
        restore H2D (restore upcasts on device).  NOT bit-exact for f32
        sources (16 mantissa bits dropped; bf16/int leaves round-trip
        exactly) — the exact-resume contract test pins both behaviors.
        The win is for transfer-bound links: restore bytes halve."""
        self.checkpoint_dir = checkpoint_dir
        self.local_rank = local_rank
        self.job_name = job_name
        if wire_dtype not in (None, "bf16"):
            raise ValueError(f"unsupported wire_dtype {wire_dtype!r}")
        self.wire_dtype = wire_dtype
        # gs://... checkpoint dirs raise until the object store is ported
        self.storage = storage or get_checkpoint_storage(
            path_hint=checkpoint_dir)
        self._shm_handler = SharedMemoryHandler(local_rank, job_name)
        self._saver: Optional[AsyncCheckpointSaver] = None
        self._event_queue: Optional[SharedQueue] = None
        self._latest_step = -1
        self._drain_thread: Optional[threading.Thread] = None
        self._drain_error: Optional[BaseException] = None
        # staging overlap: a save no longer waits out the PRIOR
        # drain on the training thread — the new drain thread joins its
        # predecessor first (the predecessor Thread object is passed as an
        # ARG, so the ordering is plain happens-before, no shared flag).
        # `_drain_lock` guards the cross-thread mutables below; the chain
        # is BOUNDED at depth 2 (one running + one queued): each queued
        # drain holds a full device snapshot, so deeper chains would
        # accumulate HBM copies until OOM — at the bound the save falls
        # back to the old blocking wait.
        self._drain_lock = threading.Lock()
        self._drain_pending = 0
        # seconds the drain chain spent waiting on predecessors, credited
        # to the ledger by the MAIN thread at the next save boundary
        # (ledger credits land at fusion boundaries)
        self._chain_wait_s = 0.0
        # the drain stream and pinned host buffers, per device
        self._streams: Dict[torch.device, "torch.cuda.Stream"] = {}
        self._pinned: Dict[Tuple, torch.Tensor] = {}
        # the last save's snapshot (its CUDA events and drain timing)
        self.last_snapshot: Optional[_Snapshot] = None
        if standalone is None:
            # a worker launched by an elastic agent must attach to the agent's
            # saver queue, never host its own (socket-name collision)
            from ..common.constants import NodeEnv

            attached = os.getenv(NodeEnv.MASTER_ADDR) is not None
            standalone = (not attached
                          and AsyncCheckpointSaver.get_ckpt_saver() is None)
        if standalone:
            # host the async saver in-process (no separate agent)
            self._saver = AsyncCheckpointSaver.start_async_saving_ckpt(
                job_name, local_shard_num=local_shard_num,
                node_rank=node_rank, storage=self.storage)
            self._saver.register_path(checkpoint_dir)
            self._event_queue = self._saver._event_queue
        else:
            self._event_queue = SharedQueue(f"{job_name}-ckpt-events",
                                            master=False)
        # the segment's owner, stamped as its creator pid (shm_handler.py):
        # the process that hosts the saver and persists the segment after
        # a worker dies.  A worker launched by an elastic agent stamps its
        # parent, the agent: another job's saver, sweeping the segments
        # of dead creators at its start, must spare a SIGKILLed worker's
        # segment until the agent has persisted it and relaunched.
        in_process = standalone or \
            AsyncCheckpointSaver.get_ckpt_saver() is not None
        self._owner_pid = os.getpid() if in_process else os.getppid()
        # client side of the saver's per-segment lock: staging must not
        # overwrite the payload while the saver streams it to disk
        self._shm_lock = SharedLock(shm_lock_name(job_name, local_rank),
                                    master=False)
        # report of the last load(): which tier/generation served, every
        # fallback taken and why, whether self-heal re-staged shm
        self.last_restore: Dict = {}
        # restore hint: "" keeps the default verified chain shm →
        # storage; "storage" skips the local shm fast path and forces the
        # authoritative read.  Every tier stays digest-verified — the
        # hint only SKIPS hot tiers, it never adds an unverified path.
        self.preferred_tier = ""

    def _stage_locked(self, state: Any, step: int, extra: Dict):
        acquired = False
        try:
            acquired = self._shm_lock.acquire(
                timeout=CheckpointConstant.SAVE_TIMEOUT)
        except Exception:  # noqa: BLE001 — saver gone: stage unlocked
            acquired = False
        extra = dict(extra)
        extra.setdefault("_pid", self._owner_pid)
        try:
            self._shm_handler.save_state_dict(state, step, extra)
        finally:
            if acquired:
                try:
                    self._shm_lock.release()
                except Exception:  # noqa: BLE001
                    pass

    # ------------------------------------------------------------------ save

    def _wire(self, dtype: torch.dtype) -> torch.dtype:
        """Dtype a leaf of `dtype` is staged in: bf16 wire staging narrows
        float32 leaves (engine docstring)."""
        if self.wire_dtype == "bf16" and dtype == torch.float32:
            return torch.bfloat16
        return dtype

    def _device_snapshot(self, state: Any) -> "_Snapshot":
        """Point-in-time copy of a tree: CUDA leaves get fresh device
        memory, one slab per (device, staged dtype) filled by one
        ``_foreach_copy_`` on the current stream; host leaves a host copy.

        The copy decouples the checkpoint from the step's in-place
        updates: the slabs are never written by training, so the drain
        thread can read them while training rolls forward.
        """
        flat = flatten_state_dict(state)
        snap = _Snapshot(list(flat))
        groups: Dict[torch.device, Dict[torch.dtype, List[str]]] = {}
        for name, leaf in flat.items():
            if not torch.is_tensor(leaf):
                host = np.array(leaf, copy=True)
                if self.wire_dtype == "bf16" and host.dtype == np.float32:
                    host = torch.from_numpy(host).to(torch.bfloat16)
                snap.host[name] = host
            elif leaf.device.type == "cuda":
                groups.setdefault(leaf.device, {}).setdefault(
                    self._wire(leaf.dtype), []).append(name)
            elif leaf.device.type == "cpu":
                snap.host[name] = leaf.detach().to(self._wire(leaf.dtype),
                                                   copy=True)
            else:
                raise ValueError(f"checkpoint leaf {name!r} is on "
                                 f"{leaf.device}: only cuda and cpu tensors "
                                 f"are staged")
        for device, by_dtype in groups.items():
            with torch.cuda.device(device):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for dtype, names in by_dtype.items():
                    srcs = [flat[n].detach() for n in names]
                    numels = [t.numel() for t in srcs]
                    slab = torch.empty(sum(numels), dtype=dtype,
                                       device=device)
                    views = [v.view(t.shape)
                             for v, t in zip(slab.split(numels), srcs)]
                    torch._foreach_copy_(views, srcs)
                    snap.slabs.append((device, dtype, slab, names,
                                       [t.shape for t in srcs]))
                end.record()
                snap.events[device] = (start, end)
        return snap

    def _drain_stream(self, device: torch.device) -> "torch.cuda.Stream":
        stream = self._streams.get(device)
        if stream is None:
            stream = self._streams[device] = torch.cuda.Stream(device)
        return stream

    def _pinned_slab(self, device: torch.device, dtype: torch.dtype,
                     numel: int) -> torch.Tensor:
        """Pinned host buffer for one slab, kept for the next save (drains
        run one at a time, so one buffer a (device, dtype) serves all)."""
        buf = self._pinned.get((device, dtype))
        if buf is None or buf.numel() < numel:
            self._pinned.pop((device, dtype), None)
            buf = torch.empty(numel, dtype=dtype, pin_memory=True)
            self._pinned[(device, dtype)] = buf
        return buf[:numel]

    def _to_host(self, snap: "_Snapshot") -> "OrderedDict[str, Any]":
        """Drain side: each slab to its pinned host buffer on the drain
        stream (after the snapshot's event), then the host views, in the
        tree's order.  Releases the slabs once their copies finished."""
        host = dict(snap.host)
        t0 = time.monotonic()
        for device in snap.events:
            with torch.cuda.device(device):
                stream = self._drain_stream(device)
                stream.wait_event(snap.events[device][1])
                try:
                    with torch.cuda.stream(stream):
                        for dev, dtype, slab, names, shapes in snap.slabs:
                            if dev != device:
                                continue
                            pinned = self._pinned_slab(device, dtype,
                                                       slab.numel())
                            pinned.copy_(slab, non_blocking=True)
                            views = pinned.split([s.numel() for s in shapes])
                            for n, v, s in zip(names, views, shapes):
                                host[n] = v.view(s)
                finally:
                    # no slab may go back to the allocator (the drain's
                    # finally releases them) while this stream reads it
                    stream.synchronize()
        snap.slabs.clear()
        snap.timing["d2h_s"] = time.monotonic() - t0
        return OrderedDict((n, host[n]) for n in snap.order)

    def _wait_drain(self, timeout: Optional[float] = None):
        t = self._drain_thread
        if t is not None and t.is_alive():
            t.join(timeout)
            if t.is_alive():
                raise TimeoutError(
                    f"checkpoint staging of step {self._latest_step} still "
                    f"in flight after {timeout}s")
        with self._drain_lock:
            err, self._drain_error = self._drain_error, None
        if err is not None:
            raise err

    def _take_drain_error(self) -> Optional[BaseException]:
        with self._drain_lock:
            err, self._drain_error = self._drain_error, None
        return err

    def _drain(self, prev: Optional[threading.Thread], snapshot: "_Snapshot",
               step: int, extra: Dict, storage_path: Optional[str]):
        """Background: wait out the predecessor staging (the segment must
        stay whole — one writer at a time), then snapshot → host (the
        drain stream) → shm, then hand off."""
        try:
            if prev is not None and prev.is_alive():
                t0 = time.monotonic()
                prev.join()
                waited = time.monotonic() - t0
                snapshot.timing["chain_wait_s"] = waited
                with self._drain_lock:
                    self._chain_wait_s += waited
            host = self._to_host(snapshot)
            t0 = time.monotonic()
            self._stage_locked(host, step, extra)
            snapshot.timing["stage_s"] = time.monotonic() - t0
            if storage_path is not None:
                self._event_queue.put(CheckpointEvent.save(step,
                                                           storage_path))
        except BaseException as e:  # noqa: BLE001 — surfaced on next save
            logger.exception("checkpoint drain of step %d failed", step)
            with self._drain_lock:
                self._drain_error = e
        finally:
            snapshot.slabs.clear()
            with self._drain_lock:
                self._drain_pending -= 1

    def _start_save(self, step: int, state: Any, extra_meta: Optional[Dict],
                    path: Optional[str],
                    storage_path: Optional[str]) -> float:
        with tspans.span("ckpt:save", {"step": step}):
            t0 = time.monotonic()
            # staging overlap: a prior drain still in flight no longer
            # blocks here — the new drain thread chains behind it.  Only
            # at the chain bound (one running + one queued snapshot in
            # HBM) does this save pay the old blocking wait.
            with self._drain_lock:
                pending = self._drain_pending
                chain_wait, self._chain_wait_s = self._chain_wait_s, 0.0
            if pending >= 2:
                self._wait_drain()  # bound the snapshot chain (HBM)
            err = self._take_drain_error()
            if err is not None:
                raise err
            # ledger split: time spent waiting out PRIOR stagings (here
            # or accumulated inside the drain chain) is persist stall;
            # everything after is this save's own stage cost
            t_persist = time.monotonic() - t0
            get_ledger().account("ckpt_persist", t_persist + chain_wait)
            extra = dict(extra_meta or {})
            # tag the segment with its checkpoint dir so a later process can't
            # restore a stale segment left over from an unrelated job run
            extra.setdefault("_ckpt_dir", path or self.checkpoint_dir)
            try:
                snapshot = self._device_snapshot(state)
            except Exception as e:  # noqa: BLE001
                # state too big to double-buffer in HBM (e.g. GPT-2 xl +
                # AdamW on a 16GB chip): fall back to synchronous staging
                # straight from the live buffers — slower blocking save,
                # but correct
                from ..common.util import is_oom_error

                if not is_oom_error(e):
                    raise
                logger.warning("device snapshot does not fit HBM; staging "
                               "synchronously (%s)", type(e).__name__)
                # the sync path writes the segment from THIS thread: any
                # chained drain must land first (one writer at a time)
                self._wait_drain()
                self._stage_locked(state, step, extra)
                self._latest_step = step
                if storage_path is not None:
                    self._event_queue.put(CheckpointEvent.save(step,
                                                               storage_path))
                blocked = time.monotonic() - t0
                get_ledger().account("ckpt_stage",
                                     max(0.0, blocked - t_persist))
                return blocked
            self._latest_step = step
            self.last_snapshot = snapshot
            prev = self._drain_thread
            with self._drain_lock:
                self._drain_pending += 1
            self._drain_thread = threading.Thread(
                target=self._drain, args=(prev, snapshot, step, extra,
                                          storage_path),
                daemon=True, name="dwt-ckpt-drain")
            self._drain_thread.start()
            blocked = time.monotonic() - t0
            get_ledger().account("ckpt_stage", max(0.0, blocked - t_persist))
            self._record_blocking_metric(blocked)
            return blocked

    def _report_ckpt_health(self, tier: str, reason: str):
        """Checkpoint-health event: local metric + master node event.

        The master's event stream is where operators see corruption —
        a quarantined generation on one node of a large job would
        otherwise only exist in that node's logs."""
        try:
            get_registry().inc(
                "dwt_ckpt_integrity_events",
                labels={"job": self.job_name, "tier": tier})
            from ..trainer import elastic as _elastic

            ctx = getattr(_elastic, "_context", None)
            if ctx is not None and ctx.mc is not None:
                ctx.mc.report_node_event(
                    "ckpt-health", f"{tier}: {reason}", level="warning")
        except Exception:  # noqa: BLE001 — health reporting must never
            pass           # break a restore

    def _record_blocking_metric(self, blocked: float):
        """Local registry + forward to the master (the worker's registry
        is per-process)."""
        try:
            get_registry().observe("dwt_ckpt_seconds", blocked,
                                   {"job": self.job_name,
                                    "kind": "blocking"})
            from ..trainer import elastic as _elastic

            ctx = getattr(_elastic, "_context", None)
            if ctx is not None and ctx.mc is not None:
                ctx.mc.report_custom_metric(
                    {"dwt_ckpt_blocking_seconds": blocked})
        except Exception:  # noqa: BLE001 — metrics must never break saves
            pass

    def save_to_memory(self, step: int, state: Any,
                       extra_meta: Optional[Dict] = None,
                       path: Optional[str] = None) -> float:
        """Snapshot on device + async stage into shm; returns blocking s."""
        return self._start_save(step, state, extra_meta, path, None)

    def save_to_storage(self, step: int, state: Any,
                        path: Optional[str] = None,
                        extra_meta: Optional[Dict] = None) -> float:
        """Snapshot + async stage + hand off to the async saver."""
        path = path or self.checkpoint_dir
        if self._saver is not None:
            self._saver.register_path(path)
        return self._start_save(step, state, extra_meta, path, path)

    def wait_staging(self, timeout: Optional[float] = None):
        """Block until the in-flight snapshot→shm staging (if any) lands."""
        self._wait_drain(timeout)

    def wait_saving_latest(self, timeout: float = 600.0) -> bool:
        """Block until the latest staged step is committed (for tests/exit).

        Keeps the bool contract: staging timeouts/errors → False, not raise.
        """
        deadline = time.monotonic() + timeout
        try:
            self._wait_drain(timeout)
        except (TimeoutError, Exception):  # noqa: BLE001
            logger.warning("staging did not complete within %ss", timeout,
                           exc_info=True)
            return False
        while time.monotonic() < deadline:
            if read_last_step(self.checkpoint_dir,
                              self.storage) >= self._latest_step:
                return True
            time.sleep(0.1)
        return False

    # ------------------------------------------------------------------ load

    def load(self, path: Optional[str] = None,
             step: Optional[int] = None) -> Optional[Dict[str, Any]]:
        """Verified tiered restore → flat {name: host array}: numpy
        arrays, and CPU tensors for bfloat16 and float8 leaves
        (`_assemble`).

        Walks shm segment → storage generations (newest committed
        first), digest-verifying each tier BEFORE any bytes are assembled
        or reach the device — a flipped byte, torn persist, or truncated
        shard can never be silently restored.  A
        storage generation that fails verification is QUARANTINED to the
        ``.quarantine/`` sidecar (evidence, not deletion) and the walk
        continues to the next-older commit.  After a degraded restore
        (any tier but local shm) the recovered state is re-staged into
        shm (self-heal) so the next failure takes the fast path again.
        ``self.last_restore`` reports which tier/generation served and
        every fallback taken.  Names containing ``#shardN`` are assembled
        into full global arrays.

        Telemetry: the walk opens a ``ckpt:restore`` span with one child
        per tier attempted, and each tier's wall time is credited to its
        own ledger state (restore_shm / restore_storage)
        — a degraded restore shows exactly where the time went.
        """
        with tspans.span("ckpt:restore",
                         {"step": -1 if step is None else step}) as rec:
            result = self._load_tiered(path, step)
            rec["attrs"]["tier"] = self.last_restore.get("tier", "none")
            rec["attrs"]["fallbacks"] = len(
                self.last_restore.get("fallbacks", []))
            return result

    def _load_tiered(self, path: Optional[str],
                     step: Optional[int]) -> Optional[Dict[str, np.ndarray]]:
        led = get_ledger()
        self._wait_drain()  # an in-flight staging must land before reading
        path = path or self.checkpoint_dir
        report: Dict = {"tier": "none", "step": -1, "fallbacks": [],
                        "healed": False}
        preferred = self.preferred_tier
        if preferred:
            report["preferred"] = preferred
        self.last_restore = report

        stale_shm = None  # verified shm OLDER than the storage tracker:
        # kept as a candidate in case the newer storage gens are corrupt
        flat, shm_step, reason = None, -1, None
        if preferred != "storage":
            with tspans.span("ckpt:restore:shm"), \
                    led.window("restore_shm"):
                flat, shm_step, reason = self._load_verified_shm(path, step)
        if flat is not None:
            if step is not None or shm_step >= read_last_step(
                    path, self.storage):
                report.update(tier="shm", step=shm_step)
                return flat
            stale_shm = (shm_step, flat)
            reason = "stale"
        if reason:
            report["fallbacks"].append({"tier": "shm", "reason": reason})
            if _is_corruption(reason):
                self._report_ckpt_health("shm", reason)

        with tspans.span("ckpt:restore:storage"), \
                led.window("restore_storage"):
            flat = self.load_from_storage(path, step, _report=report)
        if flat is not None:
            if stale_shm is not None and stale_shm[0] > report["step"]:
                # every storage gen newer than the stale shm was corrupt:
                # the verified shm staging is now the best copy there is
                report.update(tier="shm", step=stale_shm[0])
                return stale_shm[1]
            # multi-process world (local shm legitimately holds only this
            # process's shards): restaging the ASSEMBLED global state
            # would blow local shm up to full-model size — skip the heal,
            # the next save re-stages the right shards
            restage = not any(f.get("reason") == "partial-local-coverage"
                              for f in report["fallbacks"])
            self._finish_degraded(flat, report["step"], path, report,
                                  restage=restage)
            return flat
        if stale_shm is not None:
            report.update(tier="shm", step=stale_shm[0])
            return stale_shm[1]
        return None

    def _load_verified_shm(self, path: str, step: Optional[int]
                           ) -> tuple:
        """(flat, step, reason) — flat None unless the local segment is
        present, tagged for `path`, digest-verified, step-matched, and
        fully covering.  `reason` explains a None (None reason = simply
        no segment staged)."""
        state = self._shm_handler.segment_state()
        if state in ("absent", "empty"):
            return None, -1, None
        if state == "torn":
            return None, -1, "torn-header"
        loaded = self._shm_handler.load_state_dict()
        if loaded is None:  # raced a concurrent invalidation
            return None, -1, None
        shm_step, flat, metas, extra = loaded
        if extra.get("_ckpt_dir") != path:
            # no tag (legacy/foreign segment) must NOT pass the guard
            return None, -1, "foreign-segment"
        if step is not None and shm_step != step:
            return None, -1, "step-mismatch"
        header = self._shm_handler.load_header() or {}
        ok, why = verify_segment_entries(metas, flat,
                                         header.get("algo", ""))
        if not ok:
            logger.error("shm segment for step %d fails verification "
                         "(%s) — falling back", shm_step, why)
            return None, -1, why
        entries = [dict(m.to_dict(), array=flat[m.name]) for m in metas]
        if not self._full_coverage(entries):
            # multi-process world: local shm holds only THIS process's
            # shards — assembling would fill peer shards with garbage
            # (and each process would restore different values).
            # Storage has every rank's shards.
            return None, -1, "partial-local-coverage"
        return self._assemble(entries), shm_step, None

    def _finish_degraded(self, flat: Dict, step: int, path: str,
                         report: Dict, restage: bool):
        """Self-heal after a degraded restore: re-stage the recovered
        state into shm (so the NEXT failure reads the fast tier)."""
        if restage:
            try:
                self._stage_locked(flat, step, {"_ckpt_dir": path})
                ok, why = self._shm_handler.verify()
                report["healed"] = bool(ok)
                if not ok:
                    logger.warning("self-heal restage failed "
                                   "verification: %s", why)
            except Exception:  # noqa: BLE001 — healing must not break restore
                logger.exception("self-heal restage failed")
        self._latest_step = max(self._latest_step, step)
        logger.warning(
            "DEGRADED restore: tier=%s step=%d fallbacks=%s healed=%s",
            report["tier"], step, report["fallbacks"], report["healed"])
        self._report_ckpt_health(
            "degraded-restore",
            f"tier={report['tier']} step={step} "
            f"fallbacks={len(report['fallbacks'])}")

    @staticmethod
    def _full_coverage(entries) -> bool:
        """True iff every sharded tensor's shards tile its global shape."""
        import math

        vol: Dict[str, int] = {}
        glob: Dict[str, tuple] = {}
        for e in entries:
            name = e["name"]
            base = name.split("#shard")[0]
            if "#shard" not in name:
                continue  # whole tensor present
            glob[base] = tuple(e["global_shape"])
            v = 1
            for s, t in e["index"]:
                v *= max(0, t - s)
            vol[base] = vol.get(base, 0) + v
        return all(vol.get(b, 0) >= math.prod(gs) for b, gs in glob.items())

    def load_from_storage(self, path: Optional[str] = None,
                          step: Optional[int] = None,
                          _report: Optional[Dict] = None
                          ) -> Optional[Dict[str, np.ndarray]]:
        """Verified walk over committed generations, newest first.

        Explicit `step`: that generation only — a verification failure
        quarantines it and returns None (the caller asked for THOSE
        bytes; substituting another step silently would be worse than
        failing).  `step=None`: newest-first over every committed
        generation, quarantining failures and falling back until one
        verifies.  `_report` (engine-internal) collects tier/fallbacks.
        """
        path = path or self.checkpoint_dir
        report = _report if _report is not None else {
            "tier": "none", "step": -1, "fallbacks": [], "healed": False}
        if _report is None:
            self.last_restore = report
        if step is not None:
            candidates = [step]
        else:
            tracker = read_last_step(path, self.storage)
            candidates = sorted(
                set(self.committed_steps(path))
                | ({tracker} if tracker >= 0 else set()),
                reverse=True)
        for s in candidates:
            flat, failure = self._read_verified_step(path, s)
            if flat is not None:
                report.update(tier="storage", step=s)
                if step is None and s != candidates[0]:
                    logger.warning(
                        "restored OLDER generation %d (newest committed "
                        "was %d) — newer generations failed verification",
                        s, candidates[0])
                if step is None and report["fallbacks"] and \
                        read_last_step(path, self.storage) > s:
                    # the tracker's target was just quarantined: repoint
                    # it at the generation that actually verified, so
                    # later loads (and freshness comparisons against the
                    # healed shm staging) converge instead of re-walking
                    self.storage.write(str(s), os.path.join(
                        path, CheckpointConstant.TRACKER_FILE))
                return flat
            if failure is None:
                continue  # nothing (or an in-progress persist) there
            # verification failed: quarantine the evidence, walk on
            qdir = quarantine_step(self.storage, path, s, failure)
            report["fallbacks"].append(
                {"tier": "storage", "step": s, "reason": failure,
                 "quarantined": qdir})
            self._report_ckpt_health("storage", f"step {s}: {failure}")
        return None

    def _read_verified_step(self, path: str, step: int) -> tuple:
        """(flat, failure_reason): digest-verified read of one generation.

        (None, None) = generation absent / not yet committed (benign);
        (None, reason) = bytes present but fail the trust boundary.
        """
        sdir = step_dir(path, step)
        manifest = read_manifest(self.storage, sdir)
        if manifest is None:
            if not self.storage.exists(sdir):
                if read_last_step(path, self.storage) == step:
                    # the tracker names a generation that no longer
                    # exists at all — data loss, not an in-flight save
                    return None, "missing-generation"
                return None, None
            marker = os.path.join(sdir, CheckpointConstant.COMMIT_MARKER)
            tracker_step = read_last_step(path, self.storage)
            if self.storage.exists(marker) or tracker_step == step:
                # committed (or tracker-published) without a manifest:
                # a torn/ripped-out manifest, or a pre-trust-boundary
                # writer — unverifiable either way
                return None, "missing-manifest"
            return None, None  # persist still in flight — not ours to touch
        if int(manifest.get("step", -1)) != step:
            return None, "manifest-step-mismatch"
        algo = manifest.get("algo", "")
        entries = []
        for rank_s, entry in manifest["ranks"].items():
            rank = int(rank_s)
            meta_raw = self.storage.read(
                os.path.join(sdir, f"meta_rank{rank}.json"))
            raw = self.storage.read(
                os.path.join(sdir, f"shards_rank{rank}.bin"))
            if meta_raw is None or raw is None:
                return None, "missing-shard-file"
            meta_raw = (meta_raw.encode() if isinstance(meta_raw, str)
                        else bytes(meta_raw))
            raw = bytes(raw)
            try:
                meta = verify_meta_bytes(meta_raw, entry, algo, rank)
                verify_rank_bytes(raw, entry, algo, rank)
            except VerifyFailure as e:
                logger.error("step %d rank %d fails verification: %s",
                             step, rank, e)
                return None, e.reason
            for t in meta["tensors"]:
                arr = np.frombuffer(
                    raw, dtype=_np_dtype(t["dtype"]),
                    count=int(np.prod(t["shape"])) if t["shape"] else 1,
                    offset=t["file_offset"]).reshape(t["shape"])
                entries.append(dict(t, array=arr))
        if not self._full_coverage(entries):
            # partial step (a rank's shards never landed): assembling
            # would fill the holes with uninitialized memory
            logger.error("step %d on storage is missing shards — refusing "
                         "to assemble a partial checkpoint", step)
            return None, "partial-coverage"
        return self._assemble(entries), None

    @staticmethod
    def _assemble(entries) -> Dict[str, Any]:
        """Merge `name#shardN` pieces into global arrays by their indices.

        A bfloat16 or float8 leaf, read as its unsigned integer view,
        comes out as a CPU tensor of its dtype (numpy has no such dtype
        without ml_dtypes): a copy, so the tensor owns writable memory."""
        out: Dict[str, Any] = {}
        partial: Dict[str, np.ndarray] = {}
        dtypes: Dict[str, str] = {}
        for e in entries:
            name = e["name"]
            base = name.split("#shard")[0]
            dtypes[base] = e["dtype"]
            if "#shard" not in name:
                out[base] = e["array"]
                continue
            if base not in partial:
                partial[base] = np.empty(e["global_shape"],
                                         dtype=e["array"].dtype)
            slices = tuple(slice(s, t) for s, t in e["index"])
            partial[base][slices] = e["array"]
        out.update(partial)
        for name, dtype in dtypes.items():
            if dtype in TORCH_ONLY_DTYPES:
                out[name] = torch.from_numpy(np.array(out[name])).view(
                    TORCH_ONLY_DTYPES[dtype][1])
        return out

    def latest_step(self) -> int:
        return max(self._latest_step,
                   read_last_step(self.checkpoint_dir, self.storage))

    def committed_steps(self, path: Optional[str] = None) -> list:
        """Sorted steps on storage bearing the commit marker.

        Loss-spike rollback needs to pick a step BEFORE the spike, not just
        the tracker's latest — the latest commit can postdate spike onset.
        The marker (written by `commit_checkpoint` only after EVERY shard's
        done-file landed) is required: a non-empty done-dir alone can be a
        partial set whose assembly would be silent garbage.
        """
        from ..common.constants import CheckpointConstant

        path = path or self.checkpoint_dir
        prefix = CheckpointConstant.CKPT_NAME_PREFIX
        steps = []
        for name in self.storage.listdir(path):
            if not name.startswith(prefix):
                continue
            try:
                step = int(name[len(prefix):])
            except ValueError:
                continue
            marker = os.path.join(path, name,
                                  CheckpointConstant.COMMIT_MARKER)
            if self.storage.exists(marker):
                steps.append(step)
        return sorted(steps)

    def demote_steps_after(self, step: int,
                           path: Optional[str] = None) -> None:
        """Point the tracker at `step` and delete NEWER step dirs.

        Rollback durability: once a spike rollback resumes from `step`,
        the post-spike commits are a poisoned lineage — if they survived,
        any later crash (before the rolled-back run commits fresh) would
        resume from them and silently undo the rollback.
        """
        from ..common.constants import CheckpointConstant

        path = path or self.checkpoint_dir
        for s in self.committed_steps(path):
            if s > step:
                logger.warning("rollback: discarding post-spike "
                               "checkpoint step %d", s)
                self.storage.safe_remove(step_dir(path, s))
        self.storage.write(str(step), os.path.join(
            path, CheckpointConstant.TRACKER_FILE))
        self._latest_step = min(self._latest_step, step)
        # the shm staging may still hold the newest (post-spike) state —
        # a later plain load() would prefer it over the demoted tracker
        header = self._shm_handler.load_header()
        if header and header.get("step", 0) > step:
            self._shm_handler.mark_empty()

    def close(self):
        try:
            self._wait_drain(timeout=600)
        except BaseException:  # noqa: BLE001 — teardown must proceed
            logger.exception("pending checkpoint drain failed during close")
        self._pinned.clear()  # the drain's pinned host buffers
        self._shm_handler.close()
        self._shm_lock.close()
        if self._event_queue is not None and self._saver is None:
            self._event_queue.close()


class _Snapshot:
    """One save's point-in-time copy: the tree's leaf names in order, the
    host leaves, the device slabs (device, dtype, slab, names, shapes),
    and per device the CUDA events around the copy.  `timing` collects
    the drain's seconds (``d2h_s``, ``stage_s``, ``chain_wait_s``)."""

    def __init__(self, order: List[str]):
        self.order = order
        self.host: Dict[str, Any] = {}
        self.slabs: List[Tuple] = []
        self.events: Dict[torch.device, Tuple] = {}
        self.timing: Dict[str, float] = {}

    def device_ms(self) -> float:
        """Device time of the snapshot's copies (CUDA events); waits for
        them to finish."""
        ms = 0.0
        for start, end in self.events.values():
            end.synchronize()
            ms += start.elapsed_time(end)
        return ms


def _host_tensor(value: Any) -> torch.Tensor:
    """A loaded host array as a CPU tensor (a copy where the array is
    read-only, as arrays over loaded bytes are)."""
    if torch.is_tensor(value):
        return value
    arr = np.asarray(value)
    return torch.from_numpy(arr if arr.flags.writeable else arr.copy())


def _torch_dtype(value: Any) -> torch.dtype:
    if torch.is_tensor(value):
        return value.dtype
    return torch.from_numpy(np.empty(0, np.asarray(value).dtype)).dtype


@torch.no_grad()
def _restore_cuda(pairs: List[Tuple[torch.Tensor, Any]]):
    """Host values into CUDA leaves, in place: per (device, stored dtype)
    one pinned buffer filled on the host, then one copy per leaf to the
    device; a stored dtype narrower than the leaf's (bf16 wire) lands in
    a device temporary and is upcast there."""
    groups: Dict[Tuple, List] = {}
    for leaf, value in pairs:
        groups.setdefault((leaf.device, _torch_dtype(value)), []).append(
            (leaf, value))
    for (device, dtype), items in groups.items():
        numels = [leaf.numel() for leaf, _ in items]
        pinned = torch.empty(sum(numels), dtype=dtype, pin_memory=True)
        with torch.cuda.device(device):
            for (leaf, value), view in zip(items, pinned.split(numels)):
                if torch.is_tensor(value):
                    view.copy_(value.reshape(-1))
                else:
                    view.numpy()[...] = np.asarray(value).reshape(-1)
                src = view.view(leaf.shape)
                if leaf.dtype == dtype:
                    leaf.copy_(src, non_blocking=True)
                else:
                    tmp = torch.empty(leaf.shape, dtype=dtype, device=device)
                    tmp.copy_(src, non_blocking=True)
                    leaf.copy_(tmp)
            # the pinned buffer is read by the copies above: the restored
            # state is on the card when this returns
            torch.cuda.current_stream(device).synchronize()


def restore_tree(template: Any, flat: Dict[str, Any]) -> Any:
    """Restore the flat name→array map that `CheckpointEngine.load`
    returns into `template`, in place; returns `template`.  A template
    with a ``load_tree`` method (a `trainer.train_step.TrainState`, or
    its ``tree()``) restores through it; any other tree of tensors
    through `copy_into`."""
    if hasattr(template, "load_tree"):
        template.load_tree(flat)
    else:
        copy_into(template, flat)
    return template


@torch.no_grad()
def copy_into(template: Any, flat: Dict[str, Any]):
    """Copy `flat` into `template`'s tensors, in place, on their devices.

    Dtype casts follow JAX's `restore_pytree` (:825-842): a stored dtype
    narrower than a CUDA leaf's (bf16 wire staging) is shipped as stored
    and upcast on the device; any other difference is cast on the host
    before the copy."""
    cuda: List[Tuple[torch.Tensor, Any]] = []
    for name, leaf in flatten_state_dict(template).items():
        if name not in flat:
            raise KeyError(f"checkpoint missing tensor {name!r}")
        if not torch.is_tensor(leaf):
            raise TypeError(f"template leaf {name!r} is a "
                            f"{type(leaf).__name__}: restore writes into "
                            f"tensors in place")
        value = flat[name]
        if not torch.is_tensor(value):
            value = np.asarray(value)
        stored = _torch_dtype(value)
        if stored != leaf.dtype and not (
                leaf.device.type == "cuda"
                and stored.itemsize < leaf.dtype.itemsize):
            value = _host_tensor(value).to(leaf.dtype)
        if tuple(value.shape) != tuple(leaf.shape):
            raise ValueError(f"{name}: checkpoint shape "
                             f"{tuple(value.shape)} != {tuple(leaf.shape)}")
        if leaf.device.type == "cuda":
            cuda.append((leaf, value))
        elif leaf.device.type == "cpu":
            leaf.copy_(_host_tensor(value))
        else:
            raise ValueError(f"template leaf {name!r} is on {leaf.device}: "
                             f"only cuda and cpu tensors are restored")
    if cuda:
        _restore_cuda(cuda)
