"""Checkpoint trust boundary: digests, atomic manifests, quarantine.

Parity: a whole copy of dlrover_wuqiong_tpu/checkpoint/integrity.py:1-297
(no JAX), kept in the port because the port imports nothing of the JAX
package.  The digest is the same: crc32c when ``google_crc32c`` imports,
else zlib crc32, with the algorithm recorded beside every digest, so a
generation written on a host with the other algorithm reads as
``algo-mismatch`` (ROADMAP queue 3, a deliberate sameness).

Parity: reference `dlrover/python/common/storage.py` (commit hooks) and
`elastic_agent/torch/ckpt_saver.py:773` (done-file commit protocol) carry
NO content integrity — the reference trusts whatever bytes the filesystem
returns.  PHOENIX-style resilience (PAPERS.md) hinges on *trusting* the
hot-swappable checkpoint at restore time, so this module adds the layer
the reference lacks:

- per-leaf digests (crc32c when `google_crc32c` is present, else
  zlib.crc32 — the algorithm travels in the manifest, so a reader never
  compares digests computed under different algorithms);
- a per-generation ``manifest.json`` committed atomically (write-tmp +
  fsync + rename via `PosixDiskStorage.write`) AFTER every rank's shard
  file landed and BEFORE the commit marker / tracker publish — a torn
  persist is detectable by construction: marker without manifest, or
  manifest whose digests do not match the bytes, is never restored;
- quarantine: a generation that fails verification is MOVED to a
  ``.quarantine/`` sidecar dir (never deleted — post-mortems need the
  bytes) so the fallback walk cannot trip over it twice.

Restore-time verification for every tier (shm segment, replica blob,
storage generation) lives here too, so `engine.load` / `replica.restore`
/ `tools/ckpt_doctor.py` all share one definition of "healthy".
"""

from __future__ import annotations

import json
import os
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

from ..common.log import get_logger

logger = get_logger("ckpt_integrity")

try:  # C-speed crc32c (ships with the GCS client stack)
    import google_crc32c

    DIGEST_ALGO = "crc32c"

    def _crc(data, value: int = 0) -> int:
        return int(google_crc32c.extend(value, bytes(data)))
except ImportError:  # pragma: no cover — container-dependent
    DIGEST_ALGO = "crc32"

    def _crc(data, value: int = 0) -> int:
        return zlib.crc32(data, value) & 0xFFFFFFFF


MANIFEST_NAME = "manifest.json"
QUARANTINE_DIR = ".quarantine"
MANIFEST_VERSION = 1


def digest_bytes(data, value: int = 0) -> int:
    """Streaming digest: feed chunks, carrying `value` between calls."""
    return _crc(data, value)


def digest_array(arr) -> int:
    """Digest of a numpy array's C-contiguous bytes."""
    import numpy as np

    host = np.ascontiguousarray(arr)
    return _crc(host.view(np.uint8).reshape(-1).tobytes())


# ------------------------------------------------------------- manifest


def build_manifest(step: int, ranks: Dict[int, Dict], *,
                   world: Optional[Dict] = None,
                   extra: Optional[Dict] = None) -> Dict:
    """Manifest dict for one committed generation.

    `ranks`: {global_rank: {"bin_nbytes", "bin_digest", "meta_digest",
    "n_tensors"}} — per-leaf digests live in the rank's meta json (which
    the meta_digest seals), keeping the manifest O(ranks) not O(leaves).
    `world` carries mesh/world shape; `extra` the engine's staging extras
    (fused-K, mesh shape, the _ckpt_dir tag).
    """
    return {
        "version": MANIFEST_VERSION,
        "algo": DIGEST_ALGO,
        "step": int(step),
        "created_unix": time.time(),
        "world": dict(world or {}),
        "extra": dict(extra or {}),
        "ranks": {str(r): dict(v) for r, v in ranks.items()},
    }


def write_manifest(storage, sdir: str, manifest: Dict) -> None:
    """Atomic publish: storage.write is write-tmp + fsync + rename."""
    storage.write(json.dumps(manifest), os.path.join(sdir, MANIFEST_NAME))


def read_manifest(storage, sdir: str) -> Optional[Dict]:
    """Parsed manifest, or None when missing/torn/not-a-manifest."""
    raw = storage.read(os.path.join(sdir, MANIFEST_NAME), "r")
    if not raw:
        return None
    try:
        m = json.loads(raw)
    except ValueError:
        return None
    if not isinstance(m, dict) or "ranks" not in m or "step" not in m:
        return None
    return m


# ---------------------------------------------------------- verification


class VerifyFailure(Exception):
    """A tier offered bytes that do not match their manifest/digests."""

    def __init__(self, reason: str, detail: str = ""):
        self.reason = reason
        self.detail = detail
        super().__init__(f"{reason}: {detail}" if detail else reason)


def verify_rank_bytes(raw: bytes, rank_entry: Dict, algo: str,
                      rank: int) -> None:
    """Digest-check one rank's shard-file bytes against its manifest entry.

    Raises VerifyFailure; the caller already holds `raw` for slicing, so
    verification costs one pass over bytes it was going to read anyway.
    """
    if algo != DIGEST_ALGO:
        # digests from another algorithm are incomparable — treat as
        # unverifiable rather than silently passing
        raise VerifyFailure("algo-mismatch",
                            f"manifest algo {algo!r} != local {DIGEST_ALGO!r}")
    if len(raw) != int(rank_entry.get("bin_nbytes", -1)):
        raise VerifyFailure(
            "truncated-shard-file",
            f"rank {rank}: {len(raw)} bytes on storage, manifest says "
            f"{rank_entry.get('bin_nbytes')}")
    if digest_bytes(raw) != int(rank_entry.get("bin_digest", -1)):
        raise VerifyFailure("shard-digest-mismatch",
                            f"rank {rank}: shard file bytes do not match "
                            f"the committed digest")


def verify_meta_bytes(meta_raw: bytes, rank_entry: Dict, algo: str,
                      rank: int) -> Dict:
    """Digest-check + parse one rank's meta json; returns the parsed meta."""
    if algo != DIGEST_ALGO:
        raise VerifyFailure("algo-mismatch",
                            f"manifest algo {algo!r} != local {DIGEST_ALGO!r}")
    if digest_bytes(meta_raw) != int(rank_entry.get("meta_digest", -1)):
        raise VerifyFailure("meta-digest-mismatch",
                            f"rank {rank}: meta json does not match the "
                            f"committed digest")
    try:
        return json.loads(meta_raw.decode())
    except (ValueError, UnicodeDecodeError) as e:
        raise VerifyFailure("torn-meta", f"rank {rank}: {e}") from e


def verify_storage_step(storage, path: str, step: int,
                        per_leaf: bool = False) -> Dict:
    """Full offline verification of one generation (doctor / drills).

    Returns {"ok", "step", "reason", "bad_leaves", "ranks"} — never
    raises.  `per_leaf=True` additionally digests every tensor slice to
    pinpoint WHICH leaf a shard-file mismatch hit.
    """
    from .ckpt_saver import step_dir

    sdir = step_dir(path, step)
    out: Dict[str, Any] = {"step": step, "ok": False, "reason": None,
                           "bad_leaves": [], "ranks": 0}
    manifest = read_manifest(storage, sdir)
    if manifest is None:
        out["reason"] = "missing-manifest"
        return out
    if int(manifest.get("step", -1)) != step:
        out["reason"] = "manifest-step-mismatch"
        return out
    algo = manifest.get("algo", "")
    for rank_s, entry in manifest["ranks"].items():
        rank = int(rank_s)
        meta_raw = storage.read(
            os.path.join(sdir, f"meta_rank{rank}.json"))
        raw = storage.read(os.path.join(sdir, f"shards_rank{rank}.bin"))
        if meta_raw is None or raw is None:
            out["reason"] = "missing-shard-file"
            return out
        try:
            meta = verify_meta_bytes(bytes(meta_raw), entry, algo, rank)
            verify_rank_bytes(bytes(raw), entry, algo, rank)
        except VerifyFailure as e:
            out["reason"] = e.reason
            if not per_leaf:
                return out
            meta = None
        if per_leaf and meta is not None:
            for t in meta.get("tensors", []):
                if "digest" not in t:
                    continue
                chunk = bytes(raw)[t["file_offset"]:
                                   t["file_offset"] + t["nbytes"]]
                if digest_bytes(chunk) != int(t["digest"]):
                    out["bad_leaves"].append(
                        {"rank": rank, "name": t["name"]})
        out["ranks"] += 1
    if out["reason"] is None and not out["bad_leaves"]:
        out["ok"] = True
    elif out["reason"] is None:
        out["reason"] = "leaf-digest-mismatch"
    return out


# ------------------------------------------------------------ quarantine


def quarantine_step(storage, path: str, step: int, reason: str) -> str:
    """Move a failed generation into the `.quarantine/` sidecar.

    Never deletes: the corrupt bytes are evidence.  Returns the
    quarantine path ("" when there was nothing to move).  A `.reason`
    file records why and when, for the doctor CLI and post-mortems.
    """
    from .ckpt_saver import step_dir

    sdir = step_dir(path, step)
    if not storage.exists(sdir):
        return ""
    qroot = os.path.join(path, QUARANTINE_DIR)
    storage.safe_makedirs(qroot)
    dst = os.path.join(qroot, os.path.basename(sdir))
    n = 0
    while storage.exists(dst):  # re-corruption of a later same-step save
        n += 1
        dst = os.path.join(qroot, f"{os.path.basename(sdir)}.{n}")
    try:
        # posix fast path: one rename keeps it atomic and cheap
        os.replace(sdir, dst)
    except OSError:
        # object store / cross-device: copy-then-remove via the backend
        _copy_tree(storage, sdir, dst)
        storage.safe_remove(sdir)
    storage.write(
        json.dumps({"reason": reason, "quarantined_unix": time.time()}),
        os.path.join(dst, ".reason"))
    logger.error("quarantined checkpoint step %d -> %s (%s)", step, dst,
                 reason)
    return dst


def _copy_tree(storage, src: str, dst: str) -> None:
    storage.safe_makedirs(dst)
    for name in storage.listdir(src):
        sp, dp = os.path.join(src, name), os.path.join(dst, name)
        if storage.listdir(sp):  # non-empty dir
            _copy_tree(storage, sp, dp)
            continue
        try:
            data = storage.read(sp)
        except OSError:  # empty directory on a posix backend
            data = None
        if data is not None:
            storage.write(data, dp)
        else:
            storage.safe_makedirs(dp)


def list_quarantined(storage, path: str) -> List[str]:
    return [n for n in storage.listdir(os.path.join(path, QUARANTINE_DIR))]


# ----------------------------------------------------- shm segment verify


def verify_segment_entries(metas: List, flat: Dict, algo: str
                           ) -> Tuple[bool, str]:
    """Digest-check loaded shm tensors against their header metas.

    `metas` are TensorMeta (digest == -1 means a legacy writer: fails
    verification — the trust boundary does not grandfather undigested
    bytes into device_put).  Returns (ok, reason).
    """
    if algo and algo != DIGEST_ALGO:
        return False, "algo-mismatch"
    for m in metas:
        d = getattr(m, "digest", -1)
        if d is None or int(d) < 0:
            return False, f"undigested-leaf:{m.name}"
        if digest_array(flat[m.name]) != int(d):
            return False, f"leaf-digest-mismatch:{m.name}"
    return True, ""
