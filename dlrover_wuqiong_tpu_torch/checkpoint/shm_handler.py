"""Shared-memory staging of flat tensor trees.

Parity: dlrover_wuqiong_tpu/checkpoint/shm_handler.py:1-449, with the
segment format byte for byte: a 1 MiB header region ([0:8] big-endian
json length, published last; [8:12] the crc of the json; [12:12+n] the
json), payload from 1 MiB on, one `TensorMeta` per leaf with the same
fields, each leaf's digest over its staged bytes, the creator pid in
``extra``.  A segment either package writes loads in the other, and so
does a blob, the segment's bytes as the replica ring ships them
(`verify_segment_blob`, `blob_state_dict`; JAX :351-394).

One departure from the JAX module: a handler re-attaches when the
segment under its name was re-created (another inode or size), where the
JAX one keeps reading its old mapping.  A segment is re-created when a
writer needs more room (`_ensure_size`) or the replica ring restores it,
and an agent's saver left on the unlinked mapping would skip every later
step ("shm holds step N, expected M").

Where the JAX module walks ``jax.Array`` shards, this one takes
`torch.Tensor` leaves (and numpy arrays, and Python or numpy scalars):

- `flatten_state_dict` walks nested ``dict`` / ``list`` / ``tuple`` /
  NamedTuple / dataclass trees and gives the names JAX's
  ``tree_flatten_with_path`` gives (``/``-joined keys, indices and field
  names; a ``dict``'s keys sorted, as JAX sorts them; ``None`` is an
  empty subtree).
- `_leaf_refs` takes a tensor whole.  A rank's piece of a sharded
  tensor (a `MeshPiece`, which a sharded `TrainState.tree` hands over, or
  a DTensor) is one ``name#shardN`` leaf with its global shape and
  ``[start, stop)`` index per dim, as JAX writes a ``jax.Array``'s
  distinct shards (JAX :99-114); a piece that covers the whole tensor
  keeps the plain name, and a piece replicated over other ranks is
  written only by the rank at coordinate 0 of those mesh dims.  The
  engine assembles ``#shardN`` leaves, so a checkpoint from any mesh
  loads in any world.
- Dtype names stay JAX's (``float32``, ``bfloat16``, ``float8_e4m3fn``,
  ``int32``, ...).  numpy has no bfloat16 or float8 without ``ml_dtypes``,
  which the port does not use: such bytes move as same-width unsigned
  integer views (`_np_dtype`), and `_host_bytes` reads any leaf as its raw
  bytes.  The engine turns a read-back bfloat16 or float8 leaf into a CPU
  tensor of its dtype (engine.py `_assemble`).

A leaf on the card is read back to the host here only on the synchronous
path (the engine's out-of-memory fallback); the flash path hands this
module host tensors that its drain already copied (engine.py).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..common.log import get_logger
from ..common.multi_process import SharedMemoryBuffer
from .integrity import DIGEST_ALGO, digest_bytes

logger = get_logger("shm_handler")

_HEADER_SIZE = 1 << 20  # fixed 1MB header region
# header layout: [0:8] big-endian json length (0 = empty/invalid, published
# LAST for crash consistency), [8:12] crc of the json bytes (a bit flip in
# the header itself must not yield a parseable-but-wrong meta), [12:12+n]
# the json.  Payload starts at _HEADER_SIZE.
_HDR_JSON_OFF = 12

#: dtypes numpy lacks (without ml_dtypes): their bytes read back as
#: same-width unsigned integers, and the engine views them as torch
#: tensors of the named dtype
TORCH_ONLY_DTYPES = {
    "bfloat16": (np.uint16, torch.bfloat16),
    "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
    "float8_e5m2": (np.uint8, torch.float8_e5m2),
}


def _np_dtype(name: str) -> np.dtype:
    """numpy dtype that holds a leaf of dtype `name` (JAX's name)."""
    if name in TORCH_ONLY_DTYPES:
        return np.dtype(TORCH_ONLY_DTYPES[name][0])
    return np.dtype(name)


def dtype_name(value: Any) -> str:
    """JAX's name of a leaf's dtype: ``torch.bfloat16`` -> ``bfloat16``."""
    if torch.is_tensor(value):
        return str(value.dtype).removeprefix("torch.")
    return np.dtype(value.dtype).name


@dataclass
class TensorMeta:
    """Location of one array shard inside the shm segment."""

    name: str
    dtype: str
    shape: List[int]  # shard (local) shape
    offset: int
    nbytes: int
    global_shape: List[int] = field(default_factory=list)
    # per-dim [start, stop) of this shard within the global array
    index: List[List[int]] = field(default_factory=list)
    # crc of this shard's staged bytes (-1 = legacy writer, fails the
    # trust boundary's verification on purpose)
    digest: int = -1

    def to_dict(self):
        return {
            "name": self.name, "dtype": self.dtype, "shape": self.shape,
            "offset": self.offset, "nbytes": self.nbytes,
            "global_shape": self.global_shape, "index": self.index,
            "digest": self.digest,
        }

    @classmethod
    def from_dict(cls, d):
        return cls(**d)


class MeshPiece:
    """A rank's piece of a sharded leaf: its `local` tensor, the global
    shape, the ``[start, stop)`` index per dim, its number among the
    leaf's distinct pieces, and whether this rank writes it (`owner`).

    `restore`, if set, is how a restore fills the piece: ``restore(name,
    flat) -> (target tensor, its value)`` from the checkpoint's flat
    name→global array map (a quantized state's piece, `parallel.fsdp`,
    reads its sibling leaves there and names the tensor it fills);
    without it `local` gets the global array's slice at `index`."""

    def __init__(self, local, global_shape, index, number: int = 0,
                 owner: bool = True, restore=None):
        self.local = local
        self.global_shape = [int(s) for s in global_shape]
        self.index = [[int(a), int(b)] for a, b in index]
        self.number = number
        self.owner = owner
        self.restore = restore

    @property
    def whole(self) -> bool:
        return self.index == [[0, s] for s in self.global_shape]

    def with_local(self, local) -> "MeshPiece":
        """The same piece over another copy of its values."""
        return MeshPiece(local, self.global_shape, self.index,
                         self.number, self.owner, self.restore)

    def stacked(self, r: int, replicas: int, numbers: int) -> "MeshPiece":
        """This piece as replica `r`'s of a leaf stacked over `replicas`
        on a new leading dim (local ``(1, ...)``, index ``[r, r + 1)``
        there, number ``r * numbers + number`` where each replica has
        `numbers` pieces); a restore hook reads the replica's slice of
        every global array it asks for."""
        restore = None
        if self.restore is not None:
            inner = self.restore

            def restore(name, flat, _r=r):
                return inner(name, _Replica(flat, _r))
        return MeshPiece(self.local.unsqueeze(0),
                         [replicas] + self.global_shape,
                         [[r, r + 1]] + self.index,
                         r * numbers + self.number, self.owner, restore)


class _Replica:
    """A flat name→array map seen through replica `r` of stacked leaves:
    ``m[name]`` is ``flat[name][r]``."""

    def __init__(self, flat, r: int):
        self.flat, self.r = flat, r

    def __contains__(self, name) -> bool:
        return name in self.flat

    def __getitem__(self, name):
        return self.flat[name][self.r]


def mesh_piece(value) -> MeshPiece:
    """A DTensor's local piece as a `MeshPiece` (its layout from its own
    mesh: `parallel.sharding.dtensor_layout`)."""
    from ..parallel.sharding import dtensor_layout

    index, number, owner = dtensor_layout(value)
    return MeshPiece(value.to_local(), value.shape, index, number, owner)


def _leaf_refs(name: str, value: Any) -> List[Tuple[str, Any, List[int],
                                                    List[List[int]]]]:
    """One leaf -> [(name, ref, global_shape, index)]: a tensor stays
    where it is (no transfer here) and is staged whole; a rank's piece
    of a sharded leaf (`MeshPiece`, DTensor) is ``name#shardN``, or
    nothing where another rank writes it; anything else becomes a numpy
    array."""
    from ..parallel.fsdp import is_dtensor

    if is_dtensor(value):
        value = mesh_piece(value)
    if isinstance(value, MeshPiece):
        if not value.owner:
            return []
        ref = value.local
        ref = ref.detach() if torch.is_tensor(ref) else np.asarray(ref)
        ename = name if value.whole else f"{name}#shard{value.number}"
        return [(ename, ref, list(value.global_shape),
                 [list(i) for i in value.index])]
    if torch.is_tensor(value):
        ref = value.detach()
    else:
        ref = np.asarray(value)
    shape = list(ref.shape)
    return [(name, ref, shape, [[0, s] for s in shape])]


def _host_bytes(ref) -> np.ndarray:
    """A leaf's C-contiguous bytes on the host, as a flat uint8 array (a
    view where the leaf is a contiguous host array already)."""
    if torch.is_tensor(ref):
        if ref.device.type != "cpu":
            ref = ref.to("cpu")  # the synchronous staging path only
        return ref.contiguous().reshape(-1).view(torch.uint8).numpy()
    # np.ascontiguousarray promotes 0-d to 1-d; the meta keeps the shape
    return np.ascontiguousarray(ref).view(np.uint8).reshape(-1)


def _flatten(node: Any, path: List[str], out: Dict[str, Any]):
    if node is None:  # an empty subtree, as in JAX
        return
    if isinstance(node, dict):
        # JAX sorts a dict's keys and keeps an OrderedDict's order
        keys = node if isinstance(node, OrderedDict) else sorted(node)
        for k in keys:
            _flatten(node[k], path + [str(k)], out)
    elif isinstance(node, tuple) and hasattr(node, "_fields"):  # NamedTuple
        for f in node._fields:
            _flatten(getattr(node, f), path + [f], out)
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            _flatten(v, path + [str(i)], out)
    elif dataclasses.is_dataclass(node) and not isinstance(node, type):
        for f in dataclasses.fields(node):
            _flatten(getattr(node, f.name), path + [f.name], out)
    else:
        out["/".join(path) if path else "leaf"] = node


def flatten_state_dict(state: Any) -> Dict[str, Any]:
    """Tree -> flat {path: leaf} with '/'-joined string paths, the names
    JAX's ``flatten_state_dict`` gives the same tree."""
    flat: Dict[str, Any] = {}
    _flatten(state, [], flat)
    return flat


_SHM_ROOT = "/dev/shm"


class SharedMemoryHandler:
    """Owns one shm segment staging one process's checkpoint shards."""

    def __init__(self, local_rank: int, job_name: str = "dwt"):
        self._name = f"{job_name}_ckpt_shm_{local_rank}"
        self.local_rank = local_rank
        self._buf: Optional[SharedMemoryBuffer] = None
        # (inode, size) of the segment `_buf` maps, None where the host
        # has no /dev/shm to compare against
        self._mapped: Optional[Tuple[int, int]] = None
        self._lock = threading.Lock()

    @property
    def shm_name(self) -> str:
        return self._name

    def _segment_id(self) -> Optional[Tuple[int, int]]:
        """(inode, size) of the segment now under this name; None when
        there is none (or no /dev/shm)."""
        try:
            st = os.stat(os.path.join(_SHM_ROOT, self._name))
        except OSError:
            return None
        return st.st_ino, st.st_size

    def _map(self, buf: SharedMemoryBuffer):
        self._buf = buf
        self._mapped = self._segment_id()

    def _drop_stale(self):
        """Forget a mapping whose segment was unlinked or re-created."""
        if self._buf is None or self._mapped is None:
            return
        if self._segment_id() != self._mapped:
            logger.info("shm segment %s was re-created: re-attaching",
                        self._name)
            self._buf.close()
            self._buf = None
            self._mapped = None

    def _ensure_size(self, needed: int):
        self._drop_stale()
        if self._buf is None or self._buf.size < needed:
            if self._buf is not None:
                self._buf.close()
            size = 1 << max(20, math.ceil(math.log2(needed)))
            self._map(SharedMemoryBuffer(self._name, create=True, size=size))

    def attach(self) -> bool:
        self._drop_stale()
        try:
            if self._buf is None:
                self._map(SharedMemoryBuffer(self._name))
            return True
        except FileNotFoundError:
            return False

    # ----------------------------------------------------------------- write

    def save_state_dict(self, state: Any, step: int = 0,
                        extra_meta: Optional[Dict] = None):
        """Stage a tree of tensors into shm.

        Metadata (dtype/shape/nbytes) needs no transfer, so the segment is
        sized up front; then each leaf's bytes are copied into the
        segment and digested, and the header is published last.
        """
        flat = flatten_state_dict(state)
        refs: List[Tuple[str, Any, List[int], List[List[int]]]] = []
        for name, leaf in flat.items():
            refs.extend(_leaf_refs(name, leaf))
        metas: List[TensorMeta] = []
        offset = _HEADER_SIZE
        for ename, ref, gshape, index in refs:
            itemsize = (ref.element_size() if torch.is_tensor(ref)
                        else ref.dtype.itemsize)
            nbytes = int(np.prod(ref.shape)) * itemsize
            metas.append(TensorMeta(
                name=ename, dtype=dtype_name(ref), shape=list(ref.shape),
                offset=offset, nbytes=nbytes, global_shape=gshape,
                index=index))
            offset += nbytes
        extra = dict(extra_meta or {})
        # creator pid: the saver-startup sweeper reaps segments whose
        # creator died (same dead-pid pattern as SharedLock)
        extra.setdefault("_pid", os.getpid())
        with self._lock:
            self._ensure_size(offset)
            buf = self._buf.buf
            # crash-consistency: invalidate the segment first, write payload,
            # publish the header LAST.  A crash mid-staging leaves length=0
            # (reader sees "no checkpoint"), never a header describing
            # partially-written payload — critical now that staging runs in a
            # background drain thread overlapping training.
            buf[0:8] = (0).to_bytes(8, "big")
            for meta, (_, ref, _, _) in zip(metas, refs):
                view = _host_bytes(ref)
                buf[meta.offset:meta.offset + meta.nbytes] = view
                # digest the staged bytes: restore (any tier) refuses to
                # hand a flipped/torn shard to the device; zlib and
                # crc32c take the buffer itself (the JAX module digests a
                # bytes copy: the same value)
                meta.digest = digest_bytes(view)
            header = {
                "step": step,
                "algo": DIGEST_ALGO,
                "metas": [m.to_dict() for m in metas],
                "extra": extra,
            }
            header_bytes = json.dumps(header).encode()
            if len(header_bytes) + _HDR_JSON_OFF > _HEADER_SIZE:
                raise ValueError("checkpoint meta header exceeds 1MB")
            buf[8:12] = digest_bytes(header_bytes).to_bytes(4, "big")
            buf[_HDR_JSON_OFF:_HDR_JSON_OFF + len(header_bytes)] = \
                header_bytes
            buf[0:8] = len(header_bytes).to_bytes(8, "big")

    # ------------------------------------------------------------------ read

    def load_header(self) -> Optional[Dict]:
        if not self.attach():
            return None
        return _parse_header(self._buf.buf)

    def segment_state(self) -> str:
        """"absent" | "empty" | "torn" | "ok" — distinguishes "nothing
        staged" (benign cold start) from a header that is present but
        fails its crc / parse (corruption the restore chain must report).
        """
        if not self.attach():
            return "absent"
        buf = self._buf.buf
        n = int.from_bytes(bytes(buf[0:8]), "big")
        if n == 0:
            return "empty"
        return "ok" if _parse_header(buf) is not None else "torn"

    def load_state_dict(self) -> Optional[Tuple[int, Dict[str, np.ndarray],
                                                List[TensorMeta], Dict]]:
        """Returns (step, {name: np.ndarray}, metas, extra) or None; a
        bfloat16 or float8 leaf is its unsigned integer view."""
        header = self.load_header()
        if header is None:
            return None
        buf = self._buf.buf
        out: Dict[str, np.ndarray] = {}
        metas = [TensorMeta.from_dict(m) for m in header["metas"]]
        for meta in metas:
            raw = np.frombuffer(
                bytes(buf[meta.offset:meta.offset + meta.nbytes]),
                dtype=_np_dtype(meta.dtype))
            out[meta.name] = raw.reshape(meta.shape)
        return header.get("step", 0), out, metas, header.get("extra", {})

    def iter_shards(self):
        """Yield (meta, memoryview) without copying — for the async saver."""
        header = self.load_header()
        if header is None:
            return
        buf = self._buf.buf
        for m in header["metas"]:
            meta = TensorMeta.from_dict(m)
            yield meta, buf[meta.offset:meta.offset + meta.nbytes]

    def verify(self) -> Tuple[bool, str]:
        """Digest-check every staged shard against its header meta.

        (ok, reason) — reason "" on success, "no-segment" when nothing is
        staged.  A legacy segment without digests FAILS (the trust
        boundary does not grandfather undigested bytes)."""
        from .integrity import verify_segment_entries

        loaded = self.load_state_dict()
        if loaded is None:
            return False, "no-segment"
        _, flat, metas, _ = loaded
        header = self.load_header() or {}
        return verify_segment_entries(metas, flat, header.get("algo", ""))

    def restamp_owner(self, pid: int) -> bool:
        """Stamp `pid` as the staged segment's owner (``extra._pid``, the
        creator pid `sweep_stale_segments` reads), publishing the header
        last as staging does.  For a segment written from another host's
        bytes (the replica ring's restore): the stamp it came with names
        a process of that host.  False when nothing is staged."""
        with self._lock:
            if not self.attach():
                return False
            buf = self._buf.buf
            header = _parse_header(buf)
            if header is None:
                return False
            header.setdefault("extra", {})["_pid"] = int(pid)
            header_bytes = json.dumps(header).encode()
            if len(header_bytes) + _HDR_JSON_OFF > _HEADER_SIZE:
                raise ValueError("checkpoint meta header exceeds 1MB")
            buf[0:8] = (0).to_bytes(8, "big")
            buf[8:12] = digest_bytes(header_bytes).to_bytes(4, "big")
            buf[_HDR_JSON_OFF:_HDR_JSON_OFF + len(header_bytes)] = \
                header_bytes
            buf[0:8] = len(header_bytes).to_bytes(8, "big")
            return True

    def mark_empty(self):
        if self._buf is not None:
            self._buf.buf[0:8] = (0).to_bytes(8, "big")

    def close(self):
        with self._lock:
            if self._buf is not None:
                self._buf.close()
                self._buf = None
                self._mapped = None

    def unlink(self):
        with self._lock:
            self._drop_stale()
            if self._buf is None:
                try:
                    self._buf = SharedMemoryBuffer(self._name)
                except FileNotFoundError:
                    return
            self._buf.unlink()
            self._buf.close()
            self._buf = None
            self._mapped = None


# -------------------------------------------------- header / blob helpers


def _parse_header(buf) -> Optional[Dict]:
    """Header json out of a segment buffer/blob; None when empty or torn.

    The 4-byte header crc catches a bit flip in the header region itself —
    without it a flipped byte in a meta's offset/dtype would parse fine
    and misread the payload."""
    if len(buf) < _HDR_JSON_OFF:
        return None
    n = int.from_bytes(bytes(buf[0:8]), "big")
    if n == 0 or n > _HEADER_SIZE - _HDR_JSON_OFF or \
            _HDR_JSON_OFF + n > len(buf):
        return None
    raw = bytes(buf[_HDR_JSON_OFF:_HDR_JSON_OFF + n])
    if digest_bytes(raw) != int.from_bytes(bytes(buf[8:12]), "big"):
        return None
    try:
        return json.loads(raw.decode())
    except ValueError:
        return None


def verify_segment_blob(blob) -> Tuple[Optional[int], str]:
    """Verify a raw segment copy (replica wire blob) WITHOUT touching shm.

    Returns (step, "") when every shard's digest matches its header meta,
    else (None, reason) — the replica restore path checks the pulled blob
    BEFORE overwriting the local segment, so a corrupt peer copy can
    never clobber local state or reach the device.  Each leaf is digested
    through a view of the blob (the JAX helper digests a bytes slice:
    the same value, without the copy)."""
    header = _parse_header(blob)
    if header is None:
        return None, "torn-header"
    if header.get("algo", "") != DIGEST_ALGO:
        return None, "algo-mismatch"
    view = memoryview(blob)
    for m in header.get("metas", []):
        d = m.get("digest", -1)
        if d is None or int(d) < 0:
            return None, f"undigested-leaf:{m.get('name')}"
        end = m["offset"] + m["nbytes"]
        if end > len(blob):
            return None, f"truncated-payload:{m.get('name')}"
        if digest_bytes(view[m["offset"]:end]) != int(d):
            return None, f"leaf-digest-mismatch:{m.get('name')}"
    return header.get("step", 0), ""


def blob_state_dict(blob) -> Optional[Tuple[int, Dict[str, np.ndarray],
                                            Dict]]:
    """Parse a segment blob into (step, {name: np.ndarray}, extra).

    For the hot-swap hydration path: a survivor holds a DEAD rank's
    segment as wire bytes (replica.fetch_peer) and needs its arrays
    without routing them through the local shm segment (which holds the
    survivor's OWN shards).  Callers must verify first
    (verify_segment_blob) — this helper only decodes.  The arrays are
    read-only views of the blob; a bfloat16 or float8 leaf is its
    unsigned integer view, as in `load_state_dict`."""
    header = _parse_header(blob)
    if header is None:
        return None
    out: Dict[str, np.ndarray] = {}
    for m in header.get("metas", []):
        meta = TensorMeta.from_dict(m)
        dtype = _np_dtype(meta.dtype)
        raw = np.frombuffer(blob, dtype=dtype,
                            count=meta.nbytes // dtype.itemsize,
                            offset=meta.offset)
        out[meta.name] = raw.reshape(meta.shape)
    return header.get("step", 0), out, header.get("extra", {})


# ------------------------------------------------- stale-segment sweeper


def sweep_stale_segments(current_job: str) -> List[str]:
    """Reap orphaned ckpt shm segments whose creator pid is dead.

    POSIX shm outlives hard kills: every SIGKILLed drill or crashed run
    leaks its `{job}_ckpt_shm_{rank}` segments until reboot.  On saver
    startup we walk /dev/shm for the framework's naming pattern, read each
    header's creator pid (stamped by save_state_dict), and unlink segments
    whose creator no longer exists — the same dead-pid reap SharedLock
    applies to lock holders (common/multi_process.py).

    Segments of `current_job`, segments with live creators, and segments
    whose header is unreadable (no pid evidence — may be mid-staging by a
    live writer) are left alone.  Returns the reaped names.
    """
    from ..common.multi_process import _pid_alive

    shm_root = _SHM_ROOT
    if not os.path.isdir(shm_root):  # non-Linux: nothing to sweep
        return []
    reaped: List[str] = []
    for name in sorted(os.listdir(shm_root)):
        if "_ckpt_shm_" not in name:
            continue
        if current_job and name.startswith(f"{current_job}_ckpt_shm_"):
            continue
        try:
            seg = SharedMemoryBuffer(name)
        except (FileNotFoundError, OSError):
            continue
        try:
            header = _parse_header(seg.buf)
            pid = (header or {}).get("extra", {}).get("_pid")
            if pid is None or _pid_alive(int(pid)):
                continue
            seg.unlink()
            reaped.append(name)
            logger.warning("reaped stale ckpt shm segment %s "
                           "(creator pid %s is dead)", name, pid)
        except Exception:  # noqa: BLE001 — sweeping must never break startup
            logger.exception("stale-segment sweep failed for %s", name)
        finally:
            try:
                seg.close()
            except Exception:  # noqa: BLE001
                pass
    return reaped
