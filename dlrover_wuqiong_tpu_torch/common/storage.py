"""Checkpoint storage abstraction with a class registry.

Parity: a copy of dlrover_wuqiong_tpu/common/storage.py: `CheckpointStorage`,
`PosixDiskStorage`, `ObjectStoreStorage`, `register_storage` and
`get_checkpoint_storage`.  An object-store path (``gs://``, ``s3://``,
``az://``) resolves to `ObjectStoreStorage`, which imports ``etils.epath``
when it is built: on a host without ``etils`` that raises the
`ImportError` there, as in the JAX package.
"""

from __future__ import annotations

import os
import shutil
import threading
from abc import ABC, abstractmethod
from typing import Dict, Optional, Type


class CheckpointStorage(ABC):
    """Byte/file-level storage interface used by the async checkpoint saver."""

    @abstractmethod
    def write(self, content, path: str):  # bytes or str
        ...

    @abstractmethod
    def read(self, path: str, mode: str = "rb"):
        ...

    @abstractmethod
    def safe_makedirs(self, path: str):
        ...

    @abstractmethod
    def safe_remove(self, path: str):
        ...

    @abstractmethod
    def exists(self, path: str) -> bool:
        ...

    @abstractmethod
    def listdir(self, path: str):
        ...

    def commit(self, step: int, success: bool):
        """Hook called after all shards of a step have been persisted."""

    def get_class_meta(self) -> Dict:
        return {"class_name": type(self).__name__, "kwargs": {}}


class PosixDiskStorage(CheckpointStorage):
    """Local disk / NFS-mounted POSIX storage."""

    def __init__(self, **kwargs):
        self._lock = threading.Lock()

    def write(self, content, path: str):
        mode = "wb" if isinstance(content, (bytes, bytearray, memoryview)) else "w"
        tmp = f"{path}.tmp.{os.getpid()}"
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(tmp, mode) as f:
            f.write(content)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def write_fileobj(self, fileobj, path: str, length: int):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            remaining = length
            while remaining > 0:
                chunk = fileobj.read(min(remaining, 64 << 20))
                if not chunk:
                    break
                f.write(chunk)
                remaining -= len(chunk)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def read(self, path: str, mode: str = "rb"):
        if not os.path.exists(path):
            return None
        with open(path, mode) as f:
            return f.read()

    def safe_makedirs(self, path: str):
        os.makedirs(path, exist_ok=True)

    def safe_remove(self, path: str):
        if os.path.isdir(path):
            shutil.rmtree(path, ignore_errors=True)
        elif os.path.exists(path):
            try:
                os.remove(path)
            except OSError:
                pass

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def listdir(self, path: str):
        if not os.path.isdir(path):
            return []
        return sorted(os.listdir(path))


class ObjectStoreStorage(CheckpointStorage):
    """Cloud object-store backend (gs:// / s3://) via `etils.epath`.

    A multi-host TPU job's checkpoints live in GCS, not on local disk —
    this backend gives the flash-ckpt saver the same interface there.
    epath routes to the appropriate filesystem implementation; hosts
    without the cloud filesystem deps fail at use-time with the
    underlying error (the posix paths keep working through epath too).
    """

    def __init__(self, **kwargs):
        from etils import epath  # lazy: a host without etils fails here

        self._epath = epath

    def _p(self, path: str):
        return self._epath.Path(path)

    def write(self, content, path: str):
        """Atomic publish on every backend: object stores already commit
        whole objects atomically, but epath on a POSIX path writes in
        place — a crash mid-write would leave a torn file where the
        checkpoint trust boundary expects manifests/trackers to be
        whole-or-absent.  Write a sibling tmp then rename."""
        p = self._p(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        tmp = self._p(f"{path}.tmp.{os.getpid()}")
        if isinstance(content, str):
            tmp.write_text(content)
        else:
            tmp.write_bytes(bytes(content))
        try:
            tmp.rename(p)
        except OSError:
            # backends whose rename cannot replace: fall back to the
            # object store's own atomic whole-object write
            if isinstance(content, str):
                p.write_text(content)
            else:
                p.write_bytes(bytes(content))
            try:
                tmp.unlink()
            except OSError:
                pass

    def write_fileobj(self, fileobj, path: str, length: int):
        p = self._p(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        with p.open("wb") as f:
            remaining = length
            while remaining > 0:
                chunk = fileobj.read(min(1 << 20, remaining))
                if not chunk:
                    break
                f.write(chunk)
                remaining -= len(chunk)

    def read(self, path: str, mode: str = "rb"):
        p = self._p(path)
        try:
            return p.read_text() if "b" not in mode else p.read_bytes()
        except (FileNotFoundError, OSError):
            return None

    def safe_makedirs(self, path: str):
        self._p(path).mkdir(parents=True, exist_ok=True)

    def safe_remove(self, path: str):
        p = self._p(path)
        try:
            if p.is_dir():
                p.rmtree()
            elif p.exists():
                p.unlink()
        except OSError:
            pass

    def exists(self, path: str) -> bool:
        return self._p(path).exists()

    def listdir(self, path: str):
        p = self._p(path)
        if not p.exists():
            return []
        try:
            return sorted(c.name for c in p.iterdir())
        except (NotADirectoryError, OSError):
            return []

    def commit(self, step: int, success: bool):
        pass

    def get_class_meta(self) -> Dict:
        return {"class_name": type(self).__name__, "kwargs": {}}


_STORAGE_REGISTRY: Dict[str, Type[CheckpointStorage]] = {
    "PosixDiskStorage": PosixDiskStorage,
    "ObjectStoreStorage": ObjectStoreStorage,
}

_OBJECT_SCHEMES = ("gs://", "s3://", "az://")


def register_storage(cls: Type[CheckpointStorage]):
    _STORAGE_REGISTRY[cls.__name__] = cls
    return cls


def get_checkpoint_storage(meta: Optional[Dict] = None,
                           path_hint: str = "") -> CheckpointStorage:
    """Resolve a backend — by explicit meta, or by the target path's scheme
    (gs://... → object store)."""
    if not meta:
        if path_hint.startswith(_OBJECT_SCHEMES):
            return ObjectStoreStorage()
        return PosixDiskStorage()
    cls = _STORAGE_REGISTRY.get(meta.get("class_name", "PosixDiskStorage"),
                                PosixDiskStorage)
    return cls(**meta.get("kwargs", {}))
