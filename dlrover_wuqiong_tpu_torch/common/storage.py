"""Checkpoint storage abstraction with a class registry.

Parity: a copy of dlrover_wuqiong_tpu/common/storage.py (stdlib only)
without `ObjectStoreStorage`, which needs ``etils``: `CheckpointStorage`,
`PosixDiskStorage`, `register_storage` and `get_checkpoint_storage`.  An
object-store path (``gs://``, ``s3://``, ``az://``) raises
`NotImplementedError` until ROADMAP item 6c brings that backend.
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


_STORAGE_REGISTRY: Dict[str, Type[CheckpointStorage]] = {
    "PosixDiskStorage": PosixDiskStorage,
}

_OBJECT_SCHEMES = ("gs://", "s3://", "az://")


def register_storage(cls: Type[CheckpointStorage]):
    _STORAGE_REGISTRY[cls.__name__] = cls
    return cls


def get_checkpoint_storage(meta: Optional[Dict] = None,
                           path_hint: str = "") -> CheckpointStorage:
    """Resolve a backend — by explicit meta, or by the target path's scheme
    (an object-store path raises until its backend is ported)."""
    if not meta:
        if path_hint.startswith(_OBJECT_SCHEMES):
            raise NotImplementedError(
                f"{path_hint!r}: object-store checkpoint storage is not "
                "ported yet (ROADMAP queue 1 item 6c); use a POSIX path")
        return PosixDiskStorage()
    cls = _STORAGE_REGISTRY.get(meta.get("class_name", "PosixDiskStorage"),
                                PosixDiskStorage)
    return cls(**meta.get("kwargs", {}))
