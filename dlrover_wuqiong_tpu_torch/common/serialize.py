"""Typed message serialization.

Parity: a copy of dlrover_wuqiong_tpu/common/serialize.py (stdlib only),
kept in the port because the port imports nothing of the JAX package.
Messages are dataclasses registered by name and encoded as JSON; a frame
the port writes is byte-equal to the JAX package's for the same message
(tests/test_torch_serving_worker.py holds them equal).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Type

_MESSAGE_REGISTRY: Dict[str, Type] = {}


def message(cls):
    """Class decorator: make a dataclass a wire-serializable message."""
    cls = dataclasses.dataclass(cls)
    _MESSAGE_REGISTRY[cls.__name__] = cls
    return cls


def _encode_value(v: Any) -> Any:
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return {
            "__msg__": type(v).__name__,
            "fields": {
                f.name: _encode_value(getattr(v, f.name))
                for f in dataclasses.fields(v)
            },
        }
    if isinstance(v, dict):
        return {str(k): _encode_value(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_encode_value(x) for x in v]
    if isinstance(v, bytes):
        return {"__bytes__": v.hex()}
    return v


def _decode_value(v: Any) -> Any:
    if isinstance(v, dict):
        if "__msg__" in v:
            cls = _MESSAGE_REGISTRY.get(v["__msg__"])
            if cls is None:
                raise ValueError(f"unknown message type {v['__msg__']}")
            kwargs = {k: _decode_value(x) for k, x in v.get("fields", {}).items()}
            known = {f.name for f in dataclasses.fields(cls)}
            return cls(**{k: x for k, x in kwargs.items() if k in known})
        if "__bytes__" in v:
            return bytes.fromhex(v["__bytes__"])
        return {k: _decode_value(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_decode_value(x) for x in v]
    return v


def dumps(obj: Any) -> bytes:
    return json.dumps(_encode_value(obj), separators=(",", ":")).encode("utf-8")


def loads(data: bytes) -> Any:
    return _decode_value(json.loads(data.decode("utf-8")))
