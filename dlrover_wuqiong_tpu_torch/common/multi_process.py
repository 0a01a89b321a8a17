"""Local IPC primitives shared between the async saver and training processes.

Parity: a copy of dlrover_wuqiong_tpu/common/multi_process.py (stdlib
only) without `SharedDict`, which nothing of the port reads: a
unix-domain-socket server per named resource (`LocalSocketComm`,
`SharedLock` with its dead-pid reap, `SharedQueue`), and POSIX shared
memory for tensor staging (`SharedMemoryBuffer`).  Socket names and
``DWT_SOCKET_DIR`` stay the same, so a port process and a JAX process that
share a job name share its resources: give each job its own name.
Used by the flash checkpoint (checkpoint/): training processes write
tensor bytes into shm and enqueue events for the async saver.
"""

from __future__ import annotations

import json
import os
import queue
import socket
import socketserver
import struct
import threading
import time
from multiprocessing import resource_tracker, shared_memory
from typing import Any, Dict, Optional

from .log import get_logger

logger = get_logger("multi_process")

SOCKET_DIR = os.getenv("DWT_SOCKET_DIR", "/tmp/dwt/sockets")

_LEN = struct.Struct(">I")


def _socket_path(name: str) -> str:
    os.makedirs(SOCKET_DIR, exist_ok=True)
    return os.path.join(SOCKET_DIR, f"{name}.sock")


def _send(sock: socket.socket, obj: Any):
    data = json.dumps(obj).encode()
    sock.sendall(_LEN.pack(len(data)) + data)


def _recv(sock: socket.socket) -> Any:
    hdr = b""
    while len(hdr) < 4:
        chunk = sock.recv(4 - len(hdr))
        if not chunk:
            raise ConnectionError("closed")
        hdr += chunk
    (n,) = _LEN.unpack(hdr)
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("closed")
        buf += chunk
    return json.loads(buf.decode())


class LocalSocketComm:
    """A named resource reachable over a unix socket.

    The creating process (``master=True``) runs a server thread answering
    requests; other processes connect as clients.  Subclasses implement
    ``_handle(request) -> response``.
    """

    def __init__(self, name: str, master: bool = False):
        self._name = name
        self._path = _socket_path(name)
        self._master = master
        self._server = None
        self._client_lock = threading.Lock()
        self._client_sock: Optional[socket.socket] = None
        if master:
            self._start_server()

    # ------------------------------------------------------------------ server

    def _start_server(self):
        if os.path.exists(self._path):
            os.unlink(self._path)
        outer = self

        class _Handler(socketserver.BaseRequestHandler):
            def handle(self):
                while True:
                    try:
                        req = _recv(self.request)
                    except (ConnectionError, OSError):
                        return
                    try:
                        resp = outer._handle(req)
                    except Exception as e:  # noqa: BLE001
                        resp = {"err": f"{type(e).__name__}: {e}"}
                    try:
                        _send(self.request, resp)
                    except OSError:
                        return

        class _Server(socketserver.ThreadingUnixStreamServer):
            daemon_threads = True

        self._server = _Server(self._path, _Handler)
        t = threading.Thread(target=self._server.serve_forever, daemon=True,
                             name=f"dwt-ipc-{self._name}")
        t.start()

    def close(self):
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
            if os.path.exists(self._path):
                os.unlink(self._path)
        with self._client_lock:
            if self._client_sock is not None:
                self._client_sock.close()
                self._client_sock = None

    def _handle(self, request: Dict) -> Dict:
        raise NotImplementedError

    # ------------------------------------------------------------------ client

    class _DialBudgetExceeded(Exception):
        """Could not even CONNECT within the caller's dial budget."""

    def _request(self, req: Dict, timeout: float = 60.0,
                 dial_timeout: Optional[float] = None) -> Dict:
        """`timeout` bounds the whole exchange; `dial_timeout` (<= timeout)
        separately bounds the CONNECT phase — a socket path that never
        answers means the resource master does not exist, and callers with
        their own fallback (lock-free staging copy, replica backup) must
        not wait out the full exchange budget to learn that."""
        if self._master:
            return self._handle(req)
        from .util import retry_call

        start = time.monotonic()

        def attempt() -> Dict:
            # raw dial sanctioned here because the whole attempt runs
            # under retry_call (graftlint raw-rpc-call)
            if self._client_sock is None:
                if dial_timeout is not None and \
                        time.monotonic() - start > dial_timeout:
                    raise LocalSocketComm._DialBudgetExceeded()
                self._client_sock = socket.socket(socket.AF_UNIX,
                                                  socket.SOCK_STREAM)
                self._client_sock.connect(self._path)
            _send(self._client_sock, req)
            resp = _recv(self._client_sock)
            if "err" in resp:
                raise RuntimeError(resp["err"])
            return resp

        def drop_sock(_n, _exc, _delay):
            if self._client_sock is not None:
                self._client_sock.close()
                self._client_sock = None

        with self._client_lock:
            try:
                # flat 0.1s cadence preserved (jitterless, max=base): the
                # master side comes up once and stays — backoff would only
                # delay the first contact
                return retry_call(
                    attempt, attempts=None, deadline_s=timeout,
                    base_delay_s=0.1, max_delay_s=0.1, jitter=0.0,
                    retry_on=(ConnectionError, FileNotFoundError, OSError),
                    on_retry=drop_sock)
            except (LocalSocketComm._DialBudgetExceeded, ConnectionError,
                    FileNotFoundError, OSError) as e:
                drop_sock(0, e, 0.0)
                raise TimeoutError(
                    f"IPC resource {self._name} unreachable") from e


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except (PermissionError, OSError):
        pass
    return True


class SharedLock(LocalSocketComm):
    """Cross-process lock. Parity: reference SharedLock (multi_process.py:225).

    Unlike the reference, the holder's PID is tracked and a waiter reaps
    the lock when the holder process no longer exists: a worker SIGKILLed
    mid-critical-section (shm staging, elastic_agent relaunch flow) must
    not wedge the NEXT worker generation for the full acquire timeout —
    the lock, like the shm segments and sockets around it, outlives hard
    kills."""

    def __init__(self, name: str, master: bool = False):
        self._lock = threading.Lock() if master else None
        self._meta = threading.Lock() if master else None
        self._holder_pid: Optional[int] = None
        super().__init__(f"lock-{name}", master)

    def _try_acquire(self, pid: int) -> bool:
        with self._meta:
            if self._lock.acquire(blocking=False):
                self._holder_pid = pid
                return True
            holder = self._holder_pid
            if holder is not None and not _pid_alive(holder):
                logger.warning(
                    "lock %s: holder pid %d is dead — reaping", self._name,
                    holder)
                try:
                    self._lock.release()
                except RuntimeError:
                    pass
                self._lock.acquire(blocking=False)
                self._holder_pid = pid
                return True
            return False

    def _handle(self, request):
        op = request["op"]
        if op == "acquire":
            pid = int(request.get("pid", 0))
            if not request.get("blocking", True):
                return {"ok": self._try_acquire(pid)}
            timeout = request.get("timeout", -1)
            deadline = (time.monotonic() + timeout) if timeout and timeout > 0 \
                else None
            # poll instead of a blocking Lock.acquire so a holder that
            # dies WHILE we wait is noticed within one poll interval
            while True:
                if self._try_acquire(pid):
                    return {"ok": True}
                if deadline is not None and time.monotonic() >= deadline:
                    return {"ok": False}
                time.sleep(0.05)
        if op == "release":
            with self._meta:
                try:
                    self._lock.release()
                except RuntimeError:
                    pass
                self._holder_pid = None
            return {"ok": True}
        if op == "locked":
            return {"ok": self._lock.locked()}
        raise ValueError(op)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        # client timeout must outlast the server's poll loop, not cut the
        # socket mid-wait (the server would keep polling for a vanished
        # waiter and hand it a lock nobody releases) — but the CONNECT
        # phase is bounded by the caller's own timeout: when the lock
        # master does not exist at all, the caller learns it within its
        # budget instead of the 60s rpc floor
        rpc_timeout = max(60.0, timeout + 30.0) if timeout and timeout > 0 \
            else 7 * 24 * 3600.0
        dial = max(0.2, timeout) if timeout and timeout > 0 else None
        return self._request({"op": "acquire", "blocking": blocking,
                              "timeout": timeout, "pid": os.getpid()},
                             timeout=rpc_timeout, dial_timeout=dial)["ok"]

    def release(self):
        self._request({"op": "release"})

    def locked(self) -> bool:
        return self._request({"op": "locked"})["ok"]


class SharedQueue(LocalSocketComm):
    """Cross-process FIFO queue. Parity: reference SharedQueue (:346)."""

    def __init__(self, name: str, master: bool = False, maxsize: int = 0):
        self._queue = queue.Queue(maxsize) if master else None
        super().__init__(f"queue-{name}", master)

    def _handle(self, request):
        op = request["op"]
        if op == "put":
            self._queue.put(request["item"])
            return {"ok": True}
        if op == "get":
            try:
                item = self._queue.get(
                    block=request.get("block", True),
                    timeout=request.get("timeout"))
                return {"ok": True, "item": item}
            except queue.Empty:
                return {"ok": False, "item": None}
        if op == "qsize":
            return {"ok": True, "n": self._queue.qsize()}
        if op == "empty":
            return {"ok": True, "n": int(self._queue.empty())}
        raise ValueError(op)

    def put(self, item: Any):
        self._request({"op": "put", "item": item})

    def get(self, block: bool = True, timeout: Optional[float] = None) -> Any:
        wait = timeout if timeout is not None else 3600.0
        resp = self._request({"op": "get", "block": block, "timeout": timeout},
                             timeout=wait + 60.0)
        if not resp["ok"]:
            raise queue.Empty
        return resp["item"]

    def qsize(self) -> int:
        return self._request({"op": "qsize"})["n"]

    def empty(self) -> bool:
        return bool(self._request({"op": "empty"})["n"])


class SharedMemoryBuffer:
    """POSIX shared-memory segment wrapper.

    Parity: reference's SharedMemory (unregistered from the resource tracker so a
    training-process exit doesn't tear down the agent's segment).
    """

    def __init__(self, name: str, create: bool = False, size: int = 0):
        self.name = name
        if create:
            try:
                existing = shared_memory.SharedMemory(name=name)
            except FileNotFoundError:
                existing = None
            if existing is not None:
                if existing.size >= size:
                    self._shm = existing
                    self._created = False
                    self._unregister()
                    return
                existing.close()
                existing.unlink()
            self._shm = shared_memory.SharedMemory(name=name, create=True,
                                                   size=size)
            self._created = True
        else:
            self._shm = shared_memory.SharedMemory(name=name)
            self._created = False
        self._unregister()

    def _unregister(self):
        # Keep the segment alive independent of any single process's exit.
        try:
            resource_tracker.unregister(self._shm._name, "shared_memory")
        except Exception:  # noqa: BLE001 — best-effort; impl detail of CPython
            pass

    @property
    def buf(self) -> memoryview:
        return self._shm.buf

    @property
    def size(self) -> int:
        return self._shm.size

    def close(self):
        self._shm.close()

    def unlink(self):
        # CPython 3.12's SharedMemory.unlink() unconditionally UNregisters
        # the segment from the resource tracker — but __init__ already
        # unregistered it (by design, see _unregister), so the tracker
        # process would log a KeyError traceback.  Re-register first so the
        # pair balances.
        try:
            resource_tracker.register(self._shm._name, "shared_memory")
        except Exception:  # noqa: BLE001 — impl detail of CPython
            pass
        try:
            self._shm.unlink()
        except FileNotFoundError:
            # already unlinked by a peer: CPython skipped ITS unregister,
            # so balance the register above or the tracker warns at exit
            try:
                resource_tracker.unregister(self._shm._name, "shared_memory")
            except Exception:  # noqa: BLE001
                pass
