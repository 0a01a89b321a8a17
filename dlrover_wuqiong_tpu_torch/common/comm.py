"""Framed-message TCP RPC used for the agent↔master control plane.

Parity: a copy of dlrover_wuqiong_tpu/common/comm.py (stdlib only), kept
in the port because the port imports nothing of the JAX package.  The same
bytes go on the wire, so a JAX client talks to the port's master and the
port's client to a JAX master (tests/test_torch_serving_worker.py).  The
transport is a length-prefixed JSON protocol over TCP — dependency-free,
testable in-process, and the payloads are the typed messages from
`messages.py`.  A port master on a journal bumps its epoch at each
restart, and a promoted standby serves the epoch above (master/journal.py,
master/standby.py); a master without one serves epoch 1 for its whole
life and replays idem keys from memory.

Master fault tolerance rides in the envelope:

- every response carries the master's **fencing epoch** (bumped each time a
  master restarts on its journal, master/journal.py) — clients watch it and
  re-register / re-sync when a new master takes over instead of trusting a
  stale world;
- mutating requests may carry an **idempotency key** (``idem``) so a retry
  that crosses a master restart is applied at most once (the servicer's
  journaled idem cache returns the recorded response for a replay);
- all socket IO retries through the repo-wide ``retry_call``
  (common/util.py) with exponential backoff + reconnect; exhaustion raises
  ``MasterUnreachableError`` so callers can tell "master answered with an
  error" (RpcError — never retried) from "master is gone" (degraded mode).

Distributed tracing rides the same envelope (telemetry/spans.py): a
client call opens an ``rpc:<verb>`` span and stamps its context into the
optional ``trace`` field; the servicer side adopts it and opens
``serve:<verb>`` under the caller's span, so one restore or re-mesh
reconstructs as a single trace tree across agent/master/saver processes.
Untraced peers (fakes, old frames) simply omit the field.

Wire format per frame: 4-byte big-endian length + JSON body
  request:  {"verb": "get"|"report", "node_id": int, "node_type": str,
             "payload": <encoded message>, "idem": str?,
             "trace": {"trace_id": str, "span_id": str}?}
  response: {"ok": bool, "error": str, "payload": <encoded message|null>,
             "epoch": int|null}
"""

from __future__ import annotations

import inspect
import socket
import socketserver
import struct
import threading
from typing import Any, Callable, Optional

from ..telemetry import spans as tspans
from . import serialize
from .log import get_logger
from .util import retry_call

logger = get_logger("comm")

_LEN = struct.Struct(">I")
MAX_FRAME = 512 * 1024 * 1024

#: exception classes that mean "the bytes did not make it" — safe to retry
#: (ValueError covers a torn frame: a length prefix read off a half-closed
#: stream)
TRANSPORT_ERRORS = (OSError, ConnectionError, ValueError)


def _send_frame(sock: socket.socket, data: bytes):
    sock.sendall(_LEN.pack(len(data)) + data)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed connection")
        buf.extend(chunk)
    return bytes(buf)


def _recv_frame(sock: socket.socket) -> bytes:
    (length,) = _LEN.unpack(_recv_exact(sock, 4))
    if length > MAX_FRAME:
        raise ValueError(f"frame too large: {length}")
    return _recv_exact(sock, length)


def find_free_port(host: str = "127.0.0.1") -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind((host, 0))
        return s.getsockname()[1]


def addr_connectable(addr: str, timeout: float = 1.0) -> bool:
    """Reference `elastic_run.py:326 _check_to_use_dlrover_run` telnet probe.

    ``addr`` may be an ordered endpoint list ("primary,standby" — the
    warm-standby HA form MasterClient dials): connectable when ANY
    endpoint answers, since the client's failover rotation reaches it.
    """
    for one in addr.split(","):
        one = one.strip()
        if not one:
            continue
        try:
            host, port = one.rsplit(":", 1)
            with socket.create_connection((host, int(port)),
                                          timeout=timeout):
                return True
        except OSError:
            continue
    return False


class RpcServer:
    """Threaded RPC server dispatching to a handler.

    handler(verb: str, node_id: int, node_type: str, payload) -> response
    message.  A handler whose signature also accepts an ``idem`` keyword
    (MasterServicer.handle) receives the request's idempotency key; plain
    4-arg handlers (tests, fakes) keep working unchanged.

    `epoch_provider` (callable -> int) stamps the master's fencing epoch
    into every response envelope; None leaves the field null (fakes).
    """

    def __init__(self, handler: Callable, host: str = "0.0.0.0",
                 port: int = 0,
                 epoch_provider: Optional[Callable[[], int]] = None):
        self._handler = handler
        self._epoch_provider = epoch_provider
        try:
            params = inspect.signature(handler).parameters
            self._pass_idem = "idem" in params or any(
                p.kind == inspect.Parameter.VAR_KEYWORD
                for p in params.values())
        except (TypeError, ValueError):  # builtins / odd callables
            self._pass_idem = False

        outer = self

        class _Handler(socketserver.BaseRequestHandler):
            def handle(self):
                sock = self.request
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                while True:
                    try:
                        frame = _recv_frame(sock)
                    except (ConnectionError, OSError):
                        return
                    epoch = None
                    if outer._epoch_provider is not None:
                        try:
                            epoch = outer._epoch_provider()
                        except Exception:  # noqa: BLE001 — advisory field
                            epoch = None
                    try:
                        req = serialize.loads(frame)
                        args = (req.get("verb", "get"),
                                req.get("node_id", -1),
                                req.get("node_type", ""),
                                req.get("payload"))
                        payload_name = type(req.get("payload")).__name__
                        # adopt the caller's trace so serve:<verb> nests
                        # under the client's rpc:<verb> span
                        with tspans.extract(req.get("trace")), \
                                tspans.span(
                                    f"serve:{req.get('verb', 'get')}",
                                    {"node_id": req.get("node_id", -1),
                                     "msg": payload_name}):
                            if outer._pass_idem:
                                resp = outer._handler(
                                    *args, idem=req.get("idem"))
                            else:
                                resp = outer._handler(*args)
                        body = serialize.dumps(
                            {"ok": True, "error": "", "payload": resp,
                             "epoch": epoch}
                        )
                    except Exception as e:  # noqa: BLE001 — report to caller
                        logger.exception("rpc handler error")
                        body = serialize.dumps(
                            {"ok": False, "error": f"{type(e).__name__}: {e}",
                             "payload": None, "epoch": epoch}
                        )
                    try:
                        _send_frame(sock, body)
                    except OSError:
                        return

        class _Server(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._server = _Server((host, port), _Handler)
        self.port = self._server.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self):
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True, name="dwt-rpc-server"
        )
        self._thread.start()
        logger.info("RPC server listening on port %s", self.port)

    def stop(self):
        self._server.shutdown()
        self._server.server_close()


class RpcError(RuntimeError):
    """The master ANSWERED with an error — never retried blindly."""


class MasterUnreachableError(RpcError):
    """The retry budget ran out without a response frame making it back.

    Subclasses RpcError so legacy `except RpcError` sites still catch it;
    the distinct type is what the MasterClient's degraded mode keys on
    (buffer the message, keep training) vs a real handler error (raise)."""


class RpcClient:
    """Persistent-connection client; every call retries through retry_call.

    Parity: reference `elastic_agent/master_client.py` retry decorator
    semantics (`retry_grpc_request`), extended with the fencing-epoch watch:
    the first response from a RESTARTED master carries a higher epoch, and
    `on_epoch_change(old, new)` fires exactly once per bump (outside the
    socket lock, re-entrant calls suppressed) so the MasterClient can
    re-register and re-sync in-flight state.
    """

    def __init__(self, addr: str, node_id: int = -1, node_type: str = "worker",
                 timeout: float = 30.0, retries: int = 3,
                 base_delay_s: float = 0.1, max_delay_s: float = 2.0):
        self._addr = addr
        self._node_id = node_id
        self._node_type = node_type
        self._timeout = timeout
        self._retries = retries
        self._base_delay_s = base_delay_s
        self._max_delay_s = max_delay_s
        self._sock: Optional[socket.socket] = None
        self._lock = threading.Lock()
        # fencing epoch bookkeeping
        self.epoch: Optional[int] = None
        self.on_epoch_change: Optional[Callable[[int, int], None]] = None
        self._epoch_lock = threading.Lock()
        self._notifying = False

    def _connect(self):
        host, port = self._addr.rsplit(":", 1)
        sock = socket.create_connection((host, int(port)), timeout=self._timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = sock

    def close(self):
        with self._lock:
            self._close_locked()

    def _close_locked(self):
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None

    def _attempt(self, req: bytes) -> Any:
        with self._lock:
            if self._sock is None:
                self._connect()
            try:
                _send_frame(self._sock, req)
                body = _recv_frame(self._sock)
            except TRANSPORT_ERRORS:
                # half-open / mid-frame death poisons the stream — drop it
                # so the retry re-dials instead of reading a stale tail
                self._close_locked()
                raise
        return serialize.loads(body)

    def _call(self, verb: str, payload: Any, idem: Optional[str] = None,
              attempts: Optional[int] = None,
              deadline_s: Optional[float] = None) -> Any:
        with tspans.span(f"rpc:{verb}",
                         {"msg": type(payload).__name__,
                          "node_id": self._node_id}):
            envelope = {"verb": verb, "node_id": self._node_id,
                        "node_type": self._node_type, "payload": payload}
            trace = tspans.inject()
            if trace is not None:
                envelope["trace"] = trace
            if idem is not None:
                envelope["idem"] = idem
            req = serialize.dumps(envelope)
            if attempts is None and deadline_s is None:
                attempts = self._retries
            try:
                resp = retry_call(
                    lambda: self._attempt(req),
                    attempts=attempts, deadline_s=deadline_s,
                    base_delay_s=self._base_delay_s,
                    max_delay_s=self._max_delay_s,
                    retry_on=TRANSPORT_ERRORS, label=verb)
            except TRANSPORT_ERRORS as e:
                raise MasterUnreachableError(
                    f"rpc {verb} to {self._addr} failed after retries: "
                    f"{type(e).__name__}: {e}") from e
        self._observe_epoch(resp.get("epoch"))
        if not resp.get("ok"):
            raise RpcError(resp.get("error", "unknown rpc error"))
        return resp.get("payload")

    def _observe_epoch(self, new: Optional[int]):
        if new is None:
            return
        fire = None
        with self._epoch_lock:
            old = self.epoch
            self.epoch = new
            if old is not None and new != old and not self._notifying \
                    and self.on_epoch_change is not None:
                fire = (old, new)
                self._notifying = True
        if fire is None:
            return
        try:
            self.on_epoch_change(*fire)
        except Exception:  # noqa: BLE001 — resync is best-effort
            logger.exception("epoch-change callback failed")
        finally:
            with self._epoch_lock:
                self._notifying = False

    def get(self, payload: Any, **kw) -> Any:
        return self._call("get", payload, **kw)

    def report(self, payload: Any, **kw) -> Any:
        return self._call("report", payload, **kw)
