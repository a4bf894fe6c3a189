"""Transport seam for the host fleet; port of
``raft_tpu/serving/transport.py``, speaking the same wire protocol.

The fleet's remote lanes (serving/hosts.py) never touch a socket or a
pickle directly: every byte that crosses a host boundary goes through ONE
seam, :meth:`Transport.call`, so liveness drills, corruption drills and
the CPU tests all land in one place:

- :class:`LoopbackTransport` runs the worker **in-process** but still
  round-trips every message through the wire encoding (pickle, the
  ``transport.send`` / ``transport.recv`` fault sites). A test drives a
  byte-identical protocol to the real thing without a subprocess:
  corruption in transit, raises and hangs fire where they would on a
  socket.
- :class:`SocketTransport` speaks the same messages over a
  length-prefixed TCP connection to a worker process
  (``python -m raft_tpu_torch.serving.host_worker`` runs
  :func:`serve_forever`). A dead peer (SIGKILL, reset, refused) surfaces
  as :class:`TransportError` on the caller, never a hang past the call
  timeout.

Wire protocol (both directions, the JAX package's): an 8-byte big-endian
length, then ``pickle((method, payload))`` out and ``pickle((status,
payload))`` back, ``status in ("ok", "error")``, pickled with
``pickle.HIGHEST_PROTOCOL``. Payloads are plain picklables: numpy arrays
(u8 or fp32 frames out, fp32 flow back), dicts, bytes; never a tensor, so
either package's client drives either package's worker. One request in
flight per connection: :class:`SocketTransport` serialises callers with a
leaf lock. Unpickling runs code, so a worker serves only the fleet's own
trusted network (``serve_forever`` binds 127.0.0.1 unless told
otherwise).

Fault sites (testing/faults.py): ``transport.send`` fires before a
request leaves (``corrupt`` zero-fills the encoded request: the receiver
sees garbage and the caller gets a clean :class:`TransportError` to
retry), ``transport.recv`` as the reply is decoded (``corrupt`` zero-fills
the reply bytes). ``raise``, ``hang`` and ``crash`` behave as at every
other site.
"""

from __future__ import annotations

import pickle
import socket
import struct
import threading
from typing import Any, Optional

from raft_tpu_torch.testing.faults import fault_data, fault_point

#: both transports own ONE leaf lock serialising calls; nothing is ever
#: acquired while holding it but the blocking socket I/O itself (no
#: callbacks, no scheduler locks: HostFleet and the scheduler call
#: transports with NO lock held). Holding it across the I/O IS the
#: contract (one request in flight per connection).
LOCK_ORDER = (
    ("transport.SocketTransport._lock",),
    ("transport.LoopbackTransport._lock",),
)

GRAFTTHREAD = {
    "locks": ("_lock",),
}

#: graftwire declarations: holding ``_lock`` across the socket I/O is the
#: transport contract (one request in flight per connection), so it is a
#: wire lock, not a W3 finding; ``_send_msg`` and ``_recv_exact`` are the
#: only functions that touch raw socket send/recv, and all framing lives
#: there (W6).
GRAFTWIRE = {
    "wire_locks": ("_lock",),
    "framed_helpers": ("_send_msg", "_recv_exact"),
}

_LEN = struct.Struct(">Q")
#: sanity bound on a single message (a corrupted length prefix must read
#: as a protocol error, not a 2**60-byte allocation)
MAX_MESSAGE_BYTES = 1 << 32


class TransportError(RuntimeError):
    """The transport could not complete a call: peer dead or reset,
    timeout, protocol garbage, or corrupted bytes. Always retryable: the
    call either never reached the worker or its effect is idempotent by
    design (the worker's method contracts in serving/hosts.py)."""


def encode(obj: Any) -> bytes:
    return pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)


def decode(data: bytes) -> Any:
    try:
        return pickle.loads(data)
    except Exception as exc:  # noqa: BLE001 — any garbage, one error
        raise TransportError(
            f"undecodable message ({len(data)} bytes): {exc}") from None


def _send_msg(sock: socket.socket, data: bytes) -> None:
    try:
        sock.sendall(_LEN.pack(len(data)) + data)
    except OSError as exc:
        raise TransportError(f"send failed: {exc}") from None


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        try:
            chunk = sock.recv(min(n - len(buf), 1 << 24))
        except OSError as exc:
            raise TransportError(f"recv failed: {exc}") from None
        if not chunk:
            raise TransportError("peer closed the connection mid-message")
        buf.extend(chunk)
    return bytes(buf)


def _recv_msg(sock: socket.socket) -> bytes:
    (n,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    if n > MAX_MESSAGE_BYTES:
        raise TransportError(
            f"message length {n} exceeds {MAX_MESSAGE_BYTES} "
            "(corrupted length prefix?)")
    return _recv_exact(sock, n)


class LoopbackTransport:
    """In-process transport over a worker OBJECT (anything with
    ``handle(method, payload) -> payload``). Every call still pays the
    full encode/decode round trip and fires both fault sites, so a
    ``transport.send`` corruption reads exactly as it would on a socket:
    the request decodes to garbage and the caller retries."""

    def __init__(self, worker, name: str = "loopback"):
        self._worker = worker
        self.name = name
        self._lock = threading.Lock()
        self._closed = False

    def call(self, method: str, payload: Any = None,
             timeout_s: Optional[float] = None) -> Any:
        with self._lock:
            if self._closed:
                raise TransportError(f"{self.name}: transport closed")
            fault_point("transport.send")
            data = fault_data("transport.send", encode((method, payload)))
            try:
                req_method, req_payload = decode(data)
            except (TransportError, TypeError, ValueError) as exc:
                raise TransportError(
                    f"{self.name}: request corrupted in transit: "
                    f"{exc}") from None
            try:
                reply = ("ok", self._worker.handle(req_method,
                                                   req_payload))
            except Exception as exc:  # noqa: BLE001 — worker-side error
                reply = ("error", f"{type(exc).__name__}: {exc}")
            fault_point("transport.recv")
            rdata = fault_data("transport.recv", encode(reply))
            try:
                status, result = decode(rdata)
            except (TransportError, TypeError, ValueError) as exc:
                raise TransportError(
                    f"{self.name}: reply corrupted in transit: "
                    f"{exc}") from None
            if status != "ok":
                raise TransportError(f"{self.name}: worker error on "
                                     f"{method}: {result}")
            return result

    def close(self) -> None:
        with self._lock:
            self._closed = True

    def reopen(self) -> "LoopbackTransport":
        """Fresh transport to the SAME worker object (the reconnect probe
        after a dead verdict poisoned this one)."""
        return LoopbackTransport(self._worker, name=self.name)

    @property
    def closed(self) -> bool:
        return self._closed


class SocketTransport:
    """Length-prefixed pickle RPC over TCP to a worker process.
    Lazy-connecting (a closed or killed peer surfaces on the next call),
    and :meth:`close` from ANOTHER thread poisons an in-flight recv: the
    dead-host verdict's way of unsticking a lane blocked on a zombie's
    socket."""

    def __init__(self, host: str, port: int, *,
                 connect_timeout_s: float = 5.0,
                 call_timeout_s: Optional[float] = 60.0,
                 name: Optional[str] = None):
        self.host = host
        self.port = int(port)
        self.connect_timeout_s = float(connect_timeout_s)
        self.call_timeout_s = call_timeout_s
        self.name = name or f"{host}:{port}"
        self._lock = threading.Lock()
        self._sock: Optional[socket.socket] = None
        self._closed = False

    def _connect(self) -> socket.socket:
        if self._sock is None:
            try:
                self._sock = socket.create_connection(
                    (self.host, self.port),
                    timeout=self.connect_timeout_s)
            except OSError as exc:
                raise TransportError(
                    f"{self.name}: connect failed: {exc}") from None
        return self._sock

    def call(self, method: str, payload: Any = None,
             timeout_s: Optional[float] = None) -> Any:
        with self._lock:
            if self._closed:
                raise TransportError(f"{self.name}: transport closed")
            fault_point("transport.send")
            data = fault_data("transport.send", encode((method, payload)))
            sock = self._connect()
            sock.settimeout(timeout_s if timeout_s is not None
                            else self.call_timeout_s)
            try:
                _send_msg(sock, data)
                rdata = _recv_msg(sock)
            except TransportError:
                # a failed exchange leaves the stream unframed: drop the
                # connection so the NEXT call starts clean instead of
                # reading a stale half-message
                self._drop()
                raise
            fault_point("transport.recv")
            rdata = fault_data("transport.recv", rdata)
            status, result = decode(rdata)
            if status != "ok":
                raise TransportError(f"{self.name}: worker error on "
                                     f"{method}: {result}")
            return result

    def _drop(self) -> None:
        sock, self._sock = self._sock, None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    def close(self) -> None:
        # deliberately NOT under _lock: close() is how the dead-host
        # verdict unsticks a caller blocked inside call()'s recv — the
        # socket close makes that recv raise, the caller drops the
        # connection and surfaces TransportError
        self._closed = True
        sock = self._sock
        if sock is not None:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass

    def reopen(self) -> "SocketTransport":
        """Fresh transport to the same endpoint (the reconnect probe after
        a dead verdict: the worker may have restarted on the same port,
        or the partition healed)."""
        return SocketTransport(
            self.host, self.port,
            connect_timeout_s=self.connect_timeout_s,
            call_timeout_s=self.call_timeout_s, name=self.name)

    @property
    def closed(self) -> bool:
        return self._closed


def serve_connection(conn: socket.socket, worker) -> None:
    """One connection's server loop (the worker side of
    :class:`SocketTransport`): decode a request, dispatch to
    ``worker.handle``, encode the reply; returns when the peer closes."""
    while True:
        try:
            data = _recv_msg(conn)
        except TransportError:
            return   # peer gone / stream garbage: this connection ends
        try:
            method, payload = decode(data)
            reply = ("ok", worker.handle(method, payload))
        except Exception as exc:  # noqa: BLE001 — reply, don't die
            reply = ("error", f"{type(exc).__name__}: {exc}")
        try:
            _send_msg(conn, encode(reply))
        except TransportError:
            return


def serve_forever(port: int, worker, *, host: str = "127.0.0.1",
                  ready_fh=None) -> None:
    """Blocking single-threaded worker server: accept one connection at a
    time and run :func:`serve_connection` on it. Writes ``PORT <n>`` to
    ``ready_fh`` (stdout, for the parent to read) once bound; ``port=0``
    binds an ephemeral one."""
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((host, port))
    srv.listen(4)
    if ready_fh is not None:
        ready_fh.write(f"PORT {srv.getsockname()[1]}\n")
        ready_fh.flush()
    while True:
        conn, _ = srv.accept()
        try:
            serve_connection(conn, worker)
        finally:
            try:
                conn.close()
            except OSError:
                pass
