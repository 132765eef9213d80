"""Supervised TCP transport: the sealed-envelope data plane gets a wire;
port of ``byteps_tpu/comm/transport.py``.

Without it every parameter-server byte travels an in-process loopback:
``ServerEngine.push`` and ``KVStore.push_delta*`` short-circuit through
Python calls, so the protocol work that is already wire-ready (CRC32C
sealed envelopes with NACK and bounded retransmit, idempotent
seq-tokened pushes, per-peer slowness scoring) never crosses a socket
whose failures are real.  This is that wire, speaking the EXISTING
envelope frames (``common/integrity.py``), with socket-level chaos
injectable without a cooperating peer.

Three layers:

**Framing**: each message is a small transport header around one
sealed-envelope payload, byte for byte the JAX package's frame::

    !4s  magic   b"BPST"
    !B   version (1)
    !B   op      (request or reply kind, the same OP_* codes)
    !Q   req_id  (matches a reply to its pending request)
    !I   meta length     (pickled request/reply metadata)
    !Q   payload length  (the sealed envelope, or a pickled reply body)

The meta and the payload carry only builtins, numpy and sealed
envelopes (a pulled value travels as a sealed numpy envelope, never a
torch object), so a JAX peer unpickles every frame and the frames equal
the JAX package's.  The receiver verifies each envelope on receive; a
failed verification is answered with ``OP_NACK`` and the sender
retransmits from its sealed SOURCE copy under the same
``BYTEPS_INTEGRITY_MAX_RETRANSMITS`` budget.  Frame sizes are clamped by
``BYTEPS_BUS_MAX_FRAME`` on both ends.

**Connection supervision**: one :class:`Connection` per peer, a state
machine CONNECTING -> READY -> DRAINING -> DEAD:

- a supervisor thread dials with full-jitter backoff (``common/
  retry.py``), performs a HELLO handshake (identifying this rank for the
  server's per-worker dedup floors), then owns the receive loop; a dead
  socket flips the state back to CONNECTING and the supervisor re-dials
  (``transport.connects`` / ``transport.reconnects``);
- every request carries a **send deadline**
  (``BYTEPS_TRANSPORT_SEND_DEADLINE``): an unanswered request surfaces
  as :class:`integrity.AckLost` (``transport.send_deadline_trips``), the
  exception the seq-token retry machinery already absorbs, never a hang;
- in-flight request bytes are bounded
  (``BYTEPS_TRANSPORT_MAX_INFLIGHT``): past the bound the sender blocks
  (``transport.backpressure_stalls``);
- idle connections exchange keepalives (``BYTEPS_TRANSPORT_KEEPALIVE``);
  a keepalive that deadlines kills the socket so the supervisor re-dials
  instead of trusting a dead-but-ESTABLISHED connection;
- every request's RTT lands in the ``transport.rtt_ms{peer=}``
  histogram and the per-peer slowness tracker (``site="transport"``).

**Endpoints**: one :class:`Endpoint` interface in front of both worlds:
:class:`LoopbackEndpoint` (direct calls into the local ``ServerEngine``
/ ``KVStore``, with the loopback integrity semantics) and
:class:`TcpEndpoint` (the real wire).  :class:`ShardedClient` routes keys
across N server endpoints through ``server/sharding.py``'s
``ServerAssigner``, the same hash space on every process.  A value
pushed from the card is copied to the host and sealed there; a store's
codec decodes on the store's own device.

Chaos (``fault/injector.py`` socket kinds, site ``transport``): the shim
consults ``injector.socket_fault`` before every socket operation:
``partition`` blackholes traffic (the deadline surfaces it),
``conn_reset`` tears the socket down with a real RST (SO_LINGER 0),
``partial_write`` ships a truncated frame then RSTs, ``slow_socket``
throttles sends; ``delay``/``drop`` at ``site=transport`` ride the same
send gate.  In an elastic world a partitioned rank's sends end in
``AckLost`` at the deadline, never a hang: the rank leaves restartably
and the survivors' membership (``fault/membership.py``) shrinks past it
(the JAX package's 4-process partition lane).

Not ported yet: the serving plane's ops.  ``OP_SERVE_PULL`` and the
``serve_cut`` / ``serve_commit`` / ``serve_ctl`` hops of ``OP_PUSH`` keep
their codes, and the server answers them as the JAX server does with no
serving endpoint or tier attached (``TransportRemoteError`` "no serving
endpoint attached" / "no serving tier attached"); the endpoints'
serving calls and ``RemoteServing`` wait for ``server/serving.py``.
"""

from __future__ import annotations

import itertools
import pickle
import socket
import struct
import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..common import integrity as _integrity
from ..common import tracing as _tracing
from ..common.logging import get_logger
from ..common.retry import RetryPolicy
from ..common.telemetry import counters, gauges, histograms
from ..fault import injector as _fault

__all__ = [
    "TransportError", "TransportClosed", "TransportConnectionLost",
    "TransportRemoteError", "Endpoint", "LoopbackEndpoint", "TcpEndpoint",
    "Connection", "TransportServer", "ShardedClient", "serve",
    "local_server", "transport_addr", "transport_host_map", "endpoint_to",
    "CONNECTING", "READY", "DRAINING", "DEAD",
]

MAGIC = b"BPST"
VERSION = 1

# request ops
OP_HELLO = 1
OP_PUSH = 2          # meta.hop selects server_push / server_push_wire /
#                      kv / kv_wire; payload = one sealed envelope
OP_SERVER_PULL = 3   # blocking ServerEngine.pull
OP_SERVE_PULL = 4    # serving-plane delta/full pull (the plane is not
#                      ported: the server answers "no serving endpoint
#                      attached")
OP_KV_PULL = 5       # KVStore.pull_versioned
OP_STATE = 6         # rejoin-state blob (utils/checkpoint.pack_state)
OP_KEEPALIVE = 7
# reply ops
OP_ACK = 16
OP_NACK = 17         # receiver's integrity NACK: retransmit from source
OP_ERR = 18          # remote exception, meta carries kind + message
OP_REPLY = 19        # reply with a payload (pulls, state)

_HEADER = struct.Struct("!4sBBQIQ")

# connection states (the supervisor's state machine)
CONNECTING = "CONNECTING"
READY = "READY"
DRAINING = "DRAINING"
DEAD = "DEAD"


class TransportError(ConnectionError):
    """Base class for transport failures."""


class TransportClosed(TransportError):
    """The connection was closed locally (DRAINING/DEAD): no new
    requests are accepted."""


class TransportConnectionLost(TransportError):
    """The connection died while a request was in flight.  The sender
    retries from its sealed source copy once the supervisor reconnects
    (bounded by the request deadline); receivers' seq-token dedup makes
    the retry safe even when the original landed."""


class TransportRemoteError(TransportError):
    """The remote handler raised something the protocol has no richer
    mapping for; carries the remote exception's repr."""


# -- framing ----------------------------------------------------------------


def _host(value) -> np.ndarray:
    """A value to seal as a host array: a tensor on any device is copied
    to the host (a CPU tensor is viewed), anything else goes through
    numpy."""
    if isinstance(value, torch.Tensor):
        t = value.detach()
        return (t if t.device.type == "cpu" else t.cpu()).numpy()
    return np.asarray(value)


def _max_frame() -> int:
    from ..common.config import get_config
    return get_config().bus_max_frame


def _pack_frame(op: int, req_id: int, meta: Optional[dict],
                payload: bytes = b"") -> bytes:
    mb = pickle.dumps(meta, protocol=pickle.HIGHEST_PROTOCOL) if meta else b""
    limit = _max_frame()
    if len(mb) > limit or len(payload) > limit:
        # clamp at the SENDER too (the bus does, fault/membership.py):
        # an oversized frame shipped anyway would cross the wire only to
        # be refused by the receiver's clamp, read as a connection loss,
        # and retransmitted forever — a clear error here, not a
        # misdiagnosed "partition" after gigabytes of wasted bandwidth
        raise TransportError(
            f"frame exceeds BYTEPS_BUS_MAX_FRAME ({limit} bytes): "
            f"meta={len(mb)} payload={len(payload)}")
    return b"".join((_HEADER.pack(MAGIC, VERSION, op, req_id, len(mb),
                                  len(payload)), mb, payload))


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(1 << 20, n - len(buf)))
        if not chunk:
            raise TransportConnectionLost("connection closed mid-frame")
        buf += chunk
    return bytes(buf)


def _read_frame(sock: socket.socket) -> Tuple[int, int, dict, bytes]:
    head = _recv_exact(sock, _HEADER.size)
    magic, version, op, req_id, meta_len, payload_len = _HEADER.unpack(head)
    if magic != MAGIC or version != VERSION:
        raise TransportError(
            f"bad transport frame header {head[:6]!r} (not a BPST v1 "
            "frame — peer speaking another protocol?)")
    clamp = _max_frame()
    if meta_len > clamp or payload_len > clamp:
        raise TransportError(
            f"transport frame length {max(meta_len, payload_len)} exceeds "
            f"BYTEPS_BUS_MAX_FRAME={clamp} — corrupt length prefix or "
            "misbehaving peer; failing the connection")
    meta = pickle.loads(_recv_exact(sock, meta_len)) if meta_len else {}
    payload = _recv_exact(sock, payload_len) if payload_len else b""
    return op, req_id, meta, payload


# -- the chaos socket shim --------------------------------------------------


def _abort_socket(sock: socket.socket) -> None:
    """Tear a connection down hard: SO_LINGER 0 + shutdown.  The
    shutdown WAKES any local thread blocked in ``recv`` on this fd (a
    bare ``close`` would leave a supervisor parked on a dead descriptor
    forever — the exact hang this transport exists to rule out) and
    sends the peer its termination; the fd itself is closed by the loop
    that owns it, never here (closing another thread's blocking socket
    invites fd-reuse races)."""
    try:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                        struct.pack("ii", 1, 0))
    except OSError:
        pass
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass


def _chaos_send(sock: socket.socket, data: bytes, peer: int = -1) -> None:
    """One frame onto the wire, through the socket-level chaos gate.
    ``partition`` and ``drop`` blackhole the frame (the caller's send
    deadline surfaces the silence); ``conn_reset``/``partial_write``
    tear the connection down like the real failures they model.  A
    ranks-scoped partition (``partition:ranks=A|B``) blackholes only
    frames whose ``peer`` is across the cut — callers that know the
    remote rank pass it."""
    if _fault.ENABLED:
        if peer >= 0 and _fault.edge_cut(peer):
            return  # severed edge: bytes vanish, connection stays "up"
        act = _fault.socket_fault("transport", "send")
        if act == "partition":
            return  # blackholed: bytes vanish, connection stays "up"
        if act == "conn_reset":
            _abort_socket(sock)
            raise ConnectionResetError("injected conn_reset (chaos)")
        if act == "partial_write":
            try:
                sock.sendall(data[:max(1, len(data) // 2)])
            except OSError:
                pass
            _abort_socket(sock)
            raise ConnectionResetError("injected partial_write (chaos)")
        _fault.fire("transport")          # delay/straggler/slow sleeps
        if _fault.should_drop("transport"):
            return  # dropped frame: same deadline-backed blackhole
    sock.sendall(data)


def _chaos_recv_gate(sock: socket.socket, peer: int = -1) -> Optional[str]:
    """Chaos decision for ONE received frame — consulted AT ARRIVAL
    time (deciding before the blocking read would let a pre-partition
    verdict swallow a frame arriving after the partition healed).
    ``conn_reset`` kills the socket here; ``partition`` tells the
    caller to discard the frame (a deaf peer still drains its TCP
    buffers).  ``peer`` scopes ranks-partitions to the severed edges
    only."""
    if not _fault.ENABLED:
        return None
    if peer >= 0 and _fault.edge_cut(peer):
        return "partition"
    act = _fault.socket_fault("transport", "recv")
    if act == "conn_reset":
        _abort_socket(sock)
        raise ConnectionResetError("injected conn_reset (chaos)")
    return act


# -- connection registry (gauges + /debug/state) ----------------------------

_connections: "weakref.WeakSet[Connection]" = weakref.WeakSet()


def _publish_conn_gauges() -> None:
    conns = [c for c in _connections if c.state != DEAD]
    gauges.set("transport.connections", len(conns))
    gauges.set("transport.connections_ready",
               sum(1 for c in conns if c.state == READY))


class _Waiter:
    __slots__ = ("ev", "op", "meta", "payload", "error")

    def __init__(self):
        self.ev = threading.Event()
        self.op = 0
        self.meta: dict = {}
        self.payload = b""
        self.error: Optional[BaseException] = None


class Connection:
    """One supervised connection to a peer transport server.

    The state machine: CONNECTING (supervisor dialing with backoff) →
    READY (HELLO acked, requests flow) → back to CONNECTING on any
    socket death (pending requests fail with
    :class:`TransportConnectionLost`; senders retransmit) → DRAINING
    (close() called: no new requests, pending ones finish) → DEAD.
    """

    def __init__(self, addr: Tuple[str, int], peer: int = -1, *,
                 rank: Optional[int] = None,
                 connect_timeout_s: Optional[float] = None,
                 send_deadline_s: Optional[float] = None,
                 keepalive_s: Optional[float] = None,
                 max_inflight: Optional[int] = None):
        from ..common.config import get_config
        cfg = get_config()
        self.addr = (str(addr[0]), int(addr[1]))
        self.peer = int(peer)
        self.rank = cfg.host_id if rank is None else int(rank)
        self._connect_timeout = (cfg.transport_connect_timeout_s
                                 if connect_timeout_s is None
                                 else float(connect_timeout_s))
        self._deadline = (cfg.transport_send_deadline_s
                          if send_deadline_s is None
                          else float(send_deadline_s))
        self._keepalive = (cfg.transport_keepalive_s if keepalive_s is None
                           else float(keepalive_s))
        self._max_inflight = (cfg.transport_max_inflight
                              if max_inflight is None else int(max_inflight))
        self._cv = threading.Condition()
        self._state = CONNECTING
        self._sock: Optional[socket.socket] = None
        self._send_mutex = threading.Lock()
        self._pending: Dict[int, _Waiter] = {}
        self._req_ids = itertools.count(1)
        self._inflight = 0
        self._closed = False
        self._last_send = time.monotonic()
        self.connects = 0
        self.reconnects = 0
        self.dial_attempts = 0   # every dial try, successful or not
        self.last_rtt_ms: Optional[float] = None
        self._threads = [
            threading.Thread(target=self._run, daemon=True,
                             name=f"bps-transport-conn-{self.peer}")]
        if self._keepalive > 0:
            self._threads.append(threading.Thread(
                target=self._keepalive_loop, daemon=True,
                name=f"bps-transport-ka-{self.peer}"))
        _connections.add(self)
        from ..common import metrics as _metrics
        _metrics.register_component("transport_conn", self)
        for t in self._threads:
            t.start()
        _publish_conn_gauges()

    # -- observability ------------------------------------------------------

    @property
    def state(self) -> str:
        return self._state

    def debug_state(self) -> dict:
        with self._cv:
            return {"kind": "transport_conn",
                    "peer": self.peer,
                    "addr": "%s:%d" % self.addr,
                    "state": self._state,
                    "pending": len(self._pending),
                    "inflight_bytes": self._inflight,
                    "connects": self.connects,
                    "reconnects": self.reconnects,
                    "last_rtt_ms": self.last_rtt_ms}

    # -- the supervisor -----------------------------------------------------

    def _dial(self) -> socket.socket:
        if _fault.ENABLED and (
                _fault.socket_fault("transport", "connect") == "partition"
                or _fault.edge_cut(self.peer)):
            raise ConnectionRefusedError("injected partition (chaos)")
        sock = socket.create_connection(self.addr,
                                        timeout=self._connect_timeout)
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            # HELLO handshake: identify this rank (the server keys its
            # per-worker dedup floors by it) and prove liveness — READY
            # means the server actually answered, not just SYN/ACK
            _chaos_send(sock, _pack_frame(OP_HELLO, 0,
                                          {"rank": self.rank,
                                           "peer": self.peer}),
                        self.peer)
            sock.settimeout(self._connect_timeout)
            op, _rid, _meta, _payload = _read_frame(sock)
            if op != OP_ACK:
                raise TransportError(f"HELLO answered with op {op}")
            sock.settimeout(None)
            return sock
        except BaseException:
            sock.close()
            raise

    def _run(self) -> None:
        backoff = RetryPolicy.from_config()
        attempt = 0
        while True:
            with self._cv:
                if self._closed:
                    break
            self.dial_attempts += 1
            try:
                sock = self._dial()
            except (OSError, TransportError):
                attempt += 1
                delay = max(backoff.backoff(min(attempt, 10)), 0.005)
                with self._cv:
                    if self._closed:
                        break
                    self._cv.wait(delay)
                continue
            with self._cv:
                if self._closed:
                    sock.close()
                    break
                self._sock = sock
                self._state = READY
                self.connects += 1
                if self.connects > 1:
                    self.reconnects += 1
                self._cv.notify_all()
            counters.inc("transport.connects")
            if self.connects > 1:
                counters.inc("transport.reconnects")
            _publish_conn_gauges()
            attempt = 0
            err = self._recv_loop(sock)
            try:
                sock.close()
            except OSError:
                pass
            with self._cv:
                self._sock = None
                if not self._closed:
                    self._state = CONNECTING
                lost = list(self._pending.values())
                self._pending.clear()
                self._cv.notify_all()
            for w in lost:
                w.error = TransportConnectionLost(
                    f"connection to {self.addr} lost: {err}")
                w.ev.set()
            _publish_conn_gauges()
            if lost:
                get_logger().warning(
                    "transport: connection to %s lost (%s); %d request(s) "
                    "will retransmit after reconnect", self.addr, err,
                    len(lost))
        with self._cv:
            self._state = DEAD
            lost = list(self._pending.values())
            self._pending.clear()
            self._cv.notify_all()
        for w in lost:
            w.error = TransportClosed(f"connection to {self.addr} closed")
            w.ev.set()
        _publish_conn_gauges()

    def _recv_loop(self, sock: socket.socket) -> str:
        while True:
            try:
                op, req_id, meta, payload = _read_frame(sock)
                discard = _chaos_recv_gate(sock, self.peer) == "partition"
            except ConnectionResetError as e:
                counters.inc("transport.conn_resets")
                return repr(e)
            except Exception as e:  # noqa: BLE001 — ANY frame-read
                # failure (incl. a corrupt meta unpickle) poisons the
                # CONNECTION, not the supervisor: returning here lets
                # the supervisor reconnect instead of leaving a
                # reader-less socket parked in READY forever
                return repr(e)
            if discard:
                continue  # partitioned: the reply never "arrives"
            with self._cv:
                w = self._pending.pop(req_id, None)
            if w is not None:
                w.op, w.meta, w.payload = op, meta, payload
                w.ev.set()

    def _kill_socket(self) -> None:
        """Force the recv loop off a socket we no longer trust; the
        supervisor reconnects."""
        with self._cv:
            sock = self._sock
        if sock is not None:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass

    def _keepalive_loop(self) -> None:
        while True:
            with self._cv:
                if self._closed:
                    return
                self._cv.wait(max(self._keepalive / 2, 0.05))
                if self._closed:
                    return
                idle = time.monotonic() - self._last_send
                ready = self._state == READY
                # a pending request means the wire is NOT idle — it is
                # parked on a legitimately slow reply (a merge-round
                # pull), and that request's own deadline already bounds
                # a dead socket.  Probing here would race the parked
                # reply and kill a healthy connection.
                busy = bool(self._pending)
            if not ready or busy or idle < self._keepalive:
                continue
            try:
                self.request(OP_KEEPALIVE, {},
                             deadline_s=max(self._keepalive, 1.0))
            except _integrity.AckLost:
                # a dead-but-ESTABLISHED socket: kill it so the
                # supervisor re-dials instead of trusting the corpse
                self._kill_socket()
            except TransportError:
                pass

    # -- requests -----------------------------------------------------------

    def request(self, op: int, meta: dict, payload: bytes = b"",
                deadline_s: Optional[float] = None
                ) -> Tuple[int, dict, bytes]:
        """One request/reply round trip, deadline-bounded end to end
        (waiting for READY, backpressure, and the reply wait all share
        the budget).  Raises :class:`integrity.AckLost` at the deadline
        — never blocks forever."""
        deadline = self._deadline if deadline_s is None else deadline_s
        t_end = time.monotonic() + deadline
        nbytes = len(payload)
        stalled = False
        with self._cv:
            while True:
                if self._closed or self._state in (DRAINING, DEAD):
                    raise TransportClosed(
                        f"connection to {self.addr} is {self._state}")
                if self._state == READY and (
                        self._inflight + nbytes <= self._max_inflight
                        or self._inflight == 0):
                    break
                if self._state == READY and not stalled:
                    # bounded in-flight buffering: the pushing thread
                    # blocks here, holding its scheduler credit — the
                    # wire's backpressure becomes the engine's
                    stalled = True
                    counters.inc("transport.backpressure_stalls")
                remaining = t_end - time.monotonic()
                if remaining <= 0:
                    counters.inc("transport.send_deadline_trips")
                    raise _integrity.AckLost(
                        f"transport request to {self.addr} exceeded its "
                        f"{deadline:.1f}s send deadline while "
                        f"{self._state}")
                self._cv.wait(min(remaining, 0.5))
            sock = self._sock
            req_id = next(self._req_ids)
            w = _Waiter()
            self._pending[req_id] = w
            self._inflight += nbytes
        t0 = time.monotonic()
        try:
            frame = _pack_frame(op, req_id, meta, payload)
            try:
                with self._send_mutex:
                    self._last_send = t0
                    _chaos_send(sock, frame, self.peer)
            except ConnectionResetError as e:
                counters.inc("transport.conn_resets")
                self._kill_socket()
                raise TransportConnectionLost(
                    f"send to {self.addr} reset: {e}") from None
            except OSError as e:
                self._kill_socket()
                raise TransportConnectionLost(
                    f"send to {self.addr} failed: {e}") from None
            if not w.ev.wait(max(t_end - time.monotonic(), 0.0)):
                counters.inc("transport.send_deadline_trips")
                raise _integrity.AckLost(
                    f"no reply from {self.addr} within {deadline:.1f}s "
                    f"(req {req_id}, op {op}) — the peer is partitioned, "
                    "wedged, or the reply was lost; retry is safe "
                    "(seq-token dedup)")
        finally:
            with self._cv:
                self._pending.pop(req_id, None)
                self._inflight -= nbytes
                self._cv.notify_all()
        if w.error is not None:
            raise w.error
        rtt = time.monotonic() - t0
        self.last_rtt_ms = rtt * 1e3
        if op != OP_KEEPALIVE:
            histograms.observe("transport.rtt_ms", rtt * 1e3,
                               peer=self.peer)
            # Slowness feed (utils/slowness.py): a chronically slow
            # wire to this peer scores as SLOW before it ever scores as
            # dead.  Keepalives are excluded here too — a mostly-idle
            # connection's stream of sub-ms probe RTTs would dilute a
            # slow data path's score and delay the demotion the score
            # exists to trigger.  Lazy import — utils pulls in
            # checkpoint → core.api at package init.
            from ..utils import slowness as _slowness
            _slowness.tracker().observe(self.peer, rtt, site="transport")
        return w.op, w.meta, w.payload

    # -- lifecycle ----------------------------------------------------------

    def close(self, drain: bool = True, timeout: float = 5.0) -> None:
        """DRAINING: no new requests; with ``drain`` the pending ones
        get up to ``timeout`` to finish.  Then DEAD, socket torn down,
        threads joined."""
        with self._cv:
            if self._state == DEAD and self._closed:
                return
            self._state = DRAINING
            self._cv.notify_all()
            if drain:
                t_end = time.monotonic() + timeout
                while self._pending:
                    remaining = t_end - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cv.wait(min(remaining, 0.25))
            self._closed = True
            self._cv.notify_all()
        self._kill_socket()
        for t in self._threads:
            t.join(timeout=5)
        with self._cv:
            self._state = DEAD
        _publish_conn_gauges()


# -- the server -------------------------------------------------------------


class TransportServer:
    """One rank's transport listener: accepts peer connections and
    dispatches their frames into the LOCAL receivers — the
    :class:`~byteps_tpu_torch.server.engine.ServerEngine` merge engine,
    the :class:`~byteps_tpu_torch.server.kv_store.KVStore` and a
    rejoin-state provider.  Verification happens HERE, on receive: a
    frame that fails its CRC is answered ``OP_NACK`` and the sender
    retransmits from its sealed source copy — the loopback NACK machine,
    now with a real wire in the middle.

    Per-(key, worker) sequence floors make ``server_push`` hops
    idempotent on the wire: a retransmit whose original landed (the
    reply was lost, not the request) is acknowledged and dropped, so a
    sync merge round can never count one worker twice."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, *,
                 rank: int = 0, engine=None, kv=None,
                 state_provider: Optional[Callable[[], bytes]] = None):
        self.rank = int(rank)
        self.engine = engine
        self.kv = kv
        self.state_provider = state_provider
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(128)
        self.host, self.port = self._listener.getsockname()[:2]
        self._lock = threading.Lock()
        self._conns: Dict[socket.socket, int] = {}
        self._push_floor: Dict[Tuple[str, int], int] = {}
        self._push_inflight: set = set()
        self._closed = False
        self._threads: List[threading.Thread] = []
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name=f"bps-transport-srv-{self.rank}")
        from ..common import metrics as _metrics
        _metrics.register_component("transport_server", self)
        self._accept_thread.start()

    @property
    def addr(self) -> Tuple[str, int]:
        return (self.host, self.port)

    def attach(self, *, engine=None, kv=None,
               state_provider=None) -> "TransportServer":
        """Attach/replace local receivers (idempotent; None leaves the
        existing attachment)."""
        if engine is not None:
            self.engine = engine
        if kv is not None:
            self.kv = kv
        if state_provider is not None:
            self.state_provider = state_provider
        return self

    def debug_state(self) -> dict:
        with self._lock:
            return {"kind": "transport_server",
                    "rank": self.rank,
                    "addr": "%s:%d" % (self.host, self.port),
                    "peers": sorted(set(self._conns.values())),
                    "connections": len(self._conns),
                    "push_floors": len(self._push_floor),
                    "attached": {
                        "engine": self.engine is not None,
                        "kv": self.kv is not None,
                        "serving": False,
                        "tier": False,
                        "state": self.state_provider is not None}}

    # -- accept / dispatch --------------------------------------------------

    def _accept_loop(self) -> None:
        while True:
            try:
                sock, _addr = self._listener.accept()
            except OSError:
                return  # listener closed
            with self._lock:
                if self._closed:
                    sock.close()
                    return
                self._conns[sock] = -1
                t = threading.Thread(target=self._handle, args=(sock,),
                                     daemon=True,
                                     name=f"bps-transport-h-{self.rank}")
                self._threads.append(t)
            t.start()

    def _handle(self, sock: socket.socket) -> None:
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass
        # parked pulls answer from side threads, so two threads can
        # write this socket — frames must not interleave
        send_lock = threading.Lock()
        try:
            while True:
                try:
                    op, req_id, meta, payload = _read_frame(sock)
                    with self._lock:
                        peer = self._conns.get(sock, -1)
                    discard = _chaos_recv_gate(sock, peer) == "partition"
                except ConnectionResetError:
                    counters.inc("transport.conn_resets")
                    return
                except Exception:  # noqa: BLE001 — any frame-read
                    # failure fails the CONNECTION (the client
                    # reconnects); the handler must not die leaving the
                    # socket half-read
                    return
                if discard:
                    continue  # deaf while partitioned
                if op == OP_SERVER_PULL:
                    # the engine parks this pull until the merge round
                    # completes — potentially a long, LEGITIMATE wait.
                    # Answer from a side thread so keepalives and other
                    # requests on this connection are not starved behind
                    # it (a starved keepalive reads as a dead socket and
                    # tears the connection down)
                    threading.Thread(
                        target=self._answer_parked_pull,
                        args=(sock, send_lock, req_id, meta),
                        daemon=True,
                        name=f"bps-transport-pull-{self.rank}").start()
                    continue
                try:
                    reply = self._dispatch(sock, op, req_id, meta, payload)
                except _integrity.AckLost:
                    # chaos drop:site=kv_push — the delta APPLIED, the
                    # acknowledgement is what gets lost: stay silent so
                    # the client's deadline surfaces AckLost and its
                    # same-token retry is dedup-absorbed
                    continue
                except Exception as e:  # noqa: BLE001 — remote errors
                    # travel as data, never kill the handler
                    reply = _pack_frame(OP_ERR, req_id,
                                        {"kind": type(e).__name__,
                                         "error": repr(e)})
                if reply is None:
                    continue
                if not self._send_reply(sock, send_lock, reply):
                    return
        finally:
            with self._lock:
                self._conns.pop(sock, None)
                try:
                    self._threads.remove(threading.current_thread())
                except ValueError:
                    pass
            try:
                sock.close()
            except OSError:
                pass

    def _send_reply(self, sock: socket.socket, send_lock: threading.Lock,
                    reply: bytes) -> bool:
        try:
            with self._lock:
                if self._closed:
                    return False
                peer = self._conns.get(sock, -1)
            with send_lock:
                _chaos_send(sock, reply, peer)
            return True
        except OSError:
            return False

    def _answer_parked_pull(self, sock: socket.socket,
                            send_lock: threading.Lock, req_id: int,
                            meta: dict) -> None:
        try:
            if self.engine is None:
                raise TransportRemoteError("no ServerEngine attached")
            # always bounded: our client sends an explicit timeout, but
            # a foreign client omitting one must not park this
            # answering thread forever (it outlives the request's
            # client-side deadline as a leak, not a wait)
            timeout = meta.get("timeout")
            if timeout is None:
                from ..common.config import get_config
                timeout = get_config().transport_send_deadline_s
            value, version = self.engine.pull_versioned(
                meta["key"], timeout)
            frame = _integrity.seal_array(value, key=meta["key"],
                                          seq=version, worker=self.rank)
            reply = _pack_frame(OP_REPLY, req_id, {"version": version},
                                frame)
        except Exception as e:  # noqa: BLE001 — remote errors travel
            reply = _pack_frame(OP_ERR, req_id, {"kind": type(e).__name__,
                                                 "error": repr(e)})
        self._send_reply(sock, send_lock, reply)

    def _claim_push(self, key: str, worker: int,
                    seq: int) -> Tuple[str, int]:
        """Wire-level idempotence for ``server_push`` hops (the KV hops
        bring their own store-side dedup): atomically claim (key,
        worker, seq) by advancing the floor AT CHECK TIME.  A
        check-then-mark split would double-sum: a reconnect retransmit
        can arrive on a fresh handler thread while the original
        dispatch is still inside ``receive_push``.  Returns (verdict,
        previous floor):

        - ``"claimed"`` — merge it;
        - ``"dup"`` — the original LANDED: drop and ACK;
        - ``"inflight"`` — the original is still mid-merge on another
          handler thread, its fate unknown: answer NOTHING.  A dup-ACK
          here would report success for a merge that may yet raise; the
          silence trips the client's deadline and its next same-token
          retry finds the resolved floor (landed → dup, rolled back →
          fresh claim)."""
        with self._lock:
            if (key, worker, seq) in self._push_inflight:
                return "inflight", 0
            floor = self._push_floor.get((key, worker), 0)
            if seq <= floor:
                counters.inc("integrity.dup_dropped")
                return "dup", floor
            self._push_floor[(key, worker)] = seq
            self._push_inflight.add((key, worker, seq))
            return "claimed", floor

    def _resolve_push(self, key: str, worker: int, seq: int,
                      floor: int, landed: bool) -> None:
        """Resolve a claim: on success the advanced floor stands; after
        the merge RAISED the floor rolls back (the error travels to the
        sender as ``OP_ERR``; a later same-token retry must get another
        chance, not a silent dup-ACK)."""
        with self._lock:
            self._push_inflight.discard((key, worker, seq))
            if not landed and self._push_floor.get((key, worker), 0) == seq:
                if floor > 0:
                    self._push_floor[(key, worker)] = floor
                else:
                    self._push_floor.pop((key, worker), None)

    def _dispatch(self, sock: socket.socket, op: int, req_id: int,
                  meta: dict, payload: bytes) -> Optional[bytes]:
        if op == OP_HELLO:
            with self._lock:
                self._conns[sock] = int(meta.get("rank", -1))
            return _pack_frame(OP_ACK, req_id, {"rank": self.rank})
        if op == OP_KEEPALIVE:
            return _pack_frame(OP_ACK, req_id, {})
        if op == OP_PUSH:
            return self._dispatch_push(req_id, meta, payload)
        if op == OP_KV_PULL:
            if self.kv is None:
                raise TransportRemoteError("no KVStore attached")
            value, version = self.kv.pull_versioned(meta["key"])
            frame = _integrity.seal_array(value, key=meta["key"],
                                          seq=version, worker=self.rank)
            return _pack_frame(OP_REPLY, req_id, {"version": version},
                               frame)
        if op == OP_SERVE_PULL:
            # the serving plane is not ported: answered as the JAX
            # server answers with no serving endpoint attached
            raise TransportRemoteError("no serving endpoint attached")
        if op == OP_STATE:
            if self.state_provider is None:
                raise TransportRemoteError("no rejoin-state provider "
                                           "attached")
            return _pack_frame(OP_REPLY, req_id, {},
                               bytes(self.state_provider()))
        raise TransportRemoteError(f"unknown transport op {op}")

    def _dispatch_push(self, req_id: int, meta: dict,
                       payload: bytes) -> bytes:
        hop = meta.get("hop", "server_push")
        try:
            if hop in ("server_push", "kv") or (
                    hop == "serve_cut" and meta.get("codec") is None):
                arr, env = _integrity.open_array(payload)
            else:
                data, env = _integrity.open_bytes(payload)
        except _integrity.IntegrityError as e:
            # the receiver's NACK: counted and flight-recorded exactly
            # like the loopback hop's, but the retransmit now genuinely
            # crosses the wire again
            counters.inc("integrity.crc_reject")
            from ..common import flight_recorder as _flight
            _flight.record("integrity.crc_reject", site="transport",
                           hop=hop, rank=self.rank)
            get_logger().warning(
                "transport server %d: NACK %s frame (%s)", self.rank, hop,
                e)
            return _pack_frame(OP_NACK, req_id, {"error": str(e)})
        mepoch = meta.get("mepoch")
        if hop == "server_push" or hop == "server_push_wire":
            if self.engine is None:
                raise TransportRemoteError("no ServerEngine attached")
            verdict, floor = self._claim_push(env.key, env.worker,
                                              env.seq)
            if verdict == "dup":
                return _pack_frame(OP_ACK, req_id, {"dup": True})
            if verdict == "inflight":
                return None   # silence: the retry re-resolves
            try:
                if hop == "server_push":
                    self.engine.receive_push(env.key, arr, env.worker,
                                             meta["num_workers"],
                                             mepoch=mepoch)
                else:
                    self.engine.receive_push_wire(env.key, data,
                                                  env.worker,
                                                  meta["num_workers"],
                                                  mepoch=mepoch)
            except BaseException:
                self._resolve_push(env.key, env.worker, env.seq, floor,
                                   landed=False)
                raise
            self._resolve_push(env.key, env.worker, env.seq, floor,
                               landed=True)
            return _pack_frame(OP_ACK, req_id, {})
        if hop == "kv":
            if self.kv is None:
                raise TransportRemoteError("no KVStore attached")
            version = self.kv.apply_delta(env.key, arr, mepoch=mepoch,
                                          worker_id=env.worker,
                                          seq=env.seq)
            return _pack_frame(OP_ACK, req_id, {"version": version})
        if hop == "kv_wire":
            if self.kv is None:
                raise TransportRemoteError("no KVStore attached")
            version = self.kv.apply_delta_wire(env.key, data,
                                               mepoch=mepoch,
                                               worker_id=env.worker,
                                               seq=env.seq)
            return _pack_frame(OP_ACK, req_id, {"version": version})
        if hop in ("serve_cut", "serve_commit", "serve_ctl"):
            # serving-tier publication hops: the tier is not ported, so
            # they are answered as the JAX server answers with none
            # attached
            raise TransportRemoteError("no serving tier attached")
        raise TransportRemoteError(f"unknown push hop {hop!r}")

    def close(self) -> None:
        with self._lock:
            self._closed = True
            conns = list(self._conns)
            threads = list(self._threads)
        try:
            # shutdown BEFORE close: a bare close does not wake the
            # accept thread blocked in accept() (the same
            # closed-fd-never-wakes hang _abort_socket documents)
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        for sock in conns:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass
        self._accept_thread.join(timeout=5)
        for t in threads:
            t.join(timeout=5)


# -- endpoints --------------------------------------------------------------


class Endpoint:
    """ONE interface in front of the in-process loopback and the real
    wire, covering the data-plane hops: training pushes
    (``push``/``push_compressed``/``push_delta``/``push_delta_wire``),
    pulls, and rejoin state (``pull_state``).  The serving pulls of the
    JAX interface wait for the serving plane."""

    def push(self, key: str, value, worker_id: int, num_workers: int,
             mepoch: Optional[int] = None) -> None:
        raise NotImplementedError

    def push_compressed(self, key: str, data: bytes, worker_id: int,
                        num_workers: int,
                        mepoch: Optional[int] = None) -> None:
        raise NotImplementedError

    def push_delta(self, key: str, delta, mepoch: Optional[int] = None,
                   worker_id: int = 0, seq: Optional[int] = None) -> int:
        raise NotImplementedError

    def push_delta_wire(self, key: str, data: bytes,
                        mepoch: Optional[int] = None, worker_id: int = 0,
                        seq: Optional[int] = None) -> int:
        raise NotImplementedError

    def pull(self, key: str, timeout: Optional[float] = None) -> np.ndarray:
        raise NotImplementedError

    def pull_versioned(self, key: str, timeout: Optional[float] = None
                       ) -> Tuple[np.ndarray, int]:
        raise NotImplementedError

    def kv_pull(self, key: str) -> Tuple[np.ndarray, int]:
        raise NotImplementedError

    def pull_state(self) -> Any:
        raise NotImplementedError

    def close(self) -> None:
        pass


class LoopbackEndpoint(Endpoint):
    """The same-process fast path: direct calls into the local
    receivers, preserving every loopback integrity semantic (the
    in-process seal/CRC bypass, chaos rerouting, seq dedup)."""

    def __init__(self, engine=None, kv=None,
                 state_provider: Optional[Callable[[], bytes]] = None):
        self.engine = engine
        self.kv = kv
        self.state_provider = state_provider

    def push(self, key, value, worker_id, num_workers, mepoch=None):
        return self.engine.push(key, value, worker_id, num_workers,
                                mepoch=mepoch)

    def push_compressed(self, key, data, worker_id, num_workers,
                        mepoch=None):
        return self.engine.push_compressed(key, data, worker_id,
                                           num_workers, mepoch=mepoch)

    def push_delta(self, key, delta, mepoch=None, worker_id=0, seq=None):
        return self.kv.push_delta(key, delta, mepoch=mepoch,
                                  worker_id=worker_id, seq=seq)

    def push_delta_wire(self, key, data, mepoch=None, worker_id=0,
                        seq=None):
        return self.kv.push_delta_wire(key, data, mepoch=mepoch,
                                       worker_id=worker_id, seq=seq)

    def pull(self, key, timeout=None):
        return self.engine.pull(key, timeout=timeout)

    def pull_versioned(self, key, timeout=None):
        return self.engine.pull_versioned(key, timeout)

    def kv_pull(self, key):
        return self.kv.pull_versioned(key)

    def pull_state(self):
        from ..utils.checkpoint import unpack_state
        return unpack_state(self.state_provider())


class TcpEndpoint(Endpoint):
    """The real wire: sealed envelopes over a supervised
    :class:`Connection`, NACK-driven retransmit from the sealed source
    copy, seq-token idempotence across reconnects, ``wire:{site}``
    tracing spans covering a genuine network hop."""

    # ONE strictly-increasing token source for every endpoint in this
    # process: the server's per-(key, worker) dedup floors are
    # process-lifetime, so a RECREATED endpoint with its own counter
    # restarting at 1 would have its real contributions silently
    # dup-ACKed below the old floor
    _push_seq = itertools.count(1)

    def __init__(self, addr: Tuple[str, int], peer: int = -1, *,
                 rank: Optional[int] = None,
                 conn: Optional[Connection] = None, **conn_kw):
        self._conn = conn if conn is not None else Connection(
            addr, peer=peer, rank=rank, **conn_kw)
        self.peer = self._conn.peer
        self._seq = TcpEndpoint._push_seq

    @property
    def connection(self) -> Connection:
        return self._conn

    @property
    def state(self) -> str:
        return self._conn.state

    # -- the sender half of the NACK/retransmit machine ---------------------

    def _transmit(self, meta: dict, frame: bytes, site: str, key: str,
                  worker: int, seq: int,
                  deadline_s: Optional[float] = None
                  ) -> Tuple[dict, bytes]:
        """Send one sealed frame, honoring NACKs (bounded retransmit
        from the SOURCE copy — never the echoed bytes), reconnect-level
        retries (the request deadline bounds them), and the caller's
        chaos sites (``bitflip:site=server_push`` et al corrupt the
        frame per attempt, exactly as the loopback hop did)."""
        budget = _integrity.max_retransmits()
        deadline = (self._conn._deadline if deadline_s is None
                    else deadline_s)
        t_end = time.monotonic() + deadline
        t0 = time.monotonic()
        nacks = 0
        attempts = 0
        while True:
            attempts += 1
            if attempts > 1:
                counters.inc("integrity.retransmit")
            wire = frame
            if _fault.ENABLED:
                wire = _fault.corrupt_bytes(site, frame)
                _fault.fire(site)
            try:
                rop, rmeta, rpayload = self._conn.request(
                    OP_PUSH, dict(meta), wire,
                    deadline_s=max(t_end - time.monotonic(), 0.001))
            except TransportConnectionLost:
                # the supervisor reconnects; retransmit from source.
                # The deadline bounds the loop — at expiry request()
                # raises AckLost, never a hang.
                if time.monotonic() >= t_end:
                    counters.inc("transport.send_deadline_trips")
                    raise _integrity.AckLost(
                        f"transport push {key!r} to peer {self.peer} "
                        f"exhausted its {deadline:.1f}s deadline across "
                        "reconnects") from None
                continue
            if rop == OP_NACK:
                nacks += 1
                get_logger().warning(
                    "transport: NACK %r seq %d worker %d (attempt %d/%d) "
                    "from peer %d: %s", key, seq, worker, nacks,
                    budget + 1, self.peer, rmeta.get("error"))
                if nacks > budget:
                    raise _integrity.IntegrityError(
                        f"frame {key!r} still corrupt after {budget} "
                        f"retransmissions: {rmeta.get('error')}")
                continue
            if rop == OP_ERR:
                raise _map_remote_error(rmeta)
            dt = time.monotonic() - t0
            # Step attribution + causal tracing: this is the step's
            # "wire" component, now covering a REAL network hop.
            from ..common.telemetry import attribution
            attribution.add("wire", dt * 1e3)
            ctx = _tracing.current()
            if ctx is not None:
                tr = _tracing.tracer()
                if tr.active:
                    tr.record_traced(ctx.trace_id, f"wire:{site}",
                                     f"wire/{site}", t0, t0 + dt, key=key,
                                     worker=worker, seq=seq,
                                     peer=self.peer, attempts=attempts)
                    tr.flow(ctx.trace_id, "t", f"wire/{site}", t0)
            return rmeta, rpayload

    def _request_verified(self, op: int, meta: dict,
                          deadline_s: Optional[float] = None
                          ) -> Tuple[dict, Any]:
        """Pull-type request whose REPLY carries sealed payload(s):
        verify on receive, treat corruption as a NACK (bounded retry of
        the whole request), and retry across a reconnect — reads are
        idempotent, so a connection lost mid-pull must not surface to
        the caller while its deadline still has budget."""
        budget = _integrity.max_retransmits()
        deadline = (self._conn._deadline if deadline_s is None
                    else deadline_s)
        t_end = time.monotonic() + deadline
        attempt = 0
        while True:
            attempt += 1
            try:
                rop, rmeta, rpayload = self._conn.request(
                    op, dict(meta),
                    deadline_s=max(t_end - time.monotonic(), 0.001))
            except TransportConnectionLost:
                if time.monotonic() >= t_end:
                    counters.inc("transport.send_deadline_trips")
                    raise _integrity.AckLost(
                        f"pull (op {op}) from peer {self.peer} exhausted "
                        f"its {deadline:.1f}s deadline across "
                        "reconnects") from None
                continue
            if rop == OP_ERR:
                raise _map_remote_error(rmeta)
            try:
                if op == OP_STATE:
                    return rmeta, rpayload
                value, _env = _integrity.open_array(rpayload)
                return rmeta, value
            except _integrity.IntegrityError:
                counters.inc("integrity.crc_reject")
                if attempt > budget:
                    raise
                counters.inc("integrity.retransmit")

    # -- Endpoint API -------------------------------------------------------

    def push(self, key, value, worker_id, num_workers, mepoch=None):
        seq = next(self._seq)
        frame = _integrity.seal_array(_host(value), key=key, seq=seq,
                                      worker=worker_id)
        self._transmit({"hop": "server_push", "num_workers": num_workers,
                        "mepoch": mepoch}, frame, "server_push", key,
                       worker_id, seq)

    def push_compressed(self, key, data, worker_id, num_workers,
                        mepoch=None):
        seq = next(self._seq)
        frame = _integrity.seal_bytes(bytes(data), key=key, seq=seq,
                                      worker=worker_id)
        self._transmit({"hop": "server_push_wire",
                        "num_workers": num_workers, "mepoch": mepoch},
                       frame, "server_push", key, worker_id, seq)

    def push_delta(self, key, delta, mepoch=None, worker_id=0, seq=None):
        token = seq if seq is not None else next(self._seq)
        frame = _integrity.seal_array(_host(delta), key=key,
                                      seq=token, worker=worker_id)
        rmeta, _ = self._transmit({"hop": "kv", "mepoch": mepoch}, frame,
                                  "kv_push", key, worker_id, token)
        return rmeta.get("version", -1)

    def push_delta_wire(self, key, data, mepoch=None, worker_id=0,
                        seq=None):
        token = seq if seq is not None else next(self._seq)
        frame = _integrity.seal_bytes(bytes(data), key=key, seq=token,
                                      worker=worker_id)
        rmeta, _ = self._transmit({"hop": "kv_wire", "mepoch": mepoch},
                                  frame, "kv_push", key, worker_id, token)
        return rmeta.get("version", -1)

    def pull(self, key, timeout=None):
        return self.pull_versioned(key, timeout)[0]

    def pull_versioned(self, key, timeout=None):
        # the server parks the pull until the merge round completes, so
        # the request deadline must cover the caller's timeout — and the
        # server-side park must be bounded too (an unbounded park leaks
        # the answering thread long after this client gave up)
        deadline = self._conn._deadline
        if timeout is not None:
            deadline = max(deadline, timeout + 5.0)
        meta, value = self._request_verified(
            OP_SERVER_PULL,
            {"key": key,
             "timeout": timeout if timeout is not None else deadline},
            deadline_s=deadline)
        return np.array(value, copy=True), meta.get("version", -1)

    def kv_pull(self, key):
        rmeta, value = self._request_verified(OP_KV_PULL, {"key": key})
        return np.array(value, copy=True), rmeta.get("version", -1)

    def pull_state(self):
        _meta, payload = self._request_verified(OP_STATE, {})
        from ..utils.checkpoint import unpack_state
        return unpack_state(payload)

    def close(self, drain: bool = True):
        with _endpoints_lock:
            for r, ep in list(_endpoints.items()):
                if ep is self:
                    del _endpoints[r]
        self._conn.close(drain=drain)


def _map_remote_error(meta: dict) -> BaseException:
    kind = meta.get("kind", "")
    msg = meta.get("error", "remote error")
    if kind == "TimeoutError":
        return TimeoutError(msg)
    if kind in ("RuntimeError", "KeyError", "ValueError"):
        return {"RuntimeError": RuntimeError, "KeyError": KeyError,
                "ValueError": ValueError}[kind](msg)
    return TransportRemoteError(f"{kind}: {msg}")


# -- sharded routing --------------------------------------------------------


class ShardedClient:
    """Routes keys across N server endpoints by the SAME hash space the
    reference uses (``server/sharding.py``): every process derives the
    identical key→shard map (``key_to_int`` covers string serving
    keys), so two workers can never split one key's history across two
    servers — the silent double-sum a divergent router would cause."""

    def __init__(self, endpoints: Sequence[Endpoint], assigner=None):
        from ..server.sharding import ServerAssigner
        self.endpoints = list(endpoints)
        if not self.endpoints:
            raise ValueError("ShardedClient needs at least one endpoint")
        self.assigner = (assigner if assigner is not None
                         else ServerAssigner(num_servers=len(self.endpoints)))

    def endpoint_for(self, key) -> Endpoint:
        return self.endpoints[self.assigner.write_target(key)]

    def push(self, key, value, worker_id, num_workers, mepoch=None):
        return self.endpoint_for(key).push(key, value, worker_id,
                                           num_workers, mepoch=mepoch)

    def push_delta(self, key, delta, **kw):
        return self.endpoint_for(key).push_delta(key, delta, **kw)

    def push_delta_wire(self, key, data, **kw):
        return self.endpoint_for(key).push_delta_wire(key, data, **kw)

    def pull(self, key, timeout=None):
        return self.endpoint_for(key).pull(key, timeout=timeout)

    def kv_pull(self, key):
        return self.endpoint_for(key).kv_pull(key)

    def close(self):
        for ep in self.endpoints:
            ep.close()


# -- host map / module-level plumbing ---------------------------------------

_servers: Dict[int, TransportServer] = {}
_servers_lock = threading.Lock()
# endpoint_to()'s per-peer cache (TCP only; loopbacks are stateless)
_endpoints: Dict[int, TcpEndpoint] = {}
_endpoints_lock = threading.Lock()


def transport_host_map() -> List[Tuple[str, Optional[int]]]:
    """``BYTEPS_TRANSPORT_HOSTS`` parsed into per-rank ``(host, port)``
    entries (port None = derive from the port base) — the data-plane
    analog of the membership bus's host map."""
    from ..common.config import get_config
    out: List[Tuple[str, Optional[int]]] = []
    for entry in get_config().transport_hosts.split(","):
        entry = entry.strip()
        if not entry:
            continue
        if ":" in entry:
            host, port_s = entry.rsplit(":", 1)
            out.append((host, int(port_s)))
        else:
            out.append((entry, None))
    return out


def transport_addr(rank: int) -> Tuple[str, int]:
    """Where rank ``rank``'s transport server listens: the host map
    entry when configured, else ``127.0.0.1:(port_base + rank)``.
    Raises with the knob names when neither is configured — a silent
    wrong-port default would look exactly like a partition."""
    from ..common.config import get_config
    cfg = get_config()
    hosts = transport_host_map()
    if rank < len(hosts):
        host, port = hosts[rank]
        if port is None:
            if not cfg.transport_port_base:
                raise ValueError(
                    f"BYTEPS_TRANSPORT_HOSTS entry for rank {rank} has no "
                    "port and BYTEPS_TRANSPORT_PORT_BASE is unset")
            port = cfg.transport_port_base + rank
        return host, port
    if not cfg.transport_port_base:
        raise ValueError(
            f"no transport address for rank {rank}: set "
            "BYTEPS_TRANSPORT_HOSTS (per-rank host[:port] list) or "
            "BYTEPS_TRANSPORT_PORT_BASE (rank's port = base + rank)")
    return "127.0.0.1", cfg.transport_port_base + rank


def serve(rank: Optional[int] = None, host: Optional[str] = None,
          port: Optional[int] = None, **attach) -> TransportServer:
    """Start (or return) THIS process's transport server, listening at
    its host-map/port-base address, and attach local receivers
    (``engine=``, ``kv=``, ``state_provider=``)."""
    from ..common.config import get_config
    cfg = get_config()
    rank = cfg.host_id if rank is None else int(rank)
    # check-and-create under ONE lock hold: two concurrent callers
    # racing past a split check would both bind (EADDRINUSE on a fixed
    # port; a silently leaked listener + orphaned peers on an ephemeral
    # one)
    with _servers_lock:
        srv = _servers.get(rank)
        if srv is not None:
            return srv.attach(**attach)
        if host is None or port is None:
            try:
                mhost, mport = transport_addr(rank)
            except ValueError:
                mhost, mport = "127.0.0.1", 0
            host = mhost if host is None else host
            port = mport if port is None else port
        srv = TransportServer(host=host, port=port, rank=rank, **attach)
        _servers[rank] = srv
    return srv


def local_server(rank: Optional[int] = None) -> Optional[TransportServer]:
    from ..common.config import get_config
    rank = get_config().host_id if rank is None else int(rank)
    with _servers_lock:
        return _servers.get(rank)


def endpoint_to(rank: int, **conn_kw) -> Endpoint:
    """The one routing decision: an :class:`Endpoint` to ``rank`` — the
    in-process loopback when the target is THIS process's registered
    server (same-process fast path: no socket, no serialization, the
    loopback integrity semantics), the supervised TCP path otherwise.

    TCP endpoints are CACHED per peer: every call returns the same
    supervised connection (``conn_kw`` only applies when the cached
    entry is created or has been closed) — a fresh endpoint per call
    would leak a supervisor thread pair each time.  ``close()`` evicts
    the cache entry."""
    from ..common.config import get_config
    if rank == get_config().host_id:
        srv = local_server(rank)
        if srv is not None:
            return LoopbackEndpoint(engine=srv.engine, kv=srv.kv,
                                    state_provider=srv.state_provider)
    with _endpoints_lock:
        ep = _endpoints.get(rank)
        if ep is not None and ep.state != DEAD:
            return ep
        ep = TcpEndpoint(transport_addr(rank), peer=rank, **conn_kw)
        _endpoints[rank] = ep
        return ep


def _reset_for_tests() -> None:
    with _endpoints_lock:
        eps = list(_endpoints.values())
        _endpoints.clear()
    for ep in eps:
        ep.close(drain=False)
    with _servers_lock:
        servers = list(_servers.values())
        _servers.clear()
    for srv in servers:
        srv.close()
    # directly-constructed Connections are kept alive by their own
    # supervisor threads even after their owner is dropped — the weak
    # registry still sees them, so a test cannot leak reconnect loops
    # into its neighbors' thread/gauge baselines
    for conn in list(_connections):
        if conn.state != DEAD:
            try:
                conn.close(drain=False, timeout=0.5)
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass
    _publish_conn_gauges()
