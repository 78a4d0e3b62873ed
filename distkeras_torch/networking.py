"""Networking — the parameter-server transport between processes; the
port of :mod:`distkeras_tpu.networking`.

Each process runs its workers against a :class:`RemoteParameterServer`
proxy speaking a framed msgpack protocol to a
:class:`ParameterServerService` that wraps the real center on its owner.
The wire is the reference's byte for byte (``docs/PROTOCOL.md``): an
8-byte big-endian length, then a msgpack payload in flax's encoding
(:mod:`distkeras_torch.utils.serde`), so a JAX client talks to a port
service and a port client to a JAX service.

- **msgpack, not pickle**: no code runs on either end of the socket.
- **native data plane**: framing and the full-buffer send/recv loops run
  in C (``native/dk_transport.c``, built by ``native/build.py``) through
  ctypes, which releases the GIL for the whole syscall loop; the
  pure-Python path runs when the library cannot be built or loaded.
- tensors cross as numpy: a device tree is fetched to the host before it
  is packed, and what arrives comes back onto the worker's device. The
  center's parameters are f32 masters; nothing bf16 goes on the wire.
"""

from __future__ import annotations

import ctypes
import os
import socket
import struct
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from distkeras_torch import telemetry
from distkeras_torch.ops import rules
from distkeras_torch.utils import serde


def _to_host(tree):
    """A tree of tensors (flat or nested) -> the nested flax layout of
    numpy arrays the wire carries."""
    return rules.unflatten({k: v.detach().cpu().numpy()
                            if isinstance(v, torch.Tensor) else np.asarray(v)
                            for k, v in rules.flatten(tree).items()})


def _to_device(tree, device=None) -> dict:
    """A tree off the wire -> a flat dict of tensors (on ``device``, else
    the host)."""
    return {k: torch.tensor(v, device=device)
            for k, v in rules.flatten(tree).items()}


# Transport-level telemetry: every framed send/recv in the process
# (PS exchanges AND serving token frames) counts here, so the scrape
# endpoint can answer "how many bytes is this host moving over DCN".
# Bound children are resolved once — the hot path is two locked adds.
_NET_FRAMES = telemetry.get_registry().counter(
    "net_frames_total", "framed-msgpack frames moved",
    labelnames=("direction",),
)
_NET_BYTES = telemetry.get_registry().counter(
    "net_bytes_total", "framed-msgpack payload bytes moved",
    labelnames=("direction",),
)
_SENT_FRAMES = _NET_FRAMES.labels(direction="sent")
_SENT_BYTES = _NET_BYTES.labels(direction="sent")
_RECV_FRAMES = _NET_FRAMES.labels(direction="received")
_RECV_BYTES = _NET_BYTES.labels(direction="received")


def _tree_nbytes(tree) -> int:
    """Host-side payload size of a tree (numpy leaves after msgpack
    restore / before serialize); scalars count as zero."""
    return sum(int(getattr(leaf, "nbytes", 0) or 0)
               for leaf in rules.flatten(tree).values())

# ---------------------------------------------------------------------------
# Native data plane (ctypes; pure-Python fallback)
# ---------------------------------------------------------------------------

# the repository's native/ (beside this package), built by native/build.py
_NATIVE_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "native", "libdk_transport.so",
)
_native = None


def _load_native():
    global _native
    if _native is not None:
        return _native
    if not os.path.exists(_NATIVE_PATH):
        try:
            import sys

            sys.path.insert(0, os.path.dirname(os.path.dirname(_NATIVE_PATH)))
            from native.build import build

            build(quiet=True)
        except Exception:
            _native = False
            return False
    try:
        lib = ctypes.CDLL(_NATIVE_PATH)
        lib.dk_send_frame.argtypes = [
            ctypes.c_int, ctypes.c_char_p, ctypes.c_uint64
        ]
        lib.dk_send_frame.restype = ctypes.c_int
        lib.dk_recv_frame_size.argtypes = [ctypes.c_int]
        lib.dk_recv_frame_size.restype = ctypes.c_int64
        lib.dk_recv_exact.argtypes = [
            ctypes.c_int, ctypes.c_char_p, ctypes.c_uint64
        ]
        lib.dk_recv_exact.restype = ctypes.c_int
        _native = lib
    except OSError:
        _native = False
    return _native


def native_transport_active() -> bool:
    return bool(_load_native())


# ---------------------------------------------------------------------------
# Fault injection (chaos-test seam)
# ---------------------------------------------------------------------------

class FaultRule:
    """One deterministic fault: fire on the ``nth`` matching frame.

    ``direction`` is ``"send"`` or ``"recv"``; ``min_bytes`` narrows
    the match to frames at least that large (how a test targets "the
    Nth weight-push chunk" without the transport understanding ops —
    push chunks dwarf every control frame). ``action``:

    - ``"drop"``  — the frame is silently not sent (the peer's
      request-level timeout is what notices);
    - ``"delay"`` — sleep ``delay_s`` before sending (jitter/stall);
    - ``"truncate"`` — send the full-length header but only half the
      payload, then shut the socket down: the peer observes a typed
      :class:`FrameError` (a torn frame, not a clean EOF);
    - ``"kill"``  — shut the connection down and raise
      ``ConnectionError`` at the caller (the connection dies exactly
      at this frame).

    ``repeat=True`` keeps firing on every later match too;
    ``prob`` (with the injector's seeded RNG) fires each match with
    that probability instead of deterministically at ``nth``.
    ``matched``/``fired`` count for assertions."""

    ACTIONS = ("drop", "delay", "truncate", "kill")

    def __init__(self, action: str, direction: str = "send",
                 nth: int = 1, min_bytes: int = 0,
                 repeat: bool = False, delay_s: float = 0.05,
                 prob: Optional[float] = None):
        if action not in self.ACTIONS:
            raise ValueError(
                f"unknown fault action {action!r}: want one of "
                f"{self.ACTIONS}"
            )
        if direction not in ("send", "recv"):
            raise ValueError(
                f"direction must be 'send' or 'recv'; got {direction!r}"
            )
        if nth < 1:
            raise ValueError(f"nth must be >= 1; got {nth}")
        self.action = action
        self.direction = direction
        self.nth = nth
        self.min_bytes = min_bytes
        self.repeat = repeat
        self.delay_s = delay_s
        self.prob = prob
        self.matched = 0
        self.fired = 0


class FaultInjector:
    """Deterministic, seeded fault injection for the framed transport.

    Installed process-wide (:func:`install_fault_injector`), consulted
    by :func:`send_frame` / :func:`recv_frame` on every frame — zero
    overhead when nothing is installed (one ``is None`` check). Rules
    are evaluated in insertion order under one lock, so concurrent
    connections observe one consistent frame count; with a fixed seed
    and a fixed frame sequence the fired faults are reproducible,
    which is what lets the chaos tests assert exact outcomes
    (replica dies at the Nth push chunk → fleet converges on
    reconnect) instead of flaky ones."""

    def __init__(self, seed: int = 0):
        import random as _random

        self.rng = _random.Random(seed)
        self.rules = []
        self._lock = threading.Lock()

    def rule(self, action: str, **kw) -> FaultRule:
        r = FaultRule(action, **kw)
        with self._lock:
            self.rules.append(r)
        return r

    def check(self, direction: str, nbytes: int):
        """First rule firing for this frame, or None. Counts matches."""
        with self._lock:
            for r in self.rules:
                if r.direction != direction or nbytes < r.min_bytes:
                    continue
                r.matched += 1
                if r.prob is not None:
                    fire = self.rng.random() < r.prob
                else:
                    fire = (r.matched == r.nth
                            or (r.repeat and r.matched >= r.nth))
                if fire:
                    r.fired += 1
                    return r
        return None


_fault_injector: Optional[FaultInjector] = None


def install_fault_injector(fi: FaultInjector):
    """Arm ``fi`` for every framed send/recv in this process (chaos
    tests only; tests must :func:`uninstall_fault_injector` in
    teardown so faults cannot leak across tests)."""
    global _fault_injector
    _fault_injector = fi


def uninstall_fault_injector():
    global _fault_injector
    _fault_injector = None


def _inject_send(sock: socket.socket, payload: bytes) -> bool:
    """Apply any armed send-side fault. Returns True when the frame
    was consumed by the fault (caller must not send it)."""
    fi = _fault_injector
    if fi is None:
        return False
    r = fi.check("send", len(payload))
    if r is None:
        return False
    if r.action == "drop":
        return True
    if r.action == "delay":
        time.sleep(r.delay_s)
        return False
    if r.action == "truncate":
        try:
            sock.sendall(struct.pack(">Q", len(payload))
                         + payload[:len(payload) // 2])
        except OSError:
            pass
        try:
            sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        raise ConnectionError(
            "fault injected: frame truncated mid-payload"
        )
    # kill
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    raise ConnectionError("fault injected: connection killed")


def _inject_recv(sock: socket.socket):
    """Apply any armed recv-side fault (kill/delay; size-blind — the
    header has not been read yet)."""
    fi = _fault_injector
    if fi is None:
        return
    r = fi.check("recv", 0)
    if r is None:
        return
    if r.action == "delay":
        time.sleep(r.delay_s)
        return
    if r.action in ("kill", "truncate", "drop"):
        try:
            sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        raise ConnectionError("fault injected: connection killed")


# ---------------------------------------------------------------------------
# Framing (reference: send_data / recv_data)
# ---------------------------------------------------------------------------

# Upper bound on an accepted frame. Without it an 8-byte length header can
# demand an allocation up to INT64_MAX before any payload arrives (ADVICE
# r1). Big enough for multi-GB model pytrees; raise explicitly if needed.
MAX_FRAME_BYTES = 1 << 33  # 8 GiB


class FrameError(ConnectionError):
    """A framed-msgpack frame violated the transport contract: its
    header announced more bytes than the caller's ``max_bytes`` limit
    (a corrupt/hostile header must not demand the allocation), or the
    peer closed the connection mid-payload (a truncated frame must not
    masquerade as a clean EOF — the pre-typed behavior, which made a
    half-written KV payload look like an orderly shutdown). The
    message always names the limit or the expected size; ``limit`` and
    ``size`` carry them structurally. Subclasses ``ConnectionError``
    so every existing drop-the-connection handler keeps working."""

    def __init__(self, msg, limit=None, size=None):
        super().__init__(msg)
        self.limit = limit
        self.size = size


def _native_usable(sock: socket.socket):
    """The C data plane does raw blocking send/recv on the fd; a Python-level
    timeout puts the fd in non-blocking mode (EAGAIN mid-frame), so only use
    the native path on fully blocking sockets."""
    if sock.gettimeout() is not None:
        return None
    return _load_native()


def send_frame(sock: socket.socket, payload: bytes):
    if _fault_injector is not None and _inject_send(sock, payload):
        return  # frame consumed by an injected drop
    lib = _native_usable(sock)
    if lib:
        rc = lib.dk_send_frame(sock.fileno(), payload, len(payload))
        if rc != 0:
            raise ConnectionError("dk_send_frame failed")
    else:
        sock.sendall(struct.pack(">Q", len(payload)) + payload)
    _SENT_FRAMES.inc()
    _SENT_BYTES.inc(len(payload))


def recv_frame(
    sock: socket.socket, max_bytes: int = MAX_FRAME_BYTES
) -> Optional[bytes]:
    """One frame, or None on clean EOF (before a header). Frames over
    ``max_bytes`` raise :class:`FrameError` naming the limit instead of
    allocating, and an EOF mid-frame raises it too (a truncated frame
    is damage, not shutdown); callers drop the connection either way."""
    if _fault_injector is not None:
        _inject_recv(sock)
    lib = _native_usable(sock)
    if lib:
        size = lib.dk_recv_frame_size(sock.fileno())
        if size < 0:
            return None
        if size > max_bytes:
            raise FrameError(
                f"frame of {size} bytes exceeds max_bytes={max_bytes}",
                limit=max_bytes, size=size,
            )
        buf = ctypes.create_string_buffer(size)
        if lib.dk_recv_exact(sock.fileno(), buf, size) != 0:
            raise FrameError(
                f"truncated frame: peer closed mid-payload "
                f"({size} bytes expected)", size=size,
            )
        _RECV_FRAMES.inc()
        _RECV_BYTES.inc(size)
        return buf.raw
    header = _recv_exact_py(sock, 8)
    if header is None:
        return None
    (size,) = struct.unpack(">Q", header)
    if size > max_bytes:
        raise FrameError(
            f"frame of {size} bytes exceeds max_bytes={max_bytes}",
            limit=max_bytes, size=size,
        )
    data = _recv_exact_py(sock, size)
    if data is None:
        # EOF between a complete header and its payload: a torn frame,
        # not a clean close — the typed error lets callers distinguish
        raise FrameError(
            f"truncated frame: peer closed mid-payload "
            f"({size} bytes expected)", size=size,
        )
    _RECV_FRAMES.inc()
    _RECV_BYTES.inc(size)
    return data


def _recv_exact_py(sock: socket.socket, n: int) -> Optional[bytes]:
    chunks = []
    got = 0
    while got < n:
        chunk = sock.recv(n - got)
        if not chunk:
            return None
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def send_msg(sock: socket.socket, obj: Any):
    """Tree/dict -> msgpack frame (reference: send_data, minus pickle)."""
    send_frame(sock, serde.packb(obj))


def recv_msg(sock: socket.socket, max_bytes: int = MAX_FRAME_BYTES) -> Any:
    data = recv_frame(sock, max_bytes=max_bytes)
    if data is None:
        return None
    return serde.unpackb(data)


def connect(host: str, port: int, disable_nagle: bool = True) -> socket.socket:
    """Reference: networking.py · connect — TCP with Nagle off for the
    small-framed control path."""
    sock = socket.create_connection((host, port))
    if disable_nagle:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return sock


# ---------------------------------------------------------------------------
# Parameter-server service + remote proxy
# ---------------------------------------------------------------------------

class ParameterServerService:
    """Expose a :class:`~distkeras_torch.parameter_servers.ParameterServer`
    over TCP (reference: parameter_servers.py · SocketParameterServer's
    accept loop + per-connection handler threads).

    Hardening over the reference (ADVICE r1): binds loopback unless an
    explicit host is given, supports a shared-secret handshake (clients
    must open with ``{"op": "auth", "token": ...}`` when ``secret`` is
    set), caps frame sizes, replies ``{"error": ...}`` on per-op failures
    instead of dropping the connection, and prunes finished handler
    threads.

    Telemetry: every op records latency into
    ``ps_op_latency_ms{op=...}`` (plus op counts and payload bytes) in
    the service's :class:`~distkeras_torch.telemetry.MetricRegistry`, and
    a ``"trace"`` id carried on the message (the remote proxy attaches
    one per call) yields a ``ps.<op>`` span in the tracer. Two read-only
    ops expose both over the wire: ``{"op": "stats"}`` →
    ``{"num_updates", "metrics": registry.collect()}`` and
    ``{"op": "trace_dump", "trace"?, "limit"?}`` → ``{"spans": [...]}``.
    """

    def __init__(self, ps, host: str = "127.0.0.1", port: int = 0,
                 secret: Optional[str] = None,
                 max_frame_bytes: int = MAX_FRAME_BYTES,
                 registry: Optional[telemetry.MetricRegistry] = None,
                 tracer: Optional[telemetry.Tracer] = None):
        self.ps = ps
        self.secret = secret
        self.max_frame_bytes = max_frame_bytes
        self.registry = registry or telemetry.get_registry()
        self.tracer = tracer or telemetry.get_tracer()
        self._m_ops = self.registry.counter(
            "ps_ops_total", "parameter-server service ops handled",
            labelnames=("op",),
        )
        self._m_op_ms = self.registry.histogram(
            "ps_op_latency_ms",
            "service-side op latency: dispatch through reply (ms)",
            labelnames=("op",),
        )
        self._m_op_bytes = self.registry.counter(
            "ps_op_bytes_total",
            "pytree payload bytes moved per op (host-side nbytes)",
            labelnames=("op",),
        )
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self.port = self._sock.getsockname()[1]
        self._threads = []
        self._running = False
        # workers on other processes announce completion with 'leave';
        # a remote PROCESS announces it is fully done (final center read)
        # with a negative-id leave. The owner waits for the latter before
        # tearing the service down.
        self.remote_leaves = 0
        self.remote_done = 0
        self._leave_cond = threading.Condition()

    def start(self):
        self._running = True
        self._sock.listen(64)
        t = threading.Thread(target=self._accept_loop, daemon=True)
        t.start()
        self._threads.append(t)

    def _accept_loop(self):
        while self._running:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            t = threading.Thread(
                target=self._handle, args=(conn,), daemon=True
            )
            t.start()
            self._threads = [x for x in self._threads if x.is_alive()]
            self._threads.append(t)

    def _handle(self, conn: socket.socket):
        """Per-connection dispatch (reference: the 1-byte 'c'/'p' action
        protocol, upgraded to named ops)."""
        authed = self.secret is None
        try:
            while True:
                try:
                    msg = recv_msg(conn, max_bytes=self.max_frame_bytes)
                except Exception:  # malformed/oversized: drop this client
                    return
                if msg is None or not isinstance(msg, dict):
                    return
                op = msg.get("op")
                if not authed:
                    if op == "auth" and str(msg.get("token")) == self.secret:
                        authed = True
                        send_msg(conn, {"ok": 1})
                        continue
                    send_msg(conn, {"error": "auth required"})
                    return
                t0 = time.monotonic()
                try:
                    self._dispatch(conn, op, msg)
                except (ConnectionError, OSError):
                    raise
                except Exception as e:  # op failure: reply, keep serving
                    send_msg(conn, {"error": f"{type(e).__name__}: {e}"})
                finally:
                    ms = (time.monotonic() - t0) * 1e3
                    op_name = str(op)
                    self._m_ops.labels(op=op_name).inc()
                    self._m_op_ms.labels(op=op_name).observe(ms)
                    self.tracer.record(msg.get("trace"), f"ps.{op_name}",
                                       t0, ms)
        except (ConnectionError, OSError):
            return
        finally:
            conn.close()

    def _dispatch(self, conn: socket.socket, op, msg: dict):
        # the center lives on its device; this service is the host
        # boundary, so every outgoing tree crosses through pull_host /
        # _to_host before serialization, and every incoming one goes to
        # the PS as numpy (the PS puts it on the center's device)
        if op == "pull":
            value = self.ps.pull_host()
            self._m_op_bytes.labels(op="pull").inc(_tree_nbytes(value))
            send_msg(conn, {"value": value})
        elif op == "pull_with_clock":
            value, clock = self.ps.pull_with_clock()
            value = _to_host(value)
            self._m_op_bytes.labels(op="pull_with_clock").inc(
                _tree_nbytes(value)
            )
            send_msg(conn, {"value": value, "clock": clock})
        elif op == "commit":
            self._m_op_bytes.labels(op="commit").inc(
                _tree_nbytes(msg["delta"])
            )
            self.ps.commit(
                msg["delta"], worker=int(msg.get("worker", 0)),
                worker_clock=int(msg.get("clock", 0)),
            )
            send_msg(conn, {"ok": 1})
        elif op == "commit_and_wait":
            self._m_op_bytes.labels(op="commit_and_wait").inc(
                _tree_nbytes(msg["params"])
            )
            center = self.ps.commit_and_wait(
                msg["params"], worker=int(msg.get("worker", 0))
            )
            send_msg(conn, {"value": _to_host(center)})
        elif op == "leave":
            wid = int(msg.get("worker", 0))
            if wid < 0:
                # process-level done sentinel: the remote process has read
                # its final center and will make no further calls
                with self._leave_cond:
                    self.remote_done += 1
                    self._leave_cond.notify_all()
            else:
                self.ps.leave(wid)
                with self._leave_cond:
                    self.remote_leaves += 1
                    self._leave_cond.notify_all()
            send_msg(conn, {"ok": 1})
        elif op == "num_updates":
            send_msg(conn, {"value": self.ps.num_updates})
        elif op == "stats":
            send_msg(conn, {
                "num_updates": self.ps.num_updates,
                "metrics": self.registry.collect(),
            })
        elif op == "trace_dump":
            send_msg(conn, {"spans": self.tracer.dump(
                trace=(None if msg.get("trace") is None
                       else int(msg["trace"])),
                limit=(None if msg.get("limit") is None
                       else int(msg["limit"])),
            )})
        else:
            send_msg(conn, {"error": f"unknown op {op!r}"})

    def wait_for_remote_done(self, count: int, timeout: float = 600.0) -> bool:
        """Block until ``count`` remote PROCESSES have announced they are
        fully done (final center read) — the owner calls this before
        stopping the service so no process loses the center mid-exchange."""
        with self._leave_cond:
            return self._leave_cond.wait_for(
                lambda: self.remote_done >= count, timeout=timeout
            )

    def stop(self):
        self._running = False
        try:
            self._sock.close()
        except OSError:
            pass


class RemoteParameterServer:
    """Client proxy with the same method surface as a local
    :class:`ParameterServer`, so workers are transport-agnostic
    (reference: workers.py · NetworkWorker.connect/pull/push)."""

    def __init__(self, host: str, port: int, secret: Optional[str] = None,
                 connect_timeout: float = 120.0):
        self.host, self.port = host, port
        self.secret = secret
        # processes come up skewed (the owner may still be compiling when
        # a peer's first worker pulls) — retry refused connections until
        # the service is listening
        self.connect_timeout = connect_timeout
        self._local = threading.local()

    def _connect_with_retry(self) -> socket.socket:
        deadline = time.monotonic() + self.connect_timeout
        while True:
            try:
                return connect(self.host, self.port)
            except (ConnectionRefusedError, OSError):
                if time.monotonic() >= deadline:
                    raise
                time.sleep(0.2)

    def _sock(self) -> socket.socket:
        # one connection per worker thread, mirroring the reference's
        # per-executor connection
        if not hasattr(self._local, "sock"):
            sock = self._connect_with_retry()
            if self.secret is not None:
                send_msg(sock, {"op": "auth", "token": self.secret})
                reply = recv_msg(sock)
                if not (isinstance(reply, dict) and reply.get("ok")):
                    sock.close()
                    raise ConnectionError(
                        "parameter server rejected auth handshake"
                    )
            self._local.sock = sock
        return self._local.sock

    def _call(self, msg: dict) -> dict:
        # allocate a trace id per op and send it along: the service
        # records the matching ps.<op> span server-side, so one id links
        # both halves of the round trip
        tracer = telemetry.get_tracer()
        tid = msg.setdefault("trace", tracer.new_trace_id())
        sock = self._sock()
        t0 = time.monotonic()
        send_msg(sock, msg)
        reply = recv_msg(sock)
        tracer.record(tid, f"ps.rpc.{msg.get('op')}", t0,
                      (time.monotonic() - t0) * 1e3)
        if reply is None:
            raise ConnectionError("parameter server closed the connection")
        if "error" in reply:
            raise RuntimeError(reply["error"])
        return reply

    # -- ParameterServer surface -------------------------------------------

    def start(self):
        pass

    def stop(self):
        pass

    def pull(self, device=None) -> dict:
        """The center as a flat dict of tensors (on ``device``, else the
        host)."""
        return _to_device(self._call({"op": "pull"})["value"], device)

    def pull_with_clock(self, device=None):
        r = self._call({"op": "pull_with_clock"})
        return _to_device(r["value"], device), int(r["clock"])

    def get_model(self) -> dict:
        """The center as numpy in the flax layout."""
        return self._call({"op": "pull"})["value"]

    def commit(self, delta, worker: int = 0, worker_clock: int = 0):
        self._call({"op": "commit", "delta": _to_host(delta),
                    "worker": worker, "clock": worker_clock})

    def commit_and_wait(self, params, worker: int = 0, device=None):
        value = self._call(
            {"op": "commit_and_wait", "params": _to_host(params),
             "worker": worker}
        )["value"]
        return _to_device(value, device)

    def leave(self, worker: int = 0):
        try:
            self._call({"op": "leave", "worker": worker})
        except (ConnectionError, RuntimeError):
            pass

    @property
    def num_updates(self) -> int:
        return int(self._call({"op": "num_updates"})["value"])

    def stats(self) -> dict:
        """Service-side update count + metric-registry snapshot."""
        return dict(self._call({"op": "stats"}))

    def trace_dump(self, trace: Optional[int] = None,
                   limit: Optional[int] = None) -> list:
        """Service-side span records (optionally one trace id)."""
        # "trace" doubles as this op's filter, so pin it explicitly —
        # otherwise _call's auto-attached span id would filter the dump
        # down to (almost) nothing
        msg: dict = {"op": "trace_dump",
                     "trace": None if trace is None else int(trace)}
        if limit is not None:
            msg["limit"] = int(limit)
        return list(self._call(msg)["spans"])

    def close(self):
        if hasattr(self._local, "sock"):
            self._local.sock.close()
