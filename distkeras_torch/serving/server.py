"""TCP token-streaming front-end for the continuous-batching engine —
the port of :mod:`distkeras_tpu.serving.server`, on the same wire: a
client of either package drives a server of either package.

Speaks the framed-msgpack transport this framework already uses
(:mod:`distkeras_torch.networking` ``send_msg``/``recv_msg``), with the
same accept-loop shape as :class:`ParameterServerService`: one handler
thread per connection, loopback bind by default, per-op error replies
instead of dropped connections. The engine steps on its own loop thread
(:meth:`~distkeras_torch.serving.engine.ServingEngine.serve_forever`, on
the engine's card); handler threads submit (the scheduler is locked),
read host-side counters (``stats``, the registry, the tracer, the
flight ring), and marshal everything that touches the pool, the prefix
index, the caches or the weights through
:meth:`~distkeras_torch.serving.engine.ServingEngine.control` (the named
control calls, onto the loop thread). Array leaves on the wire (pushed
weights, KV blocks) are numpy in flax's msgpack encoding
(:mod:`distkeras_torch.utils.serde`).

A tensor-parallel engine (``ServingEngine(mesh=make_mesh({"model":
n}))``, one process a rank) is served by the same script on every rank:
each builds the same engine and the same ``LMServer(engine)``. Rank 0
(the leader) binds the socket and serves this wire unchanged; its loop
is the engine's lock-step loop, whose step records carry every
admission and named control call to the other ranks. Every other rank
(a follower) binds nothing (``port`` is None) and runs only its engine's
follower loop, which ends when the leader stops; a follower's script
waits for that with :meth:`LMServer.join`.

Protocol (all frames are msgpack dicts):

  client → server
    {"op": "generate", "prompt": [ids], "max_new_tokens": n,
     "temperature"?, "seed"?, "eos_id"?, "top_k"?, "top_p"?,
     "deadline_s"?, "tier"?, "trace"?: tid, "parent_span"?: name}
    {"op": "stats"}
    {"op": "metrics"}                         # registry snapshot
    {"op": "trace_dump", "trace"?: tid, "limit"?: n}
    {"op": "chrome_trace", "trace"?: tid, "limit"?: n}
                                              # spans as Chrome
                                              # trace-event JSON
    {"op": "flight", "last"?: n}              # flight-recorder ticks
    {"op": "alerts"}                          # SLO monitor state
    {"op": "timeseries", "last"?: n}          # metric-history ring
                                              # (periodic registry
                                              # deltas: rates, gauge
                                              # samples, windowed
                                              # percentiles)
    {"op": "events", "last"?: n}              # control-plane event
                                              # journal (drain/undrain,
                                              # reconfigure, weight
                                              # swaps, ...)
    {"op": "drain"}                           # close admissions (graceful);
                                              # with "undrain": 1 reopen
                                              # them (rolling updates)
    {"op": "reconfigure", "role": r}          # flip the replica's
                                              # advertised role (mixed/
                                              # prefill/decode) between
                                              # ticks — the fleet
                                              # controller's drain →
                                              # reconfigure → undrain
                                              # rebalancing primitive
    {"op": "push_weights", "seq": i, "n": k, "chunk": bytes,
     "version"?: v}                           # live weight update: one
                                              # serialized variables
                                              # blob chunked across k
                                              # frames; the last chunk
                                              # validates + atomically
                                              # swaps at the tick
                                              # boundary
    {"op": "export_kv", "prompt": [ids]}      # gather the cached KV
                                              # blocks covering the
                                              # prompt's prefix, for
                                              # migration to a peer
    {"op": "import_kv", "prompt": [ids], "blocks": [[leaf arrays]]}
                                              # install migrated KV
                                              # blocks into this
                                              # replica's prefix cache

  server → client
    {"ok": 1, "id": rid, "trace": tid}        # generate accepted
    {"ok": 0, "error": msg}                   # rejected (hard failure)
    {"ok": 0, "error": "overloaded", "queue_depth": n}
                                              # queue backpressure (typed:
                                              # ServingClient raises
                                              # OverloadedError — routers
                                              # spill, callers back off)
    {"ok": 0, "error": "draining"}            # admissions closed (typed:
                                              # DrainingError)
    {"ok": 0, "error": "unknown_op", "op": op}
                                              # unrecognized op (typed:
                                              # UnknownOpError — the
                                              # terminal dispatch arm, so
                                              # the handled op set is
                                              # closed and checkable)
    {"ok": 0, "error": "weight_push", "detail": msg}
                                              # pushed weights refused
                                              # before any swap (typed:
                                              # WeightPushError naming
                                              # the first mismatched
                                              # leaf)
    {"id": rid, "t": tok}                     # one streamed token
    {"id": rid, "done": 1, "reason": r, "n": k}   # stream end
    {"ok": 1, "stats": {...}}                 # stats reply
    {"ok": 1, "metrics": {...}}               # MetricRegistry.collect()
    {"ok": 1, "spans": [...]}                 # Tracer.dump()
    {"ok": 1, "chrome": {"traceEvents": [...]}}   # Perfetto-loadable
    {"ok": 1, "flight": {"meta":..,"ticks":[..]}}   # FlightRecorder ring
    {"ok": 1, "alerts": [...]}                # SloMonitor.alerts()
    {"ok": 1, "timeseries": {"meta":..,"points":[..]}}
                                              # TimeSeriesStore ring
    {"ok": 1, "events": {"meta":..,"events":[..]}}   # EventJournal ring
    {"ok": 1, "draining": 1, "active": a, "queued": q}   # drain accepted
    {"ok": 1, "role": r}                      # reconfigure applied
    {"ok": 1, "received": i}                  # push_weights chunk i < k-1
    {"ok": 1, "applied": 1, "version": v, "swap_ms": ms}
                                              # push_weights final chunk:
                                              # the swap is live
    {"ok": 1, "tokens": t, "blocks": [...]}   # export_kv reply (tokens
                                              # 0 = nothing cached —
                                              # the caller falls back
                                              # to seeded replay)
    {"ok": 1, "imported": k, "tokens": t, "mode": m}   # import_kv reply

The ``trace`` id in the generate ack is the request's telemetry trace id
(allocated at admission, OR propagated verbatim when the submit carried
a ``trace`` field — how a router keeps one fleet-wide id across the
client → router → replica hops; ``parent_span`` names the upstream span
that submitted, recorded on the queued span as the cross-process link):
``trace_dump`` filtered to it returns the full span chain
(queued/prefill/decode/finish + this connection's stream span), and
``chrome_trace`` the same spans as Chrome trace-event JSON for
ui.perfetto.dev (without a trace id, the engine loop's phase spans too,
in a lane of their own: its tick).

Tokens stream as the engine emits them — a connection may hold many
in-flight requests, so frames are tagged with the request id and the
client demultiplexes. Token pushes run in per-request pump threads fed by
the request's :class:`TokenStream`, so a slow client never stalls the
engine loop; a per-connection lock keeps frames whole.
"""

from __future__ import annotations

import queue as _queue
import socket
import threading
from typing import Any, Dict, List, Optional, Tuple

from distkeras_torch.networking import connect, recv_msg, send_msg
from distkeras_torch.serving.engine import ServingEngine
from distkeras_torch.serving.scheduler import DrainingError, QueueFullError
from distkeras_torch.serving.weights import (
    WeightPushError,
    chunk_payload,
    deserialize_weights,
    serialize_weights,
)
from distkeras_torch.telemetry.chrome import to_chrome_trace
from distkeras_torch.telemetry.timeseries import TimeSeriesStore

# serving frames are small (one token or one prompt); cap accordingly
MAX_SERVE_FRAME_BYTES = 1 << 24  # 16 MiB

# terminal stream-frame reason a ServingClient synthesizes when the
# connection dies mid-stream (never sent by a server, whose genuine
# finish reasons are eos/length/expired/error) — consumers that see it
# know the stream was cut, not completed; the router's failover keys on
# exactly this sentinel to replay the request on a surviving replica
DISCONNECTED = "disconnected"


def shutdown_close(sock: socket.socket):
    """Close a socket that other threads may be blocked reading:
    ``shutdown`` first, so the FIN goes out and blocked ``recv`` calls
    unblock immediately — a bare ``close()`` while another thread sits
    in ``recv`` leaves the file description held by the blocked
    syscall, and the peer never sees EOF."""
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


class OverloadedError(RuntimeError):
    """The server refused a submit under queue backpressure (the
    engine's :class:`~distkeras_torch.serving.scheduler.QueueFullError`
    surfaced over the wire as a structured ``overloaded`` reply).
    Spill-worthy: a router retries on another replica, a direct caller
    backs off and resubmits. ``queue_depth`` carries the server's queue
    depth at rejection time when the server reported it."""

    def __init__(self, msg: str, queue_depth=None):
        super().__init__(msg)
        self.queue_depth = queue_depth


class UnknownOpError(RuntimeError):
    """The server (or router) did not recognize the requested op — the
    typed reply of the terminal dispatch arm. Distinct from a hard
    failure: the connection is healthy, the protocol surface simply
    does not include the op (a version-skewed client, a typo'd op
    name). ``op`` carries the rejected op name as the server echoed
    it."""

    def __init__(self, msg: str, op=None):
        super().__init__(msg)
        self.op = op


class ServingConnectionError(ConnectionError, RuntimeError):
    """The TCP connection to an LM server could not be established or
    died mid-use. Always names the ``host:port`` it concerns, so fleet
    logs point at the replica, not just "connection reset". Inherits
    ``RuntimeError`` as well: pre-typed callers caught RuntimeError
    from ``_call`` rejections, and a dead connection must not slip past
    them."""


class LMServer:
    """Serve a :class:`ServingEngine` over TCP. ``start()`` spins the
    accept loop and the engine's own loop thread; ``stop()`` winds both
    down. Binds loopback unless an explicit host is given.

    ``slo`` attaches an :class:`~distkeras_torch.telemetry.SloMonitor`
    (started/stopped with the server; served by the ``alerts`` op), and
    ``watchdog_timeout_s`` arms the engine's stall watchdog — if the
    loop thread stops ticking while work is pending, a flight
    postmortem is dumped.

    ``timeseries`` controls the metric-history collector (the
    ``timeseries`` op): True (the default) samples the engine registry
    into an own :class:`~distkeras_torch.telemetry.TimeSeriesStore` on a
    self-timed collector thread, a store instance shares one, and
    None/False disables it.

    Over a tensor-parallel engine only rank 0 serves (see the module
    docstring); on every other rank the server has no socket, SLO
    monitor, time-series collector or watchdog, ``start()`` starts the
    follower loop, and ``stop()`` / :meth:`join` wait for the leader to
    end it."""

    def __init__(self, engine: ServingEngine, host: str = "127.0.0.1",
                 port: int = 0,
                 max_frame_bytes: int = MAX_SERVE_FRAME_BYTES,
                 slo=None, watchdog_timeout_s: Optional[float] = None,
                 timeseries=True):
        self.engine = engine
        # a tp follower serves nothing: it follows the leader's loop
        self.leader = engine.tp_rank == 0
        self.slo = slo if self.leader else None
        if not self.leader:
            self.timeseries: Optional[TimeSeriesStore] = None
        elif timeseries is True:
            self.timeseries = TimeSeriesStore(registry=engine.registry)
        else:
            self.timeseries = timeseries or None
        self._watchdog = (engine.watchdog(timeout_s=watchdog_timeout_s)
                          if watchdog_timeout_s is not None and self.leader
                          else None)
        self.max_frame_bytes = max_frame_bytes
        self._sock: Optional[socket.socket] = None
        self.port: Optional[int] = None
        if self.leader:
            self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self._sock.bind((host, port))
            self.port = self._sock.getsockname()[1]
        # the loop thread's error, once it ended with one
        self.loop_error: Optional[BaseException] = None
        self._loop: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        # live client connections: stop() closes them so handler
        # threads blocked in recv unblock immediately (clients see EOF
        # at stop time, not whenever they next send a frame)
        self._conns: List[socket.socket] = []
        self._conns_lock = threading.Lock()
        # critical-path "stream" phase: the delivery tail after the
        # engine finished decoding — observed per request by the pump,
        # into the same family the engine fills its phases into
        self._m_cp_stream = engine.registry.histogram(
            "serving_request_critical_path_ms",
            "per-request time attribution by critical-path phase (ms)",
            labelnames=("phase",),
        ).labels(phase="stream")

    def start(self) -> "LMServer":
        self._loop = threading.Thread(target=self._engine_loop, daemon=True)
        targets = [self._loop]
        if self.leader:
            self._sock.listen(64)
            targets.insert(0, threading.Thread(target=self._accept_loop,
                                               daemon=True))
        for t in targets:
            t.start()
            self._threads.append(t)
        if self.slo is not None:
            self.slo.start()
        if self._watchdog is not None:
            self._watchdog.start()
        if self.timeseries is not None:
            self.timeseries.start()
        return self

    def stop(self, timeout: float = 10.0):
        if not self.leader:
            # a follower cannot stop alone: its loop ends with the
            # leader's
            self.join(timeout)
            return
        self._stop.set()
        if self._watchdog is not None:
            self._watchdog.stop()
        if self.slo is not None:
            self.slo.stop()
        if self.timeseries is not None:
            self.timeseries.stop()
        # shutdown-first on the listener too: a bare close() leaves the
        # accept loop blocked in accept() holding the file description,
        # and its join below would burn the full timeout
        shutdown_close(self._sock)
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            shutdown_close(c)
        for t in self._threads:
            t.join(timeout)

    def join(self, timeout: Optional[float] = None) -> bool:
        """Wait until the engine's loop thread has ended — on a
        tensor-parallel follower, until the leader stopped (or the loop
        failed: ``loop_error``). Returns whether it has ended."""
        if self._loop is not None:
            self._loop.join(timeout)
            return not self._loop.is_alive()
        return True

    # -- loops --------------------------------------------------------------

    def _engine_loop(self):
        try:
            self.engine.serve_forever(self._stop)
        except BaseException as e:
            self.loop_error = e
            raise

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._conns_lock:
                self._conns.append(conn)
            t = threading.Thread(
                target=self._handle, args=(conn,), daemon=True
            )
            t.start()
            self._threads = [x for x in self._threads if x.is_alive()]
            self._threads.append(t)

    # -- per-connection handler ---------------------------------------------

    @staticmethod
    def _send(conn: socket.socket, lock: threading.Lock, msg: dict):
        with lock:
            send_msg(conn, msg)

    def _pump(self, conn, lock, req):
        """Forward one request's token stream to the client."""
        import time

        n = 0
        t0 = time.monotonic()
        try:
            for tok in req.stream:
                self._send(conn, lock, {"id": req.rid, "t": int(tok)})
                n += 1
            # span before the done frame (same discipline as
            # _notify_finish): a client that saw "done" can immediately
            # trace_dump and find the stream span in the chain
            end = time.monotonic()
            self.engine.tracer.record(
                req.trace_id, "stream", t0, (end - t0) * 1e3, tokens=n,
            )
            # delivery tail: how long the pump kept running after the
            # engine finished the request (done_t is set before the
            # stream's end sentinel, so it is visible here)
            self._m_cp_stream.observe(
                max(0.0, (end - req.done_t) * 1e3)
                if req.done_t is not None else 0.0
            )
            self._send(conn, lock, {
                "id": req.rid, "done": 1,
                "reason": req.stream.finish_reason, "n": n,
            })
        except (ConnectionError, OSError):
            # client went away mid-stream: drain silently (the engine
            # finishes the request; its tokens are simply dropped)
            for _ in req.stream:
                pass
            self.engine.tracer.record(
                req.trace_id, "stream", t0,
                (time.monotonic() - t0) * 1e3, tokens=n, aborted=1,
            )

    def _handle(self, conn: socket.socket):
        lock = threading.Lock()
        pumps: List[threading.Thread] = []
        # push_weights chunk reassembly, per connection (chunks of one
        # push always ride one connection, in order)
        push_buf: dict = {}
        try:
            while not self._stop.is_set():
                try:
                    msg = recv_msg(conn, max_bytes=self.max_frame_bytes)
                except Exception:  # malformed/oversized: drop this client
                    return
                if msg is None or not isinstance(msg, dict):
                    return
                op = msg.get("op")
                try:
                    if op == "generate":
                        req = self.engine.submit(
                            prompt=[int(t) for t in msg["prompt"]],
                            max_new_tokens=int(msg["max_new_tokens"]),
                            temperature=float(msg.get("temperature", 0.0)),
                            seed=int(msg.get("seed", 0)),
                            eos_id=(None if msg.get("eos_id") is None
                                    else int(msg["eos_id"])),
                            top_k=(None if msg.get("top_k") is None
                                   else int(msg["top_k"])),
                            top_p=(None if msg.get("top_p") is None
                                   else float(msg["top_p"])),
                            deadline_s=(
                                None if msg.get("deadline_s") is None
                                else float(msg["deadline_s"])),
                            # QoS class: omitted = interactive (the
                            # expensive tier — existing clients keep
                            # their latency guarantees unchanged)
                            tier=(str(msg["tier"])
                                  if msg.get("tier") is not None
                                  else "interactive"),
                            # propagated trace context: a router (or
                            # tracing client) minted the id upstream —
                            # this replica's spans join that chain
                            trace_id=(None if msg.get("trace") is None
                                      else int(msg["trace"])),
                            parent_span=(
                                None if msg.get("parent_span") is None
                                else str(msg["parent_span"])),
                        )
                        # ack BEFORE the pump starts so the acceptance
                        # frame always precedes the first token frame
                        self._send(conn, lock, {"ok": 1, "id": req.rid,
                                                "trace": req.trace_id})
                        t = threading.Thread(
                            target=self._pump, args=(conn, lock, req),
                            daemon=True,
                        )
                        t.start()
                        pumps.append(t)
                    elif op == "stats":
                        self._send(conn, lock,
                                   {"ok": 1, "stats": self.engine.stats()})
                    elif op == "metrics":
                        self._send(conn, lock, {
                            "ok": 1,
                            "metrics": self.engine.registry.collect(),
                        })
                    elif op == "trace_dump":
                        spans = self.engine.tracer.dump(
                            trace=(None if msg.get("trace") is None
                                   else int(msg["trace"])),
                            limit=(None if msg.get("limit") is None
                                   else int(msg["limit"])),
                        )
                        self._send(conn, lock, {"ok": 1, "spans": spans})
                    elif op == "chrome_trace":
                        limit = (None if msg.get("limit") is None
                                 else int(msg["limit"]))
                        spans = self.engine.tracer.dump(
                            trace=(None if msg.get("trace") is None
                                   else int(msg["trace"])),
                            limit=limit,
                        )
                        if msg.get("trace") is None:
                            # the whole view: the loop's phase lanes too
                            spans += self.engine.tracer.phase_dump(limit)
                        self._send(conn, lock, {
                            "ok": 1, "chrome": to_chrome_trace(spans),
                        })
                    elif op == "flight":
                        fl = self.engine.flight
                        if fl is None:
                            self._send(conn, lock, {
                                "ok": 0,
                                "error": "flight recorder disabled",
                            })
                        else:
                            last = (None if msg.get("last") is None
                                    else int(msg["last"]))
                            self._send(conn, lock, {"ok": 1, "flight": {
                                "meta": fl.meta("scrape"),
                                "ticks": fl.snapshots(last=last),
                            }})
                    elif op == "alerts":
                        # no monitor attached -> no rules -> no alerts:
                        # an empty list, not an error (clients probe)
                        alerts = (self.slo.alerts()
                                  if self.slo is not None else [])
                        self._send(conn, lock,
                                   {"ok": 1, "alerts": alerts})
                    elif op == "timeseries":
                        ts = self.timeseries
                        if ts is None:
                            self._send(conn, lock, {
                                "ok": 0,
                                "error": "time-series store disabled",
                            })
                        else:
                            last = (None if msg.get("last") is None
                                    else int(msg["last"]))
                            self._send(conn, lock, {
                                "ok": 1, "timeseries": {
                                    "meta": ts.meta(),
                                    "points": ts.points(last=last),
                                }})
                    elif op == "events":
                        jr = self.engine.journal
                        last = (None if msg.get("last") is None
                                else int(msg["last"]))
                        self._send(conn, lock, {
                            "ok": 1, "events": {
                                "meta": jr.meta(),
                                "events": jr.events(last=last),
                            }})
                    elif op == "export_kv":
                        # KV-block migration, the prefill-replica half:
                        # gather the cached blocks covering this
                        # prompt's prefix. Marshalled onto the engine
                        # loop thread — pool/prefix/cache state is
                        # engine-thread-only by design
                        out = self.engine.control(
                            "export_blocks", [int(t) for t in msg["prompt"]])
                        self._send(conn, lock, {
                            "ok": 1, "tokens": out["tokens"],
                            "blocks": out["blocks"],
                        })
                    elif op == "import_kv":
                        # the decode-replica half: install migrated
                        # blocks so the next admission of this prompt
                        # hits the prefix cache
                        out = self.engine.control(
                            "import_blocks", [int(t) for t in msg["prompt"]],
                            msg["blocks"])
                        self._send(conn, lock, {
                            "ok": 1, "imported": out["imported"],
                            "tokens": out["tokens"],
                            "mode": out["mode"],
                        })
                    elif op == "drain":
                        if msg.get("undrain"):
                            # reopen admissions: the undrain half of
                            # the rolling-update primitive
                            self.engine.control("end_drain")
                            st = self.engine.stats()
                            self._send(conn, lock, {
                                "ok": 1, "draining": 0,
                                "active": st["active_slots"],
                                "queued": st["queue_depth"],
                            })
                        else:
                            # graceful drain: admissions close now;
                            # queued + in-flight streams finish under
                            # the normal loop (stats reports
                            # draining/drained progress)
                            self.engine.control("begin_drain")
                            st = self.engine.stats()
                            self._send(conn, lock, {
                                "ok": 1, "draining": 1,
                                "active": st["active_slots"],
                                "queued": st["queue_depth"],
                            })
                    elif op == "reconfigure":
                        # role rebalancing: flip the replica's
                        # advertised specialization. Marshalled onto
                        # the engine loop thread (like push_weights)
                        # so the flip lands between ticks; callers
                        # drain first — the controller's declarative
                        # drain → reconfigure → undrain primitive
                        role = self.engine.control("set_role",
                                                   str(msg["role"]))
                        self._send(conn, lock, {"ok": 1, "role": role})
                    elif op == "push_weights":
                        # live weight update: chunks accumulate per
                        # connection; the last one deserializes,
                        # validates against the live tree, and swaps
                        # atomically at the tick boundary (marshalled
                        # onto the engine loop thread — no locks touch
                        # the hot path)
                        self._op_push_weights(conn, lock, msg,
                                              push_buf)
                    else:
                        # typed terminal arm: the handled op set above
                        # is CLOSED — the wire-contract pass extracts
                        # it as exact, and clients raise UnknownOpError
                        self._send(conn, lock, {
                            "ok": 0, "error": "unknown_op",
                            "op": str(op),
                        })
                except (ConnectionError, OSError):
                    raise
                except QueueFullError:
                    # structured so clients can tell spill-worthy
                    # backpressure (retry elsewhere / later) from hard
                    # failures; depth gives routers a load signal
                    self._send(conn, lock, {
                        "ok": 0, "error": "overloaded",
                        "queue_depth": self.engine.queue_depth(),
                    })
                except DrainingError:
                    self._send(conn, lock, {"ok": 0, "error": "draining"})
                except Exception as e:
                    self._send(conn, lock, {
                        "ok": 0, "error": f"{type(e).__name__}: {e}"
                    })
        except (ConnectionError, OSError):
            return
        finally:
            # a stopping server does not wait on its pumps: the loop
            # thread is winding down, so a stream still in flight may
            # never end (the pump is a daemon blocked on it)
            for t in pumps:
                t.join(timeout=0.0 if self._stop.is_set() else 5.0)
            conn.close()
            with self._conns_lock:
                if conn in self._conns:
                    self._conns.remove(conn)

    def _op_push_weights(self, conn, lock, msg: dict, buf: dict):
        """One push_weights chunk. ``buf`` is the per-connection
        reassembly state: chunk 0 resets it, the last chunk joins,
        deserializes, and applies the swap on the engine loop thread.
        Refusals — out-of-order chunks, an undecodable payload, or a
        tree that fails validation against the live weights — answer
        the typed ``weight_push`` error code with the detail (the
        first mismatched leaf) in ``detail``; nothing is swapped."""
        seq = int(msg["seq"])
        n = int(msg["n"])
        if seq == 0:
            buf.clear()
            buf["chunks"] = []
        chunks = buf.get("chunks")
        if chunks is None or len(chunks) != seq or seq >= n:
            have = len(chunks) if chunks is not None else None
            buf.clear()
            self._send(conn, lock, {
                "ok": 0, "error": "weight_push",
                "detail": f"out-of-order push chunk seq={seq} of "
                          f"n={n} (have {have})",
            })
            return
        chunks.append(bytes(msg["chunk"]))
        if seq < n - 1:
            self._send(conn, lock, {"ok": 1, "received": seq})
            return
        payload = b"".join(chunks)
        buf.clear()
        version = (None if msg.get("version") is None
                   else int(msg["version"]))
        try:
            variables = deserialize_weights(payload)
        except Exception as e:
            self._send(conn, lock, {
                "ok": 0, "error": "weight_push",
                "detail": f"undecodable weight payload "
                          f"({type(e).__name__}: {e})",
            })
            return
        try:
            out = self.engine.control("update_weights", variables,
                                      version=version)
        except WeightPushError as e:
            self._send(conn, lock, {
                "ok": 0, "error": "weight_push", "detail": str(e),
            })
            return
        self._send(conn, lock, {
            "ok": 1, "applied": 1, "version": out["version"],
            "swap_ms": out["swap_ms"],
        })


class ServingClient:
    """Client for :class:`LMServer`: submit prompts, iterate streamed
    tokens. A reader thread demultiplexes tagged frames into per-request
    queues, so many requests can be in flight on one connection."""

    def __init__(self, host: str, port: int, timeout: Optional[float] = 60.0,
                 request_timeout: float = 60.0,
                 max_frame_bytes: int = MAX_SERVE_FRAME_BYTES):
        """``timeout`` bounds raw socket operations (None = no socket
        deadline — long-lived backend connections that may sit idle,
        e.g. a router's, rely on request-level timeouts instead);
        ``request_timeout`` is the default wait for any reply — ack
        frames in :meth:`_call` and per-token waits in :meth:`result` —
        inherited by every call unless overridden per call. Expiries
        raise :class:`TimeoutError` naming the operation/request; a
        refused or dead connection raises
        :class:`ServingConnectionError` naming ``host:port``.
        ``max_frame_bytes`` bounds each accepted reply frame: a frame
        whose header announces more raises a typed
        :class:`~distkeras_torch.networking.FrameError` naming the limit
        instead of attempting the allocation (as does a frame truncated
        by a mid-payload close). The default (16 MiB) clears ordinary
        token/stats traffic with room to spare; size it above the
        largest expected KV block batch when :meth:`export_kv` payloads
        ride this connection — roughly ``blocks_per_prompt x
        block_nbytes`` for the served model."""
        self.host, self.port = host, int(port)
        self.max_frame_bytes = max_frame_bytes
        try:
            self._sock = connect(host, port)
        except OSError as e:
            raise ServingConnectionError(
                f"cannot connect to LM server at {host}:{port}: {e}"
            ) from e
        self._sock.settimeout(timeout)
        self.request_timeout = request_timeout
        # _call_lock serializes a request frame with ITS reply frame:
        # ack frames carry no request id, so two threads interleaving
        # send/recv on the ack queue would swap replies (a generate ack
        # delivered to a stats caller maps tokens to the wrong rid)
        self._call_lock = threading.Lock()
        self._send_lock = threading.Lock()
        self._acks: _queue.Queue = _queue.Queue()
        self._streams: Dict[int, _queue.Queue] = {}
        self._streams_lock = threading.Lock()
        self._trace_ids: Dict[int, int] = {}  # rid -> telemetry trace id
        self._closed = False
        self._close_reason: Optional[str] = None
        self._reader = threading.Thread(target=self._read_loop, daemon=True)
        self._reader.start()

    @property
    def closed(self) -> bool:
        """True once the connection is gone (locally closed or died)."""
        # a stale False only means the caller raced the close, which
        # every locked read would too — monotonic-flag monitor read
        return self._closed  # analysis: unguarded-ok

    @property
    def close_reason(self) -> Optional[str]:
        """Why the connection ended (None while it is alive)."""
        # analysis: unguarded-ok (monitor read; set once at close)
        return self._close_reason

    def _stream_q(self, rid: int) -> _queue.Queue:
        with self._streams_lock:
            if rid not in self._streams:
                q = _queue.Queue()
                if self._closed:
                    # late consumer on a dead connection: hand it the
                    # terminal frame immediately instead of letting it
                    # block until its timeout
                    q.put(("end", DISCONNECTED))
                self._streams[rid] = q
            return self._streams[rid]

    def _read_loop(self):
        reason = "closed by client"
        try:
            while True:
                msg = recv_msg(self._sock,
                               max_bytes=self.max_frame_bytes)
                if msg is None:
                    reason = "server closed the connection"
                    break
                if "t" in msg:
                    self._stream_q(int(msg["id"])).put(("tok", int(msg["t"])))
                elif "done" in msg:
                    self._stream_q(int(msg["id"])).put(
                        ("end", str(msg.get("reason")))
                    )
                else:
                    self._acks.put(msg)
        except (ConnectionError, OSError) as e:
            if not self._closed:  # a local close() races the recv error
                reason = f"connection lost ({type(e).__name__}: {e})"
        finally:
            # mark closed under the streams lock so _stream_q can never
            # create a queue that misses both this sweep and the
            # late-consumer seeding above
            with self._streams_lock:
                self._closed = True
                if self._close_reason is None:
                    self._close_reason = reason
                for q in self._streams.values():
                    q.put(("end", DISCONNECTED))
            self._acks.put({"_disconnected": 1})

    def _conn_error(self) -> ServingConnectionError:
        return ServingConnectionError(
            f"connection to LM server at {self.host}:{self.port} is "
            f"closed ({self._close_reason or 'unknown reason'})"
        )

    def _call(self, msg: dict, timeout: Optional[float] = None) -> dict:
        if timeout is None:
            timeout = self.request_timeout
        with self._call_lock:
            if self._closed:
                raise self._conn_error()
            try:
                with self._send_lock:
                    send_msg(self._sock, msg)
            except (ConnectionError, OSError) as e:
                raise ServingConnectionError(
                    f"send to LM server at {self.host}:{self.port} "
                    f"failed: {e}"
                ) from e
            try:
                reply = self._acks.get(timeout=timeout)
            except _queue.Empty:
                raise TimeoutError(
                    f"no reply to op {msg.get('op')!r} within {timeout}s"
                ) from None
        if reply.get("_disconnected"):
            # re-seed so every later caller fails fast instead of
            # waiting out its timeout on an ack that can never come
            self._acks.put(reply)
            raise self._conn_error()
        if not reply.get("ok"):
            err = reply.get("error", "request rejected")
            if err == "overloaded":
                depth = reply.get("queue_depth")
                raise OverloadedError(
                    f"server at {self.host}:{self.port} is overloaded"
                    + (f" (queue_depth={depth})" if depth is not None
                       else ""),
                    queue_depth=depth,
                )
            if err == "draining":
                raise DrainingError(
                    f"server at {self.host}:{self.port} is draining "
                    f"(admissions closed)"
                )
            if err == "unknown_op":
                bad = reply.get("op")
                raise UnknownOpError(
                    f"server at {self.host}:{self.port} does not "
                    f"handle op {bad!r}",
                    op=bad,
                )
            if err == "weight_push":
                raise WeightPushError(
                    str(reply.get("detail")
                        or "weight push refused"))
            raise RuntimeError(err)
        return reply

    def generate(self, prompt, max_new_tokens: int, **kw) -> int:
        """Submit one request; returns its id (stream via
        :meth:`stream` / :meth:`result`; telemetry trace id via
        :meth:`trace_of`). Pass ``tier="batch"`` to submit into the
        cheap QoS class (preempted first under load; default
        ``"interactive"``). Pass ``trace=`` (and optionally
        ``parent_span=``) to propagate an existing telemetry trace id
        across the wire — the server's spans join that chain instead
        of minting a new id (how the router stitches one fleet-wide
        trace per request). Typed rejections: :class:`OverloadedError`
        (queue backpressure — retry elsewhere/later),
        :class:`~distkeras_torch.serving.DrainingError` (admissions
        closed), :class:`ServingConnectionError` (dead connection,
        names host:port); anything else raises ``RuntimeError``. All
        subclass RuntimeError, so untyped callers keep working."""
        msg = {"op": "generate",
               "prompt": [int(t) for t in prompt],
               "max_new_tokens": int(max_new_tokens)}
        msg.update({k: v for k, v in kw.items() if v is not None})
        reply = self._call(msg)
        rid = int(reply["id"])
        if reply.get("trace") is not None:
            self._trace_ids[rid] = int(reply["trace"])
        return rid

    def frames(self, rid: int, timeout: Optional[float] = None):
        """Yield a request's raw stream frames as ``(kind, value)``
        pairs: ``("tok", token)`` per token, then exactly one terminal
        ``("end", reason)`` — ``reason`` is the server's finish reason,
        or the :data:`DISCONNECTED` sentinel if the connection died
        mid-stream (a consumer is never left hanging). ``timeout``
        bounds each inter-frame wait (default: the constructor's
        ``request_timeout``); expiry raises :class:`TimeoutError`
        naming the request. The router proxies on this; :meth:`stream`
        and :meth:`result` are thin views over it."""
        if timeout is None:
            timeout = self.request_timeout
        q = self._stream_q(rid)
        n = 0
        while True:
            try:
                kind, val = q.get(timeout=timeout)
            except _queue.Empty:
                raise TimeoutError(
                    f"request {rid}: no token or end-of-stream within "
                    f"{timeout}s (received {n} tokens)"
                ) from None
            yield kind, val
            if kind == "end":
                return
            n += 1

    def stream(self, rid: int, timeout: Optional[float] = None):
        """Yield tokens for a request as they arrive (ends on the
        terminal frame, including a mid-stream disconnect)."""
        for kind, val in self.frames(rid, timeout=timeout):
            if kind == "tok":
                yield val

    def result(self, rid: int, timeout: Optional[float] = None,
               ) -> Tuple[List[int], Optional[str]]:
        """Block until a request finishes: (tokens, finish_reason).
        ``timeout`` bounds each inter-token wait (defaults to the
        constructor's ``request_timeout``); a stalled stream raises
        :class:`TimeoutError` naming the request instead of a bare
        ``queue.Empty``. A stream cut by a dead connection finishes
        with ``finish_reason`` :data:`DISCONNECTED` rather than
        hanging."""
        out: List[int] = []
        for kind, val in self.frames(rid, timeout=timeout):
            if kind == "end":
                return out, val
            out.append(val)
        return out, None  # unreachable: frames always ends with "end"

    def stats(self) -> dict:
        return dict(self._call({"op": "stats"})["stats"])

    def metrics(self) -> dict:
        """The server's :meth:`MetricRegistry.collect` snapshot."""
        return dict(self._call({"op": "metrics"})["metrics"])

    def trace_of(self, rid: int) -> Optional[int]:
        """Telemetry trace id for a request this client submitted."""
        return self._trace_ids.get(rid)

    def trace_dump(self, trace: Optional[int] = None,
                   limit: Optional[int] = None) -> List[dict]:
        """Server-side span records (optionally one trace id's chain)."""
        msg: dict = {"op": "trace_dump"}
        if trace is not None:
            msg["trace"] = int(trace)
        if limit is not None:
            msg["limit"] = int(limit)
        return list(self._call(msg)["spans"])

    def chrome_trace(self, trace: Optional[int] = None,
                     limit: Optional[int] = None) -> dict:
        """Server-side spans as Chrome trace-event JSON (one trace id's
        chain when given — against a router, the fleet-merged chain;
        without one, the engine loop's phase spans beside the requests).
        ``json.dump`` the result and open it in ui.perfetto.dev."""
        msg: dict = {"op": "chrome_trace"}
        if trace is not None:
            msg["trace"] = int(trace)
        if limit is not None:
            msg["limit"] = int(limit)
        return dict(self._call(msg)["chrome"])

    def flight(self, last: Optional[int] = None) -> dict:
        """The server engine's flight-recorder ring:
        ``{"meta": {...}, "ticks": [...]}`` (most recent ``last`` ticks
        when given). Raises RuntimeError when the recorder is
        disabled."""
        msg: dict = {"op": "flight"}
        if last is not None:
            msg["last"] = int(last)
        return dict(self._call(msg)["flight"])

    def alerts(self) -> List[dict]:
        """SLO alert state per rule (firing first); empty when the
        server has no monitor attached."""
        return list(self._call({"op": "alerts"})["alerts"])

    def timeseries(self, last: Optional[int] = None) -> dict:
        """The server's metric-history ring: ``{"meta": {...},
        "points": [...]}`` (most recent ``last`` points when given).
        Against a router (:mod:`~distkeras_torch.serving.router`), the
        fleet-merged series (each point carries its contributing
        ``sources``). Raises RuntimeError when the collector is
        disabled."""
        msg: dict = {"op": "timeseries"}
        if last is not None:
            msg["last"] = int(last)
        return dict(self._call(msg)["timeseries"])

    def events(self, last: Optional[int] = None) -> dict:
        """The control-plane event journal: ``{"meta": {...},
        "events": [...]}`` oldest-first (most recent ``last`` when
        given). Against a router (:mod:`~distkeras_torch.serving.router`), the
        merged fleet journal — router-side events (autoscaling,
        replica up/down, rollbacks) interleaved with every replica's
        own (drains, role flips, weight swaps), each tagged with its
        ``source``."""
        msg: dict = {"op": "events"}
        if last is not None:
            msg["last"] = int(last)
        return dict(self._call(msg)["events"])

    def export_kv(self, prompt) -> dict:
        """Gather the server's cached KV blocks covering ``prompt``'s
        prefix for migration to another replica (the disaggregated
        serving data plane; the router drives this against a
        prefill-pool replica after the prompt ran there). Returns
        ``{"tokens": covered_prefix_tokens, "blocks": [[leaf
        arrays...] per block]}`` — ``tokens`` 0 means nothing is
        cached (evicted since the prompt ran: fall back to a plain
        submit, seeded decoding recomputes the identical stream)."""
        reply = self._call({"op": "export_kv",
                            "prompt": [int(t) for t in prompt]})
        return {"tokens": int(reply["tokens"]),
                "blocks": list(reply["blocks"])}

    def import_kv(self, prompt, blocks) -> dict:
        """Install migrated KV blocks on the server (the decode-pool
        half of a migration): ``blocks`` is the ``blocks`` list an
        :meth:`export_kv` against the source replica returned, covering
        ``prompt``'s leading chunks. The server registers them in its
        radix prefix cache, so the next submit of this prompt prefills
        only the tail. Returns ``{"imported": k, "tokens": k *
        block_size, "mode": "host" | "device"}``."""
        reply = self._call({"op": "import_kv",
                            "prompt": [int(t) for t in prompt],
                            "blocks": list(blocks)})
        return {"imported": int(reply["imported"]),
                "tokens": int(reply["tokens"]),
                "mode": str(reply["mode"])}

    def push_weights(self, variables: Any = None, *,
                     payload: Optional[bytes] = None,
                     version: Optional[int] = None,
                     chunk_bytes: int = 4 << 20,
                     timeout: Optional[float] = None) -> dict:
        """Push a live weight update: serialize ``variables`` (the
        model's ``{"params": ...}`` dict; ``payload`` passes
        already-serialized bytes instead, the router's re-push path),
        chunk the blob across framed messages, and stream the chunks
        up one connection. The server validates structure/shape/dtype
        against its live tree and swaps atomically at the tick
        boundary; in-flight ticks complete on the old version, and no
        stream is dropped or corrupted by a mid-stream push.

        Against a router (:mod:`~distkeras_torch.serving.router`) the same op
        is a fleet-wide **rolling update** (drain → push → undrain,
        one replica at a time); the ack then arrives after the whole
        fleet converged — pass a generous ``timeout``.

        Raises the typed
        :class:`~distkeras_torch.serving.WeightPushError` (naming the
        first mismatched leaf) when the server refuses the tree;
        nothing was swapped in that case. Returns ``{"version",
        "swap_ms"}`` of the applied update."""
        if payload is None:
            payload = serialize_weights(variables)
        chunks = chunk_payload(payload, chunk_bytes)
        n = len(chunks)
        reply: dict = {}
        for i, ch in enumerate(chunks):
            msg: dict = {"op": "push_weights", "seq": i, "n": n,
                         "chunk": ch}
            if version is not None:
                msg["version"] = int(version)
            reply = self._call(msg, timeout=timeout)
        return {"version": int(reply["version"]),
                "swap_ms": reply.get("swap_ms")}

    def drain(self, replica: Optional[str] = None) -> dict:
        """Gracefully drain the server: admissions close immediately
        (subsequent :meth:`generate` calls raise
        :class:`~distkeras_torch.serving.DrainingError`), queued and
        in-flight streams finish. Returns ``{"active": slots_busy,
        "queued": depth}`` at drain time; poll :meth:`stats` for
        ``drained`` before stopping the process.

        ``replica`` is meaningful against a router: the named
        backend replica is drained and taken out of routing (the
        rolling-deploy primitive) while the router keeps admitting. A
        direct LMServer ignores the field and drains itself."""
        msg: dict = {"op": "drain"}
        if replica is not None:
            msg["replica"] = str(replica)
        reply = self._call(msg)
        return {"active": int(reply.get("active", 0)),
                "queued": int(reply.get("queued", 0))}

    def undrain(self, replica: Optional[str] = None) -> dict:
        """Reopen admissions on a drained server (or, through a
        router, on one named backend replica) — the undrain half of
        the rolling-update primitive. Idempotent."""
        msg: dict = {"op": "drain", "undrain": 1}
        if replica is not None:
            msg["replica"] = str(replica)
        reply = self._call(msg)
        return {"active": int(reply.get("active", 0)),
                "queued": int(reply.get("queued", 0))}

    def reconfigure(self, role: str,
                    replica: Optional[str] = None) -> str:
        """Flip the server's advertised role (``"mixed"`` /
        ``"prefill"`` / ``"decode"``) — the middle step of the fleet
        controller's drain → reconfigure → undrain rebalancing
        primitive. Returns the role now in effect. ``replica`` is
        meaningful against a router: the named backend
        replica is reconfigured (the router itself has no role)."""
        msg: dict = {"op": "reconfigure", "role": str(role)}
        if replica is not None:
            msg["replica"] = str(replica)
        reply = self._call(msg)
        return str(reply["role"])

    def close(self):
        """Idempotent: safe to call twice, or after the connection
        already died (socket close is a no-op then). Shutdown-first so
        the reader thread unblocks and seeds every pending stream with
        its terminal frame. The closed flags flip under the streams
        lock — the same discipline as the reader's shutdown sweep —
        so ``_stream_q`` can never create a queue against a
        half-closed connection that misses its terminal seed."""
        with self._streams_lock:
            if not self._closed:
                self._close_reason = "closed by client"
                self._closed = True
        shutdown_close(self._sock)
