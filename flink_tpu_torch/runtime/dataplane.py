"""Data plane: record-batch exchange between task executors over TCP (DCN).

Within a TPU slice, keyBy shuffles ride ICI as compiled all-to-all
collectives (flink_tpu_torch/parallel). ACROSS hosts, batches travel on this
plane — the DCN counterpart of the reference's Netty shuffle
(io/network/netty/**) with the same backpressure discipline:

- **Credit-based flow control** (CreditBasedPartitionRequestClientHandler.java:61,
  RemoteInputChannel.java:114): a receiving channel grants credits equal to
  its free ring slots; the sender spends one credit per batch and BLOCKS
  when out of credit — backpressure propagates to the producing step loop
  with no unbounded buffering, exactly the "no credit ⇒ no send ⇒ writer
  blocks on LocalBufferPool" chain of the reference.
- **Batch debloating** (runtime/throughput/BufferDebloater.java): senders
  size batches toward `target_latency x observed_throughput` with an EMA,
  trading latency for amortization the way buffer debloating resizes
  network buffers.

Wire (flink_tpu_torch/security): the same handshake + MAC-signed framing as the
RPC plane. Control frames — ("open", channel, offered_formats) /
("credit", channel, n, chosen_format) / ("eos", channel) — and non-batch
payloads travel as restricted-pickle frames exactly as before. Record
BATCHES take the zero-copy binary columnar wire (security/wire.py): a
little-endian header + restricted-pickle sidecar + the raw array buffers,
sent with scatter-gather I/O and MACed incrementally, so a contiguous
numeric column crosses the host boundary without a single serialization
copy (the Netty zero-copy buffer-transfer analogue). The format is
negotiated per connection on the open/credit exchange, so an old-wire peer
transparently downgrades the channel to the legacy pickled
("data", channel, seq, payload) frames (`exchange.wire-format: pickle`
forces that everywhere). Frames are MAC-verified before deserialization
exactly like RPC frames; `security.transport.enabled: false` yields the
same binary wire without authentication.

Credit grants are COALESCED: the receiver banks freed ring slots and sends
one ("credit", ch, n) frame per `exchange.credit-batch` slots (default:
capacity/4) instead of one per consumed batch, quartering the control-frame
rate on the hot path without changing the blocking discipline — the sender
still stalls exactly when the receiver's ring is full.

Counterpart of `flink_tpu/runtime/dataplane.py`, copied: its frames and
its wire-format negotiation interoperate with the JAX package's.
"""

from __future__ import annotations

import socket
import socketserver
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from flink_tpu_torch.chaos import plan as _chaos
from flink_tpu_torch.lint.contracts import absorbs_faults
from flink_tpu_torch.metrics.registry import Meter
from flink_tpu_torch.security.framing import FrameAuthError, RestrictedUnpicklingError
from flink_tpu_torch.security.transport import (
    SecurityConfig,
    client_handshake,
    recv_msg,
    recv_obj,
    send_data_frame,
    send_obj,
    server_handshake,
    validate_server_config,
    wrap_client_socket,
    wrap_server_socket,
)
from flink_tpu_torch.security.wire import WireFormatError, extract_columns


class SequenceLostError(ConnectionError):
    """Raised by OutputChannel.reconnect() when the re-run open/credit
    negotiation proves a frame was LOST (receiver's next expected seq !=
    sender's): provably unrecoverable at this layer — callers must
    escalate to the checkpoint-rewind restart path immediately instead of
    burning the reconnect window on re-dials that can never heal it."""


def _validate_wire_format(wire_format: str) -> str:
    """exchange.wire-format must be exactly 'binary' or 'pickle': a typo
    silently negotiating the whole cluster down to the pickle wire would
    throw away the zero-copy speedup with no signal — fail at startup."""
    if wire_format not in ("binary", "pickle"):
        raise ValueError(
            f"exchange.wire-format must be 'binary' or 'pickle', "
            f"got {wire_format!r}"
        )
    return wire_format


class InputChannel:
    """Receiver side of one channel: a bounded ring of batches; consuming
    batches releases credits back to the sender in coalesced grants of
    `credit_batch` (banked freed slots), and every arriving frame must
    extend the sender's sequence contiguously — a dropped or reordered
    frame surfaces as a loud ConnectionError at poll(), never as silent
    corruption."""

    def __init__(self, channel_id: str, capacity: int,
                 grant: Callable[[int], None], credit_batch: int = 1):
        self.channel_id = channel_id
        self.capacity = capacity
        self._grant = grant
        self._credit_batch = max(1, min(credit_batch, capacity))
        self._pending_credits = 0
        self._ring: deque = deque()
        self._cv = threading.Condition()
        self._eos = False
        self._next_seq = 0
        self._error: Optional[Exception] = None
        self.bytes_in = 0
        self._in_meter = Meter()

    def _on_data(self, seq: int, payload, nbytes: int = 0) -> bool:
        """False when the frame breaks sequence contiguity — the server
        handler then drops the connection; consumers see the error on the
        next poll() once the ring's valid prefix is drained."""
        with self._cv:
            if seq != self._next_seq:
                self._error = ConnectionError(
                    f"channel {self.channel_id}: sequence gap (got seq {seq},"
                    f" expected {self._next_seq}) — a frame was dropped or"
                    " reordered in transit"
                )
                self._cv.notify_all()
                return False
            self._next_seq += 1
            self.bytes_in += nbytes
            self._in_meter.mark(nbytes)
            self._ring.append(payload)
            self._cv.notify_all()
        return True

    def _on_eos(self) -> None:
        with self._cv:
            self._eos = True
            self._cv.notify_all()

    def poll(self, timeout: Optional[float] = None):
        """Next batch, or None at end-of-stream."""
        grant_n = 0
        with self._cv:
            while not self._ring and not self._eos and self._error is None:
                if not self._cv.wait(timeout=timeout):
                    raise TimeoutError(f"channel {self.channel_id} starved")
            if self._ring:
                batch = self._ring.popleft()
                # bank the freed slot; one grant frame per credit_batch slots
                self._pending_credits += 1
                if self._pending_credits >= self._credit_batch:
                    grant_n, self._pending_credits = self._pending_credits, 0
            elif self._error is not None:
                raise self._error
            else:
                return None
        if grant_n:
            self._grant(grant_n)  # outside the lock: grants hit the socket
        return batch

    def in_rate(self) -> float:
        """Received bytes per second over the meter window (numBytesInPerSecond)."""
        return self._in_meter.rate()

    def occupancy(self) -> float:
        """Fraction of ring slots holding unconsumed batches (0..1) — the
        inPoolUsage analogue, registered as a per-channel gauge on staged
        tasks (cluster._run_graph_stage): a persistently full ring means
        THIS task is the bottleneck (its upstream is backpressured); a
        persistently empty one means it is starved."""
        with self._cv:
            return min(len(self._ring) / max(self.capacity, 1), 1.0)

    def on_reopen(self) -> "Tuple[int, int]":
        """Credits + next expected seq for an open/re-open reply. A fresh
        channel grants full capacity from seq 0 (identical to the old
        protocol); a RECONNECTING sender gets only the currently FREE ring
        slots — re-granting full capacity would mint credits for batches
        still parked in the ring — plus the sequence number this receiver
        will accept next, so the sender can verify that no frame was lost
        before resuming (seq mismatch = real loss = restart, not resume)."""
        with self._cv:
            self._pending_credits = 0   # banked grants died with the socket
            return max(self.capacity - len(self._ring), 0), self._next_seq

    @property
    def ended(self) -> bool:
        with self._cv:
            return self._eos and not self._ring


class ExchangeServer:
    """One per task executor: accepts peer connections, routes messages to
    registered input channels, sends credits back on the same socket.

    `wire_format` is what this receiver ADVERTISES on the open reply:
    "binary" accepts the zero-copy columnar wire from senders that offer it
    (old senders simply never offer, and keep the pickle wire); "pickle"
    forces every sender to the legacy frames. `credit_batch` is the
    coalescing grain for credit grants (0 = capacity/4)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, capacity: int = 8,
                 security: Optional[SecurityConfig] = None,
                 wire_format: str = "binary", credit_batch: int = 0):
        self.capacity = capacity
        self.wire_format = _validate_wire_format(wire_format)
        self.credit_batch = credit_batch if credit_batch > 0 else max(1, capacity // 4)
        self.security = SecurityConfig.resolve() if security is None else security
        validate_server_config(self.security)
        self._channels: Dict[str, InputChannel] = {}
        self._lock = threading.Lock()
        server_self = self

        class Handler(socketserver.BaseRequestHandler):
            @absorbs_faults('exchange server connection thread: disconnects and injected crashes sever the connection — returning models peer death; the consumer surfaces the stall via its channel-failure path')
            def handle(self):
                sock = self.request
                try:
                    # credit grants are tiny frames racing 1 MiB batches the
                    # other way; Nagle coalescing them stalls the sender's
                    # credit wait (Netty sets TCP_NODELAY on the same plane)
                    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                except OSError:
                    pass
                codec = None
                if server_self.security.enabled:
                    try:
                        sock.settimeout(server_self.security.handshake_timeout_s)
                        sock = wrap_server_socket(sock, server_self.security)
                        codec = server_handshake(sock, server_self.security)
                        sock.settimeout(None)
                    except (FrameAuthError, OSError, ValueError):
                        return   # unauthenticated peer: drop pre-parse
                sock_lock = threading.Lock()

                def grant_for(channel: str):
                    def grant(n: int):
                        try:
                            with sock_lock:
                                send_obj(sock, ("credit", channel, n), codec)
                        except OSError:
                            pass
                    return grant

                while True:
                    try:
                        msg, nbytes = recv_msg(sock, codec)
                    except (FrameAuthError, RestrictedUnpicklingError,
                            WireFormatError):
                        return   # tampered/malformed frame: drop pre-use
                    except OSError:
                        return   # abrupt peer disconnect (task cancel/kill)
                    if msg is None:
                        return
                    kind, channel = msg[0], msg[1]
                    if kind == "open":
                        ch = server_self._ensure(channel, grant_for(channel))
                        # wire-format negotiation rides the open reply: the
                        # 4th element names the format this receiver will
                        # accept for the channel's batches. Old senders
                        # ignore extra elements; old receivers reply with a
                        # 3-tuple, which new senders read as "pickle". The
                        # 5th element is the next seq this receiver expects
                        # — 0 on a fresh channel, the resume point for a
                        # sender re-running the open after a transient
                        # disconnect (OutputChannel.reconnect).
                        offered = msg[2] if len(msg) > 2 else ()
                        chosen = ("binary"
                                  if server_self.wire_format == "binary"
                                  and "binary" in tuple(offered) else "pickle")
                        grant_n, next_seq = ch.on_reopen()
                        with sock_lock:
                            send_obj(sock, ("credit", channel, grant_n,
                                            chosen, next_seq), codec)
                    elif kind == "data":
                        ch = server_self._channels.get(channel)
                        if ch is not None:
                            if not ch._on_data(msg[2], msg[3], nbytes):
                                return   # sequence gap: drop the connection
                    elif kind == "eos":
                        ch = server_self._channels.get(channel)
                        if ch is not None:
                            ch._on_eos()

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self.host, self.port = self._server.server_address
        threading.Thread(target=self._server.serve_forever, daemon=True,
                         name=f"exchange-{self.port}").start()

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def _ensure(self, channel_id: str, grant) -> InputChannel:
        with self._lock:
            ch = self._channels.get(channel_id)
            if ch is None:
                ch = InputChannel(channel_id, self.capacity, grant,
                                  self.credit_batch)
                self._channels[channel_id] = ch
            else:
                ch._grant = grant
            return ch

    def channel(self, channel_id: str) -> InputChannel:
        """Local handle (register before peers connect to avoid races)."""
        with self._lock:
            ch = self._channels.get(channel_id)
            if ch is None:
                ch = InputChannel(channel_id, self.capacity, lambda n: None,
                                  self.credit_batch)
                self._channels[channel_id] = ch
            return ch

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()


class OutputChannel:
    """Sender side: one channel to a remote InputChannel; send() blocks when
    out of credit (the reference's writer blocking on LocalBufferPool)."""

    def __init__(self, address: str, channel_id: str, connect_timeout: float = 10.0,
                 security: Optional[SecurityConfig] = None,
                 wire_format: str = "binary"):
        host, port = address.rsplit(":", 1)
        self._addr = (host, int(port))
        self._connect_timeout = connect_timeout
        self._wire_format = _validate_wire_format(wire_format)  # before the dial
        self.security = SecurityConfig.resolve() if security is None else security
        self.channel_id = channel_id
        # negotiated on the open reply (None until the first credit grant
        # arrives; the first send always waits for that grant): "binary"
        # only when this sender offered it AND the receiver advertised it —
        # an old-wire peer downgrades the channel to pickled frames
        self._wire: Optional[str] = None
        self._credits = 0
        self._cv = threading.Condition()
        self._seq = 0
        # next seq the receiver advertised on the open reply (None from an
        # old receiver) — reconnect() verifies continuity against it
        self._advertised_seq: Optional[int] = None
        self._linger_timer: Optional[threading.Timer] = None
        self._send_lock = threading.Lock()
        # cumulative seconds send() spent blocked waiting for credits — the
        # task-side backpressure signal (TaskIOMetrics reads this; the
        # reference's backPressuredTimeMsPerSecond measures the same wait
        # on LocalBufferPool)
        self.backpressured_s = 0.0
        self.bytes_out = 0
        self._out_meter = Meter()
        # transient-fault hardening accounting (numDataplaneReconnects)
        self.num_reconnects = 0
        self._credit_thread: Optional[threading.Thread] = None
        self._sock, self._codec = self._dial()
        self._start_credit_loop(self._sock, self._codec)
        self._send_open()

    def _dial(self):
        sock = socket.create_connection(self._addr,
                                        timeout=self._connect_timeout)
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass
        codec = None
        if self.security.enabled:
            try:
                sock = wrap_client_socket(sock, self.security)
                codec = client_handshake(sock, self.security)
            except BaseException:
                sock.close()
                raise
        sock.settimeout(None)
        return sock, codec

    def _start_credit_loop(self, sock, codec) -> None:
        t = threading.Thread(target=self._credit_loop, args=(sock, codec),
                             daemon=True, name=f"credits-{self.channel_id}")
        self._credit_thread = t
        t.start()

    def _send_open(self) -> None:
        open_msg = (("open", self.channel_id, ("binary",))
                    if self._wire_format == "binary"
                    else ("open", self.channel_id))
        with self._send_lock:
            n = send_obj(self._sock, open_msg, self._codec)
            self.bytes_out += n
            self._out_meter.mark(n)

    @absorbs_faults('credit listener: a broken credit socket wakes the sender with channel-closed, which surfaces as a send failure on the task thread — this loop has no caller to re-raise to')
    def _credit_loop(self, sock, codec) -> None:
        while True:
            try:
                msg = recv_obj(sock, codec)
            except (OSError, FrameAuthError, RestrictedUnpicklingError):
                msg = None
            if msg is None:
                with self._cv:
                    # a stale loop (its socket replaced by reconnect())
                    # must not poison the NEW connection's credit state
                    current = sock is self._sock
                    if current:
                        self._credits = -1  # poisoned: connection gone
                        self._cv.notify_all()
                # the peer closed (or close() shut down our write side and
                # the peer answered with FIN): now fully close the socket
                try:
                    sock.close()
                except OSError:
                    pass
                if current:
                    t = self._linger_timer
                    if t is not None:
                        t.cancel()     # fast FIN: don't hold the timer thread
                return
            if msg[0] == "credit" and msg[1] == self.channel_id:
                with self._cv:
                    if sock is not self._sock:
                        continue        # grant raced a reconnect: stale
                    if self._wire is None:
                        # open reply: the receiver's chosen wire format (a
                        # 3-tuple reply = old receiver = pickle) and, from
                        # new receivers, its next expected sequence number
                        self._wire = ("binary" if len(msg) > 3
                                      and msg[3] == "binary" else "pickle")
                        if len(msg) > 4:
                            self._advertised_seq = int(msg[4])
                    self._credits += msg[2]
                    self._cv.notify_all()

    def reconnect(self, timeout: float = 5.0) -> None:
        """Transient-fault hardening: re-dial the peer and re-run the
        open/credit negotiation IN PLACE (same object, counters and seq
        preserved, registered gauges stay valid). Resumes only on exact
        sequence continuity — the receiver's advertised next seq must
        equal this sender's, meaning no frame was lost — otherwise raises
        ConnectionError so the caller escalates to the checkpoint-rewind
        restart path. The caller owns retry pacing and the bounded
        reconnect window (cluster._ShardTask)."""
        try:
            # shutdown, not just close: close() does NOT wake a recv
            # already blocked in the credit thread (see close()'s linger
            # note) — without it every reconnect over a still-readable
            # socket burns the full join timeout and leaks the thread
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        t = self._credit_thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=2.0)
        sock, codec = self._dial()
        with self._cv:
            self._sock, self._codec = sock, codec
            self._credits = 0
            self._wire = None
            self._advertised_seq = None
        self._start_credit_loop(sock, codec)
        self._send_open()
        deadline = time.monotonic() + timeout
        with self._cv:
            while self._wire is None and self._credits >= 0:
                left = deadline - time.monotonic()
                if left <= 0 or not self._cv.wait(timeout=left):
                    raise ConnectionError(
                        f"channel {self.channel_id}: no open reply within "
                        f"{timeout}s of reconnect")
            if self._credits < 0:
                raise ConnectionError(
                    f"channel {self.channel_id}: peer refused the reconnect")
            adv = self._advertised_seq
        with self._send_lock:
            local = self._seq
        if adv is not None and adv != local:
            raise SequenceLostError(
                f"channel {self.channel_id}: receiver expects seq {adv} but "
                f"this sender is at {local} — frame(s) lost in transit; "
                "only a checkpoint rewind can recover them")
        self.num_reconnects += 1

    def send(self, payload, timeout: Optional[float] = 30.0) -> None:
        # chaos seam: `error` raises before any credit/seq is consumed
        # (reconnectable blip); `drop` consumes the seq but skips the wire
        # write — a frame lost in transit, which the receiver surfaces as
        # a sequence gap (the unrecoverable-loss path)
        hook = _chaos.HOOK
        directive = (hook("dataplane", self.channel_id)
                     if hook is not None else None)
        with self._cv:
            if self._credits == 0:
                t0 = time.perf_counter()
                try:
                    while self._credits == 0:
                        if not self._cv.wait(timeout=timeout):
                            raise TimeoutError(
                                f"no credit on {self.channel_id} "
                                "(receiver backpressured)"
                            )
                finally:
                    self.backpressured_s += time.perf_counter() - t0
            if self._credits < 0:
                raise ConnectionError(f"exchange channel {self.channel_id} closed")
            self._credits -= 1
            wire_fmt = self._wire
        # column extraction + sidecar pickling stay OUTSIDE the send lock
        # (only the header build and the socket write serialize)
        enc = None
        if wire_fmt == "binary" and self._wire_format == "binary":
            enc = extract_columns(payload)
        with self._send_lock:
            # seq assignment rides the SAME lock as the socket write, so
            # two threads sharing a sender cannot interleave sequence
            # numbers against frame order; the increment lands only AFTER
            # a successful write — a refused frame (e.g. the >=2GiB size
            # guard, raised before any byte hits the wire) must not burn a
            # seq, or the receiver would misread the next good frame as a
            # sequence gap
            seq = self._seq
            if directive == "drop":
                n = 0   # chaos: the frame "left" but never hits the wire
            elif enc is not None:
                n = send_data_frame(self._sock, self.channel_id, seq,
                                    enc[0], enc[1], self._codec)
            else:
                n = send_obj(self._sock,
                             ("data", self.channel_id, seq, payload),
                             self._codec)
            self._seq = seq + 1
            self.bytes_out += n
            self._out_meter.mark(n)

    def available_credits(self) -> int:
        with self._cv:
            return max(self._credits, 0)

    def out_rate(self) -> float:
        """Sent bytes per second over the meter window (numBytesOutPerSecond)."""
        return self._out_meter.rate()

    def end(self) -> None:
        with self._send_lock:
            n = send_obj(self._sock, ("eos", self.channel_id), self._codec)
            self.bytes_out += n
            self._out_meter.mark(n)

    def close(self) -> None:
        # graceful FIN, not a hard close: an immediate close() with unread
        # credit messages in the receive buffer sends RST, which can discard
        # the just-sent eos before the receiver processes it (observed as a
        # downstream stage waiting forever). Shut down the write side only;
        # _credit_loop closes the socket once the peer answers with FIN.
        # A hung/partitioned peer never sends that FIN, so a timer forces
        # shutdown(SHUT_RDWR) after a bounded linger — unlike settimeout or
        # close(), shutdown DOES wake a recv already blocked in the credit
        # thread, so the fd and thread cannot leak.
        try:
            self._sock.shutdown(socket.SHUT_WR)
        except OSError:
            try:
                self._sock.close()
            except OSError:
                pass
            return

        def _force(sock=self._sock):
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass   # already closed by the credit loop — the normal case

        t = threading.Timer(30.0, _force)
        t.daemon = True
        self._linger_timer = t
        t.start()


class BatchDebloater:
    """Adaptive batch sizing: EMA of throughput x target latency, clamped.
    (BufferDebloater.java / BufferSizeEMA analogue at batch granularity.)"""

    def __init__(self, *, target_latency_s: float = 0.2, min_size: int = 256,
                 max_size: int = 1 << 20, alpha: float = 0.3):
        self.target = target_latency_s
        self.min_size = min_size
        self.max_size = max_size
        self.alpha = alpha
        self._rate: Optional[float] = None

    def observe(self, records: int, elapsed_s: float) -> None:
        if elapsed_s <= 0:
            return
        r = records / elapsed_s
        self._rate = r if self._rate is None else (1 - self.alpha) * self._rate + self.alpha * r

    @property
    def observed(self) -> bool:
        """True once at least one throughput observation has landed; senders
        pass batches through unsplit until then (min_size would shred the
        very first batch for no reason)."""
        return self._rate is not None

    def batch_size(self) -> int:
        if self._rate is None:
            return self.min_size
        return int(min(self.max_size, max(self.min_size, self._rate * self.target)))
