"""Control-plane RPC: location-transparent endpoint calls over TCP.

The analogue of the reference's actor RPC (flink-rpc-akka/.../PekkoRpcService.java:86,
PekkoInvocationHandler.java:71): named endpoints expose public methods;
remote callers hold a gateway proxy whose attribute calls serialize the
invocation, ship it over a framed TCP connection, and return the result (or
re-raise the remote exception). Each endpoint executes ALL invocations on
one dedicated main thread — the single-threaded actor discipline that the
reference enforces with MainThreadValidatorUtil (MainThreadValidatorUtil.java:35)
— so endpoint state needs no locks.

Wire format (flink_tpu_torch/security): connection handshake (version +
cluster-id + nonce challenge against the cluster secret), then 4-byte
big-endian length + HMAC-signed frame of the restricted-pickled
(endpoint, method, args, kwargs[, trace_id]) / (ok, payload) — the
optional fifth element is the caller's trace context (W3C-traceparent
analogue; see trace_context/current_trace_id). Frames are MAC-verified
BEFORE deserialization and deserialized through the security allowlist;
`security.transport.enabled: false` restores the legacy plain-pickle wire.
This is the DCN control plane; the data plane (record batches, credits)
lives in dataplane.py.

Counterpart of `flink_tpu/runtime/rpc.py`, copied.
"""

from __future__ import annotations

import contextlib
import dataclasses
import random
import socket
import socketserver
import threading
import time
import traceback
import uuid
from concurrent.futures import Future
from typing import Any, Callable, Dict, FrozenSet, Optional

from flink_tpu_torch.chaos import plan as _chaos
from flink_tpu_torch.lint.contracts import absorbs_faults


# ---------------------------------------------------------------------------
# trace-context propagation (W3C-traceparent-lite over the RPC frame)
# ---------------------------------------------------------------------------

_trace_ctx = threading.local()


def current_trace_id() -> Optional[str]:
    """Trace id of the RPC invocation currently executing on this endpoint
    main thread (None outside an invocation or when the caller sent none).
    The observability analogue of reading the traceparent header."""
    return getattr(_trace_ctx, "incoming", None)


@contextlib.contextmanager
def trace_context(trace_id: Optional[str]):
    """Attach `trace_id` to every RPC this thread issues inside the block:
    the gateway appends it to the invocation frame, the receiving endpoint
    exposes it via current_trace_id() for the duration of the handler —
    spans emitted on both sides of the wire stitch into one trace."""
    prev = getattr(_trace_ctx, "outgoing", None)
    _trace_ctx.outgoing = trace_id
    try:
        yield
    finally:
        _trace_ctx.outgoing = prev

from flink_tpu_torch.security.framing import FrameAuthError, RestrictedUnpicklingError
from flink_tpu_torch.security.transport import (
    SecurityConfig,
    client_handshake,
    recv_obj,
    send_obj,
    server_handshake,
    validate_server_config,
    wrap_client_socket,
    wrap_server_socket,
)


class RpcEndpoint:
    """Base class: public methods become remotely callable; all invocations
    (local or remote) run on the endpoint's single main thread."""

    def __init__(self, name: Optional[str] = None):
        self.name = name or f"{type(self).__name__}-{uuid.uuid4().hex[:8]}"
        self._inbox: "list" = []
        self._cv = threading.Condition()
        self._running = True
        self._main_thread = threading.Thread(
            target=self._main_loop, name=f"rpc-main-{self.name}", daemon=True
        )
        self._main_thread.start()

    # -- main-thread discipline --------------------------------------------
    def validate_main_thread(self) -> None:
        assert threading.current_thread() is self._main_thread, (
            f"endpoint {self.name} state touched off the main thread"
        )

    def run_in_main_thread(self, fn: Callable, *args, **kwargs) -> Future:
        f: Future = Future()
        with self._cv:
            if not self._running:
                f.set_exception(RuntimeError(f"endpoint {self.name} stopped"))
                return f
            self._inbox.append((fn, args, kwargs, f))
            self._cv.notify()
        return f

    def _main_loop(self) -> None:
        while True:
            with self._cv:
                while self._running and not self._inbox:
                    self._cv.wait(timeout=0.2)
                if not self._running and not self._inbox:
                    return
                fn, args, kwargs, fut = self._inbox.pop(0)
            try:
                fut.set_result(fn(*args, **kwargs))
            except BaseException as e:  # noqa: BLE001 — forwarded to caller
                fut.set_exception(e)

    def stop(self) -> None:
        with self._cv:
            self._running = False
            self._cv.notify_all()

    # called by the server
    def _invoke(self, method: str, args, kwargs, trace_id: Optional[str] = None):
        fn = getattr(self, method, None)
        if fn is None or method.startswith("_"):
            raise AttributeError(f"{self.name} has no rpc method {method!r}")
        if trace_id is None:
            return self.run_in_main_thread(fn, *args, **kwargs)

        def with_ctx(*a, **kw):
            # surface the caller's trace id to the handler (main thread)
            _trace_ctx.incoming = trace_id
            try:
                return fn(*a, **kw)
            finally:
                _trace_ctx.incoming = None

        return self.run_in_main_thread(with_ctx, *args, **kwargs)


class RpcService:
    """Hosts endpoints on one TCP port; builds gateways to remote services.

    `security` defaults to the process-wide SecurityConfig (auth ON): every
    accepted connection must complete the cluster handshake before a single
    request byte is parsed, and every frame is MAC-verified before
    deserialization."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 security: Optional[SecurityConfig] = None):
        self._endpoints: Dict[str, RpcEndpoint] = {}
        self._lock = threading.Lock()
        self.security = SecurityConfig.resolve() if security is None else security
        validate_server_config(self.security)
        service = self

        class Handler(socketserver.BaseRequestHandler):
            @absorbs_faults("RPC server loop: handler errors ship back to the caller as failed replies; the crash model (sever the connection, no reply) is implemented at the seam's own InjectedCrash handler")
            def handle(self):
                sock = self.request
                codec = None
                if service.security.enabled:
                    try:
                        sock.settimeout(service.security.handshake_timeout_s)
                        sock = wrap_server_socket(sock, service.security)
                        codec = server_handshake(sock, service.security)
                        sock.settimeout(None)
                    except (FrameAuthError, OSError, ValueError):
                        return   # unauthenticated peer: drop pre-parse
                while True:
                    try:
                        msg = recv_obj(sock, codec)
                    except (FrameAuthError, RestrictedUnpicklingError):
                        return   # tampered frame / disallowed global: drop
                    except OSError:
                        return
                    if msg is None:
                        return
                    try:
                        # 4-tuple = legacy frame; 5th element carries the
                        # optional trace context (traceparent analogue)
                        trace_id = None
                        if len(msg) == 5:
                            endpoint, method, args, kwargs, trace_id = msg
                        else:
                            endpoint, method, args, kwargs = msg
                        # chaos seam (server side): a delay rule wedges
                        # this connection thread — the stuck-endpoint
                        # model; drop severs the connection pre-dispatch;
                        # crash ALSO severs it with no reply (a crashed
                        # server cannot answer — shipping it back as a
                        # RemoteRpcError would absorb the process-death
                        # model into an ordinary handler error)
                        hook = _chaos.HOOK
                        if hook is not None:
                            try:
                                if hook("rpc",
                                        f"server:{endpoint}.{method}") \
                                        == "drop":
                                    return
                            except _chaos.InjectedCrash:
                                return
                        with service._lock:
                            ep = service._endpoints.get(endpoint)
                        if ep is None:
                            raise LookupError(f"no endpoint {endpoint!r}")
                        result = ep._invoke(method, args, kwargs,
                                            trace_id).result()
                        reply = (True, result)
                    except BaseException as e:  # noqa: BLE001 — shipped back
                        reply = (False, (type(e).__name__, str(e), traceback.format_exc()))
                    try:
                        send_obj(sock, reply, codec)
                    except OSError:
                        return

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self.host, self.port = self._server.server_address
        self._thread = threading.Thread(
            target=self._server.serve_forever, name=f"rpc-srv-{self.port}", daemon=True
        )
        self._thread.start()

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def register(self, endpoint: RpcEndpoint) -> None:
        with self._lock:
            self._endpoints[endpoint.name] = endpoint

    def unregister(self, name: str) -> None:
        with self._lock:
            self._endpoints.pop(name, None)

    def gateway(self, address: str, endpoint: str, timeout: float = 10.0,
                reply_timeout: Optional[float] = None) -> "RpcGateway":
        return RpcGateway(address, endpoint, timeout, security=self.security,
                          reply_timeout=reply_timeout)

    def stop(self) -> None:
        with self._lock:
            eps = list(self._endpoints.values())
        for ep in eps:
            ep.stop()
        self._server.shutdown()
        self._server.server_close()


class RemoteRpcError(RuntimeError):
    def __init__(self, exc_type: str, message: str, remote_traceback: str):
        super().__init__(f"{exc_type}: {message}")
        self.exc_type = exc_type
        self.remote_traceback = remote_traceback


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff + jitter + an overall deadline for gateway-side
    retries of IDEMPOTENT control-plane calls (the transient-fault
    hardening the chaos rpc-flap scenario exercises). Job-mutating calls
    never retry: a re-sent submit/deploy/rescale whose first attempt DID
    land server-side would double-apply."""

    max_attempts: int = 5
    initial_backoff_s: float = 0.05
    multiplier: float = 2.0
    max_backoff_s: float = 1.0
    jitter: float = 0.5          # backoff scaled by U[1-jitter, 1+jitter]
    deadline_s: float = 8.0      # overall wall budget across attempts


#: control-plane methods safe to re-send after a transport-level failure
#: (connection reset/refused, reply timeout): liveness reports, checkpoint
#: acks/declines (the JM's handlers are attempt-guarded and level-
#: triggered), registrations (keyed by tm_id), and pure reads. Everything
#: else — submit_job, deploy_task, rescale_job, cancel_job, put — stays
#: single-attempt.
IDEMPOTENT_METHODS: FrozenSet[str] = frozenset({
    "ping", "heartbeat_tm", "register_task_executor",
    "ack_checkpoint", "decline_checkpoint",
    "task_finished", "cancel_task", "release_job_state",
    "peer_alive", "fetch_shard_restore",
    "job_status", "job_result", "job_metrics", "job_spans",
    "job_backpressure", "job_checkpoints", "job_checkpoint",
    "job_exceptions", "job_autoscaler", "job_device", "list_jobs", "get",
    # NOT here: trigger_checkpoint — the JM-side method of that name
    # allocates a fresh checkpoint id per call, so a retry after a lost
    # reply double-triggers (two barrier rounds, an orphaned savepoint)
})


class RpcGateway:
    """Dynamic proxy: gateway.method(*a, **kw) → remote invocation.

    One TCP connection per gateway, serialized calls (matching the
    per-endpoint ordering guarantee of the reference's actor mailbox).
    Replies are awaited under `reply_timeout` (default: the connect
    `timeout`) — a wedged server handler surfaces as a loud TimeoutError
    on a now-closed connection instead of blocking the caller forever —
    and calls in :data:`IDEMPOTENT_METHODS` retry transport failures per
    `retry`. Gateways carrying payload-shipping calls whose server-side
    handling is legitimately slow (deploys restoring large snapshots,
    acks persisting them) should pass a generous `reply_timeout` — the
    cluster uses PAYLOAD_REPLY_TIMEOUT_S — so the wedge detector never
    misfires on a genuinely big transfer."""

    def __init__(self, address: str, endpoint: str, timeout: float = 10.0,
                 security: Optional[SecurityConfig] = None,
                 retry: Optional[RetryPolicy] = None,
                 reply_timeout: Optional[float] = None):
        self._address = address
        self._endpoint = endpoint
        self._timeout = timeout
        self._reply_timeout = timeout if reply_timeout is None else reply_timeout
        self._retry = RetryPolicy() if retry is None else retry
        self._security = SecurityConfig.resolve() if security is None else security
        self._sock: Optional[socket.socket] = None
        self._codec = None
        self._lock = threading.Lock()

    def _connect(self) -> socket.socket:
        if self._sock is None:
            host, port = self._address.rsplit(":", 1)
            sock = socket.create_connection((host, int(port)), timeout=self._timeout)
            if self._security.enabled:
                try:
                    sock = wrap_client_socket(sock, self._security)
                    self._codec = client_handshake(sock, self._security)
                except BaseException:
                    sock.close()
                    raise
            # the timeout guards CONNECT + handshake only: leaving it armed
            # would make any invocation whose reply takes > timeout raise
            # mid-frame and poison the connection for every later call
            sock.settimeout(None)
            self._sock = sock
        return self._sock

    @property
    def address(self) -> str:
        """host:port this gateway dials (for building sibling gateways to
        the same service, e.g. a tight-timeout liveness probe next to a
        payload-tier gateway)."""
        return self._address

    def close(self) -> None:
        with self._lock:
            self._close_locked()

    def _close_locked(self) -> None:
        """Drop the cached socket; caller must hold self._lock (the lock is
        non-reentrant, so call() error paths use this instead of close())."""
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None
                self._codec = None

    def _attempt(self, method: str, frame) -> tuple:
        """One wire attempt: connect (if needed), send, await the reply
        under the gateway timeout. Any failure closes the connection (a
        half-done exchange poisons frame alignment) and raises."""
        with self._lock:
            # chaos seam: drop = the connection "died" before the frame
            # left; error/crash raise from the hook itself. Inside the
            # attempt so retries re-consult the plan (nth-counting sees
            # every attempt).
            hook = _chaos.HOOK
            if hook is not None and hook(
                    "rpc", f"{self._endpoint}.{method}") == "drop":
                self._close_locked()
                raise _chaos.InjectedFault(
                    f"rpc-drop:{self._endpoint}.{method}")
            sock = self._connect()
            try:
                # armed for THIS call only: a wedged server handler (its
                # endpoint main thread blocked in the invocation) must
                # surface as a timeout, not hold the caller forever. The
                # connection is closed on timeout, so a later call gets a
                # fresh socket with no stale reply in flight.
                sock.settimeout(self._reply_timeout)
                send_obj(sock, frame, self._codec)
                reply = recv_obj(sock, self._codec)
                sock.settimeout(None)
            except TimeoutError as e:
                self._close_locked()
                raise TimeoutError(
                    f"rpc {self._endpoint}.{method} to {self._address} "
                    f"timed out after {self._reply_timeout}s (wedged or "
                    f"partitioned endpoint)") from e
            except (OSError, FrameAuthError, RestrictedUnpicklingError):
                self._close_locked()
                raise
            if reply is None:
                self._close_locked()
                raise ConnectionError(f"rpc connection to {self._address} closed")
            return reply

    def __getattr__(self, method: str):
        if method.startswith("_"):
            raise AttributeError(method)

        def call(*args, **kwargs):
            trace_id = getattr(_trace_ctx, "outgoing", None)
            frame = ((self._endpoint, method, args, kwargs, trace_id)
                     if trace_id is not None
                     else (self._endpoint, method, args, kwargs))
            retry = self._retry
            can_retry = method in IDEMPOTENT_METHODS \
                and retry.max_attempts > 1
            deadline = time.monotonic() + retry.deadline_s
            backoff = retry.initial_backoff_s
            attempt = 0
            while True:
                attempt += 1
                try:
                    reply = self._attempt(method, frame)
                    break
                except (FrameAuthError, RestrictedUnpicklingError):
                    raise          # tampering is never transient
                except _chaos.InjectedCrash:
                    raise          # models process death: must escalate
                except OSError:
                    # transient transport failure (reset, refused, reply
                    # timeout, injected flap): re-send with backoff +
                    # jitter inside the overall deadline — but ONLY for
                    # idempotent calls; the lock is NOT held across the
                    # backoff sleep (CONC003), so other callers proceed
                    now = time.monotonic()
                    if (not can_retry or attempt >= retry.max_attempts
                            or now >= deadline):
                        raise
                    pause = backoff * (1.0 + retry.jitter
                                       * (2.0 * random.random() - 1.0))
                    time.sleep(max(min(pause, deadline - now), 0.0))
                    backoff = min(backoff * retry.multiplier,
                                  retry.max_backoff_s)
            ok, payload = reply
            if ok:
                return payload
            raise RemoteRpcError(*payload)

        return call

    def call_async(self, method: str, *args, **kwargs) -> Future:
        f: Future = Future()

        def run():
            try:
                f.set_result(getattr(self, method)(*args, **kwargs))
            except BaseException as e:  # noqa: BLE001
                f.set_exception(e)

        threading.Thread(target=run, daemon=True,
                         name=f"rpc-async-{self._endpoint}.{method}").start()
        return f
