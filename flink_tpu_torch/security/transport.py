"""Transport security: cluster secret, connection handshake, optional TLS.

The runtime's network planes (runtime/rpc.py control plane, the
runtime/dataplane.py exchange, and the blob endpoint riding RPC) share one
trust model, mirroring the reference's internal-connectivity security
(`security.ssl.internal.*`, SSLHandlerFactory.java):

- A **per-cluster shared secret** (config > secret file > environment >
  auto-generated per-user file) authenticates both ends.
- A **handshake** at connection open: the server sends a random challenge
  nonce; the client answers with protocol version + cluster id + its own
  nonce + an HMAC over both nonces; the server verifies constant-time and
  proves itself back with an HMAC over the reversed transcript. Anything
  that fails — wrong magic, wrong version, wrong cluster, wrong secret —
  is disconnected BEFORE any payload byte is deserialized.
- A per-connection **session key** `HMAC(secret, nonces)` then MAC-signs
  every frame (security/framing.py), so post-handshake tampering or
  injection is detected frame-by-frame.
- **TLS** (stdlib `ssl`) can be layered UNDER the HMAC framing with the
  `security.ssl.internal.*` options — certificates give you wire privacy
  and PKI-rooted peer identity; the HMAC layer still provides cluster
  membership + per-frame integrity even where TLS terminates early (a
  sidecar, an lb).

`security.transport.enabled: false` restores the legacy plaintext-pickle
protocol for local debugging.

Counterpart of `flink_tpu/security/transport.py`, copied: the same
environment names, per-user secret path and handshake bytes, so a port
process and a JAX-package process holding one secret authenticate each
other.
"""

from __future__ import annotations

import dataclasses
import hashlib
import hmac
import os
import secrets as _secrets
import socket
import struct
import tempfile
import threading
from typing import Optional

from flink_tpu_torch.security.framing import (
    MAC_LEN,
    FrameAuthError,
    FrameCodec,
    dumps,
    restricted_loads,
)
from flink_tpu_torch.security import wire
from flink_tpu_torch.chaos import plan as _chaos   # leaf module (stdlib-only)

MAGIC = b"FTPU"
PROTOCOL_VERSION = 1
NONCE_LEN = 16
_HS_CLIENT = b"flink-tpu-hs-client-v1"
_HS_SERVER = b"flink-tpu-hs-server-v1"
_HS_SESSION = b"flink-tpu-session-v1"
_REST_BEARER = b"flink-tpu-rest-bearer-v1"

ENV_ENABLED = "FLINK_TPU_SECURITY_TRANSPORT_ENABLED"
ENV_SECRET = "FLINK_TPU_SECURITY_TRANSPORT_SECRET"
ENV_SECRET_FILE = "FLINK_TPU_SECURITY_TRANSPORT_SECRET_FILE"
ENV_CLUSTER_ID = "FLINK_TPU_SECURITY_TRANSPORT_CLUSTER_ID"


# ---------------------------------------------------------------------------
# byte-level framing shared by every plane (moved from runtime/rpc.py so the
# security layer does not depend on the runtime it guards)
# ---------------------------------------------------------------------------

def send_frame(sock: socket.socket, payload: bytes) -> None:
    sock.sendall(struct.pack(">I", len(payload)) + payload)


def _read_n(sock: socket.socket, n: int) -> Optional[bytes]:
    """Exactly n bytes off the socket, or None if the peer closes first."""
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(1 << 20, n - len(buf)))
        if not chunk:
            return None
        buf += chunk
    return bytes(buf)


def _recv_into_exact(sock: socket.socket, buf) -> bool:
    """Fill `buf` straight from the kernel (`recv_into`, no intermediate
    chunk accumulation); False if the peer closes mid-frame."""
    view = memoryview(buf)
    got = 0
    while got < len(buf):
        r = sock.recv_into(view[got:])
        if r == 0:
            return False
        got += r
    return True


def recv_frame(sock: socket.socket) -> Optional[bytes]:
    hdr = _read_n(sock, 4)
    if hdr is None:
        return None
    (n,) = struct.unpack(">I", hdr)
    return _read_n(sock, n)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    """Fixed-size read used ONLY during the handshake: an unauthenticated
    peer never gets to pick an allocation size."""
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise FrameAuthError("peer closed during handshake")
        buf += chunk
    return bytes(buf)


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SecurityConfig:
    """Resolved transport-security settings for one process/cluster."""

    enabled: bool = True
    secret: bytes = b""
    cluster_id: str = "flink-tpu"
    handshake_timeout_s: float = 10.0
    ssl_enabled: bool = False
    ssl_cert: Optional[str] = None
    ssl_key: Optional[str] = None
    ssl_ca: Optional[str] = None

    # -- construction ------------------------------------------------------
    @staticmethod
    def disabled() -> "SecurityConfig":
        return SecurityConfig(enabled=False)

    @staticmethod
    def with_secret(secret, cluster_id: str = "flink-tpu", **kw) -> "SecurityConfig":
        if isinstance(secret, str):
            secret = secret.encode()
        return SecurityConfig(enabled=True, secret=secret, cluster_id=cluster_id, **kw)

    @staticmethod
    def from_config(config) -> "SecurityConfig":
        """Resolve from a Configuration's `security.*` option group."""
        from flink_tpu_torch.config import SecurityOptions

        if not config.get(SecurityOptions.TRANSPORT_ENABLED):
            return SecurityConfig.disabled()
        secret = config.get(SecurityOptions.TRANSPORT_SECRET)
        secret_file = config.get(SecurityOptions.TRANSPORT_SECRET_FILE)
        if secret is not None:
            key = secret.encode() if isinstance(secret, str) else bytes(secret)
        elif secret_file:
            key = _read_secret_file(secret_file)
        else:
            key = _env_or_default_secret()
        return SecurityConfig(
            enabled=True,
            secret=key,
            cluster_id=config.get(SecurityOptions.TRANSPORT_CLUSTER_ID),
            ssl_enabled=config.get(SecurityOptions.SSL_INTERNAL_ENABLED),
            ssl_cert=config.get(SecurityOptions.SSL_INTERNAL_CERT),
            ssl_key=config.get(SecurityOptions.SSL_INTERNAL_KEY),
            ssl_ca=config.get(SecurityOptions.SSL_INTERNAL_CA),
        )

    @staticmethod
    def resolve(config=None) -> "SecurityConfig":
        """The entry point every plane uses: explicit Configuration if
        given, else the cached process default (env > per-user secret
        file). Every process of one user on one host resolves the same
        default secret, so local multi-process clusters (and the e2e
        subprocess tests) authenticate out of the box."""
        if config is not None:
            return SecurityConfig.from_config(config)
        return _process_default()


_default_lock = threading.Lock()
_default: Optional[SecurityConfig] = None


def _process_default() -> SecurityConfig:
    global _default
    with _default_lock:
        if _default is None:
            if os.environ.get(ENV_ENABLED, "true").strip().lower() in (
                    "false", "0", "no", "off"):
                _default = SecurityConfig.disabled()
            else:
                _default = SecurityConfig(
                    enabled=True,
                    secret=_env_or_default_secret(),
                    cluster_id=os.environ.get(ENV_CLUSTER_ID, "flink-tpu"),
                )
        return _default


def _set_process_default(sec: Optional[SecurityConfig]) -> Optional[SecurityConfig]:
    """Swap the cached process default (testing hook; see
    flink_tpu_torch.testing.harness.transport_security). Returns the previous
    value so callers can restore it."""
    global _default
    with _default_lock:
        prev, _default = _default, sec
        return prev


def _read_secret_file(path: str) -> bytes:
    with open(path, "rb") as f:
        data = f.read().strip()
    if not data:
        raise ValueError(f"transport secret file {path!r} is empty")
    return data


def _default_secret_path() -> str:
    uid = os.getuid() if hasattr(os, "getuid") else 0
    return os.path.join(tempfile.gettempdir(), f"flink-tpu-{uid}.transport.secret")


def _read_default_secret(path: str) -> bytes:
    """Read the auto-provisioned secret ONLY if we own it and nobody else
    can touch it: the default path lives in a world-writable tmpdir, so a
    local attacker could pre-create it with a value they know (secret
    squatting) — trusting such a file would hand them the cluster."""
    st = os.lstat(path)
    uid = os.getuid() if hasattr(os, "getuid") else st.st_uid
    if st.st_uid != uid or (st.st_mode & 0o077) or not os.path.isfile(path):
        raise PermissionError(
            f"refusing auto-provisioned transport secret {path!r}: it must "
            f"be a regular file owned by uid {uid} with mode 0600 (found "
            f"uid {st.st_uid}, mode {oct(st.st_mode & 0o777)}). Remove it, "
            "or set security.transport.secret-file / "
            f"{ENV_SECRET} explicitly."
        )
    return _read_secret_file(path)


def _env_or_default_secret() -> bytes:
    env = os.environ.get(ENV_SECRET)
    if env:
        return env.encode()
    env_file = os.environ.get(ENV_SECRET_FILE)
    if env_file:
        return _read_secret_file(env_file)
    # auto-provisioned per-user secret (the Jupyter-token pattern): 0600 so
    # other local users cannot read it; same-user processes share it
    path = _default_secret_path()
    try:
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_EXCL, 0o600)
    except FileExistsError:
        return _read_default_secret(path)
    try:
        os.write(fd, _secrets.token_hex(32).encode())
    finally:
        os.close(fd)
    return _read_default_secret(path)


def rest_bearer_token(sec: SecurityConfig) -> str:
    """REST API bearer token derived from the cluster secret (one secret to
    provision; the REST plane authenticates with its HMAC-derived form so
    the raw transport secret never appears in HTTP headers)."""
    return hmac.new(sec.secret, _REST_BEARER, hashlib.sha256).hexdigest()


def bearer_header_equal(header_value: str, token: str) -> bool:
    """Constant-time check of an Authorization header against
    `Bearer <token>` — THE comparison both HTTP planes (runtime/rest.py
    and the SQL gateway) use. Compares latin-1 BYTES: compare_digest
    raises TypeError on non-ASCII str input, and http.server decodes
    headers as latin-1, so a garbage header must read as unauthorized,
    never kill the handler thread."""
    return hmac.compare_digest(
        (header_value or "").encode("latin-1", "replace"),
        f"Bearer {token}".encode("latin-1", "replace"),
    )


# ---------------------------------------------------------------------------
# TLS layering (security.ssl.internal.* analogue)
# ---------------------------------------------------------------------------

def validate_server_config(sec: SecurityConfig) -> None:
    """Fail FAST on server-side misconfiguration. Called at
    RpcService/ExchangeServer construction: inside a connection handler the
    same error would be swallowed by the unauthenticated-peer drop and
    surface only as every client timing out with no server diagnostic."""
    if sec.enabled and sec.ssl_enabled and not (sec.ssl_cert and sec.ssl_key):
        raise ValueError(
            "security.ssl.internal.enabled requires security.ssl.internal.cert "
            "and security.ssl.internal.key"
        )


def wrap_server_socket(sock: socket.socket, sec: SecurityConfig) -> socket.socket:
    if not sec.ssl_enabled:
        return sock
    import ssl

    if not sec.ssl_cert or not sec.ssl_key:
        raise ValueError(
            "security.ssl.internal.enabled requires security.ssl.internal.cert "
            "and security.ssl.internal.key"
        )
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(sec.ssl_cert, sec.ssl_key)
    if sec.ssl_ca:
        # mutual TLS: require a peer certificate from the cluster CA
        ctx.load_verify_locations(sec.ssl_ca)
        ctx.verify_mode = ssl.CERT_REQUIRED
    return ctx.wrap_socket(sock, server_side=True)


def wrap_client_socket(sock: socket.socket, sec: SecurityConfig) -> socket.socket:
    if not sec.ssl_enabled:
        return sock
    import ssl

    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    # cluster-internal certs are addressed by ip:port, not DNS names — peer
    # identity comes from the CA + the HMAC handshake (the reference's
    # internal SSL likewise pins a fingerprint rather than hostnames)
    ctx.check_hostname = False
    if sec.ssl_ca:
        ctx.load_verify_locations(sec.ssl_ca)
        ctx.verify_mode = ssl.CERT_REQUIRED
    else:
        ctx.verify_mode = ssl.CERT_NONE
    if sec.ssl_cert and sec.ssl_key:
        ctx.load_cert_chain(sec.ssl_cert, sec.ssl_key)
    return ctx.wrap_socket(sock)


# ---------------------------------------------------------------------------
# handshake
# ---------------------------------------------------------------------------

def _hs_mac(sec: SecurityConfig, label: bytes, *parts: bytes) -> bytes:
    msg = label + bytes([PROTOCOL_VERSION]) + sec.cluster_id.encode() + b"".join(parts)
    return hmac.new(sec.secret, msg, hashlib.sha256).digest()


def _session_key(sec: SecurityConfig, server_nonce: bytes, client_nonce: bytes) -> bytes:
    return hmac.new(sec.secret, _HS_SESSION + server_nonce + client_nonce,
                    hashlib.sha256).digest()


def server_handshake(sock: socket.socket, sec: SecurityConfig) -> FrameCodec:
    """Challenge the connecting peer; raises FrameAuthError before ANY
    variable-length/deserializable byte is accepted from an
    unauthenticated source."""
    server_nonce = _secrets.token_bytes(NONCE_LEN)
    sock.sendall(MAGIC + bytes([PROTOCOL_VERSION]) + server_nonce)
    head = _recv_exact(sock, len(MAGIC) + 2)
    if head[:len(MAGIC)] != MAGIC:
        raise FrameAuthError("bad handshake magic")
    if head[len(MAGIC)] != PROTOCOL_VERSION:
        raise FrameAuthError(f"unsupported protocol version {head[len(MAGIC)]}")
    cid_len = head[len(MAGIC) + 1]
    cid = _recv_exact(sock, cid_len)
    client_nonce = _recv_exact(sock, NONCE_LEN)
    proof = _recv_exact(sock, 32)
    want = _hs_mac(sec, _HS_CLIENT, server_nonce, client_nonce)
    # one combined constant-time verdict: cluster-id mismatch and secret
    # mismatch are indistinguishable to the peer
    cid_ok = hmac.compare_digest(cid, sec.cluster_id.encode())
    if not (hmac.compare_digest(proof, want) and cid_ok):
        raise FrameAuthError("handshake authentication failed")
    sock.sendall(_hs_mac(sec, _HS_SERVER, client_nonce, server_nonce))
    return FrameCodec(_session_key(sec, server_nonce, client_nonce), is_client=False)


def client_handshake(sock: socket.socket, sec: SecurityConfig) -> FrameCodec:
    """Answer the server's challenge and verify the server's proof (mutual
    authentication: a rogue listener without the secret is detected)."""
    head = _recv_exact(sock, len(MAGIC) + 1 + NONCE_LEN)
    if head[:len(MAGIC)] != MAGIC:
        raise FrameAuthError(
            "peer did not offer the secured handshake (is "
            "security.transport.enabled false on the server?)"
        )
    if head[len(MAGIC)] != PROTOCOL_VERSION:
        raise FrameAuthError(f"unsupported protocol version {head[len(MAGIC)]}")
    server_nonce = head[len(MAGIC) + 1:]
    client_nonce = _secrets.token_bytes(NONCE_LEN)
    cid = sec.cluster_id.encode()
    if len(cid) > 255:
        raise ValueError("security.transport.cluster-id longer than 255 bytes")
    sock.sendall(
        MAGIC + bytes([PROTOCOL_VERSION, len(cid)]) + cid + client_nonce
        + _hs_mac(sec, _HS_CLIENT, server_nonce, client_nonce)
    )
    proof = _recv_exact(sock, 32)
    if not hmac.compare_digest(proof, _hs_mac(sec, _HS_SERVER, client_nonce, server_nonce)):
        raise FrameAuthError("server failed to prove the cluster secret")
    return FrameCodec(_session_key(sec, server_nonce, client_nonce), is_client=True)


# ---------------------------------------------------------------------------
# object send/recv used by every plane
# ---------------------------------------------------------------------------

def send_obj(sock: socket.socket, obj, codec: Optional[FrameCodec]) -> int:
    """Restricted-pickle frame send; returns bytes written to the wire (the
    dataplane's numBytesOut accounting reads this)."""
    hook = _chaos.HOOK   # chaos seam: one is-None check when chaos is off
    if hook is not None:
        # port-qualified site so a rule can target ONE peer: "send_obj"
        # alone matches every plane's sends process-wide
        try:
            peer = sock.getpeername()[1]
        except OSError:
            peer = 0
        if hook("transport", f"send_obj:{peer}") == "drop":
            return 0      # frame silently lost pre-wire (peer sees silence)
    payload = dumps(obj)
    mac_len = MAC_LEN if codec is not None else 0
    if len(payload) + mac_len >= wire.DATA_FLAG:
        # bit 31 of the length prefix marks binary data frames on the
        # dataplane; a >= 2 GiB pickled frame would be misparsed there, so
        # fail loudly at the sender (any plane: a single 2 GiB frame means
        # something upstream is already deeply wrong). Checked BEFORE
        # seal(): a refused frame must not consume a codec sequence slot.
        raise ValueError(
            f"frame too large ({len(payload) + mac_len} bytes >= 2 GiB)")
    frame = codec.seal(payload) if codec is not None else payload
    send_frame(sock, frame)
    return 4 + len(frame)


def recv_obj(sock: socket.socket, codec: Optional[FrameCodec]):
    """Next message, or None at EOF. With a codec: MAC-verify first, then
    restricted-deserialize. Without (security disabled): legacy pickle."""
    frame = recv_frame(sock)
    if frame is None:
        return None
    if codec is not None:
        return restricted_loads(codec.open(frame))
    import pickle

    return pickle.loads(frame)


# ---------------------------------------------------------------------------
# binary columnar data frames (dataplane only; see security/wire.py)
# ---------------------------------------------------------------------------

def _advance(views, n: int):
    """Drop the first n bytes from a scatter-gather view list (partial
    sendmsg): fully-sent views fall off, the boundary view is sliced."""
    for i, v in enumerate(views):
        if n >= len(v):
            n -= len(v)
            continue
        rest = views[i:] if n == 0 else [v[n:]] + views[i + 1:]
        return rest
    return []


try:
    _IOV_MAX = os.sysconf("SC_IOV_MAX")
except (AttributeError, OSError, ValueError):
    _IOV_MAX = 1024
if _IOV_MAX <= 0:
    _IOV_MAX = 1024  # sysconf may report 'indeterminate' as -1, not raise


def _send_parts(sock: socket.socket, parts) -> None:
    """Scatter-gather send (`socket.sendmsg`) of a list of buffers without
    concatenating them, at most IOV_MAX buffers per call (a many-column
    payload can exceed the kernel's iovec limit — EMSGSIZE — so the send
    loops in capped groups); falls back to one joined `sendall` where
    sendmsg is unavailable (TLS sockets raise NotImplementedError before
    any byte is written, so the fallback never double-sends)."""
    views = [memoryview(p) for p in parts if len(p)]
    sendmsg = getattr(sock, "sendmsg", None)
    if sendmsg is not None:
        try:
            while views:
                views = _advance(views, sendmsg(views[:_IOV_MAX]))
            return
        except NotImplementedError:
            pass  # ssl.SSLSocket: refuses up front, nothing sent yet
    sock.sendall(b"".join(views))


def send_data_frame(sock: socket.socket, channel: str, seq: int, cols,
                    sidecar: bytes, codec: Optional[FrameCodec]) -> int:
    """One binary columnar data frame: length prefix with the DATA_FLAG bit,
    optional incremental MAC over every part, then the parts themselves via
    scatter-gather I/O — contiguous numeric columns leave the process with
    zero copies. Returns bytes written."""
    parts, body_len = wire.encode_frame(channel, seq, cols, sidecar)
    mac_len = MAC_LEN if codec is not None else 0
    total = body_len + mac_len
    if total >= wire.DATA_FLAG:
        raise ValueError(f"data frame too large ({total} bytes)")
    prefix = struct.pack(">I", total | wire.DATA_FLAG)
    if codec is not None:
        mac = codec.seal_parts(parts)
        _send_parts(sock, [prefix, mac, *parts])
    else:
        _send_parts(sock, [prefix, *parts])
    return 4 + total


def recv_msg(sock: socket.socket, codec: Optional[FrameCodec]):
    """Next dataplane message as ``(msg, nbytes)``; ``(None, 0)`` at EOF.

    Legacy frames decode exactly like `recv_obj`. Binary columnar data
    frames — flag bit set in the length prefix — are read into ONE
    preallocated buffer with `recv_into`, MAC-verified over that buffer
    BEFORE any parsing, then decoded to ``("data", channel, seq, payload)``
    with the payload's raw columns as zero-copy `np.frombuffer` views
    (security/wire.py). `nbytes` is the frame's full wire size, feeding the
    receiver's numBytesIn accounting."""
    while True:
        hdr = _read_n(sock, 4)
        if hdr is None:
            return None, 0
        # chaos seam (recv side), consulted only once a frame provably
        # exists (after the length prefix) — at EOF a bounded drop rule
        # must not burn its max_fires budget on nothing. A drop swallows
        # the frame AFTER it is read (and MAC-verified) — exactly loss in
        # transit past the NIC; a dropped data frame then surfaces as a
        # sequence gap. The site carries the receiver's OWN port so one
        # exchange server is targetable without every other live socket
        # skewing nth-counts.
        hook = _chaos.HOOK
        dropping = False
        if hook is not None:
            try:
                own = sock.getsockname()[1]
            except OSError:
                own = 0
            dropping = hook("transport", f"recv_msg:{own}") == "drop"
        (n,) = struct.unpack(">I", hdr)
        if not (n & wire.DATA_FLAG):
            body = _read_n(sock, n)
            if body is None:
                return None, 0
            if codec is not None:
                obj_bytes = codec.open(body)   # MAC-verify (and advance the
                # replay counter) even for a dropped frame — the drop models
                # loss ABOVE the authenticated transport, not a desync
                if dropping:
                    continue
                return restricted_loads(obj_bytes), 4 + n
            if dropping:
                continue
            import pickle

            return pickle.loads(body), 4 + n
        n &= wire.DATA_FLAG - 1
        total = 4 + n
        if codec is not None:
            if n < MAC_LEN:
                raise FrameAuthError("binary frame shorter than its MAC")
            # one allocation, one recv_into stream for MAC + body together,
            # with the body (byte MAC_LEN) placed on the alignment grid
            buf = wire.alloc_body(n, lead=MAC_LEN)
            if not _recv_into_exact(sock, buf):
                return None, 0
            body = memoryview(buf)[MAC_LEN:]
            codec.open_parts(bytes(buf[:MAC_LEN]), (body,))
            if dropping:   # after MAC verify: the replay counter advanced
                continue
            channel, seq, payload = wire.decode_frame(body)
        else:
            buf = wire.alloc_body(n)
            if not _recv_into_exact(sock, buf):
                return None, 0
            if dropping:
                continue
            channel, seq, payload = wire.decode_frame(buf, trusted_pickle=True)
        return ("data", channel, seq, payload), total
