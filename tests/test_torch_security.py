"""The port's transport security held against the JAX package's.

Golden frames: the binary columnar wire encodes the same bytes in both
packages, and each package decodes the other's frames. The handshake with
fixed nonces gives both packages the same proofs and session key. The
port's restricted unpickler resolves flink_tpu_torch classes only: it
refuses its own security module, module-level functions, every torch
global (a pickled tensor's `torch._utils._rebuild_tensor_v2`) and any
flink_tpu name, the last without importing it. Tamper, replay and
wrong-secret cases follow tests/test_security.py and
tests/test_wire_format.py.
"""

import os
import pickle
import socket
import struct
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from flink_tpu.security import framing as jframing  # noqa: E402
from flink_tpu.security import transport as jtransport  # noqa: E402
from flink_tpu.security import wire as jwire  # noqa: E402
from flink_tpu_torch.runtime.dataplane import ExchangeServer, OutputChannel  # noqa: E402
from flink_tpu_torch.runtime.rpc import RpcEndpoint, RpcGateway, RpcService  # noqa: E402
from flink_tpu_torch.security import framing as tframing  # noqa: E402
from flink_tpu_torch.security import transport as ttransport  # noqa: E402
from flink_tpu_torch.security import wire as twire  # noqa: E402
from flink_tpu_torch.testing.harness import ephemeral_transport_security  # noqa: E402

from test_wire_format import GOLDEN_HEADER_HEX, NUMERIC_DTYPES  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _frame(wire, payload, channel="ch", seq=9):
    cols, sidecar = wire.extract_columns(payload)
    parts, body_len = wire.encode_frame(channel, seq, cols, sidecar)
    body = b"".join(bytes(p) for p in parts)
    assert len(body) == body_len
    return body


def _payloads():
    rng = np.random.default_rng(21)
    out = [("b", (rng.random(37) * 100).astype(d), np.arange(37, dtype=np.int64))
           for d in NUMERIC_DTYPES]
    keys = np.asarray([f"k{i % 5}" for i in range(16)], dtype=object)
    out.append((keys, rng.random(16), np.arange(16, dtype=np.int64), 777, 3))
    out.append(("b", np.arange(12, dtype="<f4").reshape(3, 4), np.array([], np.int64)))
    return out


@pytest.mark.parametrize("i", range(len(NUMERIC_DTYPES) + 2))
def test_frames_are_byte_equal_and_decode_across_packages(i):
    payload = _payloads()[i]
    port, jax = _frame(twire, payload), _frame(jwire, payload)
    assert port == jax
    for decode in (twire.decode_frame, jwire.decode_frame):
        ch, seq, out = decode(bytearray(port))
        assert (ch, seq, len(out)) == ("ch", 9, len(payload))
        for got, want in zip(out, payload):
            if isinstance(want, np.ndarray):
                np.testing.assert_array_equal(got, want)
                assert got.dtype == want.dtype
            else:
                assert got == want


def test_golden_header_bytes_are_the_jax_packages():
    payload = ("b", np.arange(4, dtype="<i8"), np.array([[1.5, 2.5]], dtype="<f8"))
    cols, sidecar = twire.extract_columns(payload)
    parts, body_len = twire.encode_frame("gold", 3, cols, sidecar)
    assert bytes(parts[0]).hex() == GOLDEN_HEADER_HEX and body_len == 208


def test_handshake_with_fixed_nonces_gives_equal_proofs_and_session_keys(monkeypatch):
    """Server and client of each package pair with the other's, over a
    socket pair, with the same fixed nonces: every pairing derives the same
    session key, and the frames it seals are byte-equal."""
    nonces = {"server": b"S" * 16, "client": b"C" * 16}
    sec_t = ttransport.SecurityConfig.with_secret("s3cret", "c1")
    sec_j = jtransport.SecurityConfig.with_secret("s3cret", "c1")
    keys, sealed = {}, {}
    for srv_name, srv, srv_sec in (("port", ttransport, sec_t), ("jax", jtransport, sec_j)):
        for cli_name, cli, cli_sec in (("port", ttransport, sec_t), ("jax", jtransport, sec_j)):
            monkeypatch.setattr(srv._secrets, "token_bytes", lambda n: nonces["server"])
            a, b = socket.socketpair()
            out = {}
            t = threading.Thread(target=lambda: out.setdefault(
                "srv", srv.server_handshake(a, srv_sec)))
            t.start()
            monkeypatch.setattr(cli._secrets, "token_bytes", lambda n: nonces["client"])
            codec = cli.client_handshake(b, cli_sec)
            t.join(5)
            a.close(), b.close()
            keys[(srv_name, cli_name)] = (out["srv"]._key, codec._key)
            sealed[(srv_name, cli_name)] = codec.seal(b"payload")
            monkeypatch.undo()
    assert len({k for pair in keys.values() for k in pair}) == 1
    assert len(set(sealed.values())) == 1
    want = ttransport._hs_mac(sec_t, ttransport._HS_CLIENT, nonces["server"], nonces["client"])
    assert want == jtransport._hs_mac(sec_j, jtransport._HS_CLIENT, nonces["server"],
                                      nonces["client"])


def test_default_secret_path_and_environment_names_are_the_jax_packages():
    assert ttransport._default_secret_path() == jtransport._default_secret_path()
    for name in ("ENV_ENABLED", "ENV_SECRET", "ENV_SECRET_FILE", "ENV_CLUSTER_ID", "MAGIC",
                 "_HS_CLIENT", "_HS_SERVER", "_HS_SESSION", "_REST_BEARER"):
        assert getattr(ttransport, name) == getattr(jtransport, name)
    sec = ttransport.SecurityConfig.with_secret("x")
    assert ttransport.rest_bearer_token(sec) == jtransport.rest_bearer_token(
        jtransport.SecurityConfig.with_secret("x"))


@pytest.mark.parametrize("payload,match", [
    (b"cflink_tpu_torch.security.framing\ntrusted_loads\n.", "security"),
    (b"cflink_tpu_torch.security\ntrusted_loads\n.", "security"),
    (b"cflink_tpu_torch.core.keygroups\nkey_hash\n.", "CLASSES"),
    (b"ctorch._utils\n_rebuild_tensor_v2\n.", "torch._utils"),
    (b"cflink_tpu.core.time\nTimeWindow\n.", "flink_tpu.core.time"),
    (b"cos\nsystem\n.", "os.system"),
    (b"cbuiltins\neval\n.", "builtins.eval"),
])
def test_allowlist_refusals(payload, match):
    with pytest.raises(tframing.RestrictedUnpicklingError, match=match):
        tframing.restricted_loads(payload)


def test_allowlist_refuses_a_pickled_tensor_and_resolves_port_classes():
    from flink_tpu_torch.core.time import TimeWindow

    with pytest.raises(tframing.RestrictedUnpicklingError, match="torch"):
        tframing.restricted_loads(tframing.dumps(torch.arange(3)))
    assert tframing.restricted_loads(
        b"cflink_tpu_torch.core.time\nTimeWindow\n.") is TimeWindow
    msg = (True, [("k1", TimeWindow(0, 2000), 3.0, 1999)])
    assert tframing.restricted_loads(tframing.dumps(msg)) == msg


def test_a_flink_tpu_name_is_refused_without_importing_it():
    code = textwrap.dedent("""
        import sys
        from flink_tpu_torch.security.framing import (RestrictedUnpicklingError,
                                                      restricted_loads)
        for frame in (b"cflink_tpu.core.time\\nTimeWindow\\n.", b"cflink_tpu\\nx\\n."):
            try:
                restricted_loads(frame)
            except RestrictedUnpicklingError:
                pass
            else:
                raise SystemExit("accepted")
        bad = sorted(m for m in sys.modules if m == "flink_tpu" or m.startswith("flink_tpu."))
        print("imported:", bad)
        raise SystemExit(1 if bad else 0)
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_frame_codec_tamper_replay_reflection():
    key = os.urandom(32)
    client, server = tframing.FrameCodec(key, True), tframing.FrameCodec(key, False)
    f1, f2 = client.seal(b"one"), client.seal(b"two")
    assert server.open(f1) == b"one" and server.open(f2) == b"two"
    with pytest.raises(tframing.FrameAuthError):
        server.open(f1)
    bad = bytearray(client.seal(b"x"))
    bad[-1] ^= 0x01
    with pytest.raises(tframing.FrameAuthError):
        server.open(bytes(bad))
    with pytest.raises(tframing.FrameAuthError):
        tframing.FrameCodec(key, True).open(tframing.FrameCodec(key, True).seal(b"y"))
    # a port-sealed frame opens with the JAX codec and the reverse
    assert jframing.FrameCodec(key, False).open(
        tframing.FrameCodec(key, True).seal(b"z")) == b"z"
    assert tframing.FrameCodec(key, False).open(
        jframing.FrameCodec(key, True).seal(b"z")) == b"z"


@pytest.mark.parametrize("victim", ["header", "sidecar", "buffer", "mac"])
def test_tampered_binary_frame_rejected(victim):
    body = bytearray(_frame(twire, ("b", np.arange(64, dtype=np.float64),
                                    np.arange(64, dtype=np.int64)), "c", 0))
    mac = tframing.FrameCodec(b"secret" * 6, is_client=True).seal_parts((bytes(body),))
    recv = tframing.FrameCodec(b"secret" * 6, is_client=False)
    hlen = struct.unpack_from("<I", body, 4)[0]
    if victim == "header":
        body[8] ^= 1
    elif victim == "sidecar":
        body[hlen] ^= 1
    elif victim == "buffer":
        body[-1] ^= 1
    else:
        mac = bytes([mac[0] ^ 1]) + mac[1:]
    with pytest.raises(tframing.FrameAuthError):
        recv.open_parts(mac, (body,))


class _Echo(RpcEndpoint):
    def __init__(self):
        super().__init__(name="echo")

    def shout(self, text):
        return text.upper()


class _EvilReduce:
    def __init__(self, canary):
        self.canary = canary

    def __reduce__(self):
        return (os.mkdir, (self.canary,))


def test_rpc_rejects_wrong_secret_wrong_cluster_and_hostile_frames(tmp_path):
    sec = ephemeral_transport_security("prod")
    svc = RpcService(security=sec)
    svc.register(_Echo())
    try:
        good = RpcGateway(svc.address, "echo", security=sec)
        assert good.shout("ok") == "OK"
        good.close()
        for other in (ephemeral_transport_security("prod"),
                      ttransport.SecurityConfig.with_secret(sec.secret, "staging")):
            with pytest.raises((ConnectionError, OSError)):
                RpcGateway(svc.address, "echo", security=other).shout("x")
        # an authenticated peer pushing a disallowed global is dropped pre-parse
        s = socket.create_connection((svc.host, svc.port), timeout=5)
        s.settimeout(5)
        codec = ttransport.client_handshake(s, sec)
        ttransport.send_frame(s, codec.seal(pickle.dumps(_EvilReduce(str(tmp_path / "pwned")))))
        assert s.recv(1) == b""
        s.close()
        assert not (tmp_path / "pwned").exists()
    finally:
        svc.stop()


def test_exchange_rejects_wrong_secret_and_unsigned_frames(tmp_path):
    server = ExchangeServer(capacity=2, security=ephemeral_transport_security())
    server.channel("c1")
    try:
        with pytest.raises((ConnectionError, OSError)):
            OutputChannel(server.address, "c1", security=ephemeral_transport_security())
        s = socket.create_connection((server.host, server.port), timeout=5)
        s.settimeout(5)
        assert s.recv(21)[:4] == ttransport.MAGIC
        ttransport.send_frame(s, pickle.dumps(_EvilReduce(str(tmp_path / "pwned"))))
        assert s.recv(1) == b""
        s.close()
        assert not (tmp_path / "pwned").exists()
    finally:
        server.stop()


def test_security_config_resolves_the_option_group(tmp_path):
    from flink_tpu_torch.config import Configuration

    secret = tmp_path / "secret"
    secret.write_text("from-file\n")
    conf = Configuration({"security.transport.secret-file": str(secret),
                          "security.transport.cluster-id": "c9"})
    sec = ttransport.SecurityConfig.resolve(conf)
    assert (sec.enabled, sec.secret, sec.cluster_id) == (True, b"from-file", "c9")
    assert not ttransport.SecurityConfig.resolve(
        Configuration({"security.transport.enabled": False})).enabled
