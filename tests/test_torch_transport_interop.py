"""The port's planes and the JAX package's authenticate each other.

With one secret, a JAX OutputChannel sends to the port's ExchangeServer and
the port's OutputChannel to a JAX ExchangeServer, over the binary wire and
the legacy frames; a port RpcGateway calls a JAX RpcService and the
reverse. With different secrets every pairing is refused. The frames carry
numpy and stdlib values only: each package's allowlist refuses the other
package's classes.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

from flink_tpu.runtime import dataplane as jdp  # noqa: E402
from flink_tpu.runtime import rpc as jrpc  # noqa: E402
from flink_tpu.security import transport as jtransport  # noqa: E402
from flink_tpu_torch.runtime import dataplane as tdp  # noqa: E402
from flink_tpu_torch.runtime import rpc as trpc  # noqa: E402
from flink_tpu_torch.security import transport as ttransport  # noqa: E402

PAIRS = [("jax", "port"), ("port", "jax")]
MOD = {"jax": (jdp, jrpc, jtransport), "port": (tdp, trpc, ttransport)}


def _sec(pkg, secret, cluster="interop"):
    return MOD[pkg][2].SecurityConfig.with_secret(secret, cluster)


@pytest.mark.parametrize("wire_format", ["binary", "pickle"])
@pytest.mark.parametrize("sender,receiver", PAIRS)
def test_data_plane_across_packages(sender, receiver, wire_format):
    server = MOD[receiver][0].ExchangeServer(capacity=4, security=_sec(receiver, "s1"),
                                             wire_format=wire_format)
    ch = server.channel("x/a1/0->1")
    out = MOD[sender][0].OutputChannel(server.address, "x/a1/0->1",
                                       security=_sec(sender, "s1"), wire_format=wire_format)
    try:
        rng = np.random.default_rng(4)
        keys = np.asarray([f"k{i % 7}" for i in range(300)], dtype=object)
        vals, ts = rng.random(300), np.arange(300, dtype=np.int64)
        out.send((keys, vals, ts, 1500, 0))
        out.send(("b", vals.astype(np.float32).reshape(100, 3), ts[:100]))
        out.send(("w", 1234))
        got = ch.poll(timeout=5)
        np.testing.assert_array_equal(got[0], keys)
        np.testing.assert_array_equal(got[1], vals)
        assert got[3:] == (1500, 0)
        got = ch.poll(timeout=5)
        np.testing.assert_array_equal(got[1], vals.astype(np.float32).reshape(100, 3))
        assert ch.poll(timeout=5) == ("w", 1234)
        assert out._wire == wire_format
        out.end()
        assert ch.poll(timeout=5) is None and ch.ended
    finally:
        out.close()
        server.stop()


@pytest.mark.parametrize("sender,receiver", PAIRS)
def test_data_plane_refuses_a_different_secret(sender, receiver):
    server = MOD[receiver][0].ExchangeServer(capacity=2, security=_sec(receiver, "s1"))
    server.channel("c")
    try:
        with pytest.raises((ConnectionError, OSError)):
            MOD[sender][0].OutputChannel(server.address, "c", security=_sec(sender, "s2"))
    finally:
        server.stop()


def _echo_endpoint(pkg):
    base = MOD[pkg][1].RpcEndpoint

    class Echo(base):
        def __init__(self):
            super().__init__(name="echo")

        def shout(self, text, n=1):
            return (text.upper() * n, np.arange(3))

        def boom(self):
            raise ValueError("kapow")

    return Echo()


@pytest.mark.parametrize("caller,server", PAIRS)
def test_rpc_across_packages(caller, server):
    svc = MOD[server][1].RpcService(security=_sec(server, "s1"))
    svc.register(_echo_endpoint(server))
    try:
        gw = MOD[caller][1].RpcGateway(svc.address, "echo", security=_sec(caller, "s1"))
        text, arr = gw.shout("hi", n=2)
        assert text == "HIHI" and arr.tolist() == [0, 1, 2]
        with pytest.raises(MOD[caller][1].RemoteRpcError, match="kapow"):
            gw.boom()
        gw.close()
        bad = MOD[caller][1].RpcGateway(svc.address, "echo", security=_sec(caller, "s2"),
                                        retry=MOD[caller][1].RetryPolicy(max_attempts=1))
        with pytest.raises((ConnectionError, OSError)):
            bad.shout("x")
        other_cluster = MOD[caller][1].RpcGateway(
            svc.address, "echo", security=_sec(caller, "s1", "elsewhere"))
        with pytest.raises((ConnectionError, OSError)):
            other_cluster.shout("x")
    finally:
        svc.stop()


def test_the_per_user_default_secret_is_shared(monkeypatch, tmp_path):
    """Two processes of one user, one per package, resolve the same default
    secret file and so the same SecurityConfig."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", None)
    for name in ("FLINK_TPU_SECURITY_TRANSPORT_SECRET", "FLINK_TPU_SECURITY_TRANSPORT_SECRET_FILE"):
        monkeypatch.delenv(name, raising=False)
    a = ttransport._env_or_default_secret()
    b = jtransport._env_or_default_secret()
    assert a == b and len(a) == 64
    assert ttransport._default_secret_path().startswith(str(tmp_path))
