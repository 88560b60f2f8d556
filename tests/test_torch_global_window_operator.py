"""The port's count-triggered global-window operator held against the JAX
package's.

The cases of `tests/test_device_kernels.py:75-150` (trigger detection,
purging parity with the per-record oracle, non-purging accumulation,
snapshot and restore) on both packages' `TpuGlobalWindowOperator` (the
port's with `device="cpu"`), plus batched random streams compared record
for record between the packages, where a key crossing several multiples of
N in one batch fires once (the reference's documented coalescing), and
snapshots restored across the packages. The end-to-end job is in
`test_torch_per_batch_datastream.py`.

Tolerance: exact (small integer payloads; a mean to rtol 1e-6).
"""

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")

from flink_tpu.api.windowing.assigners import GlobalWindows as JaxGlobalWindows  # noqa: E402
from flink_tpu.api.windowing.triggers import CountTrigger as JaxCount  # noqa: E402
from flink_tpu.api.windowing.triggers import PurgingTrigger as JaxPurging  # noqa: E402
from flink_tpu.ops.aggregators import BUILTINS  # noqa: E402
from flink_tpu.runtime import tpu_global_window_operator as jgw  # noqa: E402
from flink_tpu.runtime.oracle_window_operator import OracleWindowOperator  # noqa: E402
from flink_tpu_torch.api.windowing.triggers import CountTrigger, PurgingTrigger  # noqa: E402
from flink_tpu_torch.core.time import MAX_WATERMARK  # noqa: E402
from flink_tpu_torch.runtime import tpu_global_window_operator as tgw  # noqa: E402

PKGS = ("jax", "port")


def make_op(pkg, agg, **kw):
    if pkg == "jax":
        return jgw.TpuGlobalWindowOperator(agg, **kw)
    return tgw.TpuGlobalWindowOperator(agg, device="cpu", **kw)


def rows(out):
    return [(k, r, t) for k, _w, r, t in out]


def test_supported_trigger_detection():
    assert tgw.supported_trigger(CountTrigger.of(5)) == (5, False)
    assert tgw.supported_trigger(PurgingTrigger.of(CountTrigger.of(3))) == (3, True)
    assert tgw.supported_trigger(None) is None
    assert tgw.supported_trigger(PurgingTrigger.of(None)) is None


@pytest.mark.parametrize("pkg", PKGS)
def test_global_count_purging_parity_per_record(pkg):
    device = make_op(pkg, "sum", count_n=3, purging=True, key_capacity=16)
    oracle = OracleWindowOperator(JaxGlobalWindows.create(),
                                  BUILTINS["sum"]().python_equivalent(),
                                  trigger=JaxPurging.of(JaxCount.of(3)))
    rng = np.random.default_rng(2)
    for i in range(60):
        key = f"k{rng.integers(0, 4)}"
        val = float(rng.integers(1, 10))
        device.process_record(key, val, i)
        device.flush()
        oracle.process_record(key, val, i)
    d = [(k, round(float(r), 3)) for k, _w, r, _t in device.drain_output()]
    o = [(k, round(float(r), 3)) for k, _w, r, _t in oracle.drain_output()]
    assert d == o and len(d) > 0


@pytest.mark.parametrize("pkg", PKGS)
def test_global_count_nonpurging_accumulates(pkg):
    device = make_op(pkg, "max", count_n=2, purging=False, key_capacity=8)
    for i, v in enumerate([5.0, 1.0, 9.0, 2.0]):
        device.process_record("k", v, i)
        device.flush()
    assert [r for _, _, r, _ in device.drain_output()] == [5.0, 9.0]


@pytest.mark.parametrize("pkg", PKGS)
def test_global_count_snapshot_restore(pkg):
    op = make_op(pkg, "sum", count_n=4, purging=True, key_capacity=8)
    op.process_record("a", 1.0, 0)
    op.process_record("a", 2.0, 1)
    op.flush()
    snap = op.snapshot()
    op2 = make_op(pkg, "sum", count_n=4, purging=True, key_capacity=8)
    op2.restore(snap)
    op2.process_record("a", 3.0, 2)
    op2.process_record("a", 4.0, 3)
    op2.flush()
    out = op2.drain_output()
    assert len(out) == 1 and out[0][2] == 10.0


def _batches(seed, n_batches=12, batch=300, keys=40):
    rng = np.random.default_rng(seed)
    for b in range(n_batches):
        k = np.where(rng.random(batch) < 0.3, 0, rng.integers(0, keys, batch)).astype(np.int64)
        yield k, rng.integers(0, 9, batch).astype(np.float32), np.full(batch, b, np.int64)


def _run(pkg, agg, n, purging, seed=3):
    op = make_op(pkg, agg, count_n=n, purging=purging, key_capacity=8, dense_int_keys=True)
    out = []
    for k, v, ts in _batches(seed):
        op.process_batch(k, v, ts)
        out += rows(op.drain_output())
    return out, op


@pytest.mark.parametrize("purging", [True, False])
@pytest.mark.parametrize("agg", ["sum", "count", "min", "max", "mean"])
def test_batched_coalesced_parity(agg, purging):
    port, pop = _run("port", agg, 7, purging)
    jax, _jop = _run("jax", agg, 7, purging)
    assert len(port) == len(jax) > 0
    assert [(k, t) for k, _r, t in port] == [(k, t) for k, _r, t in jax]
    np.testing.assert_allclose([r for _k, r, _t in port], [r for _k, r, _t in jax], rtol=1e-6)
    assert all(t == MAX_WATERMARK for _k, _r, t in port)
    # the hot key crosses several multiples of 7 in one batch and fires once
    assert sum(1 for k, _r, _t in port if k == 0) <= 12
    assert pop.K == 64


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("purging", [True, False])
def test_snapshot_restores_across_packages(direction, purging):
    src, dst = direction.split("_to_")
    straight, _op = _run(src, "sum", 5, purging)
    a = make_op(src, "sum", count_n=5, purging=purging, key_capacity=8, dense_int_keys=True)
    batches = list(_batches(3))
    out = []
    for k, v, ts in batches[:6]:
        a.process_batch(k, v, ts)
        out += rows(a.drain_output())
    b = make_op(dst, "sum", count_n=5, purging=purging, key_capacity=8, dense_int_keys=True)
    b.restore(a.snapshot())
    for k, v, ts in batches[6:]:
        b.process_batch(k, v, ts)
        out += rows(b.drain_output())
    assert out == straight


def test_state_and_step_counts():
    op = make_op("port", "sum", count_n=2, purging=True, key_capacity=4)
    tgw.CALLS["global_count_step"] = 0
    op.process_batch(np.array(["a", "b", "a"], dtype=object), np.ones(3, np.float32),
                     np.zeros(3, np.int64))
    assert tgw.CALLS["global_count_step"] == 1
    assert rows(op.drain_output()) == [("a", 2.0, MAX_WATERMARK)]
    # acc, count and fired: [K] each
    assert op.state_bytes() == 3 * 4 * 4 and op.state_key_count() == 2
