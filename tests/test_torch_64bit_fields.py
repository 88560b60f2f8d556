"""Aggregates declared with 64-bit fields, held against the JAX package
(ROADMAP C1).

The JAX package runs with x64 off, so a `sum_agg(np.float64)` or
`sum_agg(np.int64)` field is a 32-bit device array there. The port gives
such fields the same 32-bit dtypes (`ops/aggregators.py::device_dtype`).
ROADMAP C1's inputs (values 16777216.0 and 1.0, and 0.1 and 0.2, one key,
one 1 s tumbling window) go through both packages' `TpuWindowOperator`,
`FusedWindowOperator` (after `flush_all()`), `TpuGlobalWindowOperator`
and the session operator, the port's on the CPU. C3's inputs (16777216.0
and 1.0, and 0.5 and 0.5) hold the fused operator's int sum fields, which
both packages sum per cell in float32 before the cast.

Tolerance: exact, by `repr` of every emitted value. The session operator
is held against the JAX operator's 32-bit aggregate for a float sum or
mean: the JAX session operator's host merge truncates a float64 sum's
cells to integers, a reference fault the port does not reproduce
(`runtime/tpu_session_operator.py` docstring).
"""

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")

from flink_tpu.api.windowing import assigners as jasg  # noqa: E402
from flink_tpu.ops import aggregators as jagg  # noqa: E402
from flink_tpu.runtime.fused_window_operator import FusedWindowOperator as JaxFused  # noqa: E402
from flink_tpu.runtime.tpu_global_window_operator import (  # noqa: E402
    TpuGlobalWindowOperator as JaxGlobal,
)
from flink_tpu.runtime.tpu_session_operator import (  # noqa: E402
    TpuSessionWindowOperator as JaxSession,
)
from flink_tpu.runtime.tpu_window_operator import TpuWindowOperator as JaxWindow  # noqa: E402
from flink_tpu_torch.api.windowing import assigners as tasg  # noqa: E402
from flink_tpu_torch.ops import aggregators as tagg  # noqa: E402
from flink_tpu_torch.runtime.fused_window_operator import FusedWindowOperator  # noqa: E402
from flink_tpu_torch.runtime.tpu_global_window_operator import (  # noqa: E402
    TpuGlobalWindowOperator,
)
from flink_tpu_torch.runtime.tpu_session_operator import TpuSessionWindowOperator  # noqa: E402
from flink_tpu_torch.runtime.tpu_window_operator import TpuWindowOperator  # noqa: E402
from jax_native_twins import jax_native_library  # noqa: E402,F401

C1_VALUES = ([16777216.0, 1.0], [0.1, 0.2])
#: ROADMAP C3's inputs: a per-record cast would round neither away
C3_VALUES = ([16777216.0, 1.0], [0.5, 0.5])
AGGS = [("sum", np.float64), ("mean", np.float64), ("min", np.float64),
        ("max", np.float64), ("sum", np.int64)]


def _drive(op, vals):
    op.process_batch(np.array([1, 1]), np.array(vals, np.float32), np.array([10, 20]))
    op.process_watermark(5000)
    if hasattr(op, "flush_all"):
        op.flush_all()
    return [(k, w.start, w.end, repr(r), t) for k, w, r, t in op.drain_output()]


def _aggs(name, dtype):
    return getattr(jagg, f"{name}_agg")(dtype), getattr(tagg, f"{name}_agg")(dtype)


@pytest.mark.parametrize("vals", C1_VALUES)
@pytest.mark.parametrize("name,dtype", AGGS)
def test_window_operator_computes_64bit_fields_in_32_bits(name, dtype, vals):
    ja, ta = _aggs(name, dtype)
    want = _drive(JaxWindow(jasg.TumblingEventTimeWindows.of(1000), ja), vals)
    got = _drive(TpuWindowOperator(tasg.TumblingEventTimeWindows.of(1000), ta,
                                   device="cpu"), vals)
    assert got == want and len(got) == 1
    if vals == C1_VALUES[0] and name == "sum" and dtype == np.float64:
        assert want[0][3] == "16777216.0"      # the float32 sum, not 16777217


@pytest.mark.parametrize("vals", C1_VALUES)
@pytest.mark.parametrize("name,dtype", AGGS)
def test_fused_operator_computes_64bit_fields_in_32_bits(name, dtype, vals):
    ja, ta = _aggs(name, dtype)
    want = _drive(JaxFused(jasg.TumblingEventTimeWindows.of(1000), ja), vals)
    got = _drive(FusedWindowOperator(tasg.TumblingEventTimeWindows.of(1000), ta,
                                     device="cpu"), vals)
    assert got == want and len(got) == 1
    if vals == C1_VALUES[1] and name == "sum" and dtype == np.float64:
        assert want[0][3] == "0.30000001192092896"


@pytest.mark.parametrize("vals", C3_VALUES)
@pytest.mark.parametrize("dtype", [np.int64, np.int32])
def test_fused_operator_sums_int_fields_per_cell_in_float32(dtype, vals):
    # C3: the fused ingest sums a step's records per (key, slice) cell in
    # float32 and casts that partial to int32 once, in both packages (the
    # JAX operator's superscan on the CPU takes the matmul-histogram
    # ingest, `_build_superscan`); a cast per record would give 16777217
    # and 0
    ja, ta = jagg.sum_agg(dtype), tagg.sum_agg(dtype)
    want = _drive(JaxFused(jasg.TumblingEventTimeWindows.of(1000), ja), vals)
    got = _drive(FusedWindowOperator(tasg.TumblingEventTimeWindows.of(1000), ta,
                                     device="cpu"), vals)
    assert got == want and len(got) == 1
    assert want[0][3] == ("16777216" if vals == C3_VALUES[0] else "1")


@pytest.mark.parametrize("vals", C1_VALUES)
def test_global_count_operator_computes_64bit_sums_in_32_bits(vals):
    out = []
    for op in (JaxGlobal(jagg.sum_agg(np.float64), count_n=2, purging=True),
               TpuGlobalWindowOperator(tagg.sum_agg(np.float64), count_n=2, purging=True,
                                       device="cpu")):
        op.process_batch(np.array([1, 1]), np.array(vals, np.float32), np.array([10, 20]))
        out.append([(k, repr(r)) for k, _w, r, _t in op.drain_output()])
    assert out[0] == out[1] and len(out[0]) == 1


@pytest.mark.parametrize("vals", C1_VALUES)
@pytest.mark.parametrize("name,dtype,jax_dtype", [
    ("sum", np.float64, np.float32), ("mean", np.float64, np.float32),
    ("min", np.float64, np.float64), ("max", np.float64, np.float64),
    ("sum", np.int64, np.int64),
])
def test_session_operator_computes_64bit_fields_in_32_bits(name, dtype, jax_dtype, vals):
    want = _drive(JaxSession(jasg.EventTimeSessionWindows.with_gap(1000),
                             getattr(jagg, f"{name}_agg")(jax_dtype)), vals)
    op = TpuSessionWindowOperator(tasg.EventTimeSessionWindows.with_gap(1000),
                                  getattr(tagg, f"{name}_agg")(dtype), device="cpu")
    got = _drive(op, vals)
    assert got == want and len(got) == 1
    assert all(f.dtype.itemsize == 4 for f in op._fields)


def test_the_jax_session_host_merge_truncates_float64_sums():
    """The reference fault the port leaves out, pinned where it lives: a
    float64 sum merged on the JAX session operator's host path comes out
    truncated to an integer, where the port gives the float32 sum."""
    want = _drive(JaxSession(jasg.EventTimeSessionWindows.with_gap(1000),
                             jagg.sum_agg(np.float64)), [0.1, 0.2])
    got = _drive(TpuSessionWindowOperator(tasg.EventTimeSessionWindows.with_gap(1000),
                                          tagg.sum_agg(np.float64), device="cpu"), [0.1, 0.2])
    assert [r[3] for r in want] == ["0"]
    assert [r[3] for r in got] == ["0.30000001192092896"]


def test_device_dtypes_and_identities_are_the_jax_packages():
    for dt, dev in ((np.float64, np.float32), (np.int64, np.int32), (np.float32, np.float32),
                    (np.int32, np.int32)):
        assert tagg.device_dtype(dt) == np.dtype(dev)
        assert tagg.torch_dtype(dt).itemsize == 4
    for name in ("min", "max"):
        for dt in (np.float64, np.float32):
            f = getattr(tagg, f"{name}_agg")(dt).fields[0]
            ref = np.asarray(jnp.full((1,), getattr(jagg, f"{name}_agg")(dt).fields[0].identity,
                                      dtype=dt))[0]
            assert f.device_identity == ref.item()
