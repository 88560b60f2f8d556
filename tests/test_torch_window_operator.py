"""The port's per-batch window operator held against the JAX package's.

The cases of `tests/test_tpu_window_operator.py` (tumbling, sliding,
offset, non-divisible, late re-fire, touched-key re-fire, side output,
ring overflow, key growth, columnar ingest, random parity with lateness)
run on both packages' `TpuWindowOperator` (the port's with
`device="cpu"`), with the JAX test's expected values, and the two
packages' emissions are compared record for record. The random cases also
hold both against the JAX package's per-record oracle operator, as the
JAX tests do; batched random streams (many records a batch, masked late
re-fires that coalesce) compare the two packages directly, for both
ingest forms and with the late side output. Snapshots taken in either
package restore in the other and continue at parity.

Tolerance: exact. Payloads are small integers, so float32 sums are exact
in any order; a mean is compared to rtol 1e-6.
"""

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")

from flink_tpu.api.windowing import assigners as jasg  # noqa: E402
from flink_tpu.ops.aggregators import BUILTINS  # noqa: E402
from flink_tpu.runtime.oracle_window_operator import OracleWindowOperator  # noqa: E402
from flink_tpu.runtime.tpu_window_operator import TpuWindowOperator as JaxOp  # noqa: E402
from flink_tpu.testing.harness import KeyedWindowOperatorHarness  # noqa: E402
from flink_tpu_torch.api.windowing import assigners as tasg  # noqa: E402
from flink_tpu_torch.runtime.tpu_window_operator import TpuWindowOperator as PortOp  # noqa: E402

PKGS = ("jax", "port")


def tumbling(pkg, size, **kw):
    return (jasg if pkg == "jax" else tasg).TumblingEventTimeWindows.of(size, **kw)


def sliding(pkg, size, slide):
    return (jasg if pkg == "jax" else tasg).SlidingEventTimeWindows.of(size, slide)


def make_op(pkg, assigner, agg="sum", **kw):
    if pkg == "jax":
        return JaxOp(assigner, agg, **kw)
    return PortOp(assigner, agg, device="cpu", **kw)


def h(pkg, assigner, agg="sum", **kw):
    return KeyedWindowOperatorHarness(make_op(pkg, assigner, agg, **kw))


def norm(out):
    """Emissions with each package's TimeWindow as (start, end)."""
    return [(k, (w.start, w.end), r, t) for k, w, r, t in out]


# ---------------------------------------------------------------------------
# the cases of tests/test_tpu_window_operator.py, on both packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", PKGS)
def test_tumbling_sum_basic(pkg):
    t = h(pkg, tumbling(pkg, 1000))
    t.process_elements((("a", 1.0), 100), (("a", 2.0), 900), (("b", 5.0), 500))
    t.process_watermark(999)
    assert sorted(norm(t.extract_output())) == [
        ("a", (0, 1000), 3.0, 999), ("b", (0, 1000), 5.0, 999)]


@pytest.mark.parametrize("pkg", PKGS)
def test_tumbling_fire_order_and_timestamps(pkg):
    t = h(pkg, tumbling(pkg, 1000))
    t.process_elements((("a", 1.0), 100), (("a", 2.0), 1100), (("a", 4.0), 2100))
    t.process_watermark(5000)
    out = t.extract_output()
    assert [r for (_, _, r, _) in out] == [1.0, 2.0, 4.0]
    assert [ts for (_, _, _, ts) in out] == [999, 1999, 2999]


@pytest.mark.parametrize("pkg", PKGS)
def test_sliding_count_five_windows(pkg):
    t = h(pkg, sliding(pkg, 10_000, 2_000), agg="count")
    t.process_element(("k", 1.0), 10_500)
    t.process_watermark(30_000)
    out = t.extract_output()
    assert sorted(w.end for (_, w, _, _) in out) == [12_000, 14_000, 16_000, 18_000, 20_000]
    assert all(r == 1 and isinstance(r, int) for (_, _, r, _) in out)


@pytest.mark.parametrize("pkg", PKGS)
def test_no_fire_before_watermark(pkg):
    t = h(pkg, tumbling(pkg, 1000))
    t.process_element(("a", 1.0), 100)
    t.process_watermark(998)
    assert t.extract_output() == []
    t.process_watermark(999)
    assert len(t.extract_output()) == 1


@pytest.mark.parametrize("pkg", PKGS)
def test_late_refire_within_lateness(pkg):
    t = h(pkg, tumbling(pkg, 1000), allowed_lateness=500)
    t.process_element(("a", 1.0), 100)
    t.process_watermark(999)
    assert t.extract_results() == [("a", 1.0)]
    t.process_element(("a", 2.0), 200)
    t.process_watermark(999)
    assert t.extract_results() == [("a", 3.0)]
    t.process_watermark(1499)
    t.process_element(("a", 7.0), 300)
    t.process_watermark(1499)
    assert t.extract_results() == []
    assert t.op.num_late_records_dropped == 1


@pytest.mark.parametrize("pkg", PKGS)
def test_refire_only_touched_keys(pkg):
    t = h(pkg, tumbling(pkg, 1000), allowed_lateness=1000)
    t.process_elements((("a", 1.0), 100), (("b", 2.0), 200))
    t.process_watermark(999)
    assert sorted(t.extract_results()) == [("a", 1.0), ("b", 2.0)]
    t.process_element(("a", 10.0), 300)
    t.process_watermark(1000)
    assert t.extract_results() == [("a", 11.0)]


@pytest.mark.parametrize("pkg", PKGS)
def test_late_side_output(pkg):
    t = h(pkg, tumbling(pkg, 1000), emit_late_to_side_output=True)
    t.process_element(("a", 1.0), 100)
    t.process_watermark(999)
    t.extract_output()
    t.process_element(("a", 2.0), 150)
    t.process_watermark(1000)
    assert t.side_output("late-data") == [("a", 2.0, 150)]
    assert t.op.num_late_records_dropped == 0


@pytest.mark.parametrize("pkg", PKGS)
def test_sliding_late_refires_all_live_windows(pkg):
    t = h(pkg, sliding(pkg, 2000, 1000), allowed_lateness=5000)
    t.process_element(("k", 1.0), 1500)
    t.process_watermark(2999)
    assert len(t.extract_output()) == 2
    t.process_element(("k", 2.0), 1600)
    t.process_watermark(3000)
    out = sorted(norm(t.extract_output()), key=lambda o: o[1])
    assert [(o[1], o[2]) for o in out] == [((0, 2000), 3.0), ((1000, 3000), 3.0)]


@pytest.mark.parametrize("pkg", PKGS)
def test_key_capacity_growth(pkg):
    t = h(pkg, tumbling(pkg, 1000), key_capacity=4)
    for i in range(37):
        t.process_element((f"key-{i}", 1.0), 100)
    t.process_watermark(999)
    out = t.extract_output()
    assert len(out) == 37
    assert t.op.state.K == 64


@pytest.mark.parametrize("pkg", PKGS)
def test_ring_overflow_future_records_buffered(pkg):
    t = h(pkg, tumbling(pkg, 1000), num_slices=8)
    t.process_element(("a", 1.0), 500)
    t.process_element(("b", 2.0), 100_500)
    t.process_watermark(999)
    assert t.extract_results() == [("a", 1.0)]
    assert len(t.op._future) == 1
    t.process_watermark(100_999)
    assert t.extract_results() == [("b", 2.0)]
    assert not t.op._future


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("name,expected", [("sum", 6.0), ("count", 3), ("max", 3.0),
                                           ("min", 1.0), ("mean", 2.0)])
def test_aggregators_on_device(pkg, name, expected):
    t = h(pkg, tumbling(pkg, 1000), agg=name)
    t.process_elements((("a", 1.0), 0), (("a", 2.0), 1), (("a", 3.0), 2))
    t.process_watermark(999)
    assert t.extract_results() == [("a", pytest.approx(expected))]


@pytest.mark.parametrize("pkg", PKGS)
def test_columnar_batch_ingest_path(pkg):
    op = make_op(pkg, tumbling(pkg, 1000), dense_int_keys=True)
    keys = np.array([0, 1, 0, 2, 1], dtype=np.int64)
    vals = np.array([1, 2, 3, 4, 5], dtype=np.float32)
    ts = np.array([100, 200, 300, 1500, 1600], dtype=np.int64)
    op.process_batch(keys, vals, ts)
    op.process_watermark(1999)
    assert sorted(norm(op.drain_output())) == [
        (0, (0, 1000), 4.0, 999), (1, (0, 1000), 2.0, 999),
        (1, (1000, 2000), 5.0, 1999), (2, (1000, 2000), 4.0, 1999)]


def test_columnar_output_matches_jax():
    """columnar_output: one packed (key ids, values) row a fired window."""
    outs = {}
    for pkg in PKGS:
        op = make_op(pkg, sliding(pkg, 2000, 1000), dense_int_keys=True, columnar_output=True,
                     allowed_lateness=1000)
        op.process_batch(np.array([3, 1, 3, 2]), np.array([1, 2, 3, 4], np.float32),
                         np.array([100, 900, 1500, 2500]))
        op.process_watermark(2999)
        op.process_batch(np.array([1]), np.array([5], np.float32), np.array([1200]))
        op.process_watermark(3999)
        outs[pkg] = [(k, (w.start, w.end), np.asarray(ids).tolist(), np.asarray(v).tolist(), t)
                     for k, w, (ids, v), t in op.drain_output()]
    assert outs["port"] == outs["jax"]
    assert all(k is None for k, *_ in outs["port"]) and len(outs["port"]) == 5


@pytest.mark.parametrize("pkg", PKGS)
def test_snapshot_restore_roundtrip(pkg):
    t = h(pkg, tumbling(pkg, 1000))
    t.process_elements((("a", 1.0), 100), (("b", 2.0), 200))
    snap = t.snapshot()
    t2 = h(pkg, tumbling(pkg, 1000))
    t2.restore(snap)
    t2.process_element(("a", 10.0), 300)
    t2.process_watermark(999)
    assert sorted(t2.extract_results()) == [("a", 11.0), ("b", 2.0)]


# ---------------------------------------------------------------------------
# random parity: per-record batches against the oracle (the JAX tests'
# criterion) and against each other; batched streams against each other
# ---------------------------------------------------------------------------

def _run_per_record(pkg, assigner_fn, agg, records, wm_stride, lateness=0):
    tpu = h(pkg, assigner_fn(pkg), agg=agg, allowed_lateness=lateness, num_slices=256)
    max_ts = 0
    for i, (key, val, ts) in enumerate(records):
        tpu.process_element((key, val), ts)
        tpu.op.flush()
        max_ts = max(max_ts, ts)
        if (i + 1) % wm_stride == 0:
            tpu.process_watermark(max_ts - 700)
    tpu.process_watermark(max_ts + 10**6)
    return norm(tpu.extract_output()), tpu.op.num_late_records_dropped


def _oracle(assigner_fn, agg, records, wm_stride, lateness=0):
    orc = KeyedWindowOperatorHarness(OracleWindowOperator(
        assigner_fn("jax"), BUILTINS[agg]().python_equivalent(), allowed_lateness=lateness))
    max_ts = 0
    for i, (key, val, ts) in enumerate(records):
        orc.process_element((key, val), ts)
        max_ts = max(max_ts, ts)
        if (i + 1) % wm_stride == 0:
            orc.process_watermark(max_ts - 700)
    orc.process_watermark(max_ts + 10**6)
    return norm(orc.extract_output()), orc.op.num_late_records_dropped


def _last_per_window(out):
    return {(k, w): (round(float(r), 3), t) for k, w, r, t in out}


def _records(seed, n, keys, vals_hi, ts_hi, unit=False):
    rng = np.random.default_rng(seed)
    return [(f"k{rng.integers(0, keys)}", 1.0 if unit else float(rng.integers(1, vals_hi)),
             int(rng.integers(0, ts_hi))) for _ in range(n)]


RANDOM_CASES = {
    "tumbling_sum": (lambda p: tumbling(p, 1000), "sum", (42, 400, 7, 10, 20_000), 25, 0),
    "tumbling_count": (lambda p: tumbling(p, 1000), "count", (42, 400, 7, 10, 20_000), 25, 0),
    "tumbling_max": (lambda p: tumbling(p, 1000), "max", (42, 400, 7, 10, 20_000), 25, 0),
    "tumbling_mean": (lambda p: tumbling(p, 1000), "mean", (42, 400, 7, 10, 20_000), 25, 0),
    "sliding_with_lateness": (lambda p: sliding(p, 3000, 1000), "sum",
                              (7, 300, 5, 10, 15_000), 20, 500),
    "sliding_nondivisible": (lambda p: sliding(p, 2100, 900), "sum",
                             (3, 200, 4, 5, 10_000), 15, 0),
    "offset": (lambda p: tumbling(p, 1000, offset_ms=250), "count",
               (11, 150, 3, 2, 8_000), 10, 0),
}


@pytest.mark.parametrize("case", sorted(RANDOM_CASES))
def test_parity_random_per_record(case):
    assigner_fn, agg, rec, stride, lateness = RANDOM_CASES[case]
    records = _records(*rec, unit=case == "offset")
    port, port_dropped = _run_per_record("port", assigner_fn, agg, records, stride, lateness)
    jax, jax_dropped = _run_per_record("jax", assigner_fn, agg, records, stride, lateness)
    orc, orc_dropped = _oracle(assigner_fn, agg, records, stride, lateness)
    if agg == "mean":
        assert [o[:2] + o[3:] for o in port] == [o[:2] + o[3:] for o in jax]
        np.testing.assert_allclose([o[2] for o in port], [o[2] for o in jax], rtol=1e-6)
    else:
        assert port == jax
    assert _last_per_window(port) == _last_per_window(orc)
    assert len(port) == len(orc)
    assert port_dropped == jax_dropped == orc_dropped


def _batched_stream(seed, batches=24, batch=400, keys=50, span_ms=1000, late_frac=0.05,
                    too_late_frac=0.01):
    """Batches of ~span_ms of event time with a watermark trailing 300 ms
    after each; some records 1-2 s behind it (re-fires with lateness) and a
    few 15 s behind (past cleanup)."""
    rng = np.random.default_rng(seed)
    out = []
    for b in range(batches):
        lo = b * span_ms
        ts = rng.integers(lo, lo + span_ms, batch)
        late = rng.random(batch) < late_frac
        ts = np.where(late, ts - rng.integers(1000, 2000, batch), ts)
        too_late = rng.random(batch) < too_late_frac
        ts = np.maximum(np.where(too_late, ts - 15_000, ts), 0)
        k = rng.integers(0, keys, batch).astype(np.int64)
        v = rng.integers(0, 9, batch).astype(np.float32)
        out.append((k, v, ts.astype(np.int64), lo + span_ms - 300))
    return out


def _run_batched(pkg, stream, agg="sum", **kw):
    op = make_op(pkg, sliding(pkg, 4000, 1000), agg, dense_int_keys=True, key_capacity=16,
                 **kw)
    emitted = []
    for k, v, ts, wm in stream:
        op.process_batch(k, v, ts)
        op.process_watermark(wm)
        emitted += norm(op.drain_output())
    op.process_watermark(10**9)
    emitted += norm(op.drain_output())
    return emitted, op


@pytest.mark.parametrize("kernel", ["scatter", "sort"])
@pytest.mark.parametrize("agg", ["sum", "count", "min", "max"])
def test_parity_batched_with_lateness_and_side_output(agg, kernel):
    stream = _batched_stream(5)
    kw = dict(allowed_lateness=2000, emit_late_to_side_output=True, ingest_kernel=kernel)
    port, pop = _run_batched("port", stream, agg, **kw)
    jax, jop = _run_batched("jax", stream, agg, **kw)
    assert port == jax and len(port) > 0
    assert pop.side_output == jop.side_output and len(pop.side_output["late-data"]) > 0
    # masked re-fires happened: some (key, window) emitted more than once
    assert len({(k, w) for k, w, _r, _t in port}) < len(port)


def test_parity_batched_drops_too_late_records():
    stream = _batched_stream(6)
    port, pop = _run_batched("port", stream, allowed_lateness=1500)
    jax, jop = _run_batched("jax", stream, allowed_lateness=1500)
    assert port == jax
    assert pop.num_late_records_dropped == jop.num_late_records_dropped > 0


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_snapshot_restores_across_packages(direction):
    """A snapshot taken mid-stream in one package restores in the other,
    which then continues exactly as the first would have."""
    src, dst = direction.split("_to_")
    stream = _batched_stream(7, batches=16)
    kw = dict(allowed_lateness=2000, emit_late_to_side_output=True)
    straight, _op = _run_batched(src, stream, **kw)
    a = make_op(src, sliding(src, 4000, 1000), dense_int_keys=True, key_capacity=16, **kw)
    first = []
    for k, v, ts, wm in stream[:8]:
        a.process_batch(k, v, ts)
        a.process_watermark(wm)
        first += norm(a.drain_output())
    snap = a.snapshot()
    assert snap["columnar"]["count"].shape == (a.state.K, a.state.S)
    b = make_op(dst, sliding(dst, 4000, 1000), dense_int_keys=True, key_capacity=16, **kw)
    b.restore(snap)
    rest = []
    for k, v, ts, wm in stream[8:]:
        b.process_batch(k, v, ts)
        b.process_watermark(wm)
        rest += norm(b.drain_output())
    b.process_watermark(10**9)
    rest += norm(b.drain_output())
    assert first + rest == straight
    np.testing.assert_array_equal(b.snapshot()["columnar"]["count"],
                                  _run_batched(src, stream, **kw)[1].snapshot()["columnar"]["count"])


def test_port_operator_state_is_slice_major():
    op = make_op("port", tumbling("port", 1000), key_capacity=8, num_slices=16)
    assert tuple(op.state.count.shape) == (16, 8)
    assert op.state_row_bytes() == 16 * 4 * 2
    op.process_batch(np.array(["a", "b", "a"], dtype=object), np.ones(3, np.float32),
                     np.array([1, 2, 3]))
    assert op.key_loads().tolist()[:2] == [2, 1]
    assert op.key_stats_ready()


def test_unported_options_raise_naming_their_item():
    # the hot/cold key split is ported (
    # tests/test_torch_state_tiering.py runs it against the JAX operator)
    op = make_op("port", tumbling("port", 1000), hot_key_capacity=4)
    assert op.cold_tier is not None and op.state.K <= 4
    # the emission tracker is ported: it stamps each fired window, as the
    # JAX operator's does, on the same injected clock
    stamped = {}
    for pkg in ("jax", "port"):
        from importlib import import_module

        el = import_module(("flink_tpu" if pkg == "jax" else "flink_tpu_torch")
                           + ".metrics.emission_latency")
        op = make_op(pkg, tumbling(pkg, 1000), allowed_lateness=500)
        assert op.emission_tracker is None
        op.emission_tracker = el.EmissionLatencyTracker("w", clock=lambda: 5.0)
        op.process_batch(np.array(["a", "b", "a"], dtype=object), np.ones(3, np.float32),
                         np.array([100, 1200, 2500]))
        op.process_watermark(3999)
        stamped[pkg] = op.emission_tracker.snapshot()
    assert stamped["port"] == stamped["jax"] and stamped["port"]["count"] == 3
