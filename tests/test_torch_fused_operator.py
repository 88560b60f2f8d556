"""The port's traced-chain prologue, key dictionary and FusedWindowOperator
held against the JAX package's.

- Prologue: `process_superbatch_raw` of both pipelines over the same raw
  columns (JAX: the chained XLA superscan; port: the torch prologue, then
  the plain version of K1), with jnp UDFs on one side and torch UDFs on the
  other.
- Key dictionary: the port's vectorized integer path hands out the ids the
  JAX dictionary hands out, and snapshots cross.
- Operator: both packages' FusedWindowOperator over the same batches and
  watermarks, in row and columnar output, with key-capacity growth, and
  with snapshots crossing between the packages mid-stream.

Tolerance: exact. Payloads are small integer-valued floats, so every
float32 partial sum is an exact integer whatever the add order; rows are
compared for keys whose window count is above 0 (other rows are
meaningless).
"""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from flink_tpu.api.windowing import assigners as jasg
from flink_tpu.core.time import MAX_WATERMARK
from flink_tpu.runtime import fused_window_operator as jfo
from flink_tpu.runtime import fused_window_pipeline as jfp
from flink_tpu.state.columnar import KeyDictionary as JaxKeyDictionary
from flink_tpu_torch.api.windowing import assigners as tasg
from flink_tpu_torch.runtime import fused_window_operator as tfo
from flink_tpu_torch.runtime import fused_window_pipeline as tfp
from flink_tpu_torch.state.columnar import KeyDictionary

NUM_KEYS = 64
GEOMETRY = dict(key_capacity=NUM_KEYS, num_slices=16, nsb=4, fires_per_step=4,
                out_rows=16, chunk=256)


def _window(m):
    return m.SlidingEventTimeWindows.of(2000, 500)


def _raw_stream(steps, batch, seed, late_every=0, key_hi=NUM_KEYS):
    """Raw 3-column records (key, value, kind) as float32, timestamps mildly
    out of order; every `late_every`-th step carries 25 records far behind
    the watermark."""
    rng = np.random.default_rng(seed)
    out, wms = [], []
    t_cursor, wm = 5000.0, None
    for t in range(steps):
        keys = rng.integers(0, key_hi, batch)
        vals = rng.integers(-20, 21, batch)
        kinds = rng.integers(0, 3, batch)
        base = t_cursor + np.sort(rng.random(batch)) * 400.0
        ts = np.maximum(base.astype(np.int64) - rng.integers(0, 120, batch), 0)
        if late_every and wm is not None and t % late_every == 0:
            ts[:25] = wm - 2500
        out.append((np.stack([keys, vals, kinds], 1).astype(np.float32), ts))
        wm = int(base[-1]) - 150
        wms.append(wm)
        t_cursor += 400.0
    return out, wms


def _assert_emissions_equal(ref, dev):
    assert len(ref) == len(dev) and len(ref) > 0
    for (rw, rc, rf), (dw, dc, df) in zip(ref, dev):
        assert (rw.start, rw.end) == (dw.start, dw.end)
        rc, dc = np.asarray(rc), np.asarray(dc)
        assert np.array_equal(rc, dc)
        live = rc > 0
        assert set(rf) == set(df)
        for name in rf:
            a, b = np.asarray(rf[name]), np.asarray(df[name])
            assert a.dtype == b.dtype
            assert np.array_equal(a[live], b[live])


# (jax transforms, torch transforms, jax value_fn, torch value_fn, aggregate)
PROLOGUES = {
    "filter_map_key_count": (
        (("filter", lambda c: c[:, 2] < 2), ("map", lambda c: c * jnp.asarray([1.0, 2.0, 1.0]))),
        (("filter", lambda c: c[:, 2] < 2), ("map", lambda c: c * torch.tensor([1.0, 2.0, 1.0]))),
        None, None, "count"),
    "map_ts_sum": (
        (("map_ts", lambda c, ts: jnp.stack(
            [c[:, 0], c[:, 1] + (ts % 5).astype(jnp.float32)], axis=1)),),
        (("map_ts", lambda c, ts: torch.stack(
            [c[:, 0], c[:, 1] + (ts % 5).to(torch.float32)], dim=1)),),
        lambda c: c[:, 1], lambda c: c[:, 1], "sum"),
    "value_fn_sum": (
        (("filter", lambda c: c[:, 2] != 1),), (("filter", lambda c: c[:, 2] != 1),),
        lambda c: c[:, 1] * 3.0, lambda c: c[:, 1] * 3.0, "sum"),
    "value_fn_min": ((), (), lambda c: c[:, 1], lambda c: c[:, 1], "min"),
    "value_fn_max": ((), (), lambda c: c[:, 1], lambda c: c[:, 1], "max"),
}


def _prologue_pipes(case):
    jt, tt, jv, tv, agg = PROLOGUES[case]
    jkey = lambda c: c[:, 0].astype(jnp.int32)            # noqa: E731
    tkey = lambda c: c[:, 0].to(torch.int32)              # noqa: E731
    jax_pipe = jfp.FusedWindowPipeline(
        _window(jasg), agg, prologue=jfp.TracedPrologue(jt, jkey, jv), **GEOMETRY)
    port_pipe = tfp.FusedWindowPipeline(
        _window(tasg), agg, prologue=tfp.TracedPrologue(tt, tkey, tv), device="cpu",
        **GEOMETRY)
    return jax_pipe, port_pipe


@pytest.mark.parametrize("case", sorted(PROLOGUES))
def test_prologue_matches_jax_chained_superscan(case):
    steps, wms = _raw_stream(6, 500, seed=len(case), late_every=2)
    jax_pipe, port_pipe = _prologue_pipes(case)
    for lo, hi in ((0, 3), (3, 6)):
        ref = jax_pipe.process_superbatch_raw(steps[lo:hi], wms[lo:hi])
        dev = port_pipe.process_superbatch_raw(steps[lo:hi], wms[lo:hi])
        _assert_emissions_equal(ref, dev)
    assert port_pipe.num_late_records_dropped == jax_pipe.num_late_records_dropped > 0
    # a watermark-only dispatch fires and purges through the plain path
    empty = [(np.empty((0, 3), np.float32), np.empty(0, np.int64))] * 2
    tail = [wms[-1] + 3000, wms[-1] + 9000]
    _assert_emissions_equal(jax_pipe.process_superbatch_raw(empty, tail),
                            port_pipe.process_superbatch_raw(empty, tail))


def test_prologue_deferred_dispatches_and_staged_geometry():
    """Deferred dispatches resolve in order, and a ragged step width pads
    to the power-of-two multiple of the chunk the JAX pipeline stages."""
    steps, wms = _raw_stream(6, 300, seed=4)
    steps[4] = (steps[4][0][:37], steps[4][1][:37])
    jax_pipe, port_pipe = _prologue_pipes("filter_map_key_count")
    d1 = port_pipe.process_superbatch_raw(steps[:3], wms[:3], defer=True)
    d2 = port_pipe.process_superbatch_raw(steps[3:], wms[3:], defer=True)
    _assert_emissions_equal(jax_pipe.process_superbatch_raw(steps[:3], wms[:3]), d1.resolve())
    _assert_emissions_equal(jax_pipe.process_superbatch_raw(steps[3:], wms[3:]), d2.resolve())
    raw, srel, ts, _plan = port_pipe.stage_superbatch_raw(steps[:3], wms[:3])
    assert srel.shape == (3 * 512,) and raw.shape == (3 * 512, 3) and ts is None


def test_out_of_range_key_raises_in_both_packages():
    steps, wms = _raw_stream(3, 400, seed=8, key_hi=NUM_KEYS + 5)
    jax_pipe, port_pipe = _prologue_pipes("filter_map_key_count")
    with pytest.raises(ValueError, match="outside \\[0, 64\\)"):
        jax_pipe.process_superbatch_raw(steps, wms)
    with pytest.raises(ValueError, match="outside \\[0, 64\\)"):
        port_pipe.process_superbatch_raw(steps, wms)


def test_timestamps_that_do_not_fit_int32_raise_under_map_ts():
    steps, wms = _raw_stream(2, 100, seed=9)
    big = 1 << 40
    steps = [(raw, ts + big) for raw, ts in steps]
    _jax_pipe, port_pipe = _prologue_pipes("map_ts_sum")
    with pytest.raises(TypeError, match="do not fit"):
        port_pipe.process_superbatch_raw(steps, [w + big for w in wms])


# ---------------------------------------------------------------------------
# key dictionary
# ---------------------------------------------------------------------------

def test_key_dictionary_ids_and_snapshots_match_jax():
    rng = np.random.default_rng(2)
    ours, ref = KeyDictionary(), JaxKeyDictionary()
    for n in (50, 300, 1, 0, 700):
        keys = rng.integers(-1000, 1000, n) * 7919
        ids, cap = ours.lookup_or_insert(keys)
        ref_ids, ref_cap = ref.lookup_or_insert(keys)
        assert np.array_equal(ids, np.asarray(ref_ids)) and cap == ref_cap
    assert ours.snapshot() == ref.snapshot()
    # snapshots cross in both directions and keep handing out the same ids
    back = KeyDictionary.restore(ref.snapshot())
    again = JaxKeyDictionary.restore(ours.snapshot())
    keys = rng.integers(-2000, 2000, 400) * 7919
    a, _ = back.lookup_or_insert(keys)
    b, _ = again.lookup_or_insert(keys)
    assert np.array_equal(a, np.asarray(b))
    # a non-integer batch switches to the dict path with the same ids
    mixed = np.asarray(["x", "y", "x"], dtype=object)
    assert np.array_equal(back.lookup_or_insert(mixed)[0],
                          np.asarray(again.lookup_or_insert(mixed)[0]))
    assert back.keys_for([0, len(back) - 1]) == again.keys_for([0, len(again) - 1])


# ---------------------------------------------------------------------------
# operator
# ---------------------------------------------------------------------------

def _keyed_batches(steps, batch, seed, key_space=NUM_KEYS):
    """(raw keys, values, timestamps) batches with sparse raw keys (the key
    dictionary densifies them) and their watermarks."""
    rng = np.random.default_rng(seed)
    out, wms = [], []
    t_cursor = 7000.0
    for _t in range(steps):
        keys = rng.integers(0, key_space, batch) * 31 + 5
        vals = rng.integers(0, 9, batch).astype(np.float32)
        base = t_cursor + np.sort(rng.random(batch)) * 400.0
        ts = np.maximum(base.astype(np.int64) - rng.integers(0, 120, batch), 0)
        out.append((keys, vals, ts))
        wms.append(int(base[-1]) - 150)
        t_cursor += 400.0
    return out, wms


def _operators(agg, columnar, key_capacity=NUM_KEYS, T=4, prologue=None):
    kw = dict(key_capacity=key_capacity, superbatch_steps=T, num_slices=16, chunk=256,
              columnar_output=columnar)
    ref = jfo.FusedWindowOperator(_window(jasg), agg, prologue=prologue and prologue[0], **kw)
    dev = tfo.FusedWindowOperator(_window(tasg), agg, prologue=prologue and prologue[1],
                                  device="cpu", **kw)
    return ref, dev


def _norm_rows(rows):
    out = []
    for k, w, r, ts in rows:
        if k is None:      # packed columnar fire: (window, key ids, values)
            r = ((r[0].start, r[0].end), np.asarray(r[1]).tolist(), np.asarray(r[2]).tolist())
        out.append((k, (w.start, w.end), r, int(ts)))
    return out


def _feed(op, batches, wms, raw=False):
    for (keys, vals, ts), wm in zip(batches, wms):
        if raw:
            op.process_raw_batch(keys, ts)
        else:
            op.process_batch(keys, vals, ts)
        op.process_watermark(wm)


@pytest.mark.parametrize("columnar", [False, True], ids=["rows", "columnar"])
@pytest.mark.parametrize("agg", ["count", "sum", "max"])
def test_operator_output_matches_jax(agg, columnar):
    batches, wms = _keyed_batches(14, 300, seed=6)
    ref, dev = _operators(agg, columnar)
    _feed(ref, batches, wms)
    _feed(dev, batches, wms)
    mid_ref, mid_dev = ref.drain_output(), dev.drain_output()
    assert _norm_rows(mid_ref) == _norm_rows(mid_dev) and mid_dev
    assert dev.emitted_watermark == ref.emitted_watermark
    ref.process_watermark(MAX_WATERMARK - 1)
    dev.process_watermark(MAX_WATERMARK - 1)
    assert _norm_rows(ref.drain_output()) == _norm_rows(dev.drain_output())
    assert dev.num_late_records_dropped == ref.num_late_records_dropped


def test_operator_key_capacity_growth_with_a_dispatch_in_flight():
    """The host-keyed operator starts at 16 keys and doubles while a
    deferred dispatch is still in flight; the in-flight fires resolve
    against their own rows."""
    batches, wms = _keyed_batches(12, 200, seed=7, key_space=200)
    ref, dev = _operators("sum", False, key_capacity=16, T=3)
    _feed(ref, batches, wms)
    _feed(dev, batches, wms)
    for op in (ref, dev):
        op.process_watermark(MAX_WATERMARK - 1)
    assert dev.pipe.K == ref.pipe.K == 256
    rows = _norm_rows(dev.drain_output())
    assert len({k for k, *_ in rows}) > 16
    assert _norm_rows(ref.drain_output()) == rows


def test_traced_operator_matches_jax():
    steps, wms = _raw_stream(10, 300, seed=12, late_every=3)
    batches = [(raw, None, ts) for raw, ts in steps]
    prologue = (
        jfp.TracedPrologue((("filter", lambda c: c[:, 2] < 2),),
                           lambda c: c[:, 0].astype(jnp.int32), lambda c: c[:, 1]),
        tfp.TracedPrologue((("filter", lambda c: c[:, 2] < 2),),
                           lambda c: c[:, 0].to(torch.int32), lambda c: c[:, 1]),
    )
    for columnar in (False, True):
        ref, dev = _operators("sum", columnar, T=4, prologue=prologue)
        for op in (ref, dev):
            _feed(op, batches, wms, raw=True)
            op.process_watermark(MAX_WATERMARK - 1)
        rows = _norm_rows(dev.drain_output())
        assert rows and _norm_rows(ref.drain_output()) == rows
        assert dev.num_late_records_dropped == ref.num_late_records_dropped > 0


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_operator_snapshot_crosses_packages(direction):
    batches, wms = _keyed_batches(12, 300, seed=9)
    ref, dev = _operators("sum", False, T=4)
    _feed(ref, batches, wms)
    whole = _norm_rows(ref.drain_output())
    ref.process_watermark(MAX_WATERMARK - 1)
    whole += _norm_rows(ref.drain_output())

    first, second = _operators("sum", False, T=4)
    if direction == "port_to_jax":
        first, second = second, first
    _feed(first, batches[:6], wms[:6])
    rows = _norm_rows(first.drain_output())
    second.restore(first.snapshot())          # flushes buffered steps first
    _feed(second, batches[6:], wms[6:])
    second.process_watermark(MAX_WATERMARK - 1)
    rows += _norm_rows(second.drain_output())
    assert rows == whole


def test_operator_unported_options_raise_naming_the_roadmap():
    # the mesh is ported (tests/test_torch_multichip_runtime.py); on the
    # mesh, tiering and shared partials are still queued
    from flink_tpu_torch.parallel.mesh import Mesh
    from flink_tpu_torch.state.tier_manager import TierConfig

    mesh = Mesh(["cpu"] * 2)
    assert tfo.FusedWindowOperator(_window(tasg), "count", device="cpu",
                                   mesh=mesh).mesh_devices() == 2
    for kw in (dict(tier=TierConfig(hot_key_capacity=16)),
               dict(assigners=[_window(tasg)], prologue=object())):
        with pytest.raises(NotImplementedError, match="ROADMAP.md Queue A, item 13"):
            tfo.FusedWindowOperator(_window(tasg), "count", device="cpu", mesh=mesh, **kw)
    # the state tier is ported (tests/test_torch_state_tiering.py runs
    # it): the option builds a tiered operator at the hot capacity
    op = tfo.FusedWindowOperator(_window(tasg), "count", device="cpu",
                                 tier=TierConfig(hot_key_capacity=16))
    assert op.tier is not None and op.pipe.K == 16 and op.tier_gauges()["residentKeys"] == 0
    # shared partials are ported: without a prologue both packages refuse
    # `assigners=` alike (tests/test_torch_shared_pipeline.py runs them)
    for make in (lambda: jfo.FusedWindowOperator(_window(jasg), "count", assigners=[]),
                 lambda: tfo.FusedWindowOperator(_window(tasg), "count", device="cpu",
                                                 assigners=[])):
        with pytest.raises(ValueError, match="a prologue is required"):
            make()
    # latency mode (D2) is ported: the option builds the operator
    # (tests/test_torch_latency_mode.py runs it)
    from flink_tpu_torch.scheduler.latency_controller import LatencySpec

    op = tfo.FusedWindowOperator(_window(tasg), "count", device="cpu",
                                 latency=LatencySpec(target_ms=5))
    assert op.pipe.readback_steps == 8 and op.latency_gauges()["latencyModeActive"] == 1
    # the device plane (D4) is ported: the operator takes a tracker and
    # reports its phase counters (tests/test_torch_device_stats.py runs it)
    from flink_tpu_torch.metrics.device_stats import CompileTracker

    op = tfo.FusedWindowOperator(_window(tasg), "count", device="cpu")
    op.attach_device_stats(CompileTracker())
    assert op.phase_totals() == {"ingestRecords": 0, "fireSteps": 0, "purgeSteps": 0}
    assert op.key_stats_ready() is False
    # queryable state is ported: a key never seen has no cells
    assert op.query_state_for(1) == {}
    # an operator without shared partials has no member lanes, in both
    # packages
    for unshared in (op, jfo.FusedWindowOperator(_window(jasg), "count")):
        with pytest.raises(TypeError):
            unshared.drain_spec_output(0)
