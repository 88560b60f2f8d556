"""The port's fused pipelines held against the JAX package's.

`flink_tpu_torch`'s FusedWindowPipeline and FusedGlobalWindowPipeline run
with device="cpu" (the plain PyTorch superscans) beside the JAX pipelines
on the pallas kernels in interpret mode, on identical numpy-made streams
with late records. Snapshots cross between the packages in both directions
mid-stream.

Tolerance: exact. Counts and order statistics are order-free; the sum and
mean payloads are small integers, so every float32 partial sum is an
integer below 2**24 whatever the add order. Rows are compared for keys
whose window count is above 0 (rows of absent keys are meaningless).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from flink_tpu.api.windowing import assigners as jasg
from flink_tpu.ops import aggregators as jagg
from flink_tpu.runtime import fused_window_pipeline as jfp
from flink_tpu_torch.api.windowing import assigners as tasg
from flink_tpu_torch.ops import aggregators as tagg
from flink_tpu_torch.runtime import fused_window_pipeline as tfp

NUM_KEYS = 128
WINDOWS = {
    "sliding": lambda m: m.SlidingEventTimeWindows.of(2000, 500),
    "tumbling": lambda m: m.TumblingEventTimeWindows.of(1000),
}
AGGS = {
    "count": ("count", "count"),
    "sum": ("sum", "sum"),
    "mean": ("mean", "mean"),
    "max8": (lambda: jagg.max_agg(domain_bits=8), lambda: tagg.max_agg(domain_bits=8)),
}


def _agg(spec):
    return spec() if callable(spec) else spec


def _stream(steps, batch, seed=11, late_every=2):
    """YSB-shaped batches (keys, vals, ts) and watermarks; every
    `late_every`-th batch carries 25 records far behind the watermark."""
    rng = np.random.default_rng(seed)
    batches, wms = [], []
    ms_per_batch = 400.0
    t_cursor = 5000.0
    wm = None
    for t in range(steps):
        keys = rng.integers(0, NUM_KEYS, size=batch).astype(np.int32)
        base = t_cursor + np.sort(rng.random(batch)) * ms_per_batch
        ts = np.maximum(base.astype(np.int64) - rng.integers(0, 120, batch), 0)
        if wm is not None and t % late_every == 0:
            ts[:25] = wm - 2500
        vals = rng.integers(0, 9, size=batch).astype(np.float32)
        batches.append((keys, vals, ts))
        wm = int(base[-1]) - 150
        wms.append(wm)
        t_cursor += ms_per_batch
    return batches, wms


def _geometry():
    return dict(key_capacity=NUM_KEYS, num_slices=16, nsb=4, fires_per_step=4,
                out_rows=16, chunk=1024)


def _jax_pipe(window, agg):
    return jfp.FusedWindowPipeline(WINDOWS[window](jasg), _agg(AGGS[agg][0]),
                                   backend="pallas", pallas_interpret=True,
                                   **_geometry())


def _port_pipe(window, agg):
    return tfp.FusedWindowPipeline(WINDOWS[window](tasg), _agg(AGGS[agg][1]),
                                   device="cpu", **_geometry())


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


@pytest.mark.parametrize("agg", sorted(AGGS))
@pytest.mark.parametrize("window", sorted(WINDOWS))
def test_keyed_pipeline_matches_jax_pallas(window, agg):
    batches, wms = _stream(6, 700)
    ref_pipe, dev_pipe = _jax_pipe(window, agg), _port_pipe(window, agg)
    for lo, hi in ((0, 3), (3, 6)):
        ref = ref_pipe.process_superbatch(batches[lo:hi], wms[lo:hi])
        dev = dev_pipe.process_superbatch(batches[lo:hi], wms[lo:hi])
        _assert_emissions_equal(ref, dev)
    assert dev_pipe.num_late_records_dropped == ref_pipe.num_late_records_dropped
    assert dev_pipe.num_late_records_dropped > 0


def test_deferred_dispatches_resolve_in_order():
    batches, wms = _stream(6, 700, seed=3)
    ref_pipe, dev_pipe = _jax_pipe("sliding", "count"), _port_pipe("sliding", "count")
    d1 = dev_pipe.process_superbatch(batches[:3], wms[:3], defer=True)
    d2 = dev_pipe.process_superbatch(batches[3:], wms[3:], defer=True)
    _assert_emissions_equal(ref_pipe.process_superbatch(batches[:3], wms[:3]),
                            d1.resolve())
    _assert_emissions_equal(ref_pipe.process_superbatch(batches[3:], wms[3:]),
                            d2.resolve())


def test_plan_superbatch_matches_staged():
    """The bounds-driven planner + caller-staged idx give the same emissions
    as the data-driven stage_superbatch, and as the JAX pipeline."""
    steps, batch = 6, 1024
    M, SLIDE, OOO = 400, 500, 120
    rng = np.random.default_rng(9)
    batches, wms, bounds = [], [], []
    for t in range(steps):
        keys = rng.integers(0, NUM_KEYS, size=batch).astype(np.int32)
        base = t * M + ((np.arange(1, batch + 1) * M) // batch)
        ts = np.maximum(base - rng.integers(0, OOO + 1, batch), 0).astype(np.int64)
        batches.append((keys, None, ts))
        wms.append(int(t * M + M - OOO - 1))
        bounds.append((max((t * M - OOO) // SLIDE, 0), (t * M + M) // SLIDE))

    staged_pipe = _port_pipe("sliding", "count")
    planned_pipe = _port_pipe("sliding", "count")
    ref_pipe = _jax_pipe("sliding", "count")
    for lo, hi in ((0, 3), (3, 6)):
        ref = ref_pipe.process_superbatch(batches[lo:hi], wms[lo:hi])
        got_staged = staged_pipe.process_superbatch(batches[lo:hi], wms[lo:hi])
        plan, smin_abs = planned_pipe.plan_superbatch(bounds[lo:hi], wms[lo:hi])
        idx = np.stack([
            (k.astype(np.int64) * 4 + ts // SLIDE - smin_abs[r]).astype(np.int32)
            for r, (k, _v, ts) in enumerate(batches[lo:hi])])
        got_planned = planned_pipe.process_superbatch(
            None, None, staged=(torch.from_numpy(idx.reshape(-1)), None, plan))
        _assert_emissions_equal(got_staged, got_planned)
        _assert_emissions_equal(ref, got_planned)


@pytest.mark.parametrize("agg", ["count", "max8"])
def test_snapshot_crosses_from_jax_to_port(agg):
    batches, wms = _stream(6, 600, seed=5)
    jax_pipe, port_pipe = _jax_pipe("sliding", agg), _port_pipe("sliding", agg)
    jax_pipe.process_superbatch(batches[:3], wms[:3])
    snap = jax_pipe.snapshot()
    port_pipe.restore(snap)
    back = port_pipe.snapshot()
    assert back.keys() == snap.keys()
    for k in ("count",):
        assert back[k].dtype == snap[k].dtype and back[k].shape == snap[k].shape
    _assert_emissions_equal(jax_pipe.process_superbatch(batches[3:], wms[3:]),
                            port_pipe.process_superbatch(batches[3:], wms[3:]))
    assert port_pipe.num_late_records_dropped == jax_pipe.num_late_records_dropped


def test_snapshot_crosses_from_port_to_jax():
    batches, wms = _stream(6, 600, seed=6)
    jax_pipe, port_pipe = _jax_pipe("sliding", "sum"), _port_pipe("sliding", "sum")
    port_pipe.process_superbatch(batches[:3], wms[:3])
    snap = port_pipe.snapshot()
    assert snap["count"].shape == (NUM_KEYS, 16) and snap["count"].dtype == np.int32
    assert snap["state"]["sum"].dtype == np.float32
    jax_pipe.restore(snap)
    _assert_emissions_equal(jax_pipe.process_superbatch(batches[3:], wms[3:]),
                            port_pipe.process_superbatch(batches[3:], wms[3:]))


def test_key_capacity_growth_matches_jax():
    batches, wms = _stream(6, 500, seed=12)
    jax_pipe, port_pipe = _jax_pipe("sliding", "count"), _port_pipe("sliding", "count")
    for p in (jax_pipe, port_pipe):
        p.process_superbatch(batches[:3], wms[:3])
        p.ensure_key_capacity(NUM_KEYS + 5)
    assert port_pipe.K == jax_pipe.K == 2 * NUM_KEYS
    grown = [(k + NUM_KEYS, v, ts) for k, v, ts in batches[3:]]
    _assert_emissions_equal(jax_pipe.process_superbatch(grown, wms[3:]),
                            port_pipe.process_superbatch(grown, wms[3:]))
    assert np.array_equal(np.asarray(jax_pipe.key_loads()),
                          port_pipe.key_loads().numpy())
    assert port_pipe.state_row_bytes() == jax_pipe.state_row_bytes()


@pytest.mark.parametrize("agg", ["max", "sum", "min"])
def test_global_pipeline_matches_jax_pallas(agg):
    batches, wms = _stream(6, 700, seed=21)
    geo = dict(num_slices=16, nsb=4, fires_per_step=4, out_rows=16, chunk=1024)
    ref_pipe = jfp.FusedGlobalWindowPipeline(
        jasg.SlidingEventTimeWindows.of(2000, 500), agg, backend="pallas",
        pallas_interpret=True, **geo)
    dev_pipe = tfp.FusedGlobalWindowPipeline(
        tasg.SlidingEventTimeWindows.of(2000, 500), agg, device="cpu", **geo)
    for lo, hi in ((0, 3), (3, 6)):
        ref = ref_pipe.process_superbatch(batches[lo:hi], wms[lo:hi])
        dev = dev_pipe.process_superbatch(batches[lo:hi], wms[lo:hi])
        assert len(ref) == len(dev) and len(ref) > 0
        for (rw, rc, rf), (dw, dc, df) in zip(ref, dev):
            assert (rw.start, rw.end) == (dw.start, dw.end)
            assert int(rc) == int(dc)
            assert np.asarray(rf[agg]) == np.asarray(df[agg])
    snap = dev_pipe.snapshot()
    ref_snap = ref_pipe.snapshot()
    for k in ("count",):
        assert np.array_equal(snap[k], np.asarray(ref_snap[k]))
    assert np.array_equal(snap["state"][agg], np.asarray(ref_snap["state"][agg]))
    assert dev_pipe.num_late_records_dropped == ref_pipe.num_late_records_dropped


def test_unported_options_raise_naming_the_roadmap():
    """The option this test held to its ROADMAP item, the device plane's
    `attach_device_stats` (item D4), is ported: both pipelines take a
    tracker and turn their phase counters on, and nothing of either
    pipeline raises a `not_ported` error any more (the device plane's
    twins are tests/test_torch_device_stats.py)."""
    from flink_tpu_torch.metrics.device_stats import CompileTracker

    gpipe = tfp.FusedGlobalWindowPipeline(WINDOWS["sliding"](tasg), "max", device="cpu",
                                          num_slices=16)
    pipe = _port_pipe("sliding", "count")
    for p in (gpipe, pipe):
        tracker = CompileTracker()
        p.attach_device_stats(tracker)
        assert p.compile_tracker is tracker and p.phase_counters is True
        assert p.phase_totals.tolist() == [0, 0, 0]
    assert "not_ported" not in Path(tfp.__file__).read_text()
