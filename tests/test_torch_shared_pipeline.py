"""The port's SharedWindowPipeline and shared-partials FusedWindowOperator
held against the JAX package's.

- Planning: both packages' SharedWindowPipeline (plan_only) over the same
  slice bounds and watermarks give equal plan arrays (smin, fire_pos,
  fire_valid, fire_row, purge mask), fire lists (row, window, step, spec)
  and fire cursors, for three members and for the five-member dashboard
  group (1, 5, 15 and 60 granules tumbling, 10 sliding by 1: F = 20, mixed
  per-slot window lengths).
- Rows: process_superbatch of both pipelines (the port's plain K1, the JAX
  package's XLA superscan and its Pallas kernel in interpret mode) over one
  numpy-made stream with late records.
- The operator: a mid-stream snapshot of a shared-partials
  FusedWindowOperator taken in one package and restored in the other
  (`fire_cursors`, `spec_outputs`), both directions, against an
  uninterrupted run; and latency mode (readback groups, every ladder rung)
  over a shared group, whose rows equal throughput mode's in order.

Tolerance: exact. Counts are order-free and the sum payloads are small
integers, so float32 partial sums are exact in any order; rows are
compared for keys whose window count is above 0.
"""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from flink_tpu.api.windowing import assigners as jasg  # noqa: E402
from flink_tpu.core.time import MAX_WATERMARK  # noqa: E402
from flink_tpu.runtime import fused_window_operator as jfo  # noqa: E402
from flink_tpu.runtime import fused_window_pipeline as jfp  # noqa: E402
from flink_tpu.scheduler.latency_controller import LatencySpec as JaxLatencySpec  # noqa: E402
from flink_tpu_torch.api.windowing import assigners as tasg  # noqa: E402
from flink_tpu_torch.runtime import fused_window_operator as tfo  # noqa: E402
from flink_tpu_torch.runtime import fused_window_pipeline as tfp  # noqa: E402
from flink_tpu_torch.scheduler.latency_controller import LatencySpec  # noqa: E402

NUM_KEYS = 256
GRANULE = 100


def T(ms):
    return lambda m: m.TumblingEventTimeWindows.of(ms)


def SL(size, slide):
    return lambda m: m.SlidingEventTimeWindows.of(size, slide)


GROUPS = {
    "three": [T(100), T(500), SL(400, 200)],
    # the dashboard group of chip_smoke.py's api_correlated leg 2, on a
    # 100 ms granule: 1, 5, 15, 60 granules tumbling, 10 sliding by 1
    "five": [T(100), T(500), T(1500), T(6000), SL(1000, 100)],
}


def _assigners(m, group):
    return [a(m) for a in GROUPS[group]]


def _port_pipe(group, agg="count", chunk=256, **kw):
    return tfp.SharedWindowPipeline(_assigners(tasg, group), agg, key_capacity=NUM_KEYS,
                                    nsb=4, fires_per_step=4, out_rows=64, chunk=chunk,
                                    device="cpu", **kw)


def _jax_pipe(group, agg="count", chunk=256, **kw):
    return jfp.SharedWindowPipeline(_assigners(jasg, group), agg, key_capacity=NUM_KEYS,
                                    nsb=4, fires_per_step=4, out_rows=64, chunk=chunk, **kw)


def _bounds(steps, per_step=3):
    """Each step covers `per_step` new slices; the watermark trails the
    step's last slice by one granule."""
    bounds, wms = [], []
    for t in range(steps):
        lo = 10 + t * per_step
        bounds.append((lo, lo + per_step - 1))
        wms.append((lo + per_step - 1) * GRANULE - GRANULE)
    return bounds, wms


def _fires(fires):
    return [(pf.row, pf.j, pf.step, pf.spec) for pf in fires]


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_plans_match_jax(group):
    port, ref = _port_pipe(group, plan_only=True), _jax_pipe(group, plan_only=True)
    assert port.S == ref.S and port.F == ref.F == 4 * len(GROUPS[group])
    assert port.slot_spws() == ref._fire_spws
    assert [(s.spw, s.sl) for s in port.specs] == [(s.spw, s.sl) for s in ref.specs]
    bounds, wms = _bounds(60)
    total = 0
    for lo in range(0, 60, 8):
        (pplan, psmin), (rplan, rsmin) = (p.plan_superbatch(bounds[lo:lo + 8], wms[lo:lo + 8])
                                          for p in (port, ref))
        assert np.array_equal(psmin, np.asarray(rsmin))
        for a, b in zip(pplan[:5], rplan[:5]):
            assert np.array_equal(np.asarray(a.cpu()), np.asarray(b))
        assert _fires(pplan[5]) == _fires(rplan[5])
        assert port.fire_cursors == ref.fire_cursors
        assert port.purged_to == ref.purged_to
        total += len(pplan[5])
    assert total > 100
    if group == "five":
        assert port.slot_spws() == (1,) * 4 + (5,) * 4 + (15,) * 4 + (60,) * 4 + (10,) * 4


def _stream(steps, batch, seed, late_every=4):
    """(keys, small integer values, timestamps) and watermarks: each step
    covers 250 ms of event time, mildly out of order; every `late_every`-th
    step carries 20 records far behind the watermark."""
    rng = np.random.default_rng(seed)
    out, wms, wm = [], [], None
    t_cursor = 3000.0
    for t in range(steps):
        keys = rng.integers(0, NUM_KEYS, batch).astype(np.int32)
        vals = rng.integers(0, 9, batch).astype(np.float32)
        base = t_cursor + np.sort(rng.random(batch)) * 250.0
        ts = np.maximum(base.astype(np.int64) - rng.integers(0, 40, batch), 0)
        if wm is not None and t % late_every == 0:
            ts[:20] = wm - 9000
        out.append((keys, vals, ts))
        wm = int(base[-1]) - 60
        wms.append(wm)
        t_cursor += 250.0
    return out, wms


def _emissions(got):
    rows = []
    for (spec, w), counts, fields in got:
        counts = np.asarray(counts)
        live = counts > 0
        rows.append((spec, int(w.start), int(w.end), counts.tolist(),
                     {k: np.asarray(v)[live].tolist() for k, v in fields.items()}))
    return rows


# the JAX package's XLA superscan on every case, its Pallas kernel (in
# interpret mode, the slowest) on the five-member sum
ROW_CASES = [(g, a, "xla") for g in sorted(GROUPS) for a in ("count", "sum")] + [
    ("five", "sum", "pallas")]


@pytest.mark.parametrize("group,agg,route", ROW_CASES)
def test_fired_rows_match_jax(group, agg, route):
    batches, wms = _stream(32, 300, seed=len(group) + len(agg))
    # the Pallas kernel stages whole chunks of 1024 records
    chunk = 1024 if route == "pallas" else 256
    port = _port_pipe(group, agg, chunk=chunk)
    ref = _jax_pipe(group, agg, chunk=chunk, backend=route,
                    pallas_interpret=route == "pallas")
    rows = []
    for lo in range(0, 32, 4):
        got = _emissions(port.process_superbatch(batches[lo:lo + 4], wms[lo:lo + 4]))
        want = _emissions(ref.process_superbatch(batches[lo:lo + 4], wms[lo:lo + 4]))
        assert got == want
        rows += got
    assert len(rows) > 40
    assert port.num_late_records_dropped == ref.num_late_records_dropped > 0
    assert {s for s, *_ in rows} == set(range(len(GROUPS[group])))


# ---------------------------------------------------------------------------
# the shared-partials operator: snapshots across the packages, latency mode
# ---------------------------------------------------------------------------

OP_KW = dict(key_capacity=NUM_KEYS, superbatch_steps=8, nsb=4, fires_per_step=4,
             out_rows=64, chunk=256)


def _prologues():
    port = tfp.TracedPrologue((("filter", lambda c: c[:, 1] < 6.5),),
                              lambda c: c[:, 0].to(torch.int32), lambda c: c[:, 1])
    ref = jfp.TracedPrologue((("filter", lambda c: c[:, 1] < 6.5),),
                             lambda c: c[:, 0].astype(jnp.int32), lambda c: c[:, 1])
    return port, ref


def _port_op(group, agg, latency=None, **kw):
    return tfo.FusedWindowOperator(None, agg, assigners=_assigners(tasg, group),
                                   prologue=_prologues()[0], device="cpu", latency=latency,
                                   **{**OP_KW, **kw})


def _jax_op(group, agg, latency=None, **kw):
    return jfo.FusedWindowOperator(None, agg, assigners=_assigners(jasg, group),
                                   prologue=_prologues()[1], latency=latency,
                                   **{**OP_KW, **kw})


def _raw(batches):
    return [(np.stack([k, v], 1).astype(np.float32), ts) for k, v, ts in batches]


def _lanes(op, n):
    return [[(k, int(w.start), int(w.end), r, int(ts)) for k, w, r, ts in
             op.drain_spec_output(i)] for i in range(n)]


def _feed(op, raw, wms, n, drain=True):
    lanes = [[] for _ in range(n)]
    for (col, ts), wm in zip(raw, wms):
        op.process_raw_batch(col, ts)
        op.process_watermark(wm)
        if drain:
            for lane, rows in zip(lanes, _lanes(op, n)):
                lane += rows
    return lanes


def _finish(op, lanes, n):
    op.process_watermark(MAX_WATERMARK - 1)
    for lane, rows in zip(lanes, _lanes(op, n)):
        lane += rows
    return lanes


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("group", sorted(GROUPS))
def test_operator_snapshot_crosses_packages(group, direction):
    n = len(GROUPS[group])
    batches, wms = _stream(40, 200, seed=5)
    raw = _raw(batches)
    op = _port_op(group, "sum")
    whole = _finish(op, _feed(op, raw, wms, n), n)
    assert all(len(lane) > 0 for lane in whole)
    ref = _jax_op(group, "sum")
    assert whole == _finish(ref, _feed(ref, raw, wms, n), n)

    first, second = _jax_op(group, "sum"), _port_op(group, "sum")
    if direction == "port_to_jax":
        first, second = second, first
    lanes = _feed(first, raw[:17], wms[:17], n)
    # undrained rows of the last steps ride the snapshot in spec_outputs
    first.process_raw_batch(*raw[17])
    first.process_watermark(wms[17])
    snap = first.snapshot()
    assert "spec_outputs" in snap and len(snap["spec_outputs"]) == n
    assert snap["pipe"]["fire_cursors"] and snap["normalizer"]["fire_cursors"]
    second.restore(snap)
    rest = _finish(second, _feed(second, raw[18:], wms[18:], n), n)
    assert [a + b for a, b in zip(lanes, rest)] == whole


def _latency_run(op, raw, wms, n):
    return _finish(op, _feed(op, raw, wms, n), n)


def _pin(op, rung=None):
    op._controller._clock = lambda: 0.0
    if rung is not None:
        op._controller._rung = rung
    return op


@pytest.fixture(scope="module")
def latency_stream():
    batches, wms = _stream(48, 150, seed=9)
    raw = _raw(batches)
    op = _port_op("five", "count", superbatch_steps=16)
    return raw, wms, _latency_run(op, raw, wms, 5)


@pytest.mark.parametrize("readback", [2, 4, 8])
def test_latency_mode_readback_groups_match_throughput_and_jax(latency_stream, readback):
    raw, wms, whole = latency_stream
    spec = dict(target_ms=50, readback_steps=readback, max_inflight=2)
    port = _pin(_port_op("five", "count", LatencySpec(**spec), superbatch_steps=16))
    got = _latency_run(port, raw, wms, 5)
    assert port.pipe.readback_steps == readback
    assert got == whole and sum(len(lane) for lane in got) > 100
    ref = _pin(_jax_op("five", "count", JaxLatencySpec(**spec), superbatch_steps=16))
    assert _latency_run(ref, raw, wms, 5) == got


@pytest.mark.parametrize("rung", [0, 1, 2, 3])
def test_latency_mode_every_rung_matches_throughput(latency_stream, rung):
    raw, wms, whole = latency_stream
    spec = LatencySpec(target_ms=50, readback_steps=4, max_inflight=2)
    port = _pin(_port_op("five", "count", spec, superbatch_steps=16), rung)
    assert port._controller.ladder == (2, 4, 8, 16)
    assert _latency_run(port, raw, wms, 5) == whole


@pytest.mark.parametrize("columnar", [False, True], ids=["rows", "columnar"])
@pytest.mark.parametrize("out_rows", [16, 256])
def test_operator_lanes_match_jax(out_rows, columnar):
    """Each member's rows land in its own lane, in row and columnar output;
    a small out_rows cuts dispatches early (the normalizer's fire counts
    over all members), never past K1's rows."""
    n = len(GROUPS["five"])
    batches, wms = _stream(40, 200, seed=8)
    raw = _raw(batches)

    def lanes(op):
        out = [[] for _ in range(n)]
        for (col, ts), wm in zip(raw + [(raw[0][0][:0], raw[0][1][:0])],
                                 wms + [MAX_WATERMARK - 1]):
            op.process_raw_batch(col, ts)
            op.process_watermark(wm)
            for i in range(n):
                for k, w, r, ts_ in op.drain_spec_output(i):
                    if columnar:
                        _w, ids, vals = r
                        r = (np.asarray(ids).tolist(), np.asarray(vals).tolist())
                    out[i].append((k, int(w.start), int(w.end), r, int(ts_)))
        return out

    kw = dict(out_rows=out_rows, columnar_output=columnar)
    got = lanes(_port_op("five", "sum", **kw))
    assert got == lanes(_jax_op("five", "sum", **kw))
    assert all(len(lane) > 0 for lane in got)
    assert all(k is None for lane in got for k, *_ in lane) == columnar


def test_planner_errors_match_jax():
    """More fires in one dispatch than out_rows, or more windows of one
    member in one step than its fire slots: both packages raise the same
    words."""
    bounds, wms = _bounds(40)
    for kw, match in ((dict(out_rows=8), "more than out_rows=8 fires per dispatch"),
                      (dict(), "fires_per_step=4")):
        msgs = []
        for make in (tfp.SharedWindowPipeline, jfp.SharedWindowPipeline):
            extra = {"device": "cpu"} if make is tfp.SharedWindowPipeline else {}
            asg = tasg if make is tfp.SharedWindowPipeline else jasg
            pipe = make(_assigners(asg, "five"), "count", key_capacity=NUM_KEYS, nsb=4,
                        fires_per_step=4, plan_only=True, **{"out_rows": 64, **kw, **extra})
            with pytest.raises(ValueError, match=match) as e:
                if "out_rows" in kw:
                    pipe.plan_superbatch(bounds, wms)
                else:
                    # one watermark jump fires six windows of the sliding member
                    pipe.plan_superbatch([(10, 12), (13, 13)], [1000, 1600])
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
