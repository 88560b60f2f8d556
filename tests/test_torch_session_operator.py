"""The port's TpuSessionWindowOperator held against the JAX package's.

Every scenario of `tests/test_session_operator.py` that does not need the
oracle and every one of `tests/test_session_superscan.py`, run through both
packages' operators on identical inputs made from a numpy seed (the port on
the CPU, where the session kernels K3/K4 take their plain versions), plus
snapshots crossing between the packages both ways. Fused superspans are
also held against `numpy_sessionize` over the same records.

Tolerance: exact. Emitted rows (key, window, value) are compared as sorted
lists; payloads are small integers, so float32 sums are exact in any order.
"""

import numpy as np
import pytest
import torch

from flink_tpu_torch.utils.device import HostCopy

jnp = pytest.importorskip("jax.numpy")

from flink_tpu.api.windowing.assigners import EventTimeSessionWindows as JaxSessions  # noqa: E402
from flink_tpu.ops import aggregators as jagg  # noqa: E402
from flink_tpu.runtime.tpu_session_operator import (  # noqa: E402
    TpuSessionWindowOperator as JaxOp,
)
from flink_tpu_torch.api.windowing.assigners import EventTimeSessionWindows  # noqa: E402
from flink_tpu_torch.ops import aggregators as tagg  # noqa: E402
from flink_tpu_torch.runtime.tpu_session_operator import TpuSessionWindowOperator  # noqa: E402
from flink_tpu_torch.testing.stream import numpy_sessionize  # noqa: E402
from jax_native_twins import jax_native_library  # noqa: E402,F401

AGGS = {"count": (jagg.count_agg, tagg.count_agg), "sum": (jagg.sum_agg, tagg.sum_agg),
        "max": (jagg.max_agg, tagg.max_agg), "mean": (jagg.mean_agg, tagg.mean_agg)}


def _ops(agg="sum", gap=1000, **kw):
    """(JAX operator, port operator) built alike; the port's on the CPU."""
    ja, ta = AGGS[agg] if isinstance(agg, str) else agg
    return (JaxOp(JaxSessions.with_gap(gap), ja(), **kw),
            TpuSessionWindowOperator(EventTimeSessionWindows.with_gap(gap), ta(),
                                     device="cpu", **kw))


def _norm(out):
    return sorted((k, w.start, w.end, round(float(r), 4)) for (k, w, r, _t) in out)


def _mk_stream(seed, *, n_batches=12, batch=60, num_keys=7, gap=1000,
               ooo=300, density_ms=260):
    """Bursty keyed stream: keys go quiet at random, creating real sessions
    (test_session_operator.py's generator)."""
    rng = np.random.default_rng(seed)
    t_cursor = 0
    batches, wms = [], []
    for _ in range(n_batches):
        keys = rng.integers(0, num_keys, size=batch)
        base = t_cursor + rng.integers(0, density_ms * 4, size=batch)
        jitter = rng.integers(0, ooo + 1, size=batch)
        ts = np.maximum(base - jitter, 0)
        vals = rng.integers(1, 10, size=batch).astype(np.float32)
        batches.append((keys, vals, np.sort(ts)))
        t_cursor += density_ms * 4 + int(rng.integers(0, 3)) * gap * 2
        wms.append(int(ts.max()) - ooo)
    return batches, wms


def _drive(op, batches, wms, *, drain_each=True, swap_at=None):
    """Feed batches + watermarks; at batch `swap_at`, snapshot and continue
    on swap_at's operator (restored from the snapshot)."""
    out = []
    for i, ((keys, vals, ts), wm) in enumerate(zip(batches, wms)):
        if swap_at is not None and i == swap_at[0]:
            snap = op.snapshot()
            out.extend(op.drain_output())
            op = swap_at[1]
            op.restore(snap)
        op.process_batch(np.asarray(keys), np.asarray(vals, np.float32),
                         np.asarray(ts, np.int64))
        op.process_watermark(wm)
        if drain_each:
            out.extend(op.drain_output())
    op.process_watermark(1 << 60)
    out.extend(op.drain_output())
    return _norm(out)


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("agg", ["count", "sum", "max", "mean"])
def test_randomized_parity(seed, agg):
    batches, wms = _mk_stream(seed)
    jop, top = _ops(agg, key_capacity=64)
    ref = _drive(jop, batches, wms)
    assert len(ref) > 10 and _drive(top, batches, wms) == ref


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("agg", ["count", "sum"])
def test_deferred_emissions_parity(seed, agg):
    batches, wms = _mk_stream(seed)
    jop, top = _ops(agg, key_capacity=64, defer_emissions=True)
    ref = _drive(jop, batches, wms, drain_each=False)
    assert _drive(top, batches, wms, drain_each=False) == ref
    # and the deferred port agrees with the sync port
    assert ref == _drive(_ops(agg, key_capacity=64)[1], batches, wms)


def test_deferred_snapshot_resolves_pending():
    batches, wms = _mk_stream(7)
    ref = _drive(_ops(key_capacity=64)[0], batches, wms)
    _j, top = _ops(key_capacity=64, defer_emissions=True)
    nxt = _ops(key_capacity=64, defer_emissions=True)[1]
    assert _drive(top, batches, wms, drain_each=False, swap_at=(6, nxt)) == ref


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_snapshot_restore_mid_stream_across_packages(direction):
    batches, wms = _mk_stream(11)
    ref = _drive(_ops(key_capacity=64)[0], batches, wms)
    jop, top = _ops(key_capacity=64)
    j2, t2 = _ops(key_capacity=64)
    first, second = (jop, t2) if direction == "jax_to_port" else (top, j2)
    assert _drive(first, batches, wms, swap_at=(6, second)) == ref and len(ref) > 0


def test_nonpow2_span_purges_highest_slice():
    """A span of 3: the JAX package pads it to P=4 with a duplicate of the
    highest slice's position, whose write-back must not undo its purge; the
    port merges the 3 columns unpadded. Both purge every emitted cell."""
    for op in _ops("count", key_capacity=64, num_slices=16):
        op.process_batch(np.asarray([5, 5]), np.asarray([1.0, 1.0]),
                         np.asarray([100, 2500], dtype=np.int64))
        op.process_watermark(10_000)
        assert len(op.drain_output()) == 2
        op.process_watermark(20_000)
        assert op.drain_output() == [] and op.ring_lo is None


def test_deferred_future_records_not_lost():
    outs = []
    for op in _ops("count", key_capacity=64, num_slices=4, defer_emissions=True):
        op.process_batch(np.asarray([1]), np.asarray([1.0]), np.asarray([500], np.int64))
        op.process_watermark(3_000)
        op.process_batch(np.asarray([1]), np.asarray([1.0]), np.asarray([5_500], np.int64))
        assert op._future == []
        op.process_watermark(9_000)
        outs.append(sorted((k, w.start) for (k, w, _r, _t) in op.drain_output()))
        assert op.num_late_records_dropped == 0
    assert outs[0] == outs[1] == [(1, 500), (1, 5_500)]


def test_restore_discards_inflight_deferred_scans():
    for op in _ops("count", key_capacity=64, num_slices=16, defer_emissions=True):
        op.process_batch(np.asarray([1]), np.asarray([1.0]), np.asarray([100], np.int64))
        snap = op.snapshot()
        op.process_watermark(5_000)
        assert op._pending
        op.restore(snap)
        assert not op._pending
        op.process_watermark(5_000)
        assert [(k, w.start) for (k, w, _r, _t) in op.drain_output()] == [(1, 100)]


def test_merge_across_batches_and_gap_boundary():
    """Touching windows merge: events exactly gap apart form one session;
    one past the gap splits."""
    batches = [
        (["a", "a", "b"], [1, 1, 1], [0, 99, 0]),
        (["b", "c", "c"], [1, 1, 1], [100, 0, 101]),
    ]
    wms = [50, 1 << 40]
    jop, top = _ops("count", gap=100, key_capacity=64)
    got = _drive(top, batches, wms)
    assert got == _drive(jop, batches, wms)
    assert ("a", 0, 199, 2.0) in got and ("b", 0, 200, 2.0) in got
    assert ("c", 0, 100, 1.0) in got and ("c", 101, 201, 1.0) in got


def test_late_records_counted():
    for op in _ops("count", gap=100, key_capacity=8):
        op.process_batch(np.asarray(["k"]), np.zeros(1, np.float32), np.asarray([0], np.int64))
        op.process_watermark(500)
        assert len(op.drain_output()) == 1
        op.process_batch(np.asarray(["k"]), np.zeros(1, np.float32), np.asarray([10], np.int64))
        assert op.num_late_records_dropped == 1
        op.process_watermark(1 << 40)
        assert op.drain_output() == []


def test_ring_overflow_holds_future_records():
    for op in _ops("count", gap=10, key_capacity=8, num_slices=8):
        op.process_batch(np.asarray(["k", "k"]), np.zeros(2, np.float32),
                         np.asarray([0, 1000], dtype=np.int64))
        assert len(op._future) == 1
        op.process_watermark(500)
        assert [(w.start, w.end) for (_k, w, _r, _t) in op.drain_output()] == [(0, 10)]
        op.process_watermark(1 << 40)
        assert [(w.start, w.end) for (_k, w, _r, _t) in op.drain_output()] == [(1000, 1010)]


def test_inverted_skew_raises():
    for op in _ops("count", gap=10, key_capacity=8, num_slices=8):
        op.process_batch(np.asarray(["k"]), np.zeros(1, np.float32), np.asarray([605], np.int64))
        with pytest.raises(ValueError, match="ring too small"):
            op.process_batch(np.asarray(["k", "k"]), np.zeros(2, np.float32),
                             np.asarray([5, 645], dtype=np.int64))


def _host_merges(jop) -> list:
    """A list that grows by one at each of the JAX operator's host merges."""
    calls, merge = [], jop._watermark_host_path

    def counted(*a, **kw):
        calls.append(1)
        return merge(*a, **kw)

    jop._watermark_host_path = counted
    return calls


def test_wide_span_overflow_takes_the_host_path():
    """9 sessions of one key over a 16-slice span: the JAX package merges
    with M = 8 slots, overflows and takes its exact host merge (counted);
    the port merges with M = span + 1 slots, so the merge stays on its
    kernel path (the plain version here) with the same rows."""
    gap = 10
    ts = np.arange(9, dtype=np.int64) * 19
    jop, top = _ops("sum", gap=gap, key_capacity=8, num_slices=16)
    host = _host_merges(jop)
    rows = []
    for op in (jop, top):
        op.process_batch(np.zeros(9, np.int64), np.arange(9, dtype=np.float32), ts)
        op.process_watermark(1 << 40)
        rows.append(_norm(op.drain_output()))
    assert len(rows[0]) == 9 and rows[0] == rows[1]
    assert len(host) == 1 and top.ring_lo is None


@pytest.mark.parametrize("defer", [False, True])
def test_wide_gap_merges_stay_exact(defer):
    """A gap of 2^28 ms over spans of 5 or more slices puts relative times
    past int32: the JAX package merges those spans on its host path, the
    port keeps them on its kernel path in 64-bit ms. Same rows."""
    gap = 1 << 28
    rng = np.random.default_rng(31)
    batches, wms = [], []
    for b in range(6):
        ts = np.sort(b * 6 * gap + rng.integers(0, 6 * gap, 40)).astype(np.int64)
        batches.append((rng.integers(0, 5, 40), rng.integers(1, 9, 40).astype(np.float32), ts))
        wms.append(int(ts.max()) - 3 * gap)
    jop, top = _ops("sum", gap=gap, key_capacity=8, num_slices=64, defer_emissions=defer)
    host = _host_merges(jop)
    ref = _drive(jop, batches, wms, drain_each=not defer)
    assert len(ref) > 10 and _drive(top, batches, wms, drain_each=not defer) == ref
    assert len(host) > 0


def test_value_fields_the_kernels_do_not_take_raise():
    """K3/K4 take 32-bit add/min/max fields, and 64-bit ones in their 32-bit
    form (ROADMAP C1); a float16 sum still raises at construction. A float64
    min or max equals the JAX operator's; a float64 sum equals the JAX
    operator's float32 sum (the JAX host merge truncates a float64 sum's
    cells, a reference fault the port does not reproduce)."""
    with pytest.raises(NotImplementedError, match="of 32 bits"):
        TpuSessionWindowOperator(EventTimeSessionWindows.with_gap(1000),
                                 tagg.sum_agg(np.float16), device="cpu")
    for vals in ([16777216.0, 1.0], [0.1, 0.2]):
        for name, jref in (("sum", jagg.sum_agg()), ("min", jagg.min_agg(np.float64)),
                           ("max", jagg.max_agg(np.float64))):
            rows = []
            for op in (JaxOp(JaxSessions.with_gap(1000), jref),
                       TpuSessionWindowOperator(EventTimeSessionWindows.with_gap(1000),
                                                getattr(tagg, f"{name}_agg")(np.float64),
                                                device="cpu")):
                op.process_batch(np.array([1, 1]), np.array(vals, np.float32),
                                 np.array([10, 20]))
                op.process_watermark(5000)
                rows.append([(k, w.start, w.end, repr(r)) for k, w, r, _t in op.drain_output()])
            assert rows[0] == rows[1] and len(rows[0]) == 1, (name, vals, rows)


def test_staged_ingest_matches_host_path():
    gap, S = 500, 16
    rng = np.random.default_rng(21)
    host_op = TpuSessionWindowOperator(EventTimeSessionWindows.with_gap(gap), "sum",
                                       key_capacity=32, num_slices=S, device="cpu")
    jop, top = _ops("sum", gap=gap, key_capacity=32, num_slices=S)
    outs = {id(o): [] for o in (host_op, jop, top)}
    t_cursor = 0
    for t in range(6):
        keys = rng.integers(0, 32, size=200).astype(np.int64)
        ts = np.sort(t_cursor + rng.integers(0, 400, size=200)).astype(np.int64)
        vals = rng.integers(1, 5, size=200).astype(np.float32)
        host_op.process_batch(keys, vals, ts)
        s_abs = ts // gap
        cols = (keys.astype(np.int32), (s_abs % S).astype(np.int32),
                (ts - s_abs * gap).astype(np.int32), vals)
        jop.process_batch_staged(*map(jnp.asarray, cols), int(s_abs.min()), int(s_abs.max()))
        top.process_batch_staged(*map(torch.from_numpy, cols), int(s_abs.min()),
                                 int(s_abs.max()))
        wm = t_cursor + 400 - 100
        for o in (host_op, jop, top):
            o.process_watermark(wm)
            outs[id(o)].extend(o.drain_output())
        t_cursor += 400 + (gap * 3 if t % 2 else 0)
    for o in (host_op, jop, top):
        o.process_watermark(1 << 40)
        outs[id(o)].extend(o.drain_output())
    h, j, d = (sorted((int(k), w.start, w.end, float(r)) for k, w, r, _ in outs[id(o)])
               for o in (host_op, jop, top))
    assert len(d) > 0 and d == j
    assert sorted(x[1:] for x in h) == sorted(x[1:] for x in d)


def test_operator_raises_without_a_gpu_unless_given_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TpuSessionWindowOperator(EventTimeSessionWindows.with_gap(1000), "sum")


# ---------------------------------------------------------------------------
# fused superspans (tests/test_session_superscan.py's scenarios)
# ---------------------------------------------------------------------------

GAP, S = 2000, 32


def _uniform_keys(rng, tt, B):
    active = (tt >> 2) & 3
    return (rng.integers(0, 256, size=B) | (active << 8)).astype(np.int64)


def _zipf_keys(rng, tt, B):
    n = 256
    w = 1.0 / np.arange(1, n + 1)
    ranks = np.searchsorted(np.cumsum(w) / w.sum(), rng.random(B))
    active = (tt >> 2) & 3
    perm = np.argsort((np.arange(n) * 2654435761 + active) % n)
    return (perm[ranks] | (active << 8)).astype(np.int64)


def _rotating_stream(rng, T, B, t0, key_fn):
    ks, ts, vs = [], [], []
    for t in range(T):
        tt = t0 + t
        ks.append(key_fn(rng, tt, B))
        base = tt * 655 + ((np.arange(1, B + 1) * 655) // B)
        ts.append(np.maximum(base - rng.integers(0, 501, size=B), 0))
        vs.append(rng.integers(0, 256, size=B).astype(np.float32))
    return ks, ts, vs


def _stage(ks, ts, vs, to):
    s_abs = np.stack(ts) // GAP
    cols = (np.stack(ks).astype(np.int32), (s_abs % S).astype(np.int32),
            (np.stack(ts) - s_abs * GAP).astype(np.int32), np.stack(vs).astype(np.float32))
    bounds = [(int(s_abs[t].min()), int(s_abs[t].max())) for t in range(len(ks))]
    return (*map(to, cols), bounds)


TO = {"jax": jnp.asarray, "port": torch.from_numpy}


def _mk(pkg, defer=True, slots=None):
    op = _ops("sum", gap=GAP, key_capacity=1 << 10, num_slices=S,
              defer_emissions=defer)[pkg == "port"]
    if slots is not None:
        op.MAX_SUPERSPAN_SLOTS = slots
    return op


def _wms(sp, T, every):
    return [((sp * T + t + 1) * 655 - 1000) if (t + 1) % every == 0 else None
            for t in range(T)]


def _sessions(op):
    return {(int(k), w.start, w.end): float(r) for (k, w, r, _t) in op.drain_output()}


def _drive_superspan(pkg, spans, merge_every, op=None):
    op = op or _mk(pkg)
    for sp, (ks, ts, vs) in enumerate(spans):
        kid, spos, rel, vals, bounds = _stage(ks, ts, vs, TO[pkg])
        op.process_superspan_staged(kid, spos, rel, vals, bounds,
                                    _wms(sp, len(ks), merge_every))
    op.process_watermark(1 << 59)
    return _sessions(op)


def _drive_per_step(pkg, spans, merge_every):
    op = _mk(pkg, defer=False)
    for sp, (ks, ts, vs) in enumerate(spans):
        T = len(ks)
        kid, spos, rel, vals, bounds = _stage(ks, ts, vs, TO[pkg])
        for t in range(T):
            op.process_batch_staged(kid[t], spos[t], rel[t], vals[t], *bounds[t])
            if (t + 1) % merge_every == 0:
                op.process_watermark((sp * T + t + 1) * 655 - 1000)
    op.process_watermark(1 << 59)
    return _sessions(op)


def _expect(spans):
    cat = [np.concatenate([a for s in spans for a in s[i]]) for i in range(3)]
    return numpy_sessionize(cat[0], cat[1], cat[2], GAP)


@pytest.mark.parametrize("merge_every", [4, 16])
def test_superspan_parity_vs_per_step_jax_and_numpy(merge_every):
    rng = np.random.default_rng(11)
    spans = [_rotating_stream(rng, 16, 384, sp * 16, _uniform_keys) for sp in range(2)]
    got = _drive_superspan("port", spans, merge_every)
    assert got == _drive_per_step("port", spans, merge_every)
    assert got == _drive_superspan("jax", spans, merge_every)
    assert len(got) > 0 and got == _expect(spans)


def test_superspan_parity_under_zipf_skew():
    rng = np.random.default_rng(29)
    spans = [_rotating_stream(rng, 16, 640, sp * 16, _zipf_keys) for sp in range(2)]
    got = _drive_superspan("port", spans, 8)
    assert got == _drive_superspan("jax", spans, 8) == _expect(spans)
    allk = np.concatenate([k for ks, _, _ in spans for k in ks])
    assert np.bincount(allk % 256).max() / len(allk) > 0.05


def test_superspan_slot_fallback_replays_exactly():
    rng = np.random.default_rng(5)
    spans = [_rotating_stream(rng, 16, 256, sp * 16, _uniform_keys) for sp in range(2)]
    fallback = _mk("port", slots=1)                     # force the replay
    got = _drive_superspan("port", spans, 8, op=fallback)
    assert fallback.superspan_replays == 2
    assert got == _drive_superspan("port", spans, 8) == _drive_per_step("jax", spans, 8)


def test_superspan_interleaves_with_plain_staged_ingest():
    got = {}
    for pkg in ("jax", "port"):
        rng = np.random.default_rng(17)
        span = _rotating_stream(rng, 16, 256, 0, _uniform_keys)
        op = _mk(pkg)
        kid, spos, rel, vals, bounds = _stage(*span, TO[pkg])
        op.process_superspan_staged(kid, spos, rel, vals, bounds, _wms(0, 16, 8))
        tail = _rotating_stream(rng, 8, 256, 16, _uniform_keys)
        k2, s2, r2, v2, b2 = _stage(*tail, TO[pkg])
        for t in range(8):
            op.process_batch_staged(k2[t], s2[t], r2[t], v2[t], *b2[t])
            if (t + 1) % 4 == 0:
                op.process_watermark((16 + t + 1) * 655 - 1000)
        op.process_watermark(1 << 59)
        got[pkg] = _sessions(op)
    assert got["port"] == got["jax"] == _expect([span, tail])


def test_watermark_over_pending_superspan_syncs_before_dispatch():
    """A forced in-dispatch overflow makes the pending superspan replay
    before the next merge dispatches; no duplicates, exact results."""
    rng = np.random.default_rng(23)
    span0 = _rotating_stream(rng, 16, 256, 0, _uniform_keys)
    tail = _rotating_stream(rng, 8, 256, 32, _uniform_keys)
    op = _mk("port")
    kid, spos, rel, vals, bounds = _stage(*span0, torch.from_numpy)
    op.process_superspan_staged(kid, spos, rel, vals, bounds, _wms(0, 16, 8))
    entry = next(e for e in op._pending if "superspan" in e)
    arr = entry["packed"].wait()[0].clone()
    arr[-2] = 1                           # the overflow flag of the packed result
    entry["packed"] = HostCopy([arr])
    op.process_watermark(14_000)
    assert not any("superspan" in e for e in op._pending)
    assert op.superspan_replays == 1
    k2, s2, r2, v2, b2 = _stage(*tail, torch.from_numpy)
    for t in range(8):
        op.process_batch_staged(k2[t], s2[t], r2[t], v2[t], *b2[t])
    op.process_watermark(1 << 59)
    out = op.drain_output()
    keys = [(int(k), w.start, w.end) for (k, w, _r, _t) in out]
    assert len(keys) == len(set(keys)), "duplicate session emissions"
    assert dict(zip(keys, (float(r) for (_k, _w, r, _t) in out))) == _expect([span0, tail])


def test_superspan_refuses_keydict_mixing():
    op = _mk("port")
    op.process_batch(np.asarray([5]), np.asarray([1.0], np.float32), np.asarray([1000], np.int64))
    kid, spos, rel, vals, bounds = _stage(
        *_rotating_stream(np.random.default_rng(1), 8, 64, 0, _uniform_keys), torch.from_numpy)
    with pytest.raises(ValueError, match="cannot be mixed"):
        op.process_superspan_staged(kid, spos, rel, vals, bounds, [None] * 7 + [7 * 655])


def test_superspan_requires_a_merge():
    kid, spos, rel, vals, bounds = _stage(
        *_rotating_stream(np.random.default_rng(1), 4, 64, 0, _uniform_keys), torch.from_numpy)
    with pytest.raises(ValueError, match="at least one merge"):
        _mk("port").process_superspan_staged(kid, spos, rel, vals, bounds, [None] * 4)
