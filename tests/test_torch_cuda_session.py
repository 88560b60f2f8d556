"""Hopper kernels K3 (session ingest) and K4 (session gap-merge) against
their plain PyTorch versions, on the card.

These need an NVIDIA GPU and nvcc (a CUDA kernel has no interpret mode), so
they carry the `cuda` marker and skip elsewhere. Run them on the card with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_session.py

Shapes: the bench geometry of `bench.py::secondary_sessions` (2^14 keys,
64 gap-slices of 2000 ms, 2^20 records a step from the session stream) and
adversarial inputs: every record dropped, one hot key closing more sessions
than it has slots, +-FLT_MAX and NaN in float min/max fields, a span of
exactly S, a gap whose session times pass int32.

Tolerance: bit equality of rings and packed results. Counts, min/max and
int32 fields are order-free; float32 sums are of integers below 2^24, so
exact in any order; no -0.0 meets +0.0 in a float min/max. A NaN value
makes a float min or max NaN in both; NaN payload bits are not compared
(the NaN test holds the kernels against the plain version on the CPU).
"""

import numpy as np
import pytest
import torch

from flink_tpu_torch.api.windowing.assigners import EventTimeSessionWindows
from flink_tpu_torch.ops import cuda_session
from flink_tpu_torch.ops import superscan as ps
from flink_tpu_torch.runtime.tpu_session_operator import TpuSessionWindowOperator
from flink_tpu_torch.testing import stream as st

pytestmark = pytest.mark.cuda

K, S, G = 1 << 14, 64, st.SESSION_GAP_MS
F32_MAX = float(np.finfo(np.float32).max)
FIELDS = {
    "count": (),
    "sum": (("sum", "float32", "add"),),
    "mixed": (("sum", "float32", "add"), ("max", "float32", "max"),
              ("min", "float32", "min"), ("imax", "int32", "max")),
    "int32": (("isum", "int32", "add"), ("imin", "int32", "min")),
}
IDENT = {("add", "float32"): 0, ("add", "int32"): 0, ("max", "float32"): -F32_MAX,
         ("min", "float32"): F32_MAX, ("max", "int32"): int(np.iinfo(np.int32).min),
         ("min", "int32"): int(np.iinfo(np.int32).max)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the Hopper kernels have no CPU form")
    return torch.device("cuda")


def _idents(vf):
    return tuple(IDENT[(sc, dt)] for _n, dt, sc in vf)


def _rings(vf, dev, k=K):
    return [torch.zeros((S, k), dtype=torch.int32, device=dev),
            torch.full((S, k), G, dtype=torch.int32, device=dev),
            torch.full((S, k), -1, dtype=torch.int32, device=dev),
            [torch.full((S, k), i, dtype=getattr(torch, dt), device=dev)
             for (_n, dt, _s), i in zip(vf, _idents(vf))]]


def _clone(r):
    return [r[0].clone(), r[1].clone(), r[2].clone(), [f.clone() for f in r[3]]]


def _equal(a, b):
    assert all(torch.equal(x, y) for x, y in zip(a[:3] + a[3], b[:3] + b[3]))


def _steps(dev, T, t0=0):
    return st.make_session_gen(T, 1 << 20, device=dev)(t0)


def _window(t0, t1, B=1 << 20):
    """The absolute slices steps t0..t1 of the session stream lie in."""
    b = [st.session_step_bounds(t, B) for t in range(t0, t1 + 1)]
    return min(x[0] for x in b), max(x[1] for x in b)


@pytest.mark.parametrize("fields", sorted(FIELDS))
def test_k3_matches_plain_at_the_bench_shape(cuda, fields):
    """One step and a run of 7, each over its window: the tiled route."""
    vf = FIELDS[fields]
    kid, spos, rel, vals = _steps(cuda, 8)
    a = _rings(vf, cuda)
    b = _clone(a)
    cuda_session.reset_launch_counts()
    cuda_session.session_ingest(*a, kid[0], spos[0], rel[0], vals[0], vf,   # one step
                                window=_window(0, 0))
    cuda_session.session_ingest(*a, kid[1:], spos[1:], rel[1:], vals[1:], vf,  # a run of 7
                                window=_window(1, 7))
    ps.session_ingest_plain(*b, kid, spos, rel, vals, vf)
    torch.cuda.synchronize()
    assert cuda_session.LAUNCHES["k3_session_ingest"] == 2
    assert cuda_session.LAUNCHES["k3_session_ingest_atomic"] == 0
    clusters = cuda_session._head(*a, vf, ()).clusters
    parts = sum(cuda_session.k3_plan(K, cuda_session.k3_window([w], S)[1], len(vf), clusters)[1]
                > 1 for w in (_window(0, 0), _window(1, 7)))
    assert cuda_session.LAUNCHES["k3_merge_parts"] == parts     # each launch's second kernel
    _equal(a, b)
    assert int(a[0].sum()) == 8 << 20


@pytest.mark.parametrize("case", ["no_window", "few_records"])
@pytest.mark.parametrize("fields", ["sum", "mixed"])
def test_k3_atomic_route_by_shape(cuda, fields, case):
    """No window (all S positions of 2^14 keys outgrow the tiles), or a
    window but fewer records than K3_TILED_MIN_RECORDS: K3 lands by device
    atomics, counted under its own name."""
    vf = FIELDS[fields]
    kid, spos, rel, vals = _steps(cuda, 2)
    window = None
    if case == "few_records":
        kid, spos, rel, vals = (x[0, :cuda_session.K3_TILED_MIN_RECORDS - 4]
                                for x in (kid, spos, rel, vals))
        window = _window(0, 0)
    else:
        assert cuda_session.k3_plan(K, S, len(vf), 1)[0] == 0
    a = _rings(vf, cuda)
    b = _clone(a)
    cuda_session.reset_launch_counts()
    cuda_session.session_ingest(*a, kid, spos, rel, vals, vf, window=window)
    ps.session_ingest_plain(*b, kid, spos, rel, vals, vf)
    torch.cuda.synchronize()
    assert cuda_session.LAUNCHES == {"k3_session_ingest": 0, "k3_session_ingest_atomic": 1,
                                     "k3_merge_parts": 0, "k4_session_merge": 0}
    _equal(a, b)


def _random_records(rng, n, k, slices, g=G):
    cols = [rng.integers(0, k, n), rng.choice(slices, n), rng.integers(0, g, n)]
    return [torch.from_numpy(c.astype(np.int32)) for c in cols]


@pytest.mark.parametrize("k", [1000, 4099, 1 << 14])
def test_k3_window_wraps_the_ring_and_tiles_straddle(cuda, k):
    """A window of 4 positions that wraps past S (S-2, S-1, 0, 1), keys of
    every tile (K not a multiple of a tile, nor of a 32-key run), a record
    outside the window (landed by atomics) and out-of-range keys."""
    vf = FIELDS["mixed"]
    rng = np.random.default_rng(11)
    n = 300_001
    kid, spos, rel = _random_records(rng, n, k, [S - 2, S - 1, 0, 1])
    kid[::97] = -1
    kid[5::101] = k + 3
    spos[7] = 5                                     # outside the window
    vals = torch.from_numpy(rng.integers(-500, 500, n).astype(np.float32))
    nt, _q, kt = cuda_session.k3_plan(k, 4, len(vf), 1)
    assert nt * kt >= k and (k < 4000 or nt > 1)
    a = _rings(vf, cuda, k)
    b = _clone(a)
    cuda_session.reset_launch_counts()
    cuda_session.session_ingest(*a, *(x.to(cuda) for x in (kid, spos, rel, vals)), vf,
                                window=(7 * S + S - 2, 8 * S + 1))
    ps.session_ingest_plain(*b, *(x.to(cuda) for x in (kid, spos, rel, vals)), vf)
    torch.cuda.synchronize()
    assert cuda_session.LAUNCHES["k3_session_ingest"] == 1
    _equal(a, b)
    assert int(a[0][5].sum()) == int(kid[7] >= 0)


# every kind over the two sets; +-FLT_MAX and NaN only in the float
# min/max set (a float sum of them depends on the order, an int cast of
# them is undefined)
EVERY_KIND = {
    "floats": (("max", "float32", "max"), ("min", "float32", "min"),
               ("max2", "float32", "max"), ("min2", "float32", "min")),
    "ints": (("isum", "int32", "add"), ("imin", "int32", "min"),
             ("imax", "int32", "max"), ("sum", "float32", "add")),
}


@pytest.mark.parametrize("window", [True, False], ids=["tiled", "atomic"])
@pytest.mark.parametrize("kinds", sorted(EVERY_KIND))
def test_k3_four_fields_of_every_kind_with_nan_and_extremes(cuda, kinds, window):
    """Four fields, every kind among the two sets, +-FLT_MAX and NaN in
    the float min/max set, on each route: the rings equal the plain version's
    on the CPU, NaN where it has NaN."""
    vf = EVERY_KIND[kinds]
    rng = np.random.default_rng(12)
    n = 1 << 18
    kid, spos, rel = _random_records(rng, n, 4096, [9, 10])
    v = rng.integers(-1000, 1000, n).astype(np.float32)
    if kinds == "floats":
        v[rng.random(n) < 0.01] = F32_MAX
        v[rng.random(n) < 0.01] = -F32_MAX
        v[rng.random(n) < 1e-3] = np.nan
    else:
        v += 0.5                                      # truncated toward zero
    vals = torch.from_numpy(v)
    a = _rings(vf, cuda)
    b = [x.cpu() if torch.is_tensor(x) else [f.cpu() for f in x] for x in a]
    cuda_session.reset_launch_counts()
    cuda_session.session_ingest(*a, *(x.to(cuda) for x in (kid, spos, rel, vals)), vf,
                                window=(9, 10) if window else None)
    ps.session_ingest_plain(*b, kid, spos, rel, vals, vf)
    assert cuda_session.LAUNCHES["k3_session_ingest" if window
                                 else "k3_session_ingest_atomic"] == 1
    for x, y in zip(a[:3] + a[3], b[:3] + b[3]):
        _nan_equal(x.cpu(), y)


def test_k3_drops_every_record_out_of_range(cuda):
    vf = FIELDS["mixed"]
    n = 100_003
    kid = torch.where(torch.arange(n, device=cuda) % 2 == 0, -1, K).to(torch.int32)
    z = torch.zeros(n, dtype=torch.int32, device=cuda)
    a = _rings(vf, cuda)
    fresh = _clone(a)
    cuda_session.session_ingest(*a, kid, z, z, torch.ones(n, device=cuda), vf)
    torch.cuda.synchronize()
    _equal(a, fresh)


@pytest.mark.parametrize("fields", ["float_extremes", "int32"])
def test_k3_float_extremes_and_negative_values(cuda, fields):
    """Float min/max fields meet +-FLT_MAX among negative and positive
    values; int32 fields take negative values (cast toward zero)."""
    rng = np.random.default_rng(4)
    n = 1 << 18
    vals = rng.integers(-1000, 1000, n).astype(np.float32)
    if fields == "float_extremes":
        vf = (("max", "float32", "max"), ("min", "float32", "min"))
        vals[rng.random(n) < 0.01] = F32_MAX
        vals[rng.random(n) < 0.01] = -F32_MAX
    else:
        vf = FIELDS["int32"] + (("imax", "int32", "max"),)
        vals += 0.5                                   # truncated toward zero
    cols = [rng.integers(0, 64, n), rng.integers(0, S, n), rng.integers(0, G, n)]
    kid, spos, rel = (torch.from_numpy(c.astype(np.int32)).to(cuda) for c in cols)
    v = torch.from_numpy(vals).to(cuda)
    a = _rings(vf, cuda)
    b = _clone(a)
    cuda_session.session_ingest(*a, kid, spos, rel, v, vf)
    ps.session_ingest_plain(*b, kid, spos, rel, v, vf)
    torch.cuda.synchronize()
    _equal(a, b)


def _resident(dev, vf, T=8):
    """A bench-shaped resident ring: 8 steps of the session stream."""
    kid, spos, rel, vals = _steps(dev, T)
    r = _rings(vf, dev)
    ps.session_ingest_plain(*r, kid, spos, rel, vals, vf)
    return r


def _span(dev, lo, hi):
    """The ring positions of slices lo..hi, as the operator passes them."""
    return torch.from_numpy((np.arange(lo, hi + 1) % S).astype(np.int32)).to(dev)


@pytest.mark.parametrize("wm", [2000, 4000, 1 << 30])
@pytest.mark.parametrize("fields", ["sum", "mixed"])
def test_k4_per_watermark_matches_plain_at_the_bench_shape(cuda, fields, wm):
    vf = FIELDS[fields]
    a = _resident(cuda, vf)
    b = _clone(a)
    pos = _span(cuda, 0, 3)                        # 8 steps of 655 ms: slices 0..2
    kw = dict(g=G, M=5, vfields=vf, idents=_idents(vf))
    pa = cuda_session.session_merge(*a, pos, wm, **kw)
    pb = ps.session_merge_plain(*b, pos, None, wm, **kw)
    torch.cuda.synchronize()
    _equal(a, b)
    assert torch.equal(pa, pb)


def test_k4_hot_key_past_its_slots_and_a_span_of_exactly_s(cuda):
    """One key with a session in every other slice of all S slices: more
    closed sessions than M = 8 slots, so the overflow flag is set (in both)."""
    vf = FIELDS["mixed"]
    n = S // 2
    kid = torch.full((n,), 7, dtype=torch.int32, device=cuda)
    spos = torch.arange(0, S, 2, dtype=torch.int32, device=cuda)
    spos[-1] = S - 1
    z = torch.zeros(n, dtype=torch.int32, device=cuda)
    a = _rings(vf, cuda)
    ps.session_ingest_plain(*a, kid, spos, z, torch.ones(n, device=cuda), vf)
    b = _clone(a)
    pos = _span(cuda, 0, S - 1)
    kw = dict(g=G, M=8, vfields=vf, idents=_idents(vf))
    pa = cuda_session.session_merge(*a, pos, 1 << 30, **kw)
    pb = ps.session_merge_plain(*b, pos, None, 1 << 30, **kw)
    torch.cuda.synchronize()
    _equal(a, b)
    assert torch.equal(pa, pb) and int(pa[-2]) == 1


def test_k4_wide_gap_times_pass_int32(cuda):
    """A gap of 2^28 ms over all S slices: session ends past 2^31 ms, held
    in the packed result's int64 times, bit-equal to the plain version."""
    vf = FIELDS["mixed"]
    g = 1 << 28
    rng = np.random.default_rng(8)
    n = 1 << 16
    cols = [rng.integers(0, 512, n), rng.integers(0, S, n), rng.integers(0, g, n)]
    kid, spos, rel = (torch.from_numpy(c.astype(np.int32)).to(cuda) for c in cols)
    v = torch.from_numpy(rng.integers(-99, 99, n).astype(np.float32)).to(cuda)
    a = [torch.zeros((S, 512), dtype=torch.int32, device=cuda),
         torch.full((S, 512), g, dtype=torch.int32, device=cuda),
         torch.full((S, 512), -1, dtype=torch.int32, device=cuda),
         [torch.full((S, 512), i, dtype=getattr(torch, dt), device=cuda)
          for (_n, dt, _s), i in zip(vf, _idents(vf))]]
    ps.session_ingest_plain(*a, kid, spos, rel, v, vf)
    b = _clone(a)
    kw = dict(g=g, M=S + 1, vfields=vf, idents=_idents(vf))
    pa = cuda_session.session_merge(*a, _span(cuda, 0, S - 1), 1 << 40, **kw)
    pb = ps.session_merge_plain(*b, _span(cuda, 0, S - 1), None, 1 << 40, **kw)
    torch.cuda.synchronize()
    _equal(a, b)
    assert torch.equal(pa, pb) and int(a[0].sum()) == 0
    times = ps.unpack_sessions(pa, 512, S + 1, len(vf))[0]
    assert int(times[1].max()) > (1 << 31)


def _nan_equal(x, y):
    torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True)


def test_k3_k4_propagate_nan_as_the_plain_version(cuda):
    """NaN values among the session stream's: K3's rings and K4's decoded
    sessions equal the plain version's (run on the CPU), NaN where it has
    NaN."""
    vf = FIELDS["mixed"][:3]                       # float fields: a NaN int cast is undefined
    kid, spos, rel, vals = _steps(cuda, 2)
    vals = torch.where(torch.rand(vals.shape, device=cuda) < 1e-3, float("nan"), vals)
    a = _rings(vf, cuda)
    b = _clone([x.cpu() if torch.is_tensor(x) else [f.cpu() for f in x] for x in a])
    cuda_session.session_ingest(*a, kid, spos, rel, vals, vf)
    ps.session_ingest_plain(*b, *(x.cpu() for x in (kid, spos, rel, vals)), vf)
    for x, y in zip(a[:3] + a[3], b[:3] + b[3]):
        _nan_equal(x.cpu(), y)
    assert bool(torch.isnan(a[3][1]).any()) and bool(torch.isnan(a[3][2]).any())
    kw = dict(g=G, M=5, vfields=vf, idents=_idents(vf))
    pa = cuda_session.session_merge(*a, _span(cuda, 0, 3), 1 << 30, **kw).cpu()
    pb = ps.session_merge_plain(*b, _span("cpu", 0, 3), None, 1 << 30, **kw)
    for x, y in zip(a[:3] + a[3], b[:3] + b[3]):
        _nan_equal(x.cpu(), y)
    ua, ub = ps.unpack_sessions(pa, K, 5, 3), ps.unpack_sessions(pb, K, 5, 3)
    assert all(torch.equal(x, y) for x, y in zip((ua[0], ua[1][0], ua[2]), (ub[0], ub[1][0], ub[2])))
    _nan_equal(ua[1][1:].view(torch.float32), ub[1][1:].view(torch.float32))


@pytest.mark.parametrize("fields", ["count", "sum", "int32"])
def test_superspan_on_the_card_matches_the_cpu(cuda, fields):
    """The bench schedule (T = 16, merges after steps 7 and 15): 2 K3 and 2
    K4 launches, against the plain superspan on the CPU."""
    vf = FIELDS[fields]
    T = 16
    kid, spos, rel, vals = _steps(cuda, T)
    flag = [1 if (t + 1) % 8 == 0 else 0 for t in range(T)]
    wm_rel = [(t + 1) * st.STEP_MS - 1000 if f else 0 for t, f in enumerate(flag)]
    plan = (flag, [0] * T, [0] * T, wm_rel)
    kw = dict(g=G, M=16, vfields=vf, idents=_idents(vf))
    a = _rings(vf, cuda)
    b = [x.cpu() if torch.is_tensor(x) else [f.cpu() for f in x] for x in a]
    cuda_session.reset_launch_counts()
    pa = cuda_session.session_superscan(*a, kid, spos, rel, vals, *plan, **kw)
    pb = ps.session_superscan_plain(*b, *(x.cpu() for x in (kid, spos, rel, vals)), *plan, **kw)
    torch.cuda.synchronize()
    assert cuda_session.LAUNCHES == {"k3_session_ingest": 0, "k3_session_ingest_atomic": 2,
                                     "k3_merge_parts": 0, "k4_session_merge": 2}
    _equal([x.cpu() if torch.is_tensor(x) else [f.cpu() for f in x] for x in a], b)
    assert torch.equal(pa.cpu(), pb)
    assert int(ps.unpack_sessions(pb, K, 16, len(vf))[2].sum()) > 0


def _op(dev, **kw):
    return TpuSessionWindowOperator(EventTimeSessionWindows.with_gap(1000), "sum",
                                    device=dev, **kw)


def test_operator_on_the_card_matches_the_cpu(cuda):
    rng = np.random.default_rng(3)
    outs = []
    for dev in (cuda, "cpu"):
        op = _op(dev, key_capacity=64, defer_emissions=True)
        rng = np.random.default_rng(3)
        t = 0
        for _ in range(20):
            keys = rng.integers(0, 300, 4000)         # grows the key capacity
            ts = t + rng.integers(0, 1500, 4000)
            op.process_batch(keys, rng.integers(0, 9, 4000).astype(np.float32), ts)
            op.process_watermark(int(ts.max()) - 600)
            t += 700 + int(rng.integers(0, 3)) * 2500
        op.process_watermark(1 << 60)
        outs.append(sorted((int(k), w.start, w.end, float(r)) for k, w, r, _t in op.drain_output()))
    assert len(outs[0]) > 100 and outs[0] == outs[1]


@pytest.mark.parametrize("name", ["sum", "min", "max", "mean"])
def test_operator_on_the_card_runs_64bit_fields(cuda, name):
    """ROADMAP C1: an aggregate declared np.float64 runs on K3/K4 in its
    32-bit form, equal to the CPU's run of it."""
    from flink_tpu_torch.ops import aggregators as agg_mod

    agg = getattr(agg_mod, f"{name}_agg")(np.float64)
    outs = []
    for dev in (cuda, "cpu"):
        cuda_session.reset_launch_counts()
        op = TpuSessionWindowOperator(EventTimeSessionWindows.with_gap(1000), agg,
                                      key_capacity=64, device=dev)
        rng = np.random.default_rng(8)
        t = 0
        for _ in range(12):
            keys = rng.integers(0, 100, 2000)
            ts = t + rng.integers(0, 1500, 2000)
            op.process_batch(keys, rng.integers(0, 9, 2000).astype(np.float32), ts)
            op.process_watermark(int(ts.max()) - 600)
            t += 700 + int(rng.integers(0, 3)) * 2500
        op.process_watermark(1 << 60)
        outs.append(sorted((int(k), w.start, w.end, repr(r)) for k, w, r, _t in op.drain_output()))
        if dev == cuda:
            assert cuda_session.k3_launches() > 0
            assert cuda_session.LAUNCHES["k4_session_merge"] > 0
    assert len(outs[0]) > 50 and outs[0] == outs[1]


def test_superspan_operator_on_the_card_matches_the_cpu_and_numpy(cuda):
    T, B = 16, 1 << 16
    gen = st.make_session_gen(T, B, device=cuda)
    outs = []
    for dev in (cuda, "cpu"):
        op = TpuSessionWindowOperator(EventTimeSessionWindows.with_gap(G), "sum",
                                      key_capacity=K, num_slices=S, defer_emissions=True,
                                      device=dev)
        for lo in range(0, 2 * T, T):
            staged = [x.to(dev) for x in gen(lo)]
            bounds = [st.session_step_bounds(lo + r, B) for r in range(T)]
            wms = [st.watermark_after(lo + r) if (r + 1) % 8 == 0 else None for r in range(T)]
            op.process_superspan_staged(*staged, bounds, wms)
        op.process_watermark(1 << 60)
        outs.append({(int(k), w.start, w.end): float(r) for k, w, r, _t in op.drain_output()})
        assert op.superspan_replays == 0
    recs = [np.concatenate(a) for a in zip(*(st.host_session_step(t, B) for t in range(2 * T)))]
    assert outs[0] == outs[1] == st.numpy_sessionize(*recs, G)


def _on_cpu(r):
    return [x.cpu() if torch.is_tensor(x) else [f.cpu() for f in x] for x in r]


def _empty_steps(dev, T=1):
    none = torch.empty((T, 0), dtype=torch.int32, device=dev)
    return none, none, none, none.float()


def test_k4_superspan_hot_key_past_its_slots_over_exactly_s(cuda):
    """The hot key of the per-watermark test in a superspan merge over all
    S columns, under tile staging: overflow set, rings, slots and live
    bounds equal the plain version's."""
    vf = FIELDS["mixed"]
    n = S // 2
    kid = torch.full((n,), 7, dtype=torch.int32, device=cuda)
    spos = torch.arange(0, S, 2, dtype=torch.int32, device=cuda)
    spos[-1] = S - 1
    z = torch.zeros(n, dtype=torch.int32, device=cuda)
    a = _rings(vf, cuda)
    ps.session_ingest_plain(*a, kid, spos, z, torch.ones(n, device=cuda), vf)
    b = _clone(a)
    plan = ([1], [3], [0], [1 << 30])
    kw = dict(g=G, M=8, vfields=vf, idents=_idents(vf))
    pa = cuda_session.session_superscan(*a, *_empty_steps(cuda), *plan, **kw)
    pb = ps.session_superscan_plain(*b, *_empty_steps(cuda), *plan, **kw)
    torch.cuda.synchronize()
    _equal(a, b)
    assert torch.equal(pa, pb) and int(pa[-2]) == 1 and int(pa[-3]) >= 0


@pytest.mark.parametrize("merges", [(7,), ()], ids=["last_step_no_merge", "no_merge"])
@pytest.mark.parametrize("fields", ["sum", "mixed"])
def test_superspan_live_bounds_after_a_last_step_without_a_merge(cuda, fields, merges):
    """T = 12 steps of 2^16 records with a merge after step 7 only, or
    none: the ingest after the last merge extends the live bounds, which
    one more K4 launch reads from the final ring; packed result (unused
    slots zero) and rings equal the plain superspan's on the CPU."""
    vf = FIELDS[fields]
    T, B = 12, 1 << 16
    kid, spos, rel, vals = st.make_session_gen(T, B, device=cuda)(0)
    flag = [1 if t in merges else 0 for t in range(T)]
    wm_rel = [st.watermark_after(t) if f else 0 for t, f in enumerate(flag)]
    plan = (flag, [0] * T, [0] * T, wm_rel)
    kw = dict(g=G, M=16, vfields=vf, idents=_idents(vf))
    a = _rings(vf, cuda)
    b = _on_cpu(a)
    cuda_session.reset_launch_counts()
    pa = cuda_session.session_superscan(
        *a, kid, spos, rel, vals, *plan, **kw,
        step_bounds=[st.session_step_bounds(t, B) for t in range(T)])
    pb = ps.session_superscan_plain(*b, *(x.cpu() for x in (kid, spos, rel, vals)), *plan, **kw)
    torch.cuda.synchronize()
    launches = dict(cuda_session.LAUNCHES)
    assert launches.pop("k3_merge_parts") <= len(merges) + 1
    assert launches == {"k3_session_ingest": len(merges) + 1, "k3_session_ingest_atomic": 0,
                        "k4_session_merge": len(merges) + 1}
    _equal(_on_cpu(a), b)
    assert torch.equal(pa.cpu(), pb)
    lo, hi = ps.session_live_bounds(b[0], 0, 0)
    assert (int(pb[-4]), int(pb[-3])) == (int(lo), int(hi)) and int(hi) >= 0


def test_k4_per_watermark_merge_over_an_empty_ring(cuda):
    """No fragment anywhere: no session, every slot zero, bounds (P, -1)."""
    vf = FIELDS["mixed"]
    a = _rings(vf, cuda)
    b = _clone(a)
    pos = _span(cuda, 60, 69)                       # wraps past S
    kw = dict(g=G, M=11, vfields=vf, idents=_idents(vf))
    pa = cuda_session.session_merge(*a, pos, 1 << 30, **kw)
    pb = ps.session_merge_plain(*b, pos, None, 1 << 30, **kw)
    torch.cuda.synchronize()
    _equal(a, b)
    assert torch.equal(pa, pb)
    assert pa[-4:].tolist() == [10, -1, 0, 0] and not bool(pa[:-4].any())


@pytest.mark.parametrize("k", [1000, 4099])
def test_k4_keys_not_a_multiple_of_its_tile(cuda, k):
    """K not a multiple of K4's 32-key tile (4099: nor of 4, so every
    column row is staged a cell at a time), both modes, against the plain
    versions."""
    vf = FIELDS["mixed"]
    rng = np.random.default_rng(13)
    n = 200_000
    kid, spos, rel = _random_records(rng, n, k, np.arange(20, 27))
    vals = torch.from_numpy(rng.integers(-99, 99, n).astype(np.float32))
    base = _rings(vf, cuda, k)
    ps.session_ingest_plain(*base, *(x.to(cuda) for x in (kid, spos, rel, vals)), vf)
    kw = dict(g=G, M=9, vfields=vf, idents=_idents(vf))
    pos = _span(cuda, 20, 27)
    for wm in (3 * G, 1 << 30):
        a, b = _clone(base), _clone(base)
        pa = cuda_session.session_merge(*a, pos, wm, **kw)
        pb = ps.session_merge_plain(*b, pos, None, wm, **kw)
        a2, b2 = _clone(base), _clone(base)
        plan = ([1], [20], [0], [wm])
        qa = cuda_session.session_superscan(*a2, *_empty_steps(cuda), *plan, **kw)
        qb = ps.session_superscan_plain(*b2, *_empty_steps(cuda), *plan, **kw)
        torch.cuda.synchronize()
        _equal(a, b)
        _equal(a2, b2)
        assert torch.equal(pa, pb) and torch.equal(qa, qb)
        assert wm != 1 << 30 or int(ps.unpack_sessions(pb, k, 9, len(vf))[2].sum()) > 0


def test_no_torch_kernel_runs_inside_the_session_wrappers(cuda):
    """Under the profiler, a superspan and a per-watermark merge run the
    K3/K4 kernels and nothing else on the card (the result is a
    torch.empty buffer)."""
    from flink_tpu_torch.testing.timing import device_profile

    vf = FIELDS["sum"]
    T, B = 16, 1 << 16
    staged = st.make_session_gen(T, B, device=cuda)(0)
    flag = [1 if (t + 1) % 8 == 0 else 0 for t in range(T)]
    plan = (flag, [0] * T, [0] * T, [st.watermark_after(t) for t in range(T)])
    kw = dict(g=G, M=16, vfields=vf, idents=_idents(vf))
    bounds = [st.session_step_bounds(t, B) for t in range(T)]
    a = _rings(vf, cuda)
    pos = _span(cuda, 0, 5)

    def both():
        cuda_session.session_superscan(*a, *staged, *plan, **kw, step_bounds=bounds)
        cuda_session.session_merge(*a, pos, 1 << 30, **kw)

    split, launches = device_profile(both, reps=2)   # a warm-up call first
    # 2 K3 (each one kernel, or the tiled ingest and its merge), 3 K4
    assert any(n.startswith("k4_") for n in split), split
    assert 5 <= launches <= 7, (launches, split)
    assert all(n.startswith(("k3_", "k4_")) for n in split), split
