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


@pytest.mark.parametrize("fields", sorted(FIELDS))
def test_k3_matches_plain_at_the_bench_shape(cuda, fields):
    vf = FIELDS[fields]
    kid, spos, rel, vals = _steps(cuda, 8)
    a = _rings(vf, cuda)
    b = _clone(a)
    cuda_session.reset_launch_counts()
    cuda_session.session_ingest(*a, kid[0], spos[0], rel[0], vals[0], vf)   # one step
    cuda_session.session_ingest(*a, kid[1:], spos[1:], rel[1:], vals[1:], vf)  # a run of 7
    ps.session_ingest_plain(*b, kid, spos, rel, vals, vf)
    torch.cuda.synchronize()
    assert cuda_session.LAUNCHES["k3_session_ingest"] == 2
    _equal(a, b)
    assert int(a[0].sum()) == 8 << 20


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
    assert cuda_session.LAUNCHES == {"k3_session_ingest": 2, "k4_session_merge": 2}
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
