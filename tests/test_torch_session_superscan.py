"""The port's plain session programs held against the JAX package's.

`ops/superscan.py::session_ingest_plain`, `session_gap_merge_scan_plain`,
`session_merge_plain` and `session_superscan_plain` (the CPU path and the
oracle of kernels K3/K4) against `flink_tpu/ops/superscan.py::
session_ingest_scatter`, `session_gap_merge_scan`, the session operator's
`_build_merge_scan` and `make_session_superscan` (XLA on the CPU), on the
same inputs made from a numpy seed. Rings are compared in the JAX
package's [K, S] layout, emissions decoded from each package's packing.

Tolerance: bit equality. Counts, min/max and int32 fields are order-free;
float32 sums are of integer values below 2^24, so exact in any order; no
-0.0 meets +0.0 in a float min/max. A NaN value makes a float min or max
NaN in both packages; NaN payload bits are not compared.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as hs

jnp = pytest.importorskip("jax.numpy")

from flink_tpu.ops.superscan import (  # noqa: E402
    make_session_superscan,
    session_gap_merge_scan,
    session_ingest_scatter,
)
from flink_tpu.runtime.tpu_session_operator import _build_merge_scan  # noqa: E402
from flink_tpu_torch.ops import cuda_session  # noqa: E402
from flink_tpu_torch.ops import superscan as ps  # noqa: E402

K, S, G = 48, 16, 100
F32_MAX = float(np.finfo(np.float32).max)
I32_MIN, I32_MAX = int(np.iinfo(np.int32).min), int(np.iinfo(np.int32).max)
FIELDS = {
    "count": (),
    "sum": (("sum", "float32", "add"),),
    "max": (("max", "float32", "max"),),
    "int32": (("isum", "int32", "add"), ("imin", "int32", "min")),
    "mixed": (("sum", "float32", "add"), ("max", "float32", "max"),
              ("min", "float32", "min"), ("imax", "int32", "max")),
}
IDENT = {("add", "float32"): 0, ("add", "int32"): 0, ("max", "float32"): -F32_MAX,
         ("min", "float32"): F32_MAX, ("max", "int32"): I32_MIN, ("min", "int32"): I32_MAX}


def _idents(vf):
    return tuple(IDENT[(sc, dt)] for _n, dt, sc in vf)


def _keys(rng, dist, n):
    """Key ids with out-of-range ones mixed in (-1 and >= K must drop)."""
    if dist == "uniform":
        kid = rng.integers(0, K, n)
    else:                                   # zipf(1.0) over K ranks
        w = 1.0 / np.arange(1, K + 1)
        kid = np.searchsorted(np.cumsum(w) / w.sum(), rng.random(n))
    kid[rng.random(n) < 0.05] = -1
    kid[rng.random(n) < 0.03] = K + 2
    return kid.astype(np.int32)


def _records(rng, dist, shape, s_lo, s_hi):
    n = int(np.prod(shape))
    kid = _keys(rng, dist, n)
    s_abs = rng.integers(s_lo, s_hi + 1, n)
    rel = rng.integers(0, G, n)
    vals = rng.integers(-100, 100, n).astype(np.float32)
    return tuple(a.reshape(shape) for a in
                 (kid, (s_abs % S).astype(np.int32), rel.astype(np.int32), vals))


def _jax_rings(vf):
    return (jnp.zeros((K, S), jnp.int32), jnp.full((K, S), G, jnp.int32),
            jnp.full((K, S), -1, jnp.int32),
            tuple(jnp.full((K, S), i, jnp.dtype(dt)) for (_n, dt, _s), i in
                  zip(vf, _idents(vf))))


def _port_rings(vf):
    return (torch.zeros((S, K), dtype=torch.int32), torch.full((S, K), G, dtype=torch.int32),
            torch.full((S, K), -1, dtype=torch.int32),
            [torch.full((S, K), i, dtype=getattr(torch, dt)) for (_n, dt, _s), i in
             zip(vf, _idents(vf))])


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _same_rings(jr, pr):
    (jc, jmn, jmx, jf), (pc, pmn, pmx, pf) = jr, pr
    for j, p in [(jc, pc), (jmn, pmn), (jmx, pmx)] + list(zip(jf, pf)):
        assert np.array_equal(np.asarray(j), p.T.numpy())


def _both_ingested(vf, rng, dist, n=600, s_lo=2, s_hi=9):
    """The same random resident state in both packages."""
    kid, spos, rel, vals = _records(rng, dist, (n,), s_lo, s_hi)
    jr = session_ingest_scatter(K, S, vf)(*_jax_rings(vf), *map(jnp.asarray, (kid, spos, rel, vals)))
    pr = _port_rings(vf)
    ps.session_ingest_plain(*pr, *_t(kid, spos, rel, vals), vf)
    return jr, pr


def _decode_jax(packed, M, vf):
    arr = np.asarray(packed)
    body = arr[:-1]
    out = {}
    for k in range(body.shape[0]):
        for m in range(int(body[k, -1])):
            out[(k, m)] = tuple(int(body[k, b * M + m]) for b in range(3 + len(vf)))
    return out, tuple(int(x) for x in arr[-1, :3])


def _decode_port(packed, M, vf):
    times, blocks, slots, scal = ps.unpack_sessions(packed.numpy(), K, M, len(vf))
    out = {(k, m): tuple(int(x) for x in times[:, m, k]) + tuple(int(x) for x in blocks[:, m, k])
           for k in range(K) for m in range(int(slots[k]))}
    return out, tuple(int(x) for x in scal)


def _floats(dec, vf):
    """Decoded sessions with float fields as floats (NaN payloads aside)."""
    f32 = [3 + j for j, (_n, dt, _s) in enumerate(vf) if dt == "float32"]
    return {key: tuple(float(np.int32(x).view(np.float32)) if b in f32 else x
                       for b, x in enumerate(row)) for key, row in dec[0].items()}


@pytest.mark.parametrize("dist", ["uniform", "zipf"])
@pytest.mark.parametrize("fields", sorted(FIELDS))
def test_ingest_matches_jax(fields, dist):
    vf = FIELDS[fields]
    rng = np.random.default_rng(1)
    jr, pr = _both_ingested(vf, rng, dist)
    _same_rings(jr, pr)
    # a second batch onto the same rings, as [T, B] steps flattened
    kid, spos, rel, vals = _records(rng, dist, (3, 200), 5, 12)
    jr = session_ingest_scatter(K, S, vf)(*jr, *map(jnp.asarray, (kid, spos, rel, vals)))
    ps.session_ingest_plain(*pr, *_t(kid, spos, rel, vals), vf)
    _same_rings(jr, pr)
    assert int(pr[0].sum()) > 0


def test_ingest_drops_every_out_of_range_key():
    vf = FIELDS["mixed"]
    pr = _port_rings(vf)
    kid = np.array([-1, -7, K, K + 100], np.int32)
    ps.session_ingest_plain(*pr, *_t(kid, np.zeros(4, np.int32), np.zeros(4, np.int32),
                                     np.ones(4, np.float32)), vf)
    for ring, fresh in zip([pr[0], pr[1], pr[2]] + pr[3], _port_rings(vf)[:3] + tuple(_port_rings(vf)[3])):
        assert torch.equal(ring, fresh)


@pytest.mark.parametrize("fields", ["count", "mixed"])
def test_gap_merge_scan_matches_jax(fields):
    vf = FIELDS[fields]
    idents = _idents(vf)
    rng = np.random.default_rng(3)
    n, M = 10, 4
    c = np.where(rng.random((K, n)) < 0.5, rng.integers(1, 5, (K, n)), 0).astype(np.int32)
    base = (np.arange(n) * G)[None, :]
    lo = rng.integers(0, G, (K, n))
    fmn = (base + lo).astype(np.int32)
    fmx = (base + np.minimum(lo + rng.integers(0, G, (K, n)), G - 1)).astype(np.int32)
    fl = [rng.integers(-50, 50, (K, n)).astype(dt) for _n, dt, _s in vf]
    jest = (jnp.zeros((K,), jnp.int32), *(jnp.zeros((K, M), jnp.int32) for _ in range(4)),
            jnp.full((K, M), -1, jnp.int32),
            [jnp.full((K, M), i, jnp.dtype(dt)) for (_n, dt, _s), i in zip(vf, idents)],
            jnp.zeros((), bool))
    pest = ps.session_fresh_slots(K, M, [getattr(torch, dt) for _n, dt, _s in vf], "cpu")
    wm = 6 * G
    jest = session_gap_merge_scan(*map(jnp.asarray, (c, fmn, fmx)), list(map(jnp.asarray, fl)),
                                  vf, idents, G, wm, jest)
    pest = ps.session_gap_merge_scan_plain(*_t(c.T, fmn.T, fmx.T), _t(*[f.T for f in fl]), vf,
                                           idents, G, wm, pest)
    slots = np.asarray(jest[0])
    assert np.array_equal(slots, pest[0].numpy()) and slots.sum() > K
    assert bool(jest[7]) == bool(pest[7]) and bool(pest[7])     # M = 4 overflows
    used = np.arange(M)[None, :] < slots[:, None]
    for j, p in list(zip(jest[1:6], pest[1:6])) + list(zip(jest[6], pest[6])):
        assert np.array_equal(np.asarray(j)[used], p.numpy().T[used])


@pytest.mark.parametrize("span", [1, 3, 6, 9])
@pytest.mark.parametrize("fields", sorted(FIELDS))
def test_per_watermark_merge_matches_jax(fields, span):
    """`_build_merge_scan` and `session_merge_plain` over a span padded to a
    power of two with repeats of its last position; span 3 pads one
    duplicate (its purge must not be undone), span 9 takes M = 8 and
    overflows under skew."""
    vf = FIELDS[fields]
    idents = _idents(vf)
    rng = np.random.default_rng(span)
    lo = 5
    jr, pr = _both_ingested(vf, rng, "zipf", n=1200, s_lo=lo, s_hi=lo + span - 1)
    P = 1 << (span - 1).bit_length()
    M = 8 if P > 8 else P + 1
    pos = np.empty(P, np.int32)
    pos[:span] = [s % S for s in range(lo, lo + span)]
    pos[span:] = pos[span - 1]
    valid = np.arange(P) < span
    for wm_rel in (span * G // 2, span * G + G, 10 ** 6):
        run = _build_merge_scan(K, S, P, M, G, vf, idents)
        *jr, jpacked = run(*jr, jnp.asarray(pos), jnp.asarray(valid), jnp.int32(wm_rel))
        ppacked = ps.session_merge_plain(*pr, *_t(pos, valid), wm_rel, g=G, M=M, vfields=vf,
                                         idents=idents)
        _same_rings(jr, pr)
        assert _decode_jax(jpacked, M, vf) == _decode_port(ppacked, M, vf)
    assert int(pr[0].sum()) == 0 or span == 9          # everything closed at 10^6


@pytest.mark.parametrize("merge_every", [4, 16])
@pytest.mark.parametrize("dist", ["uniform", "zipf"])
@pytest.mark.parametrize("fields", ["count", "sum", "int32", "mixed"])
def test_superspan_matches_jax(fields, dist, merge_every):
    vf = FIELDS[fields]
    idents = _idents(vf)
    rng = np.random.default_rng(7)
    T, B, M = 16, 256, 16
    lo0 = 3
    kid, spos, rel, vals = _records(rng, dist, (T, B), lo0, lo0 + 4)
    # groups of four steps drift forward two slices, each group's keys in
    # one half of the key range by turns, so sessions break and close
    q = np.arange(T)[:, None] // 4
    kid = np.where((kid >= 0) & (kid < K), kid % (K // 2) + (q % 2) * (K // 2), kid)
    spos = ((lo0 + 2 * q + rng.integers(0, 2, (T, B))) % S).astype(np.int32)
    flag = np.array([(t + 1) % merge_every == 0 for t in range(T)], np.int32)
    lo_pos = np.full(T, lo0 % S, np.int32)
    lo_rel = np.zeros(T, np.int32)
    wm_rel = np.where(flag > 0, (2 * q[:, 0] + 1) * G - 1, 0).astype(np.int32)
    run = make_session_superscan(K, S, M, G, vf, idents, T, B)
    *jr, jpacked = run(*_jax_rings(vf), *map(jnp.asarray, (kid, spos, rel, vals, flag, lo_pos,
                                                          lo_rel, wm_rel)))
    pr = _port_rings(vf)
    ppacked = ps.session_superscan_plain(*pr, *_t(kid, spos, rel, vals), flag, lo_pos, lo_rel,
                                         wm_rel, g=G, M=M, vfields=vf, idents=idents)
    _same_rings(jr, pr)
    jdec, pdec = _decode_jax(jpacked, M, vf), _decode_port(ppacked, M, vf)
    assert jdec == pdec and len(jdec[0]) > 0


def test_superspan_overflow_sets_the_flag_in_both():
    vf = FIELDS["sum"]
    idents = _idents(vf)
    rng = np.random.default_rng(9)
    T, B, M = 8, 512, 2
    kid, spos, rel, vals = _records(rng, "zipf", (T, B), 0, 7)
    flag = np.array([0, 1, 0, 1, 0, 1, 0, 1], np.int32)
    z = np.zeros(T, np.int32)
    wm_rel = np.full(T, 10 ** 6, np.int32)
    *jr, jpacked = make_session_superscan(K, S, M, G, vf, idents, T, B)(
        *_jax_rings(vf), *map(jnp.asarray, (kid, spos, rel, vals, flag, z, z, wm_rel)))
    pr = _port_rings(vf)
    ppacked = ps.session_superscan_plain(*pr, *_t(kid, spos, rel, vals), flag, z, z, wm_rel,
                                         g=G, M=M, vfields=vf, idents=idents)
    _same_rings(jr, pr)
    jdec, pdec = _decode_jax(jpacked, M, vf), _decode_port(ppacked, M, vf)
    assert jdec == pdec and pdec[1][2] == 1


@pytest.mark.parametrize("flags,runs", [
    ([0, 0, 0, 0, 0, 0, 0, 1] * 2, [(0, 7), (8, 15)]),
    ([1, 0, 0, 1, 0], [(0, 0), (1, 3), (4, 4)]),
    ([0, 0, 1], [(0, 2)]),
])
def test_ingest_runs_end_at_merges(flags, runs):
    """The CUDA wrapper's grouping: one K3 launch per run of steps up to
    and including a merge step (the bench schedule: 2 runs of 8)."""
    assert cuda_session.ingest_runs(flags) == runs


def test_nan_values_propagate_through_float_min_max_as_in_jax():
    """A NaN value makes its cell's float min and max NaN at ingest, and the
    session holding that cell NaN at the merge, in both packages; sums
    carry it as IEEE adds do. (A NaN cast to int32 is undefined in both, so
    the fields are float32 here.)"""
    vf = FIELDS["mixed"][:3]
    idents = _idents(vf)
    rng = np.random.default_rng(13)
    kid, spos, rel, vals = _records(rng, "uniform", (900,), 5, 8)
    vals[rng.random(900) < 0.02] = np.nan
    jr = session_ingest_scatter(K, S, vf)(*_jax_rings(vf), *map(jnp.asarray, (kid, spos, rel, vals)))
    pr = _port_rings(vf)
    ps.session_ingest_plain(*pr, *_t(kid, spos, rel, vals), vf)
    for j, p in zip(jr[3], pr[3]):
        np.testing.assert_array_equal(np.asarray(j), p.T.numpy())
    assert any(bool(torch.isnan(f).any()) for f in pr[3])
    P, M = 4, 5
    pos = np.array([s % S for s in range(5, 9)], np.int32)
    run = _build_merge_scan(K, S, P, M, G, vf, idents)
    *jr, jpacked = run(*jr, jnp.asarray(pos), jnp.ones(P, bool), jnp.int32(10 ** 6))
    ppacked = ps.session_merge_plain(*pr, *_t(pos), None, 10 ** 6, g=G, M=M, vfields=vf,
                                     idents=idents)
    jdec, pdec = _decode_jax(jpacked, M, vf), _decode_port(ppacked, M, vf)
    assert jdec[1] == pdec[1]
    fj, fp = _floats(jdec, vf), _floats(pdec, vf)
    assert fj.keys() == fp.keys() and any(np.isnan(x) for row in fp.values() for x in row)
    np.testing.assert_array_equal(np.array(list(fj.values())), np.array([fp[k] for k in fj]))


def test_wide_gap_times_are_exact_past_int32():
    """A gap of 2^28 ms over 16 slices puts session times past 2^31: the
    plain merge keeps them in int64 (the JAX program's int32 would wrap;
    its operator takes its host merge there), checked against the times
    the records give."""
    vf = FIELDS["sum"]
    g = 1 << 28
    pr = [torch.zeros((S, K), dtype=torch.int32), torch.full((S, K), g, dtype=torch.int32),
          torch.full((S, K), -1, dtype=torch.int32), [torch.zeros((S, K))]]
    cols = np.arange(16)
    kid = np.full(16, 3, np.int32)
    rel = ((15 - cols) * 7919).astype(np.int32)
    ps.session_ingest_plain(*pr, *_t(kid, cols.astype(np.int32), rel, np.ones(16, np.float32)),
                            vf)
    packed = ps.session_merge_plain(*pr, *_t(cols.astype(np.int32)), None, 1 << 40, g=g, M=17,
                                    vfields=vf, idents=(0,))
    times, blocks, slots, _scal = ps.unpack_sessions(packed.numpy(), K, 17, 1)
    # each fragment's min is at most g after the last one's max: one session
    assert int(slots[3]) == 1 and int(slots.sum()) == 1
    assert int(times[0, 0, 3]) == 15 * 7919 and int(times[1, 0, 3]) == 15 * g
    assert int(blocks[0, 0, 3]) == 16 and int(pr[0].sum()) == 0


def test_cpu_wrappers_take_the_plain_versions_and_count_nothing():
    vf = FIELDS["sum"]
    idents = _idents(vf)
    rng = np.random.default_rng(2)
    cuda_session.reset_launch_counts()
    T, B = 4, 64
    kid, spos, rel, vals = _records(rng, "uniform", (T, B), 0, 3)
    args = (*_t(kid, spos, rel, vals), [0, 1, 0, 1], [0] * T, [0] * T, [150, 150, 0, 400])
    a, b = _port_rings(vf), _port_rings(vf)
    pa = cuda_session.session_superscan(*a, *args, g=G, M=8, vfields=vf, idents=idents)
    pb = ps.session_superscan_plain(*b, *args, g=G, M=8, vfields=vf, idents=idents)
    assert torch.equal(pa, pb)
    pos = torch.arange(4, dtype=torch.int32)
    pa = cuda_session.session_merge(*a, pos, 10 ** 6, g=G, M=5, vfields=vf, idents=idents)
    pb = ps.session_merge_plain(*b, pos, None, 10 ** 6, g=G, M=5, vfields=vf, idents=idents)
    assert torch.equal(pa, pb) and int(ps.unpack_sessions(pa, K, 5, 1)[2].sum()) > 0
    assert cuda_session.LAUNCHES == {"k3_session_ingest": 0, "k3_session_ingest_atomic": 0,
                                     "k3_merge_parts": 0, "k4_session_merge": 0}


@pytest.mark.parametrize("fields", ["sum", "mixed"])
def test_window_arguments_change_nothing_on_the_cpu(fields):
    """K3's slice window (`session_ingest(window=)`, `session_superscan(
    step_bounds=)`) is for the card's tiles: the CPU route gives the JAX
    package's rings and sessions whatever window it is handed, even one that
    misses the records."""
    vf = FIELDS[fields]
    idents = _idents(vf)
    rng = np.random.default_rng(21)
    kid, spos, rel, vals = _records(rng, "zipf", (700,), 3, 6)
    jr = session_ingest_scatter(K, S, vf)(*_jax_rings(vf), *map(jnp.asarray, (kid, spos, rel, vals)))
    for window in (None, (3, 6), (S + 3, S + 6), (40, 41)):
        pr = _port_rings(vf)
        cuda_session.session_ingest(*pr, *_t(kid, spos, rel, vals), vf, window=window)
        _same_rings(jr, pr)
    T, B, M = 8, 128, 16
    kid, spos, rel, vals = _records(rng, "uniform", (T, B), 2, 5)
    flag = np.array([0, 0, 0, 1, 0, 0, 0, 1], np.int32)
    z = np.zeros(T, np.int32)
    wm_rel = np.where(flag > 0, 5 * G, 0).astype(np.int32)
    *jr, jpacked = make_session_superscan(K, S, M, G, vf, idents, T, B)(
        *_jax_rings(vf), *map(jnp.asarray, (kid, spos, rel, vals, flag, z, z, wm_rel)))
    for bounds in (None, [(2, 5)] * T, [(60, 61)] * T):
        pr = _port_rings(vf)
        pp = cuda_session.session_superscan(*pr, *_t(kid, spos, rel, vals), flag, z, z, wm_rel,
                                            g=G, M=M, vfields=vf, idents=idents,
                                            step_bounds=bounds)
        _same_rings(jr, pr)
        assert _decode_jax(jpacked, M, vf) == _decode_port(pp, M, vf)


@pytest.mark.parametrize("flag", [[0, 0, 1, 0, 0, 0], [0] * 6], ids=["last_no_merge", "none"])
@pytest.mark.parametrize("fields", ["count", "sum", "int32"])
def test_superspan_unused_slots_zero_and_live_bounds_after_a_last_ingest(fields, flag):
    """A superspan whose last step is not a merge (or that has none): the
    packed result's unused slots are zero and its live bounds are
    `session_live_bounds` of the final ring, relative to the last step's
    base, against `make_session_superscan`."""
    vf = FIELDS[fields]
    idents = _idents(vf)
    rng = np.random.default_rng(22)
    T, B, M = 6, 200, 8
    kid, spos, rel, vals = _records(rng, "uniform", (T, B), 4, 9)
    flag = np.array(flag, np.int32)
    lo_pos = np.full(T, 4, np.int32)
    lo_rel = np.full(T, 4, np.int32)
    wm_rel = np.where(flag > 0, 7 * G, 0).astype(np.int32)
    *jr, jpacked = make_session_superscan(K, S, M, G, vf, idents, T, B)(
        *_jax_rings(vf), *map(jnp.asarray, (kid, spos, rel, vals, flag, lo_pos, lo_rel, wm_rel)))
    pr = _port_rings(vf)
    pp = cuda_session.session_superscan(*pr, *_t(kid, spos, rel, vals), flag, lo_pos, lo_rel,
                                        wm_rel, g=G, M=M, vfields=vf, idents=idents,
                                        step_bounds=[(4, 9)] * T)
    _same_rings(jr, pr)
    assert _decode_jax(jpacked, M, vf) == _decode_port(pp, M, vf)
    times, blocks, slots, scal = ps.unpack_sessions(pp, K, M, len(vf))
    unused = torch.arange(M)[:, None] >= slots[None, :]
    assert not bool(times[:, unused].any()) and not bool(blocks[:, unused].any())
    lo, hi = ps.session_live_bounds(pr[0], 4, 4)
    assert (int(scal[0]), int(scal[1])) == (int(lo), int(hi)) and int(hi) >= 4
    assert int(pp[-1]) == 0 and (int(slots.sum()) > 0) == bool(flag.any())


@settings(max_examples=300, deadline=None, derandomize=True)
@given(S_=hs.integers(1, 200), steps=hs.lists(
    hs.tuples(hs.integers(-10_000, 10_000), hs.integers(0, 300)), min_size=1, max_size=12))
def test_k3_window_covers_exactly_the_slices_of_its_steps(S_, steps):
    """`k3_window` against a brute-force set of ring positions: every
    position a record of the steps can take lies in the W positions from
    p0, and W is the slices' span where that is below S."""
    bounds = [(lo, lo + d) for lo, d in steps]
    p0, W = cuda_session.k3_window(bounds, S_)
    assert 0 <= p0 < S_ and 1 <= W <= S_
    covered = {(p0 + d) % S_ for d in range(W)}
    slices = set(range(min(b[0] for b in bounds), max(b[1] for b in bounds) + 1))
    assert {s % S_ for s in slices} <= covered
    assert W == min(len(slices), S_)


@settings(max_examples=300, deadline=None, derandomize=True)
@given(K_=hs.integers(1, 1 << 15), W=hs.integers(1, 64), nf=hs.integers(0, 4),
       clusters=hs.sampled_from([1, 7, 15, 30, 132]))
def test_k3_plan_tiles_every_key_once_within_shared_memory(K_, W, nf, clusters):
    """`k3_plan` against a brute-force deal of the keys: each key has one
    (tile, local key) place, local keys below KT, distinct within a tile;
    a tile's cells fit K3_SMEM, with the fewest power-of-two tiles that
    fit; each tile's records split over as many clusters as the card holds
    at once (at least one, at most K3_MAX_PARTS); its scratch holds every
    tile's partials; the atomic route only where no tile count up to
    K3_MAX_TILES fits."""
    nt, q, kt = cuda_session.k3_plan(K_, W, nf, clusters)
    run = cuda_session.K3_RUN
    runs = -(-K_ // run)
    fits = [t for t in (1 << e for e in range(16)) if t <= cuda_session.K3_MAX_TILES
            and run * -(-runs // t) * (3 + nf) * W * 4 <= cuda_session.K3_SMEM]
    if nt == 0:
        assert not fits and q == kt == 0
        return
    assert nt & (nt - 1) == 0 and nt >= min(fits) and kt % run == 0
    assert (3 + nf) * W * kt * 4 <= cuda_session.K3_SMEM
    k = np.arange(K_)
    tile, local = (k // run) & (nt - 1), (k // run) // nt * run + k % run
    assert local.max() < kt
    assert len(set(zip(tile.tolist(), local.tolist()))) == K_
    assert nt == min(fits)
    assert q == max(1, min(cuda_session.K3_MAX_PARTS, clusters // nt))
    assert q == 1 or nt * q <= clusters
    words = cuda_session.k3_scratch_words(K_, W, nf, (nt, q, kt))
    assert words - cuda_session.K3_PARTS == (nt * q * (3 + nf) * W * kt if q > 1 else 0)
    assert cuda_session.K3_PARTS % 4 == 0          # the partials 16-byte aligned


@pytest.mark.parametrize("n", [0, 1, 6, 64, 2048])
@pytest.mark.parametrize("nf", [0, 1, 4])
def test_k4_chunk_fits_its_stage(n, nf):
    ch = cuda_session.k4_chunk(n, nf)
    assert 1 <= ch <= min(max(n, 1), 64)
    assert ch * (3 + nf) * cuda_session.K4_KEYS * 4 <= cuda_session.K4_STAGE_SMEM


def test_k3_launches_count_wrapper_calls_over_both_routes():
    """`k3_launches` adds K3's two routes, one a wrapper's ingest; the
    tiled route's partials merge, a second kernel of such a launch, has a
    count of its own outside it; `reset_launch_counts` zeroes every count."""
    d = {"k3_session_ingest": 3, "k3_session_ingest_atomic": 5, "k3_merge_parts": 2,
         "k4_session_merge": 7}
    assert cuda_session.k3_launches(d) == 8
    saved = dict(cuda_session.LAUNCHES)
    try:
        cuda_session.LAUNCHES.update(d)
        assert cuda_session.k3_launches() == 8
        cuda_session.reset_launch_counts()
        assert set(cuda_session.LAUNCHES) == set(d) and not any(cuda_session.LAUNCHES.values())
    finally:
        cuda_session.LAUNCHES.update(saved)
