"""Two-input joins on the port, held against the JAX package on the CPU.

The same numpy-seeded inputs go through the JAX modules (`JAX_PLATFORMS=cpu`)
and the port (`device="cpu"`), compared exactly:

- the device programs of the join ring (`ops/join_ring.py`, ROADMAP B5):
  `build_join_ingest` and both forms of `build_join_match`, over random
  geometries;
- `BucketRing` and `FusedJoinPipeline`: host mirror, device arrays,
  overflow refusals, fired pairs in order, `expand_pairs`, regrow, purge,
  snapshot/restore (across the packages);
- `DeviceJoinRunner`, `WindowJoinRunner` and `StreamingJoinRunner` jobs:
  rows in order where both packages run the device route, as multisets
  against the host route; degrade reasons, late-drop counts and snapshots
  in both modes;
- a twin of every case of tests/test_device_join.py and
  tests/test_stream_join_oracle.py except the sharded and gauge cases
  (ROADMAP items 13 and 15).

Tolerance: exact (rows, arrays and counts are integers or strings).
"""

import types

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax.numpy as jnp

import flink_tpu.api.datastream as jds
import flink_tpu.api.windowing.assigners as jasg
import flink_tpu.config as jcfg
import flink_tpu.core.watermarks as jwm
import flink_tpu.graph.transformation as jtr
import flink_tpu.joins.pipeline as jpipe
import flink_tpu.joins.ring as jring
import flink_tpu.joins.spec as jspec
import flink_tpu.ops.join_ring as jops
import flink_tpu.runtime.device_join_operator as jdjo
import flink_tpu.runtime.executor as jex
import flink_tpu.runtime.stream_join_operator as jsjo
import flink_tpu.table.changelog as jcl
import flink_tpu.table.table_env as jte
import flink_tpu.utils.arrays as jarr

import flink_tpu_torch.api.datastream as tds
import flink_tpu_torch.api.windowing.assigners as tasg
import flink_tpu_torch.config as tcfg
import flink_tpu_torch.core.watermarks as twm
import flink_tpu_torch.graph.transformation as ttr
import flink_tpu_torch.joins.pipeline as tpipe
import flink_tpu_torch.joins.ring as tring
import flink_tpu_torch.joins.spec as tspec
import flink_tpu_torch.ops.join_ring as tops
import flink_tpu_torch.runtime.device_join_operator as tdjo
import flink_tpu_torch.runtime.executor as tex
import flink_tpu_torch.runtime.stream_join_operator as tsjo
import flink_tpu_torch.table.changelog as tcl
import flink_tpu_torch.table.table_env as tte
import flink_tpu_torch.utils.arrays as tarr

PK = {
    "jax": types.SimpleNamespace(
        ds=jds, asg=jasg, cfg=jcfg, wm=jwm, tr=jtr, pipe=jpipe, ring=jring, spec=jspec,
        djo=jdjo, ex=jex, sjo=jsjo, cl=jcl, te=jte, arr=jarr, kw={},
        plan=lambda env: jtr.plan(env._sinks + env._roots),
        runtime=lambda graph, config: jex.JobRuntime(graph, config),
        runners=lambda graph, config: jex.build_runners(graph, config)[0],
        new_ring=lambda geom: jring.BucketRing(geom),
        new_pipe=lambda geom: jpipe.FusedJoinPipeline(geom)),
    "port": types.SimpleNamespace(
        ds=tds, asg=tasg, cfg=tcfg, wm=twm, tr=ttr, pipe=tpipe, ring=tring, spec=tspec,
        djo=tdjo, ex=tex, sjo=tsjo, cl=tcl, te=tte, arr=tarr, kw={"device": "cpu"},
        plan=lambda env: ttr.plan(env._sinks),
        runtime=lambda graph, config: tex.JobRuntime(graph, config, "cpu"),
        runners=lambda graph, config: tex.build_runners(graph, config, "cpu")[0],
        new_ring=lambda geom: tring.BucketRing(geom, "cpu"),
        new_pipe=lambda geom: tpipe.FusedJoinPipeline(geom, "cpu")),
}
BOTH = ("jax", "port")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_arrays(a, b, what=""):
    a, b = _np(a), _np(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype, a.shape, b.shape)
    assert np.array_equal(a, b), what


# ---------------------------------------------------------------------------
# the device programs (ROADMAP B5)
# ---------------------------------------------------------------------------

def _pad(a, m):
    out = np.empty(m, dtype=np.int32)
    out[:len(a)] = a
    out[len(a):] = a[-1]
    return out


@pytest.mark.parametrize("seed", range(4))
def test_join_ingest_matches_jax(seed):
    rng = np.random.default_rng(seed)
    NB, K = int(rng.integers(2, 9)), int(rng.integers(1, 65))
    C = int(rng.choice([1, 2, 4, 8, 16]))
    n = int(rng.integers(1, min(NB * K * C, 300) + 1))
    # unique (bucket, key, slot) coordinates, as the host plans them
    rb, rem = np.divmod(rng.choice(NB * K * C, n, replace=False), K * C)
    kid, slot = np.divmod(rem, C)
    m = tring._pad_len(n)
    lanes = [_pad(a, m) for a in (rb, kid, slot, rng.integers(0, 2**31 - 1, n),
                                  rng.integers(-2**31, 2**31 - 1, n))]
    idx0 = rng.integers(-50, 50, (NB, K, C)).astype(np.int32)
    ts0 = rng.integers(-50, 50, (NB, K, C)).astype(np.int32)
    j = jops.build_join_ingest(NB, K, C)(jnp.asarray(idx0), jnp.asarray(ts0),
                                         *(jnp.asarray(a) for a in lanes))
    tops.reset_call_counts()
    t = tops.build_join_ingest(NB, K, C)(torch.from_numpy(idx0.copy()), torch.from_numpy(ts0.copy()),
                                         *(torch.from_numpy(a) for a in lanes))
    assert tops.CALLS["join_ingest"] == 1
    for a, b, what in zip(j, t, ("idx", "ts")):
        _same_arrays(a, b, what)
    assert tops.build_join_ingest(NB, K, C) is tops.build_join_ingest(NB, K, C)


@pytest.mark.parametrize("interval", [False, True], ids=["window", "interval"])
@pytest.mark.parametrize("seed", range(4))
def test_join_match_matches_jax(seed, interval):
    rng = np.random.default_rng(100 + seed)
    NB, K = int(rng.integers(3, 9)), int(rng.integers(1, 65))
    C = int(rng.choice([1, 2, 4, 8, 16]))
    n_lb = int(rng.integers(1, NB + 1))
    n_rb = int(rng.integers(1, NB + 1))
    arrs = [rng.integers(-1000, 1000, (NB, K, C)).astype(np.int32) for _ in range(4)]
    cnt_l = rng.integers(0, C + 1, (n_lb, K)).astype(np.int32)
    cnt_r = rng.integers(0, C + 1, (n_rb, K)).astype(np.int32)
    rbs_l = rng.choice(NB, n_lb, replace=False).astype(np.int32)
    rbs_r = rng.choice(NB, n_rb, replace=False).astype(np.int32)
    lo, hi = sorted(int(x) for x in rng.integers(-800, 800, 2))
    args = (arrs[0], arrs[1], cnt_l, rbs_l, arrs[2], arrs[3], cnt_r, rbs_r)
    j = jops.build_join_match(NB, K, C, n_lb, n_rb, interval)(
        *(jnp.asarray(a) for a in args), np.int32(lo), np.int32(hi))
    tops.reset_call_counts()
    t = tops.build_join_match(NB, K, C, n_lb, n_rb, interval)(
        *(torch.from_numpy(a) for a in args), lo, hi)
    assert tops.CALLS["join_match_interval" if interval else "join_match"] == 1
    assert len(j) == len(t) == (8 if interval else 7)
    for i, (a, b) in enumerate(zip(j, t)):
        _same_arrays(a, b, f"output {i}")


@pytest.mark.parametrize("seed", range(3))
def test_expand_pairs_matches_jax(seed):
    rng = np.random.default_rng(200 + seed)
    K, L, R = 17, 12, 8
    lanes = (rng.integers(0, 1000, (K, L)).astype(np.int32), rng.random((K, L)) < 0.4,
             rng.integers(0, 1000, (K, R)).astype(np.int32), rng.random((K, R)) < 0.3)
    for a, b in zip(jpipe.expand_pairs(*lanes), tpipe.expand_pairs(*lanes)):
        _same_arrays(a, b)
    assert len(tpipe.expand_pairs(*lanes)[0]) > 0


# ---------------------------------------------------------------------------
# BucketRing and FusedJoinPipeline
# ---------------------------------------------------------------------------

def _geoms(size, slide, **kw):
    return {p: PK[p].spec.plan_join_geometry(size, slide, 0, **kw) for p in BOTH}


def _ring_state(r):
    return (r.cnt.tolist(), r.bucket_at.tolist(), _np(r.idx_arr).tolist(),
            _np(r.ts_arr).tolist(), r.snapshot(), r.live_records(), r.occupancy(),
            r.occupied_buckets(), r.state_bytes())


def _try(fn):
    try:
        fn()
        return None
    except (jspec.JoinUnsupported, tspec.JoinUnsupported) as e:
        return (e.reason, getattr(e, "overflow", None), getattr(e, "required", None))


def test_bucket_ring_matches_jax():
    rng = np.random.default_rng(7)
    geoms = _geoms(1000, 500, key_capacity=16, bucket_capacity=4, ring_slack_buckets=3)
    rings = {p: PK[p].new_ring(geoms[p]) for p in BOTH}
    errors, t0 = [], 0
    for step in range(30):
        n = int(rng.integers(1, 12))
        kids = rng.integers(0, 16 if step % 7 else 2, n)
        ts = t0 + rng.integers(0, 900 if step % 11 else 6000, n)
        rows = [(int(k), f"r{step}.{i}") for i, k in enumerate(kids)]
        got = [_try(lambda r=rings[p]: r.ingest(kids, ts, rows, 0)) for p in BOTH]
        assert got[0] == got[1]
        errors.append(got[0])
        assert _ring_state(rings["jax"]) == _ring_state(rings["port"])
        if step % 4 == 3:
            t0 += 500
            for r in rings.values():
                r.purge_below(t0 // 500 - 1)
            assert _ring_state(rings["jax"]) == _ring_state(rings["port"])
    # every refusal kind happened: slots (with the slots needed) and wrap
    kinds = {e[1] for e in errors if e}
    assert kinds == {"slots", "wrap"} and None in errors
    rb, cnt = rings["port"].run_counts(np.arange(10, 20))
    jrb, jcnt = rings["jax"].run_counts(np.arange(10, 20))
    _same_arrays(rb, jrb)
    _same_arrays(cnt, jcnt)
    # restore re-ingests: a JAX snapshot on the port and the reverse
    snaps = {p: rings[p].snapshot() for p in BOTH}
    fresh = {p: PK[p].new_ring(geoms[p]) for p in BOTH}
    fresh["port"].restore(snaps["jax"], 0)
    fresh["jax"].restore(snaps["port"], 0)
    assert _ring_state(fresh["jax"]) == _ring_state(fresh["port"])
    assert fresh["port"].snapshot() == snaps["jax"] == snaps["port"]


def _pipe_fires(p, pipe, windows, intervals):
    out = []
    for start, end in windows:
        out.append([a.tolist() for a in pipe.fire_window(start, end)])
    for lb, rb, lo, hi in intervals:
        out.append([a.tolist() for a in pipe.match_interval(lb, rb, lo, hi)])
    return out


def test_join_pipeline_matches_jax():
    """Fire order and pairs, interval matches, regrow, purge, snapshot and
    restore across the packages."""
    rng = np.random.default_rng(11)
    geoms = _geoms(1000, 250, key_capacity=32, bucket_capacity=8)
    pipes = {p: PK[p].new_pipe(geoms[p]) for p in BOTH}
    for step in range(12):
        for side in (0, 1):
            n = int(rng.integers(5, 40))
            kids = rng.integers(0, 32, n)
            ts = 5000 + step * 250 + rng.integers(0, 250, n)
            rows = [(side, step, i) for i in range(n)]
            for pipe in pipes.values():
                pipe.ingest(side, kids, ts, rows)
    windows = [(5000 + 250 * i, 6000 + 250 * i) for i in range(-3, 12)]
    intervals = [(np.arange(20, 24), np.arange(21, 26), -300, 400),
                 (np.arange(24, 28), np.arange(22, 25), 0, 0)]
    fires = {p: _pipe_fires(p, pipes[p], windows, intervals) for p in BOTH}
    assert fires["jax"] == fires["port"]
    assert sum(len(f[0]) for f in fires["port"]) > 0
    assert {p: (pipes[p].occupancy(), pipes[p].occupied_buckets(), pipes[p].state_bytes())
            for p in BOTH}["jax"] == (pipes["port"].occupancy(), pipes["port"].occupied_buckets(),
                                      pipes["port"].state_bytes())
    # regrow to more keys and slots, then purge: same fires again
    import dataclasses

    for p in BOTH:
        pipes[p].regrow(dataclasses.replace(pipes[p].geom, key_capacity=64, bucket_capacity=16))
        pipes[p].purge_below_window(6500)
    fires = {p: _pipe_fires(p, pipes[p], windows, intervals) for p in BOTH}
    assert fires["jax"] == fires["port"]
    assert pipes["port"].state_bytes() == 2 * 2 * 4 * pipes["port"].geom.ring_buckets * 64 * 16
    # snapshots equal; each restores into the other package's pipeline
    snaps = {p: pipes[p].snapshot() for p in BOTH}
    assert snaps["jax"] == snaps["port"]
    cross = {"port": PK["port"].new_pipe(pipes["port"].geom),
             "jax": PK["jax"].new_pipe(pipes["jax"].geom)}
    cross["port"].restore(snaps["jax"])
    cross["jax"].restore(snaps["port"])
    # a restore re-ingests (fresh row ids), so the crossed pipelines fire
    # alike, and the same rows as before
    crossed = {p: _pipe_fires(p, cross[p], windows, intervals) for p in BOTH}
    assert crossed["jax"] == crossed["port"]
    for p in BOTH:
        assert [len(f[0]) for f in crossed[p]] == [len(f[0]) for f in fires[p]]


class _Past2e31(list):
    """A ring's row store that has already handed out 2**31 - 1 row ids."""

    def __len__(self):
        return 2**31 - 1 + super().__len__()


def test_row_ids_past_int32_fail_the_ring_in_both_packages():
    """ROADMAP Queue C (a reference fault, reproduced): a ring's row ids
    are never recycled (purged rows stay as None in the row store) and are
    staged into int32 lanes, so the batch that hands out row id 2**31
    raises OverflowError from the lane padding, after the host mirror took
    the batch. Flink has no such bound. Row id 2**31 - 1 still lands."""
    for p in BOTH:
        geom = PK[p].spec.plan_join_geometry(1000, 1000, 0, key_capacity=4, bucket_capacity=4)
        pipe = PK[p].new_pipe(geom)
        pipe.left._rows = _Past2e31()
        pipe.ingest(0, np.array([0]), np.array([100]), ["l0"])
        assert int(_np(pipe.left.idx_arr)[0, 0, 0]) == 2**31 - 1
        with pytest.raises(OverflowError):
            pipe.ingest(0, np.array([0]), np.array([200]), ["l1"])
        assert pipe.left.occupancy() == 2          # the mirror took it


# ---------------------------------------------------------------------------
# jobs: tests/test_device_join.py's helpers in either package
# ---------------------------------------------------------------------------

def _env(P, batch=16, device=True, **extra):
    conf = P.cfg.Configuration()
    conf.set(P.cfg.ExecutionOptions.BATCH_SIZE, batch)
    conf.set(P.cfg.ExecutionOptions.DEVICE_JOINS, device)
    for opt, val in extra.items():
        conf.set(getattr(P.cfg.ExecutionOptions, opt), val)
    return P.ds.StreamExecutionEnvironment(conf, **P.kw)


def _stream(P, env, pairs, out_of_order=0):
    values = [p[0] for p in pairs]
    ts_map = {i: p[1] for i, p in enumerate(pairs)}
    strategy = (P.wm.WatermarkStrategy.for_bounded_out_of_orderness(out_of_order)
                if out_of_order else P.wm.WatermarkStrategy.for_monotonous_timestamps())
    s = env.from_collection(list(enumerate(values)), timestamp_fn=lambda iv: ts_map[iv[0]],
                            watermark_strategy=strategy)
    return s.map(lambda iv: iv[1], name="unwrap")


def _join_job(P, env, left, right, assigner, out_of_order=0, cogroup=False):
    a = _stream(P, env, left, out_of_order)
    b = _stream(P, env, right, out_of_order)
    if cogroup:
        return (a.co_group(b).where(lambda v: v[0]).equal_to(lambda v: v[0])
                .window(assigner)
                .apply(lambda ls, rs: (sorted(ls), sorted(rs))).collect())
    return (a.join(b).where(lambda v: v[0]).equal_to(lambda v: v[0])
            .window(assigner).apply(lambda l, r: (l[0], l[1], r[1])).collect())


def _run(P, env, sink):
    """Execute through JobRuntime so the runners stay inspectable; the
    rows in emission order."""
    rt = P.runtime(P.plan(env), env.config)
    rt.run()
    return list(sink.results), rt


def _one(rt, cls):
    (r,) = [r for r in rt.runners if isinstance(r, cls)]
    return r


def _runner_state(r):
    return (r.fallback_reason, r.num_late_dropped, r.matches_emitted,
            r.geom.key_capacity, r.geom.bucket_capacity, r._host is None)


def _parity(P, left, right, assigner_of, out_of_order=0, **extra):
    """The same join on the device and the host leg of package P: (rows in
    emission order, device runner, host runner); the sorted rows equal."""
    envd = _env(P, **extra)
    got, rtd = _run(P, envd, _join_job(P, envd, left, right, assigner_of(P.asg), out_of_order))
    envh = _env(P, device=False, **extra)
    exp, rth = _run(P, envh, _join_job(P, envh, left, right, assigner_of(P.asg), out_of_order))
    host = _one(rth, P.ex.WindowJoinRunner)
    dev = _one(rtd, P.djo.DeviceJoinRunner)
    assert sorted(got) == sorted(exp), (len(got), len(exp))
    return got, dev, host


def _twin(left, right, assigner_of, out_of_order=0, **extra):
    """_parity in both packages: the device legs' rows in order and the
    runners' state equal. Returns the port's (rows, dev, host)."""
    out = {p: _parity(PK[p], left, right, assigner_of, out_of_order, **extra) for p in BOTH}
    assert out["jax"][0] == out["port"][0]
    assert _runner_state(out["jax"][1]) == _runner_state(out["port"][1])
    assert out["jax"][2].num_late_dropped == out["port"][2].num_late_dropped
    return out["port"]


def TUMBLE(ms):
    return lambda asg: asg.TumblingEventTimeWindows.of(ms)


def SLIDE(size, slide):
    return lambda asg: asg.SlidingEventTimeWindows.of(size, slide)


# ---------------------------------------------------------------------------
# twins of tests/test_device_join.py: parity, adaptive geometry, degrade
# ---------------------------------------------------------------------------

def test_tumbling_parity_multi_key_multi_window():
    left = [((f"k{i % 5}", i), i * 137 % 4000) for i in range(200)]
    right = [((f"k{i % 5}", -i), i * 211 % 4000) for i in range(150)]
    rows, dev, _ = _twin(left, right, TUMBLE(1000))
    assert rows and dev._host is None and dev.fallback_reason is None
    assert dev.matches_emitted == len(rows)


def test_sliding_parity_overlapping_windows():
    left = [((f"k{i % 3}", i), i * 100) for i in range(60)]
    right = [((f"k{i % 3}", i + 1000), i * 100 + 7) for i in range(60)]
    rows, dev, _ = _twin(left, right, SLIDE(2000, 500))
    assert rows and dev._host is None


def test_out_of_order_parity_counts_late_drops_like_the_host():
    rng = np.random.RandomState(7)
    ts_l = rng.permutation(80) * 100
    ts_r = rng.permutation(80) * 100 + 3
    left = [((f"k{i % 4}", i), int(ts_l[i])) for i in range(80)]
    right = [((f"k{i % 4}", -i), int(ts_r[i])) for i in range(80)]
    rows, dev, host = _twin(left, right, SLIDE(1000, 500), out_of_order=300)
    assert dev.num_late_dropped == host.num_late_dropped > 0


def test_bucket_capacity_grows_past_initial_without_degrade():
    left = [(("hot", i), 100 + i % 7) for i in range(50)]
    right = [(("hot", -i), 200 + i % 5) for i in range(40)]
    rows, dev, _ = _twin(left, right, TUMBLE(1000))
    assert len(rows) == 50 * 40
    assert dev._host is None, dev.fallback_reason
    assert dev.geom.bucket_capacity > 16


def test_key_capacity_grows_past_initial_without_degrade():
    n = 1500
    left = [((i, "l"), (i % 8) * 100) for i in range(n)]
    right = [((i, "r"), (i % 8) * 100 + 1) for i in range(n)]
    rows, dev, _ = _twin(left, right, TUMBLE(1000), batch=256)
    assert len(rows) == n
    assert dev._host is None
    assert dev.geom.key_capacity == 2048


def test_key_capacity_degrade_keeps_parity_and_attributes():
    got, dev, _ = _twin([((i, "l"), 100) for i in range(40)],
                        [((i, "r"), 200) for i in range(40)],
                        TUMBLE(1000), KEY_CAPACITY=16)
    assert len(got) == 40
    assert dev._host is not None
    assert dev.fallback_reason == "join-key-capacity"
    assert tspec.fallback_code(dev.fallback_reason) \
        == tspec.JOIN_FALLBACK_CODES["join-key-capacity"] > 0


def test_slot_overflow_at_cap_degrades_with_parity():
    left = [(("hot", i), 100) for i in range(30)]
    right = [(("hot", -i), 150) for i in range(10)]
    got, dev, _ = _twin(left, right, TUMBLE(1000), JOIN_BUCKET_CAPACITY=8)
    assert len(got) == 300
    assert dev._host is not None
    assert dev.fallback_reason == "join-ring-overflow"


def test_ring_wrap_degrades_with_parity():
    left = [(("a", 1), 100), (("a", 2), 100 + 2 * 1000)]
    right = [(("a", 10), 150), (("a", 20), 150 + 2 * 1000)]
    got, dev, _ = _twin(left, right, TUMBLE(1000), out_of_order=4000, JOIN_RING_SLACK=1,
                        batch=1)
    assert len(got) == 2
    assert dev._host is not None
    assert dev.fallback_reason == "join-ring-overflow"


def test_mid_stream_degrade_replays_ring_exactly_once():
    left = ([((f"e{i}", i), 100 + i) for i in range(6)]
            + [((f"x{i}", i), 2100 + i) for i in range(20)])
    right = ([((f"e{i}", -i), 500 + i) for i in range(6)]
             + [((f"x{i}", -i), 2500 + i) for i in range(20)])
    got, dev, _ = _twin(left, right, TUMBLE(1000), KEY_CAPACITY=8, batch=4)
    assert len(got) == 26
    assert dev.fallback_reason == "join-key-capacity"


@pytest.mark.parametrize("window", ["tumbling", "sliding"])
@pytest.mark.parametrize("skew", ["uniform", "hot"])
def test_device_join_rows_in_order_match_jax(window, skew):
    """Seeded random streams (disordered, a few late records): the device
    route's rows in emission order equal the JAX device route's, and as a
    multiset the host route's."""
    rng = np.random.default_rng(hash((window, skew)) % 2**32)
    n = 300
    keys = (rng.integers(0, 40, 2 * n) if skew == "uniform"
            else np.minimum(rng.geometric(0.3, 2 * n), 40))
    ts = np.sort(rng.integers(0, 8000, 2 * n)) + rng.integers(-300, 300, 2 * n)
    left = [((int(k), i), int(t)) for i, (k, t) in enumerate(zip(keys[:n], ts[:n]))]
    right = [((int(k), -i), int(t)) for i, (k, t) in enumerate(zip(keys[n:], ts[n:]))]
    asg = TUMBLE(1000) if window == "tumbling" else SLIDE(1500, 500)
    rows, dev, host = _twin(left, right, asg, out_of_order=200, batch=32)
    assert rows and dev._host is None
    assert dev.num_late_dropped == host.num_late_dropped


def test_cogroup_and_refusals_take_the_host_runner_like_jax():
    """coGroup, processing time, session windows and device joins off build
    the host runner in both packages; the DeviceJoinRunner refuses each
    with the JAX package's catalogued reason; the coGroup rows match."""
    left = [((f"k{i % 3}", i), i * 90) for i in range(40)]
    right = [((f"k{i % 4}", -i), i * 70) for i in range(40)]
    rows = {}
    for p in BOTH:
        P = PK[p]
        env = _env(P)
        sink = _join_job(P, env, left, right, P.asg.TumblingEventTimeWindows.of(1000),
                         cogroup=True)
        got, rt = _run(P, env, sink)
        assert _one(rt, P.ex.WindowJoinRunner).cogroup
        rows[p] = got
    assert rows["jax"] == rows["port"] and rows["port"]

    def refusal(P, make_asg, cogroup=False, device=True):
        env = _env(P, device=device)
        _join_job(P, env, left, right, make_asg(P.asg), cogroup=cogroup)
        graph = P.plan(env)
        step = next(s for s in graph.steps if s.terminal is not None
                    and s.terminal.kind in ("window_join", "co_group"))
        try:
            kinds = [type(r).__name__ for r in P.runners(graph, env.config)]
        except ValueError as e:      # the host runner refuses processing time
            kinds = str(e)
        try:
            (P.djo.DeviceJoinRunner(step, env.config, "cpu") if P is PK["port"]
             else P.djo.DeviceJoinRunner(step, env.config))
            reason = None
        except (jspec.JoinUnsupported, tspec.JoinUnsupported) as e:
            reason = e.reason
        return reason, kinds

    cases = {
        "cogroup": dict(make_asg=TUMBLE(1000), cogroup=True),
        "disabled": dict(make_asg=TUMBLE(1000), device=False),
        "processing": dict(make_asg=lambda a: a.TumblingProcessingTimeWindows(1000)),
        "session": dict(make_asg=lambda a: a.EventTimeSessionWindows.with_gap(500)),
    }
    got = {name: [refusal(PK[p], **kw) for p in BOTH] for name, kw in cases.items()}
    for name, (j, t) in got.items():
        assert j == t, name
    assert {name: v[1][0] for name, v in got.items()} == {
        "cogroup": "join-cogroup", "disabled": "join-device-disabled",
        "processing": "join-processing-time", "session": "join-session-window"}
    assert got["processing"][1][1] == "window joins support event-time assigners"
    assert "WindowJoinRunner" in got["session"][1][1]


# ---------------------------------------------------------------------------
# twins: snapshot / restore in both modes, across the packages
# ---------------------------------------------------------------------------

def _fresh_runner(P, **extra):
    env = _env(P, **extra)
    _join_job(P, env, [(("k", 1), 100)], [(("k", 2), 200)], P.asg.TumblingEventTimeWindows.of(1000))
    graph = P.plan(env)
    return _one(types.SimpleNamespace(runners=P.runners(graph, env.config)), P.djo.DeviceJoinRunner)


class _Capture:
    """Downstream double recording batches, watermarks and end."""

    def __init__(self):
        self.rows, self.watermarks, self.ended = [], [], False

    def on_batch(self, values, ts):
        self.rows.extend(list(values))

    def on_watermark(self, wm):
        self.watermarks.append(wm)

    def on_end(self):
        self.ended = True


def test_snapshot_restore_roundtrip_device_mode():
    snaps, runners = {}, {}
    for p in BOTH:
        P = PK[p]
        r = _fresh_runner(P)
        r.downstream = None
        r.on_batch_n(0, P.arr.obj_array([("a", i) for i in range(20)]),
                     np.arange(20, dtype=np.int64) * 50)
        r.on_batch_n(1, P.arr.obj_array([("a", -i) for i in range(10)]),
                     np.arange(10, dtype=np.int64) * 50 + 5)
        snaps[p], runners[p] = r.snapshot(), r
        assert snaps[p]["mode"] == "device"
    assert snaps["jax"] == snaps["port"]
    outs = []
    # each restores the OTHER package's snapshot and fires what the
    # original fires
    for p, other in (("jax", "port"), ("port", "jax")):
        r2 = _fresh_runner(PK[p])
        r2.restore(snaps[other])
        assert r2.pipeline.occupancy() == runners[p].pipeline.occupancy()
        assert r2._keys == runners[p]._keys
        for runner in (runners[p], r2):
            runner.downstream = _Capture()
            runner.on_watermark(10_000)
            outs.append(sorted(runner.downstream.rows))
    assert all(o == outs[0] for o in outs) and len(outs[0]) == 200


def test_snapshot_restore_preserves_grown_geometry():
    snaps = {}
    for p in BOTH:
        P = PK[p]
        r = _fresh_runner(P)
        r.downstream = None
        r.on_batch_n(0, P.arr.obj_array([("hot", i) for i in range(30)]),
                     np.full(30, 100, dtype=np.int64))
        assert r.geom.bucket_capacity > 16
        snaps[p] = r.snapshot()
    assert snaps["jax"] == snaps["port"]
    r2 = _fresh_runner(PK["port"])
    r2.restore(snaps["jax"])
    assert r2.geom.bucket_capacity == snaps["jax"]["geom"][1]
    assert r2.pipeline.occupancy() == 30 and r2.occupancy() == 30
    assert r2.state_bytes() == r2.pipeline.state_bytes() > 0


def test_snapshot_restore_host_mode_carries_fallback():
    snaps = {}
    for p in BOTH:
        P = PK[p]
        r = _fresh_runner(P, KEY_CAPACITY=4)
        r.downstream = None
        r.on_batch_n(0, P.arr.obj_array([(f"k{i}", i) for i in range(10)]),
                     np.full(10, 100, dtype=np.int64))
        assert r._host is not None
        snaps[p] = r.snapshot()
        assert snaps[p]["mode"] == "host"
    assert snaps["jax"] == snaps["port"]
    r2 = _fresh_runner(PK["port"], KEY_CAPACITY=4)
    r2.downstream = None
    r2.restore(snaps["jax"])
    assert r2._host is not None
    assert r2.fallback_reason == "join-key-capacity"
    assert r2.pipeline is None and r2.occupancy() == 0 and r2.state_bytes() == 0


def _flatten_snaps(obj):
    if isinstance(obj, dict):
        yield obj
        for v in obj.values():
            yield from _flatten_snaps(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _flatten_snaps(v)


class _OneShot:
    def __init__(self, rt_ref):
        self.rt_ref, self.snap = rt_ref, None

    def register_on_complete(self, fn):
        pass

    def unregister_on_complete(self, fn):
        pass

    def maybe_trigger(self, capture):
        if self.snap is None and self.rt_ref[0].records_in >= 40:
            self.snap = capture()
            raise KeyboardInterrupt


def test_checkpointed_join_restores_through_job_runtime():
    """Capture mid-stream while the join is in device mode in either
    package, restore into a fresh runtime of the OTHER package, finish:
    the rows equal an undisturbed run's."""

    def build(P):
        env = _env(P, batch=8)
        left = [((f"k{i % 3}", i), i * 100) for i in range(60)]
        right = [((f"k{i % 3}", -i), i * 100 + 3) for i in range(60)]
        return env, _join_job(P, env, left, right, P.asg.SlidingEventTimeWindows.of(1000, 500))

    expected, snaps = {}, {}
    for p in BOTH:
        P = PK[p]
        env, sink = build(P)
        rows, rt = _run(P, env, sink)
        assert _one(rt, P.djo.DeviceJoinRunner)._host is None
        expected[p] = sorted(rows)
        env2, _sink = build(P)
        ref = [None]
        ref[0] = rt2 = P.runtime(P.plan(env2), env2.config)
        shot = _OneShot(ref)
        with pytest.raises(KeyboardInterrupt):
            rt2.run(coordinator=shot)
        assert any(s.get("mode") == "device" for s in _flatten_snaps(shot.snap))
        snaps[p] = shot.snap
    assert expected["jax"] == expected["port"] and expected["port"]
    for p, other in (("port", "jax"), ("jax", "port")):
        P = PK[p]
        env3, sink3 = build(P)
        rt3 = P.runtime(P.plan(env3), env3.config)
        rt3.restore(snaps[other])
        rt3.run()
        assert _one(rt3, P.djo.DeviceJoinRunner)._host is None
        assert sorted(sink3.results) == expected[other]


# ---------------------------------------------------------------------------
# twins: the SQL front door
# ---------------------------------------------------------------------------

def _sql_env(P, device=True):
    conf = P.cfg.Configuration()
    conf.set(P.cfg.ExecutionOptions.BATCH_SIZE, 16)
    conf.set(P.cfg.ExecutionOptions.DEVICE_JOINS, device)
    env = P.ds.StreamExecutionEnvironment(conf, **P.kw)
    tenv = P.te.TableEnvironment(env)
    orders = [{"user": f"u{i % 3}", "amount": float(i), "rowtime": i * 100} for i in range(10)]
    users = [{"user": f"u{i}", "city": f"city{i}", "ts": i * 100} for i in range(3)]
    tenv.from_rows("orders", orders, P.te.TableSchema(["user", "amount", "rowtime"],
                                                      rowtime="rowtime"))
    tenv.from_rows("users", users, P.te.TableSchema(["user", "city", "ts"], rowtime="ts"))
    return env, tenv


_SQL_JOIN = ("SELECT a.user, b.city, a.amount FROM orders AS a "
             "JOIN users AS b ON a.user = b.user "
             "WHERE a.amount > 1 WINDOW TUMBLE(INTERVAL '10' SECOND)")


def _norm(rows):
    return sorted(tuple(sorted(r.items())) for r in rows)


def _report(r):
    return (r.path, r.reason, r.detail, r.describe())


def test_sql_window_join_selects_fused_runner_with_fused_explain():
    reports = {}
    for p in BOTH:
        P = PK[p]
        env, tenv = _sql_env(P)
        report = tenv.explain_sql(_SQL_JOIN)
        assert report.fused
        assert "device=join-ring" in report.describe()
        reports[p] = _report(report)
        tenv.sql_query(_SQL_JOIN).collect()
        assert tenv.last_plan_report.fused
        djr = [r for r in P.runners(P.plan(env), env.config)
               if isinstance(r, P.djo.DeviceJoinRunner)]
        assert djr and djr[0].sql_origin
    assert reports["jax"] == reports["port"]


def test_sql_window_join_parity_device_vs_interpreted():
    rows = {}
    for p in BOTH:
        P = PK[p]
        for device in (True, False):
            env, tenv = _sql_env(P, device)
            sink = tenv.sql_query(_SQL_JOIN).collect()
            env.execute("join")
            rows[p, device] = sink.results
    assert rows["port", True] == rows["jax", True] and rows["port", True]
    assert _norm(rows["port", True]) == _norm(rows["port", False]) == _norm(rows["jax", False])


def test_sql_full_outer_join_attributed_not_crashed():
    sql = ("SELECT a.user, b.city FROM orders AS a FULL OUTER JOIN users "
           "AS b ON a.user = b.user")
    for p in BOTH:
        _env_, tenv = _sql_env(PK[p])
        report = tenv.explain_sql(sql)
        assert report.path == "interpreted"
        assert report.reason == "join-full-outer"
        with pytest.raises((jspec.JoinUnsupported, tspec.JoinUnsupported)) as ei:
            tenv.sql_query(sql)
        assert ei.value.reason == "join-full-outer"
        assert type(ei.value) is PK[p].spec.JoinUnsupported


def test_sql_regular_join_attributed_unwindowed():
    sql = "SELECT a.user, b.city FROM orders AS a JOIN users AS b ON a.user = b.user"
    out = {}
    for p in BOTH:
        _env_, tenv = _sql_env(PK[p])
        report = tenv.explain_sql(sql)
        assert report.path == "interpreted"
        assert report.reason == "join-unwindowed"
        out[p] = tenv.execute_sql_to_list(sql)
        assert len(out[p]) == 10
    assert out["jax"] == out["port"]


_REGULAR = {
    "inner": "SELECT a.user, b.city, a.amount FROM orders AS a JOIN users AS b ON a.user = b.user",
    "left": ("SELECT a.user, b.city, a.amount FROM orders AS a LEFT JOIN users AS b "
             "ON a.user = b.user"),
    "right": ("SELECT a.user, b.city, a.amount FROM orders AS a RIGHT OUTER JOIN users AS b "
              "ON a.user = b.user"),
}


@pytest.mark.parametrize("kind", sorted(_REGULAR))
def test_regular_sql_joins_changelog_matches_jax(kind):
    """Regular inner and outer joins on the StreamingJoinRunner: the raw
    changelog (kinds, order) and its materialized rows equal the JAX
    package's, with users who never order and orders of unknown users."""
    logs, mats = {}, {}
    for p in BOTH:
        P = PK[p]
        env = P.ds.StreamExecutionEnvironment(P.cfg.Configuration({"execution.step.batch-size": 4}),
                                              **P.kw)
        tenv = P.te.TableEnvironment(env)
        tenv.from_rows("orders", [{"user": f"u{i % 8}", "amount": float(i), "rowtime": i * 10}
                                  for i in range(23)],
                       P.te.TableSchema(["user", "amount", "rowtime"], rowtime="rowtime"))
        tenv.from_rows("users", [{"user": f"u{i}", "city": f"c{i}", "ts": 5 + i * 40}
                                 for i in (1, 2, 3, 6, 7)],
                       P.te.TableSchema(["user", "city", "ts"], rowtime="ts"))
        logs[p] = tenv.execute_sql_to_changelog(_REGULAR[kind])
        mats[p] = P.cl.materialize(logs[p])
        runners = P.runners(P.plan(env), env.config)
        assert any(isinstance(r, P.sjo.StreamingJoinRunner) for r in runners)
    assert logs["jax"] == logs["port"] and mats["jax"] == mats["port"]
    if kind != "inner":
        assert any(r[tcl.ROW_KIND_FIELD] == tcl.DELETE for r in logs["port"])


@pytest.mark.parametrize("sql,msg", [
    ("SELECT a.user, COUNT(*) AS n FROM orders AS a JOIN users AS b ON a.user = b.user "
     "GROUP BY a.user", "GROUP BY on a join"),
    ("SELECT COUNT(*) AS n FROM orders AS a JOIN users AS b ON a.user = b.user "
     "WINDOW TUMBLE(INTERVAL '1' SECOND)", "aggregates over a join"),
    ("SELECT a.user FROM orders AS a JOIN users AS b ON a.user = b.user "
     "WINDOW SESSION(INTERVAL '1' SECOND)", "session windows"),
    ("SELECT a.user FROM orders AS a JOIN nope AS b ON a.user = b.user", "unknown table"),
])
def test_sql_join_refusals_match_jax(sql, msg):
    errs = []
    for p in BOTH:
        _env_, tenv = _sql_env(PK[p])
        with pytest.raises((ValueError, KeyError)) as ei:
            tenv.sql_query(sql)
        errs.append((type(ei.value).__name__, str(ei.value)))
    assert errs[0] == errs[1] and msg in errs[1][1]


# ---------------------------------------------------------------------------
# twins of tests/test_stream_join_oracle.py: the regular-join oracle
# ---------------------------------------------------------------------------

def _sj_runner(P, join_type="inner"):
    t = P.tr.Transformation("regular_join", "join", [], config={
        "key_selector1": lambda r: r.get("k"),
        "key_selector2": lambda r: r.get("k"),
        "merge_fn": lambda a, b: {**a, **{"r": b.get("r")}},
        "join_type": join_type,
        "null_rows": ({"k": None, "v": None}, {"k": None, "r": None}),
    })
    step = P.tr.Step(chain=[], terminal=t, partitioning="forward")
    r = P.sjo.StreamingJoinRunner(step, P.cfg.Configuration())
    r.downstream = _Capture()
    return r


def _feed(P, runner, ordinal, rows, ts=0):
    runner.on_batch_n(ordinal, P.arr.obj_array(rows), np.full(len(rows), ts, dtype=np.int64))


def _kinds(runner):
    return [row[tcl.ROW_KIND_FIELD] for row in runner.downstream.rows]


def _sj_both(script, join_type="inner"):
    """Run script(P, runner) in both packages; the emitted rows, watermarks,
    end flag and state of the two runners equal. Returns the port's."""
    got = {}
    for p in BOTH:
        r = _sj_runner(PK[p], join_type)
        script(PK[p], r)
        got[p] = r
    j, t = got["jax"], got["port"]
    assert j.downstream.rows == t.downstream.rows
    assert (j.downstream.watermarks, j.downstream.ended) == (t.downstream.watermarks,
                                                             t.downstream.ended)
    assert j.snapshot() == t.snapshot()
    return t


def test_duplicate_rows_keep_appearance_counts_not_presence():
    kinds = []

    def script(P, r):
        row = {"k": "a", "v": 1.0}
        _feed(P, r, 0, [row, dict(row)])
        _feed(P, r, 1, [{"k": "a", "r": "west"}])
        kinds.append(_kinds(r))
        _feed(P, r, 0, [P.cl.with_kind(dict(row), P.cl.DELETE)])
        (surviving,) = r._state[0]["a"].values()
        assert surviving[1] == 1
        _feed(P, r, 0, [P.cl.with_kind(dict(row), P.cl.DELETE)])
        assert "a" not in r._state[0]

    r = _sj_both(script)
    assert kinds[-1] == [tcl.INSERT, tcl.INSERT]
    assert _kinds(r) == [tcl.INSERT, tcl.INSERT, tcl.DELETE, tcl.DELETE]


def test_retracting_an_unbuffered_row_is_an_error():
    for p in BOTH:
        P = PK[p]
        r = _sj_runner(P)
        with pytest.raises(ValueError, match="not buffered"):
            _feed(P, r, 0, [P.cl.with_kind({"k": "ghost", "v": 0.0}, P.cl.DELETE)])


def test_insert_joins_against_full_opposite_multiset():
    def script(P, r):
        _feed(P, r, 0, [{"k": "a", "v": 1.0}] * 2)
        _feed(P, r, 1, [{"k": "a", "r": "w"}] * 3)

    assert _kinds(_sj_both(script)) == [tcl.INSERT] * 6


def test_left_outer_padding_retracts_on_first_match_and_returns_on_empty():
    def script(P, r):
        _feed(P, r, 0, [{"k": "a", "v": 1.0}])
        assert "a" in r._padded
        _feed(P, r, 1, [{"k": "a", "r": "west"}])
        assert "a" not in r._padded
        _feed(P, r, 1, [P.cl.with_kind({"k": "a", "r": "west"}, P.cl.DELETE)])
        assert "a" in r._padded

    r = _sj_both(script, "left")
    K = tcl.ROW_KIND_FIELD
    assert r.downstream.rows[0] == {"k": "a", "v": 1.0, "r": None, K: tcl.INSERT}
    assert sorted(_kinds(r)[1:3]) == sorted([tcl.INSERT, tcl.DELETE])
    assert {"k": "a", "v": 1.0, "r": "west", K: tcl.INSERT} in r.downstream.rows[1:3]
    assert sorted(_kinds(r)[3:]) == sorted([tcl.DELETE, tcl.INSERT])
    assert {"k": "a", "v": 1.0, "r": None, K: tcl.INSERT} in r.downstream.rows[3:]


def test_outer_row_retraction_retracts_its_padding():
    def script(P, r):
        _feed(P, r, 0, [{"k": "a", "v": 1.0}])
        _feed(P, r, 0, [P.cl.with_kind({"k": "a", "v": 1.0}, P.cl.DELETE)])
        assert r._padded == {} and r._state[0] == {}

    r = _sj_both(script, "left")
    assert r.downstream.rows[1] == {"k": "a", "v": 1.0, "r": None,
                                    tcl.ROW_KIND_FIELD: tcl.DELETE}


def test_watermarks_min_combine_across_both_gates():
    seen = []

    def script(P, r):
        r.on_watermark_n(0, 100)
        seen.append(list(r.downstream.watermarks))
        r.on_watermark_n(1, 50)
        r.on_watermark_n(1, 80)
        r.on_watermark_n(1, 200)
        r.on_watermark_n(0, 90)

    r = _sj_both(script)
    assert seen == [[], []]
    assert r.downstream.watermarks == [50, 80, 100]


def test_end_fires_only_after_both_gates_end():
    def script(P, r):
        r.on_end_n(0)
        assert not r.downstream.ended
        r.on_end_n(1)

    assert _sj_both(script).downstream.ended


def test_full_outer_raises_typed_catalogued_error():
    for p in BOTH:
        with pytest.raises(PK[p].spec.JoinUnsupported) as ei:
            _sj_runner(PK[p], "full")
        assert ei.value.reason == "join-full-outer"
        assert "two-sided padding retraction" in ei.value.detail


def test_unknown_join_type_still_a_value_error():
    for p in BOTH:
        with pytest.raises(ValueError, match="unsupported join type"):
            _sj_runner(PK[p], "cross")


# ---------------------------------------------------------------------------
# the valve for single-input runners, the options, the entry points
# ---------------------------------------------------------------------------

def test_single_input_runners_bypass_the_valve():
    """num_inputs 1: every watermark passes straight through (no min, no
    dedup) and every end signal ends, as before two-input runners."""
    for p in BOTH:
        r = PK[p].ex.StepRunner()
        r.downstream = _Capture()
        for wm in (5, 3, 3):
            r.on_watermark_n(0, wm)
        r.on_end_n(0)
        assert r.downstream.watermarks == [5, 3, 3] and r.downstream.ended
        assert "_gate_wms" not in r.__dict__


def test_join_options_are_the_jax_options():
    for name in ("DEVICE_JOINS", "JOIN_BUCKET_CAPACITY", "JOIN_RING_SLACK"):
        j = getattr(jcfg.ExecutionOptions, name)
        t = getattr(tcfg.ExecutionOptions, name)
        assert (t.key, t.default, t.description) == (j.key, j.default, j.description)
        assert tcfg.Configuration({t.key: t.default}).get(t) == t.default
    assert [tcfg.ExecutionOptions.DEVICE_JOINS.default,
            tcfg.ExecutionOptions.JOIN_BUCKET_CAPACITY.default,
            tcfg.ExecutionOptions.JOIN_RING_SLACK.default] == [True, 128, 64]


def test_spec_is_the_jax_spec():
    assert tspec.JOIN_FALLBACK_CATALOG == jspec.JOIN_FALLBACK_CATALOG
    assert tspec.JOIN_FALLBACK_CODES == jspec.JOIN_FALLBACK_CODES
    for args in ((1000, 1000, 0), (2000, 500, 100), (3000, 2000, 0)):
        kw = dict(key_capacity=64, bucket_capacity=16, ring_slack_buckets=5)
        j = jspec.plan_join_geometry(*args, **kw)
        t = tspec.plan_join_geometry(*args, **kw)
        assert repr(j) == repr(t)
        assert [t.window_start(x) for x in (-7, 0, 2999)] == [j.window_start(x) for x in (-7, 0, 2999)]
    with pytest.raises(ValueError):
        tspec.plan_join_geometry(0, 1, 0, key_capacity=1, bucket_capacity=1)


def test_join_entry_points_raise_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    geom = tspec.plan_join_geometry(1000, 1000, 0, key_capacity=8, bucket_capacity=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpipe.FusedJoinPipeline(geom)
    with pytest.raises(RuntimeError, match="CUDA"):
        tring.BucketRing(geom)
    env = tds.StreamExecutionEnvironment()
    _join_job(PK["port"], env, [(("k", 1), 100)], [(("k", 2), 200)],
              tasg.TumblingEventTimeWindows.of(1000))
    with pytest.raises(RuntimeError, match="CUDA"):
        env.execute()
