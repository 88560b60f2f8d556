"""The port's sharded pipelines held against the JAX package's mesh and the
single-device port.

`flink_tpu_torch`'s ShardedFusedPipeline runs on meshes of `["cpu"] * n`
shards (the plain versions of K1 and its partials entry) beside the JAX
ShardedFusedPipeline on the tier-1 conftest's virtual 8-device CPU mesh,
on identical numpy-made streams: count, sum and max on meshes of 2, 4 and
8, the map-side combiner on and off (its step groups, and an int sum of
fractions cast once per cell as on one card), a permuted routing table,
the traced chain, capacity growth, and snapshots crossed between the
packages and between mesh sizes. Then the per-batch ShardedTpuWindowOperator (twins of
tests/test_parallel.py) and the ShardedJoinPipeline against the
single-ring join.

Tolerance: exact. Payloads are small integers or quarter values (every
float32 partial sum is exact whatever the add order) and rows are
compared for keys whose window count is above 0.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

from flink_tpu.api.windowing import assigners as jasg
from flink_tpu.parallel import sharded_superscan as jss
from flink_tpu.parallel.routing import plan_balanced_assignment
from flink_tpu.runtime import fused_window_pipeline as jfp
from flink_tpu.testing.harness import keyed_window_stream
from flink_tpu_torch.api.windowing import assigners as tasg
from flink_tpu_torch.ops import superscan as tss
from flink_tpu_torch.parallel import sharded_superscan as tsp
from flink_tpu_torch.parallel.mesh import Mesh
from flink_tpu_torch.runtime import fused_window_pipeline as tfp

NUM_KEYS = 256
GEOM = dict(key_capacity=NUM_KEYS, num_slices=16, nsb=4, fires_per_step=4, out_rows=16)


def _jmesh(n):
    return JaxMesh(np.array(jax.devices()[:n]), ("shards",))


def _stream(seed=3, steps=8, vals=True):
    batches, wms = keyed_window_stream(seed, steps, 600, NUM_KEYS, vals)
    # a ragged and an empty step: dead lanes on every shard
    k, v, ts = batches[2]
    batches[2] = (k[:173], None if v is None else v[:173], ts[:173])
    batches[5] = (k[:0], None if v is None else v[:0], ts[:0])
    return batches, wms


def _drain(pipe, batches, wms, every=4):
    out = []
    for lo in range(0, len(batches), every):
        out.extend(pipe.process_superbatch(batches[lo:lo + every], wms[lo:lo + every]))
    return out


def _rows(out):
    """(start, end, live keys, counts, {field: values at live keys}), in
    fire order."""
    rows = []
    for w, counts, fields in out:
        c = np.asarray(counts)
        live = np.flatnonzero(c > 0)
        rows.append((int(w.start), int(w.end), live.tolist(), c[live].tolist(),
                     {k: np.asarray(v)[live].tolist() for k, v in sorted(fields.items())}))
    return rows


def _port(agg, n=None, **kw):
    asg = tasg.SlidingEventTimeWindows.of(2000, 500)
    if n is None:
        return tfp.FusedWindowPipeline(asg, agg, chunk=512, device="cpu", **GEOM, **kw)
    return tsp.ShardedFusedPipeline(Mesh(["cpu"] * n), asg, agg, chunk=512, **GEOM, **kw)


def _jax(agg, n, **kw):
    return jss.ShardedFusedPipeline(_jmesh(n), jasg.SlidingEventTimeWindows.of(2000, 500),
                                    agg, chunk=512, **GEOM, **kw)


@pytest.fixture(scope="module")
def streams():
    return {False: _stream(vals=False), True: _stream(vals=True)}


@pytest.fixture(scope="module")
def single_rows(streams):
    return {agg: _rows(_drain(_port(agg), *streams[agg != "count"]))
            for agg in ("count", "sum", "max", "min")}


JAX_CASES = [("count", 2, False), ("count", 4, False), ("count", 8, False),
             ("sum", 4, False), ("max", 4, False), ("sum", 4, True), ("max", 2, True),
             ("count", 8, True)]


@pytest.mark.parametrize("agg,n,combine", JAX_CASES,
                         ids=[f"{a}-n{n}-{'combine' if c else 'raw'}" for a, n, c in JAX_CASES])
def test_sharded_pipeline_matches_jax_and_single_port(streams, single_rows, agg, n, combine):
    batches, wms = streams[agg != "count"]
    port = _port(agg, n, local_combine=combine)
    assert port.local_combine == combine and port.n == n and port.K_local == NUM_KEYS // n
    got = _rows(_drain(port, batches, wms))
    want = _rows(_drain(_jax(agg, n, local_combine=combine), batches, wms))
    assert len(got) > 0
    assert got == want
    assert got == single_rows[agg]


@pytest.mark.parametrize("combine", [False, True], ids=["raw", "combine"])
@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("agg", ["count", "sum", "max", "min"])
def test_sharded_pipeline_matches_single_port(streams, single_rows, agg, n, combine):
    batches, wms = streams[agg != "count"]
    assert _rows(_drain(_port(agg, n, local_combine=combine), batches, wms)) == \
        single_rows[agg]


def test_non_decomposable_aggregate_keeps_the_raw_exchange(streams, single_rows):
    from flink_tpu_torch.ops.aggregators import AccField, DeviceAggregator, decomposable, resolve

    closed = DeviceAggregator("sum_closed", (AccField("sum", np.float32, 0, "add"),),
                              lambda f: f["sum"], combinable=False)
    assert not decomposable(closed) and decomposable(resolve("sum"))
    pipe = _port(closed, 4, local_combine=True)
    assert not pipe.local_combine
    assert _rows(_drain(pipe, *streams[True])) == single_rows["sum"]


@pytest.mark.parametrize("combine", [False, True], ids=["raw", "combine"])
def test_permuted_routing_table_matches_jax(streams, single_rows, combine):
    """A non-identity key-group -> shard table, set mid-stream from the
    group loads (the JAX test_combine_under_routing_table's sequence):
    placement never changes a row, and both packages place alike."""
    batches, wms = streams[True]
    outs = {}
    for name, pipe in (("port", _port("sum", 4, local_combine=combine, skew_routing=True)),
                       ("jax", _jax("sum", 4, local_combine=combine, skew_routing=True))):
        out = []
        for i, lo in enumerate(range(0, len(batches), 4)):
            out.extend(pipe.process_superbatch(batches[lo:lo + 4], wms[lo:lo + 4]))
            if i == 0:
                loads = pipe.mesh_group_loads()
                if name == "port":
                    outs["loads"] = loads
                else:
                    np.testing.assert_array_equal(outs["loads"], loads)
                assign = plan_balanced_assignment(loads, pipe.n)[::-1].copy()
                assign = np.roll(assign, 3)
                assert pipe.set_routing_assignment(assign) == 1
                outs[name + "_perm"] = pipe.routing.perm.copy()
                outs[name + "_loads"] = np.asarray(pipe.key_loads())
        outs[name] = _rows(out)
    assert not np.array_equal(outs["port_perm"], np.arange(NUM_KEYS))
    np.testing.assert_array_equal(outs["port_perm"], outs["jax_perm"])
    np.testing.assert_array_equal(outs["port_loads"], outs["jax_loads"])
    assert outs["port"] == outs["jax"] == single_rows["sum"]


def _prologues():
    """The same traced chain in both packages: keep one record in three,
    key on column 0, value column 1."""
    jp = jfp.TracedPrologue(
        transforms=(("filter", lambda c: c[:, 2] < 0.5),),
        key_fn=lambda c: c[:, 0].astype(jnp.int32), value_fn=lambda c: c[:, 1])
    tp = tfp.TracedPrologue(
        transforms=(("filter", lambda c: c[:, 2] < 0.5),),
        key_fn=lambda c: c[:, 0].to(torch.int32), value_fn=lambda c: c[:, 1])
    return jp, tp


def _raw_steps(seed=9, steps=8, batch=700):
    rng = np.random.default_rng(seed)
    out, wms = [], []
    for t in range(steps):
        n = batch if t != 3 else 211
        col = np.stack([rng.integers(0, NUM_KEYS, n), rng.integers(0, 9, n),
                        rng.integers(0, 3, n)], axis=1).astype(np.float32)
        ts = (t * 400 + np.sort(rng.integers(0, 400, n))).astype(np.int64)
        out.append((col, ts))
        wms.append(t * 400 + 250)
    return out, wms


@pytest.mark.parametrize("combine", [False, True], ids=["raw", "combine"])
def test_traced_chain_on_the_mesh_matches_jax(combine):
    steps, wms = _raw_steps()
    jp, tp = _prologues()
    port = tsp.ShardedFusedPipeline(Mesh(["cpu"] * 4), tasg.SlidingEventTimeWindows.of(2000, 500),
                                    "sum", chunk=512, prologue=tp, local_combine=combine, **GEOM)
    jx = jss.ShardedFusedPipeline(_jmesh(4), jasg.SlidingEventTimeWindows.of(2000, 500), "sum",
                                  chunk=512, prologue=jp, local_combine=combine, **GEOM)
    single = tfp.FusedWindowPipeline(tasg.SlidingEventTimeWindows.of(2000, 500), "sum",
                                     chunk=512, prologue=tp, device="cpu", **GEOM)
    rows = {}
    for name, pipe in (("port", port), ("jax", jx), ("single", single)):
        out = []
        for lo in range(0, len(steps), 4):
            out.extend(pipe.process_superbatch_raw(steps[lo:lo + 4], wms[lo:lo + 4]))
        rows[name] = _rows(out)
    assert len(rows["port"]) > 0
    assert rows["port"] == rows["jax"] == rows["single"]


def test_traced_chain_out_of_range_key_raises_at_resolve():
    _jp, tp = _prologues()
    port = tsp.ShardedFusedPipeline(Mesh(["cpu"] * 2), tasg.SlidingEventTimeWindows.of(2000, 500),
                                    "sum", chunk=512, prologue=tp, **GEOM)
    col = np.array([[3, 1, 0], [NUM_KEYS + 5, 1, 0]], np.float32)
    with pytest.raises(ValueError, match="outside"):
        port.process_superbatch_raw([(col, np.array([10, 20], np.int64))], [5])


def test_capacity_growth_matches_jax_and_single_port():
    """The classic keyed path grows K mid-stream (to the next power of two
    rounded to a multiple of the mesh size); the rows keep matching."""
    batches, wms = _stream(seed=5, vals=True)
    small = dict(GEOM, key_capacity=64)
    pipes = {"port": tsp.ShardedFusedPipeline(Mesh(["cpu"] * 4), tasg.SlidingEventTimeWindows.of(
                 2000, 500), "sum", chunk=512, **small),
             "jax": jss.ShardedFusedPipeline(_jmesh(4), jasg.SlidingEventTimeWindows.of(2000, 500),
                                             "sum", chunk=512, **small),
             "single": tfp.FusedWindowPipeline(tasg.SlidingEventTimeWindows.of(2000, 500), "sum",
                                               chunk=512, device="cpu", **small)}
    rows = {}
    for name, pipe in pipes.items():
        out = []
        for lo in range(0, len(batches), 4):
            cut = [(k % (64 if lo == 0 else NUM_KEYS), v, t) for k, v, t in batches[lo:lo + 4]]
            pipe.ensure_key_capacity(64 if lo == 0 else NUM_KEYS)
            out.extend(pipe.process_superbatch(cut, wms[lo:lo + 4]))
        rows[name] = _rows(out)
        assert pipe.K == NUM_KEYS
    assert pipes["port"].K_local == NUM_KEYS // 4
    assert rows["port"] == rows["jax"] == rows["single"]


def test_capacity_growth_rounds_to_a_multiple_of_the_mesh():
    pipe = tsp.ShardedFusedPipeline(Mesh(["cpu"] * 3), tasg.SlidingEventTimeWindows.of(2000, 500),
                                    "count", chunk=512, **dict(GEOM, key_capacity=96))
    pipe.ensure_key_capacity(100)
    assert pipe.K == 129 and pipe.K_local == 43
    assert pipe.snapshot()["count"].shape == (129, 16)


@pytest.mark.parametrize("src,dst", [("jax8", "port2"), ("jax8", "port1"), ("port4", "jax8"),
                                     ("port4", "jax1"), ("port2", "port8"), ("port1", "port4"),
                                     ("port8", "port1")])
def test_snapshots_cross_packages_and_mesh_sizes(streams, single_rows, src, dst):
    batches, wms = streams[True]

    def make(spec):
        n, pkg = int(spec[-1]), "jax" if spec.startswith("jax") else "port"
        if n == 1:
            return (jfp.FusedWindowPipeline(jasg.SlidingEventTimeWindows.of(2000, 500), "sum",
                                            chunk=512, backend="xla", **GEOM)
                    if pkg == "jax" else _port("sum"))
        return _jax("sum", n) if pkg == "jax" else _port("sum", n)

    first, second = make(src), make(dst)
    rows = _rows(_drain(first, batches[:4], wms[:4]))
    snap = first.snapshot()
    assert snap["count"].shape == (NUM_KEYS, 16)
    second.restore(snap)
    rows += _rows(_drain(second, batches[4:], wms[4:]))
    assert rows == single_rows["sum"]


def test_partials_ingest_equals_the_lane_ingest():
    """K1's partials entry's plain version, fed B4's partials of a step's
    lanes, leaves the rings and rows the lane ingest leaves (count, sum,
    max and min fields of one aggregate, each at its scan identity)."""
    from flink_tpu_torch.ops.aggregators import AccField, DeviceAggregator, ONE

    agg = DeviceAggregator("multi", (AccField("count", np.int32, 0, "add", ONE),
                                     AccField("sum", np.float32, 0, "add"),
                                     AccField("max", np.float32,
                                              float(np.finfo(np.float32).min), "max"),
                                     AccField("min", np.int32, 2 ** 31 - 1, "min")),
                           lambda f: f["sum"])
    rng = np.random.default_rng(4)
    S, K, NSB, T, B, R = 16, 48, 4, 6, 300, 8
    idx = rng.integers(-1, K * NSB, (T, B)).astype(np.int32)
    vals = rng.integers(-20, 20, (T, B)).astype(np.float32)
    plan = (torch.tensor(rng.integers(0, S, T), dtype=torch.int32),
            torch.tensor(rng.integers(0, S, (T, 2)), dtype=torch.int32),
            torch.tensor(rng.integers(0, 2, (T, 2)), dtype=torch.int32),
            torch.tensor(rng.integers(0, R, (T, 2)), dtype=torch.int32),
            torch.tensor(rng.integers(0, 4, (T, S)).clip(0, 1), dtype=torch.int32))

    def rings():
        return (torch.zeros((S, K), dtype=torch.int32),
                [torch.full((S, K), f.device_identity, dtype=d)
                 for f, d in zip(tss.value_fields(agg), (torch.float32, torch.float32,
                                                        torch.int32))])

    c1, s1 = rings()
    o1 = tss.keyed_superscan_plain(agg, c1, s1, torch.from_numpy(idx).reshape(-1),
                                   torch.from_numpy(vals).reshape(-1), plan, NSB=NSB, R=R,
                                   spws=(3, 5), exact=True)
    c2, s2 = rings()
    cpart, parts = tss.segment_partials(agg, torch.from_numpy(idx), torch.from_numpy(vals),
                                        K * NSB)
    o2 = tss.keyed_superscan_partials_plain(
        agg, c2, s2, cpart.view(T, K, NSB), [p.view(T, K, NSB) for p in parts], plan,
        NSB=NSB, R=R, spws=(3, 5))
    assert torch.equal(c1, c2) and all(torch.equal(a, b) for a, b in zip(s1, s2))
    assert torch.equal(o1[0], o2[0]) and all(torch.equal(a, b) for a, b in zip(o1[1], o2[1]))


INT_SUM_CASES = [(np.int64, 2), (np.int32, 4)]


@pytest.mark.parametrize("dtype,n", INT_SUM_CASES,
                         ids=[f"{np.dtype(d).name}-n{n}" for d, n in INT_SUM_CASES])
def test_int_sum_of_fractions_casts_per_cell_with_local_combine(streams, dtype, n):
    """An int sum of fractional values casts each cell's float32 sum once
    on every route (ROADMAP C3): the mesh with the map-side combiner on and
    off gives the single-card rows, on C3's inputs (their two records on
    two source shards) and on a stream of quarter values."""
    from flink_tpu_torch.ops.aggregators import sum_agg

    agg = sum_agg(dtype)
    c3 = [(np.array([1, 1]), np.array(v, np.float32), np.array([10, 20]))
          for v in ([16777216.0, 1.0], [0.5, 0.5])]
    batches, wms = streams[True]
    quarters = [(k, v + (np.arange(len(v)) % 4 / 4).astype(np.float32), ts)
                for k, v, ts in batches]

    def rows(pipe, feed, marks):
        return _rows(_drain(pipe, feed, marks))

    for feed, marks in (([c3[0]], [5000]), ([c3[1]], [5000]), (quarters, wms)):
        want = rows(_port(agg), feed, marks)
        assert len(want) > 0
        for combine in (False, True):
            pipe = _port(agg, n, local_combine=combine)
            assert pipe.local_combine == combine
            assert rows(pipe, feed, marks) == want, (feed is quarters, combine)
    # every window holding both records: C3's rows (a float32 sum, cast once)
    for feed, total in (([c3[0]], 16777216), ([c3[1]], 1)):
        got = rows(_port(agg, n, local_combine=True), feed, [5000])
        assert len(got) == 4 and all(r[3] == [2] and r[4]["sum"] == [total] for r in got)


@pytest.mark.parametrize("agg", ["count", "sum", "max"])
def test_partials_cross_in_step_groups_under_the_budget(streams, single_rows, agg,
                                                        monkeypatch):
    """With a partials budget of one to three steps' partials, the map-side
    combiner's dispatch runs in several step groups (an exchange and a
    partials launch each) and gives the rows of one group."""
    from flink_tpu_torch.ops import cuda_superscan as cs

    pipe = _port(agg, 4, local_combine=True)
    step = 4 * NUM_KEYS * 4 * 4 * (1 + (agg != "count"))
    for steps in (1, 3):
        monkeypatch.setattr(cs, "PARTIAL_BUDGET", steps * step)
        assert pipe.partial_groups(4) == [(t, min(4, t + steps)) for t in range(0, 4, steps)]
        pipe = _port(agg, 4, local_combine=True)
        assert _rows(_drain(pipe, *streams[agg != "count"])) == single_rows[agg]


def test_mesh_surfaces_left_for_13b_raise():
    # shared partials and the tiered row surface on the mesh are ported
    # (tests/test_torch_mesh_features.py holds them against the JAX mesh):
    # both surfaces now run, and the row surface reads the rows the
    # one-device pipeline holds
    shared = tsp.ShardedFusedPipeline(Mesh(["cpu"] * 2), None, "count", chunk=512,
                                      assigners=[tasg.SlidingEventTimeWindows.of(2000, 500),
                                                 tasg.TumblingEventTimeWindows.of(1000)],
                                      **GEOM)
    assert shared.F == 2 * GEOM["fires_per_step"] and shared.slot_spws()[-1] == 2
    batches, wms = _stream(vals=False)
    pipe, one = _port("count", 2), _port("count")
    for p in (pipe, one):
        _drain(p, batches, wms)
    kids = np.arange(0, NUM_KEYS, 7)
    assert np.array_equal(pipe.gather_key_rows(kids)[0], one.gather_key_rows(kids)[0])
    pipe.clear_key_rows(kids)
    assert not pipe.gather_key_rows(kids)[0].any()
    assert np.array_equal(pipe.gather_cells(kids, kids % 16)[0], np.zeros(len(kids), np.int32))
    # the skew rebalancer's options are still queued (item 13b)
    from flink_tpu_torch.config import Configuration

    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue A, item 13"):
        Configuration({"parallel.mesh.skew-rebalance": True})


# ---------------------------------------------------------------------------
# the per-batch sharded operator (twins of tests/test_parallel.py)
# ---------------------------------------------------------------------------

def _records(n=500, keys=20, span=20_000, seed=0):
    rng = np.random.default_rng(seed)
    return [(f"user-{rng.integers(0, keys)}", float(rng.integers(1, 10)),
             int(rng.integers(0, span))) for _ in range(n)]


def _run_op(op, records, wm_every=50):
    from flink_tpu_torch.utils.arrays import obj_array

    max_ts = 0
    chunk = []

    def flush():
        if chunk:
            op.process_batch(obj_array([r[0] for r in chunk]),
                             np.asarray([r[1] for r in chunk], np.float32),
                             np.asarray([r[2] for r in chunk], np.int64))
            chunk.clear()

    for i, r in enumerate(records):
        chunk.append(r)
        max_ts = max(max_ts, r[2])
        if (i + 1) % wm_every == 0:
            flush()
            op.process_watermark(max_ts - 300)
    flush()
    op.process_watermark(max_ts + 10 ** 7)
    return sorted((k, w.start, w.end, round(float(r), 3), t) for k, w, r, t in op.drain_output())


def _sharded_ops(n, assigner, agg, **kw):
    from flink_tpu.parallel.mesh import build_mesh
    from flink_tpu.parallel.sharded_window import ShardedTpuWindowOperator as JaxOp
    from flink_tpu_torch.parallel.sharded_window import ShardedTpuWindowOperator as PortOp

    return (PortOp(assigner(tasg), agg, Mesh(["cpu"] * n), max_parallelism=128, num_slices=64,
                   **kw),
            JaxOp(assigner(jasg), agg, build_mesh(n), max_parallelism=128, num_slices=64, **kw))


@pytest.mark.parametrize("n", [2, 8])
def test_sharded_operator_matches_jax_and_single_shard(n):
    from flink_tpu_torch.runtime.tpu_window_operator import TpuWindowOperator

    records = _records()
    port, jx = _sharded_ops(n, lambda m: m.TumblingEventTimeWindows.of(1000), "sum")
    single = TpuWindowOperator(tasg.TumblingEventTimeWindows.of(1000), "sum", num_slices=64,
                               device="cpu")
    got = _run_op(port, records)
    assert len(got) > 0 and got == _run_op(jx, records) == _run_op(single, records)
    # every shard took keys (routing by the JAX package's hash)
    assert sum(1 for d in port.state.keydicts if len(d)) > 1


def test_sharded_operator_sliding_with_lateness():
    records = _records(400, keys=10, seed=3)
    port, jx = _sharded_ops(4, lambda m: m.SlidingEventTimeWindows.of(3000, 1000), "count",
                            allowed_lateness=500)
    got = _run_op(port, records)
    assert len(got) > 0 and got == _run_op(jx, records)


@pytest.mark.parametrize("src,dst", [("port4", "port8"), ("port4", "jax2"), ("jax8", "port2")])
def test_sharded_operator_snapshot_rescales_across_packages(src, dst):
    """Snapshot at one shard count, restore at another (either package):
    keys re-route by key group (the reference's rescale restore)."""
    from flink_tpu.parallel.mesh import build_mesh
    from flink_tpu.parallel.sharded_window import ShardedTpuWindowOperator as JaxOp
    from flink_tpu_torch.parallel.sharded_window import ShardedTpuWindowOperator as PortOp
    from flink_tpu_torch.utils.arrays import obj_array

    records = _records(300, keys=16, span=10_000, seed=7)
    mid = len(records) // 2

    def make(spec):
        n = int(spec[-1])
        if spec.startswith("jax"):
            return JaxOp(jasg.TumblingEventTimeWindows.of(1000), "sum", build_mesh(n),
                         max_parallelism=128, num_slices=64)
        return PortOp(tasg.TumblingEventTimeWindows.of(1000), "sum", Mesh(["cpu"] * n),
                      max_parallelism=128, num_slices=64)

    def feed(op, recs):
        op.process_batch(obj_array([r[0] for r in recs]),
                         np.asarray([r[1] for r in recs], np.float32),
                         np.asarray([r[2] for r in recs], np.int64))

    ref = make("port2")
    feed(ref, records)
    ref.process_watermark(10 ** 7)
    want = sorted((k, w.start, float(r)) for k, w, r, _t in ref.drain_output())
    first, second = make(src), make(dst)
    feed(first, records[:mid])
    second.restore(first.snapshot())
    feed(second, records[mid:])
    second.process_watermark(10 ** 7)
    got = sorted((k, w.start, float(r)) for k, w, r, _t in second.drain_output())
    assert len(got) > 0 and got == want


def test_spmd_step_matches_jax():
    from flink_tpu.ops import aggregators as jagg
    from flink_tpu.parallel.mesh import build_mesh
    from flink_tpu.parallel.spmd_step import make_spmd_step as jax_step
    from flink_tpu_torch.ops import aggregators as tagg
    from flink_tpu_torch.parallel.spmd_step import make_spmd_step as port_step

    n, K, S, B, maxp = 4, 32, 8, 64, 128
    rng = np.random.default_rng(2)
    kg = rng.integers(0, maxp, (n, B)).astype(np.int32)
    kg[:, -5:] = np.int32(2 ** 31 - 1)
    kid = rng.integers(0, K, (n, B)).astype(np.int32)
    spos = rng.integers(0, S, (n, B)).astype(np.int32)
    vals = rng.integers(0, 9, (n, B)).astype(np.float32)
    pos = np.array([1, 2, 3], np.int32)
    jagg_ = jagg.resolve("sum")
    acc = {f.name: np.full((n, K, S), f.identity, np.float32) for f in jagg_.fields}
    count = np.zeros((n, K, S), np.int32)
    jout = jax_step(build_mesh(n), maxp, jagg_)(
        {k: jnp.asarray(v) for k, v in acc.items()}, jnp.asarray(count), jnp.asarray(kg),
        jnp.asarray(kid), jnp.asarray(spos), jnp.asarray(vals), jnp.asarray(pos))
    mesh = Mesh(["cpu"] * n)
    t = lambda a: [torch.from_numpy(x.copy()) for x in a]  # noqa: E731
    pout = port_step(mesh, maxp, tagg.resolve("sum"))(
        {k: t(v) for k, v in acc.items()}, t(count), t(kg), t(kid), t(spos), t(vals), pos)
    for name in acc:
        np.testing.assert_array_equal(np.stack([x.numpy() for x in pout[0][name]]),
                                      np.asarray(jout[0][name]))
    np.testing.assert_array_equal(np.stack([x.numpy() for x in pout[1]]), np.asarray(jout[1]))
    mask = np.asarray(jout[3])
    np.testing.assert_array_equal(np.stack([x.numpy() for x in pout[3]]), mask)
    np.testing.assert_array_equal(np.stack([x.numpy() for x in pout[2]])[mask],
                                  np.asarray(jout[2])[mask])
    assert [int(x) for x in pout[4]] == [int(x) for x in np.asarray(jout[4])]


# ---------------------------------------------------------------------------
# the sharded join
# ---------------------------------------------------------------------------

def _join_feed(pipe, seed=1, K=64, batches=6):
    rng = np.random.default_rng(seed)
    out = []
    for b in range(batches):
        for side in (0, 1):
            n = 120
            kids = rng.integers(0, K, n)
            ts = (b * 1000 + rng.integers(0, 1000, n)).astype(np.int64)
            rows = [(side, b, i) for i in range(n)]
            pipe.ingest(side, kids, ts, rows)
        if b >= 1:
            start = (b - 1) * 1000
            l, r, k = pipe.fire_window(start, start + 2000)
            out.append(sorted(zip(pipe.left.take_rows(l), pipe.right.take_rows(r), k.tolist())))
            out.append(sorted(zip(*(x.tolist() for x in pipe.match_interval(
                np.arange(b - 1, b + 1), np.arange(b - 1, b + 1), -200, 300)))))
            pipe.purge_below_window(start - 1000)
    return out


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_join_rows_equal_the_single_ring_join(n):
    from flink_tpu_torch.joins.pipeline import FusedJoinPipeline
    from flink_tpu_torch.joins.sharded import ShardedJoinPipeline
    from flink_tpu_torch.joins.spec import plan_join_geometry

    geom = plan_join_geometry(2000, 1000, 0, key_capacity=64, bucket_capacity=64,
                              ring_slack_buckets=2)
    single = _join_feed(FusedJoinPipeline(geom, "cpu"))
    sharded = ShardedJoinPipeline(geom, Mesh(["cpu"] * n))
    assert sharded.num_shards == n and sharded.left.K_local == 64 // n
    got = _join_feed(sharded)
    assert sum(len(x) for x in got) > 0 and got == single
    # snapshots restore across the placements
    again = ShardedJoinPipeline(geom, Mesh(["cpu"] * 2))
    again.restore(sharded.snapshot())
    plain = FusedJoinPipeline(geom, "cpu")
    plain.restore(sharded.snapshot())
    assert again.fire_window(4000, 6000)[2].tolist() == plain.fire_window(4000, 6000)[2].tolist()
    with pytest.raises(ValueError, match="does not divide"):
        ShardedJoinPipeline(geom, Mesh(["cpu"] * 3))


def test_watermark_only_dispatch_of_a_traced_mesh_pipeline():
    """A traced pipeline's dispatch with no records (a restore, then a
    watermark) fires and purges through the classic path on every shard."""
    steps, wms = _raw_steps()
    _jp, tp = _prologues()
    pipes = [tsp.ShardedFusedPipeline(Mesh(["cpu"] * 4), tasg.SlidingEventTimeWindows.of(
                 2000, 500), "sum", chunk=512, prologue=tp, **GEOM),
             tfp.FusedWindowPipeline(tasg.SlidingEventTimeWindows.of(2000, 500), "sum",
                                     chunk=512, prologue=tp, device="cpu", **GEOM)]
    rows = []
    for pipe in pipes:
        out = pipe.process_superbatch_raw(steps[:4], wms[:4])
        empty = [(np.empty((0, 3), np.float32), np.empty(0, np.int64))] * 2
        n_data = len(out)
        out += pipe.process_superbatch_raw(empty, [2100, 2600])
        assert len(out) > n_data          # the empty dispatch fired windows
        rows.append(_rows(out))
    assert rows[0] == rows[1]
