"""The port's mesh layer held against the JAX package's: the mesh clamp and
key-group ranges, key-group routing tables and the balanced planner, the
keyBy exchange (B8), the segment partials (B4) and histograms (B7), the
ring collectives and hash routing.

The JAX side runs on the tier-1 conftest's virtual 8-device CPU mesh; the
port's meshes are `["cpu"] * n`. Inputs come from numpy seeds. Tolerance:
exact; the ring all-reduce takes its float32 sums in the JAX package's
order, so even random normals compare bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from flink_tpu.ops import matmul_hist as jmh
from flink_tpu.ops import segment_ops as jseg
from flink_tpu.parallel import mesh as jmesh
from flink_tpu.parallel import routing as jrt
from flink_tpu_torch.ops import matmul_hist as tmh
from flink_tpu_torch.parallel import mesh as tmesh
from flink_tpu_torch.parallel import routing as trt

INVALID = int(jseg.INVALID_INDEX)


@pytest.mark.parametrize("key_capacity", [1, 96, 128, 192, 1000, 1 << 20])
def test_usable_mesh_size_is_the_jax_clamp(key_capacity):
    for want in range(0, 11):
        for available in range(1, 10):
            assert tmesh.usable_mesh_size(want, available, key_capacity) == \
                jmesh.usable_mesh_size(want, available, key_capacity)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("max_p", [8, 128, 129])
def test_shard_ranges_match_jax(n, max_p):
    got = tmesh.shard_ranges(tmesh.Mesh(["cpu"] * n), max_p)
    want = jmesh.shard_ranges(jmesh.build_mesh(n), max_p)
    assert [(r.start, r.end) for r in got] == [(r.start, r.end) for r in want]


def test_mesh_devices_and_visible_devices(monkeypatch):
    m = tmesh.Mesh(["cpu", "cpu", "cpu"])
    assert m.shape == {"shards": 3} and m.size == 3
    assert tmesh.visible_devices("cpu") == [torch.device("cpu")]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert tmesh.visible_devices("cuda") == [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert tmesh.build_mesh(2, ["cpu"] * 4).devices == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="only 4 devices"):
        tmesh.build_mesh(5, ["cpu"] * 4)


@pytest.mark.parametrize("K,n,want", [(1024, 8, 0), (1024, 8, 64), (96, 4, 0), (96, 3, 7),
                                      (1 << 16, 4, 128), (12, 4, 0), (64, 8, 300)])
def test_key_group_routing_layouts_match_jax(K, n, want):
    assert trt.choose_key_groups(K, n, want) == jrt.choose_key_groups(K, n, want)
    t, j = trt.KeyGroupRouting(K, n, want), jrt.KeyGroupRouting(K, n, want)
    assert (t.G, t.Kg, t.is_identity) == (j.G, j.Kg, j.is_identity) == (t.G, K // t.G, True)
    np.testing.assert_array_equal(t.perm, j.perm)
    np.testing.assert_array_equal(t.perm, np.arange(K))          # identity: contiguous
    rng = np.random.default_rng(K + n)
    assign = rng.permutation(np.repeat(np.arange(n), t.G // n)).astype(np.int32)
    t2, j2 = t.with_assignment(assign), j.with_assignment(assign)
    np.testing.assert_array_equal(t2.perm, j2.perm)
    np.testing.assert_array_equal(t2.slot, j2.slot)
    assert t2.version == 1 and t2.payload() == j2.payload()
    canon = rng.integers(0, 100, (K, 3))
    np.testing.assert_array_equal(t2.to_device_layout(canon), j2.to_device_layout(canon))
    np.testing.assert_array_equal(t2.to_canonical(t2.to_device_layout(canon)), canon)
    g_dst, g_slot = t2.device_tables("cpu")
    assert g_dst.dtype == torch.int32 and g_dst.tolist() == assign.tolist()
    assert g_slot.tolist() == t2.slot.tolist()
    loads = rng.integers(0, 50, K)
    np.testing.assert_array_equal(t2.group_loads(loads), j2.group_loads(loads))
    assert t2.device_of_groups() == j2.device_of_groups()


def test_unbalanced_routing_assignment_rejected_in_both():
    for mod in (trt, jrt):
        r = mod.KeyGroupRouting(64, 4, 16)
        bad = np.zeros(16, np.int32)
        with pytest.raises(ValueError, match="G/n"):
            r.with_assignment(bad)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_balanced_assignment_and_skew_match_jax(seed, n):
    rng = np.random.default_rng(seed)
    loads = rng.zipf(1.3, 64).astype(np.float64)
    current = rng.permutation(np.repeat(np.arange(n), 64 // n))
    for cur in (None, current):
        a = trt.plan_balanced_assignment(loads, n, cur)
        np.testing.assert_array_equal(a, jrt.plan_balanced_assignment(loads, n, cur))
        assert np.bincount(a, minlength=n).tolist() == [64 // n] * n
        assert trt.predicted_skew(loads, a, n) == jrt.predicted_skew(loads, a, n)
    with pytest.raises(ValueError, match="do not divide"):
        trt.plan_balanced_assignment(loads[:63], n)


# ---------------------------------------------------------------------------
# the keyBy exchange (B8)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4])
def test_keyby_exchange_matches_jax(n):
    from flink_tpu.ops.exchange import make_keyby_exchange as jax_exchange
    from flink_tpu_torch.ops import exchange as tex

    B, maxp = 16, 128
    rng = np.random.default_rng(5)
    kg = rng.integers(0, maxp, size=(n, B)).astype(np.int32)
    payload = rng.integers(0, 1000, size=(n, B)).astype(np.int32)
    weight = rng.integers(0, 9, size=(n, B)).astype(np.float32)
    kg[:, -2:] = INVALID
    mesh = jmesh.build_mesh(n)
    sh = NamedSharding(mesh, P("shards", None))
    jkg, jcols = jax_exchange(mesh, maxp)(
        jax.device_put(kg, sh), {"payload": jax.device_put(payload, sh),
                                 "weight": jax.device_put(weight, sh)})
    tex.reset_counts()
    port = tex.make_keyby_exchange(tmesh.Mesh(["cpu"] * n), maxp)
    tkg, tcols = port([torch.from_numpy(k) for k in kg],
                      {"payload": [torch.from_numpy(p) for p in payload],
                       "weight": [torch.from_numpy(w) for w in weight]})
    np.testing.assert_array_equal(np.stack([t.numpy() for t in tkg]), np.asarray(jkg))
    for name in ("payload", "weight"):
        np.testing.assert_array_equal(np.stack([t.numpy() for t in tcols[name]]),
                                      np.asarray(jcols[name]))
    # one all-to-all a column; every block stayed on its (one) device
    assert tex.EXCHANGES == {"all_to_all": 3, "copies": 0}
    got = np.stack([t.numpy() for t in tkg])
    for d in range(n):
        live = got[d][got[d] != INVALID]
        assert ((live.astype(np.int64) * n) // maxp == d).all()


def test_all_to_all_keeps_source_order_and_copies_across_devices(monkeypatch):
    from flink_tpu_torch.ops import exchange as tex

    devices = [torch.device("cpu"), torch.device("meta")]
    blocks = [[torch.full((2,), 10 * i + j) for j in range(2)] for i in range(2)]
    moved = []
    real_to = torch.Tensor.to

    def fake_to(self, device, *a, **kw):      # a peer copy, without a second device
        moved.append(str(device))
        return real_to(self, "cpu", *a, **kw)

    monkeypatch.setattr(torch.Tensor, "to", fake_to)
    tex.reset_counts()
    recv = tex.all_to_all(blocks, devices)
    assert [r.tolist() for r in recv] == [[0, 0, 10, 10], [1, 1, 11, 11]]
    # every block lies on the first device: the second's two cross, none
    # of the first's
    assert tex.EXCHANGES["copies"] == 2 and moved == ["meta", "meta"]


# ---------------------------------------------------------------------------
# B4 and B7
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nseg", [100, 512, 1000])
def test_count_and_weighted_hist_match_jax(nseg):
    rng = np.random.default_rng(nseg)
    idx = rng.integers(-3, nseg + 3, 8192).astype(np.int32)
    vals = rng.integers(-50, 50, 8192).astype(np.float32)
    np.testing.assert_array_equal(tmh.count_hist(torch.from_numpy(idx), nseg).numpy(),
                                  np.asarray(jmh.count_hist(jnp.asarray(idx), nseg)))
    for exact in (True, False):
        np.testing.assert_array_equal(
            tmh.weighted_hist(torch.from_numpy(idx), torch.from_numpy(vals), nseg,
                              exact=exact).numpy(),
            np.asarray(jmh.weighted_hist(jnp.asarray(idx), jnp.asarray(vals), nseg,
                                         exact=exact)))


@pytest.mark.parametrize("agg", ["count", "sum", "min", "max", "mean"])
def test_segment_partials_match_jax(agg):
    from flink_tpu.ops import aggregators as jagg
    from flink_tpu.ops.superscan import make_segment_partials as jax_partials
    from flink_tpu_torch.ops import aggregators as tagg
    from flink_tpu_torch.ops.superscan import segment_partials, value_fields

    nseg = 4 * 64
    rng = np.random.default_rng(7)
    idx = rng.integers(-1, nseg + 3, 1024).astype(np.int32)
    vals = rng.integers(-9, 9, 1024).astype(np.float32)
    jfn, jvf = jax_partials(jagg.resolve(agg), nseg, 256, True, ingest="scatter")
    assert [f.name for f in value_fields(tagg.resolve(agg))] == [v[0] for v in jvf]
    jc, jparts = jfn(jnp.asarray(idx), jnp.asarray(vals))
    tc, tparts = segment_partials(tagg.resolve(agg), torch.from_numpy(idx),
                                  torch.from_numpy(vals), nseg)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    for t, j in zip(tparts, jparts):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    # the batched form: T rows of lanes at once equal T single-step calls
    idx2 = idx.reshape(4, 256)
    vals2 = vals.reshape(4, 256)
    bc, bparts = segment_partials(tagg.resolve(agg), torch.from_numpy(idx2),
                                  torch.from_numpy(vals2), nseg)
    for t in range(4):
        c, parts = segment_partials(tagg.resolve(agg), torch.from_numpy(idx2[t]),
                                    torch.from_numpy(vals2[t]), nseg)
        assert torch.equal(bc[t], c) and all(torch.equal(b[t], p) for b, p in zip(bparts, parts))


# ---------------------------------------------------------------------------
# ring collectives (twins of tests/test_ring.py)
# ---------------------------------------------------------------------------

def _jax_ring(body, x, outs=1):
    from flink_tpu.utils.jax_compat import shard_map

    mesh = jmesh.build_mesh(x.shape[0])
    spec = P("shards")
    f = jax.jit(shard_map(body, mesh=mesh, in_specs=spec,
                          out_specs=spec if outs == 1 else (spec,) * outs))
    return f(x)


def _tmesh(n):
    return [torch.device("cpu")] * n


@pytest.mark.parametrize("rows", [40, 13])
def test_ring_all_reduce_matches_jax(rows):
    from flink_tpu.parallel.ring import ring_all_reduce as jax_reduce
    from flink_tpu_torch.parallel.ring import ring_all_reduce

    rng = np.random.default_rng(rows)
    x = rng.normal(size=(8, rows, 3)).astype(np.float32)
    want = np.asarray(_jax_ring(lambda xs: jax_reduce(xs[0], "shards")[None], x))
    got = ring_all_reduce([torch.from_numpy(s) for s in x], _tmesh(8))
    for s in range(8):
        np.testing.assert_array_equal(got[s].numpy(), want[s])
        np.testing.assert_allclose(got[s].numpy(), x.sum(axis=0), rtol=1e-5)


def test_ring_all_reduce_max_combine_and_all_gather():
    from flink_tpu.parallel.ring import ring_all_gather as jax_gather
    from flink_tpu_torch.parallel.ring import ring_all_gather, ring_all_reduce

    rng = np.random.default_rng(1)
    x = rng.normal(size=(8, 16)).astype(np.float32)
    got = ring_all_reduce([torch.from_numpy(s) for s in x], _tmesh(8), combine=torch.maximum)
    np.testing.assert_array_equal(got[3].numpy(), x.max(axis=0))
    g = np.arange(8 * 4, dtype=np.float32).reshape(8, 4)
    want = np.asarray(_jax_ring(lambda xs: jax_gather(xs[0], "shards")[None], g))
    got = ring_all_gather([torch.from_numpy(s) for s in g], _tmesh(8))
    for s in range(8):
        np.testing.assert_array_equal(got[s].numpy(), want[s])
        np.testing.assert_array_equal(got[s].numpy(), g)


def test_ring_global_topk_matches_jax():
    from flink_tpu.parallel.ring import ring_global_topk as jax_topk
    from flink_tpu_torch.parallel.ring import ring_global_topk

    rng = np.random.default_rng(2)
    x = rng.permutation(8 * 50).astype(np.float32).reshape(8, 50)

    def body(xs):
        v, s = jax_topk(xs[0], 5, "shards")
        return v[None], s[None]

    jv, js = map(np.asarray, _jax_ring(body, x, outs=2))
    got = ring_global_topk([torch.from_numpy(s) for s in x], 5, _tmesh(8))
    for s, (v, src) in enumerate(got):
        np.testing.assert_array_equal(v.numpy(), jv[s])
        np.testing.assert_array_equal(src.numpy(), js[s])
        for val, owner in zip(v.tolist(), src.tolist()):
            assert val in x[owner]


# ---------------------------------------------------------------------------
# key hashing and record batches (core/records.py)
# ---------------------------------------------------------------------------

def test_hash_keys_and_record_batches_match_jax():
    from flink_tpu.core import records as jrec
    from flink_tpu_torch.core import records as trec

    ints = np.array([0, 1, -1, 2 ** 31 - 1, -(2 ** 31), 2 ** 40 + 7, -(2 ** 45)], np.int64)
    np.testing.assert_array_equal(trec.hash_keys(ints), jrec.hash_keys(ints))
    strs = np.array(["a", "user-7", "", "ключ", 3, 4.5], dtype=object)
    np.testing.assert_array_equal(trec.hash_keys(strs), jrec.hash_keys(strs))
    ts = np.arange(6, dtype=np.int64)
    tb = trec.RecordBatch.from_columns(ts, list(strs), {"value": ts.astype(np.float32)}, 128)
    jb = jrec.RecordBatch.from_columns(ts, list(strs), {"value": ts.astype(np.float32)}, 128)
    np.testing.assert_array_equal(tb.key_groups, jb.key_groups)
    sel = tb.select(tb.key_groups % 2 == 0).concat(trec.RecordBatch.empty())
    assert len(sel) == int((jb.key_groups % 2 == 0).sum())
    assert trec.StreamRecord(1).has_timestamp() is False
    assert trec.LatencyMarker(5, 0, 1).marked_time_ms == 5
