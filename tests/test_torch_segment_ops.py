"""The port's per-batch programs held against the JAX package's.

`flink_tpu_torch/ops/segment_ops.py` and `ops/sorted_ingest.py` against
`flink_tpu/ops/segment_ops.py` and `ops/sorted_ingest.py` on the same
seeded numpy inputs: ingest (scatter and sort forms) with its touch, fire
and masked fire, purge, key growth, `masked_top_k` and
`bounded_segment_fold`, for count, sum, min, max, max8 and mean, with
INVALID_INDEX lanes in every batch. The port's rings are slice-major
[S, K], the JAX package's [K, S]: compared transposed.

Tolerance: bit-equal (integer-valued payloads, so float sums are exact in
any order).
"""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from flink_tpu.ops import aggregators as jagg  # noqa: E402
from flink_tpu.ops import segment_ops as jseg  # noqa: E402
from flink_tpu.ops.sorted_ingest import make_sorted_ingest_fn  # noqa: E402
from flink_tpu_torch.ops import aggregators as tagg  # noqa: E402
from flink_tpu_torch.ops import segment_ops as tseg  # noqa: E402
from flink_tpu_torch.ops.sorted_ingest import sorted_ingest  # noqa: E402

K, S, B = 24, 8, 300
INV = int(tseg.INVALID_INDEX)
AGGS = {
    "count": (jagg.count_agg, tagg.count_agg),
    "sum": (jagg.sum_agg, tagg.sum_agg),
    "min": (jagg.min_agg, tagg.min_agg),
    "max": (jagg.max_agg, tagg.max_agg),
    "max8": (lambda: jagg.max_agg(domain_bits=8), lambda: tagg.max_agg(domain_bits=8)),
    "mean": (jagg.mean_agg, tagg.mean_agg),
}


def _batch(rng, k=K, b=B):
    """(kid, spos, vals): ~15% INVALID_INDEX lanes, integer-valued values
    in [0, 255] (the max8 domain) with a hot key."""
    kid = np.where(rng.random(b) < 0.4, 3, rng.integers(0, k, b)).astype(np.int32)
    spos = rng.integers(0, S, b).astype(np.int32)
    invalid = rng.random(b) < 0.15
    kid[invalid] = INV
    spos[invalid] = INV
    vals = rng.integers(0, 256, b).astype(np.float32)
    return kid, spos, vals


def _both(name, rng, batches=2, kernel="scatter"):
    """Ingest `batches` batches into fresh JAX and port states: (jax state,
    port state, jax touch of the last batch, port lanes of the last batch)."""
    ja, ta = (f() for f in AGGS[name])
    jacc, jcount = jseg.init_state_arrays(ja, K, S)
    tacc, tcount = tseg.init_state_arrays(ta, K, S, "cpu")
    jfn = (make_sorted_ingest_fn(ja, track_touch=True) if kernel == "sort"
           else jseg.make_ingest_fn(ja, track_touch=True))
    tfn = sorted_ingest if kernel == "sort" else tseg.ingest
    for _ in range(batches):
        kid, spos, vals = _batch(rng)
        jacc, jcount, jtouch = jfn(jacc, jcount, jnp.asarray(kid), jnp.asarray(spos),
                                   jnp.asarray(vals))
        lanes = tseg.stage_lanes(kid, spos, vals, K, S, torch.device("cpu"))
        tfn(ta, tacc, tcount, lanes)
    return (ja, jacc, jcount), (ta, tacc, tcount), jtouch, lanes


def _same_rings(jstate, tstate):
    _ja, jacc, jcount = jstate
    _ta, tacc, tcount = tstate
    np.testing.assert_array_equal(np.asarray(jcount), tcount.numpy().T)
    assert set(jacc) == set(tacc)
    for name in jacc:
        a, b = np.asarray(jacc[name]), tacc[name].numpy().T
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kernel", ["scatter", "sort"])
@pytest.mark.parametrize("agg", sorted(AGGS))
def test_ingest_matches_jax(agg, kernel):
    jstate, tstate, jtouch, lanes = _both(agg, np.random.default_rng(1), kernel=kernel)
    _same_rings(jstate, tstate)
    # the touch: the cells the last batch wrote
    dense = np.zeros((S, K), bool)
    dense[lanes.spos.numpy(), lanes.kid.numpy()] = True
    np.testing.assert_array_equal(np.asarray(jtouch), dense.T)


@pytest.mark.parametrize("agg", sorted(AGGS))
def test_sorted_ingest_gives_the_scatter_cells(agg):
    _j1, scatter, _t1, _l1 = _both(agg, np.random.default_rng(2), batches=3)
    _j2, sort, _t2, _l2 = _both(agg, np.random.default_rng(2), batches=3, kernel="sort")
    for name in scatter[1]:
        assert torch.equal(scatter[1][name], sort[1][name]), name
    assert torch.equal(scatter[2], sort[2])


@pytest.mark.parametrize("positions", [[2, 3, 4], [6, 7, 0, 1], [5], [0, 1, 2, 3, 4, 5, 6, 7]])
@pytest.mark.parametrize("agg", sorted(AGGS))
def test_fire_and_masked_fire_match_jax(agg, positions):
    jstate, tstate, jtouch, lanes = _both(agg, np.random.default_rng(3))
    ja, jacc, jcount = jstate
    ta, tacc, tcount = tstate
    pos = np.asarray(positions, np.int32)
    for masked in (False, True):
        jfire = jseg.make_fire_fn(ja, masked=masked)
        jout = (jfire(jacc, jcount, jnp.asarray(pos), jtouch) if masked
                else jfire(jacc, jcount, jnp.asarray(pos)))
        tout = tseg.fire(ta, tacc, tcount, positions, lanes if masked else None)
        jres, jcnt, jmask = (np.asarray(x) for x in jout)
        tres, tcnt, tmask = (x.numpy() for x in tout)
        np.testing.assert_array_equal(jmask, tmask)
        np.testing.assert_array_equal(jcnt, tcnt)
        assert jres.dtype == tres.dtype
        # rows of absent keys are meaningless (an empty mean divides 0 by 1)
        np.testing.assert_array_equal(jres[jmask], tres[tmask])
        if masked:
            assert tmask.sum() <= (tcnt > 0).sum()


@pytest.mark.parametrize("agg", sorted(AGGS))
def test_purge_matches_jax(agg):
    jstate, tstate, _jt, _l = _both(agg, np.random.default_rng(4))
    ja, jacc, jcount = jstate
    ta, tacc, tcount = tstate
    for chunk in ([7, 0, 1], [3], [5, 6]):
        pos = np.full(8, INV, np.int32)
        pos[:len(chunk)] = chunk
        jacc, jcount = jseg.make_purge_fn(ja, 8)(jacc, jcount, jnp.asarray(pos))
        tseg.purge(ta, tacc, tcount, pos)
        _same_rings((ja, jacc, jcount), (ta, tacc, tcount))


@pytest.mark.parametrize("agg", sorted(AGGS))
def test_grow_keys_matches_jax(agg):
    jstate, tstate, _jt, _l = _both(agg, np.random.default_rng(5))
    ja, jacc, jcount = jstate
    ta, tacc, tcount = tstate
    jacc, jcount = jseg.grow_keys(jacc, jcount, ja, 64)
    tacc, tcount = tseg.grow_keys(tacc, tcount, ta, 64)
    assert tcount.shape == (S, 64)
    _same_rings((ja, jacc, jcount), (ta, tacc, tcount))


def test_invalid_and_negative_lanes_contribute_nothing():
    agg = tagg.sum_agg()
    acc, count = tseg.init_state_arrays(agg, K, S, "cpu")
    kid = np.array([INV, -1, K, 2, 5], np.int32)
    spos = np.array([1, 1, 1, INV, 9], np.int32)
    lanes = tseg.stage_lanes(kid, spos, np.ones(5, np.float32), K, S, torch.device("cpu"))
    assert lanes.kid.numel() == 0
    tseg.ingest(agg, acc, count, lanes)
    assert int(count.sum()) == 0 and float(acc["sum"].sum()) == 0.0


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_masked_top_k_matches_jax(dtype):
    rng = np.random.default_rng(6)
    values = rng.permutation(200).astype(dtype) - 50      # distinct
    mask = rng.random(200) < 0.6
    jv, ji = jseg.masked_top_k(jnp.asarray(values), jnp.asarray(mask), 10)
    tv, ti = tseg.masked_top_k(torch.from_numpy(values), torch.from_numpy(mask), 10)
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())


@pytest.mark.parametrize("op", ["add", "min", "max"])
def test_bounded_segment_fold_matches_jax(op):
    rng = np.random.default_rng(7)
    vals = rng.integers(-100, 100, 500).astype(np.float32)
    seg = rng.integers(-1, 4, 500).astype(np.int32)
    ident = {"add": 0.0, "min": np.inf, "max": -np.inf}[op]
    j = jseg.bounded_segment_fold(jnp.asarray(vals), jnp.asarray(seg), 4, op, ident)
    t = tseg.bounded_segment_fold(torch.from_numpy(vals), torch.from_numpy(seg), 4, op, ident)
    np.testing.assert_array_equal(np.asarray(j), t.numpy())


def test_ring_runs_split_positions_at_the_wrap():
    assert tseg.ring_runs([6, 7, 0, 1]) == [(6, 8), (0, 2)]
    assert tseg.ring_runs([3, INV, INV]) == [(3, 4)]
    assert tseg.ring_runs([0, 1, 2, 3, 0]) == [(0, 4), (0, 1)]
