"""The port's million-key state plane held against the JAX package's.

Each case feeds the same numpy-seeded inputs to both packages:

- `DynamicKeyVocabulary`: routing, would_evict, demotions, promotions and
  the op journal op for op (LRU and LFU, the doorkeeper, int and str
  keys); snapshots and op replays across the packages.
- `ColdKeyTier`: ingest, fire, fire_ids, absorb_rows, read_rows,
  clear_rows and purge array for array, on the native spill store and on
  the dict store; snapshots across the packages (the native manifest of
  one read by the other).
- `FsStateChangelog`: read range, trim, torn tail, truncate, reopened
  numbering, and one package replaying the other's log;
  `ChangelogKeyedStateBackend` replaying by sequence.
- `SpillableKeyedStateBackend` under pressure, and its typed errors.
- The tiered `FusedWindowOperator` under churn (sum, count, min, max;
  sliding and tumbling) against the JAX one and the untiered port; the
  doorkeeper and LFU; full and incremental (changelog) snapshots restored
  within and across the packages; the refusals; gauges.
- The hot/cold `TpuWindowOperator` against the JAX one, snapshots across.
- `query_state_for` against the JAX operator's.
- A `state.tier.*` DataStream job through both packages' env.execute(),
  with the fused path on and off, and chip_smoke's api_tiered legs A and B
  rehearsed at 2^14 records.

Tolerance: exact. Payloads are small integers, so every float32 partial
sum is exact whatever the add order.
"""

import os
import sys
import types

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")

import flink_tpu.utils.native_bridge as jnb
from flink_tpu.api.windowing import assigners as jasg
from flink_tpu.core.keygroups import KeyGroupRange as JKeyGroupRange
from flink_tpu.core.time import MAX_WATERMARK
from flink_tpu.ops import aggregators as jagg
from flink_tpu.runtime import fused_window_operator as jfo
from flink_tpu.runtime import fused_window_pipeline as jfp
from flink_tpu.runtime import tpu_window_operator as jtwo
from flink_tpu.state import changelog as jcl
from flink_tpu.state import cold_tier as jct
from flink_tpu.state import heap as jheap
from flink_tpu.state import spillable as jsp
from flink_tpu.state import tier_manager as jtm
from flink_tpu.state import vocab as jvo

import flink_tpu_torch.utils.native_bridge as tnb
from flink_tpu_torch.api.windowing import assigners as tasg
from flink_tpu_torch.core.keygroups import KeyGroupRange as TKeyGroupRange
from flink_tpu_torch.ops import aggregators as tagg
from flink_tpu_torch.runtime import fused_window_operator as tfo
from flink_tpu_torch.runtime import fused_window_pipeline as tfp
from flink_tpu_torch.runtime import tpu_window_operator as ttwo
from flink_tpu_torch.state import changelog as tcl
from flink_tpu_torch.state import cold_tier as tct
from flink_tpu_torch.state import heap as theap
from flink_tpu_torch.state import spillable as tsp
from flink_tpu_torch.state import tier_manager as ttm
from flink_tpu_torch.state import vocab as tvo

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PK = {
    "jax": types.SimpleNamespace(asg=jasg, agg=jagg, fo=jfo, fp=jfp, two=jtwo, cl=jcl, ct=jct,
                                 heap=jheap, sp=jsp, tm=jtm, vo=jvo, kgr=JKeyGroupRange,
                                 nb=jnb, kw={}),
    "port": types.SimpleNamespace(asg=tasg, agg=tagg, fo=tfo, fp=tfp, two=ttwo, cl=tcl, ct=tct,
                                  heap=theap, sp=tsp, tm=ttm, vo=tvo, kgr=TKeyGroupRange,
                                  nb=tnb, kw={"device": "cpu"}),
}
BOTH = ("jax", "port")
DIRECTIONS = [("jax", "port"), ("port", "jax"), ("port", "port")]


# ---------------------------------------------------------------------------
# the dynamic key vocabulary
# ---------------------------------------------------------------------------

def _key_batches(seed, kind, n_batches=30, batch=40, n_keys=90):
    """Skewed batches: a hot head and a long tail, so keys churn."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        k = np.where(rng.random(batch) < 0.5, rng.integers(0, 8, batch),
                     rng.integers(0, n_keys, batch))
        out.append(np.asarray([f"k{v}" for v in k], dtype=object) if kind == "str" else k)
    return out


def _routed(r):
    return (r.ids.tolist(), r.ids.dtype, r.cold_ids.tolist(), r.cold_ids.dtype,
            r.demotions, r.promotions)


@pytest.mark.parametrize("kind", ["int", "str"])
@pytest.mark.parametrize("policy,admission", [("lru", 1), ("lfu", 1), ("lru", 3), ("lfu", 2)])
def test_vocabulary_routes_op_for_op_like_jax(policy, admission, kind):
    vs = {p: PK[p].vo.DynamicKeyVocabulary(12, policy=policy, admission_min_count=admission)
          for p in BOTH}
    for keys in _key_batches(1, kind):
        # the port's would_evict is the JAX one's repaired (ROADMAP.md Queue
        # C): true wherever the JAX one is, and wherever a batch evicts
        will = vs["port"].would_evict(keys)
        assert will or not vs["jax"].would_evict(keys)
        routed = vs["port"].observe_batch(keys)
        assert will or not routed.demotions
        assert _routed(vs["jax"].observe_batch(keys)) == _routed(routed)
        assert vs["jax"].drain_ops() == vs["port"].drain_ops()
    assert vs["jax"].snapshot() == vs["port"].snapshot()
    v = vs["port"]
    assert v.num_evictions > 0 and v.num_promotions > 0 and v.resident_count <= 12
    assert v.vocab_size == vs["jax"].vocab_size


def test_would_evict_counts_the_keys_that_take_free_ids():
    """ROADMAP.md Queue C, a reference fault the port does not reproduce:
    with the doorkeeper on and free ids left, the JAX would_evict counts
    only the keys that pass the doorkeeper against the free ids. Keys 3 and
    4 (first sightings) take the two free ids, key 5's second sighting then
    evicts key 1, and the JAX operator does not flush first: the in-flight
    fire of window [0, 1000) resolves id 0 as key 5."""
    def run(p):
        op = _tiered(p, "tumbling", "count", hot_key_capacity=4, admission_min_count=2)
        op.T = 1
        op.process_batch(np.array([1, 2]), np.zeros(2, np.float32), np.array([100, 200]))
        op.process_watermark(999)
        assert len(op._inflight) == 1
        op.process_batch(np.array([3, 4, 5, 5]), np.zeros(4, np.float32),
                         np.array([1100, 1200, 1300, 1400]))
        assert op.tier.vocab.num_evictions == 1
        op.process_watermark(MAX_WATERMARK - 1)
        return sorted((k, w.start, v) for k, w, v, _ in op.drain_output())
    truth = [(1, 0, 1), (2, 0, 1), (3, 1000, 1), (4, 1000, 1), (5, 1000, 2)]
    assert run("port") == truth
    assert run("jax") == sorted([(5, 0, 1), (2, 0, 1)] + truth[2:])
    v = tvo.DynamicKeyVocabulary(4, admission_min_count=2)
    v.observe_batch(np.array([1, 2]))
    assert v.would_evict(np.array([3, 4, 5, 5]))
    assert not jvo.DynamicKeyVocabulary.restore(v.snapshot()).would_evict(
        np.array([3, 4, 5, 5]))


@pytest.mark.parametrize("src,dst", DIRECTIONS)
def test_vocabulary_snapshot_and_op_replay_cross_the_packages(src, dst):
    batches = _key_batches(2, "int")
    a = PK[src].vo.DynamicKeyVocabulary(10, admission_min_count=2)
    ref = PK[src].vo.DynamicKeyVocabulary(10, admission_min_count=2)
    replay = PK[dst].vo.DynamicKeyVocabulary(10, admission_min_count=2)
    for keys in batches[:15]:
        a.observe_batch(keys)
        ref.observe_batch(keys)
        replay.apply_ops(a.drain_ops())
    assert replay._resident == a._resident and replay._cold == a._cold
    assert replay.num_evictions == a.num_evictions > 0
    b = PK[dst].vo.DynamicKeyVocabulary.restore(a.snapshot())
    for keys in batches[15:]:
        assert _routed(b.observe_batch(keys)) == _routed(ref.observe_batch(keys))


# ---------------------------------------------------------------------------
# the cold tier
# ---------------------------------------------------------------------------

@pytest.fixture(params=["native", "dict"])
def store(request, monkeypatch):
    if request.param == "dict":
        def unavailable(*_a, **_k):
            raise RuntimeError("native library unavailable")
        for p in BOTH:
            monkeypatch.setattr(PK[p].nb, "NativeSpillStore", unavailable)
    return request.param


def _fields(f):
    return {k: (v.tolist(), v.dtype) for k, v in f.items()}


@pytest.mark.parametrize("agg", ["sum", "count", "min", "max", "mean"])
def test_cold_tier_matches_jax_array_for_array(store, agg, tmp_path):
    tiers = {p: PK[p].ct.ColdKeyTier(PK[p].agg.resolve(agg), 32, directory=str(tmp_path / p),
                                     purge_granularity=2, flush_threshold=300)
             for p in BOTH}
    assert {t.native for t in tiers.values()} == {store == "native"}
    rng = np.random.default_rng(5)
    nf = len(tiers["port"].fields)
    for step in range(8):
        ck = rng.integers(0, 40, 200)
        s = step * 2 + rng.integers(0, 3, 200)
        vals = rng.integers(-9, 10, 200).astype(np.float32)
        rows = rng.integers(-5, 6, (30, nf)).astype(np.float64)
        cnt = rng.integers(1, 4, 30).astype(np.float64)
        a_ck, a_s = rng.integers(0, 40, 30), step * 2 + rng.integers(0, 2, 30)
        cid, cleared = int(rng.integers(0, 40)), np.arange(step * 2, step * 2 + 2)
        got = {}
        for p, t in tiers.items():
            t.ingest(ck.astype(np.int64), s, vals)
            t.absorb_rows(a_ck, a_s, rows, cnt)
            read = t.read_rows(cid, np.arange(step * 2 - 1, step * 2 + 3))
            t.clear_rows(cid, cleared)
            res, counts = t.fire(40, range(step * 2 - 2, step * 2 + 3))
            f_ids, c_ids = t.fire_ids(np.arange(0, 40, 3), range(step * 2 - 2, step * 2 + 3))
            t.purge_below_slice(step * 2 - 4)
            got[p] = ([a.tolist() for a in read], res.tolist(), res.dtype, counts.tolist(),
                      _fields(f_ids), c_ids.tolist(), t.num_cold_rows_written,
                      t.num_cold_rows_purged, t.approx_bytes())
        assert got["jax"] == got["port"]
    assert tiers["port"].num_cold_rows_purged > 0


@pytest.mark.parametrize("src,dst", DIRECTIONS)
def test_cold_tier_snapshot_restores_across_the_packages(store, src, dst, tmp_path):
    agg = "mean"
    a = PK[src].ct.ColdKeyTier(PK[src].agg.resolve(agg), 32, directory=str(tmp_path / "a"))
    rng = np.random.default_rng(6)
    a.ingest(rng.integers(0, 30, 300), rng.integers(0, 6, 300),
             rng.integers(0, 9, 300).astype(np.float32))
    snap = a.snapshot()
    assert snap["native"] == (store == "native")
    b = PK[dst].ct.ColdKeyTier(PK[dst].agg.resolve(agg), 32, directory=str(tmp_path / "b"))
    b.restore(snap)
    for t in (a, b):
        t.ingest(np.arange(5), np.full(5, 2), np.ones(5, np.float32))
    ra, rb = a.fire(30, range(0, 6)), b.fire(30, range(0, 6))
    assert ra[0].tolist() == rb[0].tolist() and ra[1].tolist() == rb[1].tolist()
    assert rb[1].sum() == 305


def test_cold_tier_typed_errors_match_jax():
    for p in BOTH:
        st = PK[p].ct._PyStoreFallback(16)
        for bad in ("py:!!!not-base64!!!", "native-manifest-into-py-store"):
            with pytest.raises(PK[p].ct.ColdTierError):
                st.restore(bad)


def test_native_store_builds_beside_the_port_and_survives_parallel_builds(tmp_path):
    import subprocess

    path = tnb.library_path()
    # under build/, never in native/ where the JAX package's bridge writes
    assert path.parent == tnb.BUILD_DIR
    assert path.relative_to(ROOT).parts[:3] == ("build", "flink_tpu_torch", "native")
    code = ("import pathlib, sys; sys.path.insert(0, sys.argv[1]);"
            "import numpy as np; import flink_tpu_torch.utils.native_bridge as nb;"
            "nb.BUILD_DIR = pathlib.Path(sys.argv[2]);"
            "s = nb.NativeSpillStore(8, sys.argv[3]);"
            "s.put_batch(np.arange(3), np.arange(3, dtype=np.float64));"
            "print(s.get_batch(np.arange(4))[1].tolist())")
    procs = [subprocess.Popen([sys.executable, "-c", code, ROOT, str(tmp_path / "build"),
                               str(tmp_path / f"s{i}")], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for i in range(3)]
    for proc in procs:
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err
        assert out.strip() == "[True, True, True, False]"
    built = sorted(os.listdir(tmp_path / "build"))
    assert built == [path.name], built          # one library, no stray temp files


# ---------------------------------------------------------------------------
# the changelog
# ---------------------------------------------------------------------------

def _log_story(p, d):
    """One script of appends, reads, trims, a torn tail, reopens and a
    truncate; everything it observes."""
    cl = PK[p].cl
    log = cl.FsStateChangelog(d, segment_bytes=96)
    seen = []
    for i in range(12):
        seen.append(log.append(("live" if i < 8 else "orphan", i, np.arange(i % 3))))
    seen.append([(s, e[0], e[1]) for s, e in log.read_entries(3, 7)])
    seen.append([e[1] for e in log.read_from(9)])
    seen.append(log.trim_above(8))
    seen.append(log.append(("new", 99, None)))
    log.truncate(5)
    seen.append(sorted(os.listdir(d)))
    seen.append([(s, e[0]) for s, e in log.read_entries(0)])
    seg = os.path.join(d, sorted(f for f in os.listdir(d) if f.startswith("seg-"))[-1])
    with open(seg, "ab") as f:
        f.write((250).to_bytes(4, "big") + b"torn")          # a crash mid-append
    again = cl.FsStateChangelog(d)
    seen.append(again.offset)
    seen.append([(s, e[0]) for s, e in again.read_entries(0)])
    seen.append(again.append(("after", 0, None)))
    return seen


def test_changelog_read_range_trim_and_torn_tail_like_jax(tmp_path):
    got = {p: _log_story(p, str(tmp_path / p)) for p in BOTH}
    assert got["jax"] == got["port"]
    # each package reads the other's segments
    for reader, writer in (("port", "jax"), ("jax", "port")):
        a = PK[reader].cl.FsStateChangelog(str(tmp_path / writer)).read_entries(0)
        b = PK[writer].cl.FsStateChangelog(str(tmp_path / writer)).read_entries(0)
        assert [(s, e[0], e[1]) for s, e in a] == [(s, e[0], e[1]) for s, e in b]


def _heap(p, max_parallelism=8):
    b = PK[p].heap.HeapKeyedStateBackend(PK[p].kgr(0, max_parallelism - 1), max_parallelism)
    b.register(PK[p].heap.StateDescriptor("v", "value"))
    b.register(PK[p].heap.reducing_state("r", lambda a, c: a + c))
    return b


@pytest.mark.parametrize("p", BOTH)
def test_changelog_backend_replays_by_sequence_not_position(p, tmp_path):
    cl = PK[p].cl
    d = str(tmp_path)
    cb = cl.ChangelogKeyedStateBackend(_heap(p), cl.FsStateChangelog(d))
    cb.set_current_key("a")
    cb.add("r", 10)
    cp1 = cb.checkpoint()
    cb.add("r", 5)             # the dead timeline
    cb.add("r", 7)
    r = cl.ChangelogKeyedStateBackend(_heap(p), cl.FsStateChangelog(d))
    r.restore(cp1)
    r.set_current_key("a")
    assert r.get("r") == 10
    r.add("r", 100)
    cp2 = r.checkpoint()
    r2 = cl.ChangelogKeyedStateBackend(_heap(p), cl.FsStateChangelog(d))
    r2.restore(cp2)
    r2.set_current_key("a")
    assert r2.get("r") == 110


# ---------------------------------------------------------------------------
# the spillable heap backend
# ---------------------------------------------------------------------------

def test_spillable_backend_matches_jax(tmp_path):
    got = {}
    for p in BOTH:
        sp = PK[p].sp.SpillableKeyedStateBackend(_heap(p), max_entries_in_memory=4,
                                                 spill_dir=str(tmp_path / p))
        seen = []
        for k in range(16):
            sp.set_current_key(k)
            sp.put("v", k * 10)
            sp.add("r", k)
            seen.append(sorted(sp._spilled))
        for k in range(16):
            sp.set_current_key(k)
            seen.append((sp.get("v"), sp.get("r")))
        seen.append((sp.num_spills, sp.num_faults, sorted(sp.keys("v"))))
        r = PK[p].sp.SpillableKeyedStateBackend(_heap(p), max_entries_in_memory=4,
                                                spill_dir=str(tmp_path / f"{p}-r"))
        r.restore(sp.snapshot(), {"v": PK[p].heap.StateDescriptor("v", "value")})
        r.set_current_key(7)
        seen.append(r.get("v"))
        got[p] = seen
    assert got["jax"] == got["port"]
    assert got["port"][-2][0] > 0 and got["port"][-1] == 70


@pytest.mark.parametrize("damage", ["missing", "corrupt"])
def test_spillable_lost_artifact_is_a_typed_error(damage, tmp_path):
    sp = tsp.SpillableKeyedStateBackend(_heap("port"), max_entries_in_memory=2,
                                        spill_dir=str(tmp_path))
    for k in range(12):
        sp.set_current_key(k)
        sp.put("v", k)
    kg, path = next(iter(sp._spilled.items()))
    if damage == "missing":
        os.unlink(path)
    else:
        with open(path, "wb") as f:
            f.write(b"\x80garbage-not-a-pickle")
    with pytest.raises(tsp.SpillReadError):
        sp._fault_in(kg)
    assert kg in sp._spilled


# ---------------------------------------------------------------------------
# the tiered fused window operator
# ---------------------------------------------------------------------------

WINDOWS = {"tumbling": lambda a: a.TumblingEventTimeWindows.of(1000),
           "sliding": lambda a: a.SlidingEventTimeWindows.of(2000, 500)}


def _tiered(p, window, agg, **tier):
    return PK[p].fo.FusedWindowOperator(WINDOWS[window](PK[p].asg), agg, superbatch_steps=8,
                                        tier=PK[p].tm.TierConfig(**tier), **PK[p].kw)


def _untiered(p, window, agg):
    return PK[p].fo.FusedWindowOperator(WINDOWS[window](PK[p].asg), agg, key_capacity=1024,
                                        superbatch_steps=8, **PK[p].kw)


def _batches(seed=7, steps=40, n_keys=200, batch=64):
    r = np.random.default_rng(seed)
    out = []
    for s in range(steps):
        keys = r.integers(0, n_keys, batch)
        vals = (keys % 5 + 1).astype(np.float32)
        ts = (s * 250 + r.integers(0, 250, batch)).astype(np.int64)
        out.append((keys, vals, ts, s * 250 + 125))
    return out


def _rows(out):
    return sorted((int(k), int(w.start), float(v)) for k, w, v, _ in out)


def _feed(op, batches, snap_at=()):
    """Rows in emission order, and the snapshots taken after the batches
    numbered in snap_at."""
    out, snaps = [], []
    for i, (keys, vals, ts, wm) in enumerate(batches):
        op.process_batch(keys, vals, ts)
        op.process_watermark(wm)
        out.extend(op.drain_output())
        if i in snap_at:
            snaps.append(op.snapshot())
            out.extend(op.drain_output())
    return out, snaps


def _finish(op, batches):
    out, _ = _feed(op, batches)
    op.process_watermark(MAX_WATERMARK - 1)
    return out + op.drain_output()


def _emitted(out):
    return [(k, w.start, w.end, v, type(v), t) for k, w, v, t in out]


@pytest.mark.parametrize("window", ["sliding", "tumbling"])
@pytest.mark.parametrize("agg", ["sum", "count", "min", "max"])
def test_tiered_operator_emits_the_jax_rows_under_churn(agg, window):
    batches = _batches()
    ops = {p: _tiered(p, window, agg, hot_key_capacity=32) for p in BOTH}
    out = {p: _finish(op, batches) for p, op in ops.items()}
    assert _emitted(out["port"]) == _emitted(out["jax"])
    assert _rows(out["port"]) == _rows(_finish(_untiered("port", window, agg), batches))
    t = ops["port"].tier
    assert t.vocab.num_evictions > 0 and t.num_promoted_rows > 0 and t.num_demoted_rows > 0
    assert t.vocab.resident_count <= 32 and ops["port"].pipe.K == 32
    assert ops["port"].tier_gauges() == ops["jax"].tier_gauges()
    assert ops["port"].tier_payload() == ops["jax"].tier_payload()
    assert ops["port"].state_key_count() == ops["jax"].state_key_count() == 200


@pytest.mark.parametrize("tier", [dict(hot_key_capacity=32, admission_min_count=3),
                                  dict(hot_key_capacity=24, eviction_policy="lfu")],
                         ids=["doorkeeper", "lfu"])
def test_tiered_operator_policies_emit_the_jax_rows(tier):
    batches = _batches(seed=3)
    ops = {p: _tiered(p, "sliding", "sum", **tier) for p in BOTH}
    out = {p: _finish(op, batches) for p, op in ops.items()}
    assert _emitted(out["port"]) == _emitted(out["jax"])
    assert ops["port"].tier.num_cold_records > 0


def _changelog_tier(d, cold):
    return dict(hot_key_capacity=32, changelog_enabled=True, changelog_dir=d,
                materialize_interval=3, cold_dir=cold)


@pytest.mark.parametrize("kind", ["full", "changelog"])
@pytest.mark.parametrize("src,dst", DIRECTIONS)
def test_tiered_snapshot_restores_within_and_across_the_packages(src, dst, kind, tmp_path):
    batches = _batches(steps=36)
    tier = (dict(hot_key_capacity=32, cold_dir=str(tmp_path / "cold")) if kind == "full"
            else _changelog_tier(str(tmp_path / "log"), str(tmp_path / "cold")))
    first = _tiered(src, "sliding", "sum", **tier)
    pre, snaps = _feed(first, batches[:24], snap_at=(7, 15, 23))   # the last is restored
    snap = snaps[-1]
    assert ("tier_changelog" in snap) == (kind == "changelog")
    if kind == "changelog":
        assert first.tier.interval_bytes_history and first.tier.last_base_bytes() > 0
    # the restored operator (either package), twice: a restart loop is stable
    rest = [_finish(_restored(dst, tier, snap), batches[24:]) for _ in range(2)]
    assert _rows(rest[0]) == _rows(rest[1])
    ref = _rows(_finish(_untiered("port", "sliding", "sum"), batches))
    assert sorted(set(_rows(pre)) | set(_rows(rest[0]))) == sorted(set(ref))
    # and the same continuation as the source package's own restore
    if src != dst:
        assert _rows(_finish(_restored(src, tier, snap), batches[24:])) == _rows(rest[0])


def _restored(p, tier, snap):
    op = _tiered(p, "sliding", "sum", **tier)
    op.restore(snap)
    return op


def test_tiered_refusals_match_jax():
    for p in BOTH:
        fo, tm, asg = PK[p].fo, PK[p].tm, PK[p].asg
        with pytest.raises(ValueError, match="host key dictionary"):
            fo.FusedWindowOperator(asg.TumblingEventTimeWindows.of(1000), "count",
                                   prologue=PK[p].fp.TracedPrologue(transforms=(),
                                                                    key_fn=lambda c: c),
                                   tier=tm.TierConfig(hot_key_capacity=32), **PK[p].kw)
        with pytest.raises(ValueError):
            fo.FusedWindowOperator(None, "count", assigners=[asg.TumblingEventTimeWindows.of(1000)],
                                   tier=tm.TierConfig(hot_key_capacity=32), **PK[p].kw)
    for src, dst in DIRECTIONS:
        tiered = _tiered(src, "tumbling", "sum", hot_key_capacity=32)
        tiered.process_batch(np.asarray([1, 2]), np.ones(2, np.float32),
                             np.asarray([100, 200], np.int64))
        with pytest.raises(RuntimeError, match="tier"):
            _untiered(dst, "tumbling", "sum").restore(tiered.snapshot())
        plain = _untiered(src, "tumbling", "sum")
        plain.process_batch(np.asarray([1, 2]), np.ones(2, np.float32),
                            np.asarray([100, 200], np.int64))
        with pytest.raises(RuntimeError, match="classic"):
            _tiered(dst, "tumbling", "sum", hot_key_capacity=32).restore(plain.snapshot())


# ---------------------------------------------------------------------------
# queryable state
# ---------------------------------------------------------------------------

def test_query_state_for_matches_jax():
    batches = _batches(seed=9, steps=20, n_keys=40)
    ops = {p: PK[p].fo.FusedWindowOperator(WINDOWS["sliding"](PK[p].asg), "mean",
                                           key_capacity=64, superbatch_steps=8, **PK[p].kw)
           for p in BOTH}
    for i, (keys, vals, ts, wm) in enumerate(batches):
        for op in ops.values():
            op.process_batch(keys, vals, ts)
            op.process_watermark(wm)
        if i % 3 == 2:     # some steps buffered, some dispatched
            for key in (0, 5, 17, 39, 1000):
                assert ops["port"].query_state_for(key) == ops["jax"].query_state_for(key)
    assert ops["port"].query_state_for(5)
    for p in BOTH:
        tiered = _tiered(p, "sliding", "sum", hot_key_capacity=8)
        with pytest.raises(RuntimeError, match="tiered path"):
            tiered.query_state_for(1)
    traced = tfo.FusedWindowOperator(WINDOWS["sliding"](tasg), "count", device="cpu",
                                     prologue=tfp.TracedPrologue(transforms=(),
                                                                 key_fn=lambda c: c))
    with pytest.raises(RuntimeError, match="fused chain path"):
        traced.query_state_for(1)


# ---------------------------------------------------------------------------
# the hot/cold per-batch operator
# ---------------------------------------------------------------------------

def _hot_cold(p, agg, columnar=False, **kw):
    return PK[p].two.TpuWindowOperator(PK[p].asg.SlidingEventTimeWindows.of(4000, 2000), agg,
                                       key_capacity=64, hot_key_capacity=8, num_slices=32,
                                       columnar_output=columnar, **kw, **PK[p].kw)


def _hot_cold_feed(op, seed=11, steps=10, lo=0):
    rng = np.random.default_rng(seed)
    out = []
    for step in range(steps):
        keys = np.asarray([f"k{v}" for v in rng.integers(0, 40, 64)], dtype=object)
        vals = rng.integers(1, 9, 64).astype(np.float32)
        ts = (step * 1000 + rng.integers(0, 1000, 64)).astype(np.int64)
        if step < lo:
            continue
        op.process_batch(keys, vals, ts)
        op.process_watermark(step * 1000 + 500)
        out.extend(op.drain_output())
    return out


def _norm_hot_cold(out):
    rows = []
    for k, w, v, t in out:
        if k is None:
            v = (v[0].tolist(), v[1].tolist(), v[1].dtype)
        rows.append((k, w.start, w.end, v, t))
    return rows


@pytest.mark.parametrize("columnar", [False, True], ids=["rows", "columnar"])
@pytest.mark.parametrize("agg", ["sum", "count", "max"])
def test_hot_cold_window_operator_matches_jax(agg, columnar):
    ops = {p: _hot_cold(p, agg, columnar) for p in BOTH}
    out = {}
    for p, op in ops.items():
        out[p] = _hot_cold_feed(op)
        op.process_watermark(1 << 62)
        out[p] += op.drain_output()
    assert _norm_hot_cold(out["port"]) == _norm_hot_cold(out["jax"])
    assert ops["port"].cold_tier.num_cold_rows_written > 0


@pytest.mark.parametrize("src,dst", DIRECTIONS)
def test_hot_cold_snapshot_restores_across_the_packages(src, dst):
    a = _hot_cold(src, "sum")
    pre = _hot_cold_feed(a, steps=5)
    b = _hot_cold(dst, "sum", cold_tier_dir=a.cold_tier.dir)
    b.restore(a.snapshot())
    post = _hot_cold_feed(b, steps=10, lo=5)
    b.process_watermark(1 << 62)
    post += b.drain_output()
    ref = _hot_cold("jax", "sum")
    want = _hot_cold_feed(ref)
    ref.process_watermark(1 << 62)
    want += ref.drain_output()
    assert sorted(_norm_hot_cold(pre + post)) == sorted(_norm_hot_cold(want))


def test_hot_cold_refuses_allowed_lateness_like_jax():
    for p in BOTH:
        with pytest.raises(ValueError, match="allowed_lateness"):
            _hot_cold(p, "sum", allowed_lateness=1000)


# ---------------------------------------------------------------------------
# the DataStream job (state.tier.* through env.execute())
# ---------------------------------------------------------------------------

def _job(p, fused, tiered, n=1 << 13, n_keys=1 << 11, batch=1024):
    from importlib import import_module

    m = {name: import_module(f"{'flink_tpu' if p == 'jax' else 'flink_tpu_torch'}.{name}")
         for name in ("api.datastream", "config", "connectors.sink", "connectors.source",
                      "core.watermarks")}
    from flink_tpu_torch.testing import stream as st

    conf = {"execution.step.batch-size": batch, "execution.state.key-capacity": n_keys,
            "execution.window.fused": fused}
    if tiered:
        conf.update({"state.tier.enabled": True, "state.tier.hot-key-capacity": 128,
                     "state.tier.admission-min-count": 2})
    cfg = m["config"].Configuration(conf)
    env = m["api.datastream"].StreamExecutionEnvironment(cfg, **PK[p].kw)
    src = m["connectors.source"]
    sink = m["connectors.sink"].CollectSink()
    (env.from_source(src.DataGeneratorSource(
        lambda idx: src.Batch(*st.millikey_columns(idx, n, n_keys, True)), n),
        m["core.watermarks"].WatermarkStrategy.for_bounded_out_of_orderness(0))
     .key_by(lambda c: c, vectorized=True)
     .window(PK[p].asg.SlidingEventTimeWindows.of(10_000, 1_000)).count().sink_to(sink))
    env.execute()
    return sorted(sink.results)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "per_batch"])
def test_tiered_datastream_job_through_both_packages(fused):
    from flink_tpu_torch.testing import stream as st

    got = _job("port", fused, True)
    assert got == _job("jax", fused, True) == _job("port", fused, False)
    assert got == st.millikey_oracle(1 << 13, 1 << 11, True)


def test_tier_options_build_the_jax_tier_config():
    from flink_tpu.config import Configuration as JConf
    from flink_tpu.runtime.executor import _tier_for_config as jtier
    from flink_tpu_torch.config import Configuration as TConf
    from flink_tpu_torch.runtime.executor import _tier_for_config as ttier

    conf = {"state.tier.enabled": True, "state.tier.hot-key-capacity": 64,
            "state.tier.eviction-policy": "lfu", "state.tier.admission-min-count": 3,
            "state.tier.cold-dir": "/x/cold", "state.changelog.enabled": True,
            "state.changelog.dir": "/x/log", "state.changelog.materialize-interval": 5,
            "state.changelog.retained-bases": 2}
    assert vars(ttier(TConf(conf))) == vars(jtier(JConf(conf)))
    assert ttier(TConf()) is None and jtier(JConf()) is None


def test_chip_smoke_api_tiered_legs_rehearsed_small():
    sys.path.insert(0, ROOT)
    import chip_smoke

    sizes = dict(chip_smoke.API_TIERED, batch=2048, parity_events=1 << 14,
                 parity_keys=1 << 13, events=1 << 14, keys=1 << 20, hot=256, runs=1)
    out = chip_smoke.api_tiered_phase(dev="cpu", sizes=sizes)
    for label in ("uniform", "zipf"):
        a, b = out["leg_a"][label], out["leg_b"][label]
        assert a["parity_vs_untiered"] and a["parity_vs_oracle"] and a["evictions"] > 0
        assert b["parity"] and b["resident_bounded"] and b["native"] and b["cold_records"] > 0
        assert a["fused_selected"] and b["fused_selected"]
        # the CPU runs take K1's plain version, which launches nothing
        assert b["k1_launches"] == 0 and not out["ok"]
    assert out["leg_b"]["zipf"]["evictions"] > 0
