"""The per-batch device programs and operators on the card against the
port's CPU path on the same inputs.

They need an NVIDIA GPU, so they carry the `cuda` marker and skip
elsewhere. Run them on the card with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_per_batch.py

Covered: `ops/segment_ops.py` (ingest with out-of-range lanes, fire,
masked fire, purge, key growth, `masked_top_k`, `bounded_segment_fold`),
`ops/sorted_ingest.py`, the global count step, the group-agg step, then
`TpuWindowOperator` over the lateness stream (also against
`LatenessOracle`), `TpuGlobalWindowOperator`, `GroupAggRunner` and a
DataStream job with allowed lateness and a late side output.

Tolerance: exact. Payloads are small integers, so float32 sums are exact
in any order of the atomics.
"""

import numpy as np
import pytest
import torch

from flink_tpu_torch.api.windowing.assigners import SlidingEventTimeWindows
from flink_tpu_torch.ops import aggregators as agg_mod
from flink_tpu_torch.ops import segment_ops as so
from flink_tpu_torch.ops.sorted_ingest import sorted_ingest
from flink_tpu_torch.runtime import group_agg_operator as ga
from flink_tpu_torch.runtime import tpu_global_window_operator as gw
from flink_tpu_torch.runtime.tpu_window_operator import TpuWindowOperator
from flink_tpu_torch.testing import stream as st

pytestmark = pytest.mark.cuda

K, S, B = 1 << 16, 64, 1 << 18
CPU = torch.device("cpu")
AGGS = {"count": agg_mod.count_agg, "sum": agg_mod.sum_agg, "min": agg_mod.min_agg,
        "max": agg_mod.max_agg, "mean": agg_mod.mean_agg}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _lanes(seed, b=B, k=K):
    rng = np.random.default_rng(seed)
    kid = np.where(rng.random(b) < 0.3, 7, rng.integers(0, k, b)).astype(np.int32)
    spos = rng.integers(0, S, b).astype(np.int32)
    bad = rng.random(b) < 0.05
    kid[bad] = rng.choice([int(so.INVALID_INDEX), -1, k, k + 5], int(bad.sum()))
    return kid, spos, rng.integers(0, 256, b).astype(np.float32)


def _rings_equal(a, b):
    (acc_a, cnt_a), (acc_b, cnt_b) = a, b
    assert torch.equal(cnt_a.cpu(), cnt_b)
    for name in acc_b:
        assert torch.equal(acc_a[name].cpu(), acc_b[name]), name


@pytest.mark.parametrize("kernel", ["scatter", "sort"])
@pytest.mark.parametrize("name", sorted(AGGS))
def test_ingest_fire_purge_match_the_cpu(cuda, name, kernel):
    agg = AGGS[name]()
    ingest = sorted_ingest if kernel == "sort" else so.ingest
    states = {d: so.init_state_arrays(agg, K, S, d) for d in (cuda, CPU)}
    touch = {}
    for seed in range(3):
        kid, spos, vals = _lanes(seed)
        for d, (acc, cnt) in states.items():
            touch[d] = so.stage_lanes(kid, spos, vals, K, S, d)
            ingest(agg, acc, cnt, touch[d])
    _rings_equal(states[cuda], states[CPU])
    for positions in ([60, 61, 62, 63, 0, 1, 2, 3, 4, 5], list(range(10))):
        for masked in (False, True):
            outs = {d: so.fire(agg, *states[d], positions, touch[d] if masked else None)
                    for d in (cuda, CPU)}
            res_c, cnt_c, mask_c = (x.cpu() for x in outs[cuda])
            res, cnt, mask = outs[CPU]
            assert torch.equal(mask_c, mask) and torch.equal(cnt_c, cnt)
            assert torch.equal(res_c[mask], res[mask])
    for d in (cuda, CPU):
        so.purge(agg, *states[d], [62, 63, 0, 1, int(so.INVALID_INDEX)])
    _rings_equal(states[cuda], states[CPU])
    grown = {d: so.grow_keys(*states[d], agg, 2 * K) for d in (cuda, CPU)}
    _rings_equal(grown[cuda], grown[CPU])


def test_small_folds_match_the_cpu(cuda):
    rng = np.random.default_rng(1)
    values = torch.from_numpy(rng.permutation(1 << 16).astype(np.float32))
    mask = torch.from_numpy(rng.random(1 << 16) < 0.5)
    got = so.masked_top_k(values.to(cuda), mask.to(cuda), 100)
    want = so.masked_top_k(values, mask, 100)
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
    seg = torch.from_numpy(rng.integers(-1, 8, 1 << 16).astype(np.int32))
    for op, ident in (("add", 0.0), ("min", float("inf")), ("max", float("-inf"))):
        vals = torch.from_numpy(rng.integers(-9, 9, 1 << 16).astype(np.float32))
        got = so.bounded_segment_fold(vals.to(cuda), seg.to(cuda), 8, op, ident)
        assert torch.equal(got.cpu(), so.bounded_segment_fold(vals, seg, 8, op, ident))


@pytest.mark.parametrize("purge", [True, False])
def test_global_count_step_matches_the_cpu(cuda, purge):
    agg = agg_mod.sum_agg()
    state = {}
    for d in (cuda, CPU):
        state[d] = ({"sum": torch.zeros(K, device=d)}, torch.zeros(K, dtype=torch.int32, device=d),
                    torch.zeros(K, dtype=torch.int32, device=d))
    for seed in range(3):
        kid, _spos, vals = _lanes(seed)
        vals = vals % 8          # the hot key's sums stay below 2^24: exact
        ok = (kid >= 0) & (kid < K)
        outs = {d: gw.step(agg, *state[d], torch.from_numpy(kid[ok]).to(d),
                           torch.from_numpy(vals[ok]).to(d), 5, purge) for d in (cuda, CPU)}
        assert torch.equal(outs[cuda][1].cpu(), outs[CPU][1])
        m = outs[CPU][1]
        assert torch.equal(outs[cuda][0].cpu()[m], outs[CPU][0][m])
        for a, b in zip(state[cuda], state[CPU]):
            a = a["sum"] if isinstance(a, dict) else a
            b = b["sum"] if isinstance(b, dict) else b
            assert torch.equal(a.cpu(), b)


def test_group_agg_step_matches_the_cpu(cuda):
    rng = np.random.default_rng(4)
    cap, L, b = 1 << 16, 3, 1 << 16
    st_ = {d: (torch.zeros(cap, dtype=torch.int32, device=d),
               torch.zeros((L, cap), device=d), torch.zeros((L, cap), dtype=torch.int32, device=d))
           for d in (cuda, CPU)}
    for _ in range(3):
        slots = rng.integers(0, cap, b).astype(np.int32)
        signs = np.where(rng.random(b) < 0.1, -1, 1).astype(np.int32)
        vals = rng.integers(0, 100, (L, b)).astype(np.float32)
        nn = (rng.random((L, b)) < 0.9).astype(np.int32)
        uniq = np.unique(slots)
        outs = {}
        for d in (cuda, CPU):
            args = [torch.from_numpy(x).to(d) for x in (slots, signs, vals, nn)]
            outs[d] = ga.device_step(*st_[d], *args, torch.from_numpy(uniq).long().to(d))
        assert all(torch.equal(x.cpu(), y) for x, y in zip(outs[cuda], outs[CPU]))


def _late_run(dev, K_, B_, batches, kernel="scatter"):
    op = TpuWindowOperator(SlidingEventTimeWindows.of(10_000, 1_000), "sum",
                           allowed_lateness=2000, emit_late_to_side_output=True,
                           columnar_output=True, dense_int_keys=True, key_capacity=K_,
                           ingest_kernel=kernel, device=dev)
    out, mx = [], None
    for b in range(batches):
        k, ts, v = st.late_records(np.arange(b * B_, (b + 1) * B_, dtype=np.int64), B_, K_)
        op.process_batch(k, v, ts)
        mx = int(ts.max()) if mx is None else max(mx, int(ts.max()))
        op.process_watermark(mx - st.LATE_WM_LAG_MS)
        out += [(w.start, np.asarray(ids), np.asarray(vals))
                for _k, w, (ids, vals), _t in op.drain_output()]
    return out, op


@pytest.mark.parametrize("kernel", ["scatter", "sort"])
def test_window_operator_matches_the_cpu_and_the_oracle(cuda, kernel):
    K_, B_, n = 1 << 16, 1 << 16, 8
    got, op = _late_run(cuda, K_, B_, n, kernel)
    want, cop = _late_run(CPU, K_, B_, n, kernel)
    assert len(got) == len(want) > 0
    for (ws, ids, vals), (cs, cids, cvals) in zip(got, want):
        assert ws == cs and np.array_equal(ids, cids) and np.array_equal(vals, cvals)
    assert op.side_output == cop.side_output
    orc = st.LatenessOracle(10_000, 1_000, 2000, K_)
    events, mx = [], None
    for b in range(n):
        k, ts, v = st.late_records(np.arange(b * B_, (b + 1) * B_, dtype=np.int64), B_, K_)
        mx = int(ts.max()) if mx is None else max(mx, int(ts.max()))
        events += orc.step(k, ts, v, mx - st.LATE_WM_LAG_MS)[0]
    assert [(j * 1000, ks.tolist(), vs.tolist()) for _kind, j, ks, vs in events] == \
        [(ws, ids.tolist(), vals.astype(np.float64).tolist()) for ws, ids, vals in got]


@pytest.mark.parametrize("purging", [True, False])
def test_global_window_operator_matches_the_cpu(cuda, purging):
    outs = {}
    for d in (cuda, CPU):
        op = gw.TpuGlobalWindowOperator("sum", count_n=64, purging=purging,
                                        dense_int_keys=True, key_capacity=1024, device=d)
        rows = []
        for seed in range(4):
            kid, _s, vals = _lanes(seed, b=1 << 16, k=1 << 12)
            ok = (kid >= 0) & (kid < 1 << 12)
            op.process_batch(kid[ok].astype(np.int64), vals[ok], np.zeros(int(ok.sum())))
            rows += op.drain_output()
        outs[d.type] = [(k, r) for k, _w, r, _t in rows]
    assert outs["cuda"] == outs["cpu"] and len(outs["cpu"]) > 0


def test_group_agg_runner_matches_the_cpu(cuda):
    from flink_tpu_torch.config import Configuration
    from flink_tpu_torch.graph.transformation import Step, Transformation
    from flink_tpu_torch.table.changelog import DELETE, with_kind
    from flink_tpu_torch.utils.arrays import obj_array

    rng = np.random.default_rng(9)
    live, rows = [], []
    for _ in range(20_000):
        if live and rng.random() < 0.1:
            rows.append(with_kind(live.pop(int(rng.integers(len(live)))), DELETE))
        else:
            live.append({"k": int(rng.integers(0, 3000)), "v": float(rng.integers(0, 50))})
            rows.append(dict(live[-1]))

    class Sink:
        def __init__(self):
            self.rows = []

        def on_batch(self, vals, ts):
            self.rows += vals.tolist()

    outs = {}
    for name, dev, device in (("cuda", cuda, True), ("host", CPU, False)):
        t = Transformation("group_agg", "ga", [], {
            "key_selector": lambda r: r["k"], "key_fields": ["k"],
            "specs": [("COUNT", None), ("SUM", "v"), ("AVG", "v")], "out_names": ["c", "s", "a"],
            "mini_batch": True, "device": device})
        r = ga.GroupAggRunner(Step(chain=[], terminal=t, partitioning="forward", inputs=[]),
                              Configuration(), dev)
        r.downstream = Sink()
        for lo in range(0, len(rows), 4096):
            r.on_batch(obj_array(rows[lo:lo + 4096]), np.arange(lo, min(lo + 4096, len(rows))))
        outs[name] = r.downstream.rows
    assert len(outs["cuda"]) == len(outs["host"]) > 0
    for a, b in zip(outs["cuda"], outs["host"]):
        assert (a["k"], a["c"], a["s"]) == (b["k"], b["c"], b["s"])
        assert a["a"] == pytest.approx(b["a"], rel=1e-6)


def test_lateness_job_on_the_card_matches_the_cpu(cuda):
    from flink_tpu_torch.api.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.api.functions import LATE_DATA_TAG
    from flink_tpu_torch.config import Configuration, ExecutionOptions
    from flink_tpu_torch.connectors.source import Batch, DataGeneratorSource
    from flink_tpu_torch.core.watermarks import WatermarkStrategy

    outs = {}
    for dev in ("cuda", "cpu"):
        cfg = Configuration()
        cfg.set(ExecutionOptions.BATCH_SIZE, 8192)
        cfg.set(ExecutionOptions.KEY_CAPACITY, 1024)
        env = StreamExecutionEnvironment(cfg, device=dev)
        counted = (env.from_source(
            DataGeneratorSource(lambda idx: Batch(*st.late_columns(idx, 8192, 1024)), 1 << 17),
            WatermarkStrategy.for_bounded_out_of_orderness(500))
            .filter(lambda c: c[:, 1] < 0.5, traceable=True)
            .key_by(lambda c: c[:, 0].to(torch.int32), traceable=True)
            .window(SlidingEventTimeWindows.of(10_000, 1_000)).allowed_lateness(2000)
            .side_output_late_data().count())
        sink = counted.collect()
        late = counted.get_side_output(LATE_DATA_TAG).collect()
        env.execute()
        outs[dev] = (sink.results, late.results)
    assert outs["cuda"] == outs["cpu"] and len(outs["cpu"][0]) > 0 and len(outs["cpu"][1]) > 0
