"""`chip_smoke.py`'s phases 18, 19 and 20 rehearsed on the CPU at small
sizes, and the references it carries held against the JAX package.

- api_latency (phase 18): the api_ysb program in throughput mode, in
  latency mode and pinned at every rung of the ladder gives the same rows,
  in order, equal to the numpy oracle's (`ok` stays false here: CPU runs
  launch no K1).
- api_oracle (phase 19): each oracle job against its numpy model; the SQL
  statement's plan report constant equals the JAX package's report.
- api_correlated (phase 20): the shared program, the independent one and
  the numpy model agree window by window; the wide group's arrays and
  latency mode's rows equal their references; the shared runner is
  selected; the K1 inputs of the shared dispatches carry their members'
  per-slot window lengths.
- C3: the rows the smoke expects of the fused operator's int sum on C3's
  inputs are the JAX operator's.

Tolerance: exact.
"""

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")

import chip_smoke as cm  # noqa: E402


def test_api_latency_phase_rows_equal_in_every_mode(monkeypatch):
    monkeypatch.setitem(cm.API, "batch", 1024)
    r = cm.api_latency_phase(dev="cpu", sizes=dict(cm.API_LATENCY, events=1 << 16,
                                                    warmup_events=1 << 12))
    assert r["parity"] and r["windows_checked"] > 60
    assert all(r["rows_equal_throughput"].values())
    assert set(r["pinned"]) == {2, 4, 8, 16, 32}
    assert 2 in r["pinned"][2]["depths"] and 32 in r["pinned"][32]["depths"]
    assert r["latency"]["gauges"]["latencyModeActive"] == 1
    assert r["throughput"]["gauges"] is None


def test_oracle_jobs_match_their_numpy_models():
    sz = dict(cm.API_ORACLE, keys=64,
              continuous_reduce=dict(cm.API_ORACLE["continuous_reduce"], events=3000),
              evictor_process=dict(cm.API_ORACLE["evictor_process"], events=4000))
    models = {"continuous_reduce": cm.continuous_reduce_model,
              "evictor_process": cm.evictor_process_model}
    for job, model in models.items():
        env, sink = cm.oracle_job(job, sz, "cpu")
        env.execute()
        got = []
        for values, tss in sink.batches:
            for row, t in zip(values, tss):
                start = int(t) + 1 - sz[job]["window"]
                got.append((int(row[0]), start, float(row[1][1]))
                           if job == "continuous_reduce" else tuple(row))
        want = model(sz)
        assert sorted(got) == want and len(want) > 50, job


def test_sql_multi_report_is_the_jax_packages():
    from flink_tpu.api.datastream import StreamExecutionEnvironment
    from flink_tpu.connectors.source import Batch, DataGeneratorSource
    from flink_tpu.core.watermarks import WatermarkStrategy
    from flink_tpu.table import TableEnvironment, TableSchema
    from flink_tpu_torch.testing import stream as st

    n = 1 << 12

    def gen(idx):
        return Batch(*st.api_columns(idx, n, 64, payload=True))

    env = StreamExecutionEnvironment.get_execution_environment()
    tenv = TableEnvironment(env)
    tenv.register_table("ysb", env.from_source(
        DataGeneratorSource(gen, n), WatermarkStrategy.for_bounded_out_of_orderness(0)),
        TableSchema(["campaign", "event_type", "x", "rowtime"], rowtime="rowtime",
                    field_types=["int", "float", "float", "int"]), columnar=True)
    tenv.sql_query(cm.SQL_MULTI)
    r = tenv.last_plan_report
    assert (r.path, r.reason, r.describe()) == cm.SQL_MULTI_REPORT
    _env, ptenv, _sink = cm.sql_multi_job(n, dict(cm.API_ORACLE, sql_batch=1024), "cpu")
    p = ptenv.last_plan_report
    assert (p.path, p.reason, p.describe()) == cm.SQL_MULTI_REPORT


def test_c3_rows_are_the_jax_operators():
    from flink_tpu.api.windowing.assigners import TumblingEventTimeWindows
    from flink_tpu.ops.aggregators import sum_agg
    from flink_tpu.runtime.fused_window_operator import FusedWindowOperator

    rows = []
    for vals in cm.C3_INPUTS:
        op = FusedWindowOperator(TumblingEventTimeWindows.of(1000), sum_agg(np.int64))
        op.process_batch(np.array([1, 1]), np.array(vals, np.float32), np.array([10, 20]))
        op.process_watermark(5000)
        op.flush_all()
        rows += [r for _k, _w, r, _t in op.drain_output()]
    assert rows == cm.C3_JAX_ROWS


def test_api_correlated_phase_agrees_on_every_leg():
    sz = dict(cm.API_CORRELATED, keys=256, batch=4096, parity_events=1 << 16,
              timed_events=1 << 15, warmup_events=1 << 12, runs=1, wide_keys=1 << 12,
              wide_events=1 << 16, latency_events=1 << 15)
    r = cm.api_correlated_phase(dev="cpu", sizes=sz)
    assert r["leg1"]["parity"] and r["shared_selected"]
    assert [m["windows_checked"] for m in r["leg1"]["members"]] == [121, 25, 3]
    assert r["leg2"]["equal"] and r["leg2"]["totals_ok"] and r["leg2"]["selected"]
    assert r["leg3"]["rows_equal_throughput"] and r["leg3"]["selected"]
    assert not r["ok"]          # CPU runs launch no K1


@pytest.mark.parametrize("members,spws,S", [
    ("DASHBOARD_WIDE", (1,) * 4 + (5,) * 4 + (15,) * 4 + (60,) * 4 + (10,) * 4, 128),
    ("UNSTAGED", (1,) * 4 + (1440,) * 4, 2048),
])
def test_shared_k1_inputs_carry_mixed_spws(members, spws, S):
    pipe, _agg, idx, _vals, plan = cm.correlated_k1_inputs(
        getattr(cm, members), 1 << 10, 1 << 22, batch=4096, dev="cpu")
    assert pipe.slot_spws() == spws and pipe.S == S and pipe.F == len(spws)
    assert idx.numel() == 32 * 4096 and len(plan[5]) > 0
    # 32 steps of 4096 of 2^22 records cover 225 s: the 1 min members fire
    assert 0 in {pf.spec for pf in plan[5]} <= set(range(len(pipe.specs)))
