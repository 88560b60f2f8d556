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
- api_mesh (phase 24): every leg's parity on four CPU shards (the mesh,
  local-combine, one device and the numpy model; leg B's oracle, live
  rescale and savepoint restores; the sharded operator and join), and
  the exchanged K1 inputs of shard 0 (`ok` stays false: no K1 launch).
- api_metrics (phase 25): leg A's checks but K1's launch (the rows, the
  numpy model, numRecordsIn, marker histograms, the emission count
  against the fires, device sections, checkpoint gauges and spans, the
  reports' keys, the JAX package's), with the coordinator's and the
  history's `due` held true so their counts do not hang on the wall clock;
  leg B's four runs; every leg C family's gauges and emission counts.
- api_device (phase 26): every check but those that need the card (the
  rows against the plane-off job and the numpy model, the phase counters
  against the filter and the planner, compiles, spans, key skew, the
  payload's keys; the ring-doubling cause; the mesh's per-shard skew and
  summed ingest count; one profiler capture), and the payload keys the
  smoke holds the port to against the JAX package's device_snapshot().

Tolerance: exact.
- api_mesh_features (phase 27): every leg's check on four CPU shards but
  K1's launches (leg A's four results window by window and the wide
  group array for array; leg B's sharded parity with checkpoints, the
  zipf job's parity, residency and cold routing, the sharded row surface
  against one device; leg C's point lookups and the savepoint restored on
  one device and on 2 shards), and shard 0's exchanged K1 inputs of the
  wide group's shared dispatch.
- api_mesh_control (phase 28): every leg's check on four CPU shards but
  K1's launches (leg A's rebalanced mesh job against the one-card job and
  the numpy model, the rebalance's gauges, recovery and routing block, the
  skew below the static table's; leg B's autoscaler drill 4 -> 2 with the
  one-device rows; leg C's degrade 4 -> 2 from a restored checkpoint), and
  the routed dispatch K1's check takes: shard 0's partials under the
  rebalanced table.
- api_chaos (phase 30): every scenario of the matrix on four CPU shards,
  legs A-C's recoveries against their uninterrupted runs (checkpoints
  every 1 ms here: a small CPU run is over before a 25 ms checkpoint),
  and the dispatch `k1_recovered` takes; only K1's launches stay 0.
- api_state_tools (phase 31): leg A's reader cells against numpy and the
  resumed rows and total against the patched model, and the dispatch
  `k1_patched` takes; leg B's rows of every format against the columnar
  job's; only K1's launches stay 0.
- lint (phase 34): the port's analyzer in a process of its own over the
  port: 16 rules, nothing active, every baseline entry in use, no torch.
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


def test_api_mesh_phase_agrees_on_every_leg():
    out = cm.api_mesh_phase(dev="cpu", sizes=dict(
        batch=1024, parity_events=1 << 14, timed_events=1 << 15, runs=2, big_batch=2048,
        big_keys=1 << 12, big_events=1 << 16, op_keys=1 << 12, op_events=1 << 15,
        op_batch=1 << 12))
    a, b, c = out["leg_a"], out["leg_b"], out["leg_c"]
    assert a["fused_selected"] and a["sharded_selected"]
    for label in ("uniform", "zipf"):
        assert all(a[label][run]["equals_model"] for run in ("mesh", "mesh_combine", "card"))
    for run in ("card", "mesh", "mesh_combine", "rescale", "restored_card", "restored_mesh2"):
        assert b[run]["parity_vs_oracle"] and b[run]["no_window_twice"], run
    assert b["rescale"]["mesh_rescales"] == 1 and b["rescale"]["mesh_devices_after"] == 2
    assert b["savepoint_first_job"] == "CANCELED"
    assert (b["restored_card"]["mesh_devices"], b["restored_mesh2"]["mesh_devices"]) == (1, 2)
    assert c["ok"] and c["operator"]["equal"] and c["q8"]["sharded"]
    # the phase restores the visible devices it replaced
    from flink_tpu_torch.parallel import mesh as mesh_lib

    assert len(mesh_lib.visible_devices("cpu")) == 1


@pytest.mark.parametrize("combine", [False, True], ids=["lanes", "partials"])
def test_mesh_k1_inputs_are_shard_zeros(combine, monkeypatch):
    monkeypatch.setitem(cm.API_MESH, "timed_events", 1 << 18)
    shim, _agg, plan, inputs = cm.mesh_k1_inputs(cm.API_MESH, combine, dev="cpu")
    assert shim.K == cm.API_MESH["keys"] // cm.API_MESH["shards"] and len(plan[5]) > 0
    if combine:
        cpart, parts = inputs
        assert tuple(cpart.shape) == (32, shim.K, 4) and parts == [] and int(cpart.sum()) > 0
    else:
        idx, vals = inputs
        live = idx[idx >= 0]
        assert vals is None and idx.numel() == 32 * cm.API_MESH["batch"]
        assert live.numel() > 0 and int(live.max()) < shim.K * 4


def test_api_metrics_phase_holds_every_check_but_the_launches(monkeypatch):
    import flink_tpu.runtime.minicluster as jmc
    from flink_tpu_torch.checkpoint.coordinator import CheckpointCoordinator
    from flink_tpu_torch.metrics.history import MetricHistory

    monkeypatch.setattr(CheckpointCoordinator, "due", lambda self: True)
    monkeypatch.setattr(MetricHistory, "due", lambda self, now_ms=None: True)
    monkeypatch.setitem(cm.API, "batch", 4096)
    monkeypatch.setattr(cm, "API_LATENESS", dict(cm.API_LATENESS, batch=4096, keys=512))
    r = cm.api_metrics_phase(dev="cpu", sizes=dict(
        batch=4096, events=1 << 16, warmup_events=1 << 12, lateness_events=1 << 16,
        session_events=1 << 17, latency_events=1 << 16))
    a = r["leg_a"]
    assert {k for k, v in a["checks"].items() if not v} == {"k1_launched"}, a["checks"]
    assert a["checkpoints"] == a["sections"]["process_raw_batch"] == (1 << 16) // 4096
    assert a["span_counts"]["checkpointing.Checkpoint"] == a["checkpoints"]
    assert len(r["leg_b"]["runs"]) == 4 and r["leg_b"]["on_over_off"] > 0
    c = r["leg_c"]
    assert c["join_q8"]["ok"] and c["per_batch"]["ok"]
    assert c["tiered"]["gauges"]["evictions"] > 0
    assert c["latency_mode"]["gauges"]["latencyModeActive"] == 1
    assert c["session"]["emission_count"] == c["session"]["sessions"] > 0
    # the reports' keys the smoke holds the port to are the JAX client's
    client = jmc.JobClient("j", "n")
    for name, keys in cm.REPORT_KEYS.items():
        got = sorted(getattr(client, name)())
        assert set(got) <= set(keys)
    assert cm.REPORT_KEYS["latency_report"] == sorted(client.latency_report())
    assert cm.REPORT_KEYS["doctor_report"] == sorted(client.doctor_report())


def test_api_device_phase_holds_every_check_but_the_card_ones():
    """Phase 26 rehearsed small on the CPU: every check holds but those that
    need the card (K1 launches, the nvcc build inside the cold job's
    compile time, K1's kernel names in the profiler's trace, and the
    roofline gauge, which rounds to 0 over the CPU's host time)."""
    r = cm.api_device_phase(dev="cpu", sizes=dict(events=1 << 17, cold_events=1 << 14,
                                                  mesh_events=1 << 19, profiler_events=1 << 13))
    a, b, c, d, e = (r[k] for k in ("leg_a", "leg_b", "leg_c", "leg_d", "leg_e"))
    assert {k for k, v in a["checks"].items() if not v} <= {
        "k1_launched", "cold_build_in_compile_time", "hbm_pct_in_range"}, a["checks"]
    assert a["phases"]["phaseFireSteps"] == a["planned"]["fires"] > 0
    assert "ring-doubling" in b["causes"] and b["phases"]["ingestRecords"] == 12 * 512
    assert len(c["runs"]) == 4 and c["on_over_off"] > 0
    assert {k for k, v in d["checks"].items() if not v} == {"k1_once_per_shard"}, d["checks"]
    assert e["profiler"]["captures"] == 1 and e["files"] == 1


def test_device_payload_keys_are_the_jax_packages():
    """The payload keys phase 26 holds the port to are those of the JAX
    package's device_snapshot() for the same kind of job."""
    from test_torch_checkpointing import _job, _runtime

    env, _sink = _job("jax", "fused_count")
    rt = _runtime("jax", env)
    rt.run()
    snap = rt.device_snapshot()
    (uid,) = [u for u, entry in snap["operators"].items() if "compile" in entry]
    assert cm._tree_keys(snap, uid) == cm.DEVICE_PAYLOAD_KEYS
    sig = snap["compile"]["events"][0]["signature"] if snap["compile"]["events"] else None
    if sig is not None:
        assert cm.SIGNATURE_KEYS <= cm._signature_keys(sig)


def test_api_mesh_features_phase_holds_every_check_but_the_launches():
    r = cm.api_mesh_features_phase(dev="cpu", sizes=dict(
        keys=256, batch=4096, parity_events=1 << 16, timed_events=1 << 15, runs=2,
        warmup_events=1 << 12, wide_keys=1 << 12, wide_events=1 << 16, tier_batch=2048,
        tier_parity_events=1 << 14, tier_parity_keys=1 << 13, tier_hot=256,
        tier_events=1 << 14, tier_keys=1 << 20, row_keys=1 << 12, row_moves=1 << 10,
        query_events=1 << 16, query_batch=2048))
    a, b, c = r["leg_a"], r["leg_b"], r["leg_c"]
    assert a["parity"] and a["shared_selected"]
    assert [m["windows_checked"] for m in a["members"]] == [121, 25, 3]
    assert a["wide"]["equal"] and a["wide"]["totals_ok"] and a["wide"]["selected"]
    p = b["sharded_parity"]
    assert p["parity_vs_untiered"] and p["parity_vs_oracle"] and p["mesh_selected"]
    assert p["evictions"] > 0 and p["checkpoints"]["tiered"] > 0
    z = b["zipf"]
    assert z["parity"] and z["resident_bounded"] and z["cold_records"] > 0
    assert z["evictions"] > 0 and z["mesh_devices"] == 4
    assert b["row_surface"]["ok"]
    q = c["query"]
    assert q["equal"] and q["slices_seen"] > 0 and len(q["points"]) == 3
    assert c["savepoint"]["first_job"] == "CANCELED"
    for name in ("restored_card", "restored_mesh2"):
        assert c["savepoint"][name]["equal_to_uninterrupted"]
    assert (c["savepoint"]["restored_card"]["mesh_devices"],
            c["savepoint"]["restored_mesh2"]["mesh_devices"]) == (1, 2)
    # CPU runs launch no K1
    assert not r["ok"] and a["k1_launches"]["mesh_shared"] == 0
    assert "k1_mesh_shared" not in r


def test_mesh_shared_k1_inputs_are_shard_zeros():
    sz = dict(cm.API_MESH_FEATURES, batch=4096, wide_keys=1 << 12, wide_events=1 << 20)
    shim, _agg, idx, vals, plan = cm.mesh_shared_k1_inputs(sz, dev="cpu")
    assert shim.K == (1 << 12) // 4 and shim.F == 20 and vals is None
    assert shim.slot_spws() == (1,) * 4 + (5,) * 4 + (15,) * 4 + (60,) * 4 + (10,) * 4
    # the positional exchange keeps every lane: shard 0 sees all 4 x B_s
    assert idx.numel() == 32 * 4096 and len(plan[5]) > 0
    assert 0 < int((idx >= 0).sum()) < idx.numel()


def test_api_mesh_control_phase_holds_every_check_but_the_launches():
    r = cm.api_mesh_control_phase(dev="cpu", sizes=dict(
        events=1 << 16, keys=1024, batch=1024, parity_events=1 << 14, gate_at=1 << 14))
    a, b, c = r["leg_a"], r["leg_b"], r["leg_c"]
    assert a["fused_selected"] and a["sharded_selected"] and a["local_combine_active"]
    assert a["routing_table"]
    p = a["parity"]
    assert p["mesh_equals_card"] and p["mesh_equals_model"] and p["card_equals_model"]
    assert p["no_window_twice"] and p["rebalances"] >= 1
    z = a["adaptive"]["zipf"]
    assert z["gauge_mesh_rebalances"] >= 1 and z["gauge_routing_table_version"] >= 1
    assert z["num_restarts"] == 0 and "rebalance" in z["recovery_kinds"]
    assert z["routing"]["movedGroups"] > 0
    assert z["mesh_load_skew"] < a["static_mesh_load_skew"]
    assert a["adaptive"]["uniform"]["rebalances"] == 0
    assert r["reference"]["equals_model"]
    assert b["real_executor"] and not b["same_size"][0] and b["down"][0]
    assert b["mesh_rescales"] == 1 and b["mesh_devices_after"] == 2 and b["rows_equal_card"]
    assert b["last_rescale_ms"] > 0 and b["samples_observed"] >= 1
    assert c["num_restarts"] == 1 and c["mesh_devices_after"] == 2 and c["injected"] == [True]
    assert c["restored_checkpoint_ids"][0] is not None and c["rows_equal_card"]
    assert c["dispatches"] > cm.API_MESH_CONTROL["fail_at"]
    d = r["routed_dispatch"]
    assert d["table_version"] >= 1 and d["T"] == cm.API_MESH_CONTROL["superbatch_steps"]
    assert d["K_local"] == 1024 // 4 and d["partials_shape"] == [d["T"], 256, 4]
    assert d["partial_records"] > 0 and d["fires"] > 0
    # CPU runs launch no K1
    assert not r["ok"] and z["k1_partials"] == 0 and "k1_mesh_routed" not in r


def test_api_topologies_phase_holds_every_check_but_the_launches(monkeypatch):
    """Phase 29 rehearsed small on the CPU: every leg's rows against its
    model or reference job; only K1's launches stay 0 (the plain version
    counts none), so leg A, B and D's `ok` and the phase's read false."""
    monkeypatch.setitem(cm.API, "batch", 4096)
    r = cm.api_topologies_phase(dev="cpu", sizes=dict(
        parity_events=1 << 16, timed_events=1 << 15, warmup_events=1 << 13, runs=1,
        b_events=1 << 15, b_batch=2048, c_events=1 << 12, c_keys=64, c_batch=512,
        d_events=1 << 15))
    a, b, c, d = r["leg_a"], r["leg_b"], r["leg_c"], r["leg_d"]
    assert a["selection"]["ok"] and a["parity"]["union_equals_single"]
    assert a["parity"]["union_equals_oracle"] and a["parity"]["windows_checked"] > 60
    assert b["sums_equal_numpy"] and b["clicks_equal_numpy"] and b["side_rows"] > 0
    assert b["window_operators"] == ["FusedWindowOperator", "FusedWindowOperator"]
    assert c["ok"] and c["coordinator"]["failure"]["num_restarts"] == 1
    assert c["reduce"]["query_state_equal_model"] and c["iterate"]["max_rounds_guard"]
    assert d["report_equals_jax"] and d["equals_branches_alone"] and d["equals_model"]
    assert not r["ok"] and a["parity"]["union_k1"] == 0 and "k1_union" not in r


def test_api_chaos_phase_holds_every_check_but_the_launches():
    """Phase 30 rehearsed small on the CPU (2^16 records, batch 2048, the
    device error at batch 20 of 32; leg C at batch 1024, the error at batch
    40 of 64)."""
    r = cm.api_chaos_phase(dev="cpu", sizes=dict(
        events=1 << 16, batch=2048, warmup_events=1 << 12, device_nth=20, interval=1,
        mesh_events=1 << 16, mesh_batch=1024, mesh_nth=40))
    z, u, a, b, c = r["leg_0"], r["undisturbed"], r["leg_a"], r["leg_b"], r["leg_c"]
    assert z["ok"] and z["scenarios_passed"] == 8 and cm.CHAOS["events"] == 1 << 22
    assert all(x["mesh"] == [4, 2] for n, x in z["scenarios"].items() if "chip-loss" in n)
    assert u["parity_vs_oracle"] and u["num_restarts"] == 0
    assert a["status"] == "FINISHED" and a["num_restarts"] == 1 and a["injected"] == [True]
    assert a["restored_checkpoint_id"] is not None and a["rows_equal_undisturbed"]
    assert a["memory_bounded"] and a["restarted_dispatch_taken"] and a["downtime_ms"] > 0
    assert b["num_restarts"] == 1 and b["restored_checkpoint_id"] == 2 and b["torn_saves"] >= 1
    assert b["rows_equal_undisturbed"] and b["injected"] == [False]
    assert c["num_restarts"] == 1 and c["mesh_devices_after"] == 2 and c["rows_equal_card"]
    assert c["injected"] == [True] and c["restored_checkpoint_id"] is not None
    # CPU runs launch no K1
    assert not r["ok"] and a["k1_launches"] == 0 and "k1_recovered" not in a


def test_api_state_tools_phase_holds_every_check_but_the_launches(monkeypatch):
    """Phase 31 rehearsed small on the CPU (batch 4096, 2^17 records for the
    savepoint, 2^15 a format)."""
    monkeypatch.setitem(cm.API, "batch", 4096)
    r = cm.api_state_tools_phase(dev="cpu", sizes=dict(events=1 << 17, format_events=1 << 15))
    a, b = r["leg_a"], r["leg_b"]
    assert a["first_job"] == "CANCELED" and a["resumed_job"] == "FINISHED"
    assert a["in_flight_cells"] > 0 and a["reader_equals_model"]
    assert a["rows_equal_patched_model"] and a["total_equal"] and a["resumed_dispatch_taken"]
    for fmt in ("csv", "json", "avro"):
        assert b[fmt]["rows_equal_columnar_job"] and b[fmt]["codec_roundtrip"]
        assert b[fmt]["files"] == 1 and b[fmt]["bytes"] > 0
    assert not r["ok"] and a["k1_launches"] == 0 and "k1_patched" not in a


def test_api_cluster_phase_holds_every_check_but_the_launches():
    """Phase 32 rehearsed small on the CPU (2^15 records at batch 4096 over
    64 keys for legs A and B, 4 x 4096 records a leg C job, 1024 ML rows,
    2^14 records on the process cluster): every row check holds, leg B
    restarts from a checkpoint with the window stage fused, and only K1's
    launches (none on the CPU) keep leg A's gate shut."""
    r = cm.api_cluster_phase("cpu", dict(
        events_a=1 << 15, events_b=1 << 15, events_e=1 << 14, keys=64, batch=4096,
        c_steps=4, c_batch=4096, c_keys=64, ml_rows=1024, wire_rows=4096, wire_reps=3,
        handshakes=3))
    a, b, c, d, e = (r[k] for k in ("leg_a", "leg_b", "leg_c", "leg_d", "leg_e"))
    assert a["status"] == "FINISHED" and a["rows_equal_local"] and a["local_equal_oracle"]
    assert a["rows"] > 0 and a["pipelines_in_task_executor"] == 1
    assert b["status"] == "FINISHED" and b["rows_equal_uninterrupted"] and b["restarts"] >= 1
    assert b["restored_checkpoint_id"] is not None and b["stages"] == 2
    assert b["window_stage_runners"] == ["DeviceChainRunner"]
    assert b["exchange"]["numBytesOut"] > 0 and b["ok"]
    assert c["ok"] and c["sliding_count"]["rows"] > 0 and c["session_sum"]["rows"] > 0
    assert d["ok"] and d["within_tolerance"]
    assert e["ok"] and e["processes_stopped"]
    assert r["host_rates"]["decode_equal"]
    assert r["failed"] == ["leg_a"] and a["k1_launches_task_executor"] == 0
    assert "k1_cluster" not in a


def test_api_cluster_ops_phase_holds_every_check_but_the_launches():
    """Phase 33 rehearsed small on the CPU: leg A's four cluster drills at
    the JAX package's sizes; leg B at 2^15 records, batch 4096 over 64 keys,
    a 1.5 s heartbeat timeout under a 40-beat partition (4 s at the 0.1 s
    beat), paced 0.5 s a batch (the blip 0.2 s); leg C at 2^15 records.
    Every row, route and CLI check holds; only K1's launches (none on the
    CPU) keep legs B and C's gates shut."""
    r = cm.api_cluster_ops_phase("cpu", dict(
        events_b=1 << 15, keys=64, batch=4096, heartbeat_timeout_b=1.5, partition_fires=40,
        delay_partition=0.5, delay_blip=0.2, events_c=1 << 15, events_paced=1 << 15))
    a, b, c = r["leg_a"], r["leg_b"], r["leg_c"]
    assert a["ok"] and a["scenarios_passed"] == a["scenarios_total"] == 4 and a["parity"]
    assert cm.API_CLUSTER_OPS["events_b"] == 1 << 21
    blip, part = b["blip"], b["partition"]
    assert blip["status"] == "FINISHED" and blip["restarts"] >= 1
    assert blip["restored_checkpoint_id"] is not None
    assert blip["injected_fired"] == 1 and blip["rows_equal_uninterrupted"] and blip["rows"] > 0
    assert part["status"] == "FINISHED" and part["restarts"] >= 1 and part["attributed"]
    assert part["restored_checkpoint_id"] is not None and part["rows_equal_uninterrupted"]
    assert part["window_shard"] == 1 and part["restarted_dispatch_taken"]
    ysb, paced, bridge = c["ysb"], c["paced"], c["bridge"]
    assert ysb["status"] == ysb["info_status"] == "FINISHED" and ysb["cli_rc"] == [0, 0, 0]
    assert ysb["listed"] and ysb["records_in"] == 1 << 15 and ysb["prometheus_has_the_jobs_gauges"]
    assert ysb["phases"] == {"ingestRecords": -(-(1 << 15) // 3), "fireSteps": ysb["planned"][
        "fires"], "purgeSteps": ysb["planned"]["purges"]} and ysb["device_dispatches"] >= 1
    assert paced["final_status"] == "CANCELED" and paced["savepoint_written"]
    assert paced["checkpoints_completed"] >= 1 and paced["checkpoint_route"] == 200
    assert paced["flame_samples"] > 0 and paced["dashboard_has_device_table"]
    assert bridge["ok"] and bridge["jobs"]["partition"]["num_restarts"] >= 1
    # CPU runs launch no K1
    assert r["failed"] == ["leg_b", "leg_c"]
    assert blip["k1_launches"] == part["k1_launches"] == ysb["k1_launches"] == 0
    assert "k1_cluster_faulted" not in part


def test_lint_phase_passes_over_the_port():
    """Phase 34 on the CPU: the lint runs in a process of its own over the
    port with its baseline, and the line the smoke gates on reads 16 rules,
    no active violation, every entry of its baseline in use, exit 0 and no
    torch."""
    r = cm.lint_phase(dev="cpu")
    assert r["ok"] and r["rules"] == 16 and r["active_violations"] == 0
    entries = cm.json.loads((cm.Path(cm.__file__).parent / "lint_baseline_torch.json")
                            .read_text())["entries"]
    assert r["baselined"] == len(entries) == 9
    assert r["exit_code"] == 0 and r["baseline_errors"] == 0
    assert not r["torch_loaded"] and r["device_modules"] == []
    assert r["modules"] == len(list((cm.Path(cm.__file__).parent / "flink_tpu_torch")
                                    .rglob("*.py")))
    assert r["analysis_ms"] > 0 and r["process_s"] * 1e3 >= r["analysis_ms"]
