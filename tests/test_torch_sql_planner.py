"""The port's SQL planner and fused front door held against the JAX
package's.

The same statements, on the same rows (made with numpy from a seed), go
through `flink_tpu.table.TableEnvironment` and the port's
`TableEnvironment(StreamExecutionEnvironment(device="cpu"))`. Compared:
the emitted rows exactly, by `repr`, in emission order; the plan report's
`path`, `reason` and `describe()`; the `explain_sql` text; the runners the
job selects. Covered (from `tests/test_sql_planner.py`): the golden plans
and the whole fallback catalog, HOP/TUMBLE on the fused route over a
columnar table and over a typed row-mode table (host columnarizer, NULLs
in predicate columns), `table.device-fusion=false` for every fused
statement, the three-way parity of the SQL YSB job (SQL fused, SQL
interpreted, the hand-built DataStream program), `bench.py::
sql_path_microbench`'s statement and source at a small size three ways,
the statements the port cannot run yet (their `not_ported` item, and the
planner's report equal to the JAX package's; those ported since run to the
JAX package's rows), and the SQL gateway.

Tolerance: exact. Values are integer-valued floats with sums far below
2**24, so float32 accumulation is exact in any order.
"""

import json
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

import flink_tpu.api.datastream as j_ds  # noqa: E402
import flink_tpu.api.windowing.assigners as j_asg  # noqa: E402
import flink_tpu.config as j_cfg  # noqa: E402
import flink_tpu.connectors.source as j_src  # noqa: E402
import flink_tpu.core.watermarks as j_wm  # noqa: E402
import flink_tpu.graph.transformation as j_tr  # noqa: E402
import flink_tpu.planner as j_pl  # noqa: E402
import flink_tpu.runtime.executor as j_ex  # noqa: E402
import flink_tpu.table as j_tb  # noqa: E402
import flink_tpu.table.gateway as j_gw  # noqa: E402
import flink_tpu.table.sql as j_sql  # noqa: E402
import flink_tpu_torch.api.datastream as t_ds  # noqa: E402
import flink_tpu_torch.api.windowing.assigners as t_asg  # noqa: E402
import flink_tpu_torch.config as t_cfg  # noqa: E402
import flink_tpu_torch.connectors.source as t_src  # noqa: E402
import flink_tpu_torch.core.watermarks as t_wm  # noqa: E402
import flink_tpu_torch.graph.transformation as t_tr  # noqa: E402
import flink_tpu_torch.planner as t_pl  # noqa: E402
import flink_tpu_torch.runtime.executor as t_ex  # noqa: E402
import flink_tpu_torch.table as t_tb  # noqa: E402
import flink_tpu_torch.table.gateway as t_gw  # noqa: E402
import flink_tpu_torch.table.sql as t_sql  # noqa: E402
from flink_tpu_torch.planner import lowering as t_lowering  # noqa: E402
from jax_native_twins import jax_native_library  # noqa: E402,F401

JAX = types.SimpleNamespace(ds=j_ds, asg=j_asg, cfg=j_cfg, src=j_src, wm=j_wm, tr=j_tr, pl=j_pl,
                            ex=j_ex, tb=j_tb, gw=j_gw, sql=j_sql, kw={})
PORT = types.SimpleNamespace(ds=t_ds, asg=t_asg, cfg=t_cfg, src=t_src, wm=t_wm, tr=t_tr, pl=t_pl,
                             ex=t_ex, tb=t_tb, gw=t_gw, sql=t_sql, kw={"device": "cpu"})
PKGS = (JAX, PORT)
NUM_KEYS = 16


# ---------------------------------------------------------------------------
# helpers: the JAX test's tables, built in either package
# ---------------------------------------------------------------------------

def _config(P, fused=True, batch=512, keys=NUM_KEYS):
    cfg = P.cfg.Configuration()
    cfg.set(P.cfg.TableOptions.DEVICE_FUSION, fused)
    cfg.set(P.cfg.ExecutionOptions.BATCH_SIZE, batch)
    cfg.set(P.cfg.ExecutionOptions.KEY_CAPACITY, keys)
    return cfg


def _ysb_source(P, n, num_keys=NUM_KEYS, span_ms=8000, mult=7919):
    """Columnar (campaign, event_type) batches; event time rides the batch
    timestamps. All values integral -> float32 math is exact."""

    def gen(idx):
        camp = (idx * mult) % num_keys
        col = np.stack([camp, idx % 3], axis=1).astype(np.float32)
        ts = 10_000 + idx * span_ms // max(n, 1)
        return P.src.Batch(col, ts.astype(np.int64))

    return P.src.DataGeneratorSource(gen, n)


def _columnar_env(P, n=4096, fused=True, batch=512, keys=NUM_KEYS, **src):
    env = P.ds.StreamExecutionEnvironment(_config(P, fused, batch, keys), **P.kw)
    tenv = P.tb.TableEnvironment(env)
    stream = env.from_source(_ysb_source(P, n, keys, **src),
                             P.wm.WatermarkStrategy.for_bounded_out_of_orderness(0))
    tenv.register_table("ysb", stream,
                        P.tb.TableSchema(["campaign", "event_type", "rowtime"],
                                         rowtime="rowtime",
                                         field_types=["int", "float", "int"]),
                        columnar=True)
    return env, tenv


_RNG = np.random.default_rng(7)
_ROWS = [{"user": int(u), "amount": float(a), "rowtime": i * 40}
         for i, (u, a) in enumerate(zip(_RNG.integers(0, 7, 1500), _RNG.integers(0, 5, 1500)))]
_NULL_ROWS = [dict(r, amount=None) if i % 4 == 0 else r for i, r in enumerate(_ROWS)]


def _typed_rows_env(P, fused=True, rows=_ROWS, types_=("int", "float", "int")):
    cfg = P.cfg.Configuration()
    cfg.set(P.cfg.TableOptions.DEVICE_FUSION, fused)
    cfg.set(P.cfg.ExecutionOptions.BATCH_SIZE, 256)
    env = P.ds.StreamExecutionEnvironment(cfg, **P.kw)
    tenv = P.tb.TableEnvironment(env)
    tenv.from_rows("pay", rows,
                   P.tb.TableSchema(["user", "amount", "rowtime"], rowtime="rowtime",
                                    field_types=list(types_) if types_ else None))
    return env, tenv


def _report(r):
    return (r.path, r.reason, r.detail, r.describe()) if r is not None else None


def _run(P, make, sql):
    """(rows, report, runner class names) of one statement in package P."""
    env, tenv = make(P)
    sink = tenv.sql_query(sql).collect()
    runners = P.ex.build_runners(P.tr.plan(env._sinks), env.config, *(
        ("cpu",) if P is PORT else ()))[0]
    env.execute()
    return sink.results, tenv.last_plan_report, sorted(type(r).__name__ for r in runners)


def _same(make, sql):
    """Run through both packages; rows equal by repr, reports and runners
    equal. Returns the port's (rows, report, runners)."""
    jr, jrep, jrun = _run(JAX, make, sql)
    pr, prep, prun = _run(PORT, make, sql)
    assert repr(pr) == repr(jr)
    assert _report(prep) == _report(jrep)
    assert prun == jrun
    return pr, prep, prun


def _norm(rows):
    return sorted(tuple(sorted((k, v.item() if hasattr(v, "item") else v)
                               for k, v in r.items())) for r in rows)


_CATALOG = {
    "ysb": dict(fields=("campaign", "event_type", "rowtime"), rowtime="rowtime",
                field_types=("int", "float", "int"), columnar=True),
    "pay": dict(fields=("user", "amount", "rowtime"), rowtime="rowtime",
                field_types=("int", "float", "int"), columnar=False),
    "untyped": dict(fields=("user", "amount", "rowtime"), rowtime="rowtime",
                    field_types=None, columnar=False),
    "strkey": dict(fields=("name", "amount", "rowtime"), rowtime="rowtime",
                   field_types=("str", "float", "int"), columnar=False),
    "c": dict(fields=("k", "v", "rowtime"), rowtime="rowtime", field_types=None,
              columnar=True),
    "wide": dict(fields=("k", "a", "b", "c", "d", "rowtime"), rowtime="rowtime",
                 field_types=("int", "float", "float", "float", "float", "int")),
    "t": dict(fields=("k", "rowtime_tag", "rowtime"), rowtime="rowtime",
              field_types=("int", "str", "int")),
}


def _catalog(P):
    return {n: P.pl.TableInfo(name=n, **kw) for n, kw in _CATALOG.items()}


def _plan_both(sql):
    return [P.pl.plan_query(P.sql.parse_query(sql), _catalog(P)) for P in PKGS]


# ---------------------------------------------------------------------------
# plans: golden trees and the fallback catalog, statement for statement
# ---------------------------------------------------------------------------

_PLANNED = [
    # fused
    "SELECT campaign, COUNT(*) AS views, WINDOW_END AS wend FROM ysb WHERE event_type < 0.5 "
    "GROUP BY campaign, HOP(rowtime, INTERVAL '1' SECOND, INTERVAL '10' SECOND)",
    "SELECT user, SUM(amount) AS total FROM pay GROUP BY user, TUMBLE(rowtime, INTERVAL '2' SECOND)",
    "SELECT campaign, COUNT(*) FROM ysb GROUP BY campaign, "
    "HOP(rowtime, INTERVAL '2500' MILLISECOND, INTERVAL '4' SECOND)",
    "SELECT k, SUM(b) AS s FROM wide WHERE d > 1 OR (a < 2 AND b >= -1) "
    "GROUP BY k, TUMBLE(rowtime, INTERVAL '1' SECOND)",
    "SELECT user, AVG(amount) AS x, WINDOW_START AS ws FROM pay GROUP BY user, "
    "TUMBLE(rowtime, INTERVAL '1' SECOND) HAVING x > 1 ORDER BY x DESC LIMIT 2",
    # the whole fallback catalog of tests/test_sql_planner.py
    "SELECT a.user, b.user FROM pay AS a JOIN pay AS b ON a.user = b.user",
    "SELECT a.user, COUNT(*) AS n FROM pay AS a JOIN pay AS b "
    "ON a.user = b.user WINDOW TUMBLE(INTERVAL '1' SECOND)",
    "SELECT a.user, b.user FROM pay AS a JOIN pay AS b ON a.user = b.user "
    "WINDOW TUMBLE(INTERVAL '1' SECOND)",
    "SELECT a.user, b.user FROM pay AS a FULL OUTER JOIN pay AS b ON a.user = b.user",
    "SELECT a.user, b.amount FROM pay AS a LEFT JOIN pay AS b ON a.user = b.user",
    "SELECT a.user FROM pay AS a JOIN pay AS b ON a.user = b.user "
    "WINDOW SESSION(INTERVAL '1' SECOND)",
    "SELECT user, COUNT(*) AS n FROM pay GROUP BY user, SESSION(rowtime, INTERVAL '1' SECOND)",
    "SELECT user, COUNT(*) AS n FROM pay GROUP BY user",
    "SELECT user FROM pay",
    "SELECT ML_PREDICT(m, amount) FROM pay",
    "SELECT COUNT(*) AS n FROM pay GROUP BY TUMBLE(rowtime, INTERVAL '1' SECOND)",
    "SELECT user, amount, COUNT(*) AS n FROM pay GROUP BY user, amount, "
    "TUMBLE(rowtime, INTERVAL '1' SECOND)",
    "SELECT user, COUNT(*) AS n, SUM(amount) AS s FROM pay "
    "GROUP BY user, TUMBLE(rowtime, INTERVAL '1' SECOND)",
    "SELECT user, COUNT(*) AS n FROM untyped GROUP BY user, TUMBLE(rowtime, INTERVAL '1' SECOND)",
    "SELECT name, COUNT(*) AS n FROM strkey GROUP BY name, TUMBLE(rowtime, INTERVAL '1' SECOND)",
    "SELECT name, COUNT(*) AS n FROM strkey WHERE name != 'spam' "
    "GROUP BY name, TUMBLE(rowtime, INTERVAL '1' SECOND)",
    "SELECT user, COUNT(*) AS n FROM pay GROUP BY user, TUMBLE(amount, INTERVAL '1' SECOND)",
    "SELECT user, SUM(rowtime) AS s FROM pay GROUP BY user, TUMBLE(rowtime, INTERVAL '1' SECOND)",
    "SELECT user, COUNT(*) AS n FROM nowhere GROUP BY user, TUMBLE(rowtime, INTERVAL '1' SECOND)",
    "SELECT nope, COUNT(*) AS n FROM pay GROUP BY nope, TUMBLE(rowtime, INTERVAL '1' SECOND)",
    "SELECT user, SUM(nope) AS s FROM pay GROUP BY user, TUMBLE(rowtime, INTERVAL '1' SECOND)",
    "SELECT user, COUNT(*) AS n FROM pay WHERE nope > 1 "
    "GROUP BY user, TUMBLE(rowtime, INTERVAL '1' SECOND)",
    "SELECT user, COUNT(*) AS n FROM pay GROUP BY user, TUMBLE(rowtime, INTERVAL '1' SECOND) "
    "UNION ALL SELECT user, COUNT(*) AS n FROM pay GROUP BY user, TUMBLE(rowtime, INTERVAL '1' SECOND)",
    "SELECT k, SUM(v) AS s FROM c GROUP BY k, TUMBLE(rowtime, INTERVAL '1' SECOND)",
    "SELECT k, COUNT(*) AS n FROM t WHERE rowtime_tag != 'x' "
    "GROUP BY k, TUMBLE(rowtime, INTERVAL '1' SECOND)",
    "SELECT user, COUNT(*) AS n FROM pay GROUP BY user, TUMBLE(rowtime, INTERVAL '0' SECOND)",
]


@pytest.mark.parametrize("sql", _PLANNED, ids=range(len(_PLANNED)))
def test_plan_reports_match_the_jax_planner(sql):
    jrep, prep = _plan_both(sql)
    assert _report(prep) == _report(jrep)
    assert prep.reason is None or prep.reason in t_pl.FALLBACK_CATALOG
    if prep.fused and isinstance(prep.plan, t_pl.LogicalPlan):
        assert prep.plan.scan.required == jrep.plan.scan.required
        assert prep.plan.window_agg.window.slice_ms == jrep.plan.window_agg.window.slice_ms


def test_fallback_catalog_is_the_jax_packages():
    assert t_pl.FALLBACK_CATALOG == j_pl.FALLBACK_CATALOG


def test_agg_mapping_is_single_sourced_with_the_interpreted_path():
    from flink_tpu_torch.planner import rules
    from flink_tpu_torch.table import table_env

    assert rules.DEVICE_AGG_OF is table_env._DEVICE_AGG
    assert t_sql.DEVICE_AGG_OF == j_sql.DEVICE_AGG_OF


def test_non_grouped_select_column_is_refused_identically():
    sql = ("SELECT amount, COUNT(*) AS n FROM pay "
           "GROUP BY user, TUMBLE(rowtime, INTERVAL '1' SECOND)")
    for P in PKGS:
        with pytest.raises(ValueError, match="must appear in GROUP BY"):
            P.pl.plan_query(P.sql.parse_query(sql), _catalog(P))
        for fused in (True, False):
            _env, tenv = _typed_rows_env(P, fused=fused)
            with pytest.raises(ValueError, match="must appear in GROUP BY"):
                tenv.sql_query(sql)


@pytest.mark.parametrize("bad", ["SELEC nonsense", "SELECT a FROM t LIMIT x",
                                 "SELECT a FROM t WHERE a > 'x", "SELECT a FROM",
                                 "SELECT k, COUNT(*) FROM t GROUP BY k, "
                                 "TUMBLE(ts, INTERVAL 'x' SECOND)"])
def test_parse_errors_are_the_jax_diagnostics(bad):
    msgs = []
    for P in PKGS:
        with pytest.raises(P.sql.SqlParseError) as e:
            P.sql.parse_query(bad)
        msgs.append((str(e.value), e.value.pos, e.value.reason))
    assert msgs[0] == msgs[1]


def test_failed_statement_does_not_inherit_the_previous_report():
    _env, tenv = _typed_rows_env(PORT)
    tenv.sql_query("SELECT user, COUNT(*) AS n FROM pay "
                   "GROUP BY user, TUMBLE(rowtime, INTERVAL '1' SECOND)")
    assert tenv.last_plan_report is not None and tenv.last_plan_report.fused
    with pytest.raises(t_sql.SqlParseError):
        tenv.sql_query("SELEC nonsense")
    assert tenv.last_plan_report is None


@pytest.mark.parametrize("fused", [True, False])
def test_explain_sql_is_plan_only_and_the_jax_text(fused):
    sql = ("SELECT campaign, COUNT(*) AS n FROM ysb WHERE event_type > 0.5 "
           "GROUP BY campaign, TUMBLE(rowtime, INTERVAL '1' SECOND)")
    out = []
    for P in PKGS:
        env, tenv = _columnar_env(P, n=256, fused=fused)
        report = tenv.explain_sql(sql)
        assert report.lowered is None and env._sinks == []
        out.append(_report(report))
    assert out[0] == out[1]
    assert ("WindowAggregate" in out[1][3]) == fused


def test_replanning_hands_back_the_same_functions():
    """The generated extractors and masks are cached on structure, so the
    fused pipeline's caches see one function per statement."""
    sql = ("SELECT campaign, SUM(event_type) AS s FROM ysb WHERE event_type < 1.5 "
           "GROUP BY campaign, TUMBLE(rowtime, INTERVAL '1' SECOND)")
    terms = []
    for _ in range(2):
        _env, tenv = _columnar_env(PORT, n=256)
        tenv.sql_query(sql)
        terms.append(tenv.last_plan_report.lowered.terminal)
    a, b = (t.config for t in terms)
    assert a["key_selector"] is b["key_selector"] and a["value_fn"] is b["value_fn"]
    fa, fb = (t.inputs[0].inputs[0].config["fn"] for t in terms)
    assert fa is fb


def test_lowered_functions_are_torch_column_functions():
    col = torch.tensor([[3.0, 0.0], [5.0, 2.0], [7.0, float("nan")]])
    key = t_lowering._key_extractor(0)(col)
    assert key.dtype == torch.int32 and key.tolist() == [3, 5, 7]
    q = t_sql.parse_query("SELECT k FROM t WHERE v < 1 OR k >= 7 AND v != 2")
    plain = t_lowering._mask_fn_for(q.where_ast, ("k", "v"), False)(col)
    aware = t_lowering._mask_fn_for(q.where_ast, ("k", "v"), True)(col)
    assert plain.dtype == torch.bool and plain.tolist() == [True, False, True]
    assert aware.tolist() == [True, False, False]      # NULL (NaN) != 2 is not TRUE


# ---------------------------------------------------------------------------
# execution: fused and interpreted, rows and reports equal to the JAX
# package's
# ---------------------------------------------------------------------------

_COLUMNAR_STATEMENTS = [
    "SELECT campaign, COUNT(*) AS views, WINDOW_END AS wend FROM ysb WHERE event_type < 0.5 "
    "GROUP BY campaign, HOP(rowtime, INTERVAL '500' MILLISECOND, INTERVAL '2' SECOND)",
    "SELECT campaign, COUNT(*) AS n FROM ysb GROUP BY campaign, TUMBLE(rowtime, INTERVAL '1' SECOND)",
    "SELECT campaign, SUM(event_type) AS s FROM ysb WHERE event_type > 0.5 OR campaign = 3 "
    "GROUP BY campaign, TUMBLE(rowtime, INTERVAL '2' SECOND)",
    "SELECT campaign, MIN(event_type) AS m FROM ysb "
    "GROUP BY campaign, HOP(rowtime, INTERVAL '500' MILLISECOND, INTERVAL '1' SECOND)",
    "SELECT campaign, MAX(event_type) AS m, WINDOW_START AS ws FROM ysb "
    "GROUP BY campaign, TUMBLE(rowtime, INTERVAL '1' SECOND)",
    "SELECT campaign, AVG(event_type) AS a, WINDOW_START AS ws FROM ysb "
    "GROUP BY campaign, TUMBLE(rowtime, INTERVAL '2' SECOND) HAVING a > 0.9 "
    "ORDER BY a DESC, campaign LIMIT 3",
    "SELECT WINDOW_END AS we, campaign, COUNT(*) AS n FROM ysb WHERE event_type != 1 "
    "GROUP BY campaign, TUMBLE(rowtime, INTERVAL '1' SECOND) HAVING n >= 20",
]


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("sql", _COLUMNAR_STATEMENTS, ids=range(len(_COLUMNAR_STATEMENTS)))
def test_columnar_statements_match_the_jax_package(sql, fused):
    rows, report, runners = _same(lambda P: _columnar_env(P, fused=fused), sql)
    assert len(rows) > 0
    assert report.fused == fused
    assert ("DeviceChainRunner" in runners) == fused


_TYPED_STATEMENTS = [
    ("SELECT user, COUNT(*) AS n FROM pay WHERE amount > 1 "
     "GROUP BY user, TUMBLE(rowtime, INTERVAL '5' SECOND)", True),
    ("SELECT user, COUNT(*) AS n FROM pay WHERE amount != 2 "
     "GROUP BY user, TUMBLE(rowtime, INTERVAL '5' SECOND)", True),
    ("SELECT user, SUM(amount) AS s FROM pay "
     "GROUP BY user, HOP(rowtime, INTERVAL '1' SECOND, INTERVAL '3' SECOND)", False),
    ("SELECT user, MAX(user) AS m FROM pay WHERE amount <= 3 OR user = 2 "
     "GROUP BY user, TUMBLE(rowtime, INTERVAL '2' SECOND)", True),
]


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("sql,nulls", _TYPED_STATEMENTS, ids=range(len(_TYPED_STATEMENTS)))
def test_typed_row_statements_match_the_jax_package(sql, nulls, fused):
    rows_in = _NULL_ROWS if nulls else _ROWS
    rows, report, runners = _same(lambda P: _typed_rows_env(P, fused=fused, rows=rows_in), sql)
    assert len(rows) > 0 and report.fused == fused
    assert ("DeviceChainRunner" in runners) == fused


def test_null_predicate_rows_drop_alike_on_both_routes():
    sql = ("SELECT user, COUNT(*) AS n FROM pay WHERE amount != 2 "
           "GROUP BY user, TUMBLE(rowtime, INTERVAL '5' SECOND)")
    fused = _run(PORT, lambda P: _typed_rows_env(P, True, _NULL_ROWS), sql)[0]
    interp = _run(PORT, lambda P: _typed_rows_env(P, False, _NULL_ROWS), sql)[0]
    assert len(fused) > 0 and _norm(fused) == _norm(interp)


@pytest.mark.parametrize("rows,match", [
    ([{"user": (None if i == 7 else i % 3), "amount": 1.0, "rowtime": i * 100}
      for i in range(20)], "no NULL representation"),
    ([{"user": 16_777_216 + i, "amount": 1.0, "rowtime": i * 100} for i in range(4)],
     "float32 cannot represent"),
])
def test_columnarizer_refusals_are_the_jax_packages(rows, match):
    sql = "SELECT user, COUNT(*) AS n FROM pay GROUP BY user, TUMBLE(rowtime, INTERVAL '1' SECOND)"
    for P in PKGS:
        env, tenv = _typed_rows_env(P, rows=rows)
        tenv.sql_query(sql).collect()
        assert tenv.last_plan_report.fused
        with pytest.raises(TypeError, match=match):
            env.execute()


def test_string_predicate_on_string_key_executes_interpreted():
    rows = [{"name": f"u{i % 3}", "amount": float(i % 4), "rowtime": i * 100} for i in range(200)]

    def make(P):
        env = P.ds.StreamExecutionEnvironment(**P.kw)
        tenv = P.tb.TableEnvironment(env)
        tenv.from_rows("strkey", rows, P.tb.TableSchema(
            ["name", "amount", "rowtime"], rowtime="rowtime", field_types=["str", "float", "int"]))
        return env, tenv

    out, report, _r = _same(make, "SELECT name, COUNT(*) AS n FROM strkey WHERE name != 'u0' "
                                  "GROUP BY name, TUMBLE(rowtime, INTERVAL '10' SECOND)")
    assert report.reason == "non-traceable-predicate"
    assert {r["name"] for r in out} == {"u1", "u2"}
    assert all(type(r["name"]) is str for r in out)


def test_unknown_group_by_column_is_a_translation_diagnostic():
    sql = ("SELECT nope, COUNT(*) AS n FROM pay "
           "GROUP BY nope, TUMBLE(rowtime, INTERVAL '1' SECOND)")
    for P in PKGS:
        _env, tenv = _typed_rows_env(P)
        with pytest.raises(ValueError, match="unknown column"):
            tenv.sql_query(sql)
        assert tenv.last_plan_report.reason == "unknown-column"


# ---------------------------------------------------------------------------
# three-way parity of the SQL YSB job, and bench.py::sql_path_microbench
# ---------------------------------------------------------------------------

def _ds_job(P, n, window, slide, mult=7919, batch=512, keys=NUM_KEYS, span_ms=8000):
    """The hand-built DataStream program with the SQL statement's output
    shape (`bench.py::sql_path_microbench`'s `build_ds`)."""
    env = P.ds.StreamExecutionEnvironment(_config(P, True, batch, keys), **P.kw)
    if P is PORT:
        t_filter, t_key = (lambda col: col[:, 1] < 0.5), (lambda col: col[:, 0].to(torch.int32))
    else:
        t_filter, t_key = (lambda col: col[:, 1] < 0.5), (lambda col: col[:, 0].astype("int32"))
    sink = (env.from_source(_ysb_source(P, n, keys, span_ms=span_ms, mult=mult),
                            P.wm.WatermarkStrategy.for_bounded_out_of_orderness(0))
            .filter(t_filter, traceable=True).key_by(t_key, traceable=True)
            .window(P.asg.SlidingEventTimeWindows.of(window, slide)).aggregate("count")
            .map_with_timestamp(lambda rec, ts: {"campaign": rec[0], "views": rec[1],
                                                 "wend": ts + 1}, name="sql_shape_output")
            .collect())
    env.execute()
    return sink.results


def _bench_norm(rows):
    return sorted((int(r["campaign"]), int(r["wend"]), int(r["views"])) for r in rows)


def test_three_way_parity_on_the_sql_ysb_job():
    sql = _COLUMNAR_STATEMENTS[0]
    fused = _same(lambda P: _columnar_env(P, fused=True), sql)[0]
    interp = _same(lambda P: _columnar_env(P, fused=False), sql)[0]
    ds = _ds_job(PORT, 4096, 2000, 500)
    assert repr(_ds_job(JAX, 4096, 2000, 500)) == repr(ds)
    assert len(fused) > 0 and _bench_norm(fused) == _bench_norm(interp) == _bench_norm(ds)


def test_sql_path_microbench_statement_three_ways_at_a_small_size():
    """bench.py::sql_path_microbench's statement, source and geometry
    (10 s / 1 s HOP, batch 8192), cut to 64 keys and 2^15 records over
    64 s of event time: SQL fused, SQL interpreted and the DataStream
    program give equal rows in both packages; the SQL job selects the
    fused runner and the planner reports the fused path."""
    n, keys, batch = 1 << 15, 64, 8192
    sql = ("SELECT campaign, COUNT(*) AS views, WINDOW_END AS wend FROM ysb "
           "WHERE event_type < 0.5 GROUP BY campaign, "
           "HOP(rowtime, INTERVAL '1000' MILLISECOND, INTERVAL '10000' MILLISECOND)")
    geo = dict(n=n, batch=batch, keys=keys, span_ms=64_000, mult=2654435761)
    fused, report, runners = _same(lambda P: _columnar_env(P, fused=True, **geo), sql)
    interp = _same(lambda P: _columnar_env(P, fused=False, **geo), sql)[0]
    ds = _ds_job(PORT, n, 10_000, 1_000, mult=2654435761, batch=batch, keys=keys,
                 span_ms=64_000)
    assert report.fused and "DeviceChainRunner" in runners
    assert len(fused) > 0 and _bench_norm(fused) == _bench_norm(interp) == _bench_norm(ds)


def test_sql_window_steps_carry_their_origin():
    for fused, kind in ((True, "DeviceChainRunner"), (False, "WindowStepRunner")):
        env, tenv = _columnar_env(PORT, n=256, fused=fused)
        tenv.sql_query(_COLUMNAR_STATEMENTS[1]).collect()
        runners = t_ex.build_runners(t_tr.plan(env._sinks), env.config, "cpu")[0]
        sql_runners = [r for r in runners if getattr(r, "sql_origin", False)]
        assert [type(r).__name__ for r in sql_runners] == [kind]


# ---------------------------------------------------------------------------
# what the port cannot run yet: the planner reports it as the JAX package
# does, execution raises naming the ROADMAP item
# ---------------------------------------------------------------------------

_NOT_PORTED = [
    ("SELECT user, COUNT(*) AS n, SUM(amount) AS s FROM pay "
     "GROUP BY user, TUMBLE(rowtime, INTERVAL '1' SECOND)", "item 18"),
    ("SELECT user, COUNT(*) AS n FROM pay GROUP BY user, TUMBLE(rowtime, INTERVAL '1' SECOND) "
     "UNION ALL SELECT user, COUNT(*) AS n FROM pay "
     "GROUP BY user, TUMBLE(rowtime, INTERVAL '2' SECOND)", "item 19"),
    ("SELECT a.user, b.amount FROM pay AS a JOIN pay AS b ON a.user = b.user "
     "WINDOW TUMBLE(INTERVAL '1' SECOND)", "item 12"),
    ("SELECT a.user, b.amount FROM pay AS a JOIN pay AS b ON a.user = b.user", "item 12"),
    ("SELECT a.user, b.amount FROM pay AS a LEFT JOIN pay AS b ON a.user = b.user", "item 12"),
    ("SELECT ML_PREDICT(m, amount) FROM pay", "item 14"),
]


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("sql,item", _NOT_PORTED, ids=[i for _s, i in _NOT_PORTED])
def test_unported_statements_raise_naming_their_item(sql, item, fused):
    reports = []
    for P in PKGS:
        _env, tenv = _typed_rows_env(P, fused=fused)
        reports.append(_report(tenv.explain_sql(sql)))
    assert reports[0] == reports[1]
    _env, tenv = _typed_rows_env(PORT, fused=fused)
    if item == "item 18":
        # ported since: the multi-aggregate SELECT runs on the per-record
        # oracle operator, to the JAX package's rows
        rows = [repr(_typed_rows_env(P, fused=fused)[1].execute_sql_to_list(sql))
                for P in PKGS]
        assert rows[0] == rows[1] and rows[1] != "[]"
        return
    if item == "item 12":
        # ported since: joins (test_torch_joins.py). The windowed self-join
        # runs to the JAX package's rows; the regular ones build the JAX
        # package's runners (their ~3e5-row outputs run there at a small
        # size)
        kinds, rows = [], []
        for P in PKGS:
            env, tenv = _typed_rows_env(P, fused=fused)
            sink = tenv.sql_query(sql).collect()
            kinds.append(sorted(type(r).__name__ for r in P.ex.build_runners(
                P.tr.plan(env._sinks), env.config, *(("cpu",) if P is PORT else ()))[0]))
            if "WINDOW" in sql:
                env.execute()
                rows.append(sorted(map(repr, sink.results)))
        assert kinds[0] == kinds[1]
        assert rows == [] or (rows[0] == rows[1] and rows[1])
        return
    if item == "item 19":
        # ported since: UNION ALL plans each branch on its own and unites
        # them with DataStream.union, to the JAX package's runners and rows
        # (test_torch_multi_input.py holds more statements)
        kinds, rows = [], []
        for P in PKGS:
            env, tenv = _typed_rows_env(P, fused=fused)
            sink = tenv.sql_query(sql).collect()
            kinds.append([type(r).__name__ for r in P.ex.build_runners(
                P.tr.plan(env._sinks), env.config, *(("cpu",) if P is PORT else ()))[0]])
            env.execute()
            rows.append(repr(sink.results))
        assert kinds[0] == kinds[1] and "UnionRunner" in kinds[1]
        assert rows[0] == rows[1] and rows[1] != "[]"
        return
    if item == "item 14":
        # ported since: ML_PREDICT over a registered model (table/ml.py)
        # runs in the projection, to the JAX package's rows
        # (test_torch_ml.py holds more statements)
        import importlib

        rows = []
        for P in PKGS:
            env, tenv = _typed_rows_env(P, fused=fused)
            ml = importlib.import_module(P.ds.__name__.split(".")[0] + ".table.ml")
            tenv.register_model("m", ml.FnModelProvider(lambda f: f * 2, ["amount"], ["y"]))
            sink = tenv.sql_query(sql).collect()
            env.execute()
            rows.append(repr(sink.results))
        assert rows[0] == rows[1] and rows[1] != "[]"
        return
    with pytest.raises(NotImplementedError, match=f"not ported yet: ROADMAP.md Queue A, {item}"):
        tenv.sql_query(sql)


# ---------------------------------------------------------------------------
# the SQL gateway: one round trip, rows equal to the JAX gateway's
# ---------------------------------------------------------------------------

def _gateway_round_trip(P):
    gw = P.gw.SqlGateway(port=0, auth_token="sekrit", **P.kw)
    try:
        client = P.gw.SqlGatewayClient(gw.address, auth_token="sekrit")
        sh = client.open_session()
        client.register_table(sh, "pay", ["user", "amount", "rowtime"], _ROWS[:400],
                              time_col="rowtime", types=["int", "float", "int"])
        rows = client.execute(sh, "SELECT user, SUM(amount) AS s, WINDOW_END AS we FROM pay "
                                  "GROUP BY user, TUMBLE(rowtime, INTERVAL '2' SECOND)")
        oh = client._request("POST", f"/v1/sessions/{sh}/statements",
                             {"statement": "SELECT user, COUNT(*) AS n FROM pay GROUP BY user"})
        status = client.statement_status(sh, oh["operationHandle"])
        bad = client._request("POST", f"/v1/sessions/{sh}/statements",
                              {"statement": "SELECT a.user FROM pay AS a JOIN pay AS b "
                                            "ON a.user = b.user"})
        bad_status = client.statement_status(sh, bad["operationHandle"])
        client.close_session(sh)
        req = urllib.request.Request(gw.address + "/v1/sessions", data=b"{}", method="POST")
        req.add_header("Authorization", "Bearer \xa3bogus")
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(req, timeout=10)
        assert exc.value.code == 401
        return rows, oh, status, bad, bad_status
    finally:
        gw.stop()


def test_gateway_round_trip_matches_the_jax_gateway():
    jrows, joh, jstatus, jbad, jbad_status = _gateway_round_trip(JAX)
    rows, oh, status, bad, bad_status = _gateway_round_trip(PORT)
    assert json.dumps(rows) == json.dumps(jrows) and len(rows) > 0
    assert (oh["executionPath"], oh["fallbackReason"]) == ("interpreted", "no-window")
    assert (oh["executionPath"], oh["fallbackReason"]) == (joh["executionPath"],
                                                           joh["fallbackReason"])
    assert status == jstatus
    assert (bad["executionPath"], bad["fallbackReason"]) == (jbad["executionPath"],
                                                             jbad["fallbackReason"])
    # the regular join runs since joins were ported, as the JAX gateway's
    assert bad_status == jbad_status and bad_status["status"] != "ERROR"
