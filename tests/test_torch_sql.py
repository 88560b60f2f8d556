"""SQL statements end to end through the port's TableEnvironment, held
against the JAX package's.

The statements of `tests/test_sql.py` and `tests/test_retract_sql.py`
that the port runs go through `flink_tpu.table.TableEnvironment` and the
port's `TableEnvironment(StreamExecutionEnvironment(device="cpu"))` on the
same rows (made with numpy from a seed): TUMBLE COUNT, WHERE + SUM,
WINDOW_START/WINDOW_END, HAVING, per-window ORDER BY/LIMIT, HOP, SESSION
(the session operator), multi-aggregate SELECTs (a composite accumulator
on the per-record oracle operator), projections, continuous GROUP BY with
retractions (host and device accumulators), the global continuous
aggregate, cascaded aggregation over a registered changelog table and a
GROUP BY column left out of the SELECT. Compared: every emitted row by
`repr`, in emission order (the raw changelog for continuous statements),
and the plan report's path, reason and `describe()`. The parser's own
cases and the statements whose translation refuses run through both.

Tolerance: exact, AVG included (the values are small integers, so float32
and float64 means agree here to the last bit the rows show).
"""

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")

import flink_tpu.api.datastream as j_ds  # noqa: E402
import flink_tpu.config as j_cfg  # noqa: E402
import flink_tpu.table as j_tb  # noqa: E402
import flink_tpu_torch.api.datastream as t_ds  # noqa: E402
import flink_tpu_torch.config as t_cfg  # noqa: E402
import flink_tpu_torch.table as t_tb  # noqa: E402
from jax_native_twins import jax_native_library  # noqa: E402,F401

PKGS = {"jax": (j_ds, j_cfg, j_tb, {}), "port": (t_ds, t_cfg, t_tb, {"device": "cpu"})}

_RNG = np.random.default_rng(3)
CLICKS = [{"campaign": f"c{int(c)}", "price": float(p), "rowtime": i * 100}
          for i, (c, p) in enumerate(zip(_RNG.integers(0, 3, 100), _RNG.integers(0, 7, 100)))]
VISITS = [{"user": "u1", "rowtime": 0}, {"user": "u1", "rowtime": 400},
          {"user": "u1", "rowtime": 5000}, {"user": "u2", "rowtime": 100}]
KV = [{"k": f"k{int(k)}", "v": float(v)} for k, v in
      zip(_RNG.integers(0, 3, 30), _RNG.integers(0, 20, 30))]


def _tenv(pkg, tables, batch=None, group_agg_device=None):
    ds, cfg_mod, tb, kw = PKGS[pkg]
    cfg = cfg_mod.Configuration()
    if batch is not None:
        cfg.set(cfg_mod.ExecutionOptions.BATCH_SIZE, batch)
    if group_agg_device is not None:
        cfg.set(cfg_mod.ExecutionOptions.DEVICE_GROUP_AGG, group_agg_device)
    tenv = tb.TableEnvironment(ds.StreamExecutionEnvironment(cfg, **kw))
    for name, rows, fields, rowtime in tables:
        tenv.from_rows(name, rows, tb.TableSchema(list(fields), rowtime=rowtime))
    return tenv


def _both(tables, sql, changelog=False, **kw):
    """The statement through both packages: (port rows, port report),
    after checking rows and reports equal."""
    out = []
    for pkg in PKGS:
        tenv = _tenv(pkg, tables, **kw)
        rows = (tenv.execute_sql_to_changelog(sql) if changelog
                else tenv.execute_sql_to_list(sql))
        r = tenv.last_plan_report
        out.append((rows, (r.path, r.reason, r.describe())))
    assert repr(out[1][0]) == repr(out[0][0])
    assert out[1][1] == out[0][1]
    return out[1]


CLICKS_T = [("clicks", CLICKS, ("campaign", "price", "rowtime"), "rowtime")]
VISITS_T = [("visits", VISITS, ("user", "rowtime"), "rowtime")]
KV_T = [("t", KV, ("k", "v"), None)]


def test_sql_tumble_count_end_to_end():
    out, report = _both(CLICKS_T, "SELECT campaign, COUNT(*) AS n FROM clicks "
                                  "GROUP BY campaign, TUMBLE(rowtime, INTERVAL '1' SECOND)")
    assert sum(r["n"] for r in out) == 100
    assert {r["campaign"] for r in out} == {"c0", "c1", "c2"}
    assert report[:2] == ("interpreted", "untyped-schema")


def test_sql_where_and_sum():
    out, _r = _both(CLICKS_T, "SELECT campaign, SUM(price) AS total FROM clicks WHERE price >= 5 "
                              "GROUP BY campaign, TUMBLE(rowtime, INTERVAL '10' SECOND)")
    expected = {}
    for r in CLICKS:
        if r["price"] >= 5:
            expected[r["campaign"]] = expected.get(r["campaign"], 0) + r["price"]
    assert {r["campaign"]: r["total"] for r in out} == expected


def test_sql_window_bounds_columns():
    out, _r = _both(CLICKS_T, "SELECT campaign, WINDOW_START AS ws, WINDOW_END AS we, "
                              "COUNT(*) AS n FROM clicks "
                              "GROUP BY campaign, TUMBLE(rowtime, INTERVAL '1' SECOND)")
    assert out and all(r["we"] - r["ws"] == 1000 and r["ws"] % 1000 == 0 for r in out)


def test_sql_having_filters_output_rows():
    out, _r = _both(CLICKS_T, "SELECT campaign, SUM(price) AS total FROM clicks "
                              "GROUP BY campaign, TUMBLE(rowtime, INTERVAL '10' SECOND) "
                              "HAVING total > 100")
    totals = {}
    for r in CLICKS:
        totals[r["campaign"]] = totals.get(r["campaign"], 0) + r["price"]
    assert {r["campaign"]: r["total"] for r in out} == {c: t for c, t in totals.items() if t > 100}


def test_sql_order_by_limit_per_window_topn():
    out, _r = _both(CLICKS_T, "SELECT campaign, COUNT(*) AS n, WINDOW_END AS we FROM clicks "
                              "GROUP BY campaign, TUMBLE(rowtime, INTERVAL '1' SECOND) "
                              "ORDER BY n DESC, campaign ASC LIMIT 2")
    for w in {r["we"] for r in out}:
        ns = [r["n"] for r in out if r["we"] == w]
        assert ns == sorted(ns, reverse=True) and len(ns) <= 2


@pytest.mark.parametrize("agg", ["COUNT(*)", "SUM(price)", "MIN(price)", "MAX(price)",
                                 "AVG(price)"])
def test_sql_hop_query_device_path(agg):
    out, _r = _both(CLICKS_T, f"SELECT campaign, {agg} AS x, WINDOW_END AS we FROM clicks "
                              "GROUP BY campaign, HOP(rowtime, INTERVAL '1' SECOND, "
                              "INTERVAL '2' SECOND)")
    if agg == "COUNT(*)":
        assert sum(r["x"] for r in out) == 200      # every record in 2 windows


@pytest.mark.parametrize("agg", ["COUNT(*)", "SUM(price)", "AVG(price)", "MAX(price)"])
def test_sql_session_query(agg):
    out, report = _both(CLICKS_T, f"SELECT campaign, {agg} AS x FROM clicks "
                                  "GROUP BY campaign, SESSION(rowtime, INTERVAL '1' SECOND)")
    assert report[:2] == ("interpreted", "session-window") and out


def test_sql_session_query_on_visits():
    out, report = _both(VISITS_T, "SELECT user, COUNT(*) AS n FROM visits "
                                  "GROUP BY user, SESSION(rowtime, INTERVAL '1' SECOND)")
    assert sorted((r["user"], r["n"]) for r in out) == [("u1", 1), ("u1", 2), ("u2", 1)]


_MULTI = {
    "tumble_count_sum_max": "SELECT campaign, COUNT(*) AS n, SUM(price) AS s, MAX(price) AS m "
                            "FROM clicks GROUP BY campaign, TUMBLE(rowtime, INTERVAL '1' SECOND)",
    "hop_min_avg": "SELECT campaign, MIN(price) AS lo, AVG(price) AS a FROM clicks "
                   "GROUP BY campaign, HOP(rowtime, INTERVAL '1' SECOND, INTERVAL '3' SECOND)",
    "session_bounds": "SELECT campaign, COUNT(*) AS n, SUM(price) AS s, WINDOW_START AS ws, "
                      "WINDOW_END AS we FROM clicks "
                      "GROUP BY campaign, SESSION(rowtime, INTERVAL '150' MILLISECOND)",
    "having": "SELECT campaign, COUNT(*) AS n, AVG(price) AS a FROM clicks "
              "GROUP BY campaign, TUMBLE(rowtime, INTERVAL '2' SECOND) HAVING n > 6",
    "order_limit": "SELECT campaign, SUM(price) AS s, MAX(price) AS m FROM clicks "
                   "GROUP BY campaign, TUMBLE(rowtime, INTERVAL '2' SECOND) "
                   "ORDER BY s DESC LIMIT 2",
    "single_non_device_agg_pair": "SELECT campaign, MAX(price) AS m, MIN(price) AS lo "
                                  "FROM clicks GROUP BY campaign, "
                                  "TUMBLE(rowtime, INTERVAL '1' SECOND)",
}


@pytest.mark.parametrize("batch", [None, 8])
@pytest.mark.parametrize("name", sorted(_MULTI))
def test_sql_multi_aggregate_select(name, batch):
    """Several aggregates in one windowed SELECT: a composite accumulator
    on the per-record oracle operator in both packages, with the JAX plan
    report (interpreted, multi-aggregate)."""
    out, report = _both(CLICKS_T, _MULTI[name], batch=batch)
    assert out and report[0] == "interpreted"
    assert report[1] == ("session-window" if name == "session_bounds" else "multi-aggregate")


def test_sql_projection_only():
    out, report = _both(CLICKS_T, "SELECT campaign FROM clicks WHERE price = 6")
    assert all(set(r) == {"campaign"} for r in out)
    assert len(out) == sum(r["price"] == 6 for r in CLICKS)
    assert report[:2] == ("interpreted", "no-aggregate")


@pytest.mark.parametrize("sql,err,match", [
    ("SELECT campaign FROM clicks HAVING campaign = 'c0'", ValueError, "HAVING requires GROUP BY"),
    ("SELECT campaign FROM clicks ORDER BY campaign LIMIT 3", NotImplementedError, "per window"),
    ("SELECT campaign, COUNT(*) AS n FROM clicks GROUP BY TUMBLE(rowtime, INTERVAL '1' SECOND)",
     NotImplementedError, "require GROUP BY"),
    ("SELECT campaign, SUM(price) AS total FROM clicks "
     "GROUP BY campaign, TUMBLE(rowtime, INTERVAL '10' SECOND) "
     "UNION ALL SELECT campaign FROM clicks", ValueError, "same columns"),
    ("SELECT campaign, COUNT(*) AS n FROM clicks GROUP BY campaign HAVING n > 1",
     NotImplementedError, "HAVING/ORDER BY/LIMIT on continuous"),
    ("SELECT nope, COUNT(*) AS n FROM clicks GROUP BY nope, TUMBLE(rowtime, INTERVAL '1' SECOND)",
     ValueError, "unknown column"),
])
def test_refused_statements_refuse_alike(sql, err, match):
    for pkg in PKGS:
        tenv = _tenv(pkg, CLICKS_T)
        with pytest.raises(err, match=match):
            tenv.execute_sql_to_list(sql)


# ---------------------------------------------------------------------------
# continuous (non-windowed) aggregation: retract changelogs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batch", [None, 8])
@pytest.mark.parametrize("device", [False, True])
def test_sql_continuous_group_by(batch, device):
    sql = "SELECT k, COUNT(*) AS c, SUM(v) AS s, AVG(v) AS a FROM t GROUP BY k"
    log, report = _both(KV_T, sql, changelog=True, batch=batch, group_agg_device=device)
    kinds = {r["__rowkind__"] for r in log}
    assert kinds == ({"+I"} if batch is None else {"+I", "-U", "+U"})
    assert report[:2] == ("interpreted", "no-window")
    got = _both(KV_T, sql, batch=batch, group_agg_device=device)[0]
    expect = {}
    for r in KV:
        e = expect.setdefault(r["k"], [0, 0.0])
        e[0] += 1
        e[1] += r["v"]
    assert {r["k"]: (r["c"], r["s"]) for r in got} == {k: tuple(e) for k, e in expect.items()}


def test_sql_global_continuous_aggregate():
    rows = [{"k": "x", "v": float(i)} for i in range(10)]
    got, _r = _both([("t", rows, ("k", "v"), None)], "SELECT COUNT(*) AS c, SUM(v) AS s FROM t")
    assert got == [{"c": 10, "s": float(sum(range(10)))}]


def test_sql_null_semantics_in_aggregates():
    rows = [{"k": "a", "v": 1.0}, {"k": "a", "v": None}, {"k": "b", "v": None}]
    got, _r = _both([("t", rows, ("k", "v"), None)],
                    "SELECT k, COUNT(*) AS n, COUNT(v) AS nv, SUM(v) AS s, MIN(v) AS mn "
                    "FROM t GROUP BY k")
    assert sorted(got, key=lambda r: r["k"]) == [
        {"k": "a", "n": 2, "nv": 1, "s": 1.0, "mn": 1.0},
        {"k": "b", "n": 1, "nv": 0, "s": None, "mn": None}]


def test_groupby_column_not_in_select_is_projected_away():
    rows = [{"k": "a"}, {"k": "a"}, {"k": "b"}]
    got, _r = _both([("t", rows, ("k",), None)], "SELECT COUNT(*) AS c FROM t GROUP BY k")
    assert sorted(r["c"] for r in got) == [1, 2] and all(set(r) == {"c"} for r in got)


def test_composite_continuous_group_key():
    rows = [{"a": f"x{i % 2}", "b": i % 3, "v": float(i)} for i in range(24)]
    got, _r = _both([("t", rows, ("a", "b", "v"), None)],
                    "SELECT a, b, SUM(v) AS s, MAX(v) AS m FROM t GROUP BY a, b", changelog=True,
                    batch=5)
    assert got


def _cascade(pkg, second_sql, batch=None):
    ds, cfg_mod, tb, kw = PKGS[pkg]
    cfg = cfg_mod.Configuration()
    if batch is not None:
        cfg.set(cfg_mod.ExecutionOptions.BATCH_SIZE, batch)
    tenv = tb.TableEnvironment(ds.StreamExecutionEnvironment(cfg, **kw))
    rows = ([{"k": "a", "v": 1.0}] * 3 + [{"k": "b", "v": 1.0}] * 3 + [{"k": "c", "v": 1.0}] * 2)
    tenv.from_rows("t", rows, tb.TableSchema(["k", "v"]))
    counts = tenv.sql_query("SELECT k, COUNT(*) AS c FROM t GROUP BY k")
    tenv.register_table("counts", counts, tb.TableSchema(["k", "c"]))
    return (tenv.execute_sql_to_changelog(second_sql), tenv.last_plan_report.describe(),
            tenv)


@pytest.mark.parametrize("batch", [None, 3])
def test_sql_cascaded_aggregation(batch):
    sql = "SELECT c, COUNT(*) AS n FROM counts GROUP BY c"
    jlog, jdesc, _ = _cascade("jax", sql, batch)
    log, desc, _ = _cascade("port", sql, batch)
    assert repr(log) == repr(jlog) and desc == jdesc
    assert sorted(t_tb.materialize(log), key=lambda r: r["c"]) == [
        {"c": 2, "n": 1}, {"c": 3, "n": 2}]


def test_plain_projection_preserves_row_kinds():
    sql = "SELECT k, c FROM counts"
    jlog, _jd, _ = _cascade("jax", sql, batch=3)
    log, _d, _ = _cascade("port", sql, batch=3)
    assert repr(log) == repr(jlog)
    assert sorted(t_tb.materialize(log), key=lambda r: r["k"]) == [
        {"k": "a", "c": 3}, {"k": "b", "c": 3}, {"k": "c", "c": 2}]


# ---------------------------------------------------------------------------
# the parser
# ---------------------------------------------------------------------------

def test_parse_basic_query():
    q = t_tb.parse_query(
        "SELECT campaign, COUNT(*) AS n, SUM(price) FROM clicks "
        "WHERE price > 10 AND campaign != 'spam' "
        "GROUP BY campaign, TUMBLE(rowtime, INTERVAL '10' SECOND)")
    assert q.table == "clicks"
    assert [i.output_name for i in q.select] == ["campaign", "n", "sum_price"]
    assert q.group_by == ["campaign"]
    assert q.window.kind == "tumble" and q.window.size_ms == 10_000
    assert q.where({"price": 11, "campaign": "ads"}) is True
    assert q.where({"price": 11, "campaign": "spam"}) is False
    assert q.where({"price": None, "campaign": "ads"}) is False


@pytest.mark.parametrize("sql", [
    "SELECT k, COUNT(*) FROM t GROUP BY k, HOP(ts, INTERVAL '1' SECOND, INTERVAL '10' SECOND)",
    "SELECT k, SUM(v) FROM t GROUP BY k, SESSION(ts, INTERVAL '30' SECONDS)",
    "SELECT a.x, b.y FROM l AS a LEFT OUTER JOIN r AS b ON b.k = a.k WHERE a.x > -2.5",
    "SELECT k, MAX(v) AS m FROM t WHERE (v < 1 OR v > 5) AND k <> 'z' "
    "GROUP BY k, TUMBLE(ts, INTERVAL '250' MILLISECOND) HAVING m >= 2 ORDER BY m DESC, k LIMIT 4",
    "SELECT ML_PREDICT(model, a, b) AS p, k FROM t",
    "SELECT k FROM t UNION ALL SELECT k FROM u",
])
def test_parser_gives_the_jax_query(sql):
    import dataclasses

    from flink_tpu.table.sql import parse_query as jparse

    def plain(q):
        d = dataclasses.asdict(q)
        for key in ("where", "having"):
            d.pop(key, None)
        if d.get("union_all"):
            for key in ("where", "having"):
                d["union_all"].pop(key, None)
        return repr(d)

    assert plain(t_tb.parse_query(sql)) == plain(jparse(sql))
