"""The port's fluent Table API held against the JAX package's.

The cases of `tests/test_sql.py`'s fluent-API tests that the port runs
(one aggregate a call), with string and composite group keys: where +
window + group_by + aggregate on TUMBLE, SLIDE and SESSION windows,
having/order_by/limit, projections, and the misuse errors. Each goes
through `flink_tpu.table.TableEnvironment(...).table(...)` and the port's
(`device="cpu"`) on the same rows, made with numpy from a seed, and the
emitted rows must be equal by `repr`, in emission order. Several
aggregates in one call run on the per-record oracle operator in both.

Tolerance: exact (small integer values). One difference of type is
allowed, not of value: where the JAX session operator merges on its host
path it accumulates a float sum in an int64 array and emits an int (a
reference fault, ROADMAP Queue C); the port emits the float. Session
SUM rows are therefore compared with their values as floats.
"""

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")

import flink_tpu.api.datastream as j_ds  # noqa: E402
import flink_tpu.table as j_tb  # noqa: E402
import flink_tpu.table.api as j_api  # noqa: E402
import flink_tpu_torch.api.datastream as t_ds  # noqa: E402
import flink_tpu_torch.table as t_tb  # noqa: E402
import flink_tpu_torch.table.api as t_api  # noqa: E402
from jax_native_twins import jax_native_library  # noqa: E402,F401

PKGS = {"jax": (j_ds, j_tb, j_api, {}), "port": (t_ds, t_tb, t_api, {"device": "cpu"})}

_RNG = np.random.default_rng(5)
CLICKS = [{"campaign": f"c{int(c)}", "region": int(r), "price": float(p), "rowtime": i * 100}
          for i, (c, r, p) in enumerate(zip(_RNG.integers(0, 3, 120), _RNG.integers(0, 2, 120),
                                            _RNG.integers(0, 7, 120)))]


def _table(pkg):
    ds, tb, api, kw = PKGS[pkg]
    tenv = tb.TableEnvironment(ds.StreamExecutionEnvironment(**kw))
    tenv.from_rows("clicks", CLICKS, tb.TableSchema(["campaign", "region", "price", "rowtime"],
                                                    rowtime="rowtime"))
    return tenv.table("clicks"), api


def _both(build, value_as_float=None):
    out = [build(*_table(pkg)) for pkg in PKGS]
    if value_as_float:
        out = [[dict(r, **{value_as_float: float(r[value_as_float])}) for r in rows]
               for rows in out]
    assert repr(out[1]) == repr(out[0])
    return out[1]


WINDOWS = {
    "tumble": lambda api: api.Tumble.of_ms(1000),
    "slide": lambda api: api.Slide.of_ms(2000, 1000),
    "session": lambda api: api.Session.with_gap_ms(1000),
}


_GRID = [(w, k, a) for w in ("tumble", "slide")
         for k in (("campaign",), ("campaign", "region"))
         for a in (("count", "*"), ("sum", "price"), ("max", "price"), ("avg", "price"))]
# a session case costs the JAX operator a compile of ~10 s: three of them
_SESSION = [("session", ("campaign",), ("count", "*")),
            ("session", ("campaign", "region"), ("sum", "price")),
            ("session", ("campaign",), ("avg", "price"))]


@pytest.mark.parametrize("window,keys,agg", _GRID + _SESSION)
def test_windowed_aggregate_matches_the_jax_table_api(window, keys, agg):
    loose = "x" if (window, agg[0]) == ("session", "sum") else None
    rows = _both(lambda t, api: t.where(lambda r: r["price"] > 1, label="price>1")
                 .window(WINDOWS[window](api)).group_by(*keys).aggregate(x=agg).to_list(),
                 value_as_float=loose)
    assert rows and all(set(r) == set(keys) | {"x"} for r in rows)
    assert all(type(r["campaign"]) is str for r in rows)


def test_having_order_limit_match_the_jax_table_api():
    rows = _both(lambda t, api: t.window(api.Tumble.of_ms(1000)).group_by("campaign")
                 .having(lambda r: r["n"] > 1, label="n>1").order_by("-n", "campaign")
                 .limit(1).aggregate(n=("count",)).to_list())
    assert 0 < len(rows) <= 12


def test_projection_matches_the_jax_table_api():
    rows = _both(lambda t, api: t.where(lambda r: r["region"] == 1).select("campaign", "price")
                 .to_list())
    assert rows and all(set(r) == {"campaign", "price"} for r in rows)


@pytest.mark.parametrize("build,err,match", [
    (lambda t, api: t.window(api.Tumble.of_ms(1000)).group_by("campaign")
     .aggregate(total=("sum",)), ValueError, "needs a column"),
    (lambda t, api: t.window(api.Tumble.of_ms(1000)).group_by("campaign").to_list(),
     ValueError, "aggregate"),
    (lambda t, api: t.group_by("campaign").aggregate(n=("count",)), ValueError, "requires .window"),
    (lambda t, api: t.window(api.Tumble.of_ms(1000)).aggregate(n=("count",)), ValueError,
     "requires .group_by"),
    (lambda t, api: t.window(api.Tumble.of_ms(1000)).group_by("campaign")
     .aggregate(x=("median", "price")), ValueError, "unknown aggregate"),
])
def test_misuse_raises_alike(build, err, match):
    for pkg in PKGS:
        t, api = _table(pkg)
        with pytest.raises(err, match=match):
            build(t, api)


def test_several_aggregates_raise_naming_the_oracle_item():
    # item 18 is ported: several aggregates in one call run on the composite
    # accumulator over the per-record oracle operator, to the JAX rows
    rows = _both(lambda t, api: t.window(api.Tumble.of_ms(1000)).group_by("campaign")
                 .aggregate(n=("count", "*"), total=("sum", "price"), hi=("max", "price"))
                 .to_list())
    assert rows and all(set(r) >= {"campaign", "n", "total", "hi"} for r in rows)
