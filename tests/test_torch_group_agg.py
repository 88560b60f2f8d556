"""The port's continuous aggregate held against the JAX package's.

The `continuous_aggregate` jobs of `tests/test_retract_sql.py` run through
both packages' `env.execute()` (the port's with `device="cpu"`): host and
device accumulators, mini-batch on and off, retractions and NULLs. The
emitted changelogs are compared row for row, and the JAX tests' per-record
oracle (`oracle_changelog`) holds the port too. `GroupAggRunner`
snapshots restore across the two packages in both directions, on both
paths.

Tolerance: counts, kinds and keys exact; SUM bit-equal on the host path
(float64 in both) and on the device path (float32 in both, integer-valued
payloads); AVG to rtol 1e-6.
"""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from flink_tpu.api.datastream import StreamExecutionEnvironment as JaxEnv  # noqa: E402
from flink_tpu.config import Configuration as JaxConfiguration  # noqa: E402
from flink_tpu.config import ExecutionOptions as JaxExecutionOptions  # noqa: E402
from flink_tpu.graph.transformation import Step as JaxStep  # noqa: E402
from flink_tpu.graph.transformation import Transformation as JaxTransformation  # noqa: E402
from flink_tpu.runtime.group_agg_operator import GroupAggRunner as JaxRunner  # noqa: E402
from flink_tpu.utils.arrays import obj_array  # noqa: E402
from flink_tpu_torch.api.datastream import StreamExecutionEnvironment  # noqa: E402
from flink_tpu_torch.config import Configuration, ExecutionOptions  # noqa: E402
from flink_tpu_torch.graph.transformation import Step, Transformation  # noqa: E402
from flink_tpu_torch.runtime import group_agg_operator as tga  # noqa: E402
from flink_tpu_torch.table.changelog import (  # noqa: E402
    DELETE,
    INSERT,
    ROW_KIND_FIELD,
    UPDATE_AFTER,
    UPDATE_BEFORE,
    materialize,
    with_kind,
)
from tests.test_retract_sql import _mixed_stream, oracle_changelog  # noqa: E402

SPECS = [("COUNT", None), ("SUM", "v"), ("MIN", "v"), ("MAX", "v"), ("AVG", "v")]
NAMES = ["c", "s", "mn", "mx", "a"]
LINEAR = [("COUNT", None), ("SUM", "v"), ("AVG", "v"), ("COUNT", "v")]
LINEAR_NAMES = ["c", "s", "a", "cv"]


def _run(pkg, rows, specs, names, batch=None, **kw):
    if pkg == "jax":
        cfg = JaxConfiguration()
        if batch:
            cfg.set(JaxExecutionOptions.BATCH_SIZE, batch)
        env = JaxEnv(cfg)
    else:
        cfg = Configuration()
        if batch:
            cfg.set(ExecutionOptions.BATCH_SIZE, batch)
        env = StreamExecutionEnvironment(cfg, device="cpu")
    sink = (env.from_collection(list(rows)).key_by(lambda r: r["k"])
            .continuous_aggregate(specs, ["k"], names, **kw).collect())
    env.execute("group-agg")
    return sink.results


def _same_changelog(port, jax, names, exact=("c", "cv", "mn", "mx", "s")):
    assert len(port) == len(jax) > 0
    for p, j in zip(port, jax):
        assert set(p) == set(j)
        assert p[ROW_KIND_FIELD] == j[ROW_KIND_FIELD] and p["k"] == j["k"]
        for n in names:
            if n in exact or p[n] is None or j[n] is None:
                assert p[n] == j[n], n
            else:
                assert p[n] == pytest.approx(j[n], rel=1e-6), n


def _with_nulls(rows, seed=1, frac=0.15):
    """Some inserted rows get a NULL value (retractions carry the row as
    inserted, so the changelog stays consistent)."""
    rng = np.random.default_rng(seed)
    nulled = {}
    out = []
    for r in rows:
        key = (r["k"], r["v"])
        if r.get(ROW_KIND_FIELD) is None:
            if rng.random() < frac:
                nulled[key] = nulled.get(key, 0) + 1
                out.append({"k": r["k"], "v": None})
                continue
        elif nulled.get(key):
            nulled[key] -= 1
            out.append(with_kind({"k": r["k"], "v": None}, r[ROW_KIND_FIELD]))
            continue
        out.append(r)
    return out


@pytest.mark.parametrize("mini_batch", [False, True])
def test_host_path_matches_jax(mini_batch):
    rows = _mixed_stream()
    port = _run("port", rows, SPECS, NAMES, mini_batch=mini_batch, batch=64)
    jax = _run("jax", rows, SPECS, NAMES, mini_batch=mini_batch, batch=64)
    _same_changelog(port, jax, NAMES)


def test_per_record_changelog_matches_oracle():
    rows = _mixed_stream()
    port = _run("port", rows, SPECS, NAMES, mini_batch=False)
    ref = oracle_changelog(rows, lambda r: r["k"], SPECS, ["k"], NAMES)
    assert len(port) == len(ref)
    for g, r in zip(port, ref):
        assert g[ROW_KIND_FIELD] == r[ROW_KIND_FIELD] and g["k"] == r["k"]
        assert (g["c"], g["mn"], g["mx"]) == (r["c"], r["mn"], r["mx"])
        assert g["s"] == pytest.approx(r["s"]) and g["a"] == pytest.approx(r["a"])


@pytest.mark.parametrize("mini_batch", [False, True])
def test_device_path_matches_jax(mini_batch):
    rows = _mixed_stream(seed=23, n=300)
    port = _run("port", rows, LINEAR, LINEAR_NAMES, mini_batch=mini_batch, device=True,
                batch=32)
    jax = _run("jax", rows, LINEAR, LINEAR_NAMES, mini_batch=mini_batch, device=True,
               batch=32)
    _same_changelog(port, jax, LINEAR_NAMES)
    host = _run("port", rows, LINEAR, LINEAR_NAMES, mini_batch=mini_batch, batch=32)
    _same_changelog(port, host, LINEAR_NAMES)


@pytest.mark.parametrize("device", [False, True])
def test_nulls_match_jax(device):
    rows = _with_nulls(_mixed_stream(seed=41, n=300))
    assert any(r["v"] is None for r in rows)
    specs, names = (LINEAR, LINEAR_NAMES) if device else (SPECS + [("COUNT", "v")],
                                                          NAMES + ["cv"])
    port = _run("port", rows, specs, names, device=device, batch=50)
    jax = _run("jax", rows, specs, names, device=device, batch=50)
    _same_changelog(port, jax, names)
    # COUNT(v) skips the NULLs COUNT(*) counts
    assert any(r["cv"] < r["c"] for r in port)


def test_minibatch_materializes_identically():
    rows = _mixed_stream(seed=11)
    specs, names = [("COUNT", None), ("SUM", "v"), ("MIN", "v")], ["c", "s", "mn"]
    per_record = _run("port", rows, specs, names, mini_batch=False)
    mini = _run("port", rows, specs, names, mini_batch=True)
    assert len(mini) <= len(per_record)
    key = lambda r: r["k"]  # noqa: E731
    assert sorted(materialize(per_record), key=key) == sorted(materialize(mini), key=key)


@pytest.mark.parametrize("device", [False, True])
def test_insert_then_full_retract_emits_delete(device):
    rows = [{"k": "a", "v": 1.0}, {"k": "a", "v": 2.0},
            with_kind({"k": "a", "v": 1.0}, DELETE), with_kind({"k": "a", "v": 2.0}, DELETE),
            {"k": "a", "v": 4.0}]
    got = _run("port", rows, [("COUNT", None), ("SUM", "v")], ["c", "s"], mini_batch=False,
               device=device)
    assert [r[ROW_KIND_FIELD] for r in got] == [
        INSERT, UPDATE_BEFORE, UPDATE_AFTER, UPDATE_BEFORE, UPDATE_AFTER, DELETE, INSERT]
    # the freed slot is reused clean
    assert (got[-1]["c"], got[-1]["s"]) == (1, 4.0)
    assert materialize(got) == [{"k": "a", "c": 1, "s": 4.0}]


def test_min_recomputes_on_retraction_of_current_min():
    rows = [{"k": "a", "v": 5.0}, {"k": "a", "v": 3.0}, with_kind({"k": "a", "v": 3.0}, DELETE)]
    got = _run("port", rows, [("MIN", "v")], ["mn"], mini_batch=False)
    assert [r["mn"] for r in got] == [5.0, 5.0, 3.0, 3.0, 5.0]


def test_retracting_unseen_row_raises():
    with pytest.raises(ValueError, match="retract"):
        _run("port", [with_kind({"k": "a", "v": 1.0}, DELETE)], [("COUNT", None)], ["c"],
             mini_batch=False)


def test_device_minmax_is_refused():
    with pytest.raises(ValueError, match="MIN/MAX"):
        _run("port", [{"k": "a", "v": 1.0}], [("MIN", "v")], ["mn"], device=True)


def test_config_options_select_the_path():
    cfg = Configuration()
    cfg.set(ExecutionOptions.DEVICE_GROUP_AGG, True)
    cfg.set(ExecutionOptions.MINI_BATCH_GROUP_AGG, False)
    runner = tga.GroupAggRunner(_step(Transformation, Step, {}), cfg, torch.device("cpu"))
    assert runner.device and not runner.mini_batch and runner._dev is not None


def _step(transformation, step, over):
    t = transformation("group_agg", "ga", [], dict({
        "key_selector": lambda r: r["k"], "specs": [("COUNT", None), ("SUM", "v"), ("AVG", "v")],
        "key_fields": ["k"], "out_names": ["c", "s", "a"], "mini_batch": None,
        "device": None}, **over))
    return step(chain=[], terminal=t, partitioning="forward", inputs=[])


class _Sink:
    def __init__(self):
        self.rows = []

    def on_batch(self, vals, ts):
        self.rows.extend(vals.tolist())


def _runner(pkg, device):
    over = {"device": device, "mini_batch": True}
    if pkg == "jax":
        r = JaxRunner(_step(JaxTransformation, JaxStep, over), JaxConfiguration())
    else:
        r = tga.GroupAggRunner(_step(Transformation, Step, over), Configuration(),
                               torch.device("cpu"))
    r.downstream = _Sink()
    return r


def _feed(r, rows, lo, hi, step=40):
    for a in range(lo, hi, step):
        b = min(a + step, hi)
        r.on_batch(obj_array(rows[a:b]), np.arange(a, b, dtype=np.int64))


@pytest.mark.parametrize("device", [False, True])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_snapshot_restores_across_packages(direction, device):
    src, dst = direction.split("_to_")
    # enough keys to grow the capacity past 1024 slots before the snapshot
    rows = _mixed_stream(seed=31, n=4000, n_keys=8000, retract_frac=0.05)
    half = len(rows) // 2
    straight = _runner(src, device)
    _feed(straight, rows, 0, len(rows))
    a = _runner(src, device)
    _feed(a, rows, 0, half)
    snap = a.snapshot()
    assert snap["cap"] == 2048
    b = _runner(dst, device)
    b.restore(snap)
    _feed(b, rows, half, len(rows))
    _same_changelog(a.downstream.rows + b.downstream.rows, straight.downstream.rows,
                    ["c", "s", "a"])


def test_device_step_counts_one_call_a_batch():
    r = _runner("port", True)
    tga.CALLS["group_agg_step"] = 0
    _feed(r, _mixed_stream(seed=3, n=200), 0, 200)
    assert tga.CALLS["group_agg_step"] == 5
