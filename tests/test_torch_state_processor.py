"""The port's State Processor API against the JAX package's.

Savepoints of a fused job (the `[K, S]` ring K1 fills on the card, read
from the fused operator's `pipe`), a fused count job over a numeric column
and a heap-state job (the per-record oracle's reduce) are written by either
package's JobRuntime and read by both packages' `SavepointReader`:
operator uids, `records_in`, source state, `keyed_state` and
`pending_output` are equal. A savepoint patched (`transform_columnar_state`,
sum x 10) or renamed by either package's `SavepointWriter` resumes in
either package with equal rows, and the patched total obeys
tests/test_state_processor.py's formula. Jobs and helpers are
tests/test_torch_checkpointing.py's (2400 records, batch 80, 13 keys).

Tolerance: exact (integer counts, integer-valued sums).
"""

import pytest

pytest.importorskip("jax")

import flink_tpu.checkpoint.storage as jst  # noqa: E402
import flink_tpu.state_processor as jsp  # noqa: E402
import flink_tpu_torch.checkpoint.storage as tst  # noqa: E402
import flink_tpu_torch.graph.transformation as ttr  # noqa: E402
import flink_tpu_torch.state_processor as tsp  # noqa: E402
from flink_tpu_torch.runtime.minicluster import JobStatus, MiniCluster  # noqa: E402
from jax_native_twins import jax_native_library  # noqa: E402,F401
from test_torch_checkpointing import N, _job, _norm, _rows, _runtime, _Stop, _to_jax  # noqa: E402

SP = {"jax": jsp, "port": tsp}
BOTH = ("jax", "port")
# the shapes whose savepoints the reader reads: the fused operator over a
# record (sum) and over a numeric column (count), and heap state
SHAPES = ("fused_sum", "fused_count", "oracle_reduce")


def _take_savepoint(pkg: str, shape: str, path: str, at: int = 11) -> str:
    """Run `shape` in `pkg` and write a savepoint at the `at`-th step
    boundary, the JobRuntime's own savepoint path."""
    env, _sink = _job(pkg, shape)
    rt = _runtime(pkg, env)
    steps = []

    def savepoint_request():
        steps.append(1)
        if len(steps) == at:
            rt._write_savepoint(path)
            raise _Stop()

    with pytest.raises(_Stop):
        rt.run(savepoint_request=savepoint_request)
    return path


def _load(pkg: str, path: str):
    """`pkg`'s reader over the savepoint file. The JAX reader takes a file
    written by the port after its classes are mapped to the JAX package's,
    as the JAX restore needs (the port's storage maps the JAX package's
    itself)."""
    if pkg == "port":
        return tsp.SavepointReader.load(path)
    store = jst.FsCheckpointStorage(path)
    return jsp.SavepointReader(_to_jax(store.load(store.latest()[1])))


def _uid(reader, shape: str) -> str:
    return next(u for u in reader.operator_uids() if u.startswith("window_aggregate"))


def _entries(reader, uid):
    return sorted((repr(_norm(e)) for e in reader.keyed_state(uid)))


@pytest.mark.parametrize("writer", BOTH)
@pytest.mark.parametrize("shape", SHAPES)
def test_savepoints_of_either_package_read_the_same_in_both(tmp_path, shape, writer):
    sp = _take_savepoint(writer, shape, str(tmp_path / "sp"))
    readers = {pkg: _load(pkg, sp) for pkg in BOTH}
    seen = {}
    for pkg, r in readers.items():
        uid = _uid(r, shape)
        entries = list(r.keyed_state(uid))
        seen[pkg] = (sorted(r.operator_uids()), r.records_in(), _entries(r, uid),
                     sorted(repr(_norm(x)) for x in r.pending_output(uid)),
                     sorted(r.source_states()))
        assert entries and r.records_in() > 0
    assert seen["port"] == seen["jax"]
    # the savepoint of the other package reads the same as this one's
    other = _take_savepoint("jax" if writer == "port" else "port", shape, str(tmp_path / "o"))
    assert seen["port"][1:4] == (lambda r: (r.records_in(), _entries(r, _uid(r, shape)),
                                            sorted(repr(_norm(x)) for x in
                                                   r.pending_output(_uid(r, shape)))))(
        _load("port", other))


def test_fused_keyed_state_is_the_ring_model(tmp_path):
    """The port's reader over a fused savepoint gives, per (key, slice),
    the count and sum of the records taken before the savepoint that the
    ring still holds: the JAX reader's entries, and a numpy model of the
    stream's first records_in() records."""
    import numpy as np

    from test_torch_checkpointing import KEYS

    sp = _take_savepoint("port", "fused_sum", str(tmp_path / "sp"))
    r = tsp.SavepointReader.load(sp)
    uid = _uid(r, "fused_sum")
    n = r.records_in()
    idx = np.arange(N)
    ts = idx * 11 + (idx % 5) * 3
    keys, vals = idx * 7919 % KEYS, (idx % 4).astype(float)
    # the source's 3 splits are read in order; the first n records of the
    # concatenation are the ones taken
    model = {}
    for i in range(n):
        cell = model.setdefault((int(keys[i]), int(ts[i] // 300)), [0, 0.0])
        cell[0] += 1
        cell[1] += vals[i]
    got = {(k, s): (f["count"], f["sum"]) for k, s, f in r.keyed_state(uid)}
    assert got and all(model[c] == [cnt, sm] for c, (cnt, sm) in got.items())
    assert sum(c for c, _s in got.values()) <= n


def _resume(pkg: str, shape: str, path: str):
    """Rows of `shape` resumed in `pkg` from the savepoint at `path`: the
    port through its MiniCluster's savepoint restore, the JAX package
    through its JobRuntime's restore of the file's data."""
    env, sink = _job(pkg, shape)
    if pkg == "port":
        client = MiniCluster.get_shared().submit(ttr.plan(env._sinks), env.config, "resume",
                                                 savepoint_restore_path=path, device="cpu")
        assert client.wait(60) == JobStatus.FINISHED, client.error
        return _rows(sink)
    store = jst.FsCheckpointStorage(path)
    rt = _runtime(pkg, env)
    rt.restore(_to_jax(store.load(store.latest()[1])))
    rt.run()
    return _rows(sink)


@pytest.mark.parametrize("patcher", BOTH)
@pytest.mark.parametrize("taker", BOTH)
def test_a_patched_savepoint_resumes_with_equal_rows_in_both(tmp_path, taker, patcher):
    sp = _take_savepoint(taker, "fused_sum", str(tmp_path / "sp"))
    reader = _load(patcher, sp)
    uid = _uid(reader, "fused_sum")
    in_flight = sum(e[2]["sum"] for e in reader.keyed_state(uid))
    pending = sum(v for _k, _w, v, _t in reader.pending_output(uid))
    records = reader.records_in()
    writer = SP[patcher].SavepointWriter.from_reader(reader)
    writer.transform_columnar_state(uid, lambda name, arr: arr * 10 if name == "sum" else arr)
    patched = str(tmp_path / "patched")
    writer.write(patched)
    rows = {pkg: _resume(pkg, "fused_sum", patched) for pkg in BOTH}
    assert rows["port"] == rows["jax"] and rows["port"]
    # every record after the savepoint adds its value once; every in-flight
    # sum comes back x10; pending rows ride the savepoint as they were
    idx = range(records, N)
    expected = sum(float(i % 4) for i in idx) + 10 * in_flight + pending
    assert sum(r[1] for r in rows["port"]) == pytest.approx(expected)


@pytest.mark.parametrize("renamer", BOTH)
def test_a_renamed_or_removed_operator_resumes_with_equal_rows_in_both(tmp_path, renamer):
    sp = _take_savepoint("port" if renamer == "jax" else "jax", "fused_count",
                         str(tmp_path / "sp"))
    reader = _load(renamer, sp)
    uid = _uid(reader, "fused_count")
    W = SP[renamer].SavepointWriter
    away = str(tmp_path / "away")
    W.from_reader(reader).rename_operator(uid, "renamed-op").write(away)
    assert "renamed-op" in _load("port", away).operator_uids()
    back = str(tmp_path / "back")
    W.from_reader(_load(renamer, away)).rename_operator("renamed-op", uid).write(back)
    rows = {pkg: _resume(pkg, "fused_count", back) for pkg in BOTH}
    assert rows["port"] == rows["jax"] and rows["port"]
    # the uninterrupted run's rows: the rename is undone
    env, sink = _job("port", "fused_count")
    env.execute()
    assert rows["port"] == _rows(sink)
    removed = str(tmp_path / "removed")
    W.from_reader(_load(renamer, away)).remove_operator("renamed-op").write(removed)
    assert "renamed-op" not in _load("port", removed).operator_uids()
    assert "renamed-op" not in _load("jax", removed).operator_uids()


def test_heap_state_transform_equal_in_both(tmp_path):
    sp = _take_savepoint("port", "oracle_reduce", str(tmp_path / "sp"))
    out = {}
    for pkg in BOTH:
        reader = _load(pkg, sp)
        uid = _uid(reader, "oracle_reduce")
        writer = SP[pkg].SavepointWriter.from_reader(reader)
        # drop key 0's entries, scale the others' running sums
        writer.transform_heap_state(uid, lambda name, key, ns, v: None if key == 0 else (
            v[0], v[1] * 10, v[2]) if isinstance(v, tuple) else v)
        path = str(tmp_path / f"heap-{pkg}")
        writer.write(path)
        r2 = _load("port", path)
        out[pkg] = _entries(r2, uid)
        assert all(key != 0 for _name, key, _ns, _v in r2.keyed_state(uid))
    assert out["port"] == out["jax"] and out["port"]


def test_writer_from_scratch_and_errors_equal(tmp_path):
    for pkg in BOTH:
        w = SP[pkg].SavepointWriter()
        path = w.write(str(tmp_path / pkg))
        assert path.endswith("_metadata")
        r = _load(pkg, str(tmp_path / pkg))
        assert r.operator_uids() == [] and r.records_in() == 0
        with pytest.raises(KeyError, match="no operator"):
            list(r.keyed_state("missing"))
        with pytest.raises(FileNotFoundError):
            SP[pkg].SavepointReader.load(str(tmp_path / f"empty-{pkg}"))
    assert tst.FsCheckpointStorage(str(tmp_path / "port")).latest()[0] == 0


def test_a_fused_operator_keyed_by_dense_int_ids_reads_its_ring(tmp_path):
    """A traceable key_by keys the fused operator by dense int ids: its
    dictionary holds no keys, the id is the key. The port's reader yields
    the ring's cells, equal to a numpy model of the records taken; the JAX
    reader iterates the empty key list and yields none (ROADMAP.md Queue C),
    while every other field reads the same."""
    import numpy as np
    import torch

    import flink_tpu.api.datastream as jds
    import flink_tpu.api.windowing.assigners as jasg
    import flink_tpu.config as jcfg
    import flink_tpu.connectors.source as jsrc
    import flink_tpu.core.watermarks as jwm
    import flink_tpu_torch.api.datastream as tds
    import flink_tpu_torch.api.windowing.assigners as tasg
    import flink_tpu_torch.config as tcfg
    import flink_tpu_torch.connectors.source as tsrc
    import flink_tpu_torch.core.watermarks as twm

    n, keys, batch = 4096, 16, 256

    def columns(idx):
        col = np.stack([idx % keys, (idx * 7) % 11], axis=1).astype(np.float32)
        return col, (idx * 3).astype(np.int64)

    def job(pkg, hook):
        ds, asg, cfg, src, wm = ((tds, tasg, tcfg, tsrc, twm) if pkg == "port"
                                 else (jds, jasg, jcfg, jsrc, jwm))
        conf = cfg.Configuration({"execution.step.batch-size": batch,
                                  "execution.state.key-capacity": keys})
        env = (ds.StreamExecutionEnvironment(conf, device="cpu") if pkg == "port"
               else ds.StreamExecutionEnvironment(conf))

        def gen(idx):
            hook(idx)
            return src.Batch(*columns(idx))

        if pkg == "port":
            key, val = (lambda c: c[:, 0].to(torch.int32)), (lambda c: c[:, 1])
        else:
            import jax.numpy as jnp
            key, val = (lambda c: c[:, 0].astype(jnp.int32)), (lambda c: c[:, 1])
        (env.from_source(src.DataGeneratorSource(gen, n),
                         wm.WatermarkStrategy.for_bounded_out_of_orderness(0))
         .key_by(key, traceable=True).window(asg.TumblingEventTimeWindows.of(500))
         .aggregate("sum", value_fn=val, value_traceable=True).collect())
        return env

    for writer in BOTH:
        env = job(writer, lambda idx: None)
        rt = _runtime(writer, env)
        steps = []
        sp = str(tmp_path / writer)

        def savepoint_request():
            steps.append(1)
            if len(steps) == 7:
                rt._write_savepoint(sp)
                raise _Stop()

        with pytest.raises(_Stop):
            rt.run(savepoint_request=savepoint_request)
        port, jax = _load("port", sp), _load("jax", sp)
        uid = _uid(port, "fused_sum")
        assert port.records_in() == jax.records_in() > 0
        assert list(jax.keyed_state(uid)) == []
        got = {(k, s): (f["count"], f["sum"]) for k, s, f in port.keyed_state(uid)}
        col, ts = columns(np.arange(port.records_in()))
        model = {}
        for k, v, t in zip(col[:, 0].astype(int), col[:, 1], ts):
            c = model.get((int(k), int(t) // 500), (0, 0.0))
            model[(int(k), int(t) // 500)] = (c[0] + 1, c[1] + float(v))
        lo = min(s for _k, s in got)
        assert got and got == {c: v for c, v in model.items() if c[1] >= lo}
