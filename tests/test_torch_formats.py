"""The port's formats and formatted file connectors against the JAX package's.

Each format writes the same file bytes in both packages, each package reads
the other's files, Avro raises the same errors, Parquet is gated the same
way, and a FormattedFileSource -> windowed count -> FormattedFileSink job
gives the same output files through both packages' `env.execute()`.
"""

import io
import os

import numpy as np
import pytest

import flink_tpu.formats as jfmt
import flink_tpu.formats.registry as jreg
import flink_tpu_torch.formats as tfmt
import flink_tpu_torch.formats.registry as treg

ROWS = [
    {"user": "a", "n": 3, "score": 1.5, "ok": True},
    {"user": "b", "n": -7, "score": 0.25, "ok": False},
]


def _seeded_rows(n=257, seed=11):
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        row = {"k": f"key-{int(rng.integers(0, 40))}", "n": int(rng.integers(-(1 << 40), 1 << 40)),
               "x": float(rng.standard_normal()), "flag": bool(rng.integers(0, 2)),
               "s": "é,\"q\"\n" if i % 17 == 0 else f"s{i}"}
        if i % 5 == 0:
            row["opt"] = None if i % 10 == 0 else int(i)
        if i % 7 == 0:
            row["raw"] = bytes([i % 256, 0, 255])
        rows.append(row)
    return rows


@pytest.mark.parametrize("rows", [ROWS, _seeded_rows(), []], ids=["test_formats_rows",
                                                                   "seeded", "empty"])
@pytest.mark.parametrize("name", ["json", "csv", "avro"])
def test_file_bytes_equal_and_each_package_reads_the_others(name, rows, tmp_path):
    if name in ("json", "csv") and any("raw" in r for r in rows):
        rows = [{k: v for k, v in r.items() if k != "raw"} for r in rows]
    jp, tp = str(tmp_path / f"j.{name}"), str(tmp_path / f"t.{name}")
    jfmt.get_format(name).write_file(rows, jp)
    tfmt.get_format(name).write_file(rows, tp)
    jb, tb = open(jp, "rb").read() if os.path.exists(jp) else b"", \
        open(tp, "rb").read() if os.path.exists(tp) else b""
    assert jb == tb
    assert tfmt.get_format(name).read_file(jp) == jfmt.get_format(name).read_file(jp)
    assert jfmt.get_format(name).read_file(tp) == tfmt.get_format(name).read_file(tp)
    if name == "avro":   # fields missing from a row read back as None
        cols = {k for r in rows for k in r}
        assert tfmt.get_format(name).read_file(jp) == [
            {**{c: None for c in cols}, **r} for r in rows]


def test_avro_schemas_and_nullable_unions_equal():
    schema = {"type": "record", "name": "Row",
              "fields": [{"name": "k", "type": "string"},
                         {"name": "v", "type": ["null", "long"]}]}
    rows = [{"k": "x", "v": 5}, {"k": "y", "v": None}, {"k": "z", "v": -(1 << 40)}]
    out = []
    for reg in (jreg, treg):
        buf = io.BytesIO()
        reg.AvroFormat(schema=schema).write(rows, buf)
        out.append(buf.getvalue())
    assert out[0] == out[1]
    assert treg.AvroFormat(schema=schema).read(io.BytesIO(out[0])) == rows
    assert treg.AvroFormat.infer_schema(_seeded_rows()) == jreg.AvroFormat.infer_schema(
        _seeded_rows())


@pytest.mark.parametrize("blob", [b"garbage data here", b"", b"FTAv1"], ids=repr)
def test_avro_errors_equal(blob):
    errors = []
    for fmt in (jfmt, tfmt):
        with pytest.raises(ValueError) as info:
            fmt.get_format("avro").read(io.BytesIO(blob))
        errors.append(str(info.value))
    assert errors[0] == errors[1] and "not an avro container" in errors[0]


def test_truncated_avro_raises_the_same_error():
    buf = io.BytesIO()
    jfmt.get_format("avro").write(ROWS, buf)
    cut = buf.getvalue()[:9]
    kinds = []
    for fmt in (jfmt, tfmt):
        with pytest.raises(Exception) as info:
            fmt.get_format("avro").read(io.BytesIO(cut))
        kinds.append((type(info.value), str(info.value)))
    assert kinds[0] == kinds[1]


def test_parquet_gate_and_unknown_format_equal():
    outcomes = []
    for fmt in (jfmt, tfmt):
        try:
            f = fmt.get_format("parquet")
        except ImportError as e:
            outcomes.append(("gated", str(e)))
        else:
            buf = io.BytesIO()
            f.write(ROWS, buf)
            buf.seek(0)
            outcomes.append(("ok", f.read(buf) == ROWS))
        with pytest.raises(ValueError) as info:
            fmt.get_format("orc-nope")
        outcomes.append(("unknown", str(info.value)))
    assert outcomes[:2] == outcomes[2:]
    assert sorted(jfmt.FORMATS) == sorted(tfmt.FORMATS)


def _pipeline(pkg, src_path, out_dir, fmt_in, fmt_out):
    if pkg == "jax":
        from flink_tpu.api.datastream import StreamExecutionEnvironment
        from flink_tpu.api.windowing.assigners import TumblingEventTimeWindows
        from flink_tpu.core.watermarks import WatermarkStrategy
        from flink_tpu.formats.file_io import FormattedFileSink, FormattedFileSource
        env = StreamExecutionEnvironment.get_execution_environment()
    else:
        from flink_tpu_torch.api.datastream import StreamExecutionEnvironment
        from flink_tpu_torch.api.windowing.assigners import TumblingEventTimeWindows
        from flink_tpu_torch.core.watermarks import WatermarkStrategy
        from flink_tpu_torch.formats.file_io import FormattedFileSink, FormattedFileSource
        env = StreamExecutionEnvironment(device="cpu")
    stream = env.from_source(
        FormattedFileSource([src_path], format=fmt_in, timestamp_fn=lambda r: r["ts"]),
        WatermarkStrategy.for_bounded_out_of_orderness(0), "in")
    (stream.key_by(lambda r: r["word"])
     .window(TumblingEventTimeWindows.of(1000))
     .aggregate("count")
     .map(lambda kv: {"word": kv[0], "count": int(kv[1])})
     .sink_to(FormattedFileSink(out_dir, format=fmt_out)))
    env.execute("fmt-pipeline")
    return {f: open(os.path.join(out_dir, f), "rb").read() for f in sorted(os.listdir(out_dir))}


@pytest.mark.parametrize("fmt_in,fmt_out", [("avro", "json"), ("csv", "avro"), ("json", "csv")])
def test_formatted_source_to_sink_jobs_write_the_same_files(fmt_in, fmt_out, tmp_path):
    rng = np.random.default_rng(5)
    words = ["a", "b", "c", "d"]
    rows = [{"word": words[int(rng.integers(0, 4))], "n": 1, "ts": 37 * i} for i in range(600)]
    src = str(tmp_path / f"in.{fmt_in}")
    jfmt.get_format(fmt_in).write_file(rows, src)
    jout = _pipeline("jax", src, str(tmp_path / "jout"), fmt_in, fmt_out)
    tout = _pipeline("torch", src, str(tmp_path / "tout"), fmt_in, fmt_out)
    assert list(jout) == list(tout) and jout
    rows_of = {f: tfmt.get_format(fmt_out).read(io.BytesIO(b)) for f, b in tout.items()}
    jrows_of = {f: jfmt.get_format(fmt_out).read(io.BytesIO(b)) for f, b in jout.items()}
    key = (lambda r: (r["word"], r["count"]))
    assert {f: sorted(r, key=key) for f, r in rows_of.items()} == \
        {f: sorted(r, key=key) for f, r in jrows_of.items()}
    totals = {}
    for rs in rows_of.values():
        for r in rs:
            totals[r["word"]] = totals.get(r["word"], 0) + r["count"]
    assert totals == {w: sum(r["word"] == w for r in rows) for w in words}


def test_formatted_source_resumes_from_its_split_position(tmp_path):
    """The reader's position (file, row offset) snapshots and restores the
    JAX reader's way: a restored reader continues from the offset."""
    from flink_tpu.formats.file_io import FormattedFileSource as JSource
    from flink_tpu_torch.formats.file_io import FormattedFileSource as TSource

    rows = [{"v": i, "ts": i} for i in range(10)]
    path = str(tmp_path / "in.json")
    tfmt.get_format("json").write_file(rows, path)
    got = []
    for Src in (JSource, TSource):
        src = Src([path], format="json", timestamp_fn=lambda r: r["ts"])
        split = src.create_enumerator().next_split()
        reader = src.create_reader()
        reader.add_split(split)
        first = reader.poll_batch(4)
        pos = reader.snapshot_position()
        again = src.create_reader()
        again.restore_position(pos)
        rest = again.poll_batch(100)
        got.append((list(first.values), first.timestamps.tolist(), pos, list(rest.values)))
    assert got[0] == got[1]
    assert got[1][3] == rows[4:]
