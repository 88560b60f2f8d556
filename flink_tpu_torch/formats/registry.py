"""Format SPI and registry: encode and decode row dicts to file bytes.

Counterpart of `flink_tpu/formats/registry.py`, copied: every format writes
the JAX package's bytes, and Parquet raises the same error where pyarrow
is missing.

The reference's format modules (flink-formats/: flink-json, flink-csv,
flink-avro, flink-parquet, ...) plug into sources/sinks as
DeserializationSchema / BulkWriter factories; here a `Format` couples both
directions behind one name.
"""

from __future__ import annotations

import io
import json
import struct
from typing import Any, Dict, Iterable, List, Optional

from flink_tpu_torch.core.serializers import read_varint, write_varint


class Format:
    name: str = ""

    def write(self, rows: Iterable[dict], out: io.BufferedIOBase) -> None:
        raise NotImplementedError

    def read(self, inp: io.BufferedIOBase) -> List[dict]:
        raise NotImplementedError

    # convenience
    def write_file(self, rows: Iterable[dict], path: str) -> None:
        with open(path, "wb") as f:
            self.write(rows, f)

    def read_file(self, path: str) -> List[dict]:
        with open(path, "rb") as f:
            return self.read(f)


class JsonLinesFormat(Format):
    """One JSON object per line (flink-json's newline-delimited mode)."""

    name = "json"

    def write(self, rows, out):
        for r in rows:
            out.write(json.dumps(r, separators=(",", ":")).encode() + b"\n")

    def read(self, inp):
        return [json.loads(line) for line in inp.read().splitlines() if line.strip()]


class CsvFormat(Format):
    """RFC-4180 CSV (stdlib csv handles quoting/escaping); numeric columns
    parse back to int/float. The fast path for columnar batches is the
    native codec (native/flink_tpu_native.cpp codec_parse_csv)."""

    name = "csv"

    def write(self, rows, out):
        import csv

        rows = list(rows)
        if not rows:
            return
        cols = sorted({k for r in rows for k in r})
        text = io.StringIO()
        w = csv.DictWriter(text, fieldnames=cols)
        w.writeheader()
        for r in rows:
            w.writerow({c: r.get(c, "") for c in cols})
        out.write(text.getvalue().encode())

    def read(self, inp):
        import csv

        text = io.StringIO(inp.read().decode())
        out = []
        for rec in csv.DictReader(text):
            row = {}
            for c, v in rec.items():
                try:
                    row[c] = int(v)
                except (TypeError, ValueError):
                    try:
                        row[c] = float(v)
                    except (TypeError, ValueError):
                        row[c] = v
            out.append(row)
        return out


# ---------------------------------------------------------------------------
# Avro binary (self-contained subset: null/boolean/long/double/string/bytes)
# ---------------------------------------------------------------------------

def _zigzag_write(out, n: int) -> None:
    write_varint(out, (n << 1) ^ (n >> 63))


def _zigzag_read(inp) -> int:
    u = read_varint(inp)
    return (u >> 1) ^ -(u & 1)


_AVRO_WRITERS = {
    "null": lambda o, v: None,
    "boolean": lambda o, v: o.write(b"\x01" if v else b"\x00"),
    "long": lambda o, v: _zigzag_write(o, int(v)),
    "double": lambda o, v: o.write(struct.pack("<d", float(v))),
    "string": lambda o, v: (_zigzag_write(o, len(v.encode())), o.write(v.encode())),
    "bytes": lambda o, v: (_zigzag_write(o, len(v)), o.write(v)),
}

_AVRO_READERS = {
    "null": lambda i: None,
    "boolean": lambda i: i.read(1) == b"\x01",
    "long": _zigzag_read,
    "double": lambda i: struct.unpack("<d", i.read(8))[0],
    "string": lambda i: i.read(_zigzag_read(i)).decode(),
    "bytes": lambda i: i.read(_zigzag_read(i)),
}


class AvroFormat(Format):
    """Avro binary encoding with an embedded record schema (container-file
    style: magic, JSON schema header, record count, then the standard Avro
    binary encoding of each record; flink-avro analogue).

    Fields may be declared nullable via ["null", <type>] unions.
    """

    name = "avro"
    MAGIC = b"FTAv1\x00"

    def __init__(self, schema: Optional[Dict[str, Any]] = None):
        self.schema = schema

    @staticmethod
    def infer_schema(rows) -> dict:
        """Schema over ALL rows: fields missing in some rows (or ever None)
        become nullable unions, so heterogeneous rows neither crash mid-write
        nor lose columns."""
        def ftype(v):
            if isinstance(v, bool):
                return "boolean"
            if isinstance(v, int):
                return "long"
            if isinstance(v, float):
                return "double"
            if isinstance(v, bytes):
                return "bytes"
            return "string"

        seen: Dict[str, Optional[str]] = {}
        nullable = set()
        order: List[str] = []
        for r in rows:
            for k, v in r.items():
                if k not in seen:
                    seen[k] = None
                    order.append(k)
                if v is None:
                    nullable.add(k)
                elif seen[k] is None:
                    seen[k] = ftype(v)
        n = len(list(rows)) if not isinstance(rows, list) else len(rows)
        for r in rows:
            for k in order:
                if k not in r:
                    nullable.add(k)
        fields = []
        for k in order:
            t = seen[k] or "string"
            fields.append({"name": k, "type": ["null", t] if k in nullable else t})
        return {"type": "record", "name": "Row", "fields": fields}

    def _write_value(self, out, ftype, value):
        if isinstance(ftype, list):  # union: write the branch index, then value
            if value is None:
                idx = ftype.index("null")
                _zigzag_write(out, idx)
                return
            idx = next(i for i, t in enumerate(ftype) if t != "null")
            _zigzag_write(out, idx)
            _AVRO_WRITERS[ftype[idx]](out, value)
            return
        _AVRO_WRITERS[ftype](out, value)

    def _read_value(self, inp, ftype):
        if isinstance(ftype, list):
            idx = _zigzag_read(inp)
            t = ftype[idx]
            return None if t == "null" else _AVRO_READERS[t](inp)
        return _AVRO_READERS[ftype](inp)

    def write(self, rows, out):
        rows = list(rows)
        schema = self.schema or (self.infer_schema(rows) if rows else
                                 {"type": "record", "name": "Row", "fields": []})
        header = json.dumps(schema).encode()
        out.write(self.MAGIC)
        write_varint(out, len(header))
        out.write(header)
        write_varint(out, len(rows))
        for r in rows:
            for field in schema["fields"]:
                self._write_value(out, field["type"], r.get(field["name"]))

    def read(self, inp):
        magic = inp.read(len(self.MAGIC))
        if magic != self.MAGIC:
            raise ValueError("not an avro container written by this framework")
        schema = json.loads(inp.read(read_varint(inp)))
        n = read_varint(inp)
        out = []
        for _ in range(n):
            out.append({
                f["name"]: self._read_value(inp, f["type"]) for f in schema["fields"]
            })
        return out


class ParquetFormat(Format):
    """Gated on pyarrow (the image ships none — mirror of the reference's
    optional format jars)."""

    name = "parquet"

    def __init__(self):
        try:
            import pyarrow  # noqa: F401
            import pyarrow.parquet  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "parquet format requires pyarrow, which is not installed in "
                "this environment; use 'avro', 'json' or 'csv'"
            ) from e

    def write(self, rows, out):
        import pyarrow as pa
        import pyarrow.parquet as pq

        rows = list(rows)
        table = pa.Table.from_pylist(rows)
        pq.write_table(table, out)

    def read(self, inp):
        import pyarrow.parquet as pq

        return pq.read_table(inp).to_pylist()


FORMATS = {
    "json": JsonLinesFormat,
    "csv": CsvFormat,
    "avro": AvroFormat,
    "parquet": ParquetFormat,
}


def get_format(name: str, **kwargs) -> Format:
    try:
        factory = FORMATS[name]
    except KeyError:
        raise ValueError(f"unknown format {name!r}; available: {sorted(FORMATS)}")
    return factory(**kwargs)
