"""TypeSerializers and serializer snapshots (state schema evolution).

Counterpart of `flink_tpu/core/serializers.py`, copied: the bytes each
serializer writes and the snapshot dicts are the JAX package's, so a blob
or a savepoint written by one package reads in the other. A dataclass
serializer's snapshot names the user class by its module and qualified
name; user classes are the same in both packages.

Mirrors the reference's TypeSerializer (flink-core/.../typeutils/
TypeSerializer.java:59) and TypeSerializerSnapshot contract: durable state
(savepoints, typed blobs) embeds a snapshot of the serializer that wrote it;
on restore the new serializer's snapshot is resolved against the written one
producing COMPATIBLE_AS_IS / COMPATIBLE_AFTER_MIGRATION / INCOMPATIBLE —
row/dataclass types migrate by field name (added fields take defaults,
removed fields are dropped), the analogue of PojoSerializer's evolution
rules.

Binary format conventions: little-endian fixed-width numerics, varint
lengths, a null byte before nullable values. Snapshots themselves serialize
to plain JSON-able dicts (class + config), the analogue of
TypeSerializerSnapshot#writeSnapshot.
"""

from __future__ import annotations

import io
import pickle
import struct
from typing import Any, List, Sequence

import numpy as np

_MISSING = object()  # sentinel: field absent from the old schema (migration)

# compatibility verdicts
COMPATIBLE_AS_IS = "as_is"
COMPATIBLE_AFTER_MIGRATION = "after_migration"
INCOMPATIBLE = "incompatible"


def write_varint(out: io.BytesIO, n: int) -> None:
    assert n >= 0
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.write(bytes([b | 0x80]))
        else:
            out.write(bytes([b]))
            return


def read_varint(inp: io.BytesIO) -> int:
    shift = n = 0
    while True:
        byte = inp.read(1)
        if not byte:
            raise EOFError("truncated varint (blob cut short?)")
        b = byte[0]
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n
        shift += 7


class TypeSerializer:
    def write(self, value: Any, out: io.BytesIO) -> None:
        raise NotImplementedError

    def read(self, inp: io.BytesIO) -> Any:
        raise NotImplementedError

    def serialize(self, value: Any) -> bytes:
        out = io.BytesIO()
        self.write(value, out)
        return out.getvalue()

    def deserialize(self, data: bytes) -> Any:
        return self.read(io.BytesIO(data))

    def snapshot(self) -> "TypeSerializerSnapshot":
        return TypeSerializerSnapshot(type(self).__name__, self._snapshot_config())

    def _snapshot_config(self) -> dict:
        return {}

    # evolution hook: build this serializer's reader for data written by
    # `old` (only called when resolve says AFTER_MIGRATION)
    def migrating_reader(self, old: "TypeSerializerSnapshot"):
        raise NotImplementedError(f"{type(self).__name__} cannot migrate")


class TypeSerializerSnapshot:
    """JSON-able record of how state bytes were written."""

    def __init__(self, serializer_class: str, config: dict):
        self.serializer_class = serializer_class
        self.config = config

    def to_dict(self) -> dict:
        return {"class": self.serializer_class, "config": self.config}

    @staticmethod
    def from_dict(d: dict) -> "TypeSerializerSnapshot":
        return TypeSerializerSnapshot(d["class"], d.get("config", {}))

    _ROW_FAMILY = ("RowSerializer", "DataclassSerializer")

    def resolve_compatibility(self, new_serializer: TypeSerializer) -> str:
        new = new_serializer.snapshot()
        row_to_row = (
            self.serializer_class in self._ROW_FAMILY
            and new.serializer_class in self._ROW_FAMILY
        )
        if new.serializer_class != self.serializer_class and not row_to_row:
            return INCOMPATIBLE
        if new.config == self.config:
            return COMPATIBLE_AS_IS
        if row_to_row:
            # wire-identical row<->dataclass (e.g. reading with the class
            # gone) is as-is; otherwise fields migrate by name, recursing
            # into nested rows
            if (self.config["names"] == new.config["names"]
                    and self.config["fields"] == new.config["fields"]):
                return COMPATIBLE_AS_IS
            old_f = dict(zip(self.config["names"], self.config["fields"]))
            new_f = dict(zip(new.config["names"], new.config["fields"]))
            for name in set(old_f) & set(new_f):
                if old_f[name] == new_f[name]:
                    continue
                old_snap = TypeSerializerSnapshot.from_dict(old_f[name])
                new_field = _restore_raw(TypeSerializerSnapshot.from_dict(new_f[name]))
                if old_snap.resolve_compatibility(new_field) == INCOMPATIBLE:
                    return INCOMPATIBLE
            return COMPATIBLE_AFTER_MIGRATION
        return INCOMPATIBLE

    def __repr__(self):
        return f"Snapshot({self.serializer_class}, {self.config})"


def _read_exact(inp: io.BytesIO, n: int) -> bytes:
    b = inp.read(n)
    if len(b) != n:
        raise EOFError(f"truncated value: wanted {n} bytes, got {len(b)}")
    return b


class _StructSerializer(TypeSerializer):
    fmt = ""

    def write(self, value, out):
        out.write(struct.pack(self.fmt, value))

    def read(self, inp):
        (v,) = struct.unpack(self.fmt, _read_exact(inp, struct.calcsize(self.fmt)))
        return v


class LongSerializer(_StructSerializer):
    fmt = "<q"

    def write(self, value, out):
        out.write(struct.pack(self.fmt, int(value)))


class IntSerializer(_StructSerializer):
    fmt = "<i"

    def write(self, value, out):
        out.write(struct.pack(self.fmt, int(value)))


class DoubleSerializer(_StructSerializer):
    fmt = "<d"

    def write(self, value, out):
        out.write(struct.pack(self.fmt, float(value)))


class FloatSerializer(_StructSerializer):
    fmt = "<f"

    def write(self, value, out):
        out.write(struct.pack(self.fmt, float(value)))


class BooleanSerializer(TypeSerializer):
    def write(self, value, out):
        out.write(b"\x01" if value else b"\x00")

    def read(self, inp):
        b = inp.read(1)
        if not b:
            raise EOFError("truncated boolean")
        return b == b"\x01"


class BytesSerializer(TypeSerializer):
    def write(self, value, out):
        write_varint(out, len(value))
        out.write(value)

    def read(self, inp):
        return _read_exact(inp, read_varint(inp))


class StringSerializer(TypeSerializer):
    def write(self, value, out):
        b = value.encode("utf-8")
        write_varint(out, len(b))
        out.write(b)

    def read(self, inp):
        return _read_exact(inp, read_varint(inp)).decode("utf-8")


class NumpyScalarSerializer(TypeSerializer):
    def __init__(self, dtype):
        self.dtype = np.dtype(dtype)

    def write(self, value, out):
        out.write(np.asarray(value, dtype=self.dtype).tobytes())

    def read(self, inp):
        return np.frombuffer(_read_exact(inp, self.dtype.itemsize), dtype=self.dtype)[0]

    def _snapshot_config(self):
        return {"dtype": self.dtype.str}


class PickleSerializer(TypeSerializer):
    """Kryo-fallback analogue."""

    def write(self, value, out):
        b = pickle.dumps(value, protocol=pickle.HIGHEST_PROTOCOL)
        write_varint(out, len(b))
        out.write(b)

    def read(self, inp):
        return pickle.loads(_read_exact(inp, read_varint(inp)))


class TupleSerializer(TypeSerializer):
    def __init__(self, fields: Sequence[TypeSerializer]):
        self.fields = list(fields)

    def write(self, value, out):
        if len(value) != len(self.fields):
            raise ValueError(
                f"tuple arity {len(value)} != serializer arity {len(self.fields)}"
            )
        for s, v in zip(self.fields, value):
            s.write(v, out)

    def read(self, inp):
        return tuple(s.read(inp) for s in self.fields)

    def _snapshot_config(self):
        return {"fields": [s.snapshot().to_dict() for s in self.fields]}


class ListSerializer(TypeSerializer):
    def __init__(self, elem: TypeSerializer):
        self.elem = elem

    def write(self, value, out):
        write_varint(out, len(value))
        for v in value:
            self.elem.write(v, out)

    def read(self, inp):
        return [self.elem.read(inp) for _ in range(read_varint(inp))]

    def _snapshot_config(self):
        return {"elem": self.elem.snapshot().to_dict()}


class MapSerializer(TypeSerializer):
    def __init__(self, key: TypeSerializer, value: TypeSerializer):
        self.key = key
        self.value = value

    def write(self, value, out):
        write_varint(out, len(value))
        for k, v in value.items():
            self.key.write(k, out)
            self.value.write(v, out)

    def read(self, inp):
        return {self.key.read(inp): self.value.read(inp) for _ in range(read_varint(inp))}

    def _snapshot_config(self):
        return {"key": self.key.snapshot().to_dict(), "value": self.value.snapshot().to_dict()}


class RowSerializer(TypeSerializer):
    """Null-mask + named fields; migrates by field name across versions."""

    def __init__(self, names: Sequence[str], fields: Sequence[TypeSerializer]):
        assert len(names) == len(fields)
        self.names = list(names)
        self.fields = list(fields)

    def write(self, value, out):
        vals = list(value)
        mask = 0
        for i, v in enumerate(vals):
            if v is None:
                mask |= 1 << i
        write_varint(out, mask)
        for s, v in zip(self.fields, vals):
            if v is not None:
                s.write(v, out)

    def read(self, inp):
        mask = read_varint(inp)
        return tuple(
            None if mask & (1 << i) else s.read(inp) for i, s in enumerate(self.fields)
        )

    def _snapshot_config(self):
        return {
            "names": list(self.names),
            "fields": [s.snapshot().to_dict() for s in self.fields],
        }

    def migrating_reader(self, old: TypeSerializerSnapshot):
        """Reader that consumes the OLD wire format and emits rows in the NEW
        field order (dropped fields skipped, added fields None)."""
        old_names = old.config["names"]
        new_index = {n: i for i, n in enumerate(self.names)}
        # per old field: a reader that consumes the OLD wire bytes; shared
        # fields whose own schema evolved get a nested migrating reader
        readers = []
        for n, fdict in zip(old_names, old.config["fields"]):
            fsnap = TypeSerializerSnapshot.from_dict(fdict)
            idx = new_index.get(n)
            if idx is not None and self.fields[idx].snapshot().to_dict() != fdict:
                verdict = fsnap.resolve_compatibility(self.fields[idx])
                if verdict == COMPATIBLE_AFTER_MIGRATION:
                    readers.append(self.fields[idx].migrating_reader(fsnap))
                    continue
            readers.append(restore_serializer(fsnap).read)

        def read(inp: io.BytesIO):
            mask = read_varint(inp)
            out_vals: List[Any] = [_MISSING] * len(self.names)
            for i, (n, rd) in enumerate(zip(old_names, readers)):
                if mask & (1 << i):
                    v = None
                else:
                    v = rd(inp)
                if n in new_index:
                    out_vals[new_index[n]] = v
            return self._finish(out_vals)

        return read

    def _finish(self, vals: List[Any]):
        # fields absent from the old schema surface as None in plain rows
        return tuple(None if v is _MISSING else v for v in vals)


class DataclassSerializer(RowSerializer):
    def __init__(self, cls: type, names: Sequence[str], fields: Sequence[TypeSerializer]):
        super().__init__(names, fields)
        self.cls = cls

    def write(self, value, out):
        super().write([getattr(value, n) for n in self.names], out)

    def read(self, inp):
        vals = super().read(inp)
        return self.cls(**dict(zip(self.names, vals)))

    def _snapshot_config(self):
        cfg = super()._snapshot_config()
        cfg["cls"] = f"{self.cls.__module__}.{self.cls.__qualname__}"
        return cfg

    def _finish(self, vals):
        # absent fields are omitted so dataclass defaults apply; a required
        # added field without a default falls back to None
        kwargs = {n: v for n, v in zip(self.names, vals) if v is not _MISSING}
        try:
            return self.cls(**kwargs)
        except TypeError:
            full = {n: (None if v is _MISSING else v) for n, v in zip(self.names, vals)}
            return self.cls(**full)


_RESTORERS = {
    "LongSerializer": lambda c: LongSerializer(),
    "IntSerializer": lambda c: IntSerializer(),
    "DoubleSerializer": lambda c: DoubleSerializer(),
    "FloatSerializer": lambda c: FloatSerializer(),
    "BooleanSerializer": lambda c: BooleanSerializer(),
    "BytesSerializer": lambda c: BytesSerializer(),
    "StringSerializer": lambda c: StringSerializer(),
    "NumpyScalarSerializer": lambda c: NumpyScalarSerializer(c["dtype"]),
    "PickleSerializer": lambda c: PickleSerializer(),
    "TupleSerializer": lambda c: TupleSerializer(
        [restore_serializer(TypeSerializerSnapshot.from_dict(d)) for d in c["fields"]]
    ),
    "ListSerializer": lambda c: ListSerializer(
        restore_serializer(TypeSerializerSnapshot.from_dict(c["elem"]))
    ),
    "MapSerializer": lambda c: MapSerializer(
        restore_serializer(TypeSerializerSnapshot.from_dict(c["key"])),
        restore_serializer(TypeSerializerSnapshot.from_dict(c["value"])),
    ),
    "RowSerializer": lambda c: RowSerializer(
        c["names"],
        [restore_serializer(TypeSerializerSnapshot.from_dict(d)) for d in c["fields"]],
    ),
    # the writing dataclass may no longer be importable: restore as a plain
    # row over the same names/wire format (canonical-savepoint semantics)
    "DataclassSerializer": lambda c: RowSerializer(
        c["names"],
        [restore_serializer(TypeSerializerSnapshot.from_dict(d)) for d in c["fields"]],
    ),
}


def restore_serializer(snap: TypeSerializerSnapshot) -> TypeSerializer:
    """Rebuild a serializer purely from its snapshot (reading old blobs even
    when the writing code is gone — canonical-savepoint semantics)."""
    try:
        return _RESTORERS[snap.serializer_class](snap.config)
    except KeyError:
        raise ValueError(f"unknown serializer snapshot {snap.serializer_class}")


_restore_raw = restore_serializer  # internal alias (compat resolution)


# ---------------------------------------------------------------------------
# typed state blobs: length-prefixed values + embedded snapshot
# ---------------------------------------------------------------------------

def write_typed_blob(values: Sequence[Any], serializer: TypeSerializer) -> dict:
    """Durable, evolvable encoding of a list of values: bytes + snapshot."""
    out = io.BytesIO()
    write_varint(out, len(values))
    for v in values:
        serializer.write(v, out)
    return {"snapshot": serializer.snapshot().to_dict(), "data": out.getvalue()}


def read_typed_blob(blob: dict, serializer: TypeSerializer) -> List[Any]:
    """Read values back, migrating if the schema evolved; raises on
    incompatible schema change (the reference's restore-time failure)."""
    snap = TypeSerializerSnapshot.from_dict(blob["snapshot"])
    verdict = snap.resolve_compatibility(serializer)
    inp = io.BytesIO(blob["data"])
    n = read_varint(inp)
    if verdict == COMPATIBLE_AS_IS:
        return [serializer.read(inp) for _ in range(n)]
    if verdict == COMPATIBLE_AFTER_MIGRATION:
        reader = serializer.migrating_reader(snap)
        return [reader(inp) for _ in range(n)]
    raise ValueError(
        f"state written by {snap.serializer_class}{snap.config} is incompatible "
        f"with {serializer.snapshot().to_dict()}"
    )
