"""Type information: schema descriptions for records, columns and state.

Counterpart of `flink_tpu/core/types.py`, copied: extraction, columnar
dtypes and the serializers each type makes are the JAX package's.

The reference's TypeInformation (flink-core/.../typeinfo/TypeInformation.java:80)
describes a value type, creates its TypeSerializer, and is extracted by
reflection (TypeExtractor.java:99). The TPU-native analogue serves two
masters:

1. **Columnar layout**: every type reports its device-columnar dtype
   (`columnar_dtype()`), i.e. how a column of such values lands in a
   struct-of-arrays RecordBatch / HBM DeviceArray — the analogue of the
   reference's serializer knowing its binary layout. Types without a fixed
   numeric layout (strings, arbitrary objects) are host-side columns that
   reach the device only through the key dictionary / codec paths.
2. **Durable serialization**: `serializer()` returns a TypeSerializer
   (core/serializers.py) used for savepoint/state blobs with snapshot-based
   schema evolution (TypeSerializerSnapshot semantics).

Extraction mirrors TypeExtractor: `TypeInformation.of()` accepts python
types, typing hints, dataclasses (the POJO analogue, PojoSerializer.java:48)
and falls back to pickle (the Kryo fallback, KryoSerializer.java:98).
"""

from __future__ import annotations

import dataclasses
import typing
from typing import Any, Optional, Sequence, Tuple

import numpy as np


class TypeInformation:
    """Describes a value type; factory for its serializer and column dtype."""

    def serializer(self):
        raise NotImplementedError

    def columnar_dtype(self) -> Optional[np.dtype]:
        """numpy dtype of a device-ready column of this type, or None if the
        type is host-only (variable length / object)."""
        return None

    @property
    def arity(self) -> int:
        return 1

    # -- extraction (TypeExtractor analogue) --------------------------------
    @staticmethod
    def of(hint: Any) -> "TypeInformation":
        if isinstance(hint, TypeInformation):
            return hint
        if hint is int:
            return Types.LONG
        if hint is float:
            return Types.DOUBLE
        if hint is bool:
            return Types.BOOLEAN
        if hint is str:
            return Types.STRING
        if hint is bytes:
            return Types.BYTES
        if isinstance(hint, np.dtype) or (isinstance(hint, type) and issubclass(hint, np.generic)):
            return NumpyTypeInfo(np.dtype(hint))
        import types as _pytypes

        origin = typing.get_origin(hint)
        if origin is typing.Union or origin is getattr(_pytypes, "UnionType", ()):
            args = [a for a in typing.get_args(hint) if a is not type(None)]
            if len(args) == 1:
                # Optional[X] ≡ X: the row null-mask already encodes None
                return TypeInformation.of(args[0])
            return Types.PICKLED
        if origin in (tuple,):
            args = typing.get_args(hint)
            if Ellipsis in args:  # variadic tuple[X, ...]: no fixed arity
                return Types.PICKLED
            return TupleTypeInfo([TypeInformation.of(a) for a in args])
        if origin in (list,):
            (elem,) = typing.get_args(hint) or (Any,)
            return ListTypeInfo(TypeInformation.of(elem) if elem is not Any else Types.PICKLED)
        if origin in (dict,):
            args = typing.get_args(hint) or (Any, Any)
            return MapTypeInfo(
                TypeInformation.of(args[0]) if args[0] is not Any else Types.PICKLED,
                TypeInformation.of(args[1]) if args[1] is not Any else Types.PICKLED,
            )
        if dataclasses.is_dataclass(hint) and isinstance(hint, type):
            fields = []
            hints = typing.get_type_hints(hint)
            for f in dataclasses.fields(hint):
                fields.append((f.name, TypeInformation.of(hints.get(f.name, Any))
                               if hints.get(f.name, Any) is not Any else Types.PICKLED))
            return DataclassTypeInfo(hint, fields)
        return Types.PICKLED

    @staticmethod
    def infer(value: Any) -> "TypeInformation":
        """Extract from a sample value (the runtime-extraction path)."""
        if isinstance(value, bool):
            return Types.BOOLEAN
        if isinstance(value, int):
            return Types.LONG
        if isinstance(value, float):
            return Types.DOUBLE
        if isinstance(value, str):
            return Types.STRING
        if isinstance(value, bytes):
            return Types.BYTES
        if isinstance(value, np.generic):
            return NumpyTypeInfo(value.dtype)
        if isinstance(value, tuple):
            return TupleTypeInfo([TypeInformation.infer(v) for v in value])
        if dataclasses.is_dataclass(value) and not isinstance(value, type):
            return TypeInformation.of(type(value))
        return Types.PICKLED

    # identity by config
    def _config(self) -> tuple:
        return (type(self).__name__,)

    def __eq__(self, other):
        return isinstance(other, TypeInformation) and self._config() == other._config()

    def __hash__(self):
        return hash(self._config())

    def __repr__(self):
        return self._config()[0]


class BasicTypeInfo(TypeInformation):
    def __init__(self, name: str, dtype: Optional[np.dtype], serializer_factory):
        self.name = name
        self._dtype = np.dtype(dtype) if dtype is not None else None
        self._serializer_factory = serializer_factory

    def serializer(self):
        return self._serializer_factory()

    def columnar_dtype(self):
        return self._dtype

    def _config(self):
        return ("basic", self.name)

    def __repr__(self):
        return self.name


class NumpyTypeInfo(TypeInformation):
    def __init__(self, dtype: np.dtype):
        self.dtype = np.dtype(dtype)

    def serializer(self):
        from flink_tpu_torch.core.serializers import NumpyScalarSerializer

        return NumpyScalarSerializer(self.dtype)

    def columnar_dtype(self):
        return self.dtype

    def _config(self):
        return ("numpy", self.dtype.str)


class TupleTypeInfo(TypeInformation):
    def __init__(self, field_types: Sequence[TypeInformation]):
        self.field_types = list(field_types)

    @property
    def arity(self):
        return len(self.field_types)

    def serializer(self):
        from flink_tpu_torch.core.serializers import TupleSerializer

        return TupleSerializer([t.serializer() for t in self.field_types])

    def _config(self):
        return ("tuple", tuple(t._config() for t in self.field_types))

    def __repr__(self):
        return f"Tuple{self.field_types}"


class RowTypeInfo(TypeInformation):
    """Named, ordered fields — the schema type of the Table layer and the
    evolution unit for state (fields may be added/removed across restores)."""

    def __init__(self, names: Sequence[str], types: Sequence[TypeInformation]):
        assert len(names) == len(types)
        self.names = list(names)
        self.types = list(types)

    @property
    def arity(self):
        return len(self.names)

    def serializer(self):
        from flink_tpu_torch.core.serializers import RowSerializer

        return RowSerializer(self.names, [t.serializer() for t in self.types])

    def field_index(self, name: str) -> int:
        return self.names.index(name)

    def _config(self):
        return ("row", tuple(self.names), tuple(t._config() for t in self.types))

    def __repr__(self):
        return "Row(" + ", ".join(f"{n}: {t!r}" for n, t in zip(self.names, self.types)) + ")"


class DataclassTypeInfo(RowTypeInfo):
    """POJO analogue: a dataclass is a row with a reconstructor."""

    def __init__(self, cls: type, fields: Sequence[Tuple[str, TypeInformation]]):
        super().__init__([n for n, _ in fields], [t for _, t in fields])
        self.cls = cls

    def serializer(self):
        from flink_tpu_torch.core.serializers import DataclassSerializer

        return DataclassSerializer(self.cls, self.names, [t.serializer() for t in self.types])

    def _config(self):
        return ("dataclass", f"{self.cls.__module__}.{self.cls.__qualname__}",
                tuple(self.names), tuple(t._config() for t in self.types))


class ListTypeInfo(TypeInformation):
    def __init__(self, elem: TypeInformation):
        self.elem = elem

    def serializer(self):
        from flink_tpu_torch.core.serializers import ListSerializer

        return ListSerializer(self.elem.serializer())

    def _config(self):
        return ("list", self.elem._config())


class MapTypeInfo(TypeInformation):
    def __init__(self, key: TypeInformation, value: TypeInformation):
        self.key = key
        self.value = value

    def serializer(self):
        from flink_tpu_torch.core.serializers import MapSerializer

        return MapSerializer(self.key.serializer(), self.value.serializer())

    def _config(self):
        return ("map", self.key._config(), self.value._config())


class PickledTypeInfo(TypeInformation):
    """Fallback for arbitrary objects (the Kryo analogue)."""

    def serializer(self):
        from flink_tpu_torch.core.serializers import PickleSerializer

        return PickleSerializer()

    def _config(self):
        return ("pickled",)


def _mk_basic():
    from flink_tpu_torch.core import serializers as s

    return {
        "LONG": BasicTypeInfo("Long", np.int64, lambda: s.LongSerializer()),
        "INT": BasicTypeInfo("Int", np.int32, lambda: s.IntSerializer()),
        "DOUBLE": BasicTypeInfo("Double", np.float64, lambda: s.DoubleSerializer()),
        "FLOAT": BasicTypeInfo("Float", np.float32, lambda: s.FloatSerializer()),
        "BOOLEAN": BasicTypeInfo("Boolean", np.bool_, lambda: s.BooleanSerializer()),
        "STRING": BasicTypeInfo("String", None, lambda: s.StringSerializer()),
        "BYTES": BasicTypeInfo("Bytes", None, lambda: s.BytesSerializer()),
    }


class Types:
    """Static type catalogue (org.apache.flink.api.common.typeinfo.Types)."""

    LONG: BasicTypeInfo
    INT: BasicTypeInfo
    DOUBLE: BasicTypeInfo
    FLOAT: BasicTypeInfo
    BOOLEAN: BasicTypeInfo
    STRING: BasicTypeInfo
    BYTES: BasicTypeInfo
    PICKLED = PickledTypeInfo()

    @staticmethod
    def ROW(names: Sequence[str], types: Sequence[TypeInformation]) -> RowTypeInfo:
        return RowTypeInfo(names, types)

    @staticmethod
    def TUPLE(types: Sequence[TypeInformation]) -> TupleTypeInfo:
        return TupleTypeInfo(types)

    @staticmethod
    def LIST(elem: TypeInformation) -> ListTypeInfo:
        return ListTypeInfo(elem)

    @staticmethod
    def MAP(k: TypeInformation, v: TypeInformation) -> MapTypeInfo:
        return MapTypeInfo(k, v)


for _name, _ti in _mk_basic().items():
    setattr(Types, _name, _ti)
