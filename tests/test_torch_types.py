"""The port's serializers and type information against the JAX package's.

Every case of tests/test_types.py runs through both packages: the bytes
each serializer writes are equal, each package reads the other's bytes and
typed blobs, snapshots are equal dicts, and the compatibility verdicts and
schema migrations agree.
"""

import dataclasses
import typing

import numpy as np
import pytest

import flink_tpu.core.serializers as jser
import flink_tpu.core.types as jtypes
import flink_tpu_torch.core.serializers as tser
import flink_tpu_torch.core.types as ttypes

PACKAGES = [(jtypes, jser), (ttypes, tser)]


@dataclasses.dataclass
class Click:
    user: str
    count: int
    score: float


@dataclasses.dataclass
class ClickV2:
    user: str
    score: float
    region: str = "unknown"


@dataclasses.dataclass
class WithOpt:
    a: typing.Optional[int]
    b: str


# (id, type factory over a types module, value) — tests/test_types.py's
# roundtrip cases, the optional and variadic hints and a nested row
CASES = [
    ("long", lambda T: T.Types.LONG, -42),
    ("double", lambda T: T.Types.DOUBLE, 3.5),
    ("boolean", lambda T: T.Types.BOOLEAN, True),
    ("string", lambda T: T.Types.STRING, "héllo"),
    ("bytes", lambda T: T.Types.BYTES, b"\x00\x01"),
    ("int", lambda T: T.Types.INT, -7),
    ("float", lambda T: T.Types.FLOAT, 0.25),
    ("tuple", lambda T: T.Types.TUPLE([T.Types.STRING, T.Types.LONG]), ("k", 7)),
    ("list", lambda T: T.Types.LIST(T.Types.LONG), [1, 2, 3]),
    ("map", lambda T: T.Types.MAP(T.Types.STRING, T.Types.DOUBLE), {"a": 1.0, "b": 2.0}),
    ("row_null", lambda T: T.Types.ROW(["a", "b"], [T.Types.STRING, T.Types.LONG]), ("x", None)),
    ("pickled", lambda T: T.Types.PICKLED, {"arbitrary": [1, "two"]}),
    ("dataclass", lambda T: T.TypeInformation.of(Click), Click("u1", 3, 0.5)),
    ("numpy", lambda T: T.TypeInformation.of(np.float32), np.float32(1.5)),
    ("variadic", lambda T: T.TypeInformation.of(tuple[int, ...]), (1, 2, 3)),
    ("optional", lambda T: T.TypeInformation.of(WithOpt), WithOpt(None, "z")),
    ("nested_row", lambda T: T.Types.ROW(["k", "inner"], [T.Types.STRING, T.Types.ROW(
        ["x"], [T.Types.LONG])]), ("a", (7,))),
    ("hint_tuple", lambda T: T.TypeInformation.of(tuple[str, int]), ("s", 4)),
    ("hint_dict", lambda T: T.TypeInformation.of(dict[str, list[float]]), {"a": [1.0, 2.5]}),
]


@pytest.mark.parametrize("build,value", [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_serializer_bytes_and_snapshots_equal_and_cross_read(build, value):
    js, ts = build(jtypes).serializer(), build(ttypes).serializer()
    jb, tb = js.serialize(value), ts.serialize(value)
    assert jb == tb
    assert js.snapshot().to_dict() == ts.snapshot().to_dict()
    assert ts.deserialize(jb) == value and js.deserialize(tb) == value
    # the snapshot alone rebuilds a reader in the other package
    restored = tser.restore_serializer(tser.TypeSerializerSnapshot.from_dict(
        js.snapshot().to_dict()))
    jrestored = jser.restore_serializer(jser.TypeSerializerSnapshot.from_dict(
        ts.snapshot().to_dict()))
    assert restored.serialize(restored.deserialize(jb)) == jb
    assert jrestored.serialize(jrestored.deserialize(tb)) == tb


@pytest.mark.parametrize("hint", [int, float, bool, str, bytes, np.int32, typing.Optional[float],
                                  tuple[str, int], tuple[int, ...], list, dict[str, int],
                                  list[typing.Any], Click, WithOpt, typing.Union[int, str]],
                         ids=repr)
def test_extraction_from_hints_gives_equal_types(hint):
    j, t = jtypes.TypeInformation.of(hint), ttypes.TypeInformation.of(hint)
    assert j._config() == t._config() and repr(j) == repr(t)
    assert j.columnar_dtype() == t.columnar_dtype() and j.arity == t.arity


@pytest.mark.parametrize("value", [3, True, 1.5, "s", b"b", np.float32(1.5), ("a", 2, 0.5),
                                   Click("u", 1, 0.5), [1]], ids=repr)
def test_extraction_from_values_gives_equal_types(value):
    j, t = jtypes.TypeInformation.infer(value), ttypes.TypeInformation.infer(value)
    assert j._config() == t._config() and j.columnar_dtype() == t.columnar_dtype()


def _row(T, names, types):
    return T.Types.ROW(names, [getattr(T.Types, t) for t in types]).serializer()


VERDICTS = [
    ("same", (["a", "b"], ["STRING", "LONG"])),
    ("added", (["a", "b", "c"], ["STRING", "LONG", "DOUBLE"])),
    ("dropped", (["a"], ["STRING"])),
    ("retyped", (["a", "b"], ["STRING", "DOUBLE"])),
]


@pytest.mark.parametrize("new", [v[1] for v in VERDICTS] + [None],
                         ids=[v[0] for v in VERDICTS] + ["other"])
def test_compatibility_verdicts_equal(new):
    verdicts = []
    for T, S in PACKAGES:
        old = _row(T, ["a", "b"], ["STRING", "LONG"])
        ser = T.Types.LONG.serializer() if new is None else _row(T, *new)
        verdicts.append(old.snapshot().resolve_compatibility(ser))
    assert verdicts[0] == verdicts[1]
    assert verdicts[0] in (jser.COMPATIBLE_AS_IS, jser.COMPATIBLE_AFTER_MIGRATION,
                           jser.INCOMPATIBLE)


@pytest.mark.parametrize("writer", [0, 1], ids=["jax_writes", "port_writes"])
def test_typed_blob_evolution_across_packages(writer):
    """A blob written by one package migrates in the other exactly as in
    its own: added fields None, dropped fields gone, a retype refused, a
    dataclass default applied, nested rows migrated."""
    (WT, WS), (RT, RS) = PACKAGES[writer], PACKAGES[1 - writer]
    blob = WS.write_typed_blob([("u1", 1), ("u2", 2)], _row(WT, ["user", "count"],
                                                             ["STRING", "LONG"]))
    own = PACKAGES[writer][1]
    v2 = _row(RT, ["user", "score"], ["STRING", "DOUBLE"])
    assert RS.read_typed_blob(blob, v2) == [("u1", None), ("u2", None)] == \
        own.read_typed_blob(blob, _row(WT, ["user", "score"], ["STRING", "DOUBLE"]))
    assert RS.read_typed_blob(blob, _row(RT, ["user", "count"], ["STRING", "LONG"])) == \
        [("u1", 1), ("u2", 2)]
    with pytest.raises(ValueError, match="incompatible"):
        RS.read_typed_blob(blob, _row(RT, ["user", "count"], ["STRING", "DOUBLE"]))

    dblob = WS.write_typed_blob([Click("u", 5, 1.5)], WT.TypeInformation.of(Click).serializer())
    (migrated,) = RS.read_typed_blob(dblob, RT.TypeInformation.of(ClickV2).serializer())
    assert migrated == ClickV2("u", 1.5, "unknown")
    restored = RS.restore_serializer(RS.TypeSerializerSnapshot.from_dict(dblob["snapshot"]))
    assert RS.read_typed_blob(dblob, restored) == [("u", 5, 1.5)]

    inner = WT.Types.ROW(["x"], [WT.Types.LONG])
    nblob = WS.write_typed_blob([("a", (7,))], WT.Types.ROW(
        ["k", "inner"], [WT.Types.STRING, inner]).serializer())
    outer_v2 = RT.Types.ROW(["k", "inner"], [RT.Types.STRING, RT.Types.ROW(
        ["x", "y"], [RT.Types.LONG, RT.Types.DOUBLE])]).serializer()
    assert RS.read_typed_blob(nblob, outer_v2) == [("a", (7, None))]
    assert blob["data"] == PACKAGES[1 - writer][1].write_typed_blob(
        [("u1", 1), ("u2", 2)], _row(RT, ["user", "count"], ["STRING", "LONG"]))["data"]


@pytest.mark.parametrize("n", [0, 1, 127, 128, 300, 1 << 35])
def test_varints_equal(n):
    import io

    jo, to = io.BytesIO(), io.BytesIO()
    jser.write_varint(jo, n)
    tser.write_varint(to, n)
    assert jo.getvalue() == to.getvalue()
    assert tser.read_varint(io.BytesIO(jo.getvalue())) == n


def test_errors_equal():
    for T, S in PACKAGES:
        with pytest.raises(ValueError, match="arity"):
            T.Types.TUPLE([T.Types.STRING, T.Types.LONG]).serializer().serialize(("one",))
        with pytest.raises(EOFError, match="truncated"):
            T.Types.STRING.serializer().deserialize(b"\x05ab")
        with pytest.raises(ValueError, match="unknown serializer snapshot"):
            S.restore_serializer(S.TypeSerializerSnapshot("Nope", {}))
