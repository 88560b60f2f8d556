"""The port's key dictionary held against the JAX package's (ROADMAP C2).

The JAX package keys a non-integer batch in its native table by
`np.asarray(keys, dtype=np.bytes_)` at a fixed width and stores
`.tolist()` scalars (`flink_tpu/state/columnar.py::_try_native`); the port
keeps the same table in numpy. Batches of string, mixed float/int, bool,
tuple, non-ASCII and over-wide keys, and sequences that change key type,
go through both `KeyDictionary`s; ids, capacities and the stored keys
must agree exactly (`repr` of the key list). Snapshots restore across the
packages and continue at parity. ROADMAP C2's jobs run through both
packages' `env.execute()` with `repr` equality of every emitted row, and
an object batch of `[True, 1]` goes through both `TpuWindowOperator`s.

The reference folds `"1"` and `1` into one key (both are b'1'); the port
reproduces that.
"""

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")

from flink_tpu.api.datastream import StreamExecutionEnvironment as JaxEnv  # noqa: E402
from flink_tpu.api.windowing import assigners as jasg  # noqa: E402
from flink_tpu.core.watermarks import WatermarkStrategy as JaxWatermarks  # noqa: E402
from flink_tpu.runtime.tpu_window_operator import TpuWindowOperator as JaxWindow  # noqa: E402
from flink_tpu.state.columnar import KeyDictionary as JaxDict  # noqa: E402
from flink_tpu.utils import native_bridge  # noqa: E402
from flink_tpu_torch.api.datastream import StreamExecutionEnvironment  # noqa: E402
from flink_tpu_torch.api.windowing import assigners as tasg  # noqa: E402
from flink_tpu_torch.core.watermarks import WatermarkStrategy  # noqa: E402
from flink_tpu_torch.runtime.tpu_window_operator import TpuWindowOperator  # noqa: E402
from flink_tpu_torch.state.columnar import KeyDictionary  # noqa: E402
from jax_native_twins import jax_native_library  # noqa: E402,F401


def obj(*items):
    arr = np.empty(len(items), dtype=object)
    arr[:] = list(items)
    return arr


RNG = np.random.default_rng(11)
WORDS = np.array([f"w{i}" for i in RNG.integers(0, 40, 300)])

SEQUENCES = {
    "strings": [np.array(["a", "b", "a"]), np.array(["c", "a"])],
    "object_strings": [obj("a", "b", "a"), obj("b", "zz")],
    "words": [WORDS[:150], WORDS[150:]],
    "mixed_float_int": [obj(1.0, 1, 2.5), obj(1, 1.0, 3)],
    "floats": [np.array([1.5, 2.0, 1.5]), np.array([2.0, -0.0, 0.0])],
    "bool_and_int": [obj(True, 1), obj(1, False, 0)],
    "bools": [np.array([True, False, True])],
    "string_one_and_int_one": [obj("1", 1, "2")],
    "tuples": [obj((1, "a"), (2, "b"), (1, "a")), obj((2, "b"), (3, "c"))],
    "non_ascii": [obj("é", "a"), obj("a", "ü")],
    "too_wide": [np.array(["a"]), np.array(["a" * 40, "b"]), np.array(["b", "c"])],
    "ints_then_strings": [np.array([3, 1, 3]), obj("x", "y"), np.array([1, 7])],
    "strings_then_ints": [np.array(["x", "y"]), np.array([5, 6]), np.array(["y", "z"])],
    "int_widths": [np.array([7, 1], np.int32), np.array([1, 9], np.uint8),
                   np.array([2 ** 40, 7], np.int64)],
    "none_key": [obj(None, "a", None)],
}


def _run(d, batches):
    out = []
    for b in batches:
        ids, cap = d.lookup_or_insert(b)
        out.append((np.asarray(ids).tolist(), cap))
    return out, repr(d.snapshot()["keys"])


def test_the_reference_loads_its_native_table():
    # the JAX package's identity is its native table's; without the library
    # it would take the dict path everywhere
    assert native_bridge.get_lib() is not None


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_ids_and_stored_keys_match_the_jax_dictionary(name):
    batches = SEQUENCES[name]
    assert _run(KeyDictionary(), batches) == _run(JaxDict(), batches)


def test_keys_are_plain_python_values():
    d = KeyDictionary()
    d.lookup_or_insert(np.array(["a", "b"]))
    d.lookup_or_insert(np.array([1.5, 2.5]))     # the other mode: dict path
    assert [type(k) for k in d.keys_for(np.array([0, 1]))] == [str, str]


def test_float_and_int_one_stay_two_keys_and_string_one_folds():
    d = KeyDictionary()
    assert d.lookup_or_insert(obj(1.0, 1, True))[0].tolist() == [0, 1, 2]
    d2 = KeyDictionary()
    assert d2.lookup_or_insert(obj("1", 1))[0].tolist() == [0, 0]


@pytest.mark.parametrize("name", ["strings", "words", "mixed_float_int", "ints_then_strings",
                                  "tuples"])
@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_snapshots_restore_across_the_packages(name, direction):
    batches = SEQUENCES[name]
    first, rest = batches[:1], batches[1:] + batches[:1]
    src, dst = (KeyDictionary, JaxDict) if direction == "port_to_jax" else (JaxDict, KeyDictionary)
    a = src()
    _run(a, first)
    restored = dst.restore(a.snapshot())
    same = src.restore(a.snapshot())
    assert _run(restored, rest) == _run(same, rest)


def _c2_job(env_cls, asg, wm, recs, **kw):
    env = env_cls(**kw)
    sink = (env.from_collection(recs, timestamp_fn=lambda r: r[2],
                                watermark_strategy=wm.for_bounded_out_of_orderness(0))
            .key_by(lambda r: r[0]).window(asg.TumblingEventTimeWindows.of(1000))
            .aggregate("sum", value_fn=lambda r: r[1]).collect())
    env.execute()
    return repr(sink.results)


@pytest.mark.parametrize("recs,want", [
    ([("a", 1.0, 10), ("b", 2.0, 20), ("a", 4.0, 30)], "[('a', 5.0), ('b', 2.0)]"),
    ([(1.0, 1.0, 10), (1, 2.0, 20), (2.5, 4.0, 30)], "[(1.0, 1.0), (1, 2.0), (2.5, 4.0)]"),
])
def test_roadmap_c2_jobs_emit_the_jax_rows(recs, want):
    ours = _c2_job(StreamExecutionEnvironment, tasg, WatermarkStrategy, recs, device="cpu")
    assert ours == _c2_job(JaxEnv, jasg, JaxWatermarks, recs) == want


def test_bool_and_int_keys_split_at_the_operator():
    rows = []
    for op in (JaxWindow(jasg.TumblingEventTimeWindows.of(1000), "sum"),
               TpuWindowOperator(tasg.TumblingEventTimeWindows.of(1000), "sum", device="cpu")):
        op.process_batch(obj(True, 1, True), np.array([1.0, 2.0, 4.0], np.float32),
                         np.array([10, 20, 30]))
        op.process_watermark(5000)
        rows.append(repr([(k, r) for k, _w, r, _t in op.drain_output()]))
    assert rows[0] == rows[1] == "[(True, 5.0), (1, 2.0)]"
