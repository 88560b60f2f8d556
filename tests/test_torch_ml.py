"""ML_PREDICT on the port held against the JAX package's.

`TorchModelProvider` (a torch callable under inference_mode, batches padded
to powers of two) against `JaxModelProvider` (jax.jit of the same function)
over the same features, weights made with numpy from a seed and carried to
the port with `params_from_numpy`; the SQL statements of
tests/test_sql_gateway_ml.py through both TableEnvironments; the batching
predictor's order and flush boundaries; and the refusals.
"""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from flink_tpu.api.datastream import StreamExecutionEnvironment as JEnv  # noqa: E402
from flink_tpu.table import ml as jml  # noqa: E402
from flink_tpu.table import table_env as jtb  # noqa: E402
from flink_tpu_torch.api.datastream import StreamExecutionEnvironment as TEnv  # noqa: E402
from flink_tpu_torch.table import ml as tml  # noqa: E402
from flink_tpu_torch.table import table_env as ttb  # noqa: E402


def _mlp_params(seed=5, f=2, h=16, o=1):
    rng = np.random.default_rng(seed)
    return {"w1": (rng.standard_normal((f, h)) / np.sqrt(f)).astype(np.float32),
            "b1": (rng.standard_normal(h) * 0.1).astype(np.float32),
            "w2": (rng.standard_normal((h, o)) / np.sqrt(h)).astype(np.float32),
            "b2": (rng.standard_normal(o) * 0.1).astype(np.float32)}


def jax_mlp(p, x):
    import jax

    return jax.nn.relu(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]


def torch_mlp(p, x):
    return torch.relu(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]


@pytest.mark.parametrize("n", [1, 15, 16, 17, 100, 1000])
def test_torch_provider_matches_the_jax_provider(n):
    params = _mlp_params()
    feats = np.random.default_rng(n).standard_normal((n, 2)).astype(np.float32)
    jp = jml.JaxModelProvider(jax_mlp, {k: jnp.asarray(v) for k, v in params.items()},
                              ["x1", "x2"], ["score"])
    tp = tml.TorchModelProvider(torch_mlp, tml.params_from_numpy(params, "cpu"),
                                ["x1", "x2"], ["score"], device="cpu")
    want, got = np.asarray(jp.predict_batch(feats)), tp.predict_batch(feats)
    assert got.shape == want.shape == (n, 1) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert tp.predict_row({"x1": 0.5, "x2": -1.0}) == pytest.approx(
        jp.predict_row({"x1": 0.5, "x2": -1.0}), rel=1e-6)


def test_params_from_numpy_keeps_the_structure():
    p = tml.params_from_numpy({"a": [np.ones(2), (np.zeros((1, 2)),)], "b": np.float32(3)},
                              "cpu")
    assert isinstance(p["a"], list) and isinstance(p["a"][1], tuple)
    assert p["a"][0].tolist() == [1.0, 1.0] and p["b"].item() == 3.0
    assert p["a"][1][0].device.type == "cpu"


def _tenvs():
    return {"jax": jtb.TableEnvironment(JEnv()),
            "port": ttb.TableEnvironment(TEnv(device="cpu"))}


CLICKS = [{"user": "a", "x1": 1.0, "x2": 2.0}, {"user": "b", "x1": 3.0, "x2": 1.0},
          {"user": "c", "x1": -0.5, "x2": 0.25}]


def test_sql_ml_predict_through_both_table_environments():
    params = {"w": np.asarray([2.0, 0.5], np.float32), "b": np.asarray(1.0, np.float32)}
    rows = {}
    for pkg, tenv in _tenvs().items():
        mod = jtb if pkg == "jax" else ttb
        tenv.from_rows("clicks", CLICKS, mod.TableSchema(["user", "x1", "x2"]))
        if pkg == "jax":
            prov = jml.JaxModelProvider(lambda p, f: (f @ p["w"] + p["b"])[:, None],
                                        {k: jnp.asarray(v) for k, v in params.items()},
                                        ["x1", "x2"], ["score"])
        else:
            prov = tml.TorchModelProvider(lambda p, f: (f @ p["w"] + p["b"])[:, None],
                                          tml.params_from_numpy(params, "cpu"),
                                          ["x1", "x2"], ["score"], device="cpu")
        tenv.register_model("scorer", prov)
        rows[pkg] = tenv.execute_sql_to_list(
            "SELECT user, ML_PREDICT(scorer, x1, x2) AS score FROM clicks")
    assert [r["user"] for r in rows["port"]] == [r["user"] for r in rows["jax"]]
    np.testing.assert_allclose([r["score"] for r in rows["port"]],
                               [r["score"] for r in rows["jax"]], rtol=1e-6)
    assert {r["user"]: r["score"] for r in rows["port"]} == {
        "a": pytest.approx(4.0), "b": pytest.approx(7.5), "c": pytest.approx(0.125)}


def test_sql_ml_predict_with_several_outputs_and_a_where():
    rows = {}
    for pkg, tenv in _tenvs().items():
        mod, ml = (jtb, jml) if pkg == "jax" else (ttb, tml)
        tenv.from_rows("t", [{"x": float(i), "k": i % 3} for i in range(20)],
                       mod.TableSchema(["x", "k"]))
        tenv.register_model("two", ml.FnModelProvider(
            lambda f: np.concatenate([f * 2, f + 1], axis=1), ["x"], ["dbl", "inc"]))
        rows[pkg] = tenv.execute_sql_to_list(
            "SELECT k, ML_PREDICT(two, x) FROM t WHERE k = 1")
    assert rows["port"] == rows["jax"] and len(rows["port"]) == 7


def test_refusals_match_the_jax_package():
    for pkg, tenv in _tenvs().items():
        mod, ml = (jtb, jml) if pkg == "jax" else (ttb, tml)
        tenv.from_rows("t", [{"x": 1.0, "ts": 1}], mod.TableSchema(["x", "ts"]))
        with pytest.raises(KeyError, match="unknown model"):
            tenv.sql_query("SELECT ML_PREDICT(nope, x) AS y FROM t")
        tenv.register_model("m", ml.FnModelProvider(lambda f: f, ["a", "b"], ["y"]))
        with pytest.raises(ValueError, match="model wants 2"):
            tenv.sql_query("SELECT ML_PREDICT(m, x) AS y FROM t")
        with pytest.raises(NotImplementedError, match="windowed aggregate"):
            tenv.sql_query("SELECT x, COUNT(*) AS c, ML_PREDICT(m, x, x) AS y FROM t "
                           "GROUP BY x, TUMBLE(ts, INTERVAL '1' SECOND)")


@pytest.mark.parametrize("max_batch", [1, 3, 4, 16])
def test_batching_predictor_order_and_flush_boundaries(max_batch):
    calls = {}
    out = {}
    for pkg, ml in (("jax", jml), ("port", tml)):
        seen = calls.setdefault(pkg, [])

        def fn(f, _seen=seen):
            _seen.append(len(f))
            return f.sum(axis=1, keepdims=True)

        bp = ml.BatchingPredictor(ml.FnModelProvider(fn, ["x"], ["y"]), max_batch=max_batch)
        for i in range(10):
            bp.offer({"x": float(i), "tag": i})
        out[pkg] = bp.drain()
        assert bp.drain() == []
    assert out["port"] == out["jax"]
    assert [r["tag"] for r in out["port"]] == list(range(10))
    assert calls["port"] == calls["jax"]
    assert calls["port"] == [max_batch] * (10 // max_batch) + ([10 % max_batch]
                                                             if 10 % max_batch else [])


def test_torch_provider_without_a_gpu_raises_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is cuda")
    with pytest.raises(RuntimeError, match="no GPU"):
        tml.TorchModelProvider(torch_mlp, {}, ["x"], ["y"])
    with pytest.raises(RuntimeError, match="no GPU"):
        tml.params_from_numpy({"w": np.ones(2)})
