"""Latency mode (`execution.latency.*`) on the port, held against the JAX
package's latency-mode operator and against the port's own throughput mode.

- Readback groups: a T = 32 dispatch run as groups of 2, 4, 8 and 16 steps
  (`FusedWindowPipeline._process_grouped`) gives the rows of the
  whole-span dispatch, in order, and the JAX operator's rows at the same
  split (its `_process_grouped` on the CPU's XLA superscan).
- Ladder rungs: the controller pinned at each rung of the ladder (2, 4,
  8, 16, 32 steps a dispatch) gives the full-span rows.
- Flag off: `target_ms` 0 (or no spec) builds the operator and its
  dispatches as throughput mode does; the executor passes no latency
  option unless target-ms is set.
- The in-flight ring stays within `max_inflight` and drains at barriers
  (flush_all, snapshot); a restore resets the ring and the controller.
- The traced-chain form (`_process_grouped_raw`) and the executor's
  threading of the options through `env.execute()`.

The controller's rung is pinned in both packages by a constant clock (its
rate estimate stays None, so it holds the rung it is given): the choice
of rung depends on wall time otherwise. Tolerance: exact, rows in order;
payloads are small integers, so float32 sums are exact in any order.
"""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from flink_tpu.api.datastream import StreamExecutionEnvironment as JaxEnv  # noqa: E402
from flink_tpu.api.windowing import assigners as jasg  # noqa: E402
from flink_tpu.config import Configuration as JaxConfiguration  # noqa: E402
from flink_tpu.connectors.source import Batch as JaxBatch  # noqa: E402
from flink_tpu.connectors.source import DataGeneratorSource as JaxGeneratorSource  # noqa: E402
from flink_tpu.core.time import MAX_WATERMARK  # noqa: E402
from flink_tpu.core.watermarks import WatermarkStrategy as JaxWatermarkStrategy  # noqa: E402
from flink_tpu.runtime import fused_window_operator as jfo  # noqa: E402
from flink_tpu.runtime import fused_window_pipeline as jfp  # noqa: E402
from flink_tpu.scheduler.latency_controller import LatencySpec as JaxLatencySpec  # noqa: E402
from flink_tpu_torch.api import datastream as tds  # noqa: E402
from flink_tpu_torch.api.windowing import assigners as tasg  # noqa: E402
from flink_tpu_torch.config import Configuration, LatencyOptions  # noqa: E402
from flink_tpu_torch.connectors.source import Batch, DataGeneratorSource  # noqa: E402
from flink_tpu_torch.core.watermarks import WatermarkStrategy  # noqa: E402
from flink_tpu_torch.graph.transformation import plan  # noqa: E402
from flink_tpu_torch.runtime import executor as tex  # noqa: E402
from flink_tpu_torch.runtime import fused_window_operator as tfo  # noqa: E402
from flink_tpu_torch.runtime import fused_window_pipeline as tfp  # noqa: E402
from flink_tpu_torch.scheduler.latency_controller import LatencySpec  # noqa: E402

NUM_KEYS = 48
T = 32
KW = dict(key_capacity=NUM_KEYS, superbatch_steps=T, num_slices=16, chunk=128,
          out_rows=64)


def _window(m):
    return m.SlidingEventTimeWindows.of(2000, 500)


def _batches(steps, batch, seed):
    """(raw keys, small integer values, mildly disordered timestamps) and
    the watermark after each batch; a step advances event time 150 ms, so
    a 32-step dispatch fires windows in several of its readback groups."""
    rng = np.random.default_rng(seed)
    out, wms = [], []
    t_cursor = 7000.0
    for _t in range(steps):
        keys = rng.integers(0, NUM_KEYS, batch) * 7 + 3
        vals = rng.integers(0, 9, batch).astype(np.float32)
        base = t_cursor + np.sort(rng.random(batch)) * 150.0
        ts = np.maximum(base.astype(np.int64) - rng.integers(0, 60, batch), 0)
        out.append((keys, vals, ts))
        wms.append(int(base[-1]) - 80)
        t_cursor += 150.0
    return out, wms


def _pin(op, rung=None):
    """Hold op's controller at ladder rung `rung` (index; None: the top)."""
    c = op._controller
    c._clock = lambda: 0.0
    if rung is not None:
        c._rung = rung
    return op


def _rows(op):
    return [(k, (w.start, w.end), r, int(ts)) for k, w, r, ts in op.drain_output()]


def _run(op, batches, wms, raw=False):
    rows = []
    for (keys, vals, ts), wm in zip(batches, wms):
        if raw:
            op.process_raw_batch(keys, ts)
        else:
            op.process_batch(keys, vals, ts)
        op.process_watermark(wm)
        rows += _rows(op)
    op.process_watermark(MAX_WATERMARK - 1)
    return rows + _rows(op)


def _port(agg, latency=None, **kw):
    return tfo.FusedWindowOperator(_window(tasg), agg, device="cpu", latency=latency,
                                   **{**KW, **kw})


def _jax(agg, latency=None, **kw):
    return jfo.FusedWindowOperator(_window(jasg), agg, latency=latency, **{**KW, **kw})


@pytest.fixture(scope="module")
def stream():
    return _batches(80, 120, seed=3)


@pytest.fixture(scope="module")
def full_span(stream):
    return {agg: _run(_port(agg), *stream) for agg in ("count", "sum")}


@pytest.mark.parametrize("readback", [2, 4, 8, 16])
@pytest.mark.parametrize("agg", ["count", "sum"])
def test_every_readback_split_matches_full_span_and_jax(stream, full_span, agg, readback):
    spec = dict(target_ms=50, readback_steps=readback, max_inflight=2)
    port = _pin(_port(agg, LatencySpec(**spec)))
    got = _run(port, *stream)
    assert port.pipe.readback_steps == readback and port.pipe.donate_carry
    assert got == full_span[agg] and len(got) > 100
    ref = _run(_pin(_jax(agg, JaxLatencySpec(**spec))), *stream)
    assert got == ref


@pytest.mark.parametrize("rung", [0, 1, 2, 3, 4])
def test_every_ladder_rung_matches_full_span(stream, full_span, rung):
    spec = LatencySpec(target_ms=50, readback_steps=8, max_inflight=2)
    port = _pin(_port("sum", spec), rung)
    assert port._controller.ladder == (2, 4, 8, 16, 32)
    got = _run(port, *stream)
    assert got == full_span["sum"]
    depth = port._controller.ladder[rung]
    assert depth in port._ladder_geoms
    gauges = port.latency_gauges()
    assert gauges["currentBatchRung"] == depth and gauges["inflightDepth"] == 0
    ref = _jax("sum", JaxLatencySpec(target_ms=50, readback_steps=8, max_inflight=2))
    assert _run(_pin(ref, rung), *stream) == got
    assert set(ref.latency_gauges()) == set(gauges)


def test_grouped_dispatch_reads_back_each_groups_rows(stream):
    """One 32-step dispatch as 4 groups of 8: each group's handle holds only
    its own fires, sized to the rows the span has fired by its end, and the
    groups' rows in order are the whole-span dispatch's."""
    batches, wms = stream
    kw = dict(key_capacity=64, num_slices=16, nsb=4, fires_per_step=4, out_rows=64,
              chunk=128, device="cpu")
    whole = tfp.FusedWindowPipeline(_window(tasg), "sum", **kw)
    split = tfp.FusedWindowPipeline(_window(tasg), "sum", **kw)
    split.readback_steps = 8
    steps = [(k % 64, v, ts) for k, v, ts in batches[:T]]
    d = split.process_superbatch(steps, wms[:T], defer=True)
    assert isinstance(d, tfp._StreamedEmissions) and len(d._parts) == 4
    fired = [len(p._fires) for p in d._parts]
    assert sum(fired) > 0 and sum(1 for n in fired if n) >= 2
    done = np.cumsum(fired)
    for part, n in zip(d._parts, done):
        assert part._copy._host[0].shape[0] == min(64, -(-max(n, 1) // 16) * 16)
    _assert_same(d.resolve(), whole.process_superbatch(steps, wms[:T]))
    # a depth the split does not divide runs whole
    split.readback_steps = 12
    assert not split._grouped(T) and split._grouped(24)


def _assert_same(a, b):
    assert len(a) == len(b) > 0
    for (wa, ca, fa), (wb, cb, fb) in zip(a, b):
        assert (wa.start, wa.end) == (wb.start, wb.end)
        assert np.array_equal(ca, cb)
        live = np.asarray(ca) > 0
        for name in fa:
            assert np.array_equal(np.asarray(fa[name])[live], np.asarray(fb[name])[live])


@pytest.mark.parametrize("spec", [None, LatencySpec(target_ms=0, readback_steps=4,
                                                      max_inflight=3)],
                         ids=["no_spec", "target_0"])
def test_flag_off_constructs_and_runs_as_today(stream, full_span, spec):
    op = _port("count", spec)
    assert op._controller is None and op._max_inflight == 1
    assert op.pipe.readback_steps == 0 and not op.pipe.donate_carry
    assert op.latency_gauges() is None
    assert _run(op, *stream) == full_span["count"]
    assert not op._ladder_geoms
    assert tex._latency_kwargs(Configuration()) == {}
    assert tex._latency_kwargs(Configuration({"execution.latency.readback-steps": 4})) == {}


def test_inflight_ring_stays_bounded_and_drains_at_barriers(stream, full_span):
    spec = LatencySpec(target_ms=50, readback_steps=4, max_inflight=3, floor_steps=2)
    op = _pin(_port("sum", spec), 0)
    batches, wms = stream
    depths, rows = [], []
    for (keys, vals, ts), wm in zip(batches, wms):
        op.process_batch(keys, vals, ts)
        op.process_watermark(wm)
        depths.append(len(op._inflight))
        rows += _rows(op)
    assert max(depths) == 3
    snap = op.snapshot()                      # a barrier: flush_all drains the ring
    assert len(op._inflight) == 0
    rows += _rows(op)
    op.process_watermark(MAX_WATERMARK - 1)
    assert rows + _rows(op) == full_span["sum"]
    # restore resets the ring and re-holds the full-span rung
    op._inflight.append(("stale", 0))
    op._controller._rung = 0
    op.restore(snap)
    assert not op._inflight and op._controller.current_steps() == T


def test_raw_prologue_grouped_path_matches_full_span_and_jax():
    rng = np.random.default_rng(11)
    batches, wms = [], []
    t_cursor = 5000.0
    for _t in range(70):
        col = np.stack([rng.integers(0, NUM_KEYS, 100), rng.integers(-5, 6, 100),
                        rng.integers(0, 3, 100)], 1).astype(np.float32)
        base = t_cursor + np.sort(rng.random(100)) * 150.0
        batches.append((col, None, np.maximum(base.astype(np.int64) - 40, 0)))
        wms.append(int(base[-1]) - 60)
        t_cursor += 150.0
    prologue = (
        jfp.TracedPrologue((("filter", lambda c: c[:, 2] < 2),),
                           lambda c: c[:, 0].astype(jnp.int32), lambda c: c[:, 1]),
        tfp.TracedPrologue((("filter", lambda c: c[:, 2] < 2),),
                           lambda c: c[:, 0].to(torch.int32), lambda c: c[:, 1]),
    )
    spec = dict(target_ms=50, readback_steps=4, max_inflight=2)
    whole = _run(_port("sum", prologue=prologue[1]), batches, wms, raw=True)
    port = _pin(_port("sum", LatencySpec(**spec), prologue=prologue[1]))
    got = _run(port, batches, wms, raw=True)
    assert got == whole and len(got) > 100
    ref = _pin(_jax("sum", JaxLatencySpec(**spec), prologue=prologue[0]))
    assert _run(ref, batches, wms, raw=True) == got


def _job(pkg_env, cfg, batch_cls, source_cls, wm_cls, asg, key, env_kw):
    env = pkg_env.get_execution_environment(cfg, **env_kw)

    def gen(idx):
        col = np.stack([(idx * 2654435761) % NUM_KEYS, idx % 3, (idx * 7) % 11],
                       axis=1).astype(np.float32)
        return batch_cls(col, (10_000 + idx * 40_000 // 4096).astype(np.int64))

    ds = env.from_source(source_cls(gen, 4096),
                         watermark_strategy=wm_cls.for_bounded_out_of_orderness(0))
    sink = (ds.filter(lambda c: c[:, 1] < 0.5, traceable=True).key_by(key, traceable=True)
            .window(asg.SlidingEventTimeWindows.of(2000, 500)).aggregate("count").collect())
    return env, sink


LATENCY_CONF = {"execution.latency.target-ms": 50, "execution.latency.readback-steps": 2,
                "execution.latency.max-inflight-dispatches": 2,
                "execution.latency.floor-steps": 2, "execution.latency.min-dwell-ms": 500,
                "execution.latency.hysteresis-pct": 25,
                "execution.step.batch-size": 128, "execution.window.superbatch-steps": 8,
                "execution.state.key-capacity": NUM_KEYS}


@pytest.mark.parametrize("fusion", [True, False], ids=["device_chain", "host_chain"])
def test_executor_threads_the_flag_and_defaults_it_off(fusion):
    conf = dict(LATENCY_CONF, **{"execution.chain.device-fusion": fusion})
    results = []
    for latency in (True, False):
        c = {k: v for k, v in conf.items() if latency or not k.startswith("execution.latency")}
        env, sink = _job(tds.StreamExecutionEnvironment, Configuration(c), Batch,
                         DataGeneratorSource, WatermarkStrategy, tasg,
                         lambda col: col[:, 0].to(torch.int32), {"device": "cpu"})
        runners = tex.build_runners(plan(env._sinks), env.config, "cpu")[0]
        op = next(r.op for r in runners if hasattr(r, "op"))
        assert type(op).__name__ == "FusedWindowOperator"
        if latency:
            assert op.latency == LatencySpec(50, 2, 2, 2, 500, 25)
            assert op.pipe.readback_steps == 2 and op._max_inflight == 2
        else:
            assert op.latency is None and op._controller is None
        env.execute()
        results.append(sorted((int(k), int(v)) for k, v in sink.results))
    jenv, jsink = _job(JaxEnv, JaxConfiguration(conf), JaxBatch, JaxGeneratorSource,
                       JaxWatermarkStrategy, jasg,
                       lambda col: col[:, 0].astype(jnp.int32), {})
    jenv.execute()
    assert results[0] == results[1] == sorted((int(k), int(v)) for k, v in jsink.results)
    assert len(results[0]) > 100


def test_every_latency_option_is_accepted_with_the_jax_defaults():
    cfg = Configuration()
    for name in ("TARGET_MS", "MAX_INFLIGHT", "FLOOR_STEPS", "READBACK_STEPS",
                 "MIN_DWELL_MS", "HYSTERESIS_PCT"):
        from flink_tpu.config import LatencyOptions as JaxLatencyOptions

        mine, ref = getattr(LatencyOptions, name), getattr(JaxLatencyOptions, name)
        assert (mine.key, mine.default) == (ref.key, ref.default)
        cfg.set_string(mine.key, str(ref.default + 1))
        assert cfg.get(mine) == ref.default + 1
