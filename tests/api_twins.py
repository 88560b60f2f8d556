"""The two packages side by side for the DataStream API twins.

`JAX` and `PORT` name each package's modules under one set of attributes,
so a twin builds the same job on both (`build(P, env)`), runs it through
each package's `env.execute()` (`JAX_PLATFORMS=cpu`, the port with
`device="cpu"`) and compares the rows. Records are made with numpy from a
seed. `RunnerProbe` drives one runner directly, its downstream and side
channels collected, so a runner's snapshot can be restored across the
packages and fed the rest of the same input.
"""

import types

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")

import torch  # noqa: E402

import flink_tpu.cep as jcep  # noqa: E402
import flink_tpu_torch.cep as tcep  # noqa: E402
from flink_tpu.api import datastream as jds  # noqa: E402
from flink_tpu.api import functions as jfn  # noqa: E402
from flink_tpu.api import v2 as jv2  # noqa: E402
from flink_tpu.api.windowing import assigners as jasg  # noqa: E402
from flink_tpu.config import Configuration as JaxConfiguration  # noqa: E402
from flink_tpu.connectors import source as jsrc  # noqa: E402
from flink_tpu.core.watermarks import WatermarkStrategy as JaxWatermarkStrategy  # noqa: E402
from flink_tpu.graph import transformation as jtr  # noqa: E402
from flink_tpu.runtime import async_io as jaio  # noqa: E402
from flink_tpu.runtime import coordination as jcoord  # noqa: E402
from flink_tpu.runtime import executor as jex  # noqa: E402
from flink_tpu.runtime import minicluster as jmc  # noqa: E402
from flink_tpu.table import TableEnvironment as JaxTableEnvironment  # noqa: E402
from flink_tpu.table import TableSchema as JaxTableSchema  # noqa: E402
from flink_tpu_torch.api import datastream as tds  # noqa: E402
from flink_tpu_torch.api import functions as tfn  # noqa: E402
from flink_tpu_torch.api import v2 as tv2  # noqa: E402
from flink_tpu_torch.api.windowing import assigners as tasg  # noqa: E402
from flink_tpu_torch.config import Configuration  # noqa: E402
from flink_tpu_torch.connectors import source as tsrc  # noqa: E402
from flink_tpu_torch.core.watermarks import WatermarkStrategy  # noqa: E402
from flink_tpu_torch.graph import transformation as ttr  # noqa: E402
from flink_tpu_torch.runtime import async_io as taio  # noqa: E402
from flink_tpu_torch.runtime import coordination as tcoord  # noqa: E402
from flink_tpu_torch.runtime import executor as tex  # noqa: E402
from flink_tpu_torch.runtime import minicluster as tmc  # noqa: E402
from flink_tpu_torch.table import TableEnvironment, TableSchema  # noqa: E402

JAX = types.SimpleNamespace(
    port=False, ds=jds, fn=jfn, v2=jv2, asg=jasg, cfg=JaxConfiguration, src=jsrc,
    wm=JaxWatermarkStrategy, tr=jtr, aio=jaio, coord=jcoord, ex=jex, mc=jmc, cep=jcep,
    tenv=JaxTableEnvironment, schema=JaxTableSchema,
    # traceable column functions: jnp on the JAX package, torch on the port
    key=lambda col: col[:, 0].astype(jnp.int32))
PORT = types.SimpleNamespace(
    port=True, ds=tds, fn=tfn, v2=tv2, asg=tasg, cfg=Configuration, src=tsrc,
    wm=WatermarkStrategy, tr=ttr, aio=taio, coord=tcoord, ex=tex, mc=tmc, cep=tcep,
    tenv=TableEnvironment, schema=TableSchema,
    key=lambda col: col[:, 0].to(torch.int32))
PKGS = (JAX, PORT)


def env(P, **conf):
    """A StreamExecutionEnvironment of package P (the port's on the CPU),
    batch 64 unless `conf` says otherwise."""
    cfg = P.cfg({"execution.step.batch-size": 64, **conf})
    if P.port:
        return P.ds.StreamExecutionEnvironment(cfg, device="cpu")
    return P.ds.StreamExecutionEnvironment.get_execution_environment(cfg)


def records(n=600, seed=18, keys=8, span_ms=30_000, jitter_ms=200):
    """(key, kind, value, ts) tuples: keys < `keys`, kind 0/1/2
    (impression, click, purchase), value a small int, ts mildly out of
    order over `span_ms`."""
    rng = np.random.default_rng(seed)
    ts = np.sort(rng.integers(0, span_ms, n)) + rng.integers(-jitter_ms, jitter_ms + 1, n)
    return [(int(k), int(c), int(v), int(t)) for k, c, v, t in zip(
        rng.integers(0, keys, n), rng.integers(0, 3, n), rng.integers(0, 10, n),
        np.maximum(ts, 0))]


def stream(P, e, recs, bound=300, name="collection"):
    """A collection source of `recs` stamped with r[3] and watermarks
    `bound` ms behind the largest timestamp."""
    s = e.from_collection(recs, timestamp_fn=lambda r: r[3],
                          watermark_strategy=P.wm.for_bounded_out_of_orderness(bound))
    s.transform.name = name
    return s


def columns(P, n=4096, keys=64, parity=None):
    """A columnar source of api_path_microbench's columns (campaign, event
    type): records 2i + parity of a 2n-record stream when `parity` is set."""
    def gen(idx):
        i = idx if parity is None else 2 * idx + parity
        m = n if parity is None else 2 * n
        col = np.stack([(i * 2654435761) % keys, i % 3], axis=1).astype(np.float32)
        return P.src.Batch(col, (10_000 + i * 64_000 // m).astype(np.int64))
    return P.src.DataGeneratorSource(gen, n)


def runner_kinds(P, e) -> list:
    """The runner classes each package builds for the environment's job."""
    graph = P.tr.plan(e._sinks + e._roots)
    extra = ("cpu",) if P.port else ()
    return [type(r).__name__ for r in P.ex.build_runners(graph, e.config, *extra)[0]]


def twin(build, rows=lambda rs: rs, **conf):
    """Build the job on both packages (build(P, env) returns its sink), run
    each through env.execute() and return (JAX rows, port rows), each
    passed through `rows`."""
    out = []
    for P in PKGS:
        e = env(P, **conf)
        sink = build(P, e)
        e.execute()
        out.append(rows(sink.results))
    return out


class Collect:
    """A runner's downstream or side channel that keeps what it is given:
    `batches` of (values, timestamps) and `watermarks`."""

    def __init__(self):
        self.batches, self.watermarks = [], []

    def __bool__(self):
        return True

    def on_batch(self, values, timestamps):
        self.batches.append((list(values), [int(t) for t in timestamps]))

    def on_watermark(self, wm):
        self.watermarks.append(int(wm))

    def on_marker(self, wall_ms):
        pass

    def on_end(self):
        pass

    def rows(self):
        return [(v, t) for vs, ts in self.batches for v, t in zip(vs, ts)]


class RunnerProbe:
    """One runner of package P's plan of a job, fed directly: `feed`
    delivers ("batch", gate, records, ts) and ("wm", gate, wm) events;
    the downstream and every side tag in `tags` are collected."""

    def __init__(self, P, e, kind, tags=()):
        graph = P.tr.plan(e._sinks + e._roots)
        extra = ("cpu",) if P.port else ()
        runners = P.ex.build_runners(graph, e.config, *extra)[0]
        self.runner = next(r for r in runners if type(r).__name__ == kind)
        self.out = Collect()
        self.runner.downstream = self.out
        self.sides = {t: Collect() for t in tags}
        self.runner.sides = dict(self.sides) or None

    def feed(self, events):
        for ev in events:
            if ev[0] == "batch":
                _, gate, recs, ts = ev
                vals = np.empty(len(recs), dtype=object)
                vals[:] = recs
                self.runner.on_batch_n(gate, vals, np.asarray(ts, dtype=np.int64))
            elif ev[0] == "wm":
                self.runner.on_watermark_n(ev[1], ev[2])
            else:   # ("pt", now_ms): a processing-time tick
                self.runner.on_processing_time(ev[1])
        return self

    def rows(self):
        return self.out.rows(), {t: c.rows() for t, c in self.sides.items()}


def batches(recs, size=50, gates=(0,), bound=300):
    """The (batch, watermark) events of `recs` in batches of `size` for
    each gate in turn, the watermark `bound` behind the largest timestamp
    so far."""
    events, hi = [], None
    for lo in range(0, len(recs), size):
        chunk = recs[lo:lo + size]
        hi = max([hi or 0] + [r[3] for r in chunk])
        for g in gates:
            events.append(("batch", g, chunk, [r[3] for r in chunk]))
            events.append(("wm", g, hi - bound - 1))
    return events


def register_restored_states(runner, snap):
    """Register a restored heap snapshot's states on a JAX runner's backend:
    the JAX backend restores no descriptors and raises KeyError at the
    first use of a state its function declared at first use (ROADMAP.md
    Queue C; the port's registers it there)."""
    from flink_tpu.state.heap import value_state

    for name in snap["state"]:
        runner.state.register(value_state(name))


def restored_across(make, events, cut, kind, tags=(), jax_restore=None):
    """Run `events` through the runner of `kind` of each package's job
    (make(P, env) builds it) uninterrupted, and with a snapshot taken after
    events[:cut] restored into a fresh runner of each package, which takes
    the rest (`jax_restore(runner, snap)` runs after a restore into the JAX
    package's). Returns ([JAX, port] uninterrupted, {"jax>jax", "jax>port",
    "port>jax", "port>port": restored}), each as (rows, sides); a restored
    run holds the outputs of both halves."""
    def probe(P):
        e = env(P)
        make(P, e)
        return RunnerProbe(P, e, kind, tags)

    whole = [probe(P).feed(events).rows() for P in PKGS]
    restored = {}
    for src in PKGS:
        for dst in PKGS:
            first = probe(src).feed(events[:cut])
            snap = first.runner.snapshot()
            second = probe(dst)
            second.runner.restore(snap)
            if dst is JAX and jax_restore is not None:
                jax_restore(second.runner, snap)
            second.feed(events[cut:])
            rows, sides = first.rows()
            rows2, sides2 = second.rows()
            name = ("port" if src.port else "jax") + ">" + ("port" if dst.port else "jax")
            restored[name] = (rows + rows2, {t: sides[t] + sides2[t] for t in sides})
    return whole, restored


def assert_restores_like_jax(out, min_rows=1):
    """The uninterrupted runs equal; every restore equals the JAX package's
    own restore exactly; and a restore holds the uninterrupted run's rows
    (its order of equal-time timers may differ, in both packages, as the
    timer service restarts its sequence at a restore)."""
    whole, restored = out
    assert repr(whole[1]) == repr(whole[0]) and len(whole[0][0]) >= min_rows
    want = repr(restored["jax>jax"])
    assert all(repr(r) == want for r in restored.values())

    def canon(run):
        return sorted(map(repr, run[0])), {t: sorted(map(repr, v)) for t, v in run[1].items()}

    assert canon(restored["jax>jax"]) == canon(whole[0])
