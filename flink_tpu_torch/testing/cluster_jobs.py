"""Cluster jobs whose every part is importable by name.

A job spec crosses to a TaskExecutor pickled (runtime/cluster.py
`_PickledSpec`). Without cloudpickle that is the standard library's
pickle, which ships functions and classes by reference: a TaskManager
process can rebuild a spec only when its sources, UDFs and sinks live at
module level in a module it can import. These are the jobs the cluster's
checks run that way:

- `api_graph_spec`: the api_ysb DataStream program (a traceable filter
  keeping one record in three, a traceable key, a 10 s window sliding by
  1 s, `count`) as a `GraphJobSpec`; with `stages=True` the window sits in
  its own slot-sharing group, so the source/filter stage and the window
  stage run as two tasks joined by the data plane. `ApiGen` can pace the
  stream, so a check can act while the job runs.
- `ApiShardSource` and `SessionShardSource`: `DistributedJobSpec` sources
  over the same api stream and over the session clickstream, split over
  the shards record by record, with the watermark every shard gives a step.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from flink_tpu_torch.connectors.sink import Sink, SinkWriter
from flink_tpu_torch.connectors.source import Batch
from flink_tpu_torch.testing import stream as st


def t_filter(col):
    """event_type 0: one record in three (traceable)."""
    return col[:, 1] < 0.5


def t_key(col):
    """The campaign column as the dense int32 key (traceable)."""
    return col[:, 0].to(torch.int32)


class ApiGen:
    """generator_fn of the api stream of n records over `keys` campaigns,
    each batch read `delay_s` late (paces a job so a check can act while
    it runs)."""

    def __init__(self, n: int, keys: int, *, delay_s: float = 0.0):
        self.n, self.keys, self.delay_s = n, keys, delay_s

    def __call__(self, idx):
        if self.delay_s:
            time.sleep(self.delay_s)
        return Batch(*st.api_columns(idx, self.n, self.keys))


#: device memory allocated at each writer's first batch (one writer an
#: attempt), by sink label: TaskExecutors in the caller's process record
#: here, so a check can hold a restarted attempt's memory to the first's
FIRST_WRITE_BYTES = {}


class _TimedWriter(SinkWriter):
    def __init__(self, store, label=None):
        self.store, self.label = store, label

    def write(self, value, timestamp=None) -> None:
        self.store.append((value, None if timestamp is None else int(timestamp)))

    def write_batch(self, values, timestamps=None) -> None:
        if self.label is not None:
            FIRST_WRITE_BYTES.setdefault(self.label, []).append(
                torch.cuda.memory_allocated() if torch.cuda.is_available() else 0)
            self.label = None
        if timestamps is None:
            self.store.extend((v, None) for v in values)
        else:
            self.store.extend(zip(values, (int(t) for t in timestamps)))


class TimedCollectSink(Sink):
    """Collects (record, timestamp) pairs: a window's row with the window's
    max timestamp, so rows of different windows stay apart. The cluster
    returns a task's `store` as its result. With `label`, each writer logs
    the device memory allocated at its first batch in FIRST_WRITE_BYTES."""

    def __init__(self, label=None):
        self.results, self.label = [], label

    def create_writer(self) -> SinkWriter:
        return _TimedWriter(self.results, self.label)


def api_graph(n: int, *, keys: int, batch: int, window_ms: int, slide_ms: int,
              device, stages: bool = False, columnar: bool = True, gen=None,
              label=None):
    """(env, sink) of the api_ysb sliding count over n records; columnar
    output by default (a fire's rows as one (window, key ids, counts)
    record: a checkpoint of the collected rows then holds arrays, not a
    Python object a row), row mode with columnar=False."""
    from flink_tpu_torch.api.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.api.windowing.assigners import SlidingEventTimeWindows
    from flink_tpu_torch.config import Configuration, ExecutionOptions
    from flink_tpu_torch.connectors.source import DataGeneratorSource
    from flink_tpu_torch.core.watermarks import WatermarkStrategy

    cfg = Configuration()
    cfg.set(ExecutionOptions.CHAIN_FUSION, True)
    cfg.set(ExecutionOptions.BATCH_SIZE, batch)
    cfg.set(ExecutionOptions.KEY_CAPACITY, keys)
    cfg.set(ExecutionOptions.COLUMNAR_OUTPUT, columnar)
    env = StreamExecutionEnvironment(cfg, device=device)
    gen = gen or ApiGen(n, keys)
    win = (env.from_source(DataGeneratorSource(gen, n),
                           WatermarkStrategy.for_bounded_out_of_orderness(0))
           .filter(t_filter, traceable=True).key_by(t_key, traceable=True)
           .window(SlidingEventTimeWindows.of(window_ms, slide_ms)).aggregate("count"))
    if stages:
        win.slot_sharing_group("window")
    sink = TimedCollectSink(label)
    win.sink_to(sink)
    return env, sink


def api_graph_spec(name: str, n: int, **kw):
    """The api_graph job as a GraphJobSpec (same arguments)."""
    from flink_tpu_torch.graph.transformation import plan
    from flink_tpu_torch.runtime.cluster import GraphJobSpec

    env, _sink = api_graph(n, **kw)
    return GraphJobSpec(name, plan(env._sinks), env.config)


def fired_rows(results) -> list:
    """A TimedCollectSink's (or a cluster result's) rows as sorted
    (window max timestamp, key, count) triples, from row-mode records
    ((key, count), window max timestamp) or packed columnar fires
    ((window, key ids, counts), ts)."""
    out = []
    for r, t in results:
        if len(r) == 3:
            last = int(r[0].end) - 1
            out.extend((last, int(k), int(v))
                       for k, v in zip(np.asarray(r[1]).tolist(), np.asarray(r[2]).tolist()))
        else:
            out.append((int(t), int(r[0]), int(r[1])))
    return sorted(out)


class PacedSteps(list):
    """A shard's step batches, each read `delay_s` late (paces a job so a
    check can act while it runs)."""

    def __init__(self, items, delay_s: float):
        super().__init__(items)
        self.delay_s = delay_s

    def __getitem__(self, i):
        time.sleep(self.delay_s)
        return super().__getitem__(i)


class ApiShardSource:
    """DistributedJobSpec source: the api stream's `steps` x `batch`
    records (campaign key, ones, timestamps), shard s taking records
    s, s + P, ... of each step; every shard gives step t the watermark
    one below its last timestamp. With `delay_s` each step is read that
    much late."""

    def __init__(self, steps: int, batch: int, keys: int, delay_s: float = 0.0):
        self.steps, self.batch, self.keys = steps, batch, keys
        self.delay_s = delay_s

    def records(self, idx):
        col, ts = st.api_columns(idx, self.steps * self.batch, self.keys)
        return col[:, 0].astype(np.int64), ts

    def __call__(self, shard: int, num_shards: int) -> list:
        out = []
        for t in range(self.steps):
            idx = np.arange(t * self.batch + shard, (t + 1) * self.batch, num_shards,
                            dtype=np.int64)
            keys, ts = self.records(idx)
            _k, last = self.records(np.array([(t + 1) * self.batch - 1], np.int64))
            out.append((keys, np.ones(len(idx)), ts, int(last[0]) - 1))
        return PacedSteps(out, self.delay_s) if self.delay_s else out


class SessionShardSource:
    """DistributedJobSpec source: the session clickstream's `steps` x
    `batch` records (`testing.stream.session_records`), shard s taking
    records s, s + P, ... of each step. Step t's watermark is one below
    the least timestamp step t + 1 can hold, so no record is late."""

    def __init__(self, steps: int, batch: int):
        self.steps, self.batch = steps, batch

    def __call__(self, shard: int, num_shards: int) -> list:
        out = []
        for t in range(self.steps):
            idx = np.arange(t * self.batch + shard, (t + 1) * self.batch, num_shards,
                            dtype=np.int64)
            keys, ts, vals = st.session_records(idx, self.batch)
            out.append((keys, vals.astype(np.float64), ts,
                        (t + 1) * st.STEP_MS - st.OOO_MS - 1))
        return out
