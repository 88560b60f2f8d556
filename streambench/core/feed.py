"""The benchmark's own source and sink, with their clocks.

`FeedSource` is a `flink_tpu_torch.connectors.source.Source`: one split,
one reader that cuts batches of the cell's step size from the
configuration's generator (`gens/<config>.py`) and stamps them with event
time advancing at the configuration's rate:

    ts(i) = t0_ms + (i * 1000) // event_rate_per_s      (record i, int64 ms)

It runs in phases. First the warm-up (`warmup_batches` whole batches, or
`warmup_event_s` of event time rounded up to whole batches), which is
set-up; then the window, which opens at the first poll after the warm-up
and closes at the first poll `seconds` later, when the reader reports the
end of input and the job drains. The loop is closed: a batch is handed
over as soon as the job polls. Hooks given in `at` run on the job's
thread at the first poll that many seconds into the window (the traced
run's profiler starts and stops so); a hook may add another to `at`, and
their time is not the source's.

Every poll is timed on the source's own clocks (wall and thread CPU), and
every batch handed over is logged with its hand-over time and the
watermark the job derives from it (bounded out-of-orderness: the largest
timestamp so far, less the bound, less 1). `TimedSink` logs each batch of
result rows with the time it arrived.
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from flink_tpu_torch.connectors.sink import Sink, SinkWriter
from flink_tpu_torch.connectors.source import (
    Batch,
    Source,
    SourceReader,
    SourceSplit,
    SplitEnumerator,
)


def event_times(lo: int, n: int, t0_ms: int, rate: int) -> np.ndarray:
    """Event time (int64 ms) of records lo .. lo+n-1."""
    idx = np.arange(lo, lo + n, dtype=np.int64)
    return t0_ms + (idx * 1000) // rate


class EventClock:
    """`event_times` for batches of n records, into buffers it reuses. Event
    time is a step function of the record's number: where a batch holds
    long runs of one millisecond (64 records or more each) each run is one
    slice fill; otherwise, with lo * 1000 = q * rate + r, record lo + k is
    at t0 + q + D[k] + (M[k] >= rate - r), where D[k], M[k] = divmod(k *
    1000, rate). A buffer is reused only once no one else holds it (the job
    keeps a batch's timestamps until it stages them), so the source touches
    fresh memory only while the set it cycles through grows."""

    def __init__(self, n: int, t0_ms: int, rate: int):
        k = np.arange(n, dtype=np.int64) * 1000
        self.D, self.M = np.divmod(k, rate)
        self.n, self.t0, self.rate = n, int(t0_ms), int(rate)
        self._free: List[np.ndarray] = []
        self._carry = np.empty(n, bool)

    def _buffer(self) -> np.ndarray:
        for buf in self._free:
            # referenced by the list, the loop and getrefcount's argument alone
            if sys.getrefcount(buf) <= 3:
                return buf
        buf = np.empty(self.n, np.int64)
        self._free.append(buf)
        return buf

    def __call__(self, lo: int) -> np.ndarray:
        lo, n, rate, t0 = int(lo), self.n, self.rate, self.t0
        ts = self._buffer()
        first = t0 + (lo * 1000) // rate
        last = t0 + ((lo + n - 1) * 1000) // rate
        if (last - first + 1) * 64 <= n:
            a = 0
            for v in range(first, last + 1):
                # the first record at v + 1 ms or later
                b = min(-(-(v + 1 - t0) * rate // 1000) - lo, n)
                ts[a:b] = v
                a = b
            return ts
        q, r = divmod(lo * 1000, rate)
        np.add(self.D, t0 + q, out=ts)
        np.greater_equal(self.M, rate - r, out=self._carry)
        ts += self._carry
        return ts


def warmup_records(traffic: dict, batch: int, rate: int) -> int:
    """The warm-up's records, in whole batches."""
    if "warmup_batches" in traffic:
        return int(traffic["warmup_batches"]) * batch
    n = int(float(traffic["warmup_event_s"]) * rate)
    return -(-n // batch) * batch


class FeedState:
    """What the reader logs, read by the runner and the metric readers.
    Times are `time.perf_counter()` seconds."""

    def __init__(self):
        self.handed = 0                 # records handed over in all
        self.window_records = 0         # of them, in the window
        self.t_open: Optional[float] = None
        self.t_close: Optional[float] = None   # the poll that ended the input
        self.poll_wall_s = 0.0          # in the window: time inside poll_batch
        self.poll_cpu_s = 0.0           # in the window: its thread CPU time
        self.hand_t: List[float] = []   # per batch: hand-over time
        self.hand_wm: List[int] = []    # per batch: the watermark it brings
        self.polled = False
        self.opened = threading.Event()


class _FeedReader(SourceReader):
    def __init__(self, src: "FeedSource"):
        self.src = src

    def add_split(self, split: SourceSplit) -> None:
        pass

    def poll_batch(self, max_records: int) -> Optional[Batch]:
        s = self.src
        st = s.state
        t_in = time.perf_counter()
        c_in = time.thread_time()
        if st.t_close is not None:
            return None
        if not st.polled:
            st.polled = True
            if s.on_first_poll is not None:
                s.on_first_poll()
        if st.t_open is None and st.handed >= s.warm_records:
            st.t_open = t_in
            if s.on_open is not None:
                s.on_open()
            st.opened.set()
            c_in = time.thread_time()      # the hook's work is not the source's
        in_window = st.t_open is not None
        if in_window and t_in - st.t_open >= s.seconds:
            st.t_close = t_in
            return None
        if in_window and s.at and t_in - st.t_open >= s.at[0][0]:
            while s.at and t_in - st.t_open >= s.at[0][0]:
                s.at.pop(0)[1]()
                s.at.sort(key=lambda h: h[0])     # a hook may add one
            t_in, c_in = time.perf_counter(), time.thread_time()
        n = s.batch
        if max_records < n:
            raise ValueError(f"the job polls {max_records} records, the cell's batch is {n}")
        lo = st.handed
        values = s.gen.batch(lo, n)
        ts = s.clock(lo)
        st.handed = lo + n
        if in_window:
            st.window_records += n
        st.hand_wm.append(int(ts[-1]) - s.bound_ms - 1)
        t_out = time.perf_counter()
        st.hand_t.append(t_out)
        if in_window:
            st.poll_wall_s += t_out - t_in
            st.poll_cpu_s += time.thread_time() - c_in
        return Batch(values, ts)


class FeedSource(Source):
    """The cell's source (see the module docstring). `on_first_poll` and
    `on_open` run on the job's thread, at its first poll and when the
    window opens."""

    boundedness = "BOUNDED"

    def __init__(self, gen, *, batch: int, event_rate: int, t0_ms: int, bound_ms: int,
                 warm_records: int, seconds: float,
                 on_open: Optional[Callable[[], None]] = None,
                 on_first_poll: Optional[Callable[[], None]] = None,
                 at: Sequence[Tuple[float, Callable[[], None]]] = ()):
        self.gen = gen
        self.batch = int(batch)
        self.event_rate = int(event_rate)
        self.t0_ms = int(t0_ms)
        self.bound_ms = int(bound_ms)
        self.warm_records = int(warm_records)
        self.seconds = float(seconds)
        self.on_open = on_open
        self.on_first_poll = on_first_poll
        self.at = sorted(at, key=lambda a: a[0])
        self.state = FeedState()
        self.clock = EventClock(self.batch, self.t0_ms, self.event_rate)

    def create_enumerator(self) -> SplitEnumerator:
        return SplitEnumerator([SourceSplit("streambench-feed")])

    def create_reader(self) -> SourceReader:
        return _FeedReader(self)


class _TimedWriter(SinkWriter):
    def __init__(self, sink: "TimedSink"):
        self.sink = sink

    def write_batch(self, values, timestamps=None) -> None:
        t = time.perf_counter()
        self.sink.batches.append((t, values, np.asarray(timestamps, np.int64)))

    def close(self) -> None:
        self.sink.t_end = time.perf_counter()
        if self.sink.on_close is not None:
            self.sink.on_close()


class TimedSink(Sink):
    """Keeps every batch of result rows with its arrival time; `t_end` is
    when the job closed the sink, the last thing a finished job does, and
    `on_close` runs on the job's thread right after."""

    def __init__(self, on_close: Optional[Callable[[], None]] = None):
        self.batches: List[tuple] = []
        self.t_end: Optional[float] = None
        self.on_close = on_close

    def create_writer(self) -> SinkWriter:
        return _TimedWriter(self)

    def rows(self):
        """(keys int64, results float64, ts int64, arrival float64) of
        every row, in arrival order. A row is (key, result)."""
        if not self.batches:
            e = np.empty(0, np.int64)
            return e, e, e, np.empty(0)
        vals = [v for _t, b, _ts in self.batches for v in b]
        keys = np.fromiter((v[0] for v in vals), np.int64, len(vals))
        res = np.fromiter((v[1] for v in vals), np.float64, len(vals))
        ts = np.concatenate([b for _t, _v, b in self.batches])
        arr = np.concatenate([np.full(len(v), t) for t, v, _b in self.batches])
        return keys, res, ts, arr
