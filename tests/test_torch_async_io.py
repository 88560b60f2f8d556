"""Async I/O on the port held against the JAX package. Modelled on
tests/test_async_io.py: `AsyncExecutor` (ordered and unordered waits,
capacity, a timeout with its fallback value, retry strategies) driven the
same way in both packages, and `DataStream.async_map` through both
packages' `env.execute()`.

The user functions take short delays (or wait on an event the test holds)
and the checks read order, values, timeouts and retry counts, never
elapsed time. Unordered results are compared as multisets.

Tolerance: exact.
"""

import threading
import time

import numpy as np
import pytest

from api_twins import JAX, PKGS, PORT, env, records, runner_kinds, stream, twin


def _varied(x):
    time.sleep(0.002 if x % 3 == 0 else 0.0002)
    return x * 10


@pytest.mark.parametrize("ordered", [True, False])
@pytest.mark.parametrize("capacity", [1, 4, 16])
def test_executor_results_like_jax(ordered, capacity):
    out = []
    for P in PKGS:
        ex = P.aio.AsyncExecutor(_varied, capacity=capacity, ordered=ordered)
        got = ex.process(range(40))
        ex.close()
        out.append(got if ordered else sorted(got))
    assert out[0] == out[1] == [(i, i * 10) for i in range(40)]


def test_capacity_bounds_the_calls_in_flight_in_both():
    for P in PKGS:
        active, peak, lock = [0], [0], threading.Lock()

        def tracked(x, active=active, peak=peak, lock=lock):
            with lock:
                active[0] += 1
                peak[0] = max(peak[0], active[0])
            time.sleep(0.001)
            with lock:
                active[0] -= 1
            return x

        ex = P.aio.AsyncExecutor(tracked, capacity=3, ordered=True)
        assert [r for _i, r in ex.process(range(30))] == list(range(30))
        ex.close()
        assert 1 <= peak[0] <= 3


def test_a_timeout_takes_the_fallback_value_in_both():
    out = []
    for P in PKGS:
        held = threading.Event()

        class Lookup(P.aio.AsyncFunction):
            def async_invoke(self, value):
                if value == 2:
                    held.wait(10)        # released once the executor gave up
                return value

            def timeout_value(self, value):
                return -value

        ex = P.aio.AsyncExecutor(Lookup(), capacity=4, timeout_ms=500, ordered=True)
        out.append(ex.process([1, 2, 3]))
        held.set()
        ex.close()
    assert out[0] == out[1] == [(0, 1), (1, -2), (2, 3)]


def test_a_timeout_without_a_fallback_raises_in_both():
    for P in PKGS:
        held = threading.Event()

        def lookup(value, held=held):
            held.wait(10)
            return value

        ex = P.aio.AsyncExecutor(lookup, capacity=2, timeout_ms=20)
        with pytest.raises(TimeoutError):
            ex.process([1])
        held.set()
        ex.close()


@pytest.mark.parametrize("attempts", [1, 2, 3, 4])
def test_retries_like_jax(attempts):
    """Each value fails twice before it succeeds: three attempts or more
    recover, fewer raise after exactly that many calls."""
    out = []
    for P in PKGS:
        calls = {}

        def flaky(x, calls=calls):
            calls[x] = calls.get(x, 0) + 1
            if calls[x] < 3:
                raise IOError("transient")
            return x

        strategy = P.aio.RetryStrategy(max_attempts=attempts, delay_ms=0.1, multiplier=2.0)
        ex = P.aio.AsyncExecutor(flaky, capacity=2, retry=strategy)
        result = []
        for x in (7, 8):       # one value a call: the calls counted are its own
            try:
                result.append(ex.process([x]))
            except IOError:
                result.append("raised")
        ex.close()
        out.append((result, dict(calls)))
    assert out[0] == out[1]
    if attempts >= 3:
        assert out[1] == ([[(0, 7)], [(0, 8)]], {7: 3, 8: 3})
    else:
        assert out[1] == (["raised", "raised"], {7: attempts, 8: attempts})


def test_the_retry_strategy_is_the_jax_packages():
    for kw in ({}, {"max_attempts": 4, "delay_ms": 5.0, "multiplier": 3.0}):
        j, t = JAX.aio.RetryStrategy(**kw), PORT.aio.RetryStrategy(**kw)
        assert [j.delay_for(a) for a in range(1, 5)] == [t.delay_for(a) for a in range(1, 5)]
    assert PORT.aio.NO_RETRY == PORT.aio.RetryStrategy()


def _lookup(r):
    time.sleep(0.0005 if r[0] % 2 else 0.0)
    return (r[0], r[2] * 3, r[3])


@pytest.mark.parametrize("ordered", [True, False])
def test_async_map_jobs_like_jax(ordered):
    recs = records(300)

    def build(P, e):
        return (stream(P, e, recs).async_map(_lookup, capacity=8, ordered=ordered)
                .filter(lambda r: r[1] % 2 == 0).collect())

    jax_rows, port_rows = twin(build, rows=lambda rs: rs if ordered else sorted(rs))
    assert port_rows == jax_rows and len(port_rows) > 100
    want = [(r[0], r[2] * 3, r[3]) for r in recs if (r[2] * 3) % 2 == 0]
    assert port_rows == (want if ordered else sorted(want))


def test_async_map_feeds_a_window_like_jax():
    recs = records(400)

    def build(P, e):
        return (stream(P, e, recs).async_map(_lookup, capacity=4)
                .key_by(lambda r: r[0]).window(P.asg.TumblingEventTimeWindows.of(2000))
                .sum(lambda r: r[1]).collect())

    jax_rows, port_rows = twin(build)
    assert [(k, float(v)) for k, v in jax_rows] == port_rows and port_rows
    kinds = []
    for P in PKGS:
        e = env(P)
        build(P, e)
        kinds.append(runner_kinds(P, e))
    assert kinds[0] == kinds[1] and "AsyncMapRunner" in kinds[1]


def test_the_async_runner_forwards_watermarks_and_counts_its_records():
    """The port's runner takes the job's metric registry like every runner
    (numRecordsIn, latencyMs) and forwards the watermark unchanged."""
    e = env(PORT)
    stream(PORT, e, records(50)).async_map(lambda r: r).collect()
    rt = PORT.ex.JobRuntime(PORT.tr.plan(e._sinks), e.config, "cpu")
    rt.run()
    runner = next(r for r in rt.runners if type(r).__name__ == "AsyncMapRunner")
    assert runner.records_in_counter.count == 50
    vals = np.empty(0, dtype=object)
    seen = []

    class Down:
        def __bool__(self):
            return True

        def on_batch(self, v, t):
            pass

        def on_watermark(self, wm):
            seen.append(wm)

    runner.downstream = Down()
    runner.on_batch(vals, np.empty(0, dtype=np.int64))
    runner.on_watermark_n(0, 1234)
    assert seen == [1234]
