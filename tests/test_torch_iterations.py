"""Stream iterations on the port held against the JAX package. Modelled on
tests/test_iterations.py: records fed back through `close_with` re-enter
the loop body, watermarks never cross the feedback edge, a bounded job
ends when the feedback stops, and `max_rounds` bounds a loop that does
not. Each job runs through both packages' `env.execute()` on the same
records; the pending feedback rides a capture and restores across the
packages.

Tolerance: exact, rows by `repr` in emission order.
"""

import numpy as np
import pytest

from api_twins import PKGS, env, records, runner_kinds, stream, twin


def _collatz(P, e):
    it = e.from_collection([7, 12, 27, 1, 6, 97, 871]).iterate()
    body = it.map(lambda x: x // 2 if x % 2 == 0 else 3 * x + 1)
    it.close_with(body.filter(lambda x: x != 1))
    return body.filter(lambda x: x == 1).collect()


def _decrement(P, e, recs, max_rounds=10_000):
    """(key, count, rounds): each record goes round until its count is 0."""
    it = stream(P, e, recs).map(lambda r: (r[0], r[2], 0)).iterate(max_rounds=max_rounds)
    body = it.map(lambda r: (r[0], r[1] - 1, r[2] + 1))
    it.close_with(body.filter(lambda r: r[1] > 0))
    return body.filter(lambda r: r[1] <= 0).collect()


def test_collatz_reaches_one_like_jax():
    jax_rows, port_rows = twin(_collatz)
    assert port_rows == jax_rows == [1] * 7


@pytest.mark.parametrize("batch", [16, 64, 1024])
def test_decrement_loop_counts_rounds_like_jax(batch):
    recs = records(500, seed=batch)
    jax_rows, port_rows = twin(lambda P, e: _decrement(P, e, recs),
                               **{"execution.step.batch-size": batch})
    assert repr(port_rows) == repr(jax_rows)
    assert sorted(port_rows) == sorted((r[0], min(r[2], 1) - 1, max(r[2], 1)) for r in recs)


def test_the_head_passes_initial_and_feedback_records_like_jax():
    def build(P, e):
        it = stream(P, e, records(100)).map(lambda r: r[2]).iterate()
        seen = it.collect()
        body = it.map(lambda x: x - 1)
        it.close_with(body.filter(lambda x: x > 0))
        return seen

    jax_rows, port_rows = twin(build)
    assert repr(port_rows) == repr(jax_rows) and len(port_rows) > 100


def test_max_rounds_bounds_a_loop_that_does_not_converge_in_both():
    recs = records(50)
    deepest = max(r[2] for r in recs)
    for P in PKGS:
        # the deepest record needs deepest - 1 feedback rounds
        e = env(P)
        _decrement(P, e, recs, max_rounds=deepest - 2)
        with pytest.raises(RuntimeError, match="max_rounds"):
            e.execute()
        e = env(P)
        _decrement(P, e, recs, max_rounds=deepest - 1)
        e.execute()


def _windowed(P, e, strategy):
    src = e.from_collection([(1, 500), (2, 1500), (3, 2500), (5, 3100), (2, 4200)],
                            timestamp_fn=lambda v: v[1],
                            watermark_strategy=strategy(P))
    it = src.iterate()
    body = it.map(lambda v: (v[0] - 1, v[1]))
    it.close_with(body.filter(lambda v: v[0] > 0))
    return (body.filter(lambda v: v[0] <= 0).key_by(lambda v: 0)
            .window(P.asg.TumblingEventTimeWindows.of(1000)).count().collect())


@pytest.mark.parametrize("strategy", ["none", "monotonous"])
def test_feedback_carries_no_watermarks_like_jax(strategy):
    """Without a watermark strategy every record is on time at the held
    final flush; with monotonous watermarks a record that re-enters after
    its window closed is late, as in the JAX package."""
    make = {"none": lambda P: None,
            "monotonous": lambda P: P.wm.for_monotonous_timestamps()}[strategy]
    jax_rows, port_rows = twin(lambda P, e: _windowed(P, e, make), **{
        "execution.step.batch-size": 2})
    assert repr(port_rows) == repr(jax_rows) and port_rows


def test_a_tail_closed_on_a_foreign_head_is_refused_in_both():
    for P in PKGS:
        e = env(P)
        a = e.from_collection([1]).iterate()
        b = e.from_collection([2])
        a.close_with(b.map(lambda x: x))
        b.collect()
        e._sinks = [e._sinks[-1]]
        with pytest.raises(ValueError, match="iteration tail"):
            e.execute()


def test_the_iteration_runners_are_the_jax_packages():
    kinds = []
    for P in PKGS:
        e = env(P)
        _decrement(P, e, records(10))
        kinds.append(runner_kinds(P, e))
    assert kinds[0] == kinds[1]
    assert {"IterationHeadRunner", "IterationTailRunner"} <= set(kinds[1])


def test_pending_feedback_restores_across_the_packages():
    """The head's queued feedback is its state: a capture with feedback in
    flight restored into either package's runtime re-injects it."""
    captures = {}
    for P in PKGS:
        e = env(P)
        _decrement(P, e, records(10))
        extra = ("cpu",) if P.port else ()
        rt = P.ex.JobRuntime(P.tr.plan(e._sinks + e._roots), e.config, *extra)
        head = rt.iteration_heads[0]
        vals = np.empty(2, dtype=object)
        vals[:] = [(3, 4, 0), (5, 2, 1)]
        head.enqueue_feedback(vals, np.array([100, 200]))
        captures[P.port] = rt.capture()
    for src in PKGS:
        for dst in PKGS:
            e = env(dst)
            sink = _decrement(dst, e, records(10))
            extra = ("cpu",) if dst.port else ()
            rt = dst.ex.JobRuntime(dst.tr.plan(e._sinks + e._roots), e.config, *extra)
            rt.restore(captures[src.port])
            head = rt.iteration_heads[0]
            assert head.has_feedback()
            assert [list(v) for v, _t in head._feedback] == [[(3, 4, 0), (5, 2, 1)]]
            head.drain_round()
            rt._drain_iterations()
            assert sorted(sink.results) == [(3, 0, 4), (5, 0, 3)]
