"""CEP on the port held against the JAX package. Modelled on
tests/test_cep.py: the NFA over the pattern API's quantifiers and
contiguities, fed the same random event sequences in both packages; the
keyed CepOperator (event-time ordering, key isolation, snapshots restored
across the packages); and `cep.pattern_stream` jobs through both
packages' `env.execute()`, their runners the JAX package's.

Tolerance: exact; matches compare by `repr`, in order.
"""

import numpy as np
import pytest

from api_twins import PKGS, env, records, runner_kinds, stream, twin

# pattern builders over (kind, value) events: kind "a"/"b"/"c"
PATTERNS = {
    "strict_next": lambda C: C.Pattern.begin("x").where(lambda e: e[0] == "a")
    .next("y").where(lambda e: e[0] == "b"),
    "followed_by": lambda C: C.Pattern.begin("x").where(lambda e: e[0] == "a")
    .followed_by("y").where(lambda e: e[0] == "b"),
    "three_stages": lambda C: C.Pattern.begin("x").where(lambda e: e[0] == "a")
    .followed_by("y").where(lambda e: e[0] == "c").next("z").where(lambda e: e[0] == "b"),
    "times": lambda C: C.Pattern.begin("x").where(lambda e: e[0] == "a").times(2)
    .followed_by("y").where(lambda e: e[0] == "b"),
    "one_or_more": lambda C: C.Pattern.begin("x").where(lambda e: e[0] == "a").one_or_more()
    .next("y").where(lambda e: e[0] == "c"),
    "optional": lambda C: C.Pattern.begin("x").where(lambda e: e[0] == "a")
    .followed_by("y").where(lambda e: e[0] == "c").optional()
    .followed_by("z").where(lambda e: e[0] == "b"),
    "within": lambda C: C.Pattern.begin("x").where(lambda e: e[0] == "a")
    .followed_by("y").where(lambda e: e[1] > 5).within(30),
}


def _events(seed, n=40):
    rng = np.random.default_rng(seed)
    kinds = rng.choice(["a", "b", "c"], n, p=[0.4, 0.35, 0.25])
    return [((str(k), int(v)), 10 * i + int(d)) for i, (k, v, d) in enumerate(
        zip(kinds, rng.integers(0, 10, n), rng.integers(0, 10, n)))]


def _nfa_matches(C, pattern, events):
    from importlib import import_module

    nfa = import_module(C.__name__ + ".nfa").NFA(pattern)
    runs, matches = [], []
    for value, ts in events:
        runs, m = nfa.advance(runs, value, ts)
        matches.extend(m)
    return matches, sorted(repr(r) for r in runs)


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("name", sorted(PATTERNS))
def test_the_nfa_matches_like_jax(name, seed):
    out = [_nfa_matches(P.cep, PATTERNS[name](P.cep), _events(seed)) for P in PKGS]
    assert repr(out[0]) == repr(out[1])
    if name in ("followed_by", "strict_next"):
        assert out[1][0]


def test_the_operator_orders_by_event_time_and_isolates_keys_like_jax():
    out = []
    for P in PKGS:
        op = P.cep.CepOperator(PATTERNS["strict_next"](P.cep), select_fn=lambda m: m)
        for key, (value, ts) in [("k1", (("b", 1), 20)), ("k1", (("a", 2), 10)),
                                 ("k2", (("b", 3), 5)), ("k1", (("b", 4), 30)),
                                 ("k2", (("a", 5), 1)), ("k3", (("a", 6), 50))]:
            op.process_record(key, value, ts)
        op.process_watermark(40)
        op.process_record("k1", ("a", 7), 35)          # at or below the watermark: late
        op.process_record("k3", ("b", 8), 60)
        op.process_watermark(100)
        out.append((op.drain_output(), op.num_late_records_dropped))
    assert repr(out[0]) == repr(out[1]) and len(out[1][0]) == 3


@pytest.mark.parametrize("name", ["followed_by", "one_or_more", "within"])
def test_operator_snapshots_restore_across_the_packages(name):
    events = [(f"k{i % 3}", v, ts) for i, (v, ts) in enumerate(_events(7, n=60))]

    def run(P, first, second, snap_from=None):
        op = P.cep.CepOperator(PATTERNS[name](P.cep))
        if snap_from is not None:
            op.restore(snap_from)
        for chunk in (first, second):
            for key, value, ts in chunk:
                op.process_record(key, value, ts)
            op.process_watermark(max(ts for _k, _v, ts in chunk) - 15)
        return op

    half = len(events) // 2
    whole = [repr(run(P, events[:half], events[half:]).drain_output()) for P in PKGS]
    assert whole[0] == whole[1]
    for src in PKGS:
        a = src.cep.CepOperator(PATTERNS[name](src.cep))
        for key, value, ts in events[:half]:
            a.process_record(key, value, ts)
        a.process_watermark(max(ts for _k, _v, ts in events[:half]) - 15)
        first = a.drain_output()
        snap = a.snapshot()
        for dst in PKGS:
            b = dst.cep.CepOperator(PATTERNS[name](dst.cep))
            b.restore(snap)
            for key, value, ts in events[half:]:
                b.process_record(key, value, ts)
            b.process_watermark(max(ts for _k, _v, ts in events[half:]) - 15)
            assert repr(first + b.drain_output()) == whole[0]


def _job(P, e, recs):
    pattern = (P.cep.Pattern.begin("imp").where(lambda r: r[1] == 0)
               .next("click").where(lambda r: r[1] == 1).within(3_000))
    keyed = stream(P, e, recs).key_by(lambda r: r[0])
    return P.cep.pattern_stream(keyed, pattern, select_fn=lambda m: (
        m["imp"][0][0], m["imp"][0][3], m["click"][0][3]))


@pytest.mark.parametrize("batch", [8, 64])
def test_pattern_stream_jobs_like_jax(batch):
    recs = records(800, keys=5)
    jax_rows, port_rows = twin(lambda P, e: _job(P, e, recs).collect(),
                               **{"execution.step.batch-size": batch})
    assert repr(port_rows) == repr(jax_rows) and len(port_rows) > 20
    kinds = []
    for P in PKGS:
        e = env(P)
        _job(P, e, recs).collect()
        kinds.append(runner_kinds(P, e))
    assert kinds[0] == kinds[1] and "CepRunner" in kinds[1]


def test_the_cep_runner_snapshot_restores_across_the_packages():
    from api_twins import assert_restores_like_jax, batches, restored_across

    recs = records(400, keys=4)
    out = restored_across(lambda P, e: _job(P, e, recs).collect(), batches(recs, size=40),
                          10, "CepRunner")
    assert_restores_like_jax(out, min_rows=10)
