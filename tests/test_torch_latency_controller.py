"""The port's latency controller held against the JAX package's.

`flink_tpu_torch/scheduler/latency_controller.py` is a copy of
`flink_tpu/scheduler/latency_controller.py`. The cases of
`tests/test_latency_controller.py`'s ladder and controller tests run on
both, on the same sample sequences and the same injected clock: every
decision (`steps()`, `step_rate()`, `current_steps()`) along the way must
be equal, and equal to the value the JAX test expects.

Tolerance: exact (decisions are ints; rates are compared with `==`, the
same float arithmetic on the same inputs).
"""

import pytest

from flink_tpu.scheduler import latency_controller as jlc
from flink_tpu_torch.scheduler import latency_controller as tlc

MODULES = (jlc, tlc)


@pytest.mark.parametrize("floor,full", [(2, 48), (2, 32), (3, 32), (2, 2), (5, 4), (1, 1),
                                        (2, 7), (2, 64), (4, 100)])
def test_rung_ladder_matches_jax(floor, full):
    ladder = tlc.build_rung_ladder(floor, full)
    assert ladder == jlc.build_rung_ladder(floor, full)
    assert ladder[-1] == full
    assert all(a < b for a, b in zip(ladder, ladder[1:]))
    assert all(r == full or (r & (r - 1)) == 0 for r in ladder)


def test_latency_spec_defaults_match_jax():
    assert tlc.LatencySpec(50) == tlc.LatencySpec(
        **{f: getattr(jlc.LatencySpec(50), f) for f in ("target_ms", "max_inflight",
                                                        "floor_steps", "readback_steps",
                                                        "min_dwell_ms", "hysteresis_pct")})


def _ctrl(mod, **kw):
    t = [0.0]
    defaults = dict(full_steps=32, target_ms=100, floor_steps=2,
                    min_dwell_ms=500, hysteresis_pct=25, clock=lambda: t[0])
    defaults.update(kw)
    return mod.SuperbatchController(**defaults), t


def _feed(c, t, n, *, per_obs, dt):
    for _ in range(n):
        c.observe(per_obs, now=t[0])
        t[0] += dt


def _trace(mod, script, **kw):
    """Run `script(c, t, log)` on module `mod`'s controller; log records
    (label, value) pairs."""
    c, t = _ctrl(mod, **kw)
    out = []
    script(c, t, lambda label, v: out.append((label, v)))
    return out


def _warm_up(c, t, log):
    log("cold", c.steps())
    _feed(c, t, 2, per_obs=1, dt=0.1)
    log("rate", c.step_rate())
    log("held", c.steps())


def _adapts_down(c, t, log):
    _feed(c, t, 6, per_obs=10, dt=0.1)
    log("rate", round(c.step_rate(), 6))
    log("rung", c.steps())


def _hysteresis(c, t, log):
    _feed(c, t, 6, per_obs=10, dt=0.1)
    log("rung", c.steps())
    t[0] += 1.0
    for budget in (7, 9) * 10:
        _feed(c, t, 8, per_obs=budget, dt=0.1)
        log(f"budget {budget}", c.steps())


def _min_dwell(c, t, log):
    _feed(c, t, 6, per_obs=10, dt=0.1)
    log("first", c.steps())
    _feed(c, t, 2, per_obs=4, dt=0.1)
    log("in dwell", c.steps())
    _feed(c, t, 4, per_obs=4, dt=0.1)
    log("past dwell", c.steps())


def _spike(c, t, log):
    _feed(c, t, 6, per_obs=10, dt=0.1)
    log("rung", c.steps())
    _feed(c, t, 3, per_obs=100, dt=0.01)
    log("spike", c.steps())


def _reset(c, t, log):
    _feed(c, t, 6, per_obs=10, dt=0.1)
    log("rung", c.steps())
    c.reset()
    log("rate", c.step_rate())
    log("gauge", c.current_steps())
    log("held", c.steps())


def _gauge_read(c, t, log):
    _feed(c, t, 6, per_obs=10, dt=0.1)
    log("gauge before", c.current_steps())
    log("decide", c.steps())
    log("gauge after", c.current_steps())


# (script, controller kwargs, the JAX test's expected trace)
CASES = {
    "warm_up_holds_the_full_span": (_warm_up, {}, [("cold", 32), ("rate", None),
                                                   ("held", 32)]),
    "adapts_down_at_light_load": (_adapts_down, {}, [("rate", 100.0), ("rung", 8)]),
    "hysteresis_never_flaps": (_hysteresis, {}, [("rung", 8)] + [
        (f"budget {b}", 8) for b in (7, 9) * 10]),
    "min_dwell_gates_consecutive_moves": (_min_dwell, {"window": 3}, [
        ("first", 8), ("in dwell", 8), ("past dwell", 4)]),
    "rate_spike_escalates_bypassing_dwell": (_spike, {}, [("rung", 8), ("spike", 32)]),
    "reset_reholds_full_span": (_reset, {}, [("rung", 8), ("rate", None), ("gauge", 32),
                                             ("held", 32)]),
    "gauge_read_never_advances_policy": (_gauge_read, {}, [
        ("gauge before", 32), ("decide", 8), ("gauge after", 8)]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_controller_decisions_match_jax(case):
    script, kw, expected = CASES[case]
    traces = [_trace(mod, script, **kw) for mod in MODULES]
    assert traces[1] == traces[0] == expected


@pytest.mark.parametrize("seed", range(4))
def test_controller_matches_jax_on_random_arrivals(seed):
    """Random arrival bursts and gaps at a 40 ms target over a 64-step
    span: both controllers walk the same rungs."""
    import numpy as np

    rng = np.random.default_rng(seed)
    per_obs = rng.integers(1, 40, 200)
    dts = rng.choice([0.001, 0.01, 0.05, 0.2], 200)

    def script(c, t, log):
        for n, dt in zip(per_obs, dts):
            c.observe(int(n), now=t[0])
            t[0] += float(dt)
            log("rung", c.steps())

    traces = [_trace(mod, script, full_steps=64, target_ms=40, window=5) for mod in MODULES]
    assert traces[0] == traces[1]
    assert len({v for _l, v in traces[1]}) > 1
