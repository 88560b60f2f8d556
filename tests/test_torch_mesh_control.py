"""The mesh's control loops on the port, held against the JAX package's.

Twins of tests/test_skew_routing.py (the rebalancer's policy, the
routing table's surface on the runtime and the MiniCluster rebalance),
tests/test_autoscaler.py (signals, policies and the coordinator) and
tests/test_multichip_runtime.py's autoscaler drill, plus the device-loss
degrade of a mesh job:

- `SkewRebalancer` decisions, returned assignments and `payload()` over
  the JAX tests' load sequences and seeded random ones, on an injected
  clock, both packages fed the same inputs;
- every case of tests/test_autoscaler.py's signals, policies and
  coordinator sections run through both packages on injected clocks and
  executors: estimates, decisions, decision logs (their wall-clock
  `timestamp_ms` aside) and learning histories equal;
- a skewed mesh job under the rebalancer on four CPU shards against the
  JAX package's on four of its eight CPU devices: rows, `meshRebalances`,
  `routingTableVersion`, the recovery kinds and every decision equal;
- the autoscaler's mesh executor on a running job (rejects a same-size
  target, rescales 8 -> 4), rows equal to the one-device job's and the
  JAX mesh job's;
- the device-loss degrade: a device-scoped failure injected at the sixth
  sharded dispatch restarts the job over 2 of its 4 shards, once, with the
  uninterrupted rows; without the option the restart keeps 4;
- `JobRuntime.set_mesh_routing` skipping an assignment of another group
  count.

Jobs are held on threading.Events inside the source's generator, never
on sleeps. Tolerance: exact.
"""

import threading
import types

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

import flink_tpu.config as jcfg  # noqa: E402
import flink_tpu.scheduler as jsched  # noqa: E402
import flink_tpu.scheduler.signals as jsig  # noqa: E402
import flink_tpu_torch.config as tcfg  # noqa: E402
import flink_tpu_torch.scheduler as tsched  # noqa: E402
import flink_tpu_torch.scheduler.signals as tsig  # noqa: E402
import test_torch_multichip_runtime as mcr  # noqa: E402
from flink_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402

PKGS = {"jax": types.SimpleNamespace(s=jsched, sig=jsig, cfg=jcfg),
        "port": types.SimpleNamespace(s=tsched, sig=tsig, cfg=tcfg)}
IDENT = (np.arange(128, dtype=np.int64) * 8) // 128


@pytest.fixture
def shards(monkeypatch):
    """`n` virtual shards: visible_devices gives the CPU n times."""
    def use(n):
        monkeypatch.setattr(mesh_lib, "visible_devices", lambda device: [torch.device("cpu")] * n)
    use(8)
    return use


def _twin(case):
    """(JAX trace, port trace) of one scenario."""
    return case(PKGS["jax"]), case(PKGS["port"])


def _arr(a):
    return None if a is None else np.asarray(a).tolist()


# ---------------------------------------------------------------------------
# the rebalancer's policy
# ---------------------------------------------------------------------------

def _rebalancer(m, **kw):
    clock = {"t": 0.0}
    reb = m.s.SkewRebalancer(clock=lambda: clock["t"], **kw)
    return reb, clock


def _hot(groups, level=100.0, base=1.0):
    loads = np.full(128, base)
    loads[groups] = level
    return loads


def _reb_hold(m):
    reb, _ = _rebalancer(m, skew_threshold=1.5, interval_ms=0, min_samples=1)
    return [_arr(reb.maybe_decide(np.ones(128), IDENT, 8))], reb


def _reb_fire_then_settle(m):
    reb, _ = _rebalancer(m, skew_threshold=1.25, interval_ms=0, min_samples=1)
    loads = _hot(slice(0, 16))
    assign = reb.maybe_decide(loads, IDENT, 8)
    reb.rebalance_completed()
    return [_arr(assign), _arr(reb.maybe_decide(loads, assign, 8))], reb


def _reb_unsplittable(m):
    reb, _ = _rebalancer(m, skew_threshold=1.25, interval_ms=0, min_samples=1)
    return [_arr(reb.maybe_decide(_hot([0], 1000.0, 0.0), IDENT, 8))], reb


def _reb_throttle(m):
    reb, clock = _rebalancer(m, skew_threshold=1.25, interval_ms=1000, min_samples=1)
    loads = _hot(slice(0, 16))
    out = [reb.due(), _arr(reb.maybe_decide(loads, IDENT, 8)), reb.due(),
           _arr(reb.maybe_decide(loads, IDENT, 8))]
    clock["t"] += 1.5
    out += [reb.due(), _arr(reb.maybe_decide(loads, IDENT, 8))]
    return out, reb


def _reb_spike(m):
    reb, _ = _rebalancer(m, skew_threshold=1.25, interval_ms=0, window=8, min_samples=4)
    out = [_arr(reb.maybe_decide(_hot([60], 60.0), IDENT, 8)), len(reb.decisions)]
    for g in (77, 90, 105):
        out.append(_arr(reb.maybe_decide(_hot([g], 60.0), IDENT, 8)))
    decision = None
    for _ in range(4):
        decision = reb.maybe_decide(_hot(slice(0, 16), 60.0), IDENT, 8)
        out.append(_arr(decision))
    reb.rebalance_completed()
    out += [_arr(reb.maybe_decide(_hot(slice(0, 16), 60.0), decision, 8)), len(reb._window)]
    return out, reb


def _reb_seeded(m):
    """40 polls of seeded loads (a drifting hot set, a group count change
    midway, gaps in the clock) under a 250 ms interval."""
    rng = np.random.default_rng(17)
    reb, clock = _rebalancer(m, skew_threshold=1.3, interval_ms=250, window=4, min_samples=2)
    assign, out = IDENT.copy(), []
    for i in range(40):
        g = 128 if i < 25 else 64
        if g == 64 and assign.shape[0] != 64:
            assign = (np.arange(64, dtype=np.int64) * 8) // 64
        loads = rng.integers(0, 20, g).astype(np.float64)
        loads[rng.integers(0, g // 4, 6)] += rng.integers(50, 400)
        clock["t"] += float(rng.choice([0.1, 0.2, 0.3, 0.6]))
        new = reb.maybe_decide(loads, assign, 8)
        out.append(_arr(new))
        if new is not None:
            assign = np.asarray(new, np.int64)
            reb.rebalance_completed()
    return out, reb


REBALANCER_CASES = {"hold": _reb_hold, "fire_then_settle": _reb_fire_then_settle,
                    "unsplittable": _reb_unsplittable, "throttle": _reb_throttle,
                    "spike": _reb_spike, "seeded": _reb_seeded}


@pytest.mark.parametrize("case", sorted(REBALANCER_CASES))
def test_rebalancer_decisions_and_payload_equal_the_jax_packages(case):
    (jout, jreb), (tout, treb) = _twin(REBALANCER_CASES[case])
    assert tout == jout
    assert [d.as_dict() for d in treb.decisions] == [d.as_dict() for d in jreb.decisions]
    assert treb.payload() == jreb.payload()
    # the JAX tests' own checks, on the port
    if case == "hold":
        assert tout == [None] and treb.decisions[-1].action == "hold"
    elif case == "fire_then_settle":
        assert tout[0] is not None and tout[1] is None and treb.num_rebalances == 1
    elif case == "unsplittable":
        assert tout == [None] and "does not improve" in treb.decisions[-1].reason
    elif case == "throttle":
        assert tout[0] and tout[1] is not None and not tout[2] and tout[3] is None
        assert tout[4] and tout[5] is not None
    elif case == "spike":
        assert tout[0] is None and tout[1] == 0 and tout[4] is None
        assert tout[-3] is not None and tout[-2] is None and tout[-1] == 1
    else:
        assert any(a is not None for a in tout) and treb.payload()["numRebalances"] > 0


# ---------------------------------------------------------------------------
# signals, policies, the coordinator
# ---------------------------------------------------------------------------

def _sample(m, t, busy=0.5, bp=0.0, records=0.0):
    return m.sig.SignalSample(timestamp=t, busy=busy, backpressured=bp, records_in=records)


def _estimate(m, util, samples=5, tput=1000.0):
    win = m.s.SignalWindow(size=samples)
    for i in range(samples):
        win.observe(_sample(m, float(i), busy=util, records=tput * i))
    return win.estimate()


def _decision(d):
    return None if d is None else (d.action, d.target, d.reason)


def _busy(ratio, records):
    return {"job.busyTimeMsPerSecond": ratio * 1000.0, "job.numRecordsIn": records}


def _payload(coord, job="j1", **kw):
    p = coord.payload(job, **kw)
    for d in p["decisions"]:
        d.pop("timestamp_ms")        # the wall clock, in both packages
    return p


def _coordinator(m, executor=None, policy=None, **kw):
    clock = [0.0]
    kw.setdefault("stabilization_interval_ms", 0)
    if policy is None:
        policy = m.s.ThresholdPolicy(scale_up_threshold=0.8, scale_down_threshold=0.2,
                                     min_samples=1)
    return m.s.AutoscalerCoordinator(policy, rescale_executor=executor,
                                     clock=lambda: clock[0], **kw), clock


def _sig_window(m):
    win, out = m.s.SignalWindow(size=4), []
    for i in range(4):
        out.append(win.observe(_sample(m, float(i), busy=0.2 * (i + 1),
                                       records=1000.0 * i)).as_dict())
    out.append(win.observe(_sample(m, 4.0, busy=1.0, records=4000.0)).as_dict())
    return out


def _sig_reset(m):
    win = m.s.SignalWindow(size=4)
    for i in range(3):
        win.observe(_sample(m, float(i), records=5000.0 + 1000 * i))
    return win.observe(_sample(m, 3.0, records=100.0)).as_dict()


def _sig_extract(m):
    snaps = [{"job.busyTimeMsPerSecond": 700.0, "job.busyTimeRatio": 0.1,
              "job.backPressuredTimeMsPerSecond": 100.0, "job.numRecordsIn": 42.0,
              "job.exchange.inPoolUsage.0": 0.5, "job.exchange.inPoolUsage.1": 1.0,
              "job.watermarkSkewMs": 123.0},
             {"job.busyTimeRatio": 0.33},
             {"job.busyTimeMsPerSecond": 0.0, "job.busyTimeRatio": 0.9},
             {"job.busyTimeMsPerSecond": 500.0},
             {"job.keySkew": 3.0, "job.device.hbmUtilizationPct": 40.0,
              "job.device.flopsUtilizationPct": 10.0, "job.lastCheckpointDuration": 12.0}]
    out = [repr(m.s.extract_signals(s, now=0.0)) for s in snaps]
    win = m.s.SignalWindow(size=4)
    for t, s in enumerate(({"job.keySkew": 3.0, "job.device.hbmUtilizationPct": 40.0},
                           {"job.busyTimeMsPerSecond": 100.0}, {"job.keySkew": 5.0},
                           {"job.keySkew": 0.0})):
        out.append(win.observe(m.s.extract_signals(s, now=float(t))).as_dict())
    return out


def _policy_threshold(m):
    p = m.s.ThresholdPolicy(scale_up_threshold=0.8, scale_down_threshold=0.3)
    out = [_decision(p.decide(_estimate(m, u, samples=s), par, 1, mx))
           for u, s, par, mx in ((0.9, 5, 2, 8), (0.1, 5, 4, 8), (0.5, 5, 2, 8), (0.9, 5, 8, 8),
                                 (0.1, 5, 1, 8), (0.9, 5, 2, 3), (0.9, 1, 2, 8))]
    pol = m.s.ThresholdPolicy(scale_down_threshold=0.3, min_samples=1)
    win = m.s.SignalWindow(size=4)
    for i, u in enumerate([0.9, 0.0, 0.0, 0.0]):
        est = win.observe(_sample(m, float(i), busy=u, records=100.0 * i))
    out.append(_decision(pol.decide(est, 4, 1, 8)))
    return out


def _policy_learning(m):
    p = m.s.LearningPolicy(m.s.ThresholdPolicy(scale_up_threshold=0.8), patience=3,
                           min_gain=1.1)
    hot = _estimate(m, 0.95)
    out = [_decision(p.decide(hot, 2, 1, 8))]
    p.record_outcome("scale-up", 2, 4, 1000.0, 1005.0)
    out += [_decision(p.decide(hot, 2, 1, 8)) for _ in range(4)]
    p.record_outcome("scale-up", 2, 4, 1000.0, 1800.0)
    out.append(_decision(p.decide(hot, 2, 1, 8)))
    p.record_outcome("scale-up", 2, 4, 1000.0, 1001.0)
    out.append(_decision(p.decide(hot, 4, 1, 16)))
    d = m.s.LearningPolicy(m.s.ThresholdPolicy(scale_down_threshold=0.3), patience=2,
                           min_gain=1.25)
    cold = _estimate(m, 0.05)
    out.append(_decision(d.decide(cold, 4, 1, 8)))
    d.record_outcome("scale-down", 4, 2, 1000.0, 500.0)
    out.append(_decision(d.decide(cold, 4, 1, 8)))
    out.append([(o.action, o.from_parallelism, o.gain) for o in p.history])
    out.append([m.s.build_policy(n).name for n in ("threshold", "learning")])
    with pytest.raises(ValueError):
        m.s.build_policy("oracle")
    return out


def _coord_executes(m):
    calls = []
    coord, clock = _coordinator(m, lambda j, t, r: (calls.append((j, t)) or True, "ok"),
                                stabilization_interval_ms=1500)
    out = []
    for i in range(3):
        clock[0] = float(i)
        out.append(_decision(coord.observe("j1", 2, _busy(0.95, 1000.0 * i), max_slots=8)))
    return out, calls, _payload(coord, num_rescales=len(calls))


def _coord_stabilization(m):
    calls = []
    coord, clock = _coordinator(m, lambda j, t, r: (calls.append(t) or True, "ok"),
                                stabilization_interval_ms=10_000)
    out = []
    for i in range(5):
        clock[0] = float(i)
        out.append(_decision(coord.observe("j1", 2, _busy(0.95, 100.0 * i))))
    clock[0] = 11.0
    out.append(_decision(coord.observe("j1", 2, _busy(0.95, 600.0))))
    clock[0] = 12.0
    out.append(_decision(coord.observe("j1", 4, _busy(0.95, 50.0))))
    coord.rescale_completed("j1", 250.0)
    return out, calls, _payload(coord)


def _coord_rejected_and_coalesced(m):
    coord, clock = _coordinator(m, lambda j, t, r: (False, "no checkpoint"),
                                decision_log_size=4)
    out = []
    for i in range(5):
        clock[0] = float(i)
        out.append(_decision(coord.observe("j1", 1, _busy(0.95, 10.0 * i), max_slots=4)))
    return out, _payload(coord)


def _coord_bounded_log(m):
    coord, clock = _coordinator(m, None, decision_log_size=2, signal_window=1)
    for i in range(6):
        clock[0] = float(i)
        coord.observe("j1", 2, _busy(0.95 if i % 2 else 0.05, 10.0 * i), max_slots=8)
    return _payload(coord)


def _learning_coord(m):
    policy = m.s.LearningPolicy(m.s.ThresholdPolicy(scale_up_threshold=0.8, min_samples=1),
                                min_gain=1.2, patience=10)
    return _coordinator(m, lambda j, t, r: (True, "ok"), policy=policy,
                        stabilization_interval_ms=1000) + (policy,)


def _coord_outcome_cases(m):
    out = {}
    # a failover lands at p=1 (not the rescale's target), then a deploy
    # that never lands (p stays 1), then an outcome that feeds the policy
    for name, start, after in (("foreign", 2, 1), ("never_lands", 1, 1), ("feeds", 2, 4)):
        coord, clock, policy = _learning_coord(m)
        coord.observe("j1", start, _busy(0.95, 0.0), max_slots=8)
        clock[0] = 2.0
        d = _decision(coord.observe("j1", start, _busy(0.95, 200.0), max_slots=8))
        if name != "never_lands":
            coord.rescale_completed("j1", 50.0)
        for i in range(4):
            clock[0] = 4.0 + i
            coord.observe("j1", after, _busy(0.95 if name == "never_lands" else 0.5,
                                             100.0 * i), max_slots=8)
        clock[0] = 20.0
        out[name] = (d, [(o.action, o.from_parallelism, o.gain) for o in policy.history],
                     _payload(coord), _decision(policy.decide(_estimate(m, 0.95), 2, 1, 8)))
    return out


def _coord_throttle(m):
    seen = []
    coord, clock = _coordinator(m, None, interval_ms=1000)
    for t in (0.0, 0.1, 0.5, 1.1, 1.2, 2.2):
        clock[0] = t
        coord.maybe_observe("j1", 1, lambda: seen.append(t) or _busy(0.5, 0.0))
    return seen


def _coord_from_config(m):
    A = m.cfg.AutoscalerOptions
    cfg = (m.cfg.Configuration().set(A.POLICY, "learning").set(A.MIN_PARALLELISM, 2)
           .set(A.MAX_PARALLELISM, 6).set(A.STABILIZATION_INTERVAL_MS, 5000))
    coord = m.s.AutoscalerCoordinator.from_config(cfg)
    out = [type(coord.policy).__name__, coord.min_parallelism, coord.max_parallelism,
           coord.stabilization_s, _payload(coord, "nope")]
    small = (m.cfg.Configuration().set(A.SIGNAL_WINDOW, 2).set(A.STABILIZATION_INTERVAL_MS, 0)
             .set(A.SCALE_UP_THRESHOLD, 0.8))
    calls, clock = [], [0.0]
    coord = m.s.AutoscalerCoordinator.from_config(
        small, rescale_executor=lambda j, t, r: (calls.append(t) or True, "ok"),
        clock=lambda: clock[0])
    for i in range(2):
        clock[0] = float(i)
        coord.observe("j1", 1, _busy(0.95, 100.0 * i), max_slots=4)
    for i in range(4):
        clock[0] = 3.0 + i
        coord.observe("j1", 2, _busy(0.5, 100.0 * i))
    return out + [calls, _payload(coord), m.s.empty_autoscaler_payload()]


AUTOSCALER_CASES = {"signal_window": _sig_window, "signal_reset": _sig_reset,
                    "extract_signals": _sig_extract, "threshold_policy": _policy_threshold,
                    "learning_policy": _policy_learning, "coord_executes": _coord_executes,
                    "coord_stabilization": _coord_stabilization,
                    "coord_rejected_coalesced": _coord_rejected_and_coalesced,
                    "coord_bounded_log": _coord_bounded_log,
                    "coord_outcomes": _coord_outcome_cases, "coord_throttle": _coord_throttle,
                    "from_config": _coord_from_config}


@pytest.mark.parametrize("case", sorted(AUTOSCALER_CASES))
def test_autoscaler_traces_equal_the_jax_packages(case):
    jout, tout = _twin(AUTOSCALER_CASES[case])
    assert tout == jout
    # the JAX tests' own checks, on the port
    if case == "signal_window":
        assert tout[3]["throughput_per_s"] == pytest.approx(1000.0) and tout[4]["samples"] == 4
    elif case == "signal_reset":
        assert tout["samples"] == 1 and tout["throughput_per_s"] == 0.0
    elif case == "extract_signals":
        assert tout[-2]["key_skew"] == pytest.approx(4.0)
        assert tout[-1]["key_skew"] == pytest.approx(8.0 / 3.0)
    elif case == "threshold_policy":
        assert tout[0][:2] == ("scale-up", 4) and tout[1][:2] == ("scale-down", 2)
        assert tout[5][1] == 3 and "peak" in tout[-1][2]
    elif case == "learning_policy":
        assert all(d[0] == "none" and "damped" in d[2] for d in tout[1:4])
        assert tout[4][0] == "scale-up" and "retry" in tout[4][2]
        assert tout[7][0] == "scale-down" and tout[8][0] == "none"
    elif case == "coord_executes":
        _out, calls, payload = tout
        assert calls == [("j1", 4)] and payload["decisions"][0]["outcome"] == "executed"
    elif case == "coord_stabilization":
        out, calls, payload = tout
        assert calls == [4] and payload["decisions"][0]["duration_ms"] == 250.0
    elif case == "coord_rejected_coalesced":
        decisions = tout[1]["decisions"]
        assert len(decisions) == 1 and decisions[0]["repeats"] == 5
        assert decisions[0]["outcome"] == "rejected: no checkpoint"
    elif case == "coord_bounded_log":
        assert len(tout["decisions"]) == 2
    elif case == "coord_outcomes":
        assert tout["foreign"][1] == [] and tout["never_lands"][1] == []
        assert tout["feeds"][1][0][2] == pytest.approx(1.0)
        assert tout["feeds"][3][0] == "none" and "damped" in tout["feeds"][3][2]
    elif case == "coord_throttle":
        assert tout == [0.0, 1.1, 2.2]
    else:
        assert tout[:4] == ["LearningPolicy", 2, 6, 5.0] and tout[5] == [2]


# ---------------------------------------------------------------------------
# the MiniCluster: rebalance, autoscale, degrade
# ---------------------------------------------------------------------------

N_SKEW_KEYS = 256


def _skewed_keys(idx):
    # 70% of the mass on 32 hot keys clustered in the first shard's range
    u = ((idx * 2654435761) % 1000) / 1000.0
    return np.where(u < 0.7, (idx % 32) * 8, (idx * 40503) % N_SKEW_KEYS).astype(np.int64)


def _skewed_job(pkg, *, rebalance, mesh=True, rescale_at=None):
    """tests/test_skew_routing.py's skewed job (host-keyed, tumbling count),
    on four shards of either package; `rescale_at` (a record index): the
    source asks for a live rescale to 2 shards when it first reaches it."""
    import flink_tpu.api.datastream as jds
    import flink_tpu.api.windowing.assigners as jasg
    import flink_tpu.connectors.sink as jsink
    import flink_tpu.connectors.source as jsrc
    import flink_tpu.core.watermarks as jwm
    import flink_tpu_torch.api.datastream as tds
    import flink_tpu_torch.api.windowing.assigners as tasg
    import flink_tpu_torch.connectors.sink as tsink
    import flink_tpu_torch.connectors.source as tsrc
    import flink_tpu_torch.core.watermarks as twm

    ds_mod, asg, sink_mod, src, wm, cfg_mod = (
        (jds, jasg, jsink, jsrc, jwm, jcfg) if pkg == "jax"
        else (tds, tasg, tsink, tsrc, twm, tcfg))
    E, P = cfg_mod.ExecutionOptions, cfg_mod.ParallelOptions
    cfg = cfg_mod.Configuration()
    for opt, val in ((E.BATCH_SIZE, 512), (E.KEY_CAPACITY, N_SKEW_KEYS),
                     (E.SUPERBATCH_STEPS, 4), (P.MESH_ENABLED, mesh), (P.MESH_DEVICES, 4),
                     (P.MESH_LOCAL_COMBINE, mesh), (P.MESH_SKEW_REBALANCE, rebalance),
                     (P.MESH_REBALANCE_SKEW_THRESHOLD, 1.2),
                     (P.MESH_REBALANCE_INTERVAL_MS, 0)):
        cfg.set(opt, val)
    env = ds_mod.StreamExecutionEnvironment(cfg, **({} if pkg == "jax" else {"device": "cpu"}))
    held, ready = {}, threading.Event()

    def gen(idx):
        if rescale_at is not None and not held.get("asked") and idx[0] >= rescale_at:
            # the job's own thread pulls the batch: the request lands at the
            # next step boundary of either package
            held["asked"] = True
            assert ready.wait(60)
            held["client"].rescale_mesh(2)
        return src.Batch(_skewed_keys(idx), (idx * 2).astype(np.int64))

    ds = env.from_source(
        src.DataGeneratorSource(gen, 16 * 512),
        watermark_strategy=wm.WatermarkStrategy.for_monotonous_timestamps())
    sink = sink_mod.CollectSink()
    (ds.key_by(lambda col: col, vectorized=True)
       .window(asg.TumblingEventTimeWindows.of(1000)).count().sink_to(sink))
    client = env.execute_async("skew-routing")
    held["client"] = client
    ready.set()
    client.wait(180)
    return client, sorted((int(k), int(n)) for k, n in sink.results)


def _control_facts(client):
    from flink_tpu.metrics.registry import metrics_snapshot as jsnap
    from flink_tpu_torch.metrics.registry import metrics_snapshot as tsnap

    snap_fn = tsnap if type(client).__module__.startswith("flink_tpu_torch") else jsnap
    snap = snap_fn(client.metrics.all_metrics())
    blocks = [e["routing"] for e in client._runtime.device_snapshot()["operators"].values()
              if e.get("routing")]
    return {"rebalances": client.mesh_rebalances, "restarts": client.num_restarts,
            "rescales": client.mesh_rescales, "shards": client._runtime.mesh_devices(),
            "version": client._runtime.mesh_routing_version(),
            "kinds": [r["kind"] for r in client.exceptions.payload()["recoveries"]],
            "gauges": (snap["job.meshRebalances"], snap["job.routingTableVersion"]),
            "routing": {k: blocks[0][k] for k in ("version", "numKeyGroups", "movedGroups")},
            # each decision but its time on the job's monotonic clock
            "decisions": [{k: v for k, v in d.as_dict().items() if k != "timestamp"}
                          for d in client.rebalancer.decisions]}


def test_minicluster_rebalance_equals_the_jax_packages(shards):
    """The JAX package's test_minicluster_rebalance_exactly_once on four
    shards of each package: the same rows as the static one-device job, and
    the same rebalances, table version, recovery kinds and decisions."""
    _c, expected = _skewed_job("port", rebalance=False, mesh=False)
    client, rows = _skewed_job("port", rebalance=True)
    jclient, jrows = _skewed_job("jax", rebalance=True)
    assert rows == jrows == expected and len(rows) > 0
    facts, jfacts = _control_facts(client), _control_facts(jclient)
    assert facts == jfacts
    assert facts["rebalances"] >= 1 and facts["restarts"] == 0 and facts["version"] >= 1
    assert set(facts["kinds"]) == {"rebalance"} and facts["routing"]["movedGroups"] > 0
    assert facts["gauges"][0] >= 1 and facts["gauges"][1] >= 1
    from flink_tpu_torch.metrics.registry import metrics_snapshot

    assert metrics_snapshot(client.metrics.all_metrics())["job.lastRebalanceDurationMs"] > 0
    assert client._runtime.mesh_devices() == 4


@pytest.mark.parametrize("rescale_at", [0, 8 * 512], ids=["rescale_first", "rebalance_first"])
def test_rebalance_and_rescale_one_after_the_other_equal_the_jax_packages(shards, rescale_at):
    """A live rescale 4 -> 2 asked at the first batch (it lands before any
    rebalance) or halfway (after the first rebalance): each completed
    rescale or rebalance is applied and counted once, by the attempt that
    completes it, so rows, counters, restarts, table version, recovery
    kinds and decisions equal the JAX package's."""
    _c, expected = _skewed_job("port", rebalance=False, mesh=False)
    client, rows = _skewed_job("port", rebalance=True, rescale_at=rescale_at)
    jclient, jrows = _skewed_job("jax", rebalance=True, rescale_at=rescale_at)
    assert client.status().value == "FINISHED"
    assert rows == jrows == expected and len(rows) > 0
    facts, jfacts = _control_facts(client), _control_facts(jclient)
    assert facts == jfacts
    assert facts["rescales"] == 1 and facts["restarts"] == 0 and facts["shards"] == 2
    assert "rescale" in facts["kinds"]
    if rescale_at:
        assert facts["kinds"].index("rebalance") < facts["kinds"].index("rescale")
    from flink_tpu_torch.metrics.registry import metrics_snapshot

    snap = metrics_snapshot(client.metrics.all_metrics())
    assert snap["job.meshRebalances"] == facts["rebalances"]
    assert client.exceptions.payload()["entries"] == []


def _held_job(shards, extra, *, n=mcr.N, devices=0, visible=8, at=None, wrapper=None):
    """A mesh job held at its source's quarter mark (`at` records) until the
    returned `go` is set; `wrapper` (installed by the caller) may fail a
    dispatch."""
    shards(visible)
    reached, go, fired = threading.Event(), threading.Event(), []
    at = n // 4 if at is None else at

    def hook(idx):
        if not fired and idx[0] >= at:
            fired.append(True)
            reached.set()
            assert go.wait(60)

    env, sink = mcr._make_env(mcr.PORT, mcr.WINDOWS["tumbling"](mcr.tasg), mesh_on=True,
                              n=n, batch=1024, devices=devices, extra=extra, hook=hook)
    client = env.execute_async("mesh-control")
    assert reached.wait(60)
    return client, sink, go


@pytest.fixture(scope="module")
def tumbling_rows():
    """The one-device port's rows and the JAX mesh job's of the tumbling
    program (8 devices of the conftest's CPU mesh)."""
    env, sink = mcr._make_env(mcr.PORT, mcr.WINDOWS["tumbling"](mcr.tasg), mesh_on=False)
    env.execute()
    jenv, jsink = mcr._make_env(mcr.JAX, mcr.WINDOWS["tumbling"](mcr.jasg), mesh_on=True)
    jenv.execute()
    return mcr._rows(sink), mcr._rows(jsink)


def test_autoscaler_executes_mesh_rescales_as_the_parallelism_axis(shards, tumbling_rows):
    """tests/test_multichip_runtime.py's drill: with autoscaler.enabled on
    a mesh job the coordinator holds a real executor; a same-size target is
    rejected, 8 -> 4 runs as a live rescale, and the completed rescale
    stamps the job's gauges and the coordinator's decision log."""
    from flink_tpu_torch.metrics.registry import metrics_snapshot

    client, sink, go = _held_job(shards, {tcfg.AutoscalerOptions.ENABLED: True,
                                          tcfg.RestartOptions.INITIAL_BACKOFF_MS: 1})
    auto = client.autoscaler
    assert auto.rescale_executor is not None, "the mesh job's autoscaler is observe-only"
    accepted, detail = auto.rescale_executor(client.job_id, 8, "drill")
    assert not accepted and "already at 8" in detail
    accepted, detail = auto.rescale_executor(client.job_id, 4, "drill")
    assert accepted and detail == "mesh rescale 8 -> 4 requested"
    go.set()
    client.wait(120)
    assert client.status().value == "FINISHED"
    assert client.mesh_rescales == 1 and client.num_restarts == 0
    assert client._runtime.mesh_devices() == 4
    assert client.last_mesh_rescale_duration_ms > 0
    snap = metrics_snapshot(client.metrics.all_metrics())
    assert snap["job.numRescales"] == 1 and snap["job.lastRescaleDurationMs"] > 0
    assert auto.payload(client.job_id)["enabled"]
    assert mcr._rows(sink) == tumbling_rows[0] == tumbling_rows[1]


def test_autoscaler_without_a_mesh_observes_only(tumbling_rows):
    env, sink = mcr._make_env(mcr.PORT, mcr.WINDOWS["tumbling"](mcr.tasg), mesh_on=False,
                              extra={tcfg.AutoscalerOptions.ENABLED: True})
    client = env.execute_async("observe-only")
    client.wait(120)
    assert client.autoscaler.rescale_executor is None and client.mesh_rescales == 0
    assert mcr._rows(sink) == tumbling_rows[0]


class _DeviceLoss:
    """Fails the sixth sharded dispatch with a device-scoped chaos marker."""

    def __init__(self, monkeypatch, at=6):
        from flink_tpu_torch.parallel.sharded_superscan import ShardedFusedPipeline

        self.calls, self.at = 0, at
        real = ShardedFusedPipeline._scan_shards

        def scan(pipe, *a, **kw):
            self.calls += 1
            if self.calls == self.at:
                raise RuntimeError("[chaos-injected:device] shard 1 lost")
            return real(pipe, *a, **kw)

        monkeypatch.setattr(ShardedFusedPipeline, "_scan_shards", scan)


@pytest.mark.parametrize("degrade", [True, False], ids=["degrade", "no_degrade"])
def test_device_loss_degrades_the_mesh_to_half_its_shards(shards, tumbling_rows, monkeypatch,
                                                          degrade):
    from flink_tpu_torch.checkpoint.coordinator import CheckpointCoordinator

    monkeypatch.setattr(CheckpointCoordinator, "due", lambda self: True)
    loss = _DeviceLoss(monkeypatch)
    shards(4)
    env, sink = mcr._make_env(
        mcr.PORT, mcr.WINDOWS["tumbling"](mcr.tasg), mesh_on=True, batch=1024,
        extra={tcfg.CheckpointingOptions.INTERVAL_MS: 5,
               tcfg.ParallelOptions.MESH_DEGRADE_ON_DEVICE_LOSS: degrade,
               tcfg.RestartOptions.INITIAL_BACKOFF_MS: 1})
    client = env.execute_async("device-loss")
    client.wait(120)
    assert client.status().value == "FINISHED" and loss.calls > loss.at
    assert client.num_restarts == 1
    assert client._runtime.mesh_devices() == (2 if degrade else 4)
    history = client.exceptions.payload()
    (entry,) = history["entries"]
    assert entry["injected"] is True
    (recovery,) = history["recoveries"]
    assert recovery["restored_checkpoint_id"] is not None
    assert mcr._rows(sink) == tumbling_rows[0]


@pytest.mark.parametrize("exc,loss", [
    (RuntimeError("CUDA error: an illegal memory access was encountered"), True),
    (type("AcceleratorError", (RuntimeError,), {})("device lost"), True),
    (RuntimeError("k1 launch failed: CUDA error 700"), True),
    (ValueError("bad record"), False),
    (RuntimeError("ring full"), False),
], ids=["torch_cuda_error", "accelerator_error", "launch_error", "value_error", "plain"])
def test_is_device_loss_walks_the_cause_chain(exc, loss):
    from flink_tpu_torch.runtime.minicluster import _is_device_loss

    assert _is_device_loss(exc) is loss
    try:
        try:
            raise exc
        except Exception as inner:
            raise KeyError("wrapped") from inner
    except KeyError as outer:
        assert _is_device_loss(outer) is loss
    # a cycle in the chain ends the walk
    a, b = ValueError("a"), ValueError("b")
    a.__cause__, b.__cause__ = b, a
    assert _is_device_loss(a) is False


def test_set_mesh_routing_skips_a_mismatched_group_count():
    """tests/test_skew_routing.py's case on both runtimes: an assignment
    sized for another G is skipped (no-op), the right one swaps the table."""
    from flink_tpu.parallel.sharded_superscan import ShardedFusedPipeline as JaxPipe
    from flink_tpu.runtime.executor import JobRuntime as JaxRuntime
    from flink_tpu_torch.parallel.mesh import Mesh
    from flink_tpu_torch.parallel.sharded_superscan import ShardedFusedPipeline
    from flink_tpu_torch.runtime.executor import JobRuntime

    import jax
    from jax.sharding import Mesh as JaxMesh

    geom = dict(key_capacity=256, num_slices=16, nsb=4, fires_per_step=4, out_rows=16,
                chunk=512, skew_routing=True)
    pipes = {"port": ShardedFusedPipeline(Mesh(["cpu"] * 8), mcr.tasg.SlidingEventTimeWindows.of(
                 2000, 500), "count", **geom),
             "jax": JaxPipe(JaxMesh(np.array(jax.devices()[:8]), ("shards",)),
                            mcr.jasg.SlidingEventTimeWindows.of(2000, 500), "count", **geom)}
    out = {}
    for name, runtime_cls in (("port", JobRuntime), ("jax", JaxRuntime)):
        pipe = pipes[name]
        op = types.SimpleNamespace(pipe=pipe, routing_version=pipe.routing_version,
                                   set_routing_assignment=pipe.set_routing_assignment)
        rt = runtime_cls.__new__(runtime_cls)
        rt.runners = [types.SimpleNamespace(op=op)]
        rt.set_mesh_routing(np.zeros(7, np.int64))
        trace = [pipe.routing.version, pipe.routing.is_identity, rt.mesh_routing_version()]
        rt.set_mesh_routing(np.repeat(np.arange(8)[::-1], pipe.routing.G // 8))
        trace += [pipe.routing.version, pipe.routing.is_identity, rt.mesh_routing_version(),
                  pipe.routing_payload()]
        out[name] = trace
    assert out["port"] == out["jax"]
    assert out["port"][:6] == [0, True, 0, 1, False, 1]
