"""The port's chaos plane against the JAX package's (`flink_tpu/chaos/plan.py`
and the seams that read it).

For the same rules and seed both packages' FaultPlans fire the same
sequence over the same scripted calls (nth, probability, a window on a
driven clock, max_fires, the partition default, crash over error), and
`from_config` builds equal plans. Then the cases of tests/test_chaos.py
that need no cluster run in both packages: the hook's install cycle, the
storage seam (error, torn, load), the typed corruption and restore skip,
the coordinator's tolerance and its refusal to tolerate an InjectedCrash,
a MiniCluster job whose config installs a plan (uninstalled after the job)
and an installed empty plan being result-neutral. No test sleeps on the
window clock: it is driven.
"""

import os
import types

import numpy as np
import pytest

pytest.importorskip("jax")

import flink_tpu.chaos as jchaos  # noqa: E402
import flink_tpu.chaos.plan as jplan  # noqa: E402
import flink_tpu.checkpoint.coordinator as jco  # noqa: E402
import flink_tpu.checkpoint.storage as jst  # noqa: E402
import flink_tpu.config as jcfg  # noqa: E402
import flink_tpu.metrics.checkpoint_stats as jstats  # noqa: E402
import flink_tpu.testing.harness as jharness  # noqa: E402
import flink_tpu_torch.chaos as tchaos  # noqa: E402
import flink_tpu_torch.chaos.plan as tplan  # noqa: E402
import flink_tpu_torch.checkpoint.coordinator as tco  # noqa: E402
import flink_tpu_torch.checkpoint.storage as tst  # noqa: E402
import flink_tpu_torch.config as tcfg  # noqa: E402
import flink_tpu_torch.metrics.checkpoint_stats as tstats  # noqa: E402
import flink_tpu_torch.testing.harness as tharness  # noqa: E402

PK = {"jax": types.SimpleNamespace(chaos=jchaos, plan=jplan, co=jco, st=jst, cfg=jcfg,
                                   stats=jstats, harness=jharness),
      "port": types.SimpleNamespace(chaos=tchaos, plan=tplan, co=tco, st=tst, cfg=tcfg,
                                    stats=tstats, harness=tharness)}
BOTH = ("jax", "port")


def _outcome(plan, scope, site):
    """One seam call: the directive, or the raised fault's type and text."""
    try:
        return ("ok", plan.act(scope, site))
    except tplan.InjectedFault as e:
        return (type(e).__name__, str(e), e.label)
    except jplan.InjectedFault as e:
        return (type(e).__name__, str(e), e.label)


def _script(seed: int, n: int = 400):
    """A scripted call sequence over every scope and a few sites, with the
    clock the window trigger reads."""
    rng = np.random.default_rng(seed)
    scopes = ["transport", "rpc", "dataplane", "storage", "device", "heartbeat"]
    sites = ["save:3", "load:/x/chk-3/_metadata", "window_aggregate@2", "a.b", "tm-b",
             "0->1", "cold-tier:get"]
    t, calls = 0.0, []
    for _ in range(n):
        t += float(rng.exponential(0.02))
        calls.append((scopes[int(rng.integers(0, 6))], sites[int(rng.integers(0, 7))], t))
    return calls


RULE_SETS = {
    "nth_max_fires": [{"scope": "rpc", "fault": "error", "match": "a.b", "nth": 3,
                       "max_fires": 2}],
    "probability": [{"scope": "device", "fault": "drop", "probability": 0.5,
                     "max_fires": None},
                    {"scope": "storage", "fault": "error", "probability": 0.2,
                     "match": "save", "max_fires": 5}],
    "window": [{"scope": "heartbeat", "fault": "partition", "window_s": [1.0, 2.5]},
               {"scope": "dataplane", "fault": "drop", "window_s": [0.5, 3.0],
                "probability": 0.7, "max_fires": 9}],
    "partition_default": [{"scope": "heartbeat", "fault": "partition", "match": "tm-b"},
                          {"scope": "heartbeat", "fault": "partition", "max_fires": 1}],
    "crash_over_error": [{"scope": "storage", "fault": "error", "nth": 2, "max_fires": None},
                         {"scope": "storage", "fault": "crash", "nth": 5, "max_fires": 3},
                         {"scope": "storage", "fault": "torn", "match": "save",
                          "max_fires": None}],
    "every_kind": [{"scope": s, "fault": f, "probability": 0.3, "max_fires": 4,
                    "label": f"{s}-{f}"}
                   for s in ("device", "storage", "rpc") for f in ("error", "torn", "drop")],
}


@pytest.mark.parametrize("seed", [0, 7, 123])
@pytest.mark.parametrize("rules", sorted(RULE_SETS))
def test_the_same_rules_and_seed_fire_the_same_sequence(rules, seed):
    runs = []
    for pkg in BOTH:
        clock = [0.0]
        P = PK[pkg].plan
        plan = P.FaultPlan([P.FaultRule(**{**d, "window_s": tuple(d["window_s"])}
                                        if "window_s" in d else d)
                            for d in RULE_SETS[rules]], seed=seed, clock=lambda: clock[0])
        outs = []
        for scope, site, t in _script(seed):
            clock[0] = t
            outs.append(_outcome(plan, scope, site))
        runs.append((outs, plan.report(), plan.total_fired))
    assert runs[0] == runs[1]
    assert runs[1][2] > 0


def test_from_config_builds_equal_plans_and_is_off_by_default():
    rules = ('[{"scope": "storage", "fault": "error", "match": "save", "nth": 2},'
             ' {"scope": "heartbeat", "fault": "partition", "window_s": [1, 2]}]')
    plans = []
    for pkg in BOTH:
        C = PK[pkg].cfg
        assert PK[pkg].plan.FaultPlan.from_config(C.Configuration()) is None
        assert PK[pkg].plan.FaultPlan.from_config(
            C.Configuration().set(C.ChaosOptions.RULES, rules)) is None   # not enabled
        cfg = (C.Configuration().set(C.ChaosOptions.ENABLED, True)
               .set(C.ChaosOptions.SEED, 9).set(C.ChaosOptions.RULES, rules))
        plan = PK[pkg].plan.FaultPlan.from_config(cfg)
        plans.append((plan.seed, [vars(r) for r in plan.rules]))
        empty = PK[pkg].plan.FaultPlan.from_config(
            C.Configuration().set(C.ChaosOptions.ENABLED, True))
        assert empty is not None and empty.rules == []
    assert plans[0] == plans[1]
    assert plans[1][1][0]["nth"] == 2 and plans[1][1][1]["window_s"] == (1, 2)
    for opt in ("ENABLED", "SEED", "RULES"):
        j, t = getattr(jcfg.ChaosOptions, opt), getattr(tcfg.ChaosOptions, opt)
        assert (j.key, j.default, j.type) == (t.key, t.default, t.type)


@pytest.mark.parametrize("pkg", BOTH)
def test_hook_is_none_by_default_and_install_uninstall_cycle(pkg):
    P, H = PK[pkg].plan, PK[pkg].harness
    assert P.HOOK is None and P.active_plan() is None
    with H.fault_injection(rules=[]) as plan:
        assert P.HOOK is not None and P.HOOK.__self__ is plan
        assert P.active_plan() is plan
        with pytest.raises(RuntimeError, match="already installed"):
            P.install_plan(plan)
    assert P.HOOK is None and P.active_plan() is None
    with pytest.raises(ZeroDivisionError):
        with H.fault_injection(rules=[{"scope": "device", "fault": "error"}]):
            1 / 0
    assert P.HOOK is None


@pytest.mark.parametrize("pkg", BOTH)
def test_rules_validate_and_faults_are_labeled_connection_errors(pkg):
    P = PK[pkg].plan
    with pytest.raises(ValueError, match="scope"):
        P.FaultRule("warp-drive", "error")
    with pytest.raises(ValueError, match="fault"):
        P.FaultRule("rpc", "gremlins")
    assert P.FaultRule("heartbeat", "partition").max_fires is None
    assert P.FaultRule("heartbeat", "partition", max_fires=1).max_fires == 1
    assert P.FaultRule("rpc", "error").max_fires == 1
    e = P.InjectedFault("rpc:error:x")
    assert isinstance(e, ConnectionError) and P.INJECTED_MARKER in repr(e)
    assert isinstance(P.InjectedCrash("x"), P.InjectedFault)
    assert tchaos.INJECTED_MARKER == jchaos.INJECTED_MARKER == tstats.INJECTED_MARKER


def test_the_harness_transport_helpers_wait_for_the_cluster():
    """Ported since (the cluster, ROADMAP item 14b): as in the JAX harness,
    an ephemeral security is a fresh random secret, and transport_security
    pins the process default for a block and restores it (the test keeps
    its original name)."""
    from flink_tpu_torch.security import transport as ttransport

    a, b = tharness.ephemeral_transport_security("c"), tharness.ephemeral_transport_security("c")
    assert a.enabled and a.cluster_id == "c" and a.secret != b.secret and len(a.secret) == 32
    before = ttransport.SecurityConfig.resolve()
    with tharness.transport_security(a) as pinned:
        assert pinned is a and ttransport.SecurityConfig.resolve() is a
    assert ttransport.SecurityConfig.resolve() == before


# ---------------------------------------------------------------------------
# the storage seam, typed corruption and the restore skip
# ---------------------------------------------------------------------------

def _stores(pkg, tmp_path):
    return {"memory": PK[pkg].st.MemoryCheckpointStorage(),
            "fs": PK[pkg].st.FsCheckpointStorage(str(tmp_path / pkg))}


@pytest.mark.parametrize("kind", ["memory", "fs"])
def test_storage_seam_errors_tears_and_loads_as_the_jax_store(tmp_path, kind):
    seen = {}
    for pkg in BOTH:
        st = _stores(pkg, tmp_path)[kind]
        with PK[pkg].harness.fault_injection(rules=[
                {"scope": "storage", "fault": "error", "match": "save:2"},
                {"scope": "storage", "fault": "torn", "match": "save:4"},
                {"scope": "storage", "fault": "error", "match": "load", "nth": 2}]) as plan:
            st.save(1, {"x": np.arange(64)})
            with pytest.raises(PK[pkg].plan.InjectedFault, match="chaos-injected"):
                st.save(2, {"x": np.arange(64)})
            st.save(3, {"x": np.arange(64)})
            st.save(4, {"x": np.arange(64)})
            ids = [c for c, _h in st.list_checkpoints()]
            h3 = dict(st.list_checkpoints())[3]
            assert st.load(h3)["x"].shape == (64,)            # load 1
            with pytest.raises(PK[pkg].plan.InjectedFault):
                st.load(h3)                                   # load 2 errors
            with pytest.raises(PK[pkg].st.CorruptCheckpointError):
                st.load(dict(st.list_checkpoints())[4])       # torn
            # the restore rewinds past the torn checkpoint
            co = PK[pkg].co.CheckpointCoordinator(st, 1000)
            latest = co.latest_snapshot()
            seen[pkg] = (ids, latest["x"].tolist(), plan.report()["rules"],
                         [(scope, site.replace(f"/{pkg}/", "/")) for _l, scope, site
                          in plan.fired])
    assert seen["port"] == seen["jax"]
    assert seen["port"][0] == [1, 3, 4]


@pytest.mark.parametrize("pkg", BOTH)
def test_fs_load_wraps_torn_and_missing_artifacts(pkg, tmp_path):
    import shutil

    S = PK[pkg].st
    st = S.FsCheckpointStorage(str(tmp_path))
    handle = st.save(1, {"x": np.arange(16)})
    size = os.path.getsize(handle)
    with open(handle, "r+b") as f:
        f.truncate(size // 3)
    with pytest.raises(S.CorruptCheckpointError, match="chk-1"):
        st.load(handle)
    h2 = st.save(2, {"x": 1})
    shutil.rmtree(tmp_path / "chk-2")
    with pytest.raises(S.CorruptCheckpointError):
        st.load(h2)
    mem = S.MemoryCheckpointStorage()
    mem.save(1, {"x": 1})
    assert mem.load("mem:1") == {"x": 1}
    with pytest.raises(S.CorruptCheckpointError):
        mem.load("mem:7")


@pytest.mark.parametrize("pkg", BOTH)
def test_fs_save_fsyncs_file_and_parent_dir(pkg, tmp_path, monkeypatch):
    mod = PK[pkg].st
    synced = []
    real = os.fsync
    monkeypatch.setattr(mod.os, "fsync", lambda fd: (synced.append(fd), real(fd))[1])
    mod.FsCheckpointStorage(str(tmp_path)).save(1, {"x": np.arange(4)})
    assert len(synced) >= 2


@pytest.mark.parametrize("pkg", BOTH)
def test_latest_snapshot_skips_torn_checkpoints(pkg, tmp_path):
    S, C = PK[pkg].st, PK[pkg].co
    st = S.FsCheckpointStorage(str(tmp_path))
    for cid in (1, 2, 3):
        st.save(cid, {"cid": cid})

    def tear(cid):
        with open(os.path.join(str(tmp_path), f"chk-{cid}", "_metadata"), "r+b") as f:
            f.truncate(4)

    tear(3)
    coord = C.CheckpointCoordinator(st, interval_ms=1000)
    assert coord.latest_snapshot()["cid"] == 2
    tear(1)
    tear(2)
    assert coord.latest_snapshot() is None


# ---------------------------------------------------------------------------
# tolerable-failed-checkpoints and InjectedCrash
# ---------------------------------------------------------------------------

class _FlakyStorage:
    def __init__(self, inner):
        self.inner = inner
        self.exploding = False
        self.last_save_bytes = 0

    def save(self, cid, data):
        if self.exploding:
            raise OSError("disk on fire")
        out = self.inner.save(cid, data)
        self.last_save_bytes = self.inner.last_save_bytes
        return out

    def __getattr__(self, name):
        return getattr(self.inner, name)


def _tolerance_trace(pkg):
    P = PK[pkg]
    st = _FlakyStorage(P.st.MemoryCheckpointStorage())
    stats = P.stats.CheckpointStatsTracker()
    clock = [0.0]
    coord = P.co.CheckpointCoordinator(st, interval_ms=1, stats=stats,
                                       clock=lambda: clock[0], tolerable_failures=2)
    trace = []

    def step(explode):
        clock[0] += 1.0
        st.exploding = explode
        try:
            trace.append(("cid", coord.trigger(lambda: {"s": 1})))
        except P.co.CheckpointFailuresExhaustedError as e:
            trace.append(("exhausted", str(e)))
        trace.append(stats.gauge_values()["consecutiveFailedCheckpoints"])

    for explode in (True, True, False, True, True, True):
        step(explode)
    coord.reset_failure_streak()
    step(True)
    trace.append((stats.num_failed, stats.num_completed))
    return trace


def test_coordinator_tolerates_then_escalates_as_the_jax_coordinator():
    jt, tt = _tolerance_trace("jax"), _tolerance_trace("port")
    assert tt == jt
    assert ("cid", None) in tt and any(t[0] == "exhausted" for t in tt if isinstance(t, tuple))


@pytest.mark.parametrize("pkg", BOTH)
def test_coordinator_never_tolerates_crash_or_base_exceptions(pkg):
    P = PK[pkg]
    clock = [10.0]
    stats = P.stats.CheckpointStatsTracker()
    coord = P.co.CheckpointCoordinator(P.st.MemoryCheckpointStorage(), interval_ms=1,
                                       clock=lambda: clock[0], tolerable_failures=5,
                                       stats=stats)

    def crash_capture():
        raise P.plan.InjectedCrash("storage:crash:*")

    with pytest.raises(P.plan.InjectedCrash):
        coord.trigger(crash_capture)
    clock[0] += 1

    def interrupt_capture():
        raise KeyboardInterrupt()

    with pytest.raises(KeyboardInterrupt):
        coord.trigger(interrupt_capture)
    clock[0] += 1

    def error_capture():   # a plain injected error IS tolerated
        raise P.plan.InjectedFault("storage:error:*")

    assert coord.trigger(error_capture) is None
    assert stats.num_failed == 3
    assert "chaos-injected" in stats.payload()["latest"]["failed"]["failure_cause"]


@pytest.mark.parametrize("pkg", BOTH)
def test_coordinator_default_zero_tolerance_raises_original(pkg):
    P = PK[pkg]
    st = _FlakyStorage(P.st.MemoryCheckpointStorage())
    st.exploding = True
    coord = P.co.CheckpointCoordinator(st, interval_ms=1, clock=lambda: 10.0)
    with pytest.raises(OSError, match="disk on fire"):
        coord.trigger(lambda: {"s": 1})


# ---------------------------------------------------------------------------
# MiniCluster: the config's plan, and an empty plan changing nothing
# ---------------------------------------------------------------------------

def _mini_count(pkg, name, records, extra=None, chk_dir=None):
    if pkg == "jax":
        from flink_tpu.chaos.scenarios import _run_mini_count_job
        return _run_mini_count_job(name, records=records, extra_config=extra, chk_dir=chk_dir)
    from flink_tpu_torch.chaos.scenarios import _run_mini_count_job
    return _run_mini_count_job(name, device="cpu", records=records, extra_config=extra,
                               chk_dir=chk_dir)


def test_minicluster_config_chaos_plan_uninstalls_after_the_job():
    rows = {}
    for pkg in BOTH:
        C = PK[pkg].cfg
        assert PK[pkg].plan.active_plan() is None
        client, rows[pkg] = _mini_count(pkg, "drill", 650, extra={
            C.ChaosOptions.ENABLED: True, C.ChaosOptions.SEED: 3})
        assert client.status().value == "FINISHED"
        assert PK[pkg].plan.active_plan() is None, "the job's plan leaked past it"
    assert rows["port"] == rows["jax"] and rows["port"]


def test_a_config_plan_drills_the_job_and_is_attributed(tmp_path):
    """A job whose config carries a device rule restarts once, at parity,
    with the failure attributed injected, in both packages; the plan is gone
    after the job."""
    out = {}
    for pkg in BOTH:
        C = PK[pkg].cfg
        client, rows = _mini_count(pkg, "config-drill", 1300, chk_dir=str(tmp_path / pkg),
                                   extra={C.ChaosOptions.ENABLED: True,
                                          C.ChaosOptions.RULES:
                                              '[{"scope": "device", "fault": "error", '
                                              '"nth": 4}]'})
        entries = client.exceptions.payload()["entries"]
        out[pkg] = (rows, client.num_restarts, bool(entries and entries[0]["injected"]))
        assert PK[pkg].plan.active_plan() is None
    assert out["port"] == out["jax"]
    assert out["port"][1:] == (1, True)


def test_a_drill_plan_is_never_stacked_on_an_installed_one():
    with tharness.fault_injection(rules=[]) as outer:
        _client, _rows = _mini_count("port", "nested", 650, extra={
            tcfg.ChaosOptions.ENABLED: True,
            tcfg.ChaosOptions.RULES: '[{"scope": "device", "fault": "error"}]'})
        assert tplan.active_plan() is outer and _client.num_restarts == 0
    assert tplan.active_plan() is None


def test_installed_empty_plan_is_result_neutral():
    _c1, baseline = _mini_count("port", "parity-off", 1300)
    with tharness.fault_injection(rules=[]):
        _c2, hooked = _mini_count("port", "parity-on", 1300)
    _c3, jax_rows = _mini_count("jax", "parity-jax", 1300)
    assert hooked == baseline == jax_rows and baseline


@pytest.mark.parametrize("strategy", ["fixed-delay", "none"])
def test_the_failed_attempt_is_released_on_every_failure_path(strategy, monkeypatch, tmp_path):
    """The MiniCluster releases a failed attempt (device sync, collection)
    whether it restarts or gives up; a restart's timeline and JobRestart
    span start when the failure was caught, and its recovery record
    reports the release."""
    from flink_tpu_torch.runtime import minicluster as tmc

    real, calls = tmc._release_attempt, []

    def counted(device):
        calls.append(device.type)
        return real(device)

    monkeypatch.setattr(tmc, "_release_attempt", counted)
    extra = {tcfg.ChaosOptions.ENABLED: True, tcfg.RestartOptions.STRATEGY: strategy,
             tcfg.ChaosOptions.RULES: '[{"scope": "device", "fault": "error", "nth": 4}]'}
    if strategy == "none":
        with pytest.raises(RuntimeError, match="failed") as err:
            _mini_count("port", "release", 1300, chk_dir=str(tmp_path), extra=extra)
        assert calls == ["cpu"] and tplan.INJECTED_MARKER in repr(err.value.__cause__)
        return
    client, _rows = _mini_count("port", "release", 1300, chk_dir=str(tmp_path), extra=extra)
    assert calls == ["cpu"]
    assert client.status().value == "FINISHED" and client.num_restarts == 1
    (rec,) = client.exceptions.payload()["recoveries"]
    (span,) = [s for s in client.span_log.spans if s.name == "JobRestart"]
    assert 0 <= rec["release_ms"] <= rec["downtime_ms"]
    assert span.start_ts_ms == rec["failed_at_ms"]
