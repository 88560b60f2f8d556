"""The port's chaos scenario drills against the JAX package's.

Each of the eight in-process scenarios of `flink_tpu/chaos/scenarios.py`
runs once in each package, on the CPU (the port with device="cpu" and the
mesh scenarios on 8 shards, as the JAX package's run on its eight virtual
devices). The result fields a consumer reads (passed, parity, restarts,
injected_fired, attributed, skipped, doctor) are equal.

Two scenarios read the wall clock through their 1 ms checkpoint interval,
in both packages alike, so the twins hold the coordinator's clock to a
schedule counted in step boundaries, the same in both packages:
torn-checkpoint's fires count the checkpoints taken (a checkpoint at every
boundary), and join-restore's stall attribution goes to whichever control
span overlaps the first post-restore fire most, the restart or a
checkpoint taken just after it (checkpoints at the first two boundaries
only, before the injected failure at the third). On the wall clock that
scenario fails in either package when the restart is quicker than the
checkpoint after it (ROADMAP.md Queue C). The undisturbed jobs' rows equal the JAX oracle
jobs', and the four cluster scenarios raise naming the cluster's item.
"""

import pytest

pytest.importorskip("jax")

import flink_tpu.chaos.scenarios as jscen  # noqa: E402
import flink_tpu.checkpoint.coordinator as jco  # noqa: E402
import flink_tpu_torch.chaos.scenarios as tscen  # noqa: E402
import flink_tpu_torch.checkpoint.coordinator as tco  # noqa: E402
from jax_native_twins import jax_native_library  # noqa: E402,F401

FIELDS = ("passed", "parity", "restarts", "injected_fired", "attributed", "skipped", "doctor")


def _first_two(self) -> bool:
    self.boundaries = getattr(self, "boundaries", 0) + 1
    return self.interval_s > 0 and self.boundaries <= 2


SCHEDULES = {"torn-checkpoint": lambda self: self.interval_s > 0,
             "join-restore": _first_two}


def _run(name, run):
    if name not in SCHEDULES:
        return run()
    with pytest.MonkeyPatch.context() as mp:
        for co in (jco, tco):
            mp.setattr(co.CheckpointCoordinator, "due", SCHEDULES[name])
        return run()


@pytest.fixture(scope="module")
def jax_results():
    return {name: _run(name, lambda n=name: jscen.run_scenario(n)) for name in tscen.SCENARIOS}


@pytest.mark.parametrize("name", list(tscen.SCENARIOS))
def test_each_scenario_gives_the_jax_scenarios_result(name, jax_results):
    port = _run(name, lambda: tscen.run_scenario(name, device="cpu", shards=8))
    jax = jax_results[name]
    assert {f: port[f] for f in FIELDS} == {f: jax[f] for f in FIELDS}, (port, jax)
    assert port["passed"] and not port["skipped"], port["detail"]
    if name in tscen.MESH_SCENARIOS:
        assert port["mesh"] == [8, 4]


def test_the_scenario_list_is_the_jax_packages_in_process_half():
    assert list(tscen.SCENARIOS) + list(tscen.CLUSTER_SCENARIOS) == list(jscen.SCENARIOS)


def test_the_undisturbed_jobs_give_the_jax_oracle_jobs_rows():
    _c, jrows = jscen._run_mini_count_job("oracle")
    _c, trows = tscen._run_mini_count_job("oracle", device="cpu")
    assert trows == jrows and sum(n for _k, n in trows) == 2600
    _c, jjoin = jscen._run_mini_join_job("join-oracle")
    _c, tjoin = tscen._run_mini_join_job("join-oracle", device="cpu")
    assert tjoin == jjoin and tjoin


@pytest.mark.parametrize("name", tscen.CLUSTER_SCENARIOS)
def test_cluster_scenarios_raise_naming_the_cluster(name):
    with pytest.raises(NotImplementedError, match="item 14"):
        tscen.run_scenario(name, device="cpu")
    with pytest.raises(NotImplementedError, match="cluster"):
        tscen.run_matrix([name], device="cpu")


def test_one_shard_reports_a_skip_not_a_pass():
    for name in tscen.MESH_SCENARIOS:
        r = tscen.run_scenario(name, device="cpu", shards=1)
        assert r["skipped"] and r["passed"] and r["injected_fired"] == 0


def test_run_matrix_folds_the_results(monkeypatch):
    """run_matrix's summary over stubbed scenarios (the real ones run
    above): default names, the crashed-scenario result, the recovery p50."""
    calls = []

    def fake(name, ms):
        def run(device=None, shards=None):
            calls.append((name, str(device), shards))
            if ms is None:
                raise RuntimeError("boom")
            return tscen._result(name, "mini", None, [], parity=True, recovery_ms=ms)
        return run

    stubs = {n: fake(n, None if i == 2 else float(i)) for i, n in enumerate(tscen.SCENARIOS)}
    monkeypatch.setattr(tscen, "SCENARIOS", stubs)
    out = tscen.run_matrix(device="cpu", shards=8)
    assert out["scenarios_total"] == 8 and out["scenarios_passed"] == 7
    assert not out["parity"]
    crashed = out["scenarios"][2]
    assert crashed["detail"].startswith("scenario crashed: RuntimeError('boom')")
    assert out["recovery_time_ms_p50"] == 4.0   # median of 0, 1, 3, 4, 5, 6, 7
    assert [c[0] for c in calls] == list(stubs)
    assert {c[2] for c in calls if c[0] in tscen.MESH_SCENARIOS} == {8}
