"""High availability on the port against the JAX package's: the lease-file
leader election and the job result store (the cases of JAX
tests/test_distributed.py), and the Kubernetes Lease driver against JAX
tests/test_ha_kubernetes.py's fake apiserver.

The JAX cases run on the port with their module's names rebound to the
port's classes (`FileLeaderElection`, `JobResultStore`,
`KubernetesLeaderElection`, `LeaseApi`, `LeaseConflict`): the fake
apiserver then raises the port's conflict, and each case asserts what it
asserts of the JAX package. Then the two packages share one lease: a
contender of each on one lease file or one fake Lease hands over to the
other, and the Lease bodies they write are equal.
"""

import json
import time

import pytest

pytest.importorskip("jax")

import test_distributed as jdist  # noqa: E402
import test_ha_kubernetes as jk8s  # noqa: E402

import flink_tpu.runtime.ha as jha  # noqa: E402
import flink_tpu.runtime.ha_kubernetes as jhk  # noqa: E402
import flink_tpu_torch.runtime.ha as tha  # noqa: E402
import flink_tpu_torch.runtime.ha_kubernetes as thk  # noqa: E402

K8S_CASES = ("test_single_contender_acquires_and_renews", "test_failover_to_second_contender",
             "test_clean_release_hands_over_fast", "test_conflict_loser_does_not_become_leader")


@pytest.mark.parametrize("case", ["test_leader_election_failover", "test_job_result_store"])
def test_the_jax_ha_cases_hold_on_the_port(case, tmp_path, monkeypatch):
    monkeypatch.setattr(jdist, "FileLeaderElection", tha.FileLeaderElection)
    monkeypatch.setattr(jdist, "JobResultStore", tha.JobResultStore)
    getattr(jdist, case)(tmp_path)


@pytest.mark.parametrize("case", K8S_CASES)
def test_the_jax_lease_cases_hold_on_the_port(case, monkeypatch):
    for name in ("KubernetesLeaderElection", "LeaseApi", "LeaseConflict"):
        monkeypatch.setattr(jk8s, name, getattr(thk, name))
    getattr(jk8s, case)()


def _wait(pred, timeout=5.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


def test_a_lease_file_hands_over_between_the_packages(tmp_path):
    lease = str(tmp_path / "leader.lease")
    a = jha.FileLeaderElection(lease, "jax", address="a:1", renew_interval=0.05,
                               lease_timeout=0.4)
    assert _wait(lambda: a.is_leader)
    b = tha.FileLeaderElection(lease, "port", address="b:2", renew_interval=0.05,
                               lease_timeout=0.4)
    try:
        time.sleep(0.3)
        assert not b.is_leader
        assert b.current_leader()["leader"] == "jax"
        a.stop(release=True)
        assert _wait(lambda: b.is_leader and (b.current_leader() or {}).get("leader") == "port")
        with open(lease) as f:
            assert set(json.load(f)) == {"leader", "address", "stamp"}
    finally:
        a.stop()
        b.stop()


def test_job_result_stores_read_each_others_results(tmp_path):
    jstore, tstore = jha.JobResultStore(str(tmp_path)), tha.JobResultStore(str(tmp_path))
    jstore.create_dirty("a", {"state": "FINISHED"})
    tstore.create_dirty("b", {"state": "FAILED"})
    assert tstore.dirty_results() == jstore.dirty_results() == {
        "a": {"state": "FINISHED"}, "b": {"state": "FAILED"}}
    tstore.mark_clean("a")
    assert jstore.dirty_results() == {"b": {"state": "FAILED"}} and jstore.has_result("a")


def test_a_lease_hands_over_between_the_packages_and_their_bodies_are_equal(monkeypatch):
    """One fake apiserver whose conflicts both electors catch; a JAX holder
    releases and the port's contender takes the Lease; the bodies each
    writes are equal but for the holder and the renew time."""
    class Conflict(jhk.LeaseConflict, thk.LeaseConflict):
        pass

    monkeypatch.setattr(jk8s, "LeaseConflict", Conflict)
    api = jk8s.FakeLeaseApi()
    a = jhk.KubernetesLeaderElection(api, "flink", "jm-leader", "jax", address="a:1",
                                     renew_interval=0.05, lease_duration=5.0)
    assert _wait(lambda: a.is_leader)
    jbody = api.get_lease("flink", "jm-leader")
    b = thk.KubernetesLeaderElection(api, "flink", "jm-leader", "port", address="b:2",
                                     renew_interval=0.05, lease_duration=5.0)
    try:
        time.sleep(0.2)
        assert not b.is_leader and b.current_leader() == {"leader_id": "jax", "address": "a:1"}
        a.stop(release=True)
        assert _wait(lambda: b.is_leader, timeout=2.0)
        tbody = api.get_lease("flink", "jm-leader")
        assert a.current_leader() == {"leader_id": "port", "address": "b:2"}

        def masked(body):
            body = json.loads(json.dumps(body))
            body["spec"]["renewTime"] = body["spec"]["holderIdentity"] = None
            body["metadata"]["annotations"] = None
            body["metadata"].pop("resourceVersion")
            return body

        assert masked(tbody) == masked(jbody)
        assert set(tbody["metadata"]["annotations"]) == set(jbody["metadata"]["annotations"])
    finally:
        a.stop()
        b.stop()


def test_the_micro_time_wire_format_is_the_jax_packages():
    for s in ("2026-10-18T15:01:49.123456Z", "1970-01-01T00:00:00.000000Z",
              "2026-10-18T15:01:49Z"):
        assert thk._parse_micro(s) == jhk._parse_micro(s)
    now = thk._now_micro()
    assert abs(jhk._parse_micro(now) - time.time()) < 5
