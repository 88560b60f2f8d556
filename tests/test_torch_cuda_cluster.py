"""The cluster on the card (`chip_smoke.py` phase 32, small): api_ysb's
fused program as a GraphJobSpec on two in-process TaskExecutors on cuda,
its rows against the local run and the oracle, K1 launched in the
TaskExecutor and held against its plain version at its first full
dispatch; a cold-build race (two TaskExecutors' first K1 dispatches at once
in an emptied build directory); the sharded device operators (K3/K4) and
ML_PREDICT on the card. These need an NVIDIA GPU and nvcc, so they carry
the `cuda` marker and skip elsewhere. Run them on the card with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_cluster.py

(this file imports neither jax nor flink_tpu).

Tolerance: exact; K1 bit-equal to its plain version; ML scores within 1e-5
relative of the CPU's.
"""

import threading

import pytest
import torch

import chip_smoke as smoke

pytestmark = pytest.mark.cuda

SMALL = dict(smoke.API_CLUSTER, events_a=1 << 19, events_b=1 << 19, batch=16384,
             c_steps=4, c_batch=1 << 15, ml_rows=1 << 12)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: kernel K1 has no CPU form")
    return "cuda"


@pytest.fixture
def sec():
    from flink_tpu_torch.testing.harness import ephemeral_transport_security

    return ephemeral_transport_security("card-cluster")


def test_graph_job_on_two_task_executors_matches_the_local_run(cuda, sec):
    a = smoke.cluster_leg_a(SMALL, cuda, sec)
    assert a["status"] == "FINISHED" and a["rows_equal_local"] and a["local_equal_oracle"]
    assert a["k1_launches_task_executor"] > 0 and a["ok"]
    assert a["k1_cluster"]["first_dispatch"]["max_abs_err"] == 0.0
    assert a["k1_cluster"]["max_abs_err"] == 0.0


def test_two_task_executors_first_dispatches_in_a_cold_build_directory(cuda, sec, tmp_path,
                                                                       monkeypatch):
    from flink_tpu_torch.ops import cuda_superscan as cs
    from flink_tpu_torch.testing import cluster_jobs as cj

    monkeypatch.setattr(cs, "BUILD_DIR", tmp_path / "build")
    cs._library.cache_clear()
    try:
        kw = dict(keys=1024, batch=8192, window_ms=10_000, slide_ms=1000)
        env, sink = cj.api_graph(1 << 17, device="cpu", **kw)   # loads no library
        env.execute()
        want = cj.fired_rows(sink.results)
        kw["device"] = cuda
        with smoke._Cluster(sec, cuda) as c:
            cs.reset_launch_counts()
            jobs = [c.client.submit_job(cj.api_graph_spec(f"race-{i}", 1 << 17, **kw).to_bytes(),
                                        1) for i in range(2)]
            statuses = [c.wait(j, timeout=900) for j in jobs]
            rows = [cj.fired_rows(c.client.job_result(j)) for j in jobs]
            where = {te.tm_id for te in c.tes
                     for (jid, _a, _s) in list(te._tasks) if jid in jobs}
        assert [s["status"] for s in statuses] == ["FINISHED", "FINISHED"], statuses
        assert len(where) == 2                      # one job on each TaskExecutor
        assert rows[0] == rows[1] == want and cs.LAUNCHES["k1_superscan"] > 0
        built = sorted(p.name for p in (tmp_path / "build").iterdir())
        assert [n for n in built if n.startswith("libsuperscan-") and n.endswith(".so")]
        assert not [n for n in built if n.startswith("tmp-")], built
    finally:
        cs._library.cache_clear()


def test_concurrent_first_library_loads_build_once(cuda, tmp_path, monkeypatch):
    from flink_tpu_torch.ops import cuda_superscan as cs

    monkeypatch.setattr(cs, "BUILD_DIR", tmp_path / "build")
    cs._library.cache_clear()
    try:
        libs, errors = [], []
        gate = threading.Barrier(3)

        def load():
            gate.wait()
            try:
                libs.append(cs._library("superscan"))
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(e)

        threads = [threading.Thread(target=load) for _ in range(3)]
        [t.start() for t in threads]
        [t.join(600) for t in threads]
        assert not errors and len(libs) == 3 and libs[0] is libs[1] is libs[2]
    finally:
        cs._library.cache_clear()


def test_sharded_device_operators_match_numpy_on_the_card(cuda, sec):
    c = smoke.cluster_leg_c(SMALL, cuda, sec)
    assert c["sliding_count"]["equal_numpy"] and c["session_sum"]["equal_numpy"]
    assert c["session_sum"]["k3_launches"] > 0 and c["session_sum"]["k4_launches"] > 0
    assert c["ok"]


def test_ml_predict_on_the_card_matches_the_cpu(cuda):
    d = smoke.cluster_leg_d(SMALL, cuda)
    assert d["row_order_equal"] and d["within_tolerance"] and d["ok"]
