"""The chaos plane's drills on the card (`chip_smoke.py` phase 30, small):
the eight in-process scenarios with the mesh ones on four shards of the
card, a device error injected into api_ysb's job, the restarted attempt
held against the uninterrupted run and the CPU, and K1 at the restarted
attempt's first dispatch against its plain version from the restored ring.
These need an NVIDIA GPU and nvcc, so they carry the `cuda` marker and skip
elsewhere. Run them on the card with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_chaos.py

(this file imports neither jax nor flink_tpu).

Tolerance: exact; K1 bit-equal to its plain version, counts included.
"""

import pytest
import torch

import chip_smoke as smoke
from flink_tpu_torch.chaos import scenarios
from flink_tpu_torch.testing.harness import fault_injection

pytestmark = pytest.mark.cuda

EVENTS = 1 << 18
BATCH = 8192


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: kernel K1 has no CPU form")
    return "cuda"


@pytest.mark.parametrize("name", list(scenarios.SCENARIOS))
def test_each_scenario_passes_on_the_card(cuda, name):
    r = scenarios.run_scenario(name, device=cuda, shards=4)
    assert r["passed"] and not r["skipped"], r["detail"]
    assert r["injected_fired"] >= 1
    if name in smoke.ATTRIBUTED_SCENARIOS:
        assert r["attributed"] is True
    if name in scenarios.MESH_SCENARIOS:
        assert r["mesh"] == [4, 2]


def _run(dev, tmp, plan_rules=None, tap=False):
    sz = dict(smoke.API_CHECKPOINT, events=EVENTS, batch=BATCH)
    sink = smoke.FailOnceSink(smoke.timed_collect_sink())
    env = smoke.ckpt_job(EVENTS, sink, sz, interval=1, chk_dir=str(tmp), columnar=True,
                         dev=dev, conf={"execution.checkpointing.max-retained": 1 << 20})
    if plan_rules is None:
        run = smoke.ckpt_run(env, dev)
        return run, sink, None
    with fault_injection(rules=plan_rules) as plan, \
            smoke.K1Tap(lambda: plan.total_fired > 0) as k1:
        run = smoke.ckpt_run(env, dev)
    return run, sink, k1


def test_a_device_error_recovers_to_the_uninterrupted_rows_and_k1_is_exact(cuda, tmp_path):
    keys = smoke.API_CHECKPOINT["keys"]
    base, base_sink, _ = _run(cuda, tmp_path / "base")
    cpu, cpu_sink, _ = _run("cpu", tmp_path / "cpu")
    run, sink, tap = _run(cuda, tmp_path / "fault",
                          [{"scope": "device", "fault": "error", "nth": 20}])
    base_fired = smoke.columnar_fired(base_sink.inner.results, keys)[0]
    assert smoke._fired_equal(base_fired, smoke.columnar_fired(cpu_sink.inner.results, keys)[0])
    fired, twice = smoke.columnar_fired(sink.inner.results, keys)
    client = run["client"]
    assert not twice and smoke._fired_equal(fired, base_fired)
    rec = smoke.ckpt_stats(client)
    assert rec["num_restarts"] == 1 and rec["injected"] == [True]
    assert rec["restored_checkpoint_id"] is not None and run["k1_launches"] > 0
    mem = sink.first_write_bytes
    assert len(mem) == 2 and mem[1] <= mem[0] + smoke.CHAOS["mem_slack"]
    # exactness only: a profiler session here, the process's first, would
    # thin the device records of the later card files' sessions
    # (testing/timing.py::device_profile)
    k1 = tap.exact("restarted dispatch", smoke._fused_pipe(client))
    assert k1["max_abs_err"] == 0.0 and k1["first_dispatch"]["max_abs_err"] == 0.0
