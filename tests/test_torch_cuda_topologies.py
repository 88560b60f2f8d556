"""The union of two YSB feeds on the card (`chip_smoke.py` phase 29, leg A,
at 2^18 records and batch 8192), and K1 at the union job's first full
dispatch against its plain version. These need an NVIDIA GPU and nvcc,
so they carry the `cuda` marker and skip elsewhere. Run them on the card
with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_topologies.py

(this file imports neither jax nor flink_tpu).

Tolerance: exact; K1 bit-equal to its plain version, counts included.
"""

import pytest
import torch

import chip_smoke as smoke
from flink_tpu_torch.ops import cuda_superscan as cs
from flink_tpu_torch.ops.superscan import keyed_superscan_plain
from flink_tpu_torch.testing import stream as st

pytestmark = pytest.mark.cuda

EVENTS = 1 << 18
BATCH = 8192


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: kernel K1 has no CPU form")
    monkeypatch.setitem(smoke.API, "batch", BATCH)
    return "cuda"


def test_the_union_job_on_the_card_equals_the_cpu_and_the_oracle(cuda):
    fired = {}
    for dev in ("cuda", "cpu"):
        sink, _secs, k1 = smoke.union_run(EVENTS, columnar=False, dev=dev)
        fired[dev] = smoke.api_fired(sink, smoke.API["window"], smoke.API["slide"])
        if dev == "cuda":
            assert k1 > 0
    assert smoke._fired_equal(fired["cuda"], fired["cpu"])
    ref = st.api_replay(EVENTS, BATCH, num_keys=smoke.API["keys"])
    ok, checked = st.parity(ref.fired, fired["cuda"])
    assert ok and checked > 60
    assert smoke.union_selection(cuda)["ok"]


def test_k1_at_the_union_dispatch_equals_its_plain_version(cuda):
    pipe, agg, idx, vals, plan = smoke.union_k1_inputs(EVENTS, cuda)
    assert int(plan[0].shape[0]) == 32 and len(plan[5]) > 0
    err = smoke.compare_kernel(cs.keyed_superscan, keyed_superscan_plain, agg,
                               [(idx, vals, plan)], (pipe.S, pipe.K), False, NSB=pipe.NSB,
                               R=pipe.R, spws=pipe.slot_spws(), exact=True)
    assert err == 0.0
