"""The State Processor API and the formats on the card (`chip_smoke.py`
phase 31, small): a savepoint of api_ysb's tumbling sum job read against
numpy, patched sum x 10 and resumed on K1, K1 at the resumed job's first
dispatch over the patched ring as loaded and at its widest against its
plain version, and api_ysb's
records through every format into the fused count job against the CPU.
These need an NVIDIA GPU and nvcc, so they carry the `cuda` marker and skip
elsewhere. Run them on the card with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_state_tools.py

(this file imports neither jax nor flink_tpu).

Tolerance: exact; K1 bit-equal to its plain version, counts included.
"""

import pytest
import torch

import chip_smoke as smoke

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: kernel K1 has no CPU form")
    monkeypatch.setitem(smoke.API, "batch", 8192)
    return "cuda"


def test_a_patched_savepoint_resumes_on_the_card_and_k1_is_exact(cuda, tmp_path):
    a = smoke.tools_leg_a(dict(smoke.STATE_TOOLS, events=1 << 19), cuda, str(tmp_path))
    assert a["in_flight_cells"] > 0 and a["reader_equals_model"]
    assert a["rows_equal_patched_model"] and a["total_equal"] and a["k1_launches"] > 0
    assert a["k1_patched"]["max_abs_err"] == 0.0 and a["ok"]
    assert a["k1_patched"]["first_dispatch"]["max_abs_err"] == 0.0


def test_every_format_feeds_the_fused_job_on_the_card_as_on_the_cpu(cuda, tmp_path):
    sz = dict(smoke.STATE_TOOLS, format_events=1 << 15)
    card = smoke.tools_leg_b(sz, cuda, str(tmp_path / "card"))
    cpu = smoke.tools_leg_b(sz, "cpu", str(tmp_path / "cpu"))
    for fmt in sz["formats"]:
        assert card[fmt]["ok"] and card[fmt]["k1_launches"] > 0
        assert cpu[fmt]["rows_equal_columnar_job"]
        assert card[fmt]["bytes"] == cpu[fmt]["bytes"]
