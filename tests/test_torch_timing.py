"""`testing/timing.py::device_profile`'s completeness check, with the
profiler's sessions scripted (the real ones need a CUDA device): a session
holding fewer device records than the kernel launch calls it saw on the
host is run again, and the fullest one is returned, with a warning when
none was complete."""

import pytest

from flink_tpu_torch.testing import timing


def _scripted(monkeypatch, sessions):
    left = list(sessions)
    monkeypatch.setattr(timing.torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(timing, "_profile_once", lambda fn, reps: left.pop(0))
    return left


def test_a_complete_session_is_taken_as_it_comes(monkeypatch):
    left = _scripted(monkeypatch, [({"k": 2.0}, 3.0, 3.0), ({"k": 9.0}, 3.0, 3.0)])
    assert timing.device_profile(lambda: None) == ({"k": 2.0}, 3.0)
    assert len(left) == 1


@pytest.mark.parametrize("short", [({}, 0.0, 3.0), ({"k": 1.0}, 1.0, 3.0)])
def test_a_short_session_is_run_again(monkeypatch, short):
    left = _scripted(monkeypatch, [short, short, ({"k": 2.0}, 3.0, 3.0)])
    assert timing.device_profile(lambda: None) == ({"k": 2.0}, 3.0)
    assert left == []


def test_launch_calls_the_host_does_not_see_accept_the_device_rows(monkeypatch):
    _scripted(monkeypatch, [({"k": 2.0}, 5.0, 0.0)])
    assert timing.device_profile(lambda: None, tries=1) == ({"k": 2.0}, 5.0)


def test_no_complete_session_returns_the_fullest_with_a_warning(monkeypatch):
    _scripted(monkeypatch, [({"k": 1.0}, 1.0, 3.0), ({"k": 2.0}, 2.0, 3.0),
                            ({}, 0.0, 3.0)])
    with pytest.warns(RuntimeWarning, match="kept 2.0 of 3.0"):
        assert timing.device_profile(lambda: None, tries=3) == ({"k": 2.0}, 2.0)
