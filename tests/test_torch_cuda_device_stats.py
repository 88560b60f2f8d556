"""The device plane on the card: K1's and K2's phase counters against their
plain versions, and no host sync added by the compile tracker.

Each K1 and K2 launch adds [records with idx >= 0 (K1's partials entry:
the sum of its count partials), fire slots (the sum of fire_valid), steps
whose purge row holds a 0] into the dispatch's int32[3] buffer. Here every
adversarial plan of tests/test_torch_cuda_kernels.py (tiled and atomic
ingest, step groups, rings past 128 columns, 64 fire slots) runs with a
phase buffer on the kernel and on the plain version, and both are held to
the counts numpy computes from the inputs. Then a fused job runs on the
card through `env.execute_async` with the device plane on, and the
`torch.cuda.synchronize` calls and the `.item()`/`.cpu()`/`.tolist()`
reads of CUDA tensors made inside `CompileTracker.call` and inside
DeviceTimer sections are counted: all zero. It needs an NVIDIA GPU, so it
carries the `cuda` marker and skips elsewhere. Run it on the card with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_device_stats.py

Tolerance: exact (counts, and the rings and rows bit-equal as in the
kernel tests).
"""

import numpy as np
import pytest
import torch

from flink_tpu_torch.metrics import device_stats, task_io
from flink_tpu_torch.metrics.registry import metrics_snapshot
from flink_tpu_torch.ops import aggregators as agg_mod
from flink_tpu_torch.ops import cuda_superscan as cs
from flink_tpu_torch.ops.superscan import (
    global_superscan_plain,
    keyed_superscan_partials_plain,
    keyed_superscan_plain,
    partial_dtype,
    value_fields,
)
from test_torch_cuda_kernels import (
    K1_CASES,
    K2_CASES,
    MIXED,
    _PAYLOAD,
    _adversarial_plan,
    _rings,
    _same_bits,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the Hopper kernels have no CPU form")
    return torch.device("cuda")


def _expected(idx, plan):
    """[idx >= 0, sum of fire_valid, steps with a 0 in the purge row]."""
    return [int((idx >= 0).sum()), int(plan[2].sum()), int((plan[4] == 0).any(axis=1).sum())]


def _run(kernel, plain, agg, shape, dev, global_scope, T_, B_, nkeys, plan, **kw):
    rng = np.random.default_rng(T_ * 11 + B_)
    idx = rng.integers(-2, nkeys * kw["NSB"], size=T_ * B_).astype(np.int32)
    vals = _PAYLOAD[rng.integers(0, len(_PAYLOAD), size=T_ * B_)]
    args = (torch.from_numpy(idx).to(dev), torch.from_numpy(vals).to(dev),
            tuple(torch.from_numpy(p).to(dev) for p in plan))
    kc, ks = _rings(agg, shape, dev, global_scope)
    pc, ps = _rings(agg, shape, dev, global_scope)
    kph = torch.zeros(3, dtype=torch.int32, device=dev)
    pph = torch.zeros(3, dtype=torch.int32, device=dev)
    for _ in range(2):                   # two dispatches add into one buffer
        kout = kernel(agg, kc, ks, *args, phase=kph, **kw)
        pout = plain(agg, pc, ps, *args, phase=pph, **kw)
    torch.cuda.synchronize()
    for a, b in zip([kc, kout[0], *ks, *kout[1]], [pc, pout[0], *ps, *pout[1]]):
        assert _same_bits(a, b)
    want = [2 * c for c in _expected(idx, plan)]
    assert kph.tolist() == pph.tolist() == want
    return want


@pytest.mark.parametrize("case", sorted(K1_CASES))
def test_k1_phase_counts_match_plain(cuda, case):
    name, K_, S_, NSB_, F_, R_, T_, B_, spws, exact = K1_CASES[case]
    plan = _adversarial_plan(S_, T_, F_, NSB_, R_, spws, seed=len(case))
    counts = _run(cs.keyed_superscan, keyed_superscan_plain, MIXED[name], (S_, K_), cuda,
                  False, T_, B_, K_ + 5, plan, NSB=NSB_, R=R_, spws=spws, exact=exact)
    assert all(c > 0 for c in counts)


def test_k1_phase_counts_across_step_groups(cuda):
    """A dispatch split into step groups (its partials outgrow the budget)
    adds every group's counts into the one buffer."""
    K_, S_, NSB_, F_, R_, T_, B_ = 1 << 20, 8, 4, 4, 8, 48, 5000
    assert len(cs.step_groups(T_, K_, NSB_, 0)) > 1
    plan = _adversarial_plan(S_, T_, F_, NSB_, R_, (2, 3, 1, 2), seed=9)
    _run(cs.keyed_superscan, keyed_superscan_plain, agg_mod.count_agg(), (S_, K_), cuda,
         False, T_, B_, K_, plan, NSB=NSB_, R=R_, spws=(2, 3, 1, 2), exact=True)


@pytest.mark.parametrize("case", sorted(K2_CASES))
def test_k2_phase_counts_match_plain(cuda, case):
    name, S_, NSB_, F_, R_, T_, B_, spws = K2_CASES[case]
    plan = _adversarial_plan(S_, T_, F_, NSB_, R_, spws, seed=len(case))
    _run(cs.global_superscan, global_superscan_plain, MIXED[name], (S_,), cuda, True,
         T_, B_, 50, plan, NSB=NSB_, R=R_, spws=spws)


@pytest.mark.parametrize("name", ["count", "sum", "max"])
def test_k1_partials_phase_counts_match_plain(cuda, name):
    """K1's partials entry counts the sum of its count partials."""
    agg = {"count": agg_mod.count_agg, "sum": agg_mod.sum_agg, "max": agg_mod.max_agg}[name]()
    K_, S_, NSB_, F_, R_, T_ = 700, 16, 4, 4, 16, 6
    spws = (4, 2, 3, 1)
    plan = _adversarial_plan(S_, T_, F_, NSB_, R_, spws, seed=3)
    rng = np.random.default_rng(5)
    cpart = torch.from_numpy(rng.integers(0, 4, (T_, K_, NSB_)).astype(np.int32)).to(cuda)
    parts = [torch.from_numpy(rng.integers(0, 9, (T_, K_, NSB_)).astype(np.float32)).to(cuda)
             .to(partial_dtype(f)) for f in value_fields(agg)]
    dplan = tuple(torch.from_numpy(p).to(cuda) for p in plan)
    kc, ks = _rings(agg, (S_, K_), cuda, False)
    pc, ps = _rings(agg, (S_, K_), cuda, False)
    kph = torch.zeros(3, dtype=torch.int32, device=cuda)
    pph = torch.zeros(3, dtype=torch.int32, device=cuda)
    kw = dict(NSB=NSB_, R=R_, spws=spws)
    ko = cs.keyed_superscan_partials(agg, kc, ks, cpart, parts, dplan, phase=kph, **kw)
    po = keyed_superscan_partials_plain(agg, pc, ps, cpart, parts, dplan, phase=pph, **kw)
    torch.cuda.synchronize()
    for a, b in zip([kc, ko[0], *ks, *ko[1]], [pc, po[0], *ps, *po[1]]):
        assert _same_bits(a, b)
    want = [int(cpart.sum()), int(plan[2].sum()), int((plan[4] == 0).any(axis=1).sum())]
    assert kph.tolist() == pph.tolist() == want


def test_phase_buffer_off_changes_nothing(cuda):
    """Counters off (phase None) and on give the same rings and rows."""
    name, K_, S_, NSB_, F_, R_, T_, B_, spws, exact = K1_CASES["f32_fields"]
    plan = _adversarial_plan(S_, T_, F_, NSB_, R_, spws, seed=1)
    rng = np.random.default_rng(2)
    idx = torch.from_numpy(rng.integers(-2, K_ * NSB_, T_ * B_).astype(np.int32)).to(cuda)
    vals = torch.from_numpy(_PAYLOAD[rng.integers(0, len(_PAYLOAD), T_ * B_)]).to(cuda)
    dplan = tuple(torch.from_numpy(p).to(cuda) for p in plan)
    outs = []
    for phase in (None, torch.zeros(3, dtype=torch.int32, device=cuda)):
        c, st = _rings(MIXED[name], (S_, K_), cuda, False)
        o = cs.keyed_superscan(MIXED[name], c, st, idx, vals, dplan, NSB=NSB_, R=R_,
                               spws=spws, exact=exact, phase=phase)
        outs.append([c, o[0], *st, *o[1]])
    torch.cuda.synchronize()
    assert all(_same_bits(a, b) for a, b in zip(*outs))


def test_tracker_and_sections_add_no_host_sync(cuda, monkeypatch):
    """A default fused job on the card (device plane on): no synchronize and
    no read of a CUDA tensor inside CompileTracker.call or a DeviceTimer
    section; its phase counters equal the filter's survivors."""
    from flink_tpu_torch.api.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.api.windowing.assigners import SlidingEventTimeWindows
    from flink_tpu_torch.config import Configuration
    from flink_tpu_torch.connectors.sink import CollectSink
    from flink_tpu_torch.connectors.source import Batch, DataGeneratorSource
    from flink_tpu_torch.core.watermarks import WatermarkStrategy
    from flink_tpu_torch.testing import stream as st

    depth = {"tracker": 0, "section": 0}
    counts = {"tracker_calls": 0, "sections": 0, "sync_in_tracker": 0, "sync_in_section": 0,
              "read_in_tracker": 0, "read_in_section": 0}
    call = device_stats.CompileTracker.call
    enter, exit_ = task_io.DeviceTimer._Section.__enter__, task_io.DeviceTimer._Section.__exit__
    sync = torch.cuda.synchronize

    def tracked(self, *a, **kw):
        depth["tracker"] += 1
        counts["tracker_calls"] += 1
        try:
            return call(self, *a, **kw)
        finally:
            depth["tracker"] -= 1

    def s_enter(sec):
        depth["section"] += 1
        counts["sections"] += 1
        return enter(sec)

    def s_exit(sec, *exc):
        depth["section"] -= 1
        return exit_(sec, *exc)

    def counted_sync(*a, **kw):
        counts["sync_in_tracker"] += depth["tracker"] > 0
        counts["sync_in_section"] += depth["section"] > 0
        return sync(*a, **kw)

    def reader(orig):
        def read(t, *a, **kw):
            if t.is_cuda:
                counts["read_in_tracker"] += depth["tracker"] > 0
                counts["read_in_section"] += depth["section"] > 0
            return orig(t, *a, **kw)
        return read

    monkeypatch.setattr(device_stats.CompileTracker, "call", tracked)
    monkeypatch.setattr(task_io.DeviceTimer._Section, "__enter__", s_enter)
    monkeypatch.setattr(task_io.DeviceTimer._Section, "__exit__", s_exit)
    monkeypatch.setattr(torch.cuda, "synchronize", counted_sync)
    for name in ("item", "cpu", "tolist"):
        monkeypatch.setattr(torch.Tensor, name, reader(getattr(torch.Tensor, name)))

    n, keys = 1 << 18, 8192
    cfg = Configuration({"execution.step.batch-size": 8192, "execution.state.key-capacity": keys,
                         "execution.window.columnar-output": True,
                         "execution.window.superbatch-steps": 8})
    env = StreamExecutionEnvironment(cfg, device="cuda")
    sink = CollectSink()
    (env.from_source(DataGeneratorSource(lambda idx: Batch(*st.api_columns(idx, n, keys)), n),
                     WatermarkStrategy.for_bounded_out_of_orderness(0))
        .filter(lambda c: c[:, 1] < 0.5, traceable=True)
        .key_by(lambda c: c[:, 0].to(torch.int32), traceable=True)
        .window(SlidingEventTimeWindows.of(10_000, 1_000)).aggregate("count").sink_to(sink))
    cs.reset_launch_counts()
    client = env.execute_async()
    assert client.wait(300).value == "FINISHED", client.error
    snap = metrics_snapshot(client.metrics.all_metrics())
    ingest = [v for k, v in snap.items() if k.endswith(".phaseIngestRecords")]
    assert ingest == [-(-n // 3)]
    assert counts["tracker_calls"] > 0 and counts["sections"] > 0
    assert cs.LAUNCHES["k1_superscan"] > 0
    assert {k: v for k, v in counts.items() if k.startswith(("sync", "read"))} == {
        "sync_in_tracker": 0, "sync_in_section": 0, "read_in_tracker": 0,
        "read_in_section": 0}
