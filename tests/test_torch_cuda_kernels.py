"""Hopper kernels K1 and K2 against their plain PyTorch versions, on the card.

These need an NVIDIA GPU and nvcc (a CUDA kernel has no interpret mode), so
they carry the `cuda` marker and skip elsewhere. Run them on the card with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_kernels.py

(`--noconftest`: the repo's conftest imports jax, which the port's machine
need not have; this file imports neither jax nor flink_tpu.)

Tolerance: bit equality. Counts and order statistics are order-free, and
the add payloads are small integers, so every float32 partial sum is an
exact integer whatever order the kernels add in.
"""

import numpy as np
import pytest
import torch

from flink_tpu_torch.api.windowing.assigners import SlidingEventTimeWindows
from flink_tpu_torch.ops import aggregators as agg_mod
from flink_tpu_torch.ops import cuda_superscan as cs
from flink_tpu_torch.ops.superscan import (
    global_superscan_plain,
    keyed_superscan_plain,
    value_fields,
)
from flink_tpu_torch.runtime.fused_window_pipeline import (
    FusedGlobalWindowPipeline,
    FusedWindowPipeline,
)

pytestmark = pytest.mark.cuda

K, S, NSB, F, SPW, R = 1000, 8, 3, 3, 3, 8     # K deliberately not a multiple of 128
T, B = 5, 3001                                 # B deliberately ragged

AGGS = {
    "count": agg_mod.count_agg,
    "sum": agg_mod.sum_agg,
    "sum_i32": lambda: agg_mod.sum_agg(np.int32),
    "max8": lambda: agg_mod.max_agg(domain_bits=8),
    "min": agg_mod.min_agg,
    "max": agg_mod.max_agg,
    "max_i32": lambda: agg_mod.max_agg(np.int32),
    "mean": agg_mod.mean_agg,
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the Hopper kernels have no CPU form")
    return torch.device("cuda")


def _plan(rng, S_):
    return [
        rng.integers(0, S_, size=T).astype(np.int32),
        rng.integers(0, S_, size=(T, F)).astype(np.int32),
        rng.integers(0, 2, size=(T, F)).astype(np.int32),
        (np.arange(T * F, dtype=np.int32).reshape(T, F)) % R,
        (rng.random((T, S_)) > 0.2).astype(np.int32),
    ]


def _rings(agg, shape, dev, global_scope):
    count = torch.zeros(shape, dtype=torch.int32, device=dev)
    states = []
    for f in value_fields(agg):
        ident = (agg_mod.scan_identity(np.dtype(f.dtype), f.scatter)
                 if global_scope else f.identity)
        states.append(torch.full(shape, ident, dtype=agg_mod.torch_dtype(f.dtype),
                                 device=dev))
    return count, states


def _both(kernel, plain, agg, shape, nkeys, dev, global_scope, seed, **kw):
    rng = np.random.default_rng(seed)
    idx = torch.from_numpy(rng.integers(-2, nkeys * NSB, size=T * B).astype(np.int32))
    vals = torch.from_numpy(rng.integers(-5, 300, size=T * B).astype(np.float32))
    plan = [torch.from_numpy(a) for a in _plan(rng, shape[0])]
    kc, ks = _rings(agg, shape, dev, global_scope)
    pc, ps = _rings(agg, shape, dev, global_scope)
    args = (idx.to(dev), vals.to(dev), tuple(p.to(dev) for p in plan))
    before = cs.LAUNCHES.copy()
    kout = kernel(agg, kc, ks, *args, **kw)
    pout = plain(agg, pc, ps, *args, **kw)
    torch.cuda.synchronize()
    launched = {k: cs.LAUNCHES[k] - before[k] for k in before}
    return [kc, kout[0], *ks, *kout[1]], [pc, pout[0], *ps, *pout[1]], launched


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("name", sorted(AGGS))
def test_k1_matches_plain(cuda, name, exact):
    got, want, launched = _both(
        cs.keyed_superscan, keyed_superscan_plain, AGGS[name](), (S, K), K + 3,
        cuda, False, seed=len(name), NSB=NSB, R=R, spws=(3, 1, 2), exact=exact)
    assert launched["k1_superscan"] == 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["count", "sum", "sum_i32", "min", "max", "max_i32", "mean"])
def test_k2_matches_plain(cuda, name):
    got, want, launched = _both(
        cs.global_superscan, global_superscan_plain, AGGS[name](), (S,), 50,
        cuda, True, seed=len(name), NSB=NSB, R=R, spws=(SPW,) * F)
    assert launched["k2_global_superscan"] == 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_k1_refuses_what_it_cannot_run(cuda):
    agg = agg_mod.sum_agg(np.float64)
    count, states = _rings(agg, (S, K), cuda, False)
    plan = tuple(torch.from_numpy(a).to(cuda) for a in _plan(np.random.default_rng(0), S))
    with pytest.raises(NotImplementedError):
        cs.keyed_superscan(agg, count, states,
                           torch.zeros(T * B, dtype=torch.int32, device=cuda),
                           torch.zeros(T * B, device=cuda), plan, NSB=NSB, R=R,
                           spws=(SPW,) * F, exact=True)


def _stream(steps, batch, seed=4, keys=300):
    rng = np.random.default_rng(seed)
    out, wms = [], []
    for t in range(steps):
        base = 5000 + t * 400 + np.sort(rng.integers(0, 400, batch))
        ts = np.maximum(base - rng.integers(0, 120, batch), 0).astype(np.int64)
        out.append((rng.integers(0, keys, batch).astype(np.int32),
                    rng.integers(0, 9, batch).astype(np.float32), ts))
        wms.append(int(base[-1]) - 150)
    return out, wms


@pytest.mark.parametrize("agg", ["count", "sum", "max"])
def test_pipelines_on_the_card_match_the_cpu(cuda, agg):
    batches, wms = _stream(6, 900)
    win = SlidingEventTimeWindows.of(2000, 500)
    geo = dict(num_slices=16, nsb=4, fires_per_step=4, out_rows=16, chunk=256)
    for make in (lambda d: FusedWindowPipeline(win, agg, key_capacity=300, device=d, **geo),
                 lambda d: FusedGlobalWindowPipeline(win, agg, device=d, **geo)):
        gpu, cpu = make(cuda), make("cpu")
        for lo, hi in ((0, 3), (3, 6)):
            g = gpu.process_superbatch(batches[lo:hi], wms[lo:hi], defer=True).resolve()
            c = cpu.process_superbatch(batches[lo:hi], wms[lo:hi])
            assert len(g) == len(c) > 0
            for (gw, gc, gf), (cw, cc, cf) in zip(g, c):
                assert gw == cw and np.array_equal(gc, cc)
                live = np.asarray(cc) > 0
                for n in cf:
                    a, b = np.asarray(gf[n]), np.asarray(cf[n])
                    assert np.array_equal(a[live] if a.ndim else a, b[live] if b.ndim else b)
        snap_g, snap_c = gpu.snapshot(), cpu.snapshot()
        assert np.array_equal(snap_g["count"], snap_c["count"])


# ---------------------------------------------------------------------------
# plans the step-partial design must get right, bit-equal to the plain
# versions (float cells compared as bit patterns, so -0.0 counts)
# ---------------------------------------------------------------------------

_FMAX = float(np.finfo(np.float32).max)
MIXED = {
    "f32": agg_mod.DeviceAggregator("mixed_f32", (
        agg_mod.AccField("s", np.float32, 0, "add"),
        agg_mod.AccField("lo", np.float32, _FMAX, "min"),
        agg_mod.AccField("hi", np.float32, -_FMAX, "max"),
        agg_mod.AccField("m8", np.int32, -1, "max", domain_bits=8)), lambda f: f["s"]),
    "i32": agg_mod.DeviceAggregator("mixed_i32", (
        agg_mod.AccField("si", np.int32, 0, "add"),
        agg_mod.AccField("lo", np.int32, int(np.iinfo(np.int32).max), "min"),
        agg_mod.AccField("hi", np.int32, int(np.iinfo(np.int32).min), "max"),
        agg_mod.AccField("s", np.float32, 0, "add")), lambda f: f["s"]),
    "count": agg_mod.count_agg(),
    "order": agg_mod.DeviceAggregator("mixed_order", (
        agg_mod.AccField("lo", np.float32, _FMAX, "min"),
        agg_mod.AccField("hi", np.int32, int(np.iinfo(np.int32).min), "max")), lambda f: f["hi"]),
}
# payloads with -0.0 and no +0.0: a min/max that took the signed-integer
# trick, or lost -0.0 to +0.0, differs in its bits
_PAYLOAD = np.array([-0.0, -7, -3, -1, 1, 2, 5, 200, 300], np.float32)


def _adversarial_plan(S_, T_, F_, NSB_, R_, spws, seed):
    """Every step ingests NSB columns from smin[t]; the column ingested at
    t+1 is purged at t; slot 0 fires the window that ends on the step's
    last ingested column; slot 1 wraps past S; the last two slots share a
    row (the later one wins) and one row is out of range (clipped)."""
    rng = np.random.default_rng(seed)
    smin = (3 * np.arange(T_ + 1) + 1) % S_
    fpos = rng.integers(0, S_, size=(T_, F_))
    fpos[:, 0] = (smin[:T_] + NSB_ - spws[0]) % S_
    fpos[:, 1] = S_ - 1 - np.arange(T_) % 2
    fvalid = rng.integers(0, 2, size=(T_, F_))
    fvalid[:, :2] = 1
    frow = rng.integers(0, R_, size=(T_, F_))
    frow[:, -1] = frow[:, -2]
    frow[::3, 1] = R_ + 3
    purge = (rng.random((T_, S_)) > 0.1).astype(np.int32)
    purge[np.arange(T_), smin[1:]] = 0
    return [a.astype(np.int32) for a in (smin[:T_], fpos, fvalid, frow, purge)]


def _same_bits(a, b):
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def _pair(kernel, plain, agg, shape, dev, global_scope, T_, B_, nkeys, plan, **kw):
    rng = np.random.default_rng(T_ * 7 + B_)
    idx = rng.integers(-2, nkeys * kw["NSB"], size=T_ * B_).astype(np.int32)
    vals = _PAYLOAD[rng.integers(0, len(_PAYLOAD), size=T_ * B_)]
    args = (torch.from_numpy(idx).to(dev), torch.from_numpy(vals).to(dev),
            tuple(torch.from_numpy(p).to(dev) for p in plan))
    kc, ks = _rings(agg, shape, dev, global_scope)
    pc, ps = _rings(agg, shape, dev, global_scope)
    before = dict(cs.CUDA_LAUNCHES)
    for _ in range(2):                   # chained dispatches carry the ring
        kout = kernel(agg, kc, ks, *args, **kw)
        pout = plain(agg, pc, ps, *args, **kw)
        torch.cuda.synchronize()
        for a, b in zip([kc, kout[0], *ks, *kout[1]], [pc, pout[0], *ps, *pout[1]]):
            assert _same_bits(a, b)
    return {k: (cs.CUDA_LAUNCHES[k] - before[k]) // 2 for k in before}


K1_CASES = {
    # name: (agg, K, S, NSB, F, R, T, B, spws, exact)
    "f32_fields": ("f32", 1000, 8, 3, 4, 8, 5, 3001, (3, 3, 1, 5), True),
    "i32_fields_bf16": ("i32", 1000, 8, 3, 4, 8, 5, 3001, (2, 4, 1, 3), False),
    "one_step": ("f32", 777, 16, 4, 4, 8, 1, 70001, (4, 2, 3, 1), True),
    "ragged_batch": ("f32", 4096, 32, 4, 4, 64, 3, 16 * 256 * 4 + 37, (10, 10, 10, 10), True),
    "nsb_beyond_ring": ("i32", 200, 3, 5, 2, 4, 4, 999, (2, 3), True),
    # eight key tiles of the count, each re-reading the step's records
    "count_in_eight_tiles": ("count", 100_000, 8, 4, 4, 16, 3, 20_000, (3, 1, 2, 4), True),
    # more key tiles than K1_MAX_TILES: the ingest lands records with
    # device-memory atomics
    "keys_beyond_a_cluster": ("f32", 60_000, 8, 4, 4, 16, 3, 20_000, (3, 1, 2, 4), True),
    "many_keys_bf16_ragged": ("i32", 70_000, 8, 4, 4, 16, 3, 20_001, (1, 4, 2, 3), False),
    "ring_beyond_shared_memory": ("f32", 300, 600, 4, 4, 16, 3, 5000, (30, 1, 7, 600), True),
    # 40 rels of five arrays: the scan reads its partials from device memory
    "partials_beyond_shared_memory": ("i32", 300, 64, 40, 4, 16, 3, 5000, (9, 64, 2, 70), True),
}


@pytest.mark.parametrize("case", sorted(K1_CASES))
def test_k1_adversarial_plans(cuda, case):
    name, K_, S_, NSB_, F_, R_, T_, B_, spws, exact = K1_CASES[case]
    plan = _adversarial_plan(S_, T_, F_, NSB_, R_, spws, seed=len(case))
    launched = _pair(cs.keyed_superscan, keyed_superscan_plain, MIXED[name], (S_, K_),
                     cuda, False, T_, B_, K_ + 5, plan, NSB=NSB_, R=R_, spws=spws,
                     exact=exact)
    assert launched["k1_superscan"] == 2


def test_k1_splits_steps_whose_partials_outgrow_the_budget(cuda):
    K_, S_, NSB_, F_, R_, T_, B_ = 1 << 20, 8, 4, 4, 8, 48, 5000
    groups = cs.step_groups(T_, K_, NSB_, 0)
    assert len(groups) > 1
    plan = _adversarial_plan(S_, T_, F_, NSB_, R_, (2, 3, 1, 2), seed=9)
    launched = _pair(cs.keyed_superscan, keyed_superscan_plain, agg_mod.count_agg(),
                     (S_, K_), cuda, False, T_, B_, K_, plan, NSB=NSB_, R=R_,
                     spws=(2, 3, 1, 2), exact=True)
    assert launched["k1_superscan"] == 2 * len(groups)


K2_CASES = {
    # name: (agg, S, NSB, F, R, T, B, spws)
    "f32_fields": ("f32", 8, 2, 4, 16, 5, 3001, (3, 3, 1, 5)),
    "i32_fields": ("i32", 8, 3, 4, 16, 5, 3001, (2, 4, 1, 3)),
    "one_step": ("f32", 16, 4, 4, 8, 1, 70001, (4, 2, 3, 1)),
    # two ingest blocks a step, the second ragged; every float sum stays
    # below 2^24, so exact
    "two_blocks_ragged": ("f32", 8, 1, 4, 16, 3, 32768 + 4097, (1, 2, 3, 4)),
    # ten blocks a step (two fold batches in k2_scan); order statistics only
    "many_blocks": ("order", 8, 2, 4, 16, 2, 9 * 32768 + 5, (1, 2, 3, 4)),
    "nsb_8_full_ring": ("i32", 32, 8, 16, 128, 4, 9000, tuple(range(1, 17))),
    "steps_beyond_a_chunk": ("f32", 8, 2, 4, 16, 130, 1000, (2, 2, 2, 8)),
}


@pytest.mark.parametrize("case", sorted(K2_CASES))
def test_k2_adversarial_plans(cuda, case):
    name, S_, NSB_, F_, R_, T_, B_, spws = K2_CASES[case]
    plan = _adversarial_plan(S_, T_, F_, NSB_, R_, spws, seed=len(case))
    launched = _pair(cs.global_superscan, global_superscan_plain, MIXED[name], (S_,),
                     cuda, True, T_, B_, 50, plan, NSB=NSB_, R=R_, spws=spws)
    assert launched["k2_global_superscan"] == 2
