"""The port's plain keyed superscan held against the JAX package.

Same inputs (made with numpy from a seed) go through
`flink_tpu_torch.ops.superscan.keyed_superscan_plain` (the plain version of
Hopper kernel K1, and the CPU path) and through the JAX package's pallas
superscan in interpret mode and its XLA `make_superscan_step`, at
tests/test_pallas_superscan.py's geometry.

Tolerances: counts and max8 are exact. Sums are exact on integer-valued
payloads (the repo's float-add contract: every partial sum is an integer
below 2**24, so any add order gives the same float); on random floats the
two sides add in different orders, so rtol 1e-6 (a few float32 ulps).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flink_tpu.ops import aggregators as jagg
from flink_tpu.ops import pallas_superscan as ps
from flink_tpu.runtime.fused_window_pipeline import _build_superscan
from flink_tpu_torch.ops import aggregators as tagg
from flink_tpu_torch.ops import cuda_superscan as cs
from flink_tpu_torch.ops.superscan import keyed_superscan_plain

K, S, NSB, F, SPW, R = 256, 8, 2, 2, 3, 8
T, B, CH = 4, 2048, 1024
KB = K // 128

AGGS = {
    "count": (jagg.count_agg, tagg.count_agg),
    "sum": (jagg.sum_agg, tagg.sum_agg),
    "max8": (lambda: jagg.max_agg(domain_bits=8), lambda: tagg.max_agg(domain_bits=8)),
    "min": (jagg.min_agg, tagg.min_agg),
    "max": (jagg.max_agg, tagg.max_agg),
    "mean": (jagg.mean_agg, tagg.mean_agg),
}


def _inputs(seed=3, float_vals=False):
    rng = np.random.default_rng(seed)
    idx = rng.integers(-1, K * NSB, size=(T * B,)).astype(np.int32)
    if float_vals:
        vals = rng.normal(0.0, 10.0, size=(T * B,)).astype(np.float32)
    else:
        vals = rng.integers(0, 50, size=(T * B,)).astype(np.float32)
    smin = rng.integers(0, S, size=T).astype(np.int32)
    fpos = rng.integers(0, S, size=(T, F)).astype(np.int32)
    fvalid = rng.integers(0, 2, size=(T, F)).astype(np.int32)
    frow = (np.arange(T * F, dtype=np.int32).reshape(T, F)) % R
    purge = (rng.random((T, S)) > 0.2).astype(np.int32)
    return idx, vals, smin, fpos, fvalid, frow, purge


def _run_port(agg, inp, exact, spws=(SPW,) * F, wrapper=False):
    idx, vals, smin, fpos, fvalid, frow, purge = inp
    vf = [f for f in agg.fields if f.source == tagg.VALUE]
    count = torch.zeros((S, K), dtype=torch.int32)
    states = [torch.full((S, K), f.device_identity, dtype=tagg.torch_dtype(f.dtype))
              for f in vf]
    plan = tuple(torch.from_numpy(a) for a in (smin, fpos, fvalid, frow, purge))
    fn = cs.keyed_superscan if wrapper else keyed_superscan_plain
    count_out, outs = fn(agg, count, states, torch.from_numpy(idx),
                         torch.from_numpy(vals) if vf else None, plan,
                         NSB=NSB, R=R, spws=spws, exact=exact)
    return (count.numpy(), [s.numpy() for s in states], count_out.numpy(),
            [o.numpy() for o in outs])


def _run_pallas(agg, inp, exact, spws=None):
    idx, vals, smin, fpos, fvalid, frow, purge = inp
    vf = [f for f in agg.fields if f.source == jagg.VALUE]
    run = ps.build_superscan(agg, K, S, NSB, F, SPW, R, T, B, CH, exact, True,
                             fire_spws=spws)
    states = tuple(jnp.full((S * KB, 128), f.identity, jnp.dtype(f.dtype)) for f in vf)
    cnt, fst, cout, fouts = run(smin, fpos, fvalid, frow, purge,
                                jnp.zeros((S * KB, 128), jnp.int32), states,
                                jnp.asarray(idx), jnp.asarray(vals) if vf else None)
    return (np.asarray(cnt).reshape(S, K), [np.asarray(s).reshape(S, K) for s in fst],
            np.asarray(cout).reshape(R, K), [np.asarray(o).reshape(R, K) for o in fouts])


def _run_xla(agg, inp, exact):
    idx, vals, smin, fpos, fvalid, frow, purge = inp
    vf = [f for f in agg.fields if f.source == jagg.VALUE]
    run = _build_superscan(agg, K, S, NSB, F, R, SPW, CH, exact, T, B)
    state = {f.name: jnp.full((K, S), f.identity, jnp.dtype(f.dtype)) for f in vf}
    outs0 = {f.name: jnp.zeros((R, K), jnp.dtype(f.dtype)) for f in vf}
    st, cnt, outs, cout = run(state, jnp.zeros((K, S), jnp.int32), outs0,
                              jnp.zeros((R, K), jnp.int32),
                              jnp.asarray(idx.reshape(T, B)),
                              jnp.asarray(vals.reshape(T, B)),
                              smin, fpos, fvalid, frow, purge)
    return (np.asarray(cnt).T, [np.asarray(st[f.name]).T for f in vf],
            np.asarray(cout), [np.asarray(outs[f.name]) for f in vf])


def _assert_same(port, ref, exact_fields=True):
    cnt, st, cout, outs = port
    rcnt, rst, rcout, routs = ref
    assert np.array_equal(cnt, rcnt)
    assert np.array_equal(cout, rcout)
    assert len(st) == len(rst) and len(outs) == len(routs)
    for a, b in zip(st + outs, rst + routs):
        assert a.dtype == b.dtype
        if exact_fields:
            assert np.array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("mode,exact", [
    ("count", True), ("sum", True), ("sum", False), ("max8", True), ("mean", True),
])
def test_plain_matches_pallas_interpret(mode, exact):
    jmk, tmk = AGGS[mode]
    inp = _inputs()
    _assert_same(_run_port(tmk(), inp, exact), _run_pallas(jmk(), inp, exact))


def test_plain_matches_pallas_on_random_floats():
    inp = _inputs(seed=8, float_vals=True)
    _assert_same(_run_port(tagg.sum_agg(), inp, True),
                 _run_pallas(jagg.sum_agg(), inp, True), exact_fields=False)


def test_plain_matches_pallas_with_fire_spws():
    inp = _inputs(seed=4)
    _assert_same(_run_port(tagg.count_agg(), inp, True, spws=(3, 1)),
                 _run_pallas(jagg.count_agg(), inp, True, spws=(3, 1)))


@pytest.mark.parametrize("mode", ["count", "sum", "max8", "min", "max"])
def test_plain_matches_xla_step(mode):
    jmk, tmk = AGGS[mode]
    inp = _inputs(seed=5)
    _assert_same(_run_port(tmk(), inp, True), _run_xla(jmk(), inp, True))


def test_wrapper_runs_plain_version_on_cpu_tensors():
    inp = _inputs(seed=6)
    before = dict(cs.LAUNCHES)
    _assert_same(_run_port(tagg.max_agg(domain_bits=8), inp, True, wrapper=True),
                 _run_port(tagg.max_agg(domain_bits=8), inp, True))
    assert cs.LAUNCHES == before   # CPU calls launch nothing


def test_wrapper_refuses_devices_without_a_kernel():
    agg = tagg.count_agg()
    count = torch.zeros((S, K), dtype=torch.int32, device="meta")
    plan = tuple(torch.zeros(s, dtype=torch.int32, device="meta")
                 for s in [(T,), (T, F), (T, F), (T, F), (T, S)])
    with pytest.raises(ValueError, match="device"):
        cs.keyed_superscan(agg, count, [], torch.zeros(T * B, dtype=torch.int32,
                                                       device="meta"),
                           None, plan, NSB=NSB, R=R, spws=(SPW,) * F, exact=True)


def test_layout_helpers_match_the_tpu_layout():
    rng = np.random.default_rng(1)
    canon = rng.integers(0, 100, size=(K, S)).astype(np.int32)
    tpu = np.asarray(ps.to_kernel_layout(canon, K, S))
    ours = cs.to_kernel_layout(torch.from_numpy(canon))
    assert np.array_equal(ours.numpy().reshape(S * KB, 128), tpu)
    assert np.array_equal(cs.from_kernel_layout(ours).numpy(), canon)
    assert np.array_equal(cs.to_kernel_layout(canon), ours.numpy())


def test_supports_gate_is_rederived_for_hopper():
    # K % 128 and the 15 MiB VMEM budget are TPU limits and gate nothing here
    assert cs.supports(tagg.count_agg(), 1000, 64, 32, 4, 4)
    assert cs.supports(tagg.sum_agg(), 1 << 20, 64, 64, 4, 4)
    assert not ps.supports(jagg.sum_agg(), 1 << 20, 64, 64, 4, 1024)
    assert cs.supports(tagg.min_agg(), 8192, 64, 32, 4, 4)
    # up to 64 fire slots (a shared-partial group of 16 members at 4 fires
    # a step); a step descriptor's positions and rows are 16-bit
    assert cs.supports(tagg.count_agg(), 8192, 64, 32, 4, 20)
    assert cs.supports(tagg.count_agg(), 8192, 64, 32, 4, 64)
    assert not cs.supports(tagg.count_agg(), 8192, 64, 32, 4, 65)
    assert not cs.supports(tagg.count_agg(), 1000, 64, 1 << 17, 4, 4)
    assert not cs.supports(tagg.count_agg(), 1000, 1 << 17, 32, 4, 4)
    assert not cs.supports_global(tagg.count_agg(), 8, 16, 2, 17)
    # a field declared 64-bit computes in 32 bits, as in the JAX package
    # (x64 off), so K1 takes it; its dispatch equals the JAX package's
    assert cs.supports(tagg.sum_agg(np.float64), 8192, 64, 32, 4, 4)
    assert cs.supports_global(tagg.min_agg(np.float64), 8, 16, 2, 4)
    inp = _inputs(seed=5)
    _assert_same(_run_port(tagg.sum_agg(np.float64), inp, True),
                 _run_xla(jagg.sum_agg(np.float64), inp, True))


@pytest.mark.parametrize("name,dtype", [
    ("sum", np.float64), ("min", np.float64), ("max", np.float64), ("mean", np.float64),
    ("sum", np.int64),
])
def test_plain_matches_xla_step_on_64bit_fields(name, dtype):
    """ROADMAP C1: a 64-bit field runs in its 32-bit form, bit for bit as
    the JAX package's superscan step runs it with x64 off (its identity cast
    as jnp casts it). The pallas kernel itself refuses 64-bit refs, so the
    JAX package's XLA step is the reference here; an int64 min or max does
    not run there at all (its identity overflows int32)."""
    inp = _inputs(seed=6)
    port = _run_port(getattr(tagg, f"{name}_agg")(dtype), inp, True)
    _assert_same(port, _run_xla(getattr(jagg, f"{name}_agg")(dtype), inp, True))
    assert all(a.itemsize == 4 for a in port[1] + port[3])


@pytest.mark.parametrize("T_,K_,NSB_,nf", [
    (48, 8192, 4, 0),        # YSB
    (48, 1 << 20, 4, 0),     # three steps' partials fit the budget
    (48, 1 << 20, 4, 4),
    (7, 1 << 20, 16, 3),     # one step alone outgrows the budget
    (1, 1000, 3, 2),
    (0, 8192, 4, 0),
    (96, 1, 2, 1),
    (70_000, 1, 1, 0),       # the grid's step limit, not the budget, splits
])
def test_step_groups_cover_the_dispatch_within_the_budget(T_, K_, NSB_, nf):
    groups = cs.step_groups(T_, K_, NSB_, nf)
    steps = [t for t0, t1 in groups for t in range(t0, t1)]
    assert steps == list(range(T_))                      # exactly, in order
    assert all(t1 > t0 for t0, t1 in groups)
    one_step = cs.partial_bytes(1, K_, NSB_, nf)
    for t0, t1 in groups:
        size = cs.partial_bytes(t1 - t0, K_, NSB_, nf)
        assert size <= cs.PARTIAL_BUDGET or t1 - t0 == 1
    assert all(t1 - t0 <= cs.MAX_GROUP_STEPS for t0, t1 in groups)
    if one_step <= cs.PARTIAL_BUDGET and T_:
        # as few groups as the budget and the grid allow
        per = min(cs.MAX_GROUP_STEPS, cs.PARTIAL_BUDGET // one_step)
        assert len(groups) == -(-T_ // per)


def test_ysb_dispatch_takes_one_group():
    assert cs.step_groups(48, 8192, 4, 0) == [(0, 48)]
    # 6.3 MB of partials and 48 plan descriptors
    assert cs.partial_bytes(48, 8192, 4, 0) == 48 * 4 * 8192 * 4 + 48 * cs.STEP_DESC_BYTES
    assert len(cs.step_groups(48, 1 << 20, 4, 0)) == 16       # 3 steps a group


def test_global_blocks_cover_each_step():
    for B_ in (0, 1, 32767, 32768, 32769, 1 << 18):
        n = cs.global_blocks_per_step(B_)
        assert n >= 1 and n * cs.GLOBAL_CHUNK >= B_ and (n - 1) * cs.GLOBAL_CHUNK < max(B_, 1)
    assert cs.global_blocks_per_step(1 << 18) == 8                  # Q7
