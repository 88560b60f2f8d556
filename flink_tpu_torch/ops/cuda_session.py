"""Hopper kernels K3 (session ingest) and K4 (session gap-merge).

Counterparts of the JAX package's session programs, which are XLA
programs with no Pallas form: `flink_tpu/ops/superscan.py::
session_ingest_scatter`, `::session_gap_merge_scan` with
`runtime/tpu_session_operator.py::_build_merge_scan` around it, and
`::make_session_superscan`. Both kernels are in
`flink_tpu_torch/csrc/session_superscan.cu`, built and bound with K1 and
K2 (`ops/cuda_superscan.py::build`/`bind`).

K3 takes the launch's slice window from the caller (the step bounds the
session operator already holds). Where the window's cells of all keys fit
`K3_MAX_TILES` key tiles of shared memory and the launch has at least
`K3_TILED_MIN_RECORDS` records (`k3_plan`), clusters of K3_CLUSTER CTAs
land the records in private shared-memory tiles, fold them over
distributed shared memory and merge them into the ring with one plain
read-modify-write a touched cell, through partials and a second kernel
(`k3_merge_parts`) where a tile's records are split over several clusters
(`k3_session_ingest`); otherwise, one pass of device atomics
(`k3_session_ingest_atomic`). K4 stages each
32-key tile's occupied cells into shared memory and writes the whole
packed result itself, its slots, live bounds and overflow flag included:
a superspan or a per-watermark merge launches into a `torch.empty` buffer,
with no torch code between its launches (a stream's first launch, or one
that needs a larger scratch, makes the scratch). Bounds: bytes (the
kernel source's header).

The wrappers take the plain PyTorch versions (`ops/superscan.py`) only for
tensors that lie on the CPU. For CUDA tensors they launch the kernels or
raise; nothing falls back. `LAUNCHES` counts each kernel launch on the
card, K3's two routes and the tiled route's partials merge under their
own names. Rings are the slice-major
[S, K] int32/float32 tensors of the session operator, updated in place;
vfields are the aggregate's value fields as (name, dtype name, scatter),
idents their identities. The ctypes form of a ring set is built once and
kept while its tensors live; the kernels' attributes are set, and the
card's SM count and the clusters it holds at once read, once per device.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import weakref
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from flink_tpu_torch.ops import cuda_superscan as cs
from flink_tpu_torch.ops.aggregators import torch_dtype
from flink_tpu_torch.ops.superscan import (
    packed_size,
    session_ingest_plain,
    session_merge_plain,
    session_superscan_plain,
)

#: kernel launches on the card (plain-version and CPU calls do not count)
LAUNCHES: Dict[str, int] = {"k3_session_ingest": 0, "k3_session_ingest_atomic": 0,
                            "k3_merge_parts": 0, "k4_session_merge": 0}

#: K3's tiled route: keys go to tiles in runs of this many
K3_RUN = 32
#: shared memory of one tiled CTA's copy of its tile, at most
#: (K3_TILE_SMEM in csrc/session_superscan.cu)
K3_SMEM = 200 * 1024
#: key tiles a tiled launch may take; past it the records, which each
#: tile's cluster reads whole, cost more than K3's atomic route
K3_MAX_TILES = 16
#: CTAs of one cluster of the tiled route (K3_CLUSTER in the source)
K3_CLUSTER = 4
#: clusters a tile's records split over, at most (K3_MAX_PARTS in the source)
K3_MAX_PARTS = 16
#: records a launch needs for the tiled route: below it the tiles' fixed
#: cost (each CTA's tile set to the identities and folded) is more than the
#: atomic route's whole launch (`chip_smoke.py::session_kernel_times` times
#: both routes at 65536 session records)
K3_TILED_MIN_RECORDS = 1 << 18
#: keys (threads) of one K4 tile, a warp (K4_WARPS tiles a CTA in the source)
K4_KEYS = 32
#: shared memory of one K4 tile's staged chunk of columns, at most
K4_STAGE_SMEM = 32 * 1024

# K4's flags (the source's K4_*)
K4_MERGE, K4_INIT, K4_BOUNDS_PW, K4_BOUNDS_SS = 1, 2, 4, 8
_I32_MIN, _I32_MAX = -(1 << 31), (1 << 31) - 1
#: the per-stream scratch: K4's [lo, hi, overflow, ticket] at 0 (kept at
#: {INT_MAX, INT_MIN, 0, 0} between launches), K3's partials from K3_PARTS
K3_PARTS = 4


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def k3_launches(launches: Optional[Dict[str, int]] = None) -> int:
    """K3 launches over both routes (of `launches`, default LAUNCHES): one
    a wrapper's ingest, whose tiled route may add a `k3_merge_parts`."""
    d = LAUNCHES if launches is None else launches
    return d["k3_session_ingest"] + d["k3_session_ingest_atomic"]


def _kinds(vfields) -> list:
    return [cs._KIND_CODES.get((sc, np.dtype(dt)), -1) for _n, dt, sc in vfields]


def supports(vfields) -> bool:
    """Whether K3/K4 take these value fields: at most 4, each an add, min
    or max of float32 or int32 (a field declared 64-bit arrives here in
    its 32-bit device dtype)."""
    return len(vfields) <= cs.MAX_FIELDS and all(k >= 0 for k in _kinds(vfields))


# ---------------------------------------------------------------------------
# host planning (pure functions, tested on the CPU)
# ---------------------------------------------------------------------------

def k3_window(bounds, S: int) -> Tuple[int, int]:
    """(p0, W): the ring positions of a launch whose records lie in the
    absolute slices of `bounds` ((smin, smax) pairs, inclusive): W
    positions from p0, wrapping past S; all S where the slices span S or
    more, or where there are no bounds (None)."""
    if not bounds:
        return 0, S
    lo = min(int(b[0]) for b in bounds)
    hi = max(int(b[1]) for b in bounds)
    if hi < lo:
        return 0, S
    return lo % S, min(hi - lo + 1, S)


@functools.lru_cache(maxsize=256)
def k3_plan(K: int, W: int, nf: int, clusters: int) -> Tuple[int, int, int]:
    """(NT, Q, KT) of a K3 launch over W window positions of K keys with nf
    value fields on a card that holds `clusters` clusters of the tiled
    route at once. NT key tiles, a power of two, each KT local keys (whole
    runs of K3_RUN keys, dealt round-robin, so a key's tile is a mask of
    its run): the fewest whose cells ((3 + nf) int32 arrays of W x KT) fit
    K3_SMEM, since every tile's clusters read all the records. Each tile's
    records split over Q clusters of K3_CLUSTER CTAs, as many as the card
    holds in one wave (at most K3_MAX_PARTS). NT = 0: the atomic route (the
    tiles would pass K3_MAX_TILES)."""
    runs = -(-K // K3_RUN)
    per_key = (3 + nf) * W * 4
    nt = 1
    while K3_RUN * -(-runs // nt) * per_key > K3_SMEM:
        nt *= 2
        if nt > K3_MAX_TILES:
            return 0, 0, 0
    return nt, max(1, min(K3_MAX_PARTS, clusters // nt)), K3_RUN * -(-runs // nt)


def k3_scratch_words(K: int, W: int, nf: int, plan) -> int:
    """int32 words of the scratch a K3 launch of `plan` (k3_plan's) needs:
    K4's four, then the Q partials of each of the NT tiles."""
    nt, q, kt = plan
    return K3_PARTS + (nt * q * (3 + nf) * W * kt if nt and q > 1 else 0)


def k4_chunk(n: int, nf: int) -> int:
    """Columns of one staged K4 chunk: as many as a 32-key tile's cells of
    every ring fit K4_STAGE_SMEM, at most 64 (a chunk's live columns are
    two 32-bit masks) and at most n (1 for n = 0)."""
    per_col = (3 + nf) * K4_KEYS * 4
    return max(1, min(n, 64, K4_STAGE_SMEM // per_col))


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _prepare(lib, index: int) -> int:
    """Sets the kernels' attributes on device `index`, once, before its
    first launch there; returns the clusters of the tiled ingest it holds
    at once (its tiles at their largest)."""
    with torch.cuda.device(index):
        n = lib.session_prepare()
    if n < 0:
        raise RuntimeError(f"session_prepare failed: CUDA error {-n}")
    return max(n, 1)


class _Head:
    """The ctypes form of one ring set and its value fields."""

    def __init__(self, cnt, mn, mx, fields, vfields, idents):
        S, K = cnt.shape
        dev = cnt.device
        for name, t in (("cnt", cnt), ("mn", mn), ("mx", mx)):
            cs._check(t, name, torch.int32, (S, K), dev)
        if len(fields) != len(vfields):
            raise ValueError(f"{len(fields)} field rings for {len(vfields)} fields")
        for (name, dt, _sc), f in zip(vfields, fields):
            cs._check(f, f"field {name!r}", torch_dtype(dt), (S, K), dev)
        if not supports(vfields):
            raise NotImplementedError(
                f"kernels K3/K4 do not take value fields {vfields}: float32/int32 "
                "add, min and max fields only, at most 4")
        nf = len(fields)
        self.dev, self.S, self.K, self.nf = dev, S, K, nf
        self.refs = [weakref.ref(t) for t in (cnt, mn, mx, *fields)]
        self.ptrs = [t.data_ptr() for t in (cnt, mn, mx, *fields)]
        self.rings = (self.ptrs[0], self.ptrs[1], self.ptrs[2],
                      (ctypes.c_void_p * max(nf, 1))(*self.ptrs[3:]),
                      (ctypes.c_int * max(nf, 1))(*_kinds(vfields)))
        self.idents = (ctypes.c_int * max(nf, 1))(
            *[cs._bits(i, dt) for i, (_n, dt, _s) in zip(idents, vfields)])
        self.sms = _sms(dev.index)
        self.lib = cs._library("session_superscan")
        self.clusters = _prepare(self.lib, dev.index)

    def holds(self, tensors) -> bool:
        return all(r() is t and t.data_ptr() == p
                   for r, t, p in zip(self.refs, tensors, self.ptrs))


_HEADS: Dict[tuple, _Head] = {}
#: per (device, stream): the kernels' int32 scratch (K3_PARTS)
_SCRATCH: Dict[Tuple[int, int], torch.Tensor] = {}


def _head(cnt, mn, mx, fields, vfields, idents) -> _Head:
    """The ring set's head: built (and checked) once, kept while its
    tensors live."""
    tensors = (cnt, mn, mx, *fields)
    key = (tuple(id(t) for t in tensors), tuple(vfields), tuple(idents))
    h = _HEADS.get(key)
    if h is None or not h.holds(tensors):
        if cnt.device.type != "cuda":
            raise ValueError(f"no session kernel for device {cnt.device}")
        for k in [k for k, v in _HEADS.items() if v.refs[0]() is None]:
            del _HEADS[k]                      # ring sets that are gone
        h = _HEADS[key] = _Head(cnt, mn, mx, fields, vfields, idents)
    return h


def _stream(dev) -> int:
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)   # the cheap form
    return raw(dev.index) if raw is not None else torch.cuda.current_stream(dev).cuda_stream


def _scratch(dev, stream: int, words: int = K3_PARTS) -> int:
    """The address of the stream's scratch of at least `words` int32s. A
    new one (the first, or a larger) takes its head from the host: K4's
    {INT_MAX, INT_MIN, 0, 0}, which each K4 launch leaves as it found it.
    The old one is freed to the caching allocator, which gives it only to
    later work on this stream."""
    key = (dev.index, stream)
    s = _SCRATCH.get(key)
    if s is None or s.numel() < words:
        s = torch.empty(max(words, 2 * (0 if s is None else s.numel())), dtype=torch.int32,
                        device=dev)
        head = torch.zeros(K3_PARTS, dtype=torch.int32)
        head[:2] = torch.tensor([_I32_MAX, _I32_MIN])
        s[:K3_PARTS].copy_(head)
        _SCRATCH[key] = s
    return s.data_ptr()


def _records(h: _Head, kid, spos, rel, vals) -> int:
    n = kid.numel()
    for name, t, dt in (("kid", kid, torch.int32), ("spos", spos, torch.int32),
                        ("rel", rel, torch.int32), ("vals", vals, torch.float32)):
        if t.device != h.dev or t.dtype != dt or t.numel() != n or not t.is_contiguous():
            raise ValueError(f"{name}: {n} contiguous {dt} values on {h.dev} expected, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    return n


def _ingest(h: _Head, ptrs, n: int, window, stream: int) -> None:
    """One K3 launch over n records at ptrs (kid, spos, rel, vals), its
    route chosen by shape."""
    if n == 0:
        return                                 # nothing to launch
    p0, W = k3_window(window, h.S)
    plan = k3_plan(h.K, W, h.nf, h.clusters) if n >= K3_TILED_MIN_RECORDS else (0, 0, 0)
    _launch_k3(h, ptrs, n, p0, W, plan, stream)


def _launch_k3(h: _Head, ptrs, n: int, p0: int, W: int, plan, stream: int) -> None:
    """K3 over n > 0 records at ptrs in the route of `plan` (k3_plan's;
    NT = 0: atomic), over the W window positions from p0."""
    nt, q, kt = plan
    scratch = _scratch(h.dev, stream, k3_scratch_words(h.K, W, h.nf, plan))
    rc = h.lib.k3_session_ingest(*h.rings, h.nf, *ptrs, n, h.K, h.S, p0, W, nt, q, kt,
                                 scratch + 4 * K3_PARTS, h.sms, stream)
    name = "k3_session_ingest" if nt else "k3_session_ingest_atomic"
    if rc != 0:
        raise RuntimeError(f"{name} failed to launch: CUDA error {rc}")
    LAUNCHES[name] += 1
    if nt and q > 1:
        LAUNCHES["k3_merge_parts"] += 1


def _merge(h: _Head, pos, p0: int, n: int, r0: int, g: int, wm_rel: int, M: int, packed,
           flags: int, bpos: int, brel: int, scratch: int, stream: int) -> None:
    rc = h.lib.k4_session_merge(*h.rings, h.idents, h.nf, pos, p0, n, r0, g, wm_rel, M,
                                packed, flags, bpos, brel, h.K, h.S, k4_chunk(n, h.nf),
                                scratch, stream)
    if rc != 0:
        raise RuntimeError(f"k4_session_merge failed to launch: CUDA error {rc}")
    LAUNCHES["k4_session_merge"] += 1


def _on(dev):
    """The device guard, where the current device is another."""
    return contextlib.nullcontext() if dev.index == torch.cuda.current_device() else \
        torch.cuda.device(dev)


def session_ingest(cnt, mn, mx, fields, kid, spos, rel, vals, vfields,
                   window: Optional[Tuple[int, int]] = None) -> None:
    """Ingest a batch of session records (kid, spos, rel int32, vals
    float32, one shape): kernel K3 on CUDA tensors, `session_ingest_plain`
    (same contract) on CPU tensors. window: the absolute slices (smin,
    smax) the records lie in, which the tiled route holds in shared memory
    (None: K3's atomic route); the plain version ignores it."""
    if cnt.device.type == "cpu":
        return session_ingest_plain(cnt, mn, mx, fields, kid, spos, rel, vals, vfields)
    h = _head(cnt, mn, mx, fields, vfields, ())
    kid, spos, rel, vals = (x.contiguous() for x in (kid, spos, rel, vals))
    n = _records(h, kid, spos, rel, vals)
    with _on(h.dev):
        _ingest(h, (kid.data_ptr(), spos.data_ptr(), rel.data_ptr(), vals.data_ptr()), n,
                None if window is None else [window], _stream(h.dev))


def session_merge(cnt, mn, mx, fields, pos, wm_rel: int, *, g: int, M: int,
                  vfields, idents: Sequence) -> torch.Tensor:
    """One per-watermark gap-merge over the resident span: pos int32 [P],
    the ring positions of its slices in order (distinct), wm_rel an int64
    ms relative to the first. Kernel K4 on CUDA tensors (one launch into a
    `torch.empty` result), `session_merge_plain` (same contract and packed
    result, all P columns valid) on CPU tensors."""
    if cnt.device.type == "cpu":
        return session_merge_plain(cnt, mn, mx, fields, pos, None, wm_rel, g=g, M=M,
                                   vfields=vfields, idents=idents)
    h = _head(cnt, mn, mx, fields, vfields, idents)
    P = pos.numel()
    if pos.device != h.dev or pos.dtype != torch.int32 or pos.dim() != 1 or \
            not pos.is_contiguous():
        raise ValueError(f"pos: a contiguous int32 vector on {h.dev} expected")
    packed = torch.empty(packed_size(h.K, M, h.nf), dtype=torch.int32, device=h.dev)
    with _on(h.dev):
        stream = _stream(h.dev)
        _merge(h, pos.data_ptr(), 0, P, 0, g, wm_rel, M, packed.data_ptr(),
               K4_MERGE | K4_INIT | K4_BOUNDS_PW, 0, 0, _scratch(h.dev, stream), stream)
    return packed


def ingest_runs(merge_flag) -> list:
    """The superspan's steps as consecutive runs [t0, t1], each ending at a
    merge step or at the last step: one K3 launch each, the run's ingests
    commuting (add, min, max), then K4 where the run ends at a merge."""
    runs, t0 = [], 0
    T = len(merge_flag)
    for t in range(T):
        if merge_flag[t] or t == T - 1:
            runs.append((t0, t))
            t0 = t + 1
    return runs


def session_superscan(cnt, mn, mx, fields, kid, spos, rel, vals, merge_flag, lo_pos, lo_rel,
                      wm_rel, *, g: int, M: int, vfields, idents: Sequence,
                      step_bounds=None) -> torch.Tensor:
    """A fused session superspan ([T, B] records; T host plan integers per
    list, wm_rel int64): on CUDA tensors one K3 launch per run of
    `ingest_runs` (over the run's window of `step_bounds`, T (smin, smax)
    absolute slice pairs; None: K3's atomic route) and one K4 launch per
    merge into a `torch.empty` result, the first writing every slot, the
    slots carried across the merges; where the last step is no merge, one
    more K4 launch reads the final ring's live bounds. The plain version
    `session_superscan_plain` (same contract and packed result, step_bounds
    ignored) on CPU tensors."""
    if cnt.device.type == "cpu":
        return session_superscan_plain(cnt, mn, mx, fields, kid, spos, rel, vals, merge_flag,
                                       lo_pos, lo_rel, wm_rel, g=g, M=M, vfields=vfields,
                                       idents=idents)
    h = _head(cnt, mn, mx, fields, vfields, idents)
    kid, spos, rel, vals = (x.contiguous() for x in (kid, spos, rel, vals))
    _records(h, kid, spos, rel, vals)
    T = int(kid.shape[0])
    B = kid.numel() // max(T, 1)
    base = [x.data_ptr() for x in (kid, spos, rel, vals)]   # 4-byte records, [T, B]
    bpos, brel = int(lo_pos[-1]), int(lo_rel[-1])
    packed = torch.empty(packed_size(h.K, M, h.nf), dtype=torch.int32, device=h.dev)
    out = packed.data_ptr()
    with _on(h.dev):
        stream = _stream(h.dev)
        init = K4_INIT
        for t0, t1 in ingest_runs(merge_flag):
            _ingest(h, [p + 4 * t0 * B for p in base], (t1 - t0 + 1) * B,
                    None if step_bounds is None else step_bounds[t0:t1 + 1], stream)
            if merge_flag[t1]:
                _merge(h, None, int(lo_pos[t1]), h.S, int(lo_rel[t1]), g, int(wm_rel[t1]), M,
                       out, K4_MERGE | init | K4_BOUNDS_SS, bpos, brel,
                       _scratch(h.dev, stream), stream)
                init = 0
        if not merge_flag[T - 1]:
            # the live bounds of the ring after the last ingest
            _merge(h, None, bpos, h.S, brel, g, 0, M, out, init | K4_BOUNDS_SS, bpos, brel,
                   _scratch(h.dev, stream), stream)
    return packed
