"""Plain PyTorch superscans: the T-step ingest/fire/purge dispatch, and the
session programs.

Counterparts of `flink_tpu/ops/superscan.py::make_superscan_step` (with
`runtime/fused_window_pipeline.py::_build_superscan` around it) and
`make_global_scan_step`/`build_global_superscan`. They are the plain
versions of the Hopper kernels K1 and K2 (`ops/cuda_superscan.py`): the
CPU path, and the reference the kernels are held against on the card.
The session programs below (`session_*_plain`) are the plain versions of
kernels K3 and K4 (`ops/cuda_session.py`).

Ring layout is slice-major, `[S, K]` (the keyed kernel's layout, so a fire
reads `spws` contiguous K-wide rows); snapshots convert to the canonical
`[K, S]` of the JAX package. Both functions update the ring tensors in
place (the state carry never needs two copies) and return freshly
allocated fire rows.

Plan arrays (host-planned, all int32): smin [T] (ring column of the step's
lowest slice), fire_pos/fire_valid/fire_row [T, F], purge [T, S] (0 =
reset the column after the step).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from flink_tpu_torch.ops.aggregators import (
    VALUE,
    combine_binary,
    scan_identity,
    torch_dtype,
)


def value_fields(agg):
    """The aggregate's VALUE fields: each is one ring beside the count."""
    return [f for f in agg.fields if f.source == VALUE]


def field_kind(f) -> str:
    """'add' | 'max8' (bounded max, values clipped to [0, 255], identity
    -1) | 'min' | 'max'."""
    if f.scatter == "max" and f.domain_bits is not None and f.domain_bits <= 8:
        return "max8"
    return f.scatter


def _plan_host(plan):
    return [np.asarray(p.cpu()) for p in plan]


def keyed_superscan_plain(agg, count: torch.Tensor,
                          states: Sequence[torch.Tensor], idx: torch.Tensor,
                          vals, plan, *, NSB: int, R: int,
                          spws: Sequence[int], exact: bool
                          ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """One keyed T-step dispatch (the plain version of kernel K1).

    count [S, K] int32 and states (one [S, K] ring per VALUE field) are
    updated in place. idx [T*B] int32 holds `key_id * NSB + rel_slice`
    (negative = dropped); vals [T*B] float32 (None for count-only).
    Ingest lands a record in ring column (smin[t] + rel_slice) % S. After
    each step every valid fire slot f writes row clip(fire_row, 0, R-1): the
    fold over spws[f] columns from fire_pos. Then purged columns reset to
    the field's identity.

    Returns (count_out [R, K] int32, outs: one [R, K] per field); rows no
    fire wrote hold 0."""
    S, K = count.shape
    smin, fpos, fvalid, frow, purge = _plan_host(plan)
    T = smin.shape[0]
    F = fpos.shape[1]
    vfields = value_fields(agg)
    kinds = [field_kind(f) for f in vfields]
    dev = count.device
    idx2 = idx.reshape(T, -1)
    vals2 = vals.reshape(T, -1) if vfields else None
    count_out = torch.zeros((R, K), dtype=torch.int32, device=dev)
    outs = tuple(torch.zeros((R, K), dtype=torch_dtype(f.dtype), device=dev)
                 for f in vfields)
    flat_count = count.view(-1)
    flat_states = [s.view(-1) for s in states]
    for t in range(T):
        ii = idx2[t]
        kid = torch.div(ii, NSB, rounding_mode="floor")
        srel = ii - kid * NSB
        keep = (ii >= 0) & (kid < K)
        cell = ((int(smin[t]) + srel) % S * K + kid)[keep].long()
        flat_count.index_add_(0, cell, torch.ones_like(cell, dtype=torch.int32))
        if vfields:
            v = vals2[t][keep]
            # add fields without exact sums take the TPU kernel's one-term
            # bf16 form: the value is rounded to bf16 once before it is
            # accumulated; order statistics always see the raw value
            v_add = v if exact else v.to(torch.bfloat16).to(torch.float32)
        for kind, st in zip(kinds, flat_states):
            if kind == "add" and st.dtype.is_floating_point:
                st.index_add_(0, cell, v_add)
            elif kind == "add":
                # an int add field sums the step's records per cell in
                # float32 and casts each partial once, truncating toward
                # zero, as the JAX fused ingest does (`wacc.astype(dt)`)
                part = torch.zeros(st.numel(), dtype=torch.float32, device=dev)
                part.index_add_(0, cell, v_add)
                st.add_(part.to(st.dtype))
            elif kind == "max8":
                st.scatter_reduce_(0, cell, v.to(torch.int32).clamp(0, 255),
                                   "amax", include_self=True)
            else:
                st.scatter_reduce_(0, cell, v.to(st.dtype), "a" + kind,
                                   include_self=True)
        for f in range(F):
            if fvalid[t, f] <= 0:
                continue
            row = min(max(int(frow[t, f]), 0), R - 1)
            cols = [(int(fpos[t, f]) + w) % S for w in range(spws[f])]
            acc = count[cols[0]].clone()
            for c in cols[1:]:
                acc += count[c]
            count_out[row] = acc
            for kind, st, out in zip(kinds, states, outs):
                comb = combine_binary("max" if kind == "max8" else kind)
                acc = st[cols[0]].clone()
                for c in cols[1:]:
                    acc = comb(acc, st[c])
                out[row] = acc
        dead = np.flatnonzero(purge[t] == 0)
        if dead.size:
            dead_t = torch.from_numpy(dead).to(dev)
            count[dead_t] = 0
            for f, st in zip(vfields, states):
                st[dead_t] = f.device_identity
    return count_out, outs


def global_superscan_plain(agg, count: torch.Tensor,
                           states: Sequence[torch.Tensor], idx: torch.Tensor,
                           vals, plan, *, NSB: int, R: int,
                           spws: Sequence[int]
                           ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """One global-window T-step dispatch (the plain version of kernel K2).

    The key is folded out: count [S] int32 and states (one [S] ring per
    VALUE field, at the field's scan identity where empty) are updated in
    place. A record's rel-slice is idx % NSB (bare rel-slices and the keyed
    `kid * NSB + srel` encoding both fold the same; negative idx drops).
    Fire slot f folds the spws[f] lanes from fire_pos into scalar row
    clip(fire_row, 0, R-1); purge resets a lane to the scan identity.

    Returns (count_out [R] int32, outs: one [R] per field at identity where
    no fire wrote)."""
    (S,) = count.shape
    smin, fpos, fvalid, frow, purge = _plan_host(plan)
    T = smin.shape[0]
    F = fpos.shape[1]
    vfields = value_fields(agg)
    dev = count.device
    idx2 = idx.reshape(T, -1)
    vals2 = vals.reshape(T, -1) if vfields else None
    idents = [scan_identity(np.dtype(f.dtype), f.scatter) for f in vfields]
    count_out = torch.zeros((R,), dtype=torch.int32, device=dev)
    outs = tuple(torch.full((R,), ident, dtype=torch_dtype(f.dtype), device=dev)
                 for f, ident in zip(vfields, idents))
    for t in range(T):
        ii = idx2[t]
        srel = torch.where(ii >= 0, torch.remainder(ii, NSB), -1)
        for sr in range(NSB):
            sel = srel == sr
            col = (int(smin[t]) + sr) % S
            count[col] += sel.sum().to(torch.int32)
            for f, ident, st in zip(vfields, idents, states):
                lane = torch.where(sel, vals2[t].to(st.dtype),
                                   torch.tensor(ident, dtype=st.dtype, device=dev))
                if f.scatter == "add":
                    st[col] += lane.sum().to(st.dtype)
                else:
                    part = lane.amin() if f.scatter == "min" else lane.amax()
                    st[col] = combine_binary(f.scatter)(st[col], part)
        for f in range(F):
            if fvalid[t, f] <= 0:
                continue
            row = min(max(int(frow[t, f]), 0), R - 1)
            cols = torch.tensor([(int(fpos[t, f]) + w) % S
                                 for w in range(spws[f])], device=dev)
            count_out[row] = count[cols].sum().to(torch.int32)
            for fl, st, out in zip(vfields, states, outs):
                cells = st[cols]
                if fl.scatter == "add":
                    out[row] = cells.sum().to(st.dtype)
                else:
                    out[row] = cells.amin() if fl.scatter == "min" else cells.amax()
        dead = np.flatnonzero(purge[t] == 0)
        if dead.size:
            dead_t = torch.from_numpy(dead).to(dev)
            count[dead_t] = 0
            for st, ident in zip(states, idents):
                st[dead_t] = ident
    return count_out, outs


# ---------------------------------------------------------------------------
# session windows: per-slice fragments and the touching-fragment gap-merge
# (runtime/tpu_session_operator.py drives these)
# ---------------------------------------------------------------------------
#
# Session rings are slice-major, [S, K], like K1's: the fragment count
# (int32), its min and max ms relative to the slice start (int32, empty:
# g and -1), and one ring per VALUE field. A merge returns the sessions it
# closed as one packed int32 array (`packed_size`, `unpack_sessions`): M
# slots per key of the start and end ms (int64, relative to the merge's
# base slice, so any gap and span fit) as [2, M, K], then of the count and
# each field's bits (int32) as [1 + nf, M, K]; each key's number of used
# slots, [K]; then four scalars (lo_rel, hi_rel, overflow, 0). Slots no
# session uses hold 0.

def packed_size(K: int, M: int, nf: int) -> int:
    """Length of a merge's packed result, in int32 words."""
    return ((5 + nf) * M + 1) * K + 4


def unpack_sessions(packed, K: int, M: int, nf: int):
    """Views of a flat packed result (numpy array or tensor): (times [2, M, K]
    int64 start and end, blocks [1 + nf, M, K] count and field bits, used
    slots [K], scalars (lo_rel, hi_rel, overflow))."""
    t = 4 * M * K
    n = t + (1 + nf) * M * K
    wide = np.int64 if isinstance(packed, np.ndarray) else torch.int64
    return (packed[:t].view(wide).reshape(2, M, K), packed[t:n].reshape(1 + nf, M, K),
            packed[n:n + K], packed[n + K:n + K + 3])


def session_ingest_plain(cnt, mn, mx, fields, kid, spos, rel, vals, vfields) -> None:
    """One batch of session records into the rings, in place (the plain
    version of kernel K3; `session_ingest_scatter` of the JAX package).

    kid, spos, rel int32 and vals float32, any shape. A record whose kid
    lies outside [0, K) (or spos outside [0, S)) is dropped. Each record
    adds 1 to the count of cell (spos, kid), folds rel into its min and
    max, and combines its value, cast to the field's dtype as numpy's
    astype casts (to int32: truncated toward zero), into each field."""
    S, K = cnt.shape
    kid, spos = kid.reshape(-1), spos.reshape(-1)
    keep = (kid >= 0) & (kid < K) & (spos >= 0) & (spos < S)
    cell = (spos.long() * K + kid.long())[keep]
    if cell.numel() == 0:
        return
    r = rel.reshape(-1)[keep]
    cnt.view(-1).index_add_(0, cell, torch.ones_like(cell, dtype=torch.int32))
    mn.view(-1).scatter_reduce_(0, cell, r, "amin")
    mx.view(-1).scatter_reduce_(0, cell, r, "amax")
    v = vals.reshape(-1)[keep]
    for (_n, _dt, scatter), f in zip(vfields, fields):
        if scatter == "add":
            f.view(-1).index_add_(0, cell, v.to(f.dtype))
        else:
            f.view(-1).scatter_reduce_(0, cell, v.to(f.dtype), "a" + scatter)


def session_fresh_slots(K: int, M: int, field_dtypes, device):
    """Empty emission slots for a merge (the `est` carry):
    (slots [K], e_start, e_end [M, K] int64, e_cnt, e_s0, e_s1 [M, K] int32,
    e_flds one [M, K] per field, overflow)."""
    z = lambda dt=torch.int32: torch.zeros((M, K), dtype=dt, device=device)  # noqa: E731
    return (torch.zeros(K, dtype=torch.int32, device=device), z(torch.int64), z(torch.int64),
            z(), z(),
            torch.full((M, K), -1, dtype=torch.int32, device=device),
            [z(dt) for dt in field_dtypes], torch.zeros((), dtype=torch.bool, device=device))


def session_gap_merge_scan_plain(c, fmn, fmx, fl, vfields, idents, g: int, wm_rel, est):
    """The touching-fragment gap-merge over n gathered slice columns, every
    key at once (`session_gap_merge_scan` of the JAX package, slice-major).

    c [n, K] int32 (fragment count; c == 0 is a gap), fmn, fmx [n, K] int64
    (min and max ms relative to the scan's base) and fl (one [n, K] per
    field). A fragment
    joins the key's open session iff its min is at most g after the
    session's max (touching windows merge); otherwise it closes the open
    session and starts one. At the end a session closes iff its max + g - 1
    <= wm_rel. Each closed session goes to its key's next slot of `est`
    (see `session_fresh_slots`), with its column range in e_s0/e_s1; a key
    with no slot left sets overflow. Returns the updated est."""
    n, K = c.shape
    M = est[1].shape[0]
    dev = c.device
    i32 = torch.int32
    mslots = torch.arange(M, dtype=i32, device=dev)[:, None]
    combine = [combine_binary(sc) for _n, _dt, sc in vfields]
    open_ = torch.zeros(K, dtype=torch.bool, device=dev)
    cmin = torch.zeros(K, dtype=torch.int64, device=dev)
    cmax = torch.full((K,), -(1 << 30), dtype=torch.int64, device=dev)
    ccnt = torch.zeros(K, dtype=i32, device=dev)
    cstart = torch.zeros(K, dtype=i32, device=dev)
    clast = torch.zeros(K, dtype=i32, device=dev)
    cflds = [torch.full((K,), ident, dtype=f.dtype, device=dev) for f, ident in zip(fl, idents)]

    def do_emit(mask, est):
        (slots, e_start, e_end, e_cnt, e_s0, e_s1, e_flds, overflow) = est
        can = mask & (slots < M)
        oh = (mslots == slots[None, :]) & can[None, :]            # [M, K]
        e_start = torch.where(oh, cmin[None, :], e_start)
        e_end = torch.where(oh, cmax[None, :], e_end)
        e_cnt = torch.where(oh, ccnt[None, :], e_cnt)
        e_s0 = torch.where(oh, cstart[None, :], e_s0)
        e_s1 = torch.where(oh, clast[None, :], e_s1)
        e_flds = [torch.where(oh, cf[None, :], ef) for cf, ef in zip(cflds, e_flds)]
        overflow = overflow | (mask & (slots >= M)).any()
        slots = slots + can.to(i32)
        return (slots, e_start, e_end, e_cnt, e_s0, e_s1, e_flds, overflow)

    for i in range(n):
        ci = c[i]
        frag = ci > 0
        mni, mxi = fmn[i], fmx[i]
        joins = open_ & frag & (mni - cmax <= g)
        est = do_emit(open_ & frag & ~joins, est)
        starts = frag & ~joins
        cmin = torch.where(starts, mni, cmin)
        ccnt = torch.where(starts, 0, ccnt)
        cstart = torch.where(starts, i, cstart)
        cflds = [torch.where(starts, ident, cf) for cf, ident in zip(cflds, idents)]
        open_ = open_ | frag
        cmax = torch.where(frag, mxi, cmax)
        ccnt = torch.where(frag, ccnt + ci, ccnt)
        clast = torch.where(frag, i, clast)
        cflds = [torch.where(frag, comb(cf, fi[i]), cf)
                 for comb, cf, fi in zip(combine, cflds, fl)]
    return do_emit(open_ & (cmax + g - 1 <= wm_rel), est)


def _covered(idx, e_s0, e_s1, use):
    """[n, K]: columns inside the range of a session in a used slot."""
    col = idx[None, :, None]
    return ((col >= e_s0[:, None, :]) & (col <= e_s1[:, None, :]) & use[:, None, :]).any(0)


def _pack(est, lo, hi) -> torch.Tensor:
    (slots, e_start, e_end, e_cnt, _s0, _s1, e_flds, overflow) = est
    times = torch.stack([e_start, e_end]).reshape(-1).view(torch.int32)
    blocks = [e_cnt] + [ef if ef.dtype == torch.int32 else ef.view(torch.int32) for ef in e_flds]
    scal = torch.stack([lo.to(torch.int32), hi.to(torch.int32), overflow.to(torch.int32),
                        torch.zeros((), dtype=torch.int32, device=slots.device)])
    return torch.cat([times, torch.stack(blocks).reshape(-1), slots, scal])


def _check_packable(fields) -> None:
    for f in fields:
        if f.dtype not in (torch.int32, torch.float32):
            raise TypeError(f"a packed session merge takes int32/float32 fields, not {f.dtype}")


def session_merge_plain(cnt, mn, mx, fields, pos, valid, wm_rel: int, *, g: int, M: int,
                        vfields, idents) -> torch.Tensor:
    """The per-watermark session merge, in place (the plain version of
    kernel K4 in per-watermark mode; `_build_merge_scan` of the JAX
    package's session operator).

    pos int32 [P]: the ring positions of the resident span's slices in
    order, padded with repeats of the last; valid [P]: the span's own
    columns (None: all P, which are then distinct). Times are ms relative to
    the span's first slice; wm_rel any integer. Gathers the
    span, runs the gap-merge with M fresh slots per key, resets the cells
    of every closed session to the identities (written back through the
    valid columns only, so a pad repeat never undoes a purge) and returns
    the packed result, whose lo_rel/hi_rel are the first and last column
    that still holds a fragment (P and -1 if none)."""
    _check_packable(fields)
    S, K = cnt.shape
    dev = cnt.device
    P = pos.numel()
    p = pos.long()
    vm = torch.ones(P, dtype=torch.bool, device=dev) if valid is None else valid.bool()
    idx = torch.arange(P, dtype=torch.int32, device=dev)
    c = torch.where(vm[:, None], cnt[p], 0)
    off = idx[:, None].long() * g
    fl = [f[p] for f in fields]
    est = session_fresh_slots(K, M, [f.dtype for f in fields], dev)
    est = session_gap_merge_scan_plain(c, mn[p] + off, mx[p] + off, fl, vfields, idents, g,
                                       wm_rel, est)
    used = torch.arange(M, dtype=torch.int32, device=dev)[:, None] < est[0][None, :]
    purge = _covered(idx, est[4], est[5], used) & vm[:, None]
    c_new = torch.where(purge, 0, c)
    w = p[vm]                                  # the span's distinct positions
    cnt[w] = c_new[vm]
    mn[w] = torch.where(purge, g, mn[p])[vm]
    mx[w] = torch.where(purge, -1, mx[p])[vm]
    for f, fv, ident in zip(fields, fl, idents):
        f[w] = torch.where(purge, ident, fv)[vm]
    live = (c_new > 0).any(1) & vm
    lo = torch.where(live, idx, P).min()
    hi = torch.where(live, idx, -1).max()
    return _pack(est, lo, hi)


def session_live_bounds(cnt, lo_pos: int, lo_rel: int):
    """(lo, hi) int32 scalars: the first and last slice, relative to the
    ring base (position lo_pos is slice lo_rel), that holds a fragment of
    any key; (0, -1) if none. Torch code on the ring's device."""
    S = cnt.shape[0]
    idx = torch.arange(S, dtype=torch.int32, device=cnt.device)
    live = (cnt[((lo_pos + idx) % S).long()] > 0).any(1)
    abs_rel = lo_rel + idx
    lo = torch.where(live, abs_rel, 1 << 30).min()
    hi = torch.where(live, abs_rel, -1).max()
    return torch.where(hi >= 0, lo, 0), hi


def session_superscan_plain(cnt, mn, mx, fields, kid, spos, rel, vals, merge_flag, lo_pos,
                            lo_rel, wm_rel, *, g: int, M: int, vfields, idents) -> torch.Tensor:
    """A fused session superspan, in place (the plain version of the K3/K4
    dispatch; `make_session_superscan` of the JAX package).

    kid, spos, rel, vals [T, B] as `session_ingest_plain` takes them;
    merge_flag, lo_pos, lo_rel, wm_rel: T host integers (wm_rel any integer). Step t ingests its
    records, then, where merge_flag[t], gap-merges the whole ring from
    position lo_pos[t] (slice lo_rel[t] relative to the dispatch base) at
    wm_rel[t]: closed sessions take the next of M slots per key, carried
    across the dispatch's merges, and only this merge's sessions are purged.
    The packed result's lo_rel/hi_rel are the live bounds of the final ring
    from the last step's lo_pos/lo_rel."""
    _check_packable(fields)
    S, K = cnt.shape
    dev = cnt.device
    idx = torch.arange(S, dtype=torch.int32, device=dev)
    ms = torch.arange(M, dtype=torch.int32, device=dev)[:, None]
    est = session_fresh_slots(K, M, [f.dtype for f in fields], dev)
    for t in range(kid.shape[0]):
        session_ingest_plain(cnt, mn, mx, fields, kid[t], spos[t], rel[t], vals[t], vfields)
        if not merge_flag[t]:
            continue
        p = ((int(lo_pos[t]) + idx) % S).long()     # the full ring, a permutation
        off = (int(lo_rel[t]) + idx)[:, None].long() * g
        c = cnt[p]
        fl = [f[p] for f in fields]
        slots_in = est[0]
        est = session_gap_merge_scan_plain(c, mn[p] + off, mx[p] + off, fl, vfields, idents,
                                           g, int(wm_rel[t]), est)
        this = (ms >= slots_in[None, :]) & (ms < est[0][None, :])
        purge = _covered(idx, est[4], est[5], this)
        cnt[p] = torch.where(purge, 0, c)
        mn[p] = torch.where(purge, g, mn[p])
        mx[p] = torch.where(purge, -1, mx[p])
        for f, fv, ident in zip(fields, fl, idents):
            f[p] = torch.where(purge, ident, fv)
    lo, hi = session_live_bounds(cnt, int(lo_pos[-1]), int(lo_rel[-1]))
    return _pack(est, lo, hi)
