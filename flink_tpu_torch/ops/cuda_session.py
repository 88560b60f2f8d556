"""Hopper kernels K3 (session ingest) and K4 (session gap-merge).

Counterparts of the JAX package's session programs, which are XLA
programs with no Pallas form: `flink_tpu/ops/superscan.py::
session_ingest_scatter`, `::session_gap_merge_scan` with
`runtime/tpu_session_operator.py::_build_merge_scan` around it, and
`::make_session_superscan`. Both kernels are in
`flink_tpu_torch/csrc/session_superscan.cu`, built and bound with K1 and
K2 (`ops/cuda_superscan.py::build`/`bind`).

The wrappers take the plain PyTorch versions (`ops/superscan.py`) only for
tensors that lie on the CPU. For CUDA tensors they launch the kernels or
raise; nothing falls back. `LAUNCHES` counts each kernel launch on the
card. Rings are the slice-major [S, K] int32/float32 tensors of the
session operator, updated in place; vfields are the aggregate's value
fields as (name, dtype name, scatter), idents their identities.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Sequence

import numpy as np
import torch

from flink_tpu_torch.ops import cuda_superscan as cs
from flink_tpu_torch.ops.aggregators import torch_dtype
from flink_tpu_torch.ops.superscan import (
    packed_size,
    session_ingest_plain,
    session_live_bounds,
    session_merge_plain,
    session_superscan_plain,
)

#: kernel launches on the card (plain-version and CPU calls do not count)
LAUNCHES: Dict[str, int] = {"k3_session_ingest": 0, "k4_session_merge": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _kinds(vfields) -> list:
    return [cs._KIND_CODES.get((sc, np.dtype(dt)), -1) for _n, dt, sc in vfields]


def supports(vfields) -> bool:
    """Whether K3/K4 take these value fields: at most 4, each an add, min
    or max of float32 or int32."""
    return len(vfields) <= cs.MAX_FIELDS and all(k >= 0 for k in _kinds(vfields))


def _rings(cnt, mn, mx, fields, vfields, dev):
    S, K = cnt.shape
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
    return (cnt.data_ptr(), mn.data_ptr(), mx.data_ptr(),
            (ctypes.c_void_p * max(nf, 1))(*[f.data_ptr() for f in fields]),
            (ctypes.c_int * max(nf, 1))(*_kinds(vfields)))


def _cuda(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"no {what} for device {t.device}")


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _ingest(head, kid, spos, rel, vals, K: int, S: int, nf: int, dev) -> None:
    n = kid.numel()
    for name, t, dt in (("kid", kid, torch.int32), ("spos", spos, torch.int32),
                        ("rel", rel, torch.int32), ("vals", vals, torch.float32)):
        cs._check(t, name, dt, tuple(kid.shape), dev)
    if n == 0:
        return                                 # nothing to launch
    rc = cs._library("session_superscan").k3_session_ingest(
        *head, nf, kid.data_ptr(), spos.data_ptr(), rel.data_ptr(), vals.data_ptr(), n, K, S,
        _stream(dev))
    if rc != 0:
        raise RuntimeError(f"k3_session_ingest failed to launch: CUDA error {rc}")
    LAUNCHES["k3_session_ingest"] += 1


def _merge(head, idents, vfields, pos, p0: int, n: int, r0: int, g: int, wm_rel: int, M: int,
           packed, bounds: bool, K: int, S: int, dev) -> None:
    nf = len(vfields)
    bits = (ctypes.c_int * max(nf, 1))(*[cs._bits(i, dt) for i, (_n, dt, _s) in
                                        zip(idents, vfields)])
    rc = cs._library("session_superscan").k4_session_merge(
        *head, bits, nf, None if pos is None else pos.data_ptr(), p0, n, r0, g, wm_rel, M,
        packed.data_ptr(), int(bounds), K, S, _stream(dev))
    if rc != 0:
        raise RuntimeError(f"k4_session_merge failed to launch: CUDA error {rc}")
    LAUNCHES["k4_session_merge"] += 1


def session_ingest(cnt, mn, mx, fields, kid, spos, rel, vals, vfields) -> None:
    """Ingest a batch of session records (kid, spos, rel int32, vals
    float32, one shape): kernel K3 on CUDA tensors, `session_ingest_plain`
    (same contract) on CPU tensors."""
    if cnt.device.type == "cpu":
        return session_ingest_plain(cnt, mn, mx, fields, kid, spos, rel, vals, vfields)
    _cuda(cnt, "session ingest")
    dev = cnt.device
    S, K = cnt.shape
    head = _rings(cnt, mn, mx, fields, vfields, dev)
    with torch.cuda.device(dev):
        _ingest(head, kid.contiguous(), spos.contiguous(), rel.contiguous(),
                vals.contiguous(), K, S, len(vfields), dev)


def session_merge(cnt, mn, mx, fields, pos, wm_rel: int, *, g: int, M: int,
                  vfields, idents: Sequence) -> torch.Tensor:
    """One per-watermark gap-merge over the resident span: pos int32 [P],
    the ring positions of its slices in order (distinct), wm_rel an int64
    ms relative to the first. Kernel K4 on CUDA tensors,
    `session_merge_plain` (same contract and packed result, all P columns
    valid) on CPU tensors."""
    if cnt.device.type == "cpu":
        return session_merge_plain(cnt, mn, mx, fields, pos, None, wm_rel, g=g, M=M,
                                   vfields=vfields, idents=idents)
    _cuda(cnt, "session merge")
    dev = cnt.device
    S, K = cnt.shape
    P = pos.numel()
    head = _rings(cnt, mn, mx, fields, vfields, dev)
    cs._check(pos, "pos", torch.int32, (P,), dev)
    packed = torch.zeros(packed_size(K, M, len(fields)), dtype=torch.int32, device=dev)
    packed[-4] = P                             # no live column yet: (P, -1)
    packed[-3] = -1
    with torch.cuda.device(dev):
        _merge(head, idents, vfields, pos, 0, P, 0, g, wm_rel, M, packed, True, K, S, dev)
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
                      wm_rel, *, g: int, M: int, vfields, idents: Sequence) -> torch.Tensor:
    """A fused session superspan ([T, B] records; T host plan integers per
    list, wm_rel int64): on CUDA tensors one K3 launch per run of `ingest_runs` and one
    K4 launch per merge, the slots carried in the packed result, then the
    live bounds of the final ring by torch code (`session_live_bounds`);
    `session_superscan_plain` (same contract and packed result) on CPU
    tensors."""
    if cnt.device.type == "cpu":
        return session_superscan_plain(cnt, mn, mx, fields, kid, spos, rel, vals, merge_flag,
                                       lo_pos, lo_rel, wm_rel, g=g, M=M, vfields=vfields,
                                       idents=idents)
    _cuda(cnt, "session superscan")
    dev = cnt.device
    S, K = cnt.shape
    head = _rings(cnt, mn, mx, fields, vfields, dev)
    kid, spos, rel, vals = (x.contiguous() for x in (kid, spos, rel, vals))
    packed = torch.zeros(packed_size(K, M, len(fields)), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        for t0, t1 in ingest_runs(merge_flag):
            _ingest(head, kid[t0:t1 + 1], spos[t0:t1 + 1], rel[t0:t1 + 1], vals[t0:t1 + 1],
                    K, S, len(vfields), dev)
            if merge_flag[t1]:
                _merge(head, idents, vfields, None, int(lo_pos[t1]), S, int(lo_rel[t1]), g,
                       int(wm_rel[t1]), M, packed, False, K, S, dev)
        lo, hi = session_live_bounds(cnt, int(lo_pos[-1]), int(lo_rel[-1]))
        packed[-4:-2] = torch.stack([lo, hi])
    return packed
