"""Hopper kernels K1 (keyed) and K2 (global) of the superscan dispatch.

Counterpart of `flink_tpu/ops/pallas_superscan.py`. The kernels are CUDA
C++ for `sm_90a` in `flink_tpu_torch/csrc/`, built at first use by `nvcc`
into shared libraries with a plain C interface under
`build/flink_tpu_torch/` (rebuilt when a source's hash changes) and bound
with ctypes. A dispatch reduces the records of all its steps into step
partials, then walks the steps once: two kernel launches on PyTorch's
current stream (per group of steps for K1, where the partials would
outgrow `PARTIAL_BUDGET`), with no host sync inside. The wrapper allocates
the partials' scratch through PyTorch's caching allocator. K1's partials
entry (`keyed_superscan_partials`, the mesh's map-side combiner's receive
side) takes the step partials from its caller and runs the walk alone.

Every entry takes an optional `phase` buffer, int32[3] on the state's
device (the device plane's phase counters, `observability.device.enabled`):
a dispatch adds [records with idx >= 0 (the partials entry: the sum of its
count partials), fire slots (the sum of fire_valid), steps whose purge row
holds a 0] into it inside the launches it makes anyway, with no host sync;
the caller zeroes it. `k1_cost`, `k1_partials_cost` and `k2_cost` count the
bytes a dispatch must move and the operations it does, for the device
plane's roofline and for `chip_smoke.py`'s bounds.

The wrappers take the plain PyTorch version (`ops/superscan.py`) only for
tensors that lie on the CPU. For CUDA tensors they launch the kernel or
raise; nothing falls back. Each wrapper adds one to its entry in
`LAUNCHES` for every dispatch it launches on the card (and to the
launching thread's entry in `LAUNCHES_BY_THREAD`), and the number of CUDA
kernels that dispatch launched to its entry in `CUDA_LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np
import torch

from flink_tpu_torch.ops.aggregators import (
    device_dtype,
    device_value,
    scan_identity,
    torch_dtype,
)
from flink_tpu_torch.ops.superscan import (
    field_kind,
    global_superscan_plain,
    keyed_superscan_partials_plain,
    keyed_superscan_plain,
    partial_dtype,
    value_fields,
)

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "flink_tpu_torch"
#: library name -> its source in csrc/ (each also includes common.cuh); the
#: session kernels K3/K4 are wrapped in ops/cuda_session.py
SOURCES = {"superscan": "superscan.cu", "global_superscan": "global_superscan.cu",
           "session_superscan": "session_superscan.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: dispatches launched on the card, per wrapper (plain-version calls and
#: CPU calls do not count)
LAUNCHES: Dict[str, int] = {"k1_superscan": 0, "k1_partials": 0, "k2_global_superscan": 0}
#: the same dispatches by the name of the thread that launched them
LAUNCHES_BY_THREAD: Dict[str, Dict[str, int]] = {name: {} for name in LAUNCHES}
#: CUDA kernel launches of those dispatches
CUDA_LAUNCHES: Dict[str, int] = dict(LAUNCHES)

#: device memory that one keyed dispatch's step partials may take; a
#: dispatch whose partials need more runs in groups of steps
PARTIAL_BUDGET = 64 << 20
#: steps in one group, at most (the CUDA grid's z limit, one z per step)
MAX_GROUP_STEPS = 65535
#: records one K2 ingest block folds, at most
GLOBAL_CHUNK = 32768

# limits of the C entry points (csrc/common.cuh, global_superscan.cu)
MAX_FIELDS = 4
#: K1's fire slots a step: a shared-partial group of 16 member windows at
#: 4 fires a step
MAX_FIRES = 64
#: a step descriptor's fire positions and rows are 16-bit
MAX_RING = MAX_ROWS = 1 << 16
#: sizeof(StepDesc) in csrc/common.cuh (checked when a library loads): smin,
#: the writing-slot mask, 16-bit positions and rows, purged-column bits
STEP_DESC_BYTES = 4 * (1 + MAX_FIRES // 32 + MAX_FIRES + 4)
MAX_GLOBAL_FIRES = 16
MAX_GLOBAL_NSB = 8
MAX_GLOBAL_S = 32
MAX_GLOBAL_R = 128

_F32, _I32 = np.dtype(np.float32), np.dtype(np.int32)
#: (kind, dtype) -> the FieldKind number of csrc/common.cuh
_KIND_CODES = {
    ("add", _F32): 0, ("add", _I32): 1, ("max8", _I32): 2,
    ("min", _F32): 3, ("max", _F32): 4, ("min", _I32): 5, ("max", _I32): 6,
}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
        CUDA_LAUNCHES[name] = 0
        LAUNCHES_BY_THREAD[name].clear()


def _count_launch(entry: str) -> None:
    LAUNCHES[entry] += 1
    by_thread = LAUNCHES_BY_THREAD[entry]
    name = threading.current_thread().name
    by_thread[name] = by_thread.get(name, 0) + 1


def partial_bytes(steps: int, K: int, NSB: int, nf: int) -> int:
    """Bytes of K1's scratch for `steps` steps: the step partials [1 + nf,
    steps, K, NSB] int32 (the count and each VALUE field), then one plan
    descriptor per step."""
    return 4 * (1 + nf) * steps * NSB * K + STEP_DESC_BYTES * steps


def step_groups(T: int, K: int, NSB: int, nf: int) -> List[Tuple[int, int]]:
    """Split a keyed dispatch's T steps into consecutive groups [t0, t1)
    whose step partials fit in PARTIAL_BUDGET bytes (a group holds at least
    one step and at most MAX_GROUP_STEPS). Each group is two kernel
    launches."""
    per_group = min(MAX_GROUP_STEPS,
                    max(1, PARTIAL_BUDGET // partial_bytes(1, K, NSB, nf)))
    return [(t0, min(T, t0 + per_group)) for t0 in range(0, T, per_group)]


def global_blocks_per_step(B: int) -> int:
    """K2's ingest blocks per step: runs of at most GLOBAL_CHUNK records."""
    return max(1, -(-B // GLOBAL_CHUNK))


# ---------------------------------------------------------------------------
# what a dispatch must move and compute (the device plane's cost analysis,
# and chip_smoke.py's bounds): each input read once, each output written
# once; the operations are one per ingested record and array
# ---------------------------------------------------------------------------

def plan_bytes(T: int, F: int, S: int) -> int:
    """Bytes of a dispatch's plan: smin [T], fire_pos/fire_valid/fire_row
    [T, F] and purge [T, S], int32."""
    return 4 * T * (1 + 3 * F + S)


def k1_cost(*, T: int, B: int, K: int, S: int, F: int, nf: int, fires: int,
            records=None) -> Dict[str, float]:
    """One keyed lane dispatch (K1): the records' idx (and their value
    column, with VALUE fields) read once, each of the 1 + nf rings read and
    written once, one [K] row per fire and array written, the plan read
    once; one operation per ingested record and array (`records`: the
    records with idx >= 0; None counts all T*B lanes)."""
    arrays = 1 + nf
    lanes = T * B
    nbytes = (lanes * 4 * (2 if nf else 1) + 2 * arrays * S * K * 4
              + arrays * fires * K * 4 + plan_bytes(T, F, S))
    return {"flops": float((lanes if records is None else records) * arrays),
            "bytes_accessed": float(nbytes)}


def k1_partials_cost(*, T: int, K: int, S: int, NSB: int, F: int, nf: int,
                     fires: int) -> Dict[str, float]:
    """One keyed dispatch through K1's partials entry: the [1 + nf, T, K,
    NSB] partials read once, the rings read and written once, the fire
    rows written, the plan read; one operation per partial cell."""
    arrays = 1 + nf
    cells = T * K * NSB
    nbytes = (arrays * cells * 4 + 2 * arrays * S * K * 4 + arrays * fires * K * 4
              + plan_bytes(T, F, S))
    return {"flops": float(arrays * cells), "bytes_accessed": float(nbytes)}


def k2_cost(*, T: int, B: int, S: int, F: int, nf: int, fires: int,
            records=None) -> Dict[str, float]:
    """One global dispatch (K2): the records' idx (and value column) read
    once, the [S] rings read and written once, one scalar per fire and
    array written, the plan read; one operation per ingested record and
    array."""
    arrays = 1 + nf
    lanes = T * B
    nbytes = (lanes * 4 * (2 if nf else 1) + 2 * arrays * S * 4 + arrays * fires * 4
              + plan_bytes(T, F, S))
    return {"flops": float((lanes if records is None else records) * arrays),
            "bytes_accessed": float(nbytes)}


# ---------------------------------------------------------------------------
# build + load
# ---------------------------------------------------------------------------

def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    return "/usr/local/cuda/bin/nvcc"


def _library_path(name: str) -> Path:
    """The library of source `name`, named by a hash of everything that
    fixes its machine code: the source, `common.cuh` and `NVCC_FLAGS` (the
    target architecture included). That name is the library cache's key: a
    change of any of them builds a new library instead of loading a stale
    one, in this process and in every later one."""
    h = hashlib.sha256()
    for src in (SOURCES[name], "common.cuh"):
        h.update((CSRC / src).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


#: serialises builds and loads of one process: two threads (two
#: TaskExecutors of an in-process cluster) making their first dispatch at
#: once in a cold build directory must not run nvcc into one file
_build_lock = threading.RLock()


def build(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, Path]:
    """Build every named library whose source hash has no library yet: one
    nvcc per source, all started together. The ptxas report (registers,
    shared memory, spills) of each build lands beside it as a .log file.
    Returns name -> library path; raises with nvcc's output on failure.
    Safe to call from several threads: one builds, the others wait and
    find the library built."""
    with _build_lock:
        return _build(names)


def _build(names: Iterable[str]) -> Dict[str, Path]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: _library_path(n) for n in names}
    procs = {}
    for n, path in paths.items():
        if path.exists():
            continue
        # build beside the target and rename, so a reader never sees a
        # half-written library; the directory is this process's and this
        # thread's, so no other build writes the same file
        tmp = BUILD_DIR / f"tmp-{os.getpid()}-{threading.get_ident()}" / path.name
        tmp.parent.mkdir(exist_ok=True)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, path)
    failed = []
    for n, (proc, tmp, path) in procs.items():
        out, _ = proc.communicate()
        path.with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"{SOURCES[n]}:\n{out}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, path)
    for _proc, tmp, _path in procs.values():
        try:
            tmp.parent.rmdir()
        except OSError:
            pass
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return paths


_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_PTRS = ctypes.POINTER(ctypes.c_void_p)
_INTS = ctypes.POINTER(ctypes.c_int)


_libraries: Dict[str, ctypes.CDLL] = {}


def _library(name: str) -> ctypes.CDLL:
    """Library `name`, built and bound once per process (under the build
    lock, so concurrent first calls load it once)."""
    lib = _libraries.get(name)
    if lib is None:
        with _build_lock:
            lib = _libraries.get(name)
            if lib is None:
                lib = bind(ctypes.CDLL(str(build([name])[name])), name)
                _libraries[name] = lib
    return lib


# forget the loaded libraries (a cold-build check builds them anew)
_library.cache_clear = _libraries.clear


def bind(lib: ctypes.CDLL, name: str) -> ctypes.CDLL:
    """Declare the C signature of library `name`'s entry point on `lib`,
    after checking that the library's step descriptors have the size the
    scratch is sized for."""
    if lib.step_desc_bytes() != STEP_DESC_BYTES:
        raise RuntimeError(f"{name}: sizeof(StepDesc) is {lib.step_desc_bytes()}, "
                           f"the wrapper sizes its scratch for {STEP_DESC_BYTES}")
    if name == "session_superscan":
        rings = [_PTR, _PTR, _PTR, _PTRS, _INTS]         # cnt, mn, mx, fields, kinds
        # idents nf, pos, p0 n r0 g, wm_rel, M, packed, flags bpos brel K S CH,
        # scratch, stream
        lib.k4_session_merge.argtypes = rings + [_INTS, _INT, _PTR] + [_INT] * 4 + [
            ctypes.c_longlong, _INT, _PTR] + [_INT] * 6 + [_PTR, _PTR]
        # nf, kid spos rel vals, n, K S p0 W NT Q KT, part, sms, stream
        lib.k3_session_ingest.argtypes = rings + [_INT] + [_PTR] * 4 + [
            ctypes.c_longlong] + [_INT] * 7 + [_PTR, _INT, _PTR]
        lib.session_prepare.argtypes = []
        lib.k3_session_ingest.restype = lib.k4_session_merge.restype = ctypes.c_int
        lib.session_prepare.restype = ctypes.c_int
        return lib
    common = [_PTR, _PTRS, _INTS, _INTS, _INT,            # count, fields, kinds, idents, nf
              _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR,  # idx, vals, smin, fpos, fvalid, frow, purge
              _INTS, _INT, _PTR, _PTRS]                  # spws, F, count_out, outs
    if name == "superscan":
        fn = lib.k1_superscan
        # K S NSB R B exact, part, t0 tg, phase, stream
        fn.argtypes = common + [_INT] * 6 + [_PTR, _INT, _INT, _PTR, _PTR]
        # count fields kinds idents nf, part, smin fpos fvalid frow purge,
        # spws F, count_out outs, K S NSB R, descs, t0 tg, phase, stream
        lib.k1_partials.argtypes = [_PTR, _PTRS, _INTS, _INTS, _INT, _PTR] + [_PTR] * 5 + [
            _INTS, _INT, _PTR, _PTRS] + [_INT] * 4 + [_PTR, _INT, _INT, _PTR, _PTR]
        lib.k1_partials.restype = ctypes.c_int
    else:
        fn = lib.k2_global_superscan
        # S NSB R T B, part, nblk, phase, stream
        fn.argtypes = common + [_INT] * 5 + [_PTR, _INT, _PTR, _PTR]
    fn.restype = ctypes.c_int
    return lib


# ---------------------------------------------------------------------------
# shape gates (re-derived for Hopper: no VMEM budget, no K % 128)
# ---------------------------------------------------------------------------

def _kind_code(f, kind=None) -> int:
    return _KIND_CODES.get((kind or field_kind(f), f.device_dtype), -1)


def supports(agg, K: int, R: int, S: int, NSB: int, F: int) -> bool:
    """Whether kernel K1 takes this aggregate/geometry: at most 4 VALUE
    fields, each an add, bounded max8 or unbounded min/max of float32 or
    int32; at most 64 fire slots; at most 2^16 ring columns and fire rows;
    ring and out cell indices within int32 row arithmetic."""
    vf = value_fields(agg)
    return (len(vf) <= MAX_FIELDS and F <= MAX_FIRES
            and all(_kind_code(f) >= 0 for f in vf)
            and S <= MAX_RING and R <= MAX_ROWS
            and S * K < 2 ** 31 and R * K < 2 ** 31 and NSB * K < 2 ** 31)


def supports_global(agg, S: int, R: int, NSB: int, F: int) -> bool:
    """Whether kernel K2 takes this aggregate/geometry: the limits of the
    TPU kernel that still mean something here (S <= 32, R <= 128, NSB <= 8,
    add/min/max fields) plus the C entry's field and fire-slot counts. A
    bounded max folds as a plain int32 max on the global path, as on TPU."""
    vf = value_fields(agg)
    return (S <= MAX_GLOBAL_S and R <= MAX_GLOBAL_R and NSB <= MAX_GLOBAL_NSB
            and F <= MAX_GLOBAL_FIRES and len(vf) <= MAX_FIELDS
            and all(_kind_code(f, f.scatter) >= 0 for f in vf))


# ---------------------------------------------------------------------------
# layout converters between the canonical [K, S] state (snapshots, the JAX
# package) and the kernels' slice-major [S, K]
# ---------------------------------------------------------------------------

def to_kernel_layout(arr):
    """[K, S] -> [S, K] (numpy array or tensor; a contiguous copy)."""
    if isinstance(arr, torch.Tensor):
        return arr.t().contiguous()
    return np.ascontiguousarray(np.asarray(arr).T)


def from_kernel_layout(arr):
    """[S, K] -> [K, S]."""
    return to_kernel_layout(arr)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _bits(value, dtype) -> int:
    """A cell value of a field declared `dtype` as the 32-bit pattern the
    kernels store."""
    return int(np.array([device_value(value, dtype)], device_dtype(dtype)).view(np.int32)[0])


def _check(t: torch.Tensor, name: str, dtype, shape, dev) -> None:
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_phase(phase, dev) -> None:
    if phase is not None:
        _check(phase, "phase", torch.int32, (3,), dev)


def _launch(entry: str, agg, count, states, idx, vals, plan, *, kinds,
            idents, out_shape, outs_fill, spws, scratch, calls, phase):
    """Validate, allocate the fire rows and the step partials' scratch, and
    run one dispatch on the card. `scratch` is the scratch's int32 element
    count; `calls(part)` lists the trailing arguments of each C call before
    the phase buffer (each call is two CUDA launches)."""
    dev = count.device
    S = count.shape[0]
    smin, fpos, fvalid, frow, purge = plan
    T, F = fpos.shape
    B = idx.numel() // max(T, 1)
    vf = value_fields(agg)
    _check(idx, "idx", torch.int32, (T * B,), dev)
    _check(smin, "smin", torch.int32, (T,), dev)
    for name, p in (("fire_pos", fpos), ("fire_valid", fvalid), ("fire_row", frow)):
        _check(p, name, torch.int32, (T, F), dev)
    _check(purge, "purge", torch.int32, (T, S), dev)
    if len(spws) != F:
        raise ValueError(f"spws has {len(spws)} slots, expected F={F}")
    if len(states) != len(vf):
        raise ValueError(f"{len(states)} field rings for {len(vf)} fields")
    for f, st in zip(vf, states):
        _check(st, f"state {f.name!r}", torch_dtype(f.dtype), count.shape, dev)
    if vf:
        _check(vals, "vals", torch.float32, (T * B,), dev)
    _check_phase(phase, dev)
    count_out = torch.zeros(out_shape, dtype=torch.int32, device=dev)
    outs = tuple(torch.full(out_shape, fill, dtype=torch_dtype(f.dtype), device=dev)
                 for f, fill in zip(vf, outs_fill))
    n = len(vf)
    lib = _library("superscan" if entry == "k1_superscan" else "global_superscan")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        # freed after the calls are enqueued: the caching allocator reuses
        # it only for work that follows on the same stream
        part = torch.empty(scratch, dtype=torch.int32, device=dev)
        head = (count.data_ptr(),
                (ctypes.c_void_p * max(n, 1))(*[s.data_ptr() for s in states]),
                (ctypes.c_int * max(n, 1))(*kinds),
                (ctypes.c_int * max(n, 1))(*idents), n,
                idx.data_ptr(), vals.data_ptr() if vf else None,
                smin.data_ptr(), fpos.data_ptr(), fvalid.data_ptr(),
                frow.data_ptr(), purge.data_ptr(),
                (ctypes.c_int * max(F, 1))(*spws), F, count_out.data_ptr(),
                (ctypes.c_void_p * max(n, 1))(*[o.data_ptr() for o in outs]))
        _count_launch(entry)
        pp = None if phase is None else phase.data_ptr()
        for tail in calls(part.data_ptr()):
            rc = getattr(lib, entry)(*head, *tail, pp, stream)
            if rc != 0:
                raise RuntimeError(f"{entry} failed to launch: CUDA error {rc}")
            CUDA_LAUNCHES[entry] += 2
    return count_out, outs


def keyed_superscan(agg, count: torch.Tensor, states: Sequence[torch.Tensor],
                    idx: torch.Tensor, vals, plan, *, NSB: int, R: int,
                    spws: Sequence[int], exact: bool, phase=None):
    """One keyed T-step dispatch: kernel K1 on CUDA tensors, the plain
    version (`keyed_superscan_plain`, same contract) on CPU tensors.

    count [S, K] int32 and states (one [S, K] ring per VALUE field) are
    updated in place; idx [T*B] int32, vals [T*B] float32 or None; plan =
    (smin [T], fire_pos, fire_valid, fire_row [T, F], purge [T, S]) int32;
    phase: the int32[3] phase counters to add to, or None.
    Returns (count_out [R, K] int32, outs: one [R, K] per field)."""
    if count.device.type == "cpu":
        return keyed_superscan_plain(agg, count, states, idx, vals, plan,
                                     NSB=NSB, R=R, spws=spws, exact=exact, phase=phase)
    if count.device.type != "cuda":
        raise ValueError(f"no keyed superscan for device {count.device}")
    S, K = count.shape
    F = plan[1].shape[1]
    if not supports(agg, K, R, S, NSB, F):
        raise NotImplementedError(
            f"kernel K1 does not take aggregate {agg.name!r} at K={K} S={S} "
            f"R={R} F={F}: 32-bit add, max8, min and max fields only (64-bit ones "
            "compute in 32 bits), "
            "at most 4 fields, 64 fire slots, 2^16 ring columns and fire rows")
    vf = value_fields(agg)
    T = plan[1].shape[0]
    B = idx.numel() // max(T, 1)
    groups = step_groups(T, K, NSB, len(vf))
    longest = max((t1 - t0 for t0, t1 in groups), default=0)
    return _launch(
        "k1_superscan", agg, count, states, idx, vals, plan,
        kinds=[_kind_code(f) for f in vf],
        idents=[_bits(f.identity, f.dtype) for f in vf], out_shape=(R, K),
        outs_fill=[0] * len(vf), spws=spws,
        scratch=partial_bytes(longest, K, NSB, len(vf)) // 4,
        calls=lambda part: [(K, S, NSB, R, B, int(exact), part, t0, t1 - t0)
                            for t0, t1 in groups], phase=phase)


def global_superscan(agg, count: torch.Tensor, states: Sequence[torch.Tensor],
                     idx: torch.Tensor, vals, plan, *, NSB: int, R: int,
                     spws: Sequence[int], phase=None):
    """One global-window T-step dispatch: kernel K2 on CUDA tensors, the
    plain version (`global_superscan_plain`, same contract) on CPU tensors.

    count [S] int32 and states (one [S] ring per VALUE field) are updated
    in place; phase as `keyed_superscan`'s. Returns (count_out [R] int32,
    outs: one [R] per field, at the field's scan identity where no fire
    wrote)."""
    if count.device.type == "cpu":
        return global_superscan_plain(agg, count, states, idx, vals, plan,
                                      NSB=NSB, R=R, spws=spws, phase=phase)
    if count.device.type != "cuda":
        raise ValueError(f"no global superscan for device {count.device}")
    (S,) = count.shape
    F = plan[1].shape[1]
    if not supports_global(agg, S, R, NSB, F):
        raise NotImplementedError(
            f"kernel K2 does not take aggregate {agg.name!r} at S={S} R={R} "
            f"NSB={NSB} F={F}: S <= 32, R <= 128, NSB <= 8, float32/int32 "
            "add/min/max fields only")
    vf = value_fields(agg)
    idents = [scan_identity(np.dtype(f.dtype), f.scatter) for f in vf]
    T = plan[1].shape[0]
    B = idx.numel() // max(T, 1)
    nblk = global_blocks_per_step(B)
    return _launch(
        "k2_global_superscan", agg, count, states, idx, vals, plan,
        kinds=[_kind_code(f, f.scatter) for f in vf],
        idents=[_bits(i, f.dtype) for i, f in zip(idents, vf)],
        out_shape=(R,), outs_fill=idents, spws=spws,
        scratch=T * nblk * (1 + len(vf)) * NSB + T * STEP_DESC_BYTES // 4,
        calls=lambda part: [(S, NSB, R, T, B, part, nblk)] if T else [], phase=phase)


def keyed_superscan_partials(agg, count: torch.Tensor, states: Sequence[torch.Tensor],
                             cpart: torch.Tensor, parts: Sequence[torch.Tensor], plan, *,
                             NSB: int, R: int, spws: Sequence[int], out=None, phase=None):
    """One keyed T-step dispatch over pre-reduced step partials: K1's
    partials entry on CUDA tensors, the plain version
    (`keyed_superscan_partials_plain`, same contract) on CPU tensors.

    count [S, K] int32 and states (one [S, K] ring per VALUE field) are
    updated in place; cpart [T, K, NSB] int32 and parts (one [T, K, NSB]
    per VALUE field, in its `partial_dtype`) are the step partials; plan as
    `keyed_superscan`. Returns (count_out [R, K] int32, outs: one [R, K]
    per field); `out`, an earlier call's return, is written in place
    instead (rows no fire of these steps writes keep what they hold);
    phase as `keyed_superscan`'s, its ingest count the sum of cpart.
    `supports()` decides this entry as it does the lane one."""
    if count.device.type == "cpu":
        return keyed_superscan_partials_plain(agg, count, states, cpart, parts, plan,
                                              NSB=NSB, R=R, spws=spws, out=out, phase=phase)
    if count.device.type != "cuda":
        raise ValueError(f"no keyed superscan for device {count.device}")
    S, K = count.shape
    smin, fpos, fvalid, frow, purge = plan
    T, F = fpos.shape
    if not supports(agg, K, R, S, NSB, F):
        raise NotImplementedError(
            f"kernel K1 does not take aggregate {agg.name!r} at K={K} S={S} "
            f"R={R} F={F}: 32-bit add, max8, min and max fields only, at most 4 "
            "fields, 64 fire slots, 2^16 ring columns and fire rows")
    vf = value_fields(agg)
    dev = count.device
    _check(cpart, "cpart", torch.int32, (T, K, NSB), dev)
    for f, p in zip(vf, parts):
        _check(p, f"partial {f.name!r}", partial_dtype(f), (T, K, NSB), dev)
    if len(parts) != len(vf) or len(states) != len(vf):
        raise ValueError(f"{len(parts)} partials and {len(states)} rings for {len(vf)} fields")
    for f, st in zip(vf, states):
        _check(st, f"state {f.name!r}", torch_dtype(f.dtype), count.shape, dev)
    _check(smin, "smin", torch.int32, (T,), dev)
    for name, p in (("fire_pos", fpos), ("fire_valid", fvalid), ("fire_row", frow)):
        _check(p, name, torch.int32, (T, F), dev)
    _check(purge, "purge", torch.int32, (T, S), dev)
    if len(spws) != F:
        raise ValueError(f"spws has {len(spws)} slots, expected F={F}")
    _check_phase(phase, dev)
    n = len(vf)
    # the walk reads [1 + nf, steps, K, NSB] 32-bit patterns
    stacked = torch.stack([cpart] + [p.view(torch.int32) for p in parts])
    if out is None:
        count_out = torch.zeros((R, K), dtype=torch.int32, device=dev)
        outs = tuple(torch.zeros((R, K), dtype=torch_dtype(f.dtype), device=dev)
                     for f in vf)
    else:
        count_out, outs = out
        _check(count_out, "count_out", torch.int32, (R, K), dev)
        for f, o in zip(vf, outs):
            _check(o, f"out {f.name!r}", torch_dtype(f.dtype), (R, K), dev)
    lib = _library("superscan")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _count_launch("k1_partials")
        for t0 in range(0, T, MAX_GROUP_STEPS):
            tg = min(MAX_GROUP_STEPS, T - t0)
            part = stacked if tg == T else stacked[:, t0:t0 + tg].contiguous()
            descs = torch.empty(tg * STEP_DESC_BYTES // 4, dtype=torch.int32, device=dev)
            rc = lib.k1_partials(
                count.data_ptr(),
                (ctypes.c_void_p * max(n, 1))(*[st.data_ptr() for st in states]),
                (ctypes.c_int * max(n, 1))(*[_kind_code(f) for f in vf]),
                (ctypes.c_int * max(n, 1))(*[_bits(f.identity, f.dtype) for f in vf]), n,
                part.data_ptr(), smin.data_ptr(), fpos.data_ptr(), fvalid.data_ptr(),
                frow.data_ptr(), purge.data_ptr(), (ctypes.c_int * max(F, 1))(*spws), F,
                count_out.data_ptr(),
                (ctypes.c_void_p * max(n, 1))(*[o.data_ptr() for o in outs]),
                K, S, NSB, R, descs.data_ptr(), t0, tg,
                None if phase is None else phase.data_ptr(), stream)
            if rc != 0:
                raise RuntimeError(f"k1_partials failed to launch: CUDA error {rc}")
            CUDA_LAUNCHES["k1_partials"] += 2
    return count_out, outs
