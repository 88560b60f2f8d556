"""The YSB-shaped and session streams used on the card, their host replays
and the oracles.

Counterparts of `bench.py::step_bounds`, `make_device_gen`,
`NumpyWindower` and `_parity`, and of `secondary_sessions`' stream and
`_numpy_sessionize` (bottom of the module). The record bits come from a counter-based
32-bit hash of (seed, t, b) — computed with torch on the device and
bit-identically with numpy on the host, so the oracle replays exactly the
stream the device saw (it is not the JAX package's threefry stream).

Schedule (integer math, identical on host and device), step t, record b:
    bits   = hash32(seed, t, b)
    key    = bits & (NUM_KEYS - 1)
    jitter = (bits >> 13) % (OOO_MS + 1)
    ts     = max(t*STEP_MS + ((b+1)*STEP_MS)//B - jitter, 0)
    val    = (bits >> 23) & 0xFF
    watermark after step t: (t+1)*STEP_MS - WM_DELAY_MS
"""

from __future__ import annotations

import functools
import time
from typing import Dict, Tuple

import numpy as np
import torch

NUM_KEYS = 8192
WINDOW_MS = 10_000
SLIDE_MS = 1_000
OOO_MS = 500                  # out-of-orderness jitter bound
WM_DELAY_MS = 1_000
STEP_MS = 655                 # event-time span of one step
NSB = 4
SEED = 42

_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """(x * c) mod 2**32 for 0 <= x < 2**32 held in int64, without ever
    overflowing int64: c is split into 16-bit halves."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _fmix32(x):
    """murmur3's 32-bit finalizer on values held in int64 (numpy arrays,
    tensors or Python ints alike): every product is reduced to 32 bits, so
    the arithmetic right shifts only ever see non-negative values."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def step_key(seed: int, t: int) -> int:
    """The per-step hash key of step t (a Python int below 2**32)."""
    return _fmix32((seed * 0x9E3779B1 + t * 0x7FEB352D + 0x165667B1) & _M32)


def hash_bits(key, b):
    """Record bits of records b (int64 array or tensor, b < 2**31) under
    step key(s) below 2**32."""
    return _fmix32((key + _mul32(b, 0x27D4EB2F)) & _M32)


def watermark_after(t: int) -> int:
    return (t + 1) * STEP_MS - WM_DELAY_MS


def step_bounds(t: int, B: int, slide_ms: int = SLIDE_MS) -> Tuple[int, int]:
    """Inclusive (smin, smax) slice bounds of step t's records."""
    smin = max((t * STEP_MS + STEP_MS // B - OOO_MS) // slide_ms, 0)
    smax = ((t + 1) * STEP_MS) // slide_ms
    return smin, smax


def host_step(t: int, B: int, seed: int = SEED,
              num_keys: int = NUM_KEYS) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Regenerate step t's (keys, ts, vals) on the host, bit-identical to
    the device generator."""
    b = np.arange(B, dtype=np.int64)
    bits = hash_bits(np.int64(step_key(seed, t)), b)
    keys = bits & (num_keys - 1)
    jitter = (bits >> 13) % (OOO_MS + 1)
    ts = np.maximum(t * STEP_MS + ((b + 1) * STEP_MS) // B - jitter, 0)
    vals = ((bits >> 23) & 0xFF).astype(np.float32)
    return keys, ts, vals


def make_device_gen(T: int, B: int, *, device, seed: int = SEED,
                    slide_ms: int = SLIDE_MS, with_vals: bool = False,
                    nsb: int = NSB, num_keys: int = NUM_KEYS):
    """On-device generator: gen(t0, smin_abs int32[T]) -> idx [T*B] int32
    (`key * nsb + (slice - smin_abs[t])`), with vals [T*B] float32 from the
    same bits when `with_vals`. Runs with torch ops on `device`; the only
    host->device traffic is T step keys and T slice bounds."""
    dev = torch.device(device)
    b = torch.arange(B, dtype=torch.int64, device=dev)
    base = ((b + 1) * STEP_MS) // B

    def gen(t0: int, smin_abs: np.ndarray):
        keys = np.array([step_key(seed, t0 + r) for r in range(T)], np.int64)
        aux = torch.from_numpy(np.stack([
            keys, (t0 + np.arange(T, dtype=np.int64)) * STEP_MS,
            np.asarray(smin_abs, np.int64)]))
        if dev.type == "cuda":
            aux = aux.pin_memory().to(dev, non_blocking=True)
        kt, tms, smin = aux[0][:, None], aux[1][:, None], aux[2][:, None]
        bits = hash_bits(kt, b[None, :])                       # [T, B]
        kid = bits & (num_keys - 1)
        jitter = (bits >> 13) % (OOO_MS + 1)
        ts = torch.clamp(tms + base[None, :] - jitter, min=0)
        idx = (kid * nsb + ts // slide_ms - smin).to(torch.int32).reshape(-1)
        if with_vals:
            return idx, ((bits >> 23) & 0xFF).to(torch.float32).reshape(-1)
        return idx

    return gen


class NumpyWindower:
    """Incremental single-core numpy reference of the sliding/tumbling
    window aggregate (count, sum or max); alg_seconds excludes generation."""

    S = 64

    def __init__(self, window_ms: int = WINDOW_MS, slide_ms: int = SLIDE_MS,
                 agg: str = "count", num_keys: int = NUM_KEYS):
        self.window_ms = window_ms
        self.slide_ms = slide_ms
        self.agg = agg
        self.num_keys = num_keys
        self.fill = 0 if agg in ("count", "sum") else -np.inf
        self.counts = np.full((num_keys, self.S), self.fill, dtype=np.float64)
        self.fired_upto = None
        self.fired: Dict[int, np.ndarray] = {}
        self.alg_seconds = 0.0
        self.events = 0

    def step(self, keys, ts, wm, vals=None):
        S, spw = self.S, self.window_ms // self.slide_ms
        t0 = time.perf_counter()
        s_abs = ts // self.slide_ms
        flat = keys * S + (s_abs % S)
        if self.agg == "count":
            self.counts += np.bincount(flat, minlength=self.num_keys * S).reshape(
                self.num_keys, S)
        elif self.agg == "sum":
            np.add.at(self.counts.reshape(-1), flat, vals)
        else:  # max
            np.maximum.at(self.counts.reshape(-1), flat, vals)
        self.events += len(keys)
        j_hi = (wm + 1 - self.window_ms) // self.slide_ms
        j_lo = self.fired_upto + 1 if self.fired_upto is not None else j_hi
        combine = np.max if self.agg == "max" else np.sum
        for j in range(j_lo, j_hi + 1):
            # windows with negative start exist for early records, matching
            # the reference's getWindowStartWithOffset arithmetic
            pos = np.arange(j, j + spw) % S
            self.fired[j] = combine(self.counts[:, pos], axis=1)
            self.counts[:, j % S] = self.fill
        if self.fired_upto is None or j_hi > self.fired_upto:
            self.fired_upto = j_hi
        self.alg_seconds += time.perf_counter() - t0


def replay(steps: int, B: int, *, seed: int = SEED, window_ms: int = WINDOW_MS,
           slide_ms: int = SLIDE_MS, agg: str = "count",
           num_keys: int = NUM_KEYS) -> NumpyWindower:
    """Replay `steps` steps of the stream on the host through the oracle."""
    ref = NumpyWindower(window_ms, slide_ms, agg, num_keys)
    for t in range(steps):
        keys, ts, vals = host_step(t, B, seed, num_keys)
        ref.step(keys, ts, watermark_after(t), vals=vals)
    return ref


# ---------------------------------------------------------------------------
# the DataStream-API form of YSB (bench.py::api_path_microbench's program)
# ---------------------------------------------------------------------------

API_T0_MS = 10_000            # event time of record 0
API_SPAN_EVENT_MS = 64_000    # event time the whole stream spans, any size


def api_columns(idx: np.ndarray, n: int, num_keys: int = NUM_KEYS,
                payload: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """The record columns of records `idx` of an n-record stream, as
    `api_path_microbench` makes them: (campaign, event_type[, payload])
    float32 and int64 timestamps in order. The job's filter keeps
    event_type 0 (one record in three); the payload is a small integer."""
    camp = (idx * 2654435761) % num_keys
    cols = [camp, idx % 3] + ([(idx * 7) % 11] if payload else [])
    ts = API_T0_MS + idx * API_SPAN_EVENT_MS // n
    return np.stack(cols, axis=1).astype(np.float32), ts.astype(np.int64)


def api_replay(n: int, batch: int, *, window_ms: int = WINDOW_MS,
               slide_ms: int = SLIDE_MS, agg: str = "count",
               num_keys: int = NUM_KEYS) -> NumpyWindower:
    """The oracle over the filtered (key, ts[, payload]) of the same columns,
    fed batch by batch with the job's watermarks (bounded out-of-orderness
    0: the largest timestamp so far minus 1). It starts at a watermark just
    before the first record and ends at one just past the last window that
    holds a record (its fire loop walks every slide up to the watermark)."""
    ref = NumpyWindower(window_ms, slide_ms, agg, num_keys)
    none = np.empty(0, np.int64)
    ref.step(none, none, API_T0_MS - 1, vals=np.empty(0))
    wm = API_T0_MS - 1
    for lo in range(0, n, batch):
        col, ts = api_columns(np.arange(lo, min(lo + batch, n), dtype=np.int64), n,
                              num_keys, payload=agg != "count")
        keep = col[:, 1] == 0
        wm = max(wm, int(ts.max()) - 1)
        ref.step(col[keep, 0].astype(np.int64), ts[keep], wm,
                 vals=col[keep, 2] if agg != "count" else None)
    last_window = int(ts.max()) // slide_ms
    ref.step(none, none, last_window * slide_ms + window_ms - 1, vals=np.empty(0))
    return ref


# ---------------------------------------------------------------------------
# the million-key stream (bench.py::millikey_microbench's program): YSB's
# sliding count over a key vocabulary far beyond the hot tier's capacity
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=2)
def zipf_bounded_cdf(num_keys: int, s: float = 1.0) -> np.ndarray:
    """Bounded zipf cdf over ranks 1..num_keys: p_k ~ 1/k^s, normalized
    (bench.py::zipf_bounded_cdf; ~80 MB at 10^7 keys, so two are cached)."""
    ranks = np.arange(1, int(num_keys) + 1, dtype=np.float64)
    cdf = np.cumsum(1.0 / ranks ** float(s))
    cdf /= cdf[-1]
    cdf.setflags(write=False)
    return cdf


def zipf_keys(idx: np.ndarray, num_keys: int, s: float = 1.0) -> np.ndarray:
    """Stateless bounded-zipf key draw for element indices `idx`
    (bench.py::zipf_keys): the uniform variate is a splitmix64-style hash of
    the element index, so any chunking of the stream draws the same keys;
    rank r is key r (key 0 is the hottest)."""
    idx = np.asarray(idx)
    z = (idx.astype(np.uint64) + np.uint64(0x9E3779B97F4A7C15))
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    z = z ^ (z >> np.uint64(31))
    u = z.astype(np.float64) / 2.0 ** 64
    return np.searchsorted(zipf_bounded_cdf(num_keys, s), u).astype(np.int64)


def millikey_columns(idx: np.ndarray, n: int, num_keys: int, skewed: bool,
                     zipf_s: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
    """(keys int64, timestamps int64 in order) of records `idx` of an
    n-record millikey stream: uniform keys by a multiplicative hash of the
    index, or bounded zipf(zipf_s); the stream spans API_SPAN_EVENT_MS of
    event time from API_T0_MS."""
    if skewed:
        keys = zipf_keys(idx, num_keys, zipf_s)
    else:
        keys = ((idx * 2654435761) % num_keys).astype(np.int64)
    return keys, (API_T0_MS + idx * API_SPAN_EVENT_MS // n).astype(np.int64)


def millikey_oracle(n: int, num_keys: int, skewed: bool, zipf_s: float = 1.0,
                    window_ms: int = WINDOW_MS, slide_ms: int = SLIDE_MS) -> list:
    """Sorted (key, count) rows of every fired window of the sliding count
    over the n-record millikey stream (bench.py::millikey_microbench's
    host_oracle): each record lands in window_ms // slide_ms windows, one
    row per (key, window) holding records. A numpy fold that holds the whole
    vocabulary."""
    out: Dict[Tuple[int, int], int] = {}
    spw = window_ms // slide_ms
    for lo in range(0, n, 1 << 18):
        idx = np.arange(lo, min(lo + (1 << 18), n), dtype=np.int64)
        k, ts = millikey_columns(idx, n, num_keys, skewed, zipf_s)
        s = ts // slide_ms
        for shift in range(spw):
            pairs, cnts = np.unique(np.stack([k, s - shift], axis=1), axis=0,
                                    return_counts=True)
            for (kk, jj), c in zip(pairs.tolist(), cnts.tolist()):
                out[(kk, jj)] = out.get((kk, jj), 0) + c
    return sorted((kk, c) for (kk, _jj), c in out.items())


# ---------------------------------------------------------------------------
# the NEXMark join streams (bench.py::join_microbench's source() and
# keys_of()): persons and auctions keyed by seller over one event-time span
# ---------------------------------------------------------------------------

def join_rows(idx: np.ndarray, n: int, side: str, num_keys: int, skewed: bool,
              zipf_s: float = 1.0):
    """(rows, timestamps) of records `idx` of an n-record join side: rows
    (key, f"{side}{i}", category i % 3) as an object column, the keys and
    timestamps of `millikey_columns` (the bench's keys_of and its 64 s
    span from 10 s). Persons and auctions of one index share key and
    timestamp, as in the bench."""
    from flink_tpu_torch.utils.arrays import obj_array

    keys, ts = millikey_columns(idx, n, num_keys, skewed, zipf_s)
    rows = obj_array([(int(k), f"{side}{int(i)}", int(i % 3)) for k, i in zip(keys, idx)])
    return rows, ts


def join_row_ids(rows) -> np.ndarray:
    """[n, 3] int64 (key, person index, auction index) of (key, "p<i>",
    "a<j>") join rows, in lexicographic order: the form `join_model`
    returns."""
    out = np.array([(r[0], int(r[1][1:]), int(r[2][1:])) for r in rows],
                   dtype=np.int64).reshape(-1, 3)
    return out[np.lexsort(out.T[::-1])]


def join_model(n: int, num_keys: int, skewed: bool, size_ms: int, slide_ms: int, *,
               auction_filter: bool = False, zipf_s: float = 1.0) -> np.ndarray:
    """The window equi-join of the two n-record sides (persons JOIN
    auctions ON key, each over windows of size_ms sliding by slide_ms, the
    auctions filtered to category 0 with `auction_filter`, q3's filter), as
    `join_row_ids` gives a job's rows: one row per (person, auction, window)
    sharing key and window. Independent of the operators: numpy over the
    whole stream (the streams are in order, so no record is late)."""
    idx = np.arange(n, dtype=np.int64)
    keys, ts = millikey_columns(idx, n, num_keys, skewed, zipf_s)
    a_idx = idx[idx % 3 == 0] if auction_filter else idx
    spw = size_ms // slide_ms

    def assigned(sel):
        w = np.concatenate([ts[sel] // slide_ms - s for s in range(spw)])
        return np.tile(keys[sel], spw) * (1 << 24) + w, np.tile(sel, spw)

    pcode, pid = assigned(idx)
    acode, aid = assigned(a_idx)
    order = np.argsort(acode, kind="stable")
    acode, aid = acode[order], aid[order]
    lo = np.searchsorted(acode, pcode, "left")
    cnt = np.searchsorted(acode, pcode, "right") - lo
    offs = np.arange(int(cnt.sum()), dtype=np.int64) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    out = np.stack([np.repeat(pcode >> 24, cnt), np.repeat(pid, cnt),
                    aid[np.repeat(lo, cnt) + offs]], axis=1)
    return out[np.lexsort(out.T[::-1])]


def parity(cpu_fired, dev_fired, require_all: bool = True):
    """Window-by-window equality; with require_all=False (partial runs) only
    the windows the device actually fired are compared. Returns (ok,
    windows checked)."""
    mismatches = 0
    checked = 0
    for j, crow in cpu_fired.items():
        drow = dev_fired.get(j)
        if drow is None:
            if require_all and crow.any():
                mismatches += 1
            continue
        checked += 1
        if not np.array_equal(crow.astype(np.int64), np.asarray(drow).astype(np.int64)):
            mismatches += 1
    ok = mismatches == 0 and (checked > 0 or not require_all)
    if require_all:
        nonempty = len([j for j, c in cpu_fired.items() if c.any()])
        ok = ok and len(dev_fired) >= nonempty
    return ok, checked


# ---------------------------------------------------------------------------
# the session stream (bench.py::secondary_sessions' clickstream): four
# rotating blocks of 4096 keys, so sessions close; gap 2000 ms
# ---------------------------------------------------------------------------

SESSION_GAP_MS = 2_000
SESSION_BLOCK_KEYS = 4096     # keys per block; four blocks, 2**14 in all
SESSION_SEED = SEED + 7


def session_step_bounds(t: int, B: int, gap_ms: int = SESSION_GAP_MS) -> Tuple[int, int]:
    """Inclusive (smin, smax) absolute gap-slice bounds of step t's records."""
    return step_bounds(t, B, gap_ms)


def session_records(idx: np.ndarray, B: int, seed: int = SESSION_SEED
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Records `idx` (int64) of the session stream at B records a step:
    (keys int64, ts int64, vals float32), bit-identical to
    `make_session_gen`. Step t's keys come from block (t >> 2) & 3."""
    t, b = idx // B, idx % B
    bits = hash_bits(step_key(seed, t), b)
    keys = (bits & (SESSION_BLOCK_KEYS - 1)) | (((t >> 2) & 3) * SESSION_BLOCK_KEYS)
    jitter = (bits >> 13) % (OOO_MS + 1)
    ts = np.maximum(t * STEP_MS + ((b + 1) * STEP_MS) // B - jitter, 0)
    return keys, ts, ((bits >> 23) & 0xFF).astype(np.float32)


def host_session_step(t: int, B: int, seed: int = SESSION_SEED
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Step t's session records (keys, ts, vals) of B, regenerated on the
    host."""
    return session_records(np.arange(t * B, (t + 1) * B, dtype=np.int64), B, seed)


def make_session_gen(T: int, B: int, *, device, seed: int = SESSION_SEED,
                     gap_ms: int = SESSION_GAP_MS, num_slices: int = 64):
    """On-device generator of the session stream: gen(t0) -> (kid, spos,
    rel int32, vals float32), each [T, B] in the session operator's ring
    coordinates (`process_superspan_staged`), for steps [t0, t0 + T). Only
    the T step keys cross from the host."""
    dev = torch.device(device)
    b = torch.arange(B, dtype=torch.int64, device=dev)
    base = ((b + 1) * STEP_MS) // B

    def gen(t0: int):
        steps = t0 + np.arange(T, dtype=np.int64)
        aux = torch.from_numpy(np.stack([
            np.array([step_key(seed, int(t)) for t in steps], np.int64),
            steps * STEP_MS, ((steps >> 2) & 3) * SESSION_BLOCK_KEYS]))
        if dev.type == "cuda":
            aux = aux.pin_memory().to(dev, non_blocking=True)
        kt, tms, block = aux[0][:, None], aux[1][:, None], aux[2][:, None]
        bits = hash_bits(kt, b[None, :])                       # [T, B]
        kid = (bits & (SESSION_BLOCK_KEYS - 1)) | block
        ts = torch.clamp(tms + base[None, :] - (bits >> 13) % (OOO_MS + 1), min=0)
        s_abs = ts // gap_ms
        return (kid.to(torch.int32), (s_abs % num_slices).to(torch.int32),
                (ts - s_abs * gap_ms).to(torch.int32),
                ((bits >> 23) & 0xFF).to(torch.float32))

    return gen


def numpy_sessionize(keys, ts, vals, gap):
    """Single-core batch sessionizer (`bench.py::_numpy_sessionize`): sort
    by (key, ts), split where the key changes or the gap exceeds `gap`,
    segment-sum the values. Returns {(key, start, end): sum}."""
    order = np.lexsort((ts, keys))
    k, t, v = keys[order], ts[order], vals[order]
    brk = np.empty(len(k), dtype=bool)
    brk[0] = True
    brk[1:] = (k[1:] != k[:-1]) | (t[1:] - t[:-1] > gap)
    starts = np.flatnonzero(brk)
    sums = np.add.reduceat(v, starts)
    ends = np.r_[starts[1:], len(k)] - 1
    return {
        (int(k[s]), int(t[s]), int(t[e]) + gap): float(sv)
        for s, e, sv in zip(starts, ends, sums)
    }


# ---------------------------------------------------------------------------
# the lateness stream: in-order records of ~span_ms of event time a batch,
# a share delayed 1-2 s behind the watermark (re-fires under allowed
# lateness) and a smaller share 15 s behind (past cleanup: late data)
# ---------------------------------------------------------------------------

LATE_SEED = SEED + 11
LATE_T0_MS = 100_000          # event time of batch 0
LATE_WM_LAG_MS = 500          # the watermark trails the largest timestamp by this
LATE_PER_10K = 100            # 1% of records 1-2 s behind the watermark
TOO_LATE_PER_10K = 10         # 0.1% of records 15 s behind their batch
TOO_LATE_MS = 15_000


def late_records(idx: np.ndarray, B: int, num_keys: int, *, span_ms: int = 1_000,
                 seed: int = LATE_SEED) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Records `idx` (int64) of the lateness stream at B records a batch:
    (keys int64 below num_keys, a power of two; ts int64; vals float32
    integers in [0, 8)). Batch t's on-time records span [T0 + t*span,
    T0 + (t+1)*span) in order. A delayed record sits 1-2 s behind the
    watermark that follows batch t-1 (T0 + t*span - 1 - LATE_WM_LAG_MS),
    a too-late one TOO_LATE_MS behind its on-time stamp."""
    t, b = idx // B, idx % B
    bits = hash_bits(step_key(seed, t), b)
    aux = hash_bits(step_key(seed + 1, t), b)
    keys = bits & (num_keys - 1)
    on_time = LATE_T0_MS + t * span_ms + ((b + 1) * span_ms) // B - 1
    r = aux % 10_000
    delayed = LATE_T0_MS + t * span_ms - LATE_WM_LAG_MS - 1000 - (aux >> 14) % 1000
    ts = np.where(r < LATE_PER_10K, delayed,
                  np.where(r < LATE_PER_10K + TOO_LATE_PER_10K, on_time - TOO_LATE_MS, on_time))
    return keys, ts, ((aux >> 24) & 0x7).astype(np.float32)


def late_columns(idx: np.ndarray, B: int, num_keys: int = NUM_KEYS
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """The lateness stream as the api_ysb program's columns: (campaign,
    event_type, payload) float32 and the timestamps; the program's filter
    keeps event_type 0 (one record in three)."""
    keys, ts, vals = late_records(idx, B, num_keys)
    return np.stack([keys, idx % 3, vals], axis=1).astype(np.float32), ts


class LatenessOracle:
    """Numpy model of the window operator's event-time rules with allowed
    lateness, batch by batch, written from Flink's rules (WindowOperator
    with EventTimeTrigger) and not from the port's slice arithmetic:

    - a record is too late when the newest window holding it is past its
      cleanup time (end - 1 + lateness <= watermark): it goes to the side
      output and nowhere else;
    - a record that is not too late re-fires each window holding it that
      has already fired (end - 1 <= watermark) and is not cleaned up, for
      the keys the batch touched in it, with the window's full aggregate
      after the whole batch (one re-fire a window a batch);
    - a watermark fires, in order, every window that becomes due (end - 1
      <= watermark) and holds data, for every key with data in it.

    Windows are [j*slide, j*slide + size) (offset 0); `agg` is "sum" or
    "count". `step` returns the batch's emissions (kind, j, keys, values),
    re-fires first, each with ascending keys, and its side output."""

    def __init__(self, size_ms: int, slide_ms: int, lateness_ms: int, num_keys: int,
                 agg: str = "sum"):
        import math

        self.size, self.slide, self.lateness = size_ms, slide_ms, lateness_ms
        self.g = math.gcd(size_ms, slide_ms)
        self.K, self.agg = num_keys, agg
        self.cnt: Dict[int, np.ndarray] = {}      # slice -> records a key
        self.sum: Dict[int, np.ndarray] = {}
        self.wm = None
        self.fired_hi = None                      # newest window index fired
        self.oldest = None                        # oldest window holding data
        self.newest = None                        # newest window holding data

    def _window(self, j: int, keys=None):
        cnt = np.zeros(self.K, np.int64)
        sm = np.zeros(self.K, np.float64)
        for s in range(j * self.slide // self.g, (j * self.slide + self.size) // self.g):
            if s in self.cnt:
                cnt += self.cnt[s]
                sm += self.sum[s]
        if keys is None:
            keys = np.flatnonzero(cnt)
        return keys, (cnt[keys] if self.agg == "count" else sm[keys])

    def _cleanup(self, j):
        return j * self.slide + self.size - 1 + self.lateness

    def step(self, keys: np.ndarray, ts: np.ndarray, vals: np.ndarray, watermark: int):
        keys, ts = np.asarray(keys, np.int64), np.asarray(ts, np.int64)
        vals = np.asarray(vals, np.float64)
        events = []
        late = np.zeros(len(ts), bool)
        if self.wm is not None:
            late = self._cleanup(ts // self.slide) <= self.wm
        side = (keys[late], vals[late], ts[late])
        k, t, v = keys[~late], ts[~late], vals[~late]
        s = t // self.g
        order = np.argsort(s, kind="stable")
        k, t, v, s = k[order], t[order], v[order], s[order]
        cuts = np.flatnonzero(np.diff(s)) + 1
        for lo, hi in zip(np.r_[0, cuts], np.r_[cuts, len(s)]):
            if lo == hi:
                continue
            sl = int(s[lo])
            if sl not in self.cnt:
                self.cnt[sl] = np.zeros(self.K, np.int64)
                self.sum[sl] = np.zeros(self.K, np.float64)
            self.cnt[sl] += np.bincount(k[lo:hi], minlength=self.K)
            self.sum[sl] += np.bincount(k[lo:hi], weights=v[lo:hi], minlength=self.K)
        if len(t):
            first = (int(t.min()) - self.size) // self.slide + 1
            self.oldest = first if self.oldest is None else min(self.oldest, first)
            last = int(t.max()) // self.slide
            self.newest = last if self.newest is None else max(self.newest, last)
        if self.wm is not None and len(t):
            j_lo = (int(t.min()) - self.size) // self.slide + 1
            j_hi = int(t.max()) // self.slide
            for j in range(j_lo, j_hi + 1):
                start = j * self.slide
                if start + self.size - 1 > self.wm or self._cleanup(j) <= self.wm:
                    continue
                inside = (t >= start) & (t < start + self.size)
                if inside.any():
                    events.append(("refire", j) + self._window(j, np.unique(k[inside])))
        events += self.advance(watermark)
        return events, side

    def advance(self, watermark: int):
        """The fires of a watermark, then the cleanup of dead slices."""
        events = []
        if self.wm is not None and watermark <= self.wm:
            return events
        j_due = (watermark + 1 - self.size) // self.slide
        if self.oldest is not None:
            lo = self.oldest if self.fired_hi is None else max(self.oldest, self.fired_hi + 1)
            for j in range(lo, min(j_due, self.newest) + 1):
                keys, vals = self._window(j)
                if len(keys):
                    events.append(("fire", j, keys, vals))
        self.fired_hi = j_due if self.fired_hi is None else max(self.fired_hi, j_due)
        self.wm = watermark
        for sl in [sl for sl in self.cnt if self._cleanup(sl * self.g // self.slide) <= watermark]:
            del self.cnt[sl], self.sum[sl]
        return events


# ---------------------------------------------------------------------------
# a keyed changelog for the continuous aggregate: inserts, and retractions
# (-D) of rows inserted earlier and still live
# ---------------------------------------------------------------------------

def changelog_rows(n: int, num_keys: int, retract_frac: float = 0.1, seed: int = SEED):
    """n rows {"k": int, "v": float} (v an integer below 100), a share
    `retract_frac` of them -D retractions of a uniformly chosen live row."""
    from flink_tpu_torch.table.changelog import DELETE, ROW_KIND_FIELD

    rng = np.random.default_rng(seed)
    keys = rng.integers(0, num_keys, n).tolist()
    vals = rng.integers(0, 100, n).astype(np.float64).tolist()
    retract = (rng.random(n) < retract_frac).tolist()
    pick = rng.random(n).tolist()
    live, rows = [], []
    for i in range(n):
        if retract[i] and live:
            j = int(pick[i] * len(live))
            live[j], live[-1] = live[-1], live[j]
            row = dict(live.pop())
            row[ROW_KIND_FIELD] = DELETE
        else:
            row = {"k": keys[i], "v": vals[i]}
            live.append(row)
        rows.append(row)
    return rows
