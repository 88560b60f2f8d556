"""Key-space telemetry: per-key-group load, hot keys, and skew, folded on
the device.

Counterpart of `flink_tpu/metrics/key_stats.py`: `KeyStatsCollector` is
the JAX package's as it is (throttle, ready probe, `register`, `payload`,
the per-device mesh view); the fold is torch code on the loads' device.
The window operators hold per-(key, slice) record counts resident on the
device, so the whole fold is one segment-sum over data already there —
per-key loads, a contiguous-range key-group histogram (the same
``kid * G // K`` ranges the sharded superscan partitions by), top-K hot
keys, and a skew coefficient:

    skew = max key-group load / mean key-group load

1.0 is a perfectly even key space; G (the key-group count) is one group
owning everything. The autoscaler consumes the job-level gauge as an
optional signal (scheduler/signals.py — absent reads as None, never 0.0).

Collection is PULL-based and throttled: ``maybe_collect`` costs one clock
read when the interval has not elapsed (the O(1)-host-work contract for
per-batch callers); a due collection runs the fold and reads back a few
KB (the [G] histogram + top-K + scalars) in one copy, never the [K]
column. That copy waits for the work queued before it on the loads'
stream (an in-flight dispatch), once per interval.

Layering: metrics sits below the runtime. The operator hands in a
``loads_fn`` returning its device-resident per-key count column (a torch
tensor, or anything numpy reads).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch


def fold_loads(loads: torch.Tensor, G: int, top_k: int) -> torch.Tensor:
    """The device fold: per-key loads [K] -> ONE packed int32 vector
    [per-group histogram [G] | per-group active-key counts [G] |
    top-K values | top-K ids | total | max], on the loads' device. A single
    output means a single device->host copy per collection (the JAX
    fold's contract). Key-group of dense key id: ``kid * G // K``.

    int32 throughout, as the JAX fold computes (resident record counts,
    sums wrapping in int32). The top-K keeps the lower key id first among
    equal loads, as `jax.lax.top_k` does: it ranks the unique int64 key
    load * K + (K - 1 - id)."""
    loads = loads.reshape(-1).to(torch.int32)
    K = loads.shape[0]
    dev = loads.device
    ids = torch.arange(K, dtype=torch.int64, device=dev)
    gids = ids * G // K
    per_group = torch.zeros(G, dtype=torch.int32, device=dev).index_add_(0, gids, loads)
    active = torch.zeros(G, dtype=torch.int32, device=dev).index_add_(
        0, gids, (loads > 0).to(torch.int32))
    rank = loads.to(torch.int64) * K + (K - 1 - ids)
    top_i = torch.topk(rank, top_k).indices
    top_v = loads[top_i]
    return torch.cat([per_group, active, top_v, top_i.to(torch.int32),
                      torch.stack([loads.sum(dtype=torch.int32), loads.max()])])


def _host(a) -> np.ndarray:
    """A tensor (any device) or array-like as numpy: one copy."""
    if isinstance(a, torch.Tensor):
        return a.cpu().numpy()
    return np.asarray(a)


def _stats(arr: np.ndarray) -> Dict[str, float]:
    """min/max/mean/percentile summary of a small host array (the [G]
    histogram) in the registry's histogram-stats dict shape, so the gauge
    ships over metrics_snapshot and renders as a Prometheus summary."""
    if arr.size == 0:
        return {"count": 0}
    s = np.sort(arr)
    return {
        "count": int(arr.size),
        "min": float(s[0]),
        "max": float(s[-1]),
        "mean": float(s.mean()),
        "p50": float(s[arr.size // 2]),
        "p95": float(s[min(int(0.95 * arr.size), arr.size - 1)]),
        "p99": float(s[min(int(0.99 * arr.size), arr.size - 1)]),
    }


class KeyStatsCollector:
    """Throttled device-fold collector for one keyed window operator."""

    def __init__(self, loads_fn: Callable[[], Any], *,
                 num_key_groups: int = 128, top_k: int = 8,
                 row_bytes_fn: Optional[Callable[[], int]] = None,
                 ready_fn: Optional[Callable[[], bool]] = None,
                 interval_ms: int = 1000,
                 clock: Callable[[], float] = time.monotonic,
                 mesh_loads_fn: Optional[Callable[[], Any]] = None):
        self._loads_fn = loads_fn
        # the mesh (parallel/sharded_superscan.py): [n, K_local] per-device
        # local loads. The GLOBAL histogram cannot see device imbalance —
        # contiguous key ranges mean one device can own every hot key-group
        # while the global skew reads even per-group — so the mesh fold
        # keeps per-device load/skew and the scalar gauges take the MAX
        # across devices (never device 0's view)
        self._mesh_loads_fn = mesh_loads_fn
        self.num_key_groups = max(int(num_key_groups), 1)
        self.top_k = max(int(top_k), 1)
        self._row_bytes_fn = row_bytes_fn
        # O(1) host probe for "device state holds data": a fused operator
        # buffers steps host-side until its first superbatch dispatch, and
        # a fold before that would burn the whole interval reading an
        # empty ring (a short job would then finish with no skew
        # measurement at all). None = always ready (per-batch-ingest
        # operators fill state immediately).
        self._ready_fn = ready_fn
        self.interval_s = max(int(interval_ms), 0) / 1000.0
        self._clock = clock
        self._lock = threading.Lock()
        self._last_t: Optional[float] = None
        # latest fold results (host scalars / small arrays)
        self._skew: Optional[float] = None
        self._total = 0
        self._max = 0
        self._active_keys = 0
        self._hot: List[List[int]] = []          # [[kid, count], ...]
        self._group_load: Dict[str, float] = {"count": 0}
        self._group_state_bytes: Dict[str, float] = {"count": 0}
        # per-mesh-device view: [{device, records, activeKeys, keySkew}]
        self._per_device: List[Dict[str, float]] = []
        self._mesh_load_skew: Optional[float] = None

    # -- collection --------------------------------------------------------
    def maybe_collect(self, now: Optional[float] = None) -> bool:
        """Run the fold when state is resident and the interval elapsed;
        O(1) host work otherwise (one readiness bool + one clock read)."""
        if self._ready_fn is not None:
            try:
                if not self._ready_fn():
                    return False
            except Exception:  # noqa: BLE001
                return False
        now = self._clock() if now is None else now
        if self._last_t is not None and now - self._last_t < self.interval_s:
            return False
        self._last_t = now
        return self.collect()

    def collect(self) -> bool:
        """One device fold + tiny host readback; safe anytime (reads the
        operator's immutable-per-step device arrays)."""
        try:
            loads = self._loads_fn()
        except Exception:  # noqa: BLE001 — a torn-down operator must not
            return False   # fail the sampling tick
        if loads is None:
            return False
        K = int(loads.shape[0])
        if K == 0:
            return False
        G = min(self.num_key_groups, K)
        k = min(self.top_k, K)
        try:
            packed = _host(fold_loads(torch.as_tensor(loads), G, k))
            per_group = packed[:G]
            active = packed[G:2 * G]
            top_v = packed[2 * G:2 * G + k]
            top_i = packed[2 * G + k:2 * G + 2 * k]
            total = int(packed[-2])
            mx = int(packed[-1])
        except Exception:  # noqa: BLE001 — observability never fails the job
            return False
        row_bytes = 0
        if self._row_bytes_fn is not None:
            try:
                row_bytes = int(self._row_bytes_fn())
            except Exception:  # noqa: BLE001
                row_bytes = 0
        per_device, mesh_load_skew = self._collect_per_device()
        mean_group = total / G
        with self._lock:
            self._total = total
            self._max = mx
            self._active_keys = int(active.sum())
            self._skew = (float(per_group.max()) / mean_group
                          if total > 0 else None)
            self._hot = [[int(i), int(v)] for i, v in zip(top_i, top_v)
                         if v > 0]
            self._group_load = _stats(per_group)
            self._group_state_bytes = _stats(
                active.astype(np.int64) * row_bytes)
            self._per_device = per_device
            self._mesh_load_skew = mesh_load_skew
        return True

    def _collect_per_device(self):
        """Mesh fold: one [n, K_local] readback -> per-device resident
        records, active keys, and the worst GLOBAL key-group load among
        the groups the device's key range intersects (against the global
        mean group load). Attributing the FULL global group load — not
        just the device's partial slice — keeps max-over-devices equal to
        the global skew even when a group straddles a device boundary
        (non-pow2 capacities after growth), so the scalar gauges stay
        path-independent. Returns ([], None) off the mesh."""
        if self._mesh_loads_fn is None:
            return [], None
        try:
            mloads = self._mesh_loads_fn()
        except Exception:  # noqa: BLE001 — observability never fails the job
            return [], None
        if mloads is None:
            return [], None
        m = _host(mloads)
        if m.ndim != 2 or m.shape[0] < 2:
            return [], None
        n_dev, kl = m.shape
        k_total = n_dev * kl
        g = min(self.num_key_groups, k_total)
        gids = (np.arange(k_total, dtype=np.int64) * g) // k_total
        total = int(m.sum())
        mean_group = total / g if g else 0.0
        grp = np.zeros(g, np.int64)
        np.add.at(grp, gids, m.reshape(-1).astype(np.int64))
        per_device: List[Dict[str, Any]] = []
        for d in range(n_dev):
            loads_d = m[d].astype(np.int64)
            owned = grp[np.unique(gids[d * kl:(d + 1) * kl])]
            per_device.append({
                "device": d,
                "records": int(loads_d.sum()),
                "activeKeys": int((loads_d > 0).sum()),
                "hotKeyLoad": int(loads_d.max()) if kl else 0,
                "keySkew": (round(float(owned.max()) / mean_group, 4)
                            if mean_group > 0 and owned.size else None),
            })
        mesh_load_skew = None
        if total > 0:
            mean_dev = total / n_dev
            mesh_load_skew = round(
                max(e["records"] for e in per_device) / mean_dev, 4)
        return per_device, mesh_load_skew

    # -- gauges ------------------------------------------------------------
    def skew(self) -> Optional[float]:
        """max/mean key-group load; None until data has been folded (an
        absent gauge must read as absent downstream, never as 0 skew)."""
        with self._lock:
            return None if self._skew is None else round(self._skew, 4)

    def active_keys(self) -> int:
        with self._lock:
            return self._active_keys

    def hot_keys(self) -> List[List[int]]:
        with self._lock:
            return [list(e) for e in self._hot]

    def hot_key_load(self) -> int:
        """Resident record count of the hottest key (locked: collect()
        reassigns the list wholesale from the task thread)."""
        with self._lock:
            return self._hot[0][1] if self._hot else 0

    def mesh_load_skew(self) -> Optional[float]:
        """max/mean per-device resident records across the mesh (1.0 even,
        n = one device owns everything); None off the mesh or pre-fold."""
        with self._lock:
            return self._mesh_load_skew

    def per_device(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(e) for e in self._per_device]

    def _per_device_map(self, field: str) -> Dict[str, float]:
        with self._lock:
            return {str(e["device"]): e[field] for e in self._per_device
                    if e.get(field) is not None}

    def register(self, group) -> None:
        # skew/hot-key gauges fold MAX: the job's skew is its worst shard
        group.gauge("keySkew", self.skew, fold="max")
        group.gauge("activeKeys", self.active_keys, fold="sum")
        group.gauge("hotKeyLoad", self.hot_key_load, fold="max")
        # histogram-stats-shaped dict gauges: ship on metrics_snapshot and
        # render as Prometheus summaries, like shipped histograms do
        # (fold "hist": the generic approx stats envelope)
        group.gauge("keyGroupLoad", lambda: dict(self._group_load),
                    fold="hist")
        group.gauge("keyGroupStateBytes",
                    lambda: dict(self._group_state_bytes),
                    fold="hist")
        if self._mesh_loads_fn is not None:
            # per-mesh-device maps ({device: value}): declared
            # "per-device-max" so the JM's aggregate_shard_metrics folds
            # MAX across the shard's own devices FIRST (an imbalanced mesh
            # must be visible as its WORST device, never device 0's view)
            group.gauge("meshLoadSkew", self.mesh_load_skew, fold="max")
            group.gauge("meshDeviceLoad",
                        lambda: self._per_device_map("records"),
                        fold="per-device-max")
            group.gauge("keySkewPerDevice",
                        lambda: self._per_device_map("keySkew"),
                        fold="per-device-max")
            group.gauge("hotKeyLoadPerDevice",
                        lambda: self._per_device_map("hotKeyLoad"),
                        fold="per-device-max")

    # -- exposure ----------------------------------------------------------
    def payload(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "keySkew": (None if self._skew is None
                            else round(self._skew, 4)),
                "activeKeys": self._active_keys,
                "totalRecordsResident": self._total,
                "maxKeyLoad": self._max,
                "numKeyGroups": self.num_key_groups,
                "hotKeys": [list(e) for e in self._hot],
                "keyGroupLoad": dict(self._group_load),
                "keyGroupStateBytes": dict(self._group_state_bytes),
                "perDevice": [dict(e) for e in self._per_device],
                "meshLoadSkew": self._mesh_load_skew,
            }
