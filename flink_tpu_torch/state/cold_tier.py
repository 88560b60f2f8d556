"""Cold-key state tier: per-(key, slice) accumulator rows in the native
spill store, for key cardinalities beyond the device's ring rows.

Counterpart of `flink_tpu/state/cold_tier.py`, copied. The role
RocksDB/ForSt play in the reference (state larger than memory, S3/S4:
RocksDBKeyedStateBackend / ForStKeyedStateBackend): the hot dense ids stay
as device ring rows; the others aggregate host-side into the batched C++
LSM (native/spill_store.cpp via utils/native_bridge.NativeSpillStore).

Layout: store key = s_abs * (1<<32) + cold_kid (absolute slice, so ring
reuse never aliases history); value = one f64 per accumulator field plus
the count. All accesses are batched multi-get/multi-put — the ForSt
batching pattern (ForStGeneralMultiGetOperation.java).

A pure-Python dict store keeps the capability without a compiler, as in
the JAX package. The chaos plane's storage seam covers the cold tier's
reads (site ``cold-tier:<what>``), as the JAX package's does.
"""

from __future__ import annotations

import tempfile
from typing import Dict, Optional, Tuple

import numpy as np

from flink_tpu_torch.chaos import plan as _chaos
from flink_tpu_torch.ops.aggregators import ONE, DeviceAggregator

_COMBINE = {
    "add": lambda a, b: a + b,
    "min": np.minimum,
    "max": np.maximum,
}

_SLICE_SHIFT = np.uint64(32)


class ColdTierError(RuntimeError):
    """A cold-tier artifact is missing or unreadable (corrupt manifest,
    store-kind mismatch, decode failure). Typed so restore paths can treat
    a broken cold artifact like a corrupt checkpoint — skip back to an
    older complete one — instead of dying on a raw pickle/base64 error."""


class _PyStoreFallback:
    """dict-backed stand-in with the NativeSpillStore surface."""

    def __init__(self, width: int):
        self.width = width
        self._d: Dict[int, bytes] = {}

    def put_batch(self, keys, values):
        values = np.ascontiguousarray(values).reshape(len(keys), self.width)
        for k, v in zip(keys.tolist(), values):
            self._d[int(k)] = v.tobytes()

    def get_batch(self, keys):
        out = np.zeros((len(keys), self.width), dtype=np.uint8)
        found = np.zeros(len(keys), dtype=bool)
        for i, k in enumerate(keys.tolist()):
            b = self._d.get(int(k))
            if b is not None:
                out[i] = np.frombuffer(b, dtype=np.uint8)
                found[i] = True
        return out, found

    def flush(self):
        return 0

    def compact(self):
        return 0

    def purge_below(self, threshold: int) -> int:
        dead = [k for k in self._d if k < threshold]
        for k in dead:
            del self._d[k]
        return len(dead)

    @property
    def mem_entries(self) -> int:
        return len(self._d)

    def checkpoint(self) -> str:
        import base64
        import pickle

        return "py:" + base64.b64encode(pickle.dumps(self._d)).decode()

    def restore(self, manifest: str) -> None:
        import base64
        import pickle

        if not isinstance(manifest, str) or not manifest.startswith("py:"):
            raise ColdTierError(
                "cold-tier manifest is not a python-store artifact (was "
                "this snapshot taken by the native LSM store?)")
        try:
            self._d = pickle.loads(base64.b64decode(manifest[3:]))
        except Exception as e:  # noqa: BLE001 — surface as a typed artifact
            raise ColdTierError(
                f"corrupt cold-tier manifest: {e!r}") from e


class ColdKeyTier:
    """Host/LSM accumulator rows for cold dense key ids."""

    def __init__(self, agg: DeviceAggregator, ring_slices: int,
                 directory: Optional[str] = None,
                 flush_threshold: int = 1 << 18,
                 purge_granularity: Optional[int] = None,
                 gc_retained: int = 4):
        self.agg = agg
        self.S = ring_slices
        self.fields = list(agg.fields)
        self.width = (len(self.fields) + 1) * 8  # f64 per field + count
        self.dir = directory or tempfile.mkdtemp(prefix="flink_tpu_torch_cold_")
        try:
            from flink_tpu_torch.utils.native_bridge import NativeSpillStore

            self.store = NativeSpillStore(self.width, self.dir)
            self.native = True
        except (RuntimeError, OSError):
            self.store = _PyStoreFallback(self.width)
            self.native = False
        self.num_cold_rows_written = 0
        self.num_cold_rows_purged = 0
        # Disk GC window: keep run files reachable from this many recent
        # manifests INCLUDING the in-flight one. Must be >= the checkpoint
        # coordinator's max_retained + 1, or a failed in-flight checkpoint
        # could orphan the oldest retained checkpoint's files.
        self.gc_retained = gc_retained
        self._retained_manifests: list = []
        self._gc_holdoff = 0
        # memtable spills to a sorted run past this size (bounds host RSS)
        self.flush_threshold = flush_threshold
        # retention cuts batch up: purge once the slice frontier has moved
        # this many slices past the last cut (a per-watermark purge would
        # rewrite run files constantly)
        self.purge_granularity = purge_granularity or max(ring_slices // 4, 16)
        self._purged_to_slice: Optional[int] = None

    # ------------------------------------------------------------------
    def _store_keys(self, cold_kid: np.ndarray, s_abs: np.ndarray) -> np.ndarray:
        return (s_abs.astype(np.uint64) << _SLICE_SHIFT) | cold_kid.astype(np.uint64)

    def ingest(self, cold_kid: np.ndarray, s_abs: np.ndarray, vals: np.ndarray) -> None:
        """Aggregate a batch of cold-key records into the store (read-combine
        -write on the unique (key, slice) cells)."""
        if len(cold_kid) == 0:
            return
        skeys = self._store_keys(cold_kid, s_abs)
        uniq, inverse = np.unique(skeys, return_inverse=True)
        rows = np.zeros((len(uniq), len(self.fields) + 1), dtype=np.float64)
        for fi, f in enumerate(self.fields):
            src = np.ones(len(vals)) if f.source == ONE else vals.astype(np.float64)
            if f.scatter == "add":
                np.add.at(rows[:, fi], inverse, src)
            elif f.scatter == "min":
                rows[:, fi] = np.asarray(f.identity, dtype=np.float64)
                np.minimum.at(rows[:, fi], inverse, src)
            else:
                rows[:, fi] = np.asarray(f.identity, dtype=np.float64)
                np.maximum.at(rows[:, fi], inverse, src)
        np.add.at(rows[:, -1], inverse, 1.0)

        old, found = self.store.get_batch(uniq)
        old_rows = old.view(np.float64).reshape(len(uniq), len(self.fields) + 1)
        for fi, f in enumerate(self.fields):
            rows[found, fi] = _COMBINE[f.scatter](rows[found, fi], old_rows[found, fi])
        rows[found, -1] += old_rows[found, -1]
        self.store.put_batch(uniq, rows.view(np.uint8))
        self.num_cold_rows_written += len(uniq)
        if self.store.mem_entries >= self.flush_threshold:
            self.store.flush()

    def fire(self, num_cold: int, slice_range) -> Tuple[np.ndarray, np.ndarray]:
        """Combine a window's slices for every cold key.
        Returns (result[num_cold] of agg.result_dtype, counts[num_cold])."""
        nf = len(self.fields)
        acc = np.tile(
            np.asarray([f.identity for f in self.fields], dtype=np.float64),
            (max(num_cold, 1), 1),
        )
        counts = np.zeros(max(num_cold, 1), dtype=np.float64)
        if num_cold == 0:
            return acc[:0, 0], counts[:0]
        ckids = np.arange(num_cold, dtype=np.uint64)
        for s in slice_range:
            skeys = self._store_keys(ckids, np.full(num_cold, s, dtype=np.int64))
            vals, found = self.store.get_batch(skeys)
            rows = vals.view(np.float64).reshape(num_cold, nf + 1)
            for fi, f in enumerate(self.fields):
                acc[found, fi] = _COMBINE[f.scatter](acc[found, fi], rows[found, fi])
            counts[found] += rows[found, -1]
        fields = {f.name: acc[:, fi].astype(f.dtype) for fi, f in enumerate(self.fields)}
        result = np.asarray(self.agg.extract(fields), dtype=self.agg.result_dtype)
        return result, counts

    # -- tier-manager surface (state/tier_manager.py) -------------------
    def _guarded_get(self, skeys: np.ndarray, site: str):
        """All promotion/fire reads go through here: a failed read surfaces
        as :class:`ColdTierError`. The chaos plane's storage seam covers the
        cold tier (site ``cold-tier:<what>``), so a drill can model a lost
        or corrupt cold artifact mid-promotion; one is-None check when chaos
        is off."""
        hook = _chaos.HOOK
        if hook is not None:
            hook("storage", f"cold-tier:{site}")
        try:
            return self.store.get_batch(skeys)
        except ColdTierError:
            raise
        except Exception as e:  # noqa: BLE001 — typed artifact error
            raise ColdTierError(f"cold-tier read failed: {e!r}") from e

    def absorb_rows(self, cold_kid: np.ndarray, s_abs: np.ndarray,
                    rows: np.ndarray, counts: np.ndarray) -> None:
        """Merge PRE-AGGREGATED per-(key, slice) rows into the store —
        the demotion path: a hot HBM row's live cells move here when its
        key is evicted. `rows` is [m, num_fields] in field order, `counts`
        [m]; cells already present combine by each field's scatter op
        (so demote-then-reingest and plain ingest are order-independent)."""
        if len(cold_kid) == 0:
            return
        skeys = self._store_keys(np.asarray(cold_kid, np.uint64),
                                 np.asarray(s_abs))
        uniq, inverse = np.unique(skeys, return_inverse=True)
        nf = len(self.fields)
        merged = np.zeros((len(uniq), nf + 1), dtype=np.float64)
        for fi, f in enumerate(self.fields):
            if f.scatter != "add":
                merged[:, fi] = np.asarray(f.identity, dtype=np.float64)
            getattr(np, {"add": "add", "min": "minimum", "max": "maximum"}
                    [f.scatter]).at(merged[:, fi], inverse,
                                    np.asarray(rows[:, fi], np.float64))
        np.add.at(merged[:, -1], inverse, np.asarray(counts, np.float64))
        old, found = self.store.get_batch(uniq)
        old_rows = old.view(np.float64).reshape(len(uniq), nf + 1)
        for fi, f in enumerate(self.fields):
            merged[found, fi] = _COMBINE[f.scatter](
                merged[found, fi], old_rows[found, fi])
        merged[found, -1] += old_rows[found, -1]
        self.store.put_batch(uniq, merged.view(np.uint8))
        self.num_cold_rows_written += len(uniq)
        if self.store.mem_entries >= self.flush_threshold:
            self.store.flush()

    def read_rows(self, cold_kid: int, slices: np.ndarray):
        """Promotion read: one cold key's rows at `slices` (absolute).
        Returns (rows [m, num_fields] f64, counts [m] f64, found [m]
        bool). Raises :class:`ColdTierError` on an unreadable artifact."""
        slices = np.asarray(slices, dtype=np.int64)
        nf = len(self.fields)
        if slices.size == 0:
            return (np.zeros((0, nf), np.float64), np.zeros(0, np.float64),
                    np.zeros(0, bool))
        skeys = self._store_keys(
            np.full(slices.size, cold_kid, np.uint64), slices)
        vals, found = self._guarded_get(skeys, "get")
        rows = vals.view(np.float64).reshape(slices.size, nf + 1)
        return rows[:, :nf].copy(), rows[:, -1].copy(), found

    def clear_rows(self, cold_kid: int, slices: np.ndarray) -> None:
        """Promotion cut: overwrite one cold key's rows at `slices` with
        identity/zero-count rows (the store has no point delete; a
        zero-count row reads as absent everywhere)."""
        slices = np.asarray(slices, dtype=np.int64)
        if slices.size == 0:
            return
        skeys = self._store_keys(
            np.full(slices.size, cold_kid, np.uint64), slices)
        nf = len(self.fields)
        rows = np.tile(
            np.asarray([f.identity for f in self.fields] + [0.0],
                       dtype=np.float64),
            (slices.size, 1))
        self.store.put_batch(skeys, rows.view(np.uint8))

    def fire_ids(self, cold_kids: np.ndarray, slice_range):
        """Window fire over an EXPLICIT cold-id set (the tier manager's
        touched-slice index bounds it): combine the window's slices for
        those ids only — O(touched x slices-per-window), never O(all cold
        keys). Returns (fields {name: [m]}, counts [m] f64)."""
        cold_kids = np.asarray(cold_kids, dtype=np.uint64)
        m = len(cold_kids)
        nf = len(self.fields)
        acc = np.tile(
            np.asarray([f.identity for f in self.fields], dtype=np.float64),
            (max(m, 1), 1))
        counts = np.zeros(max(m, 1), dtype=np.float64)
        if m == 0:
            return {f.name: acc[:0, fi] for fi, f in enumerate(self.fields)}, \
                counts[:0]
        for s in slice_range:
            skeys = self._store_keys(
                cold_kids, np.full(m, s, dtype=np.int64))
            vals, found = self._guarded_get(skeys, "fire")
            rows = vals.view(np.float64).reshape(m, nf + 1)
            for fi, f in enumerate(self.fields):
                acc[found, fi] = _COMBINE[f.scatter](
                    acc[found, fi], rows[found, fi])
            counts[found] += rows[found, -1]
        fields = {f.name: acc[:, fi].astype(f.dtype)
                  for fi, f in enumerate(self.fields)}
        return fields, counts

    def approx_bytes(self) -> int:
        """Resident cold-store footprint estimate (memtable rows x row
        width) — the spilledBytes gauge's source. Spilled run files on
        disk are deliberately not walked per gauge read."""
        return int(self.store.mem_entries) * self.width

    def purge_below_slice(self, frontier_slice: int) -> None:
        """Retention cut: rows for slices below `frontier_slice` can never
        fire again (every window containing them has fired and purged) —
        delete them so the store tracks the live window span instead of the
        whole stream history. Cuts are batched by `purge_granularity`."""
        if (self._purged_to_slice is not None
                and frontier_slice - self._purged_to_slice < self.purge_granularity):
            return
        self._purged_to_slice = frontier_slice
        if frontier_slice <= 0:
            return
        threshold = int(np.uint64(frontier_slice) << _SLICE_SHIFT)
        self.num_cold_rows_purged += self.store.purge_below(threshold)

    # ------------------------------------------------------------------
    def snapshot(self) -> dict:
        manifest = self.store.checkpoint()
        if self.native:
            # disk GC: files outside the retained-manifest window and the
            # live run list are unreachable (every run a future restore can
            # name lives in one of these manifests)
            self._retained_manifests.append(manifest)
            if len(self._retained_manifests) > self.gc_retained:
                self._retained_manifests = \
                    self._retained_manifests[-self.gc_retained:]
            if self._gc_holdoff > 0:
                self._gc_holdoff -= 1
            else:
                try:
                    self.store.gc(self._retained_manifests)
                except OSError:
                    pass  # GC is best-effort; correctness is unaffected
        return {"manifest": manifest, "dir": self.dir,
                "native": self.native, "purged_to_slice": self._purged_to_slice}

    def restore(self, snap: dict) -> None:
        # adopt the snapshot's store kind + directory: a rebuilt operator
        # (restart with an unconfigured cold-dir) gets a fresh temp dir,
        # but a NATIVE manifest names run files relative to the dir the
        # snapshot was taken over — restoring it anywhere else reads
        # nothing. The py manifest is self-contained; a py snapshot into a
        # native instance downgrades to the py store (correct either way).
        if snap.get("native"):
            if not self.native:
                raise ColdTierError(
                    "cold-tier snapshot was taken by the native LSM store "
                    "but this build has no native bridge")
            if snap.get("dir") and snap["dir"] != self.dir:
                from flink_tpu_torch.utils.native_bridge import NativeSpillStore

                self.dir = snap["dir"]
                self.store = NativeSpillStore(self.width, self.dir)
        elif self.native:
            self.store = _PyStoreFallback(self.width)
            self.native = False
        try:
            self.store.restore(snap["manifest"])
        except ColdTierError:
            raise
        except Exception as e:  # noqa: BLE001 — typed artifact error
            raise ColdTierError(
                f"cold-tier restore failed: {e!r}") from e
        # A fresh instance must not GC away files that checkpoints from
        # BEFORE the restore still reference (the coordinator may retain
        # several older than the one restored, and their manifests are not
        # knowable here): hold GC off until gc_retained NEW checkpoints have
        # completed, by which time the retention window has provably rolled
        # past every pre-restore checkpoint.
        self._retained_manifests = [snap["manifest"]]
        self._gc_holdoff = self.gc_retained
        self._purged_to_slice = snap.get("purged_to_slice")

    def compact(self) -> None:
        self.store.compact()
