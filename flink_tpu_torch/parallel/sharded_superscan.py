"""Sharded fused superscan: kernel K1 per shard behind the keyBy exchange.

Counterpart of `flink_tpu/parallel/sharded_superscan.py`. `FusedWindowPipeline`
runs the whole T-step window dispatch on one device; this pipeline runs it
over a mesh of n shards (parallel/mesh.py), each owning a contiguous range
of K_local = K / n keys with its own [S, K_local] rings on its own device.

A dispatch, in order:
1. Lanes. The step's global lanes are dealt to the n source shards in
   contiguous chunks of B_s = B / n (any split works: the exchange
   re-routes every record to its key's owner).
2. Exchange first. The owner of a record is a function of its key and the
   routing table alone (`_owner`: static `kid // K_local`, or the table's
   key-group lookup), and the table is fixed within a dispatch, so all T
   steps route at once: ONE exchange a dispatch (ops/exchange.py), where
   the JAX package runs an `all_to_all` inside each scan step. Lanes are
   routed positionally (the JAX protocol: each destination's block keeps
   every lane, the others masked -1), so within a destination the lanes
   stay in source-shard-then-position order — the global order, which
   float min/max ties depend on.
3. K1 once per shard, over the T steps, on the shard's local
   `(kid % K_local) * NSB + rel` lanes (`cuda_superscan.keyed_superscan`;
   its plain version on CPU shards).
4. Fire rows. Each shard fills an [R, K_local] slab; the slabs
   concatenate along the key axis to the canonical [R, K] (permuted back
   to key order under a routing table) and come back in one copy.

With `local_combine` (parallel.mesh.local-combine, decomposable aggregates
only) each source shard segment-reduces its lanes by (owner, key,
rel-slice) with B4 (`ops/superscan.segment_partials`) before the exchange,
so only dense per-destination partials cross; the receiver folds the n
sources' partials with each field's combiner and ingests them through
K1's partials entry (`cuda_superscan.keyed_superscan_partials`). Dense
partials grow with the global K, not the batch, so they cross in step
groups under K1's partials budget (`partial_groups`), one exchange and
one partials launch per shard a group.

With a `TracedPrologue` (whole-graph fusion) each shard runs the torch
prologue — the user's traceable map/filter/map_ts chain and the key/value
extraction — over its slice of the raw source columns before the
exchange, so only keyed survivors cross.

The device plane (`attach_device_stats`): a mesh dispatch is one tracked
program ("sharded_superscan", or "sharded_chained_superscan" with a
prologue), each shard's K1 launches add into the shard's own phase buffer,
and the buffers ride the fire rows' readback into the planner's
`phase_totals`, summed over the shards as the JAX package sums its
per-shard counters (so fire and purge steps count once per shard).
`per_device_key_loads` is the per-shard view the key statistics read.

The planner is the JAX package's shape: a plan-only `FusedWindowPipeline`
over the GLOBAL key space (one source of truth for the window math and
the watermark/fire/purge cursors); every attribute this class does not
define forwards there. With `assigners` (shared partials) the planner is
a plan-only `SharedWindowPipeline`: F is its total fire slots, each
shard's K1 folds every slot with its member's window length
(`slot_spws`), and the fires resolve to `(spec, window)` through the
planner, so correlated windows share one ingest on the mesh as on one
device. Snapshots are canonical [K, S] numpy arrays (plus the members'
`fire_cursors` when shared), interchangeable with single-device and JAX
snapshots at any mesh size, which makes an n -> m rescale a restore.

The tiered-state row surface (`gather_key_rows`, `clear_key_rows`,
`write_cells`, `gather_cells`) reads and writes the canonical [K, S] view
in place: a global key id maps to its shard and local row (through the
routing table when there is one), and each shard's part of a call is one
`index_select`/`index_fill_`/`index_put_` on its own device.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from flink_tpu_torch.ops import cuda_superscan as cs
from flink_tpu_torch.ops.aggregators import VALUE, decomposable, torch_dtype
from flink_tpu_torch.ops.exchange import all_to_all
from flink_tpu_torch.ops.superscan import segment_partials
from flink_tpu_torch.parallel.routing import KeyGroupRouting
from flink_tpu_torch.utils.device import HostCopy, staging_buffer, upload


class ShardedFusedPipeline:
    """Keyed window aggregation over a mesh, T steps per dispatch.

    Presents the pipeline surface `FusedWindowOperator` drives on one
    device (process_superbatch / process_superbatch_raw /
    ensure_key_capacity / snapshot / restore plus the planner-geometry
    delegates), so the operator, and through it the runners, is
    mesh-agnostic."""

    def __init__(
        self,
        mesh,
        assigner,
        aggregate,
        *,
        key_capacity: int,
        num_slices: Optional[int] = None,
        nsb: int = 4,
        fires_per_step: int = 2,
        out_rows: int = 64,
        chunk: int = 1024,
        exact_sums: bool = True,
        axis: str = "shards",
        prologue=None,
        assigners=None,
        local_combine: bool = False,
        skew_routing: bool = False,
        num_key_groups: int = 0,
    ):
        # the runtime's planner is imported here, not at module level: the
        # parallel layer sits below the runtime
        from flink_tpu_torch.runtime.fused_window_pipeline import (
            FusedWindowPipeline,
            SharedWindowPipeline,
        )

        self.mesh = mesh
        self.axis = axis
        self.n = mesh.shape[axis]
        self.devices: List[torch.device] = list(mesh.devices)
        if key_capacity % self.n != 0:
            raise ValueError(f"key_capacity {key_capacity} must divide over {self.n} shards")
        geometry = dict(key_capacity=key_capacity, num_slices=num_slices, nsb=nsb,
                        fires_per_step=fires_per_step, out_rows=out_rows, chunk=chunk,
                        exact_sums=exact_sums, plan_only=True, prologue=prologue,
                        device=self.devices[0])
        # shared partials: the multi-spec planner, whose per-slot window
        # lengths every shard's K1 takes, as on one device
        self._planner = (SharedWindowPipeline(assigners, aggregate, **geometry)
                         if assigners is not None
                         else FusedWindowPipeline(assigner, aggregate, **geometry))
        self.agg = self._planner.agg
        self.prologue = prologue
        self.K = key_capacity
        self.K_local = key_capacity // self.n
        self.S = self._planner.S
        self.NSB = nsb
        self.F = self._planner.F     # total fire slots (members x fires_per_step when shared)
        self.R = out_rows
        self.chunk = chunk
        self.exact = exact_sums
        self._value_fields = [f for f in self.agg.fields if f.source == VALUE]
        self._needs_vals = bool(self._value_fields)
        # the map-side combiner: exact only for decomposable aggregates; any
        # other spec keeps the route-raw exchange
        self.local_combine = bool(local_combine) and decomposable(self.agg)
        # the key-group routing table (the static owner function when None)
        self._num_key_groups = int(num_key_groups)
        self.routing: Optional[KeyGroupRouting] = (
            KeyGroupRouting(key_capacity, self.n, num_key_groups) if skew_routing else None)
        self._tables: Dict[torch.device, tuple] = {}
        self._init_state()
        # latency mode: the mesh keeps span-granular readback (the JAX
        # package's choice: splitting a mesh dispatch multiplies its
        # exchanges); donate_carry is kept for the operator's flag — the
        # rings update in place, so there is no carry to donate
        self.donate_carry = False
        # the device plane: the tracker around each mesh dispatch, the
        # phase counters' flag, and this pipeline's own program table (the
        # JAX package caches a mesh's executables per pipeline)
        self.compile_tracker = None
        self.phase_counters = False
        self._dispatched: Dict[tuple, None] = {}

    # ------------------------------------------------------------------
    # planner delegation: the normalizer and the operator read the window
    # geometry and the cursors of a single-device pipeline; on the mesh
    # they live in the plan-only planner, so every attribute this class
    # does not define forwards there
    # ------------------------------------------------------------------
    def __getattr__(self, name):
        if name == "_planner":   # no recursion before __init__ set it
            raise AttributeError(name)
        return getattr(self._planner, name)

    # ------------------------------------------------------------------
    # the device plane (metrics/device_stats.py)
    # ------------------------------------------------------------------
    def attach_device_stats(self, tracker, phase_counters: bool = True) -> None:
        """Wire a CompileTracker around the mesh dispatch and turn the
        shards' phase counters on. Call before the first dispatch: the phase
        flag is part of the program cache key."""
        self.compile_tracker = tracker
        self.phase_counters = bool(phase_counters)

    @property
    def phase_totals(self):
        return self._planner.phase_totals

    def per_device_key_loads(self) -> torch.Tensor:
        """Per-shard local per-key record counts ([n, K_local] int32, one
        row per shard, on the first shard's device): the input of the
        per-device skew fold."""
        dev = self.devices[0]
        return torch.stack([c.sum(0, dtype=torch.int32).to(dev) for c in self._count])

    def key_stats_ready(self) -> bool:
        return self._planner.max_seen_slice is not None

    def state_row_bytes(self) -> int:
        return self._planner.state_row_bytes()

    def _tracked_dispatch(self, program: str, key: tuple, run, T: int, B: int, fires: int,
                          extra=None):
        """Run `run()` as one tracked mesh dispatch (program, signature
        keys and cache key as the JAX package's)."""
        from flink_tpu_torch.runtime.fused_window_pipeline import DispatchProgram, dtype_signature

        nf = len(self._value_fields)
        K, S, n, Kl = self.K, self.S, self.n, self.K_local
        cost = cs.k1_cost(T=T, B=n * B, K=K, S=S, F=self.F, nf=nf, fires=fires)
        prog = DispatchProgram(
            key, run, lambda: cost,
            lambda: {"temp_bytes": n * cs.partial_bytes(T, Kl, self.NSB, nf),
                     "output_bytes": n * (1 + nf) * self.R * Kl * 4,
                     "argument_bytes": (1 + nf) * S * K * 4 + n * T * B * 4 * (2 if nf else 1)},
            seen=self._dispatched)
        if self.compile_tracker is None:
            return prog()
        sig = {"T": T, "B": B, "K": K, "S": S, "n": n,
               "dtype": dtype_signature(self._value_fields)}
        sig.update(extra or {})
        return self.compile_tracker.call(program, prog, (), sig)

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------
    def _init_state(self) -> None:
        S, Kl = self.S, self.K_local
        self._count = [torch.zeros((S, Kl), dtype=torch.int32, device=d) for d in self.devices]
        self._state = {
            f.name: [torch.full((S, Kl), f.device_identity, dtype=torch_dtype(f.dtype),
                                device=d) for d in self.devices]
            for f in self._value_fields
        }

    def _route_tables(self, device: torch.device) -> tuple:
        """(g_dst, g_slot, perm) of the routing table on `device`."""
        if device not in self._tables:
            r = self.routing
            g_dst, g_slot = r.device_tables(device)
            self._tables[device] = (g_dst, g_slot, torch.from_numpy(r.perm).to(device))
        return self._tables[device]

    def _canonical_arrays(self):
        """(count [K, S], {field: [K, S]}) numpy, in canonical key order."""
        host = HostCopy([t.t() for t in self._count]
                        + [t.t() for f in self._value_fields
                           for t in self._state[f.name]]).wait()
        n = self.n
        count = np.concatenate([h.numpy() for h in host[:n]])
        state = {f.name: np.concatenate([h.numpy() for h in host[n * (i + 1):n * (i + 2)]])
                 for i, f in enumerate(self._value_fields)}
        if self.routing is not None:
            count = self.routing.to_canonical(count)
            state = {k: self.routing.to_canonical(v) for k, v in state.items()}
        return count, state

    def _put_canonical(self, count: np.ndarray, state: Dict[str, np.ndarray]) -> None:
        """Lay canonical [K, S] rows out over the shards."""
        if self.routing is not None:
            count = self.routing.to_device_layout(np.asarray(count))
            state = {k: self.routing.to_device_layout(np.asarray(v)) for k, v in state.items()}
        Kl = self.K_local

        def rings(a, dt):
            a = np.asarray(a)
            return [torch.from_numpy(np.ascontiguousarray(a[d * Kl:(d + 1) * Kl].T))
                    .to(dt).to(dev) for d, dev in enumerate(self.devices)]

        self._count = rings(count, torch.int32)
        self._state = {f.name: rings(state[f.name], torch_dtype(f.dtype))
                       for f in self._value_fields}

    def ensure_key_capacity(self, required: int) -> None:
        """Grow the GLOBAL key dimension when the host dictionary outgrows K
        (classic keyed path only — traced chains fix capacity up front): to
        the next power of two rounded up to a multiple of the mesh size, so
        the contiguous key ranges keep dividing evenly; one canonical host
        round trip, amortized by doubling."""
        if required <= self.K:
            return
        new_k = 1 << (required - 1).bit_length()
        if new_k % self.n != 0:
            new_k = -(-new_k // self.n) * self.n
        pad = new_k - self.K
        count, state = self._canonical_arrays()
        count = np.concatenate([count, np.zeros((pad, self.S), np.int32)])
        state = {f.name: np.concatenate(
                    [state[f.name], np.full((pad, self.S), f.device_identity,
                                            f.device_dtype)])
                 for f in self._value_fields}
        self._set_capacity(new_k)
        self._put_canonical(count, state)

    def _set_capacity(self, new_k: int) -> None:
        self.K = new_k
        self.K_local = new_k // self.n
        self._planner.K = new_k
        if self.routing is not None:
            # the table is sized to K: rebuild at identity over the new
            # capacity (an old-K assignment would be shape-invalid)
            self.routing = KeyGroupRouting(new_k, self.n, self._num_key_groups,
                                           version=self.routing.version + 1)
            self._tables.clear()

    # ------------------------------------------------------------------
    # key-group routing (parallel/routing.py): a remap pulls the canonical
    # state under the old table and re-lays it under the new one
    # ------------------------------------------------------------------
    def set_routing_assignment(self, assign) -> int:
        """Swap in a new group->device map; exact by construction (the
        canonical state never changes, only its placement). Returns the
        new table version."""
        if self.routing is None:
            raise RuntimeError("skew routing is disabled (parallel.mesh.skew-rebalance)")
        count, state = self._canonical_arrays()
        self.routing = self.routing.with_assignment(assign)
        self._tables.clear()
        self._put_canonical(count, state)
        return self.routing.version

    def key_loads(self) -> torch.Tensor:
        """Per-key record counts ([K] int32, canonical key order) on the
        first shard's device."""
        dev = self.devices[0]
        loads = torch.cat([c.sum(0, dtype=torch.int32).to(dev) for c in self._count])
        if self.routing is not None:
            loads = loads.index_select(0, self._route_tables(dev)[2])
        return loads

    def mesh_group_loads(self) -> Optional[np.ndarray]:
        """Per-key-group resident loads [G]; None without a table."""
        if self.routing is None:
            return None
        return self.routing.group_loads(self.key_loads().cpu().numpy())

    # ------------------------------------------------------------------
    # the tiered-state row surface (state/tier_manager.py): the contract of
    # the one-device pipeline's, over the canonical [K, S] view. These
    # shadow the planner delegation (the plan-only planner has no rings);
    # note_external_slices needs no shadow, since the planner's cursors
    # are this pipeline's
    # ------------------------------------------------------------------
    def _shard_rows(self, kids) -> List[tuple]:
        """Global key ids -> per shard j holding any: (j, positions in
        `kids` as int64 numpy, local rows as an int64 tensor on shard j's
        device). Rows are the device layout's: a routing table's `perm`
        gives the device-layout row of each canonical key."""
        k = np.asarray(kids, np.int64).reshape(-1)
        rows = k if self.routing is None else np.asarray(self.routing.perm, np.int64)[k]
        dst = rows // self.K_local
        out = []
        for j, dev in enumerate(self.devices):
            pos = np.flatnonzero(dst == j)
            if pos.size:
                out.append((j, pos, torch.from_numpy(rows[pos] - j * self.K_local).to(dev)))
        return out

    def _rings(self, j: int) -> list:
        return [self._count[j]] + [self._state[f.name][j] for f in self._value_fields]

    def _assemble(self, parts, shape: tuple):
        """Each shard's gathered pieces, copied to the host, -> (count,
        {field}) numpy arrays of `shape` in the caller's key order."""
        host = HostCopy([t for _j, _pos, ts in parts for t in ts]).wait()
        dts = [np.dtype(np.int32)] + [f.device_dtype for f in self._value_fields]
        out = [np.empty(shape, dt) for dt in dts]
        it = iter(host)
        for _j, pos, ts in parts:
            for a in out:
                a[pos] = next(it).numpy()
        return out[0], {f.name: a for f, a in zip(self._value_fields, out[1:])}

    def gather_key_rows(self, kids: np.ndarray):
        """Read whole rows: (counts np[m, S], {field: np[m, S]})."""
        parts = [(j, pos, [r.index_select(1, rows).t() for r in self._rings(j)])
                 for j, pos, rows in self._shard_rows(kids)]
        return self._assemble(parts, (np.asarray(kids).size, self.S))

    def clear_key_rows(self, kids: np.ndarray) -> None:
        """Reset rows to identity (the demotion cut)."""
        for j, _pos, rows in self._shard_rows(kids):
            self._count[j].index_fill_(1, rows, 0)
            for f in self._value_fields:
                self._state[f.name][j].index_fill_(1, rows, f.device_identity)

    def write_cells(self, kids: np.ndarray, spos: np.ndarray, counts: np.ndarray,
                    fields) -> None:
        """Set ring cells (the promotion scatter), cast to the rings' dtypes
        as the one-device pipeline casts them."""
        spos = np.asarray(spos, np.int64).reshape(-1)
        counts = np.asarray(counts).astype(np.int32).reshape(-1)
        vals = {f.name: np.asarray(fields[f.name]).astype(f.device_dtype).reshape(-1)
                for f in self._value_fields}
        for j, pos, rows in self._shard_rows(kids):
            dev = self.devices[j]
            cell = (torch.from_numpy(spos[pos]).to(dev), rows)
            self._count[j].index_put_(cell, torch.from_numpy(counts[pos]).to(dev))
            for f in self._value_fields:
                self._state[f.name][j].index_put_(
                    cell, torch.from_numpy(vals[f.name][pos]).to(dev))

    def gather_cells(self, kids: np.ndarray, spos: np.ndarray):
        """Point-read cells: (counts np[m], {field: np[m]})."""
        spos = np.asarray(spos, np.int64).reshape(-1)
        parts = []
        for j, pos, rows in self._shard_rows(kids):
            srow = torch.from_numpy(spos[pos]).to(self.devices[j])
            parts.append((j, pos, [r[srow, rows] for r in self._rings(j)]))
        return self._assemble(parts, (spos.size,))

    # ------------------------------------------------------------------
    # the dispatch
    # ------------------------------------------------------------------
    def _owner(self, idx: torch.Tensor):
        """(dst, local segment) of each global lane `kid * NSB + rel` on its
        source shard's device; -1 where the lane is dropped."""
        NSB, Kl = self.NSB, self.K_local
        kid = torch.div(idx, NSB, rounding_mode="floor")
        srel = idx - kid * NSB
        valid = (idx >= 0) & (kid < self.K)
        none = torch.full_like(idx, -1)
        if self.routing is None:
            dst = torch.where(valid, kid // Kl, none)
            lidx = torch.where(valid, (kid % Kl) * NSB + srel, none)
            return dst, lidx
        g_dst, g_slot, _perm = self._route_tables(idx.device)
        Kg = self.routing.Kg
        g = torch.where(valid, kid // Kg, 0).long()
        dst = torch.where(valid, g_dst[g], none)
        lidx = torch.where(valid, (g_slot[g] * Kg + kid % Kg) * NSB + srel, none)
        return dst, lidx

    def _plan_on(self, plan, cache: dict, device: torch.device) -> tuple:
        if device not in cache:
            cache[device] = tuple(p.to(device, non_blocking=True) for p in plan)
        return cache[device]

    def route_lanes(self, src_idx: Sequence[torch.Tensor], src_vals):
        """The exchange of a dispatch's lanes: the source shards' [T, B_s]
        global lanes -> per shard j, (idx [T, n * B_s] local lanes, vals
        [T, n * B_s] | None) on its device, -1 where a lane is not j's."""
        n = self.n
        idx_blocks, val_blocks = [], []
        for idx, vals in zip(src_idx, src_vals):
            dst, lidx = self._owner(idx)
            # all n destinations' blocks in one [n, T, B_s] mask
            mine = dst.unsqueeze(0) == torch.arange(n, dtype=dst.dtype,
                                                    device=dst.device)[:, None, None]
            idx_blocks.append(torch.where(mine, lidx.unsqueeze(0), -1).unbind(0))
            if self._needs_vals:
                val_blocks.append(torch.where(mine, vals.unsqueeze(0), 0.0).unbind(0))
        recv_idx = all_to_all(idx_blocks, self.devices, dim=1)
        recv_vals = (all_to_all(val_blocks, self.devices, dim=1) if self._needs_vals
                     else [None] * n)
        return list(zip(recv_idx, recv_vals))

    def partial_groups(self, T: int):
        """The map-side combiner's step groups: consecutive [t0, t1) whose
        partials, as all sources send them, fit in K1's PARTIAL_BUDGET
        bytes (a group holds at least one step). Each source sends dense
        [K_local * NSB] partials per channel to every shard, so a step
        costs n * K * NSB words per channel whatever the batch."""
        step_bytes = self.n * self.K * self.NSB * 4 * (1 + len(self._value_fields))
        per_group = max(1, cs.PARTIAL_BUDGET // step_bytes)
        return [(t0, min(T, t0 + per_group)) for t0 in range(0, T, per_group)]

    def route_partials(self, src_idx: Sequence[torch.Tensor], src_vals, t0: int, t1: int):
        """The map-side combiner's exchange of steps [t0, t1): each source
        shard reduces its lanes into per-destination [t1 - t0, K_local * NSB]
        partials (B4), only those cross, and each shard folds the n
        sources' partials with its fields' combiners (int add fields'
        float32 partials in float32, cast once per cell by K1's partials
        entry) -> per shard j, (count [t1 - t0, K_local, NSB] int32, one
        [t1 - t0, K_local, NSB] partial per VALUE field)."""
        n, Kl, NSB, T = self.n, self.K_local, self.NSB, t1 - t0
        blocks = []
        for idx, vals in zip(src_idx, src_vals):
            dst, lidx = self._owner(idx[t0:t1])
            pidx = torch.where(dst >= 0, dst * (Kl * NSB) + lidx, -1)
            cpart, parts = segment_partials(self.agg, pidx,
                                            None if vals is None else vals[t0:t1],
                                            n * Kl * NSB, exact=self.exact)
            # channel c's block for shard j: [1, T, K_local * NSB]
            blocks.append([[c.view(T, n, Kl * NSB)[:, j].unsqueeze(0) for j in range(n)]
                           for c in (cpart, *parts)])
        recv = [all_to_all([blocks[i][c] for i in range(n)], self.devices)
                for c in range(1 + len(self._value_fields))]
        out = []
        for j in range(n):
            cpart = recv[0][j].sum(0, dtype=torch.int32).view(T, Kl, NSB)
            parts = []
            for c, f in enumerate(self._value_fields, start=1):
                x = recv[c][j]
                p = (x.sum(0, dtype=x.dtype) if f.scatter == "add"
                     else x.amin(0) if f.scatter == "min" else x.amax(0))
                parts.append(p.view(T, Kl, NSB))
            out.append((cpart, parts))
        return out

    def _scan_shards(self, src_idx: Sequence[torch.Tensor], src_vals, plan, fires,
                     key_bounds=None, raw_dtype=None):
        """Exchange the source shards' [T, B_s] lanes, run K1 on every shard
        (one tracked dispatch), and start the canonical fire rows' readback.
        raw_dtype: the traced chain's raw column dtype (its program name)."""
        from flink_tpu_torch.runtime.fused_window_pipeline import (
            DeferredEmissions,
            _dtype_name,
            phase_buffer,
        )

        T = int(plan[0].shape[0])
        B = src_idx[0].numel() // max(T, 1)
        names = [f.name for f in self._value_fields]
        phases = [phase_buffer(self.phase_counters, d) for d in self.devices]

        def run():
            plans: dict = {}
            results = []
            if self.local_combine:
                results = [None] * self.n
                for t0, t1 in self.partial_groups(T):
                    routed = self.route_partials(src_idx, src_vals, t0, t1)
                    for j, (cpart, parts) in enumerate(routed):
                        sub = tuple(p[t0:t1] for p in self._plan_on(plan, plans,
                                                                    self.devices[j]))
                        results[j] = cs.keyed_superscan_partials(
                            self.agg, self._count[j], [self._state[nm][j] for nm in names],
                            cpart, parts, sub, NSB=self.NSB, R=self.R,
                            spws=self._planner.slot_spws(), out=results[j], phase=phases[j])
                    del routed
            else:
                for j, (idx, vals) in enumerate(self.route_lanes(src_idx, src_vals)):
                    results.append(cs.keyed_superscan(
                        self.agg, self._count[j], [self._state[nm][j] for nm in names],
                        idx.reshape(-1), None if vals is None else vals.reshape(-1),
                        self._plan_on(plan, plans, self.devices[j]), NSB=self.NSB, R=self.R,
                        spws=self._planner.slot_spws(), exact=self.exact, phase=phases[j]))
            return results

        flags = (T, B, self.phase_counters, self.local_combine,
                 None if self.routing is None else self.routing.G, self.donate_carry,
                 self.K, self.S)
        if raw_dtype is None:
            results = self._tracked_dispatch("sharded_superscan", ("classic",) + flags, run,
                                             T, B, len(fires))
        else:
            results = self._tracked_dispatch(
                "sharded_chained_superscan", ("raw",) + flags + (raw_dtype,), run, T, B,
                len(fires), {"raw_dtype": _dtype_name(raw_dtype)})
        count_rows, out_rows = self._canonical_fire_rows(results, names, len(fires))
        dev = self.devices[0]
        return DeferredEmissions(
            self._planner, fires, count_rows, out_rows, key_bounds=key_bounds,
            key_capacity=self.K,
            phase_counts=tuple(pc.to(dev, non_blocking=True) for pc in phases
                               if pc is not None))

    def source_lanes(self, staged, T: int):
        """A staged dispatch's lanes dealt to the source shards: (idx, vals,
        key bounds | None), the idx and vals n [T, B_s] chunks on their
        shards' devices. `staged` is stage_superbatch's (idx, vals, plan)
        or stage_superbatch_raw's (raws, srels, tss, plan), whose raw
        columns each shard runs the prologue over."""
        if len(staged) == 3:
            idx_d, vals_d, _plan = staged
            return (self._deal(idx_d.reshape(-1), T, -1),
                    self._deal(vals_d.reshape(-1), T, 0.0) if self._needs_vals
                    else [None] * self.n, None)
        raws, srels, tss, _plan = staged
        src_idx, src_vals, bounds = [], [], []
        for i in range(self.n):
            idx, vals, kb = self._planner._run_prologue(
                raws[i], srels[i], None if tss is None else tss[i])
            src_idx.append(idx.view(T, -1))
            src_vals.append(None if vals is None else vals.view(T, -1))
            bounds.append(kb.to(self.devices[0]))
        # global key bounds: the worst over the shards (each saw only its
        # own lanes)
        kbs = torch.stack(bounds)
        return src_idx, src_vals, torch.stack([kbs[:, 0].max(), kbs[:, 1].min()])

    def _canonical_fire_rows(self, results, names, n_fires: int):
        """Per-shard [R, K_local] slabs -> [rows, K] canonical key order on
        the first shard's device, reading back only the rows the fires use
        (padded to a multiple of 16)."""
        dev = self.devices[0]
        rows = min(self.R, -(-max(n_fires, 1) // 16) * 16)
        count_rows = torch.cat([co[:rows].to(dev) for co, _outs in results], dim=1)
        out_rows = {nm: torch.cat([outs[i][:rows].to(dev) for _co, outs in results], dim=1)
                    for i, nm in enumerate(names)}
        if self.routing is not None:
            perm = self._route_tables(dev)[2]
            count_rows = count_rows.index_select(1, perm)
            out_rows = {nm: o.index_select(1, perm) for nm, o in out_rows.items()}
        return count_rows, out_rows

    def _deal(self, t: torch.Tensor, T: int, fill) -> List[torch.Tensor]:
        """A dispatch's [T*B] lanes on the first shard's device -> n
        contiguous [T, B_s] chunks, chunk i on shard i's device."""
        B = t.numel() // max(T, 1)
        t = t.view(T, B)
        Bs = -(-B // self.n)
        if Bs * self.n != B:
            t = torch.cat([t, torch.full((T, Bs * self.n - B), fill, dtype=t.dtype,
                                         device=t.device)], dim=1)
        return [t[:, i * Bs:(i + 1) * Bs].to(d, non_blocking=True)
                for i, d in enumerate(self.devices)]

    def process_superbatch(self, batches, watermarks, *, staged=None, defer: bool = False):
        """Run T steps in one mesh dispatch (the single-device contract)."""
        if staged is None:
            staged = self.stage_superbatch(batches, watermarks)
        plan = staged[2]
        T = int(plan[0].shape[0])
        src_idx, src_vals, _kb = self.source_lanes(staged, T)
        d = self._scan_shards(src_idx, src_vals, plan[:5], plan[5])
        return d if defer else d.resolve()

    # ------------------------------------------------------------------
    # traced-chain path: each shard runs the prologue on its slice of the
    # raw source columns, then the same exchange and per-shard K1
    # ------------------------------------------------------------------
    def stage_superbatch_raw(self, steps, watermarks):
        """Plan, then stage the raw columns shard-major: one pinned host
        buffer [n, T, B_s, ...] a column, shard i's block uploaded to its
        device. Returns (raws, srels, tss | None: n tensors [T*B_s, ...]
        each, plan on the first shard's device)."""
        raw_t, srel_t, ts_t, arrays, fires = self._planner._stage_raw_host(steps, watermarks)
        T = len(steps)
        n, dev0 = self.n, self.devices[0]

        def shard_major(t, fill):
            if t is None:
                return None
            a = t.numpy()
            trail = a.shape[1:]
            B = a.shape[0] // T
            Bs = -(-B // n)
            host, staged = staging_buffer((n, T, Bs) + trail, a.dtype, dev0)
            a = a.reshape((T, B) + trail)
            if Bs * n != B:
                host[...] = fill
                for i in range(n):
                    lo, hi = i * Bs, min((i + 1) * Bs, B)
                    host[i, :, :hi - lo] = a[:, lo:hi]
            else:
                host[...] = a.reshape((T, n, Bs) + trail).swapaxes(0, 1)
            return [upload(staged[i].view((T * Bs,) + trail), d)
                    for i, d in enumerate(self.devices)]

        plan = self._planner._to_device_plan(arrays, fires)
        return shard_major(raw_t, 0), shard_major(srel_t, -1), shard_major(ts_t, 0), plan

    def process_superbatch_raw(self, steps, watermarks, *, staged=None, defer: bool = False):
        """Run T traced-chain steps in one mesh dispatch (the prologue-bearing
        sibling of process_superbatch; same defer contract)."""
        if staged is None and all(len(step[1]) == 0 for step in steps):
            # watermark-only dispatch: fire/purge through the classic path
            # (the record geometry may still be unknown after a restore)
            empty = [(np.empty(0, np.int32), None, np.empty(0, np.int64)) for _ in steps]
            return self.process_superbatch(empty, watermarks, defer=defer)
        if staged is None:
            staged = self.stage_superbatch_raw(steps, watermarks)
        plan = staged[3]
        T = int(plan[0].shape[0])
        src_idx, src_vals, key_bounds = self.source_lanes(staged, T)
        d = self._scan_shards(src_idx, src_vals, plan[:5], plan[5], key_bounds=key_bounds,
                              raw_dtype=staged[0][0].dtype)
        return d if defer else d.resolve()

    # ------------------------------------------------------------------
    def snapshot(self) -> dict:
        """Canonical [K, S] arrays: interchangeable with the single-device
        pipeline's and the JAX package's snapshots, at any mesh size and
        under any routing table."""
        count, state = self._canonical_arrays()
        p = self._planner
        return {
            "state": state,
            "count": count,
            "watermark": p.watermark,
            "fire_cursor": p.fire_cursor,
            "purged_to": p.purged_to,
            "min_used_slice": p.min_used_slice,
            "max_seen_slice": p.max_seen_slice,
            "num_late_dropped": p.num_late_records_dropped,
            # shared partials: the members' fire cursors are part of the
            # canonical form (the one-device shared pipeline writes them too)
            **({} if getattr(p, "fire_cursors", None) is None
               else {"fire_cursors": list(p.fire_cursors)}),
        }

    def restore(self, snap: dict) -> None:
        """Restore a canonical snapshot of either package, any mesh size."""
        count = np.asarray(snap["count"])
        state = {k: np.asarray(v) for k, v in dict(snap["state"]).items()}
        snap_k = int(count.shape[0])
        if snap_k % self.n != 0:
            # a grown snapshot K need not divide this mesh: identity-pad to
            # the next multiple (rows past the key dictionary are never
            # addressed, so padding is exact)
            pad = -(-snap_k // self.n) * self.n - snap_k
            count = np.concatenate([count, np.zeros((pad, self.S), count.dtype)])
            state = {f.name: np.concatenate(
                        [state[f.name], np.full((pad, self.S), f.device_identity,
                                                f.device_dtype)])
                     for f in self._value_fields}
            snap_k += pad
        if snap_k != self.K:
            self._set_capacity(snap_k)
        self._put_canonical(count, state)
        p = self._planner
        p.watermark = snap["watermark"]
        p.fire_cursor = snap["fire_cursor"]
        p.purged_to = snap["purged_to"]
        p.min_used_slice = snap["min_used_slice"]
        p.max_seen_slice = snap["max_seen_slice"]
        p.num_late_records_dropped = snap["num_late_dropped"]
        if getattr(p, "fire_cursors", None) is not None:
            p.fire_cursors = list(snap["fire_cursors"])
