"""Key-group routing for the sharded superscan (parallel.mesh.skew-rebalance).

Counterpart of `flink_tpu/parallel/routing.py`, copied: the layout math is
numpy. `KeyGroupRouting.device_tables` adds the torch form of the [G]
tables the sharded pipeline gathers from on each shard's device.

The static mesh owner function — ``dst = kid // K_local``, contiguous key
ranges per device — is what makes zipf-skewed traffic slow: whichever
device owns the hot key range absorbs the hot keys' full mass while the
rest of the mesh idles. This module replaces it with a ROUTING TABLE over
key-groups (the same contiguous ``kid * G // K`` ranges the key-stats fold
and the reference's KeyGroupRangeAssignment partition by, here exact
``kid // Kg`` because G divides K): ``assign[g]`` names the device that
owns group ``g``, and each device lays the groups it owns out in its local
row space in group-id order. The identity assignment reproduces the static
contiguous layout EXACTLY (device d owns groups d*G/n .. (d+1)*G/n - 1, so
local row = kid - d*K_local) — routing is placement, never semantics.

Hard invariant: every device owns exactly G/n groups. Device state is a
fixed [n, K_local, S] allocation; an assignment that gave one device more
groups than its row space holds would have nowhere to put them. The
balanced LPT planner in ``plan_balanced_assignment`` respects this by
construction, and ``KeyGroupRouting.with_assignment`` validates it.

Snapshots stay canonical [K, S] in global key order: ``to_device_layout``
/ ``to_canonical`` convert between the canonical order and the routed
device-major layout with one host permutation, so checkpoints restore
across any mesh size AND any routing table.

Layering: numpy over plain arrays (the parallel layer — no runtime, no
scheduler; the rebalance POLICY that decides new assignments is
scheduler/rebalancer.py, which imports this module).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch


def choose_key_groups(key_capacity: int, n_shards: int, want: int = 0) -> int:
    """The routing granularity: the largest group count <= `want`
    (0 = auto 128) that is a multiple of the mesh size AND divides the
    key capacity — both required so every device owns exactly G/n groups
    of exactly K/G keys. Floor n_shards (one group per device = the
    static layout, nothing to rebalance but still well-formed)."""
    key_capacity = int(key_capacity)
    n_shards = max(int(n_shards), 1)
    want = int(want) or 128
    want = max(min(want, key_capacity), n_shards)
    g = (want // n_shards) * n_shards
    while g > n_shards and key_capacity % g != 0:
        g -= n_shards
    if g < n_shards or key_capacity % g != 0:
        g = n_shards
    return g


def plan_balanced_assignment(group_loads: np.ndarray, n_shards: int,
                             current: Optional[np.ndarray] = None
                             ) -> np.ndarray:
    """Sticky balanced LPT: sort groups by load descending; each STAYS
    with its current owner while that keeps the owner within ~5% of the
    perfectly even per-device load (and within the G/n slot cap — every
    device must end with exactly G/n groups, the fixed row-space
    invariant), and otherwise moves to the least-loaded open device.
    Stickiness makes an already-balanced placement a fixpoint (uniform
    traffic replans to itself, zero moves) and a skewed one move only
    the groups the imbalance pays for."""
    loads = np.asarray(group_loads, np.float64)
    g = loads.shape[0]
    n = int(n_shards)
    if g % n != 0:
        raise ValueError(f"{g} groups do not divide over {n} shards")
    cap = g // n
    cur = (np.asarray(current, np.int64) if current is not None
           else (np.arange(g, dtype=np.int64) * n) // g)
    target = loads.sum() / n
    order = np.argsort(-loads, kind="stable")
    dev_load = np.zeros(n, np.float64)
    dev_count = np.zeros(n, np.int64)
    assign = np.empty(g, np.int32)
    for gi in order:
        open_devs = np.flatnonzero(dev_count < cap)
        best = open_devs[np.argmin(dev_load[open_devs])]
        owner = int(cur[gi])
        if dev_count[owner] < cap and (
                owner == best
                or dev_load[owner] + loads[gi] <= target * 1.05 + 1e-9):
            best = owner
        assign[gi] = best
        dev_load[best] += loads[gi]
        dev_count[best] += 1
    return assign


def predicted_skew(group_loads: np.ndarray, assign: np.ndarray,
                   n_shards: int) -> float:
    """max/mean per-device load under an assignment (the meshLoadSkew
    this placement would produce if traffic held its shape)."""
    loads = np.asarray(group_loads, np.float64)
    total = float(loads.sum())
    if total <= 0:
        return 1.0
    dev = np.zeros(int(n_shards), np.float64)
    np.add.at(dev, np.asarray(assign, np.int64), loads)
    return float(dev.max() / (total / int(n_shards)))


class KeyGroupRouting:
    """One routing table: assignment + the derived layout permutations.

    ``perm[kid]`` = kid's position in the device-major flat layout
    (device * K_local + slot(group) * Kg + kid % Kg), where slot(group)
    is the group's rank among the groups its device owns, in group-id
    order. ``g_dst``/``g_slot`` are the [G] tables the compiled per-shard
    program gathers from (passed as ARGUMENTS — remapping never
    recompiles)."""

    def __init__(self, key_capacity: int, n_shards: int,
                 num_groups: int = 0, *,
                 assign: Optional[Sequence[int]] = None, version: int = 0):
        self.K = int(key_capacity)
        self.n = max(int(n_shards), 1)
        if self.K % self.n != 0:
            raise ValueError(
                f"key capacity {self.K} must divide over {self.n} shards")
        self.G = choose_key_groups(self.K, self.n, num_groups)
        self.Kg = self.K // self.G
        self.version = int(version)
        if assign is None:
            assign = (np.arange(self.G, dtype=np.int64) * self.n) // self.G
        self._set(np.asarray(assign, np.int32))

    # -- construction / mutation ---------------------------------------
    def _set(self, assign: np.ndarray) -> None:
        if assign.shape != (self.G,):
            raise ValueError(
                f"assignment has {assign.shape} entries, expected {self.G}")
        counts = np.bincount(assign, minlength=self.n)
        if assign.min() < 0 or assign.max() >= self.n or \
                not np.all(counts == self.G // self.n):
            raise ValueError(
                "invalid assignment: every device must own exactly "
                f"G/n = {self.G // self.n} groups (got {counts.tolist()})")
        self.assign = assign.astype(np.int32)
        # slot of group g = rank of g among its owner's groups (stable in
        # group-id order); identity assignment => slot = g % (G/n)
        slot = np.empty(self.G, np.int64)
        for d in range(self.n):
            mine = np.flatnonzero(self.assign == d)
            slot[mine] = np.arange(mine.size)
        self.slot = slot.astype(np.int32)
        kid = np.arange(self.K, dtype=np.int64)
        g = kid // self.Kg
        kl = self.K // self.n
        self.perm = (self.assign[g].astype(np.int64) * kl
                     + self.slot[g].astype(np.int64) * self.Kg
                     + kid % self.Kg)

    def device_tables(self, device) -> tuple:
        """(g_dst, g_slot) as int32 tensors on `device`: the [G] tables
        the owner function gathers from (arguments, never constants — a
        remap swaps the tables)."""
        return (torch.from_numpy(self.assign.astype(np.int32)).to(device),
                torch.from_numpy(self.slot.astype(np.int32)).to(device))

    def with_assignment(self, assign: Sequence[int]) -> "KeyGroupRouting":
        """A new table (version + 1) with the given group->device map."""
        return KeyGroupRouting(self.K, self.n, self.G,
                               assign=assign, version=self.version + 1)

    @property
    def is_identity(self) -> bool:
        return bool(np.array_equal(
            self.assign, (np.arange(self.G, dtype=np.int64) * self.n)
            // self.G))

    # -- layout conversion (host, off the dispatch hot path) -----------
    def to_device_layout(self, canonical: np.ndarray) -> np.ndarray:
        """Canonical [K, ...] rows -> device-major flat [K, ...] rows
        (caller reshapes to [n, K_local, ...])."""
        flat = np.empty_like(canonical)
        flat[self.perm] = canonical
        return flat

    def to_canonical(self, flat: np.ndarray) -> np.ndarray:
        """Device-major flat [K, ...] rows -> canonical key order."""
        return flat[self.perm]

    # -- decision inputs ------------------------------------------------
    def group_loads(self, key_loads: np.ndarray) -> np.ndarray:
        """Fold canonical per-key loads into per-group loads [G]."""
        loads = np.asarray(key_loads, np.int64)
        gid = np.arange(self.K, dtype=np.int64) // self.Kg
        out = np.zeros(self.G, np.int64)
        np.add.at(out, gid, loads)
        return out

    def device_of_groups(self) -> List[List[int]]:
        """Groups per device, for the observability payload."""
        return [np.flatnonzero(self.assign == d).tolist()
                for d in range(self.n)]

    def payload(self) -> dict:
        """JSON-safe routing block for /jobs/:id/device."""
        moved = int(np.sum(self.assign != (
            np.arange(self.G, dtype=np.int64) * self.n) // self.G))
        return {
            "version": self.version,
            "numKeyGroups": self.G,
            "groupsPerDevice": self.G // self.n,
            "movedGroups": moved,
            "assignment": self.assign.tolist(),
        }
