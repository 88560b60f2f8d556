"""Key-group remapping for rescaling: merge, split and ownership checks.

Counterpart of `flink_tpu/state/key_groups.py`, copied (it is numpy and
plain Python; the port imports nothing of the JAX package).

Key groups are the unit of state redistribution when a keyed job changes
parallelism (reference: StateAssignmentOperation.java:64 — state handles
are re-grouped by KeyGroupRange when the new execution graph deploys).
This module holds the runtime-independent half of that operation so both
the failover rescale-down path and the autoscaler's deliberate rescale
share ONE implementation:

- `ranges_for_parallelism` — the ownership map old/new attempts slice by;
- `merge_keyed_state` / `merge_timers` — fold per-shard heap-table
  snapshots into one logical-state view (disjoint by key group by
  construction, so a plain union is exact);
- `filter_timers_for_range` — the restore-side split: keep only timers
  whose key falls in the restoring subtask's range (heap state tables
  filter themselves by range in state/heap.py restore);
- `reshardable` — device-operator snapshots re-shard inside the sharded
  device state, not via heap-table merge; callers must probe before
  committing to a rescale.

The invariant the property tests pin: for ANY (max_parallelism, old_p,
new_p), every key group is owned by exactly one subtask before and after
the remap — no state lost, none duplicated.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from flink_tpu_torch.core.keygroups import (
    KeyGroupRange,
    assign_to_key_group,
    key_group_range_for_operator,
    operator_index_for_key_group,
)


def ranges_for_parallelism(max_parallelism: int, parallelism: int) -> List[KeyGroupRange]:
    """Per-subtask key-group ownership at the given parallelism."""
    return [
        key_group_range_for_operator(max_parallelism, parallelism, i)
        for i in range(parallelism)
    ]


def owner_of_key_group(max_parallelism: int, parallelism: int, key_group: int) -> int:
    """Subtask index owning `key_group` (range-membership form of
    operator_index_for_key_group — the two must always agree, which the
    property tests assert)."""
    return operator_index_for_key_group(max_parallelism, parallelism, key_group)


def verify_partition(max_parallelism: int, parallelism: int) -> None:
    """Assert the ownership ranges partition [0, max_parallelism): every
    key group in exactly one range, and range membership agrees with
    operator_index_for_key_group. Raises AssertionError otherwise."""
    ranges = ranges_for_parallelism(max_parallelism, parallelism)
    owners: Dict[int, int] = {}
    for idx, rng in enumerate(ranges):
        for kg in rng:
            assert kg not in owners, (
                f"key group {kg} owned by both subtask {owners[kg]} and "
                f"{idx} (max={max_parallelism}, p={parallelism})")
            owners[kg] = idx
            assert owner_of_key_group(max_parallelism, parallelism, kg) == idx
    assert len(owners) == max_parallelism, (
        f"{max_parallelism - len(owners)} key groups unowned "
        f"(max={max_parallelism}, p={parallelism})")


def reshardable(handles: Dict[int, dict]) -> Tuple[bool, str]:
    """Whether a per-shard snapshot set can be re-sharded by heap-table
    merge. Device-operator snapshots (columnar state / fused-count rings)
    re-shard inside the sharded device state instead."""
    for shard in sorted(handles):
        op = handles[shard].get("operator", {})
        if "columnar" in op or "cnt" in op or "pipe" in op \
                or "tier" in op or "tier_changelog" in op:
            # "pipe" = fused-superscan ring state; "tier"/"tier_changelog"
            # = the million-key state plane's full/incremental snapshots —
            # all device-resident (or device-referencing) forms that the
            # heap-table merge cannot re-shard
            return False, (
                "device-operator snapshots re-shard by key group inside "
                "the sharded device state, not via heap-table merge; "
                "rescaling device jobs is not supported yet")
    return True, ""


def merge_keyed_state(per_shard_state: List[Dict[str, Dict[int, dict]]]) -> Dict[str, Dict[int, dict]]:
    """Union per-shard heap state tables ({name: {key_group: {key: val}}}).
    Shards own disjoint key-group ranges, so the union is exact (the
    StateAssignmentOperation merge half)."""
    merged: Dict[str, Dict[int, dict]] = {}
    for tables in per_shard_state:
        for name, table in tables.items():
            dst = merged.setdefault(name, {})
            for kg, entries in table.items():
                dst.setdefault(kg, {}).update(entries)
    return merged


def merge_timers(per_shard_timers: List[Optional[dict]]) -> dict:
    """Concatenate per-shard timer snapshots ({event, proc, watermark});
    the combined watermark is the MIN over shards (what every shard has
    reached)."""
    merged: dict = {"event": [], "proc": [], "watermark": None}
    for t in per_shard_timers:
        if t is None:
            continue
        merged["event"].extend(t.get("event", []))
        merged["proc"].extend(t.get("proc", []))
        wm = t.get("watermark")
        cur = merged["watermark"]
        if wm is not None:
            merged["watermark"] = wm if cur is None else min(cur, wm)
    return merged


def split_merged_snapshot(merged: dict, max_parallelism: int,
                          parallelism: int) -> Dict[int, dict]:
    """JM-side split of a merged logical snapshot: each new subtask ships
    only its own KeyGroupRange slice of state and timers (the collect-sink
    results ride with shard 0). Shipping the full merged state to every
    shard and letting restore-side filtering discard the rest would
    serialize ~parallelism copies of the whole job state over the deploy
    RPCs — exactly the rescale cost the autoscaler treats as the price of
    acting. The restore-side filters still run; on a pre-split slice they
    are no-ops."""
    op = merged.get("operator", {})
    state = op.get("state", {})
    timers = op.get("timers") or {"event": [], "proc": [], "watermark": None}
    out: Dict[int, dict] = {}
    ranges = ranges_for_parallelism(max_parallelism, parallelism)
    for shard, rng in enumerate(ranges):
        shard_state = {
            name: {kg: entries for kg, entries in table.items()
                   if rng.contains(kg)}
            for name, table in state.items()
        }
        out[shard] = {
            **merged,
            "operator": {
                "state": shard_state,
                "timers": filter_timers_for_range(timers, rng,
                                                  max_parallelism),
            },
            "results": list(merged.get("results", [])) if shard == 0 else [],
        }
    return out


def filter_timers_for_range(timers: dict, kg_range: KeyGroupRange,
                            max_parallelism: int) -> dict:
    """Restore-side split of a merged timer snapshot: keep only timers
    whose key's key group falls in this subtask's range. Timer entries are
    (time, key, ...) tuples — key at index 1."""

    def mine(entries: List[Any]) -> List[Any]:
        return [e for e in entries
                if kg_range.contains(assign_to_key_group(e[1], max_parallelism))]

    return {
        "event": mine(timers.get("event", [])),
        "proc": mine(timers.get("proc", [])),
        "watermark": timers.get("watermark"),
    }
