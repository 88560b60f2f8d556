"""State Processor API: offline read / transform / bootstrap of savepoints.

Counterpart of `flink_tpu/state_processor.py`, copied. Both packages'
savepoints hold the JAX form (numpy `[K, S]` rings, the fused operator's
`pipe`, `keydict`, `normalizer`, `fields` and `geometry`), so a savepoint
written, patched or renamed by either package is read here and resumes in
either; a fused operator's ring is what kernel K1 left in it.

Capability parity with flink-state-processing-api (SavepointReader.java:59,
SavepointWriter.java:62): load a savepoint, enumerate operators, read keyed
state (both heap-operator snapshots and device columnar-window snapshots),
transform or bootstrap state, and write a new savepoint that jobs can
restore from (operator-uid remapping contract, SURVEY §2.6 S10).
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from flink_tpu_torch.checkpoint.storage import FsCheckpointStorage


class SavepointReader:
    def __init__(self, data: dict):
        self.data = data

    @staticmethod
    def load(path: str) -> "SavepointReader":
        storage = FsCheckpointStorage(path)
        latest = storage.latest()
        if latest is None:
            raise FileNotFoundError(f"no savepoint/checkpoint under {path}")
        return SavepointReader(storage.load(latest[1]))

    # -- introspection ----------------------------------------------------
    def operator_uids(self) -> List[str]:
        return list(self.data.get("runners", {}).keys())

    def records_in(self) -> int:
        return self.data.get("records_in", 0)

    def source_state(self) -> dict:
        """State of the (single) source; for multi-source jobs returns the
        first source's state — use source_states() for all of them."""
        if "sources" in self.data:
            srcs = self.data["sources"]
            return next(iter(srcs.values())) if srcs else {}
        return self.data.get("source", {})

    def source_states(self) -> Dict[str, dict]:
        """Per-source-uid state ({uid: state}); single-source snapshots from
        the pre-DAG layout appear under uid 'source'."""
        if "sources" in self.data:
            return dict(self.data["sources"])
        legacy = self.data.get("source")
        return {"source": legacy} if legacy else {}

    def _runner(self, uid: str) -> dict:
        runners = self.data.get("runners", {})
        if uid not in runners:
            raise KeyError(f"no operator {uid!r}; have {list(runners)}")
        return runners[uid]

    # -- keyed state ------------------------------------------------------
    def keyed_state(self, uid: str) -> Iterator[Tuple]:
        """Yields state entries for the operator:

        - heap-operator snapshots: (state_name, key, namespace, value)
        - device columnar-window snapshots: (key, slice_index,
          {field: value, 'count': n}) for every non-empty (key, slice) cell
        """
        snap = self._runner(uid)
        op = snap.get("operator", snap)
        if "columnar" in op or "sharded" in op:
            yield from self._columnar_entries(op.get("columnar") or op.get("sharded"))
        elif "pipe" in op:
            yield from self._fused_entries(op)
        elif "state" in op:
            for state_name, kg_tables in op["state"].items():
                for _kg, entries in kg_tables.items():
                    for (key, ns), value in entries.items():
                        yield (state_name, key, ns, value)
        else:
            raise TypeError(f"operator {uid!r} snapshot has no readable keyed state")

    def _columnar_entries(self, col: dict) -> Iterator[Tuple]:
        count = np.asarray(col["count"])
        acc = {k: np.asarray(v) for k, v in col["acc"].items()}
        S = col["S"]
        f = col["frontiers"]
        if f["min_used"] is None:
            return
        lo = f["min_used"] if f["purged_to"] is None else max(f["purged_to"], f["min_used"])
        hi = f["max_used"]
        sharded = count.ndim == 3
        keydicts = col.get("keydicts") or [col["keydict"]]
        for shard, kd in enumerate(keydicts):
            keys = kd["keys"]
            cnt = count[shard] if sharded else count
            for kid, key in enumerate(keys):
                for s in range(lo, hi + 1):
                    pos = s % S
                    c = int(cnt[kid, pos])
                    if c == 0:
                        continue
                    fields = {
                        name: (arr[shard] if sharded else arr)[kid, pos].item()
                        for name, arr in acc.items()
                    }
                    fields["count"] = c
                    yield (key, s, fields)

    def pending_output(self, uid: str) -> List[Tuple]:
        """Emissions resolved but not yet drained downstream at snapshot
        time (fused operators fire due windows when the checkpoint flushes
        their buffered steps; those rows ride the checkpoint and re-emit on
        restore). Rows are (key, window, value, timestamp)."""
        snap = self._runner(uid)
        op = snap.get("operator", snap)
        return list(op.get("output", []))

    def _fused_entries(self, op: dict) -> Iterator[Tuple]:
        """Fused window operator snapshots (runtime/fused_window_operator.py):
        same (key, slice, fields) rows as columnar snapshots, reconstructed
        from the superscan's ring state + the normalizer's frontiers."""
        pipe = op["pipe"]
        count = np.asarray(pipe["count"])
        acc = {k: np.asarray(v).copy() for k, v in pipe["state"].items()}
        count = count.copy()
        S = count.shape[1]
        keys = op["keydict"]["keys"]
        if op["keydict"].get("dense_int") and not keys:
            # keyed by dense int ids (a traceable key_by): the id is the key.
            # The JAX reader iterates the dictionary's empty key list here and
            # yields nothing (ROADMAP.md Queue C)
            keys = range(count.shape[0])
        g = op["geometry"]["g"]
        offset = op["geometry"]["offset"]
        specs = op["fields"]  # (name, scatter, identity, source, dtype)
        combine = {"add": lambda a, b: a + b, "min": min, "max": max}

        # fold held-back future records (beyond the device ring span) into
        # host-side cells — they are part of the keyed state. Kept separate
        # from the ring loop: their slices can exceed lo+S, and folding them
        # through `pos = s % S` would alias live device cells.
        extra: Dict[Tuple[int, int], Dict[str, Any]] = {}
        buffered = [
            (np.asarray(k), None if v is None else np.asarray(v), np.asarray(t))
            for k, v, t in op.get("normalizer", {}).get("future", [])
        ]
        for kid_arr, val_arr, ts_arr in buffered:
            for i in range(len(ts_arr)):
                s = (int(ts_arr[i]) - offset) // g
                cell = extra.setdefault((int(kid_arr[i]), s), {"count": 0})
                cell["count"] += 1
                for name, scatter, ident, source, _dt in specs:
                    if source != "value":
                        continue
                    v = float(val_arr[i]) if val_arr is not None else 1.0
                    cell[name] = combine[scatter](cell.get(name, ident), v)

        # device ring cells: bounded by the ring frontiers (span < S)
        lo = pipe.get("purged_to")
        hi = pipe.get("max_seen_slice")
        if lo is None:
            lo = pipe.get("min_used_slice")
        if lo is not None and hi is not None:
            for kid, key in enumerate(keys):
                for s in range(lo, hi + 1):
                    pos = s % S
                    c = int(count[kid, pos])
                    cell = extra.pop((kid, s), None)
                    if cell is not None:
                        c += cell["count"]
                    if c == 0:
                        continue
                    fields = {name: arr[kid, pos].item() for name, arr in acc.items()}
                    if cell is not None:
                        for name, scatter, ident, _src, _dt in specs:
                            if name in fields:
                                fields[name] = combine[scatter](
                                    fields[name], cell.get(name, ident)
                                )
                    fields["count"] = c
                    yield (key, s, fields)

        # remaining host-only cells (slices outside the device span)
        for (kid, s), cell in sorted(extra.items(), key=lambda kv: (kv[0][1], kv[0][0])):
            fields = {
                name: cell.get(name, ident)
                for name, _scatter, ident, source, _dt in specs
                if source == "value"
            }
            fields["count"] = cell["count"]
            yield (keys[kid], s, fields)


class SavepointWriter:
    """Transforms an existing savepoint (or builds one from scratch) and
    writes it in restorable form."""

    def __init__(self, data: Optional[dict] = None):
        self.data = copy.deepcopy(data) if data else {
            "source": {
                "pending_splits": [],
                "current_split": None,
                "reader_position": {},
                "done": False,
            },
            "generator": None,
            "runners": {},
            "records_in": 0,
            "savepoint": True,
        }

    @staticmethod
    def from_reader(reader: SavepointReader) -> "SavepointWriter":
        return SavepointWriter(reader.data)

    def remove_operator(self, uid: str) -> "SavepointWriter":
        self.data.get("runners", {}).pop(uid, None)
        return self

    def rename_operator(self, old_uid: str, new_uid: str) -> "SavepointWriter":
        runners = self.data.get("runners", {})
        if old_uid in runners:
            runners[new_uid] = runners.pop(old_uid)
        return self

    def transform_heap_state(
        self, uid: str, fn: Callable[[str, Any, Any, Any], Optional[Any]]
    ) -> "SavepointWriter":
        """fn(state_name, key, namespace, value) -> new value or None to
        drop the entry."""
        snap = self.data["runners"][uid]
        op = snap.get("operator", snap)
        for state_name, kg_tables in op["state"].items():
            for kg, entries in list(kg_tables.items()):
                new_entries = {}
                for (key, ns), value in entries.items():
                    out = fn(state_name, key, ns, value)
                    if out is not None:
                        new_entries[(key, ns)] = out
                kg_tables[kg] = new_entries
        return self

    def transform_columnar_state(
        self, uid: str, fn: Callable[[str, np.ndarray], np.ndarray]
    ) -> "SavepointWriter":
        """fn(field_name, array) -> new array (applied to each accumulator
        field, including 'count'); shape must be preserved."""
        snap = self.data["runners"][uid]
        op = snap.get("operator", snap)
        col = op.get("columnar") or op.get("sharded")
        if col is None and "pipe" in op:
            # fused-operator snapshot: fields live as pipe["state"] arrays.
            # Held-back future records (raw values, not yet cells) get the
            # transform applied to their value column when the aggregate has
            # exactly one value-sourced field — elementwise fns distribute
            # over add/min/max combining, which is the API's contract.
            pipe = op["pipe"]
            for name, arr in pipe["state"].items():
                out = np.asarray(fn(name, np.asarray(arr)))
                if out.shape != np.asarray(arr).shape:
                    raise ValueError("columnar transform must preserve shape")
                pipe["state"][name] = out
            cnt = np.asarray(pipe["count"])
            new_cnt = np.asarray(fn("count", cnt))
            if new_cnt.shape != cnt.shape:
                raise ValueError("columnar transform must preserve shape")
            pipe["count"] = new_cnt
            vfields = [s for s in op.get("fields", []) if s[3] == "value"]
            fut = op.get("normalizer", {}).get("future", [])
            if fut and len(vfields) > 1:
                raise ValueError(
                    "savepoint holds raw future records for a multi-value-field "
                    "aggregate; per-field transforms cannot be applied to shared "
                    "raw values — flush the job past them or drop them explicitly"
                )
            if fut and len(vfields) == 1:
                fname = vfields[0][0]
                op["normalizer"]["future"] = [
                    (k, None if v is None else np.asarray(fn(fname, np.asarray(v))).tolist(), t)
                    for k, v, t in fut
                ]
            return self
        for name, arr in col["acc"].items():
            out = np.asarray(fn(name, np.asarray(arr)))
            if out.shape != np.asarray(arr).shape:
                raise ValueError("columnar transform must preserve shape")
            col["acc"][name] = out
        col["count"] = np.asarray(fn("count", np.asarray(col["count"])))
        return self

    def write(self, path: str) -> str:
        self.data["savepoint"] = True
        return FsCheckpointStorage(path).save(0, self.data)
