"""Changelog state backend: journal every mutation, materialize periodically.

Counterpart of `flink_tpu/state/changelog.py`, copied. Analogue of the
reference's changelog backend + DSTL (S5:
flink-statebackend-changelog/.../ChangelogKeyedStateBackend.java:114,
flink-dstl/.../FsStateChangelogStorage.java:57): wraps any keyed backend,
appends each state mutation to a durable segment log so a checkpoint is
just (last materialized snapshot handle, log offset) — near-instant —
while a `materialize()` folds the log into a fresh full snapshot and
truncates. The tier manager (state/tier_manager.py) journals into
`FsStateChangelog` directly and relies on its read range, trim and
torn-tail rules. The segment format (a 4-byte big-endian length, then a
pickled (sequence, entry) pair) is the JAX package's, so either package
replays the other's log.
"""

from __future__ import annotations

import os
import pickle
import tempfile
from typing import Dict, List, Optional, Tuple

from flink_tpu_torch.state.heap import HeapKeyedStateBackend, StateDescriptor


class FsStateChangelog:
    """Append-only mutation log in segment files (DSTL-dfs analogue)."""

    def __init__(self, directory: Optional[str] = None, segment_bytes: int = 1 << 20):
        self.dir = directory or tempfile.mkdtemp(prefix="flink_tpu_torch_dstl_")
        os.makedirs(self.dir, exist_ok=True)
        self.segment_bytes = segment_bytes
        self._seg_id = 0
        self._seg_file = None
        self._offset = 0  # global sequence number of appended entries
        self.bytes_written = 0  # lifetime appended bytes (delta-size gauge)
        # opening an existing log directory resumes numbering after the last
        # entry (a fresh writer must never collide with surviving segments)
        for seg in sorted(os.listdir(self.dir)):
            if not seg.startswith("seg-"):
                continue
            self._seg_id = max(self._seg_id, int(seg[4:12]) + 1)
            with open(os.path.join(self.dir, seg), "rb") as f:
                while True:
                    hdr = f.read(4)
                    if len(hdr) < 4:
                        break
                    body = f.read(int.from_bytes(hdr, "big"))
                    if len(body) < int.from_bytes(hdr, "big"):
                        break  # torn tail (crash mid-append): not a record
                    try:
                        seq, _ = pickle.loads(body)
                    except Exception:  # noqa: BLE001 — torn tail record
                        break
                    self._offset = max(self._offset, seq)

    def _segment_path(self, seg_id: int) -> str:
        return os.path.join(self.dir, f"seg-{seg_id:08d}.log")

    def append(self, entry: tuple) -> int:
        if self._seg_file is None:
            self._seg_file = open(self._segment_path(self._seg_id), "ab")
        self._offset += 1
        # entries carry their absolute sequence number so truncated logs
        # keep a stable numbering
        data = pickle.dumps((self._offset, entry), protocol=pickle.HIGHEST_PROTOCOL)
        self._seg_file.write(len(data).to_bytes(4, "big") + data)
        self.bytes_written += len(data) + 4
        self._seg_file.flush()
        if self._seg_file.tell() >= self.segment_bytes:
            self._seg_file.close()
            self._seg_file = None
            self._seg_id += 1
        return self._offset

    def read_entries(self, from_offset: int,
                     upto_offset: Optional[int] = None) -> List[Tuple[int, tuple]]:
        """(seq, entry) pairs with from_offset < seq <= upto_offset, in
        sequence order. A torn TAIL entry (a crash mid-append) is skipped:
        appends flush per entry and checkpoints only reference offsets of
        completed appends, so a truncated record can only ever sit beyond
        every offset a restore will ask for."""
        out: List[Tuple[int, tuple]] = []
        for seg in sorted(os.listdir(self.dir)):
            if not seg.startswith("seg-"):
                continue
            with open(os.path.join(self.dir, seg), "rb") as f:
                while True:
                    hdr = f.read(4)
                    if len(hdr) < 4:
                        break
                    body = f.read(int.from_bytes(hdr, "big"))
                    if len(body) < int.from_bytes(hdr, "big"):
                        break  # torn tail: the entry was never committed
                    try:
                        seq, entry = pickle.loads(body)
                    except Exception:  # noqa: BLE001 — torn tail record
                        break
                    if seq > from_offset and (upto_offset is None
                                              or seq <= upto_offset):
                        out.append((seq, entry))
        out.sort(key=lambda p: p[0])
        return out

    def read_from(self, from_offset: int) -> List[tuple]:
        """All entries with sequence > from_offset (1-based)."""
        return [e for _, e in self.read_entries(from_offset)]

    def trim_above(self, offset: int) -> int:
        """Drop every entry with seq > `offset` — the DEAD TIMELINE cut a
        restore must make before resuming writes. Without it, orphan
        entries from the failed attempt (appended after the restored
        checkpoint) survive in the segments; a later checkpoint's offset
        lies above them (the writer resumes past the max seq seen), so a
        subsequent replay would fold the dead timeline's mutations into
        live state. Segments fully above the cut unlink; a straddling
        segment is rewritten in place. Returns entries dropped."""
        if self._seg_file is not None:
            self._seg_file.close()
            self._seg_file = None
        dropped = 0
        max_live = 0
        for seg in sorted(os.listdir(self.dir)):
            if not seg.startswith("seg-"):
                continue
            path = os.path.join(self.dir, seg)
            keep: List[bytes] = []
            any_dropped = False
            with open(path, "rb") as f:
                while True:
                    hdr = f.read(4)
                    if len(hdr) < 4:
                        break
                    body = f.read(int.from_bytes(hdr, "big"))
                    if len(body) < int.from_bytes(hdr, "big"):
                        any_dropped = True  # torn tail goes with the trim
                        break
                    try:
                        seq, _entry = pickle.loads(body)
                    except Exception:  # noqa: BLE001 — torn tail record
                        any_dropped = True
                        break
                    if seq <= offset:
                        keep.append(hdr + body)
                        max_live = max(max_live, seq)
                    else:
                        any_dropped = True
                        dropped += 1
            if not any_dropped:
                continue
            if keep:
                tmp = path + ".trim"
                with open(tmp, "wb") as f:
                    for rec in keep:
                        f.write(rec)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, path)
            else:
                os.unlink(path)
        # resume numbering from the cut, not from the dead timeline's max
        self._offset = max(max_live, min(self._offset, offset))
        return dropped

    def truncate(self, upto_offset: int) -> None:
        """Drop whole segments fully covered by `upto_offset` (best-effort,
        like DSTL truncation after materialization)."""
        for seg in sorted(os.listdir(self.dir)):
            if not seg.startswith("seg-"):
                continue
            path = os.path.join(self.dir, seg)
            max_seq = 0
            with open(path, "rb") as f:
                while True:
                    hdr = f.read(4)
                    if len(hdr) < 4:
                        break
                    seq, _ = pickle.loads(f.read(int.from_bytes(hdr, "big")))
                    max_seq = max(max_seq, seq)
            if max_seq <= upto_offset and self._segment_path(self._seg_id) != path:
                os.unlink(path)

    @property
    def offset(self) -> int:
        return self._offset


class ChangelogKeyedStateBackend:
    """Heap backend wrapper journaling mutations; checkpoints are O(1)."""

    def __init__(self, inner: HeapKeyedStateBackend,
                 changelog: Optional[FsStateChangelog] = None):
        self.inner = inner
        self.log = changelog or FsStateChangelog()
        self._materialized: Optional[dict] = None
        self._materialized_offset = 0
        # dead-timeline cut owed from a restore, applied LAZILY on the
        # first journaled mutation: an eager cut would invalidate newer
        # retained checkpoints that are still restorable while this
        # instance has not actually diverged from the restored point
        self._pending_trim: Optional[int] = None

    # -- delegated reads ----------------------------------------------------
    def set_current_key(self, key) -> None:
        self.inner.set_current_key(key)

    @property
    def current_key(self):
        return self.inner.current_key

    def register(self, descriptor: StateDescriptor) -> None:
        self.inner.register(descriptor)

    def get(self, name: str, namespace=None):
        return self.inner.get(name, namespace)

    def keys(self, name: str):
        return self.inner.keys(name)

    # -- journaled writes ---------------------------------------------------
    def _journal(self, entry: tuple) -> None:
        if self._pending_trim is not None:
            # first mutation after a restore: the timeline diverges HERE,
            # so the failed attempt's orphan entries (seq above the
            # restored offset) must go before this append — otherwise a
            # later checkpoint's (materialized_offset, log_offset] range
            # would cover and replay them
            self.log.trim_above(self._pending_trim)
            self._pending_trim = None
        self.log.append(entry)

    def put(self, name: str, value, namespace=None) -> None:
        self.inner.put(name, value, namespace)
        self._journal(("put", self.inner.current_key, name, namespace, value))

    def add(self, name: str, value, namespace=None) -> None:
        self.inner.add(name, value, namespace)
        self._journal(("add", self.inner.current_key, name, namespace, value))

    def clear(self, name: str, namespace=None) -> None:
        self.inner.clear(name, namespace)
        self._journal(("clear", self.inner.current_key, name, namespace, None))

    # -- checkpointing ------------------------------------------------------
    def checkpoint(self) -> dict:
        """O(1): a reference to the last materialization + the log offset."""
        return {
            "materialized": self._materialized,
            "materialized_offset": self._materialized_offset,
            "log_offset": self.log.offset,
            "log_dir": self.log.dir,
        }

    def materialize(self, truncate_upto: Optional[int] = None) -> None:
        """Fold the journal into a full snapshot. Truncation is driven by
        checkpoint subsumption (the reference truncates DSTL only once no
        retained checkpoint references the range): pass the log offset of
        the oldest checkpoint still retained; entries below min(it, the new
        materialization) are dropped. Default: keep everything."""
        self._materialized = self.inner.snapshot()
        self._materialized_offset = self.log.offset
        if truncate_upto is not None:
            self.log.truncate(min(truncate_upto, self._materialized_offset))

    def restore(self, checkpoint: dict,
                descriptors: Optional[Dict[str, StateDescriptor]] = None) -> None:
        if checkpoint["materialized"] is not None:
            self.inner.restore(checkpoint["materialized"], descriptors)
        replay = FsStateChangelog(checkpoint["log_dir"]) if checkpoint["log_dir"] != self.log.dir else self.log
        # only entries within (materialized_offset, log_offset] belong
        # here — selected BY SEQUENCE, not by position: entries appended
        # after the restored checkpoint (a failed attempt's orphans) sit
        # interleaved in the segments, and a positional slice would replay
        # the wrong set. The dead timeline is then trimmed so a FUTURE
        # checkpoint's offset range can never cover orphan sequences.
        entries = [e for _s, e in replay.read_entries(
            checkpoint["materialized_offset"], checkpoint["log_offset"])]
        if replay is self.log:
            self._pending_trim = checkpoint["log_offset"]
        for op, key, name, namespace, value in entries:
            self.inner.set_current_key(key)
            if op == "put":
                self.inner.put(name, value, namespace)
            elif op == "add":
                self.inner.add(name, value, namespace)
            else:
                self.inner.clear(name, namespace)
        # adopt the restored state as this backend's baseline so the next
        # checkpoint()/restore cycle describes it (not an empty log). With
        # a pending trim the baseline offset is the RESTORED offset — the
        # log's current max seq still counts the dead timeline's orphans
        # until the first mutation cuts them
        self._materialized = self.inner.snapshot()
        self._materialized_offset = (checkpoint["log_offset"]
                                     if self._pending_trim is not None
                                     else self.log.offset)
