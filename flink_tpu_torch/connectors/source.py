"""Split-based sources, read in columnar batches.

Counterpart of `flink_tpu/connectors/source.py`: `Batch`, `Source`,
`CollectionSource`, `DataGeneratorSource` and `FileSource`. An enumerator
hands out splits, a reader polls (values, timestamps) columns sized for one
step. A checkpoint snapshots the enumerator's pending splits and the
reader's position in its split, so a restored job replays exactly the
records after the cut (the exactly-once source half).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from flink_tpu_torch.core.time import MIN_TIMESTAMP
from flink_tpu_torch.utils.arrays import obj_array


@dataclasses.dataclass
class SourceSplit:
    """A unit of source work (generator range, collection)."""

    split_id: str
    payload: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Batch:
    """Columnar poll result: `values` is an object array of records
    (record mode) or a numeric ndarray column (columnar mode)."""

    values: Any
    timestamps: Optional[np.ndarray] = None  # int64 ms

    def __len__(self):
        return len(self.values)


class SplitEnumerator:
    """Split discovery and assignment."""

    def __init__(self, splits: List[SourceSplit]):
        self._pending = list(splits)

    def next_split(self) -> Optional[SourceSplit]:
        return self._pending.pop(0) if self._pending else None

    def add_split_back(self, split: SourceSplit) -> None:
        """Failover: the reader died before finishing the split."""
        self._pending.insert(0, split)

    def snapshot(self) -> List[SourceSplit]:
        return list(self._pending)

    def restore(self, splits: List[SourceSplit]) -> None:
        self._pending = list(splits)


class SourceReader:
    """Polls columnar batches from its assigned splits."""

    def add_split(self, split: SourceSplit) -> None:
        raise NotImplementedError

    def poll_batch(self, max_records: int) -> Optional[Batch]:
        """None = currently exhausted (need another split or end)."""
        raise NotImplementedError

    def snapshot_position(self) -> Dict[str, Any]:
        """Split progress for exactly-once replay."""
        return {}

    def restore_position(self, state: Dict[str, Any]) -> None:
        pass


class Source:
    """Factory for enumerator + readers."""

    boundedness: str = "BOUNDED"

    def create_enumerator(self) -> SplitEnumerator:
        raise NotImplementedError

    def create_reader(self) -> SourceReader:
        raise NotImplementedError


class _CollectionReader(SourceReader):
    def __init__(self, timestamp_fn):
        self._items: List = []
        self._pos = 0
        self._ts_fn = timestamp_fn

    def add_split(self, split: SourceSplit) -> None:
        self._items = split.payload["items"]
        self._pos = 0

    def poll_batch(self, max_records: int) -> Optional[Batch]:
        if self._pos >= len(self._items):
            return None
        chunk = self._items[self._pos: self._pos + max_records]
        self._pos += len(chunk)
        if self._ts_fn is not None:
            ts = np.asarray([self._ts_fn(x) for x in chunk], dtype=np.int64)
        else:
            ts = np.full(len(chunk), MIN_TIMESTAMP, dtype=np.int64)
        return Batch(obj_array(chunk), ts)

    def snapshot_position(self) -> Dict[str, Any]:
        return {"pos": self._pos}

    def restore_position(self, state: Dict[str, Any]) -> None:
        self._pos = state["pos"]


class CollectionSource(Source):
    def __init__(self, items: Sequence, timestamp_fn: Optional[Callable] = None):
        self.items = list(items)
        self.timestamp_fn = timestamp_fn

    def create_enumerator(self) -> SplitEnumerator:
        return SplitEnumerator([SourceSplit("collection-0", {"items": self.items})])

    def create_reader(self) -> SourceReader:
        return _CollectionReader(self.timestamp_fn)


class _GeneratorReader(SourceReader):
    def __init__(self, generator_fn):
        self._gen = generator_fn
        self._next = 0
        self._end = 0

    def add_split(self, split: SourceSplit) -> None:
        self._next = split.payload["start"]
        self._end = split.payload["end"]

    def poll_batch(self, max_records: int) -> Optional[Batch]:
        if self._next >= self._end:
            return None
        n = min(max_records, self._end - self._next)
        idx = np.arange(self._next, self._next + n, dtype=np.int64)
        self._next += n
        return self._gen(idx)

    def snapshot_position(self) -> Dict[str, Any]:
        return {"next": self._next, "end": self._end}

    def restore_position(self, state: Dict[str, Any]) -> None:
        self._next = state["next"]
        self._end = state["end"]


class DataGeneratorSource(Source):
    """generator_fn(index_array) -> Batch; indices are a deterministic
    sequence, so a rerun, or a replay after a restore, reads the same
    stream."""

    def __init__(self, generator_fn: Callable[[np.ndarray], Batch], count: int,
                 num_splits: int = 1):
        self.generator_fn = generator_fn
        self.count = count
        self.num_splits = num_splits

    def create_enumerator(self) -> SplitEnumerator:
        per = self.count // self.num_splits
        splits = []
        for i in range(self.num_splits):
            start = i * per
            end = self.count if i == self.num_splits - 1 else (i + 1) * per
            splits.append(SourceSplit(f"gen-{i}", {"start": start, "end": end}))
        return SplitEnumerator(splits)

    def create_reader(self) -> SourceReader:
        return _GeneratorReader(self.generator_fn)


# ---------------------------------------------------------------------------
# FileSource (flink-connector-files FileSource.java:98, text lines)
# ---------------------------------------------------------------------------

class _FileReader(SourceReader):
    def __init__(self, parse_fn, timestamp_fn):
        self._parse = parse_fn
        self._ts_fn = timestamp_fn
        self._path: Optional[str] = None
        self._offset = 0  # line offset within file
        self._lines: Optional[List[str]] = None

    def add_split(self, split: SourceSplit) -> None:
        self._path = split.payload["path"]
        self._offset = split.payload.get("offset", 0)
        self._lines = None

    def poll_batch(self, max_records: int) -> Optional[Batch]:
        if self._path is None:
            return None
        if self._lines is None:
            with open(self._path) as f:
                self._lines = f.read().splitlines()
        if self._offset >= len(self._lines):
            self._path = None
            return None
        chunk = self._lines[self._offset : self._offset + max_records]
        self._offset += len(chunk)
        values = [self._parse(line) for line in chunk] if self._parse else chunk
        if self._ts_fn is not None:
            ts = np.asarray([self._ts_fn(v) for v in values], dtype=np.int64)
        else:
            ts = np.full(len(values), MIN_TIMESTAMP, dtype=np.int64)
        return Batch(obj_array(values), ts)

    def snapshot_position(self) -> Dict[str, Any]:
        return {"path": self._path, "offset": self._offset}

    def restore_position(self, state: Dict[str, Any]) -> None:
        self._path = state["path"]
        self._offset = state["offset"]
        self._lines = None


class FileSource(Source):
    def __init__(self, paths: Sequence[str], parse_fn: Optional[Callable] = None,
                 timestamp_fn: Optional[Callable] = None):
        self.paths = [str(p) for p in paths]
        self.parse_fn = parse_fn
        self.timestamp_fn = timestamp_fn

    def create_enumerator(self) -> SplitEnumerator:
        return SplitEnumerator(
            [SourceSplit(f"file-{i}", {"path": p}) for i, p in enumerate(self.paths)]
        )

    def create_reader(self) -> SourceReader:
        return _FileReader(self.parse_fn, self.timestamp_fn)
