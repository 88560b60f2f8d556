"""Formatted file connectors: FileSource/FileSink x the format registry.

Counterpart of `flink_tpu/formats/file_io.py`, copied, over the port's
`connectors/source.py` and `connectors/sink.py`.

In the reference a FileSource takes a format's DeserializationSchema /
BulkFormat and a FileSink a BulkWriter factory. Here the Source and Sink
SPIs are implemented over `flink_tpu_torch.formats.get_format`; rows are
dicts.
"""

from __future__ import annotations

import os
import tempfile
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from flink_tpu_torch.connectors.sink import Committer, Sink, SinkWriter, _FileCommitter, _PendingFile
from flink_tpu_torch.connectors.source import Batch, Source, SourceReader, SourceSplit, SplitEnumerator
from flink_tpu_torch.core.records import MIN_TIMESTAMP
from flink_tpu_torch.formats.registry import Format, get_format
from flink_tpu_torch.utils.arrays import obj_array


class _FormattedFileReader(SourceReader):
    def __init__(self, fmt: Format, timestamp_fn):
        self._fmt = fmt
        self._ts_fn = timestamp_fn
        self._path: Optional[str] = None
        self._offset = 0  # row offset (resumable split position)
        self._rows: Optional[List[dict]] = None

    def add_split(self, split: SourceSplit) -> None:
        self._path = split.payload["path"]
        self._offset = split.payload.get("offset", 0)
        self._rows = None

    def poll_batch(self, max_records: int) -> Optional[Batch]:
        if self._path is None:
            return None
        if self._rows is None:
            self._rows = self._fmt.read_file(self._path)
        if self._offset >= len(self._rows):
            self._path = None
            return None
        chunk = self._rows[self._offset : self._offset + max_records]
        self._offset += len(chunk)
        if self._ts_fn is not None:
            ts = np.asarray([self._ts_fn(r) for r in chunk], dtype=np.int64)
        else:
            ts = np.full(len(chunk), MIN_TIMESTAMP, dtype=np.int64)
        return Batch(obj_array(chunk), ts)

    def snapshot_position(self) -> Dict[str, Any]:
        return {"path": self._path, "offset": self._offset}

    def restore_position(self, state: Dict[str, Any]) -> None:
        self._path = state["path"]
        self._offset = state["offset"]
        self._rows = None


class FormattedFileSource(Source):
    """Rows from files in any registered format (FileSource.java:98)."""

    def __init__(self, paths: Sequence[str], format: str = "json",
                 timestamp_fn: Optional[Callable[[dict], int]] = None, **format_kwargs):
        self.paths = [str(p) for p in paths]
        self.format_name = format
        self.format_kwargs = format_kwargs
        self.timestamp_fn = timestamp_fn

    def create_enumerator(self) -> SplitEnumerator:
        return SplitEnumerator(
            [SourceSplit(f"file-{i}", {"path": p}) for i, p in enumerate(self.paths)]
        )

    def create_reader(self) -> SourceReader:
        return _FormattedFileReader(
            get_format(self.format_name, **self.format_kwargs), self.timestamp_fn
        )


class _FormattedFileWriter(SinkWriter):
    """Buffers an epoch's rows, writes one part file per epoch through the
    format on prepare_commit (2PC: temp file renamed on commit — the
    exactly-once discipline of the plain FileSink)."""

    def __init__(self, directory: str, prefix: str, fmt: Format, ext: str):
        self.directory = directory
        self.prefix = prefix
        self.fmt = fmt
        self.ext = ext
        self._rows: List[dict] = []
        os.makedirs(directory, exist_ok=True)

    def write(self, value, timestamp=None) -> None:
        self._rows.append(value)

    def prepare_commit(self, epoch_id: str = "final") -> List[_PendingFile]:
        rows, self._rows = self._rows, []
        fd, tmp = tempfile.mkstemp(prefix=f".{self.prefix}-inprogress-", dir=self.directory)
        with os.fdopen(fd, "wb") as f:
            self.fmt.write(rows, f)
        final = os.path.join(self.directory, f"{self.prefix}-part-{epoch_id}.{self.ext}")
        return [_PendingFile(tmp, final)]

    def close(self) -> None:
        self._rows = []


class FormattedFileSink(Sink):
    def __init__(self, directory: str, format: str = "json", prefix: str = "out",
                 **format_kwargs):
        self.directory = directory
        self.format_name = format
        self.format_kwargs = format_kwargs
        self.prefix = prefix

    def create_writer(self) -> SinkWriter:
        return _FormattedFileWriter(
            self.directory, self.prefix,
            get_format(self.format_name, **self.format_kwargs), self.format_name,
        )

    def create_committer(self) -> Optional[Committer]:
        return _FileCommitter()
