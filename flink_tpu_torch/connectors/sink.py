"""Sinks: Sink -> SinkWriter (+ Committer).

Counterpart of `flink_tpu/connectors/sink.py`: `CollectSink`,
`PrintSink` and `FileSink`. An exactly-once sink stages its output per
checkpoint epoch and commits it when the checkpoint completes: a two-phase
commit whose barrier is a step boundary.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Any, List, Optional, Sequence


class SinkWriter:
    def write(self, value, timestamp: Optional[int] = None) -> None:
        raise NotImplementedError

    def write_batch(self, values: Sequence, timestamps=None) -> None:
        for i, v in enumerate(values):
            self.write(v, None if timestamps is None else int(timestamps[i]))

    def prepare_commit(self, epoch_id: str = "final") -> List[Any]:
        """Committables of the current epoch (two-phase commit, phase 1).
        `epoch_id` names the checkpoint epoch: a committable's name is a
        pure function of it, so a replay after recovery is idempotent."""
        return []

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


class Committer:
    def commit(self, committables: List[Any]) -> None:
        pass


class Sink:
    def create_writer(self) -> SinkWriter:
        raise NotImplementedError

    def create_committer(self) -> Optional[Committer]:
        return None


class _CollectWriter(SinkWriter):
    def __init__(self, store: List):
        self.store = store

    def write(self, value, timestamp=None) -> None:
        self.store.append(value)

    def write_batch(self, values, timestamps=None) -> None:
        self.store.extend(values)


class CollectSink(Sink):
    """Collects every record into `results`."""

    def __init__(self):
        self.results: List = []

    def create_writer(self) -> SinkWriter:
        return _CollectWriter(self.results)


# ---------------------------------------------------------------------------
# FileSink with two-phase commit: one part file per epoch, moved into place
# on commit
# ---------------------------------------------------------------------------

class _PrintWriter(SinkWriter):
    def write(self, value, timestamp=None) -> None:
        print(value)


class PrintSink(Sink):
    """Print each record to standard output (DataStream.print)."""

    def create_writer(self) -> SinkWriter:
        return _PrintWriter()


@dataclasses.dataclass
class _PendingFile:
    temp_path: str
    final_path: str


class _FileWriter(SinkWriter):
    def __init__(self, directory: str, prefix: str):
        self.directory = directory
        self.prefix = prefix
        self._tmp = None
        self._fh = None
        os.makedirs(directory, exist_ok=True)
        self._open_epoch_file()

    def _open_epoch_file(self):
        fd, self._tmp = tempfile.mkstemp(prefix=f".{self.prefix}-inprogress-", dir=self.directory)
        self._fh = os.fdopen(fd, "w")

    def write(self, value, timestamp=None) -> None:
        self._fh.write(f"{value}\n")

    def prepare_commit(self, epoch_id: str = "final") -> List[_PendingFile]:
        """The part file's name is a pure function of epoch_id (the
        checkpoint id), so a replayed epoch atomically overwrites its own
        part file: exactly-once through an idempotent rename."""
        self._fh.flush()
        self._fh.close()
        final = os.path.join(self.directory, f"{self.prefix}-part-{epoch_id}")
        pending = [_PendingFile(self._tmp, final)]
        self._open_epoch_file()
        return pending

    def close(self) -> None:
        if self._fh and not self._fh.closed:
            self._fh.close()
            if os.path.exists(self._tmp) and os.path.getsize(self._tmp) == 0:
                os.unlink(self._tmp)


class _FileCommitter(Committer):
    def commit(self, committables: List[_PendingFile]) -> None:
        for p in committables:
            if os.path.exists(p.temp_path):
                os.replace(p.temp_path, p.final_path)


class FileSink(Sink):
    """Text lines (`str(value)`) into `<directory>/<prefix>-part-<epoch>`,
    committed per checkpoint; uncommitted output stays in hidden
    `.<prefix>-inprogress-*` files."""

    def __init__(self, directory: str, prefix: str = "out"):
        self.directory = directory
        self.prefix = prefix

    def create_writer(self) -> SinkWriter:
        return _FileWriter(self.directory, self.prefix)

    def create_committer(self) -> Optional[Committer]:
        return _FileCommitter()
