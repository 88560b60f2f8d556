"""Sinks: Sink -> SinkWriter (+ Committer).

Counterpart of `Sink` and `CollectSink` of `flink_tpu/connectors/sink.py`.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence


class SinkWriter:
    def write(self, value, timestamp: Optional[int] = None) -> None:
        raise NotImplementedError

    def write_batch(self, values: Sequence, timestamps=None) -> None:
        for i, v in enumerate(values):
            self.write(v, None if timestamps is None else int(timestamps[i]))

    def prepare_commit(self, epoch_id: str = "final") -> List[Any]:
        """Committables of the current epoch (two-phase commit, phase 1)."""
        return []

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
