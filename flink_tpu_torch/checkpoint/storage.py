"""Checkpoint storage: the in-memory and the file-system store.

Counterpart of `flink_tpu/checkpoint/storage.py`, copied. A checkpoint is
one dict (numpy arrays and plain data), written atomically (temp file,
fsync, rename, parent-directory fsync) under <dir>/chk-<id>/_metadata.
Device tensors must already be pulled to the host by the capture: a
`torch.Tensor` in a checkpoint is refused, since it would pickle device
storage that the JAX package cannot read.

Durability contract: `save` fsyncs the temp file BEFORE the rename and the
parent directory AFTER it, so a crash leaves either the previous checkpoint
or the new one, never a torn `_metadata` that looks complete. `load` wraps
every missing or torn artifact in the typed :class:`CorruptCheckpointError`,
so a restore can skip a damaged checkpoint and rewind to the previous one.

Files of either package load here. A JAX checkpoint pickles a few plain
`flink_tpu` classes by path (a source split, a time window); `load` maps
exactly those onto the port's counterparts (`_JAX_CLASSES`) without
importing `flink_tpu`, and refuses any other `flink_tpu.` path.

The chaos plane's storage seam (`_chaos_storage`, sites `save:<id>` and
`load:<handle>`) is the JAX store's: an `error` rule raises there, and a
`torn` rule truncates the artifact a save just completed, which `latest()`
and the restore then skip as corrupt.
"""

from __future__ import annotations

import io
import os
import pickle
import re
import shutil
import tempfile
import time
from typing import Dict, List, Optional, Tuple

from flink_tpu_torch.chaos import plan as _chaos

#: the plain classes a JAX checkpoint pickles by path -> the port's own
_JAX_CLASSES = {
    ("flink_tpu.connectors.source", "SourceSplit"):
        ("flink_tpu_torch.connectors.source", "SourceSplit"),
    ("flink_tpu.core.time", "TimeWindow"): ("flink_tpu_torch.core.time", "TimeWindow"),
    ("flink_tpu.api.windowing.assigners", "GlobalWindow"):
        ("flink_tpu_torch.api.windowing.assigners", "GlobalWindow"),
}


class CorruptCheckpointError(Exception):
    """A checkpoint artifact is missing or unreadable (torn or truncated
    `_metadata`, deleted chk dir, evicted in-memory handle). Typed so a
    restore can tell "this checkpoint is damaged, rewind further" from a
    programming error."""

    def __init__(self, handle: str, cause: BaseException):
        super().__init__(f"checkpoint artifact {handle!r} is missing or "
                         f"corrupt: {cause!r}")
        self.handle = handle
        self.__cause__ = cause


class ForeignCheckpointClassError(pickle.UnpicklingError):
    """A checkpoint names a `flink_tpu` class outside `_JAX_CLASSES`."""


class _PortUnpickler(pickle.Unpickler):
    """Resolves the JAX package's plain classes to the port's; any other
    `flink_tpu.` path is refused (never imported)."""

    def find_class(self, module: str, name: str):
        if module == "flink_tpu" or module.startswith("flink_tpu."):
            target = _JAX_CLASSES.get((module, name))
            if target is None:
                raise ForeignCheckpointClassError(
                    f"checkpoint names {module}.{name}, which the port does not map "
                    f"(mapped: {sorted('.'.join(k) for k in _JAX_CLASSES)})")
            module, name = target
        return super().find_class(module, name)


def loads(blob: bytes):
    """Unpickle a checkpoint blob of either package."""
    return _PortUnpickler(io.BytesIO(blob)).load()


class _PlainPickler(pickle.Pickler):
    """Refuses torch objects: a capture holds numpy arrays and plain data
    only. `reducer_override` runs for objects that are not builtin
    containers or scalars (arrays, windows, splits), so the check adds
    nothing per row of a collected list."""

    def reducer_override(self, obj):
        if type(obj).__module__.split(".")[0] == "torch":
            raise TypeError(f"a checkpoint holds a {type(obj).__module__}."
                            f"{type(obj).__name__}; captures hold numpy arrays and plain "
                            "data only")
        return NotImplemented


def dump(data, f) -> None:
    """Pickle a checkpoint into the binary file `f`, refusing tensors."""
    _PlainPickler(f, protocol=pickle.HIGHEST_PROTOCOL).dump(data)


class CheckpointStorage:
    # size of the most recent save()'s persisted artifact, reported to the
    # CheckpointStatsTracker (saves are serialized per coordinator)
    last_save_bytes: int = 0

    def save(self, checkpoint_id: int, data: dict) -> str:
        raise NotImplementedError

    def load(self, handle: str) -> dict:
        """Raises CorruptCheckpointError when the artifact is missing or
        unreadable."""
        raise NotImplementedError

    def list_checkpoints(self) -> List[Tuple[int, str]]:
        """Sorted (id, handle) of COMPLETE checkpoints."""
        raise NotImplementedError

    def latest(self) -> Optional[Tuple[int, str]]:
        cps = self.list_checkpoints()
        return cps[-1] if cps else None

    def discard(self, checkpoint_id: int) -> None:
        pass


def _chaos_storage(site: str) -> Optional[str]:
    """The chaos plane's storage seam: one is-None check when chaos is
    off; `error` raises here, `torn` returns the directive for save()."""
    hook = _chaos.HOOK
    if hook is not None:
        return hook("storage", site)
    return None


class MemoryCheckpointStorage(CheckpointStorage):
    def __init__(self):
        self._store: Dict[int, bytes] = {}

    def save(self, checkpoint_id: int, data: dict) -> str:
        directive = _chaos_storage(f"save:{checkpoint_id}")
        buf = io.BytesIO()
        dump(data, buf)
        blob = buf.getvalue()
        if directive == "torn":
            blob = blob[: max(len(blob) // 3, 1)]
        self._store[checkpoint_id] = blob
        self.last_save_bytes = len(blob)
        return f"mem:{checkpoint_id}"

    def load(self, handle: str) -> dict:
        _chaos_storage(f"load:{handle}")
        try:
            return loads(self._store[int(handle.split(":", 1)[1])])
        except ForeignCheckpointClassError:
            raise
        except Exception as e:  # noqa: BLE001 — missing key, torn pickle
            raise CorruptCheckpointError(handle, e) from e

    def list_checkpoints(self) -> List[Tuple[int, str]]:
        return [(i, f"mem:{i}") for i in sorted(self._store)]

    def discard(self, checkpoint_id: int) -> None:
        self._store.pop(checkpoint_id, None)


def _fsync_dir(path: str) -> None:
    """fsync a directory so a just-renamed entry survives power loss
    (no-op on platforms that cannot open directories)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass                       # e.g. a network fs refusing dir fsync
    finally:
        os.close(fd)


class FsCheckpointStorage(CheckpointStorage):
    _DIR_RE = re.compile(r"^chk-(\d+)$")

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        # the parts of the most recent save(), in seconds and bytes:
        # {"pickle_s", "fsync_s", "bytes"} (the capture/restore report)
        self.last_save_parts: Dict[str, float] = {}

    def _chk_dir(self, checkpoint_id: int) -> str:
        return os.path.join(self.directory, f"chk-{checkpoint_id}")

    def save(self, checkpoint_id: int, data: dict) -> str:
        directive = _chaos_storage(f"save:{checkpoint_id}")
        chk = self._chk_dir(checkpoint_id)
        os.makedirs(chk, exist_ok=True)
        final = os.path.join(chk, "_metadata")
        fd, tmp = tempfile.mkstemp(dir=chk, prefix=".inprogress-")
        try:
            with os.fdopen(fd, "wb") as f:
                t0 = time.perf_counter()
                dump(data, f)
                f.flush()
                t1 = time.perf_counter()
                # fsync BEFORE the rename: without it the rename can land
                # while the data blocks are still dirty, and a crash leaves
                # a torn file behind the atomic-completion marker
                os.fsync(f.fileno())
            os.replace(tmp, final)  # atomic completion marker
            # fsync the parent so the rename itself is durable
            _fsync_dir(chk)
            t2 = time.perf_counter()
            if directive == "torn":
                # chaos: the torn-metadata outcome the fsync exists to
                # prevent (disk corruption, a pre-hardening crash artifact)
                size = os.path.getsize(final)
                with open(final, "r+b") as f:
                    f.truncate(max(size // 3, 1))
            self.last_save_bytes = os.path.getsize(final)
            self.last_save_parts = {"pickle_s": t1 - t0, "fsync_s": t2 - t1,
                                    "bytes": self.last_save_bytes}
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return final

    def load(self, handle: str) -> dict:
        _chaos_storage(f"load:{handle}")
        try:
            with open(handle, "rb") as f:
                return _PortUnpickler(f).load()
        except ForeignCheckpointClassError:
            raise
        except Exception as e:  # noqa: BLE001 — missing dir or file, torn
            # or truncated pickle (EOFError/UnpicklingError), unreadable bytes
            raise CorruptCheckpointError(handle, e) from e

    def list_checkpoints(self) -> List[Tuple[int, str]]:
        out = []
        for name in os.listdir(self.directory):
            m = self._DIR_RE.match(name)
            if not m:
                continue
            meta = os.path.join(self.directory, name, "_metadata")
            if os.path.exists(meta):
                out.append((int(m.group(1)), meta))
        return sorted(out)

    def discard(self, checkpoint_id: int) -> None:
        shutil.rmtree(self._chk_dir(checkpoint_id), ignore_errors=True)
