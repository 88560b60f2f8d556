"""FileSystem abstraction: scheme-routed pluggable filesystems (C4).

Analogue of flink-core/.../core/fs/FileSystem.java (+ the plugin-loaded
implementations under flink-filesystems/): URIs route to a registered
implementation by scheme. In-repo: `file://` (local posix, atomic writes via
temp+rename) and `mem://` (process-local object store — the test stand-in
for S3/GCS-style stores). Cloud stores register the same way
(`register_file_system("s3", ...)`) when their SDKs are present.

Counterpart of `flink_tpu/core/fs.py`, copied; the port's registry is its
own.
"""

from __future__ import annotations

import os
import tempfile
import threading
from typing import Dict, List, Optional, Tuple
from urllib.parse import urlparse


class FileSystem:
    scheme: str = ""

    def read(self, path: str) -> bytes:
        raise NotImplementedError

    def write(self, path: str, data: bytes) -> None:
        """Atomic full-object write (create or replace)."""
        raise NotImplementedError

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def list(self, path: str) -> List[str]:
        raise NotImplementedError

    def delete(self, path: str, recursive: bool = False) -> None:
        raise NotImplementedError

    def mkdirs(self, path: str) -> None:
        raise NotImplementedError


class LocalFileSystem(FileSystem):
    scheme = "file"

    @staticmethod
    def _p(path: str) -> str:
        return urlparse(path).path if "://" in path else path

    def read(self, path: str) -> bytes:
        with open(self._p(path), "rb") as f:
            return f.read()

    def write(self, path: str, data: bytes) -> None:
        p = self._p(path)
        os.makedirs(os.path.dirname(p) or ".", exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(p) or ".")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
            os.replace(tmp, p)
        except BaseException:
            try:
                os.unlink(tmp)
            except FileNotFoundError:
                pass
            raise

    def exists(self, path: str) -> bool:
        return os.path.exists(self._p(path))

    def list(self, path: str) -> List[str]:
        p = self._p(path)
        return sorted(os.path.join(p, n) for n in os.listdir(p))

    def delete(self, path: str, recursive: bool = False) -> None:
        import shutil

        p = self._p(path)
        if os.path.isdir(p):
            if not recursive:
                raise IsADirectoryError(p)
            shutil.rmtree(p)
        elif os.path.exists(p):
            os.unlink(p)

    def mkdirs(self, path: str) -> None:
        os.makedirs(self._p(path), exist_ok=True)


class MemoryFileSystem(FileSystem):
    """Process-local object store: flat key space, prefix listing — the
    semantics of S3-style stores (no real directories)."""

    scheme = "mem"

    def __init__(self):
        self._objects: Dict[str, bytes] = {}
        self._lock = threading.Lock()

    @staticmethod
    def _k(path: str) -> str:
        u = urlparse(path)
        return (u.netloc + u.path).rstrip("/")

    def read(self, path: str) -> bytes:
        with self._lock:
            try:
                return self._objects[self._k(path)]
            except KeyError:
                raise FileNotFoundError(path) from None

    def write(self, path: str, data: bytes) -> None:
        with self._lock:
            self._objects[self._k(path)] = bytes(data)

    def exists(self, path: str) -> bool:
        k = self._k(path)
        with self._lock:
            return k in self._objects or any(
                o.startswith(k + "/") for o in self._objects
            )

    def list(self, path: str) -> List[str]:
        k = self._k(path)
        with self._lock:
            return sorted(
                f"mem://{o}" for o in self._objects if o.startswith(k + "/") or o == k
            )

    def delete(self, path: str, recursive: bool = False) -> None:
        k = self._k(path)
        with self._lock:
            if k in self._objects:
                del self._objects[k]
                return
            children = [o for o in self._objects if o.startswith(k + "/")]
            if children and not recursive:
                raise IsADirectoryError(path)
            for o in children:
                del self._objects[o]

    def mkdirs(self, path: str) -> None:
        pass  # object stores have no directories


_REGISTRY: Dict[str, FileSystem] = {}
_REGISTRY_LOCK = threading.Lock()


def register_file_system(scheme: str, fs: FileSystem) -> None:
    with _REGISTRY_LOCK:
        _REGISTRY[scheme] = fs


def get_file_system(uri: str) -> FileSystem:
    scheme = urlparse(uri).scheme if "://" in uri else "file"
    with _REGISTRY_LOCK:
        fs = _REGISTRY.get(scheme)
    if fs is None:
        raise ValueError(
            f"no filesystem registered for scheme {scheme!r} "
            f"(registered: {sorted(_REGISTRY)})"
        )
    return fs


register_file_system("file", LocalFileSystem())
register_file_system("mem", MemoryFileSystem())
