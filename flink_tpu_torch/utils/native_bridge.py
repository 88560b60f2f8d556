"""ctypes binding of the native spill store (`native/spill_store.cpp`).

Counterpart of `flink_tpu/utils/native_bridge.py`, for what the port's
state plane needs: `NativeSpillStore`, the batched u64 -> fixed-width-bytes
LSM the cold key tier (`state/cold_tier.py`) keeps its rows in. The
library is built at first use from the repo's C++ sources with
`g++ -O3 -shared -fPIC -std=c++17` into `build/flink_tpu_torch/native/`,
named by a hash of the sources and flags (never into `native/`, where the
JAX package's bridge writes its own). Each build goes to a file of its
own process and is renamed into place, so parallel test workers building
at once never load a half-written library.

`get_lib()` returns None when the library cannot be built or loaded, and
`NativeSpillStore` then raises RuntimeError: the cold tier catches it and
keeps its rows in a Python dict instead (the JAX package's posture). Both
packages compile the same source, so a manifest written by one restores in
the other.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_REPO_ROOT = Path(__file__).resolve().parents[2]
SOURCES = (_REPO_ROOT / "native" / "flink_tpu_native.cpp",
           _REPO_ROOT / "native" / "spill_store.cpp")
BUILD_DIR = _REPO_ROOT / "build" / "flink_tpu_torch" / "native"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def library_path() -> Path:
    """Where the library of the current sources and flags lives."""
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libflink_tpu_native-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Build the library unless the current sources already have one.
    Raises with g++'s output on failure."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"tmp-{os.getpid()}-{threading.get_ident()}-{path.name}"
    res = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), *map(str, SOURCES)],
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed building the native spill store:\n{res.stderr}")
    os.replace(tmp, path)
    return path


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library (built first if need be); None if unavailable."""
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        try:
            lib = ctypes.CDLL(str(build()))
            _declare(lib)
            _lib = lib
        except (OSError, RuntimeError, subprocess.SubprocessError):
            _load_failed = True
    return _lib


def _declare(lib: ctypes.CDLL) -> None:
    c = ctypes
    lib.ss_create.restype = c.c_void_p
    lib.ss_create.argtypes = [c.c_int64, c.c_char_p]
    lib.ss_free.argtypes = [c.c_void_p]
    lib.ss_mem_entries.restype = c.c_int64
    lib.ss_mem_entries.argtypes = [c.c_void_p]
    lib.ss_num_runs.restype = c.c_int64
    lib.ss_num_runs.argtypes = [c.c_void_p]
    lib.ss_put_batch.argtypes = [c.c_void_p, c.c_void_p, c.c_void_p, c.c_int64]
    lib.ss_get_batch.restype = c.c_int64
    lib.ss_get_batch.argtypes = [c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p, c.c_int64]
    lib.ss_flush.restype = c.c_int64
    lib.ss_flush.argtypes = [c.c_void_p]
    lib.ss_compact.restype = c.c_int64
    lib.ss_compact.argtypes = [c.c_void_p]
    lib.ss_manifest.restype = c.c_int64
    lib.ss_manifest.argtypes = [c.c_void_p, c.c_void_p, c.c_int64]
    lib.ss_gc.restype = c.c_int64
    lib.ss_gc.argtypes = [c.c_void_p, c.c_char_p, c.c_int64]
    lib.ss_restore.restype = c.c_int64
    lib.ss_restore.argtypes = [c.c_void_p, c.c_char_p, c.c_int64]
    lib.ss_clear.argtypes = [c.c_void_p]
    lib.ss_set_next_run_id.argtypes = [c.c_void_p, c.c_int64]
    lib.ss_purge_below.restype = c.c_int64
    lib.ss_purge_below.argtypes = [c.c_void_p, c.c_uint64]


class NativeSpillStore:
    """Batched u64 -> fixed-width-bytes store over the C++ LSM: the host
    spill tier for keyed state beyond device memory."""

    def __init__(self, value_width: int, directory: str):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native library unavailable")
        os.makedirs(directory, exist_ok=True)
        self._lib = lib
        self.width = value_width
        self.dir = directory
        self._handle = lib.ss_create(value_width, directory.encode())
        # never reuse run ids of files already on disk (old manifests may
        # still reference them)
        max_id = 0
        for name in os.listdir(directory):
            if name.startswith("run-") and name.endswith(".spill"):
                try:
                    max_id = max(max_id, int(name[4:-6]))
                except ValueError:
                    pass
        if max_id:
            lib.ss_set_next_run_id(self._handle, max_id + 1)

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.ss_free(self._handle)
            self._handle = None

    def put_batch(self, keys: np.ndarray, values: np.ndarray) -> None:
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        values = np.ascontiguousarray(values)
        assert values.nbytes == len(keys) * self.width
        self._lib.ss_put_batch(self._handle, keys.ctypes.data, values.ctypes.data, len(keys))

    def get_batch(self, keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (values uint8[n, width], found bool[n])."""
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        out = np.zeros((len(keys), self.width), dtype=np.uint8)
        found = np.zeros(len(keys), dtype=np.uint8)
        self._lib.ss_get_batch(self._handle, keys.ctypes.data, out.ctypes.data,
                               found.ctypes.data, len(keys))
        return out, found.astype(bool)

    def flush(self) -> int:
        rid = self._lib.ss_flush(self._handle)
        if rid < 0:
            raise OSError(f"spill flush failed in {self.dir}")
        return rid

    def compact(self) -> int:
        rid = self._lib.ss_compact(self._handle)
        if rid < 0:
            raise OSError(f"spill compact failed in {self.dir}")
        return rid

    @property
    def mem_entries(self) -> int:
        return self._lib.ss_mem_entries(self._handle)

    @property
    def num_runs(self) -> int:
        return self._lib.ss_num_runs(self._handle)

    def checkpoint(self) -> str:
        """Flush and return the manifest (newline-joined immutable run file
        names); successive checkpoints share unchanged runs."""
        self.flush()
        cap = 1 << 16
        while True:
            buf = ctypes.create_string_buffer(cap)
            n = self._lib.ss_manifest(self._handle, buf, cap)
            if n >= 0:
                return buf.raw[:n].decode()
            cap = -n + 1

    def clear(self) -> None:
        self._lib.ss_clear(self._handle)

    def purge_below(self, threshold: int) -> int:
        """Drop every entry with key < threshold (retention cut). Returns
        entries dropped; raises on I/O error while rewriting a run."""
        n = self._lib.ss_purge_below(self._handle, ctypes.c_uint64(threshold))
        if n < 0:
            raise OSError(f"spill purge failed in {self.dir}")
        return int(n)

    def gc(self, retained_manifests) -> int:
        """Unlink run files referenced by neither the live run list nor any
        retained checkpoint manifest."""
        blob = "\n".join(m for m in retained_manifests if m).encode()
        n = self._lib.ss_gc(self._handle, blob, len(blob))
        if n < 0:
            raise OSError(f"spill gc failed in {self.dir}")
        return int(n)

    def restore(self, manifest: str) -> None:
        """Replace the store's contents with the manifest's runs (rollback)."""
        m = manifest.encode()
        n = self._lib.ss_restore(self._handle, m, len(m))
        if n < 0:
            raise OSError(f"spill restore failed from manifest in {self.dir}")
