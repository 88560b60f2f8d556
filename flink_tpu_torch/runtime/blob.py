"""Blob service: content-addressed distribution of job artifacts.

Analogue of runtime/blob/BlobServer.java:88: the JobManager hosts a blob
endpoint; TaskExecutors fetch job payloads (pickled plans, UDF closures —
the JAR analogue) by content hash and cache them on local disk, so a plan
is shipped once per host regardless of how many shards run there.

Security: the blob endpoint rides the JM's RPC service, so every fetch is
behind the transport handshake + per-frame MACs (flink_tpu_torch/security) — an
unauthenticated peer is disconnected at the JM RPC port before any request
parses. Content addressing doubles as end-to-end integrity: BlobCache
re-hashes fetched AND disk-cached bytes against the requested key, so a
tampered store or cache directory cannot smuggle a different payload into
`trusted_loads` (the reference's BlobUtils checksum discipline).

Counterpart of `flink_tpu/runtime/blob.py`, copied.
"""

from __future__ import annotations

import hashlib
import os
import tempfile
from typing import Dict, Optional

from flink_tpu_torch.runtime.rpc import RpcEndpoint


class BlobServerEndpoint(RpcEndpoint):
    """JM-side store (RPC endpoint name: 'blob')."""

    def __init__(self, storage_dir: Optional[str] = None):
        super().__init__(name="blob")
        self.dir = storage_dir or tempfile.mkdtemp(prefix="flink_tpu_blob_")
        os.makedirs(self.dir, exist_ok=True)

    def put(self, data: bytes) -> str:
        key = hashlib.sha256(data).hexdigest()
        path = os.path.join(self.dir, key)
        if not os.path.exists(path):
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(data)
            os.replace(tmp, path)
        return key

    def get(self, key: str) -> bytes:
        path = os.path.join(self.dir, key)
        if not os.path.exists(path):
            raise KeyError(f"no blob {key}")
        with open(path, "rb") as f:
            return f.read()

    def has(self, key: str) -> bool:
        return os.path.exists(os.path.join(self.dir, key))

    def delete(self, key: str) -> None:
        try:
            os.unlink(os.path.join(self.dir, key))
        except FileNotFoundError:
            pass


class BlobCache:
    """TM-side cache: fetch-once per content key (TM blob cache analogue)."""

    def __init__(self, gateway, cache_dir: Optional[str] = None):
        self._gw = gateway
        self.dir = cache_dir or tempfile.mkdtemp(prefix="flink_tpu_blobcache_")
        os.makedirs(self.dir, exist_ok=True)
        self._mem: Dict[str, bytes] = {}

    def get(self, key: str) -> bytes:
        data = self._mem.get(key)
        if data is not None:
            return data
        path = os.path.join(self.dir, key)
        if os.path.exists(path):
            with open(path, "rb") as f:
                data = f.read()
            if hashlib.sha256(data).hexdigest() != key:
                # corrupted/tampered local cache entry: refetch from the JM
                os.unlink(path)
                data = None
        if data is None:
            data = self._gw.get(key)
            if hashlib.sha256(data).hexdigest() != key:
                raise ValueError(
                    f"blob {key} failed content-hash verification after fetch"
                )
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(data)
            os.replace(tmp, path)
        self._mem[key] = data
        return data
