"""High availability: leader election + job result store on a shared FS.

The analogue of the reference's HA services (M7): leader election via an
atomically-created lease file with heartbeat renewal (the file-system
counterpart of ZooKeeperLeaderElectionDriver / the K8s config-map lease,
flink-kubernetes/.../KubernetesLeaderElectionDriver.java:51), and a
JobResultStore (highavailability/FileSystemJobResultStore.java) recording
dirty→clean job results so a recovering dispatcher neither re-runs finished
jobs nor loses unacknowledged results.

Counterpart of `flink_tpu/runtime/ha.py`, copied: the lease and result
files are the JAX package's, so one package's contender sees the other's
lease.
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid
from typing import Callable, Dict, List, Optional


class FileLeaderElection:
    """Lease file: {leader_id, address, stamp}. The holder renews the stamp;
    contenders take over when the stamp goes stale."""

    def __init__(
        self,
        lease_path: str,
        contender_id: Optional[str] = None,
        *,
        address: str = "",
        renew_interval: float = 0.5,
        lease_timeout: float = 3.0,
        on_grant: Optional[Callable[[], None]] = None,
        on_revoke: Optional[Callable[[], None]] = None,
    ):
        self.path = lease_path
        self.contender_id = contender_id or uuid.uuid4().hex
        self.address = address
        self.renew_interval = renew_interval
        self.lease_timeout = lease_timeout
        self.on_grant = on_grant
        self.on_revoke = on_revoke
        self.is_leader = False
        self._running = True
        self._thread = threading.Thread(target=self._loop, name="leader-election", daemon=True)
        self._thread.start()

    def _read(self) -> Optional[dict]:
        try:
            with open(self.path) as f:
                return json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return None

    def _write(self) -> None:
        tmp = f"{self.path}.{self.contender_id}.tmp"
        with open(tmp, "w") as f:
            json.dump({"leader": self.contender_id, "address": self.address,
                       "stamp": time.time()}, f)
        os.replace(tmp, self.path)

    def _try_acquire(self) -> bool:
        try:
            fd = os.open(self.path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            cur = self._read()
            if cur is not None and time.time() - cur["stamp"] <= self.lease_timeout:
                return cur["leader"] == self.contender_id
            # stale lease: contend by rewriting, then confirm ownership
            self._write()
            time.sleep(0.05)
            cur = self._read()
            return cur is not None and cur["leader"] == self.contender_id
        else:
            os.close(fd)
            self._write()
            return True

    def _loop(self) -> None:
        while self._running:
            if self.is_leader:
                cur = self._read()
                if cur is None or cur["leader"] != self.contender_id:
                    self.is_leader = False
                    if self.on_revoke:
                        self.on_revoke()
                else:
                    self._write()  # renew
            else:
                if self._try_acquire():
                    self.is_leader = True
                    if self.on_grant:
                        self.on_grant()
            time.sleep(self.renew_interval)

    def current_leader(self) -> Optional[dict]:
        cur = self._read()
        if cur is None or time.time() - cur["stamp"] > self.lease_timeout:
            return None
        return cur

    def stop(self, release: bool = True) -> None:
        self._running = False
        self._thread.join(timeout=2)
        if release and self.is_leader:
            try:
                os.unlink(self.path)
            except FileNotFoundError:
                pass
            self.is_leader = False


class JobResultStore:
    """Dirty/clean job results as files: <dir>/<job_id>.dirty → .clean."""

    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)

    def create_dirty(self, job_id: str, result: dict) -> None:
        path = os.path.join(self.dir, f"{job_id}.dirty")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(result, f)
        os.replace(tmp, path)

    def mark_clean(self, job_id: str) -> None:
        dirty = os.path.join(self.dir, f"{job_id}.dirty")
        clean = os.path.join(self.dir, f"{job_id}.clean")
        if os.path.exists(dirty):
            os.replace(dirty, clean)

    def has_result(self, job_id: str) -> bool:
        return any(
            os.path.exists(os.path.join(self.dir, f"{job_id}{ext}"))
            for ext in (".dirty", ".clean")
        )

    def dirty_results(self) -> Dict[str, dict]:
        out = {}
        for name in os.listdir(self.dir):
            if name.endswith(".dirty"):
                with open(os.path.join(self.dir, name)) as f:
                    out[name[: -len(".dirty")]] = json.load(f)
        return out
