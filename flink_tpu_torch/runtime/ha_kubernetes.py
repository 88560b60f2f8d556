"""Kubernetes leader election over coordination.k8s.io/v1 Lease objects.

The analogue of the reference's KubernetesLeaderElectionDriver
(flink-kubernetes/.../highavailability/KubernetesLeaderElectionDriver.java:51,
which delegates to the fabric8 LeaderElector over a Lease): contenders race
to create/update a Lease whose spec carries holderIdentity, renewTime and
leaseDurationSeconds; the holder renews, contenders take over when
renewTime + duration expires, and optimistic concurrency (resourceVersion +
409 Conflict) arbitrates races.

The driver speaks the real API shapes through an injectable transport
(`api`), so it runs against an actual apiserver (in-cluster: pass an
`InClusterApi()` built from the service-account token) and is unit-tested
against an in-process fake implementing the same verbs + conflict
semantics.

Counterpart of `flink_tpu/runtime/ha_kubernetes.py`, copied: the Lease
bodies, including the `flink-tpu/leader-address` annotation, are the JAX
package's.
"""

from __future__ import annotations

import logging
import json
import threading
import time
import uuid
from typing import Callable, Optional


class LeaseConflict(Exception):
    """HTTP 409: another contender updated the Lease first."""


class LeaseApi:
    """Transport SPI: the three Lease verbs the elector needs. Implementors
    raise KeyError for 404 and LeaseConflict for 409."""

    def get_lease(self, namespace: str, name: str) -> dict:
        raise NotImplementedError

    def create_lease(self, namespace: str, name: str, body: dict) -> dict:
        raise NotImplementedError

    def replace_lease(self, namespace: str, name: str, body: dict) -> dict:
        raise NotImplementedError


class HttpLeaseApi(LeaseApi):
    """Real apiserver transport (in-cluster service-account auth)."""

    def __init__(self, base_url: str, token: str, ca_file: Optional[str] = None):
        self.base = base_url.rstrip("/")
        self.token = token
        self.ca_file = ca_file

    def _req(self, method: str, path: str, body: Optional[dict] = None) -> dict:
        import ssl
        import urllib.error
        import urllib.request

        url = f"{self.base}{path}"
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(url, data=data, method=method)
        req.add_header("Authorization", f"Bearer {self.token}")
        req.add_header("Content-Type", "application/json")
        ctx = ssl.create_default_context(cafile=self.ca_file) if self.ca_file else None
        try:
            with urllib.request.urlopen(req, timeout=10, context=ctx) as r:
                return json.loads(r.read())
        except urllib.error.HTTPError as e:
            if e.code == 404:
                raise KeyError(path) from e
            if e.code == 409:
                raise LeaseConflict(path) from e
            raise

    def _path(self, namespace: str, name: str = "") -> str:
        p = f"/apis/coordination.k8s.io/v1/namespaces/{namespace}/leases"
        return f"{p}/{name}" if name else p

    def get_lease(self, namespace, name):
        return self._req("GET", self._path(namespace, name))

    def create_lease(self, namespace, name, body):
        return self._req("POST", self._path(namespace), body)

    def replace_lease(self, namespace, name, body):
        return self._req("PUT", self._path(namespace, name), body)


def in_cluster_api() -> HttpLeaseApi:
    """Build the transport from the pod's service account (the in-cluster
    config convention: token + CA under /var/run/secrets)."""
    sa = "/var/run/secrets/kubernetes.io/serviceaccount"
    with open(f"{sa}/token") as f:
        token = f.read().strip()
    import os

    host = os.environ["KUBERNETES_SERVICE_HOST"]
    port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
    return HttpLeaseApi(f"https://{host}:{port}", token, f"{sa}/ca.crt")


def _now_micro() -> str:
    # RFC3339 with microseconds, the MicroTime wire format of renewTime
    t = time.time()
    base = time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(t))
    return f"{base}.{int((t % 1) * 1e6):06d}Z"


def _parse_micro(s: str) -> float:
    import calendar

    base, _, frac = s.rstrip("Z").partition(".")
    t = calendar.timegm(time.strptime(base, "%Y-%m-%dT%H:%M:%S"))
    return t + (float(f"0.{frac}") if frac else 0.0)


class KubernetesLeaderElection:
    """Lease-based elector with the same surface as FileLeaderElection
    (is_leader, on_grant/on_revoke, current_leader, stop)."""

    def __init__(
        self,
        api: LeaseApi,
        namespace: str,
        lease_name: str,
        contender_id: Optional[str] = None,
        *,
        address: str = "",
        renew_interval: float = 0.5,
        lease_duration: float = 3.0,
        on_grant: Optional[Callable[[], None]] = None,
        on_revoke: Optional[Callable[[], None]] = None,
        clock: Callable[[], float] = time.time,
    ):
        self.api = api
        self.namespace = namespace
        self.lease_name = lease_name
        self.contender_id = contender_id or uuid.uuid4().hex
        self.address = address
        self.renew_interval = renew_interval
        self.lease_duration = lease_duration
        self.on_grant = on_grant
        self.on_revoke = on_revoke
        self.clock = clock
        self.is_leader = False
        self._last_renew = 0.0
        self._running = True
        self._thread = threading.Thread(
            target=self._loop, name="k8s-leader-election", daemon=True)
        self._thread.start()

    # -- lease bodies -----------------------------------------------------
    def _body(self, resource_version: Optional[str]) -> dict:
        body = {
            "apiVersion": "coordination.k8s.io/v1",
            "kind": "Lease",
            "metadata": {
                "name": self.lease_name,
                "namespace": self.namespace,
                "annotations": {"flink-tpu/leader-address": self.address},
            },
            "spec": {
                "holderIdentity": self.contender_id,
                # wire format is whole seconds; never write 0 (= expired)
                "leaseDurationSeconds": max(1, int(-(-self.lease_duration // 1))),
                "renewTime": _now_micro(),
            },
        }
        if resource_version is not None:
            body["metadata"]["resourceVersion"] = resource_version
        return body

    def _expired(self, lease: dict) -> bool:
        spec = lease.get("spec", {})
        renew = spec.get("renewTime")
        if renew is None:
            return True
        dur = spec.get("leaseDurationSeconds", int(self.lease_duration))
        return self.clock() - _parse_micro(renew) > dur

    # -- elector loop -----------------------------------------------------
    def _try_acquire_or_renew(self) -> bool:
        try:
            lease = self.api.get_lease(self.namespace, self.lease_name)
        except KeyError:
            try:
                self.api.create_lease(
                    self.namespace, self.lease_name, self._body(None))
                return True
            except LeaseConflict:
                return False
        holder = lease.get("spec", {}).get("holderIdentity")
        rv = lease.get("metadata", {}).get("resourceVersion")
        if holder == self.contender_id or self._expired(lease):
            try:
                self.api.replace_lease(
                    self.namespace, self.lease_name, self._body(rv))
                return True
            except LeaseConflict:
                return False
        return False

    def _loop(self) -> None:
        while self._running:
            try:
                leading = self._try_acquire_or_renew()
                if leading:
                    self._last_renew = self.clock()
            except Exception:
                # apiserver unreachable: no contender can steal the lease
                # until it expires, so keep leading until our OWN lease
                # would have lapsed (fabric8/client-go elector semantics —
                # a network blip must not bounce leadership)
                leading = (self.is_leader and
                           self.clock() - self._last_renew <= self.lease_duration)
            if leading and not self.is_leader:
                self.is_leader = True
                if self.on_grant:
                    self.on_grant()
            elif not leading and self.is_leader:
                self.is_leader = False
                if self.on_revoke:
                    self.on_revoke()
            time.sleep(self.renew_interval)

    def current_leader(self) -> Optional[dict]:
        try:
            lease = self.api.get_lease(self.namespace, self.lease_name)
        except KeyError:
            return None
        if self._expired(lease):
            return None
        return {
            "leader_id": lease["spec"].get("holderIdentity"),
            "address": lease.get("metadata", {})
            .get("annotations", {})
            .get("flink-tpu/leader-address", ""),
        }

    def stop(self, release: bool = True) -> None:
        self._running = False
        # join longer than the transport timeout (10s): an in-flight renew
        # completing AFTER the release below would resurrect the lease
        self._thread.join(timeout=12)
        if self._thread.is_alive():
            release = False  # cannot release safely under a wedged renew
        if release and self.is_leader:
            try:
                lease = self.api.get_lease(self.namespace, self.lease_name)
                rv = lease.get("metadata", {}).get("resourceVersion")
                body = self._body(rv)
                body["spec"]["renewTime"] = "1970-01-01T00:00:00.000000Z"
                self.api.replace_lease(self.namespace, self.lease_name, body)
            except Exception as e:
                logging.getLogger(__name__).debug(
                    "lease release failed (next holder waits it out): %r", e)
            self.is_leader = False
