"""Kubernetes cluster descriptor: JM/TM manifests for a GPU cluster (Y2).

Analogue of flink-kubernetes/.../KubernetesClusterDescriptor.java +
KubernetesResourceManagerDriver.java (the RM creating TM pods) at the
declarative level this framework deploys at: generate the Deployment /
Service / ConfigMap objects (JSON — a strict YAML subset kubectl accepts)
for one JobManager and N TaskManager workers, with the GPU resource
requests and a pod-template decorator hook
(kubeclient/decorators/ analogue).

Counterpart of `flink_tpu/deploy/kubernetes.py`: the same objects, secret
mount and env var. The pods run `python -m flink_tpu_torch.runtime.cluster`:
the JobManager off the GPU (`CUDA_VISIBLE_DEVICES` empty, where the JAX
package pins `JAX_PLATFORMS=cpu`), each TaskManager with `--device cuda`.
The TPU nodeSelector and `google.com/tpu`
limit become an NVIDIA GPU product selector (`nvidia.com/gpu.product`, the
label NVIDIA's GPU feature discovery puts on a node) and an
`nvidia.com/gpu` limit, from `--gpu-product` and `--gpus`.

Apply with: `kubectl apply -f <(python -m flink_tpu_torch.deploy.kubernetes ...)`.
"""

from __future__ import annotations

import base64
import json
import secrets as _secrets
from typing import Callable, Dict, List, Optional


DEFAULT_IMAGE = "flink-tpu:latest"

# where the cluster transport secret (flink_tpu_torch/security) is mounted in
# every JM/TM pod; the runtime picks it up via the env var below
SECRET_MOUNT_PATH = "/etc/flink-tpu/secret"
SECRET_FILE_KEY = "transport.secret"
SECRET_ENV_VAR = "FLINK_TPU_SECURITY_TRANSPORT_SECRET_FILE"


def _container(name: str, args: List[str], image: str, env: Dict[str, str],
               resources: Optional[dict] = None) -> dict:
    c = {
        "name": name,
        "image": image,
        "args": args,
        "env": [{"name": k, "value": str(v)} for k, v in env.items()],
        "ports": [],
    }
    if resources:
        c["resources"] = resources
    return c


class KubernetesClusterDescriptor:
    def __init__(
        self,
        cluster_id: str,
        *,
        namespace: str = "default",
        image: str = DEFAULT_IMAGE,
        taskmanagers: int = 2,
        slots_per_tm: int = 1,
        gpu_product: Optional[str] = None,     # e.g. "NVIDIA-H100-80GB-HBM3"
        gpus_per_tm: int = 0,                  # nvidia.com/gpu resource count
        jm_port: int = 6123,
        pod_decorator: Optional[Callable[[dict], dict]] = None,
        transport_secret: Optional[str] = None,
        secret_name: Optional[str] = None,
    ):
        self.cluster_id = cluster_id
        self.namespace = namespace
        self.image = image
        self.taskmanagers = taskmanagers
        self.slots_per_tm = slots_per_tm
        self.gpu_product = gpu_product
        self.gpus_per_tm = gpus_per_tm
        self.jm_port = jm_port
        self.pod_decorator = pod_decorator or (lambda pod: pod)
        # transport auth (flink_tpu_torch/security): every pod mounts one K8s
        # Secret and points the runtime at it. Pass secret_name to reference
        # an EXISTING Secret (holding key 'transport.secret') and keep the
        # secret value out of the rendered manifests; otherwise a fresh
        # random secret is generated per descriptor and rendered inline.
        # CAUTION with the generated form: every new render carries a NEW
        # random value, so re-applying regenerated manifests to a live
        # cluster rotates the secret mid-flight and splits old/new pods
        # until all restart — for anything long-lived, provision the Secret
        # once (`kubectl create secret generic <name>
        # --from-literal=transport.secret=$(openssl rand -hex 32)`) and
        # render with secret_name=<name> (CLI: --secret-name), or pin the
        # value with transport_secret= (CLI: --secret-file).
        self.secret_name = secret_name or f"{cluster_id}-transport-secret"
        self.render_secret = secret_name is None
        self.transport_secret = transport_secret or _secrets.token_hex(32)

    # -- manifests ----------------------------------------------------------
    def jobmanager_service(self) -> dict:
        return {
            "apiVersion": "v1",
            "kind": "Service",
            "metadata": {"name": f"{self.cluster_id}-jobmanager",
                         "namespace": self.namespace,
                         "labels": {"app": self.cluster_id, "component": "jobmanager"}},
            "spec": {
                "selector": {"app": self.cluster_id, "component": "jobmanager"},
                "ports": [
                    {"name": "rpc", "port": self.jm_port},
                    {"name": "rest", "port": 8081},
                ],
            },
        }

    def transport_secret_manifest(self) -> dict:
        """The cluster transport secret as a K8s Secret (Opaque). Only part
        of manifests() when this descriptor GENERATED the secret; with
        secret_name= the operator provisions it out of band:
        `kubectl create secret generic <name> --from-literal=transport.secret=...`"""
        return {
            "apiVersion": "v1",
            "kind": "Secret",
            "metadata": {"name": self.secret_name, "namespace": self.namespace,
                         "labels": {"app": self.cluster_id}},
            "type": "Opaque",
            "data": {SECRET_FILE_KEY: base64.b64encode(
                self.transport_secret.encode()).decode()},
        }

    def _mount_transport_secret(self, container: dict) -> dict:
        container.setdefault("volumeMounts", []).append(
            {"name": "transport-secret", "mountPath": SECRET_MOUNT_PATH,
             "readOnly": True})
        container["env"].append(
            {"name": SECRET_ENV_VAR,
             "value": f"{SECRET_MOUNT_PATH}/{SECRET_FILE_KEY}"})
        return container

    def _pod(self, component: str, container: dict, extra_spec: Optional[dict] = None) -> dict:
        spec: dict = {"containers": [self._mount_transport_secret(container)],
                      "volumes": [{"name": "transport-secret",
                                   "secret": {"secretName": self.secret_name,
                                              "defaultMode": 0o400}}]}
        if component == "taskmanager" and self.gpu_product:
            # GPU scheduling: the product label of NVIDIA's GPU feature
            # discovery + the device plugin's resource request
            spec["nodeSelector"] = {
                "nvidia.com/gpu.product": self.gpu_product,
            }
        if extra_spec:
            spec.update(extra_spec)
        pod = {
            "metadata": {"labels": {"app": self.cluster_id, "component": component}},
            "spec": spec,
        }
        return self.pod_decorator(pod)

    def jobmanager_deployment(self) -> dict:
        container = _container(
            "jobmanager",
            ["python", "-m", "flink_tpu_torch.runtime.cluster", "jobmanager",
             "--host", "0.0.0.0", "--port", str(self.jm_port),
             "--checkpoint-dir", "/checkpoints", "--checkpoint-interval", "30"],
            self.image, {"CUDA_VISIBLE_DEVICES": ""},
        )
        container["ports"] = [{"containerPort": self.jm_port}]
        return {
            "apiVersion": "apps/v1",
            "kind": "Deployment",
            "metadata": {"name": f"{self.cluster_id}-jobmanager",
                         "namespace": self.namespace},
            "spec": {
                "replicas": 1,
                "selector": {"matchLabels": {"app": self.cluster_id,
                                             "component": "jobmanager"}},
                "template": self._pod("jobmanager", container),
            },
        }

    def taskmanager_deployment(self) -> dict:
        resources = None
        if self.gpus_per_tm:
            resources = {"limits": {"nvidia.com/gpu": self.gpus_per_tm}}
        container = _container(
            "taskmanager",
            ["python", "-m", "flink_tpu_torch.runtime.cluster", "taskmanager",
             "--jobmanager", f"{self.cluster_id}-jobmanager:{self.jm_port}",
             "--slots", str(self.slots_per_tm), "--device", "cuda"],
            self.image, {}, resources,
        )
        return {
            "apiVersion": "apps/v1",
            "kind": "Deployment",
            "metadata": {"name": f"{self.cluster_id}-taskmanager",
                         "namespace": self.namespace},
            "spec": {
                "replicas": self.taskmanagers,
                "selector": {"matchLabels": {"app": self.cluster_id,
                                             "component": "taskmanager"}},
                "template": self._pod("taskmanager", container),
            },
        }

    def manifests(self) -> List[dict]:
        out = [self.transport_secret_manifest()] if self.render_secret else []
        return out + [
            self.jobmanager_service(),
            self.jobmanager_deployment(),
            self.taskmanager_deployment(),
        ]

    def render(self) -> str:
        """kubectl-applicable multi-document output (JSON List object)."""
        return json.dumps({"apiVersion": "v1", "kind": "List",
                           "items": self.manifests()}, indent=2)


class YarnClusterDescriptor:
    """YARN deployment gate (Y3): the reference ships flink-yarn; this
    environment has no Hadoop — constructing the descriptor states that
    clearly instead of failing deep inside a submission."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "YARN deployment requires a Hadoop/YARN client environment, which "
            "this build does not vendor; deploy with KubernetesClusterDescriptor "
            "or bin/start-cluster.sh (standalone)"
        )


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser(prog="flink_tpu_torch.deploy.kubernetes")
    p.add_argument("cluster_id")
    p.add_argument("--namespace", default="default")
    p.add_argument("--image", default=DEFAULT_IMAGE)
    p.add_argument("--taskmanagers", type=int, default=2)
    p.add_argument("--slots", type=int, default=1)
    p.add_argument("--gpu-product", default=None,
                   help="nvidia.com/gpu.product node label the TaskManagers select")
    p.add_argument("--gpus", type=int, default=0,
                   help="nvidia.com/gpu limit of each TaskManager")
    p.add_argument("--secret-name", default=None,
                   help="reference an existing K8s Secret (key "
                        "'transport.secret') instead of rendering a fresh "
                        "random one — REQUIRED for stable re-renders of a "
                        "live cluster")
    p.add_argument("--secret-file", default=None,
                   help="pin the rendered Secret's value from a local file")
    a = p.parse_args(argv)
    if a.secret_name and a.secret_file:
        p.error("--secret-name and --secret-file are mutually exclusive: a "
                "referenced Secret is provisioned out of band, so a pinned "
                "local value would be silently ignored")
    secret_value = None
    if a.secret_file:
        # same read path as the runtime: rejects an empty/whitespace file
        # instead of silently rendering a fresh random secret in its place
        from flink_tpu_torch.security.transport import _read_secret_file

        secret_value = _read_secret_file(a.secret_file).decode()
    print(KubernetesClusterDescriptor(
        a.cluster_id, namespace=a.namespace, image=a.image,
        taskmanagers=a.taskmanagers, slots_per_tm=a.slots,
        gpu_product=a.gpu_product, gpus_per_tm=a.gpus,
        transport_secret=secret_value, secret_name=a.secret_name,
    ).render())


if __name__ == "__main__":
    main()
