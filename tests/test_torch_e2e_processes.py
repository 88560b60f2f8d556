"""The port's cluster as real processes, as tests/test_e2e_processes.py
runs the JAX package's: `python -m flink_tpu_torch.runtime.cluster
jobmanager|taskmanager --device cpu` with the secret given by file, a job
submitted over the real RPC socket, and a TaskManager SIGKILLed mid-job
to exercise checkpoint-restore failover across OS processes. The job's
source is `testing.cluster_jobs.ApiShardSource`, a module-level class, so
a TaskManager process rebuilds the spec with the standard library's pickle.
"""

import os
import secrets
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from flink_tpu_torch.api.windowing.assigners import TumblingEventTimeWindows
from flink_tpu_torch.runtime.cluster import DistributedJobSpec
from flink_tpu_torch.runtime.rpc import RpcService
from flink_tpu_torch.security.transport import SecurityConfig
from flink_tpu_torch.testing.cluster_jobs import ApiShardSource

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture
def secret_file(tmp_path):
    path = tmp_path / "cluster.secret"
    path.write_text(secrets.token_hex(16))
    return str(path)


def _spawn(args, secret_file):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.Popen(
        [sys.executable, "-m", "flink_tpu_torch.runtime.cluster", *args,
         "--secret-file", secret_file],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, cwd=ROOT)


def _wait_line(proc, needle, timeout=60):
    deadline = time.time() + timeout
    while time.time() < deadline:
        line = proc.stdout.readline().decode(errors="replace")
        if needle in line:
            return line
        if proc.poll() is not None:
            raise RuntimeError(f"process exited: {line}{proc.stdout.read().decode()}")
    raise TimeoutError(f"no {needle!r} within {timeout}s")


def _await_status(client, job_id, want, timeout=60):
    deadline = time.time() + timeout
    st = None
    while time.time() < deadline:
        st = client.job_status(job_id)
        if st["status"] in want:
            return st
        time.sleep(0.2)
    raise TimeoutError(f"job stuck in {st}")


def _spec(steps, batch, keys=16, delay_s=0.0):
    return DistributedJobSpec(name="e2e",
                              source_factory=ApiShardSource(steps, batch, keys, delay_s),
                              assigner=TumblingEventTimeWindows.of(2000), aggregate="count",
                              max_parallelism=16)


def _client(secret_file, port):
    with open(secret_file, "rb") as f:
        sec = SecurityConfig.with_secret(f.read().strip())
    svc = RpcService(security=sec)
    return svc, svc.gateway(f"127.0.0.1:{port}", "jobmanager")


def _kill(procs):
    for p in procs:
        p.kill()
        p.wait(timeout=10)
        p.stdout.close()


def test_real_process_cluster_runs_a_job(secret_file):
    port = _free_port()
    procs = [_spawn(["jobmanager", "--port", str(port)], secret_file)]
    try:
        _wait_line(procs[0], "jobmanager listening")
        procs.append(_spawn(["taskmanager", "--jobmanager", f"127.0.0.1:{port}",
                             "--slots", "2", "--device", "cpu"], secret_file))
        _wait_line(procs[1], "registered with")
        svc, client = _client(secret_file, port)
        job_id = client.submit_job(_spec(8, 64).to_bytes(), 2)
        st = _await_status(client, job_id, ("FINISHED", "FAILED"))
        assert st["status"] == "FINISHED", st
        total = sum(r for (_k, _w, r, _t) in client.job_result(job_id))
        assert total == 8 * 64            # every record of every shard counted
        svc.stop()
    finally:
        _kill(procs)


def test_real_process_taskmanager_sigkill_failover(secret_file, tmp_path):
    port = _free_port()
    procs = [_spawn(["jobmanager", "--port", str(port), "--checkpoint-dir",
                     str(tmp_path / "chk"), "--checkpoint-interval", "0.2"], secret_file)]
    try:
        _wait_line(procs[0], "jobmanager listening")
        tm_args = ["taskmanager", "--jobmanager", f"127.0.0.1:{port}", "--device", "cpu"]
        procs.append(_spawn(tm_args, secret_file))
        _wait_line(procs[1], "registered with")
        svc, client = _client(secret_file, port)
        spec = _spec(300, 50, delay_s=0.05)    # paced: the kill lands mid-run
        job_id = client.submit_job(spec.to_bytes(), 1)
        _await_status(client, job_id, ("RUNNING",))
        deadline = time.time() + 30
        while not client.job_status(job_id)["checkpoints"] and time.time() < deadline:
            time.sleep(0.1)
        assert client.job_status(job_id)["status"] == "RUNNING"
        os.kill(procs[1].pid, signal.SIGKILL)
        procs[1].wait(timeout=10)
        procs.append(_spawn(tm_args, secret_file))
        _wait_line(procs[2], "registered with")
        st = _await_status(client, job_id, ("FINISHED", "FAILED"), timeout=90)
        assert st["status"] == "FINISHED" and st["restarts"] >= 1, st
        rows = client.job_result(job_id)
        assert sum(r for (_k, _w, r, _t) in rows) == 300 * 50   # exactly once
        keys, ts = ApiShardSource(300, 50, 16).records(np.arange(300 * 50))
        want = {}
        for k, w in zip(keys.tolist(), (ts // 2000).tolist()):
            want[(k, w * 2000)] = want.get((k, w * 2000), 0) + 1
        assert {(k, w[0]): r for k, w, r, _t in rows} == want
        svc.stop()
    finally:
        _kill(procs)


def test_taskmanager_process_without_a_gpu_refuses_to_start(secret_file):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is cuda")
    port = _free_port()
    jm = _spawn(["jobmanager", "--port", str(port)], secret_file)
    try:
        _wait_line(jm, "jobmanager listening")
        tm = _spawn(["taskmanager", "--jobmanager", f"127.0.0.1:{port}"], secret_file)
        out, _ = tm.communicate(timeout=60)
        assert tm.returncode != 0 and b"no GPU" in out
        tm.stdout.close()
    finally:
        _kill([jm])
