"""CLI frontend: run / list / info / cancel / savepoint / metrics.

Capability parity with the reference client CLI (CliFrontend.java:93 actions
run, list, cancel, savepoint, info) against the REST endpoint
(runtime/rest.py), or embedded (local MiniCluster + blocking run) when no
--address is given — the LocalExecutor vs RestClusterClient split
(flink-clients LocalExecutor.java:49 / RestClusterClient.java:173).

Counterpart of `flink_tpu/cli/frontend.py`. An embedded run goes through
the port's StreamExecutionEnvironment on `--device` (default cuda, which
raises without a GPU; `--device cpu` runs the plain PyTorch path), as
`python -m flink_tpu_torch.runtime.cluster taskmanager --device` does; an
environment the script built with a device of its own keeps it. Against
`--address` the CLI speaks only HTTP (runtime/rest.py), and the job runs
where the server's cluster runs it.

Usage:
  python -m flink_tpu_torch.cli run <script.py> [--entry main] [--address URL] [--detached]
                                [--device cuda|cpu]
  python -m flink_tpu_torch.cli list --address URL
  python -m flink_tpu_torch.cli info <job_id> --address URL
  python -m flink_tpu_torch.cli cancel <job_id> --address URL
  python -m flink_tpu_torch.cli savepoint <job_id> <target_dir> --address URL
  python -m flink_tpu_torch.cli metrics <job_id> --address URL
"""

from __future__ import annotations

import argparse
import json
import sys
import urllib.request


def _http(method: str, url: str, body: dict = None) -> dict:
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method)
    if data:
        req.add_header("Content-Type", "application/json")
    with urllib.request.urlopen(req, timeout=60) as resp:
        payload = resp.read()
    return json.loads(payload) if payload else {}


def _run_local(script: str, entry: str, detached: bool, device=None) -> int:
    import importlib.util

    from flink_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)   # raises here without a GPU, before the script runs
    spec = importlib.util.spec_from_file_location("flink_tpu_torch_cli_app", script)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fn = getattr(mod, entry)
    result = fn()
    from flink_tpu_torch.api.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.runtime.minicluster import JobClient

    if isinstance(result, StreamExecutionEnvironment):
        if result.device is None:
            result.device = device
        result = result.execute_async()
    if not isinstance(result, JobClient):
        print(f"{entry}() must return JobClient or StreamExecutionEnvironment", file=sys.stderr)
        return 2
    print(f"Job submitted: {result.job_id}")
    if not detached:
        status = result.wait()
        print(f"Job {result.job_id} finished with status {status.value}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="flink-tpu-torch")
    sub = parser.add_subparsers(dest="action", required=True)

    p_run = sub.add_parser("run", help="run a pipeline script")
    p_run.add_argument("script")
    p_run.add_argument("--entry", default="main")
    p_run.add_argument("--address", default=None, help="REST endpoint; omit for embedded run")
    p_run.add_argument("--detached", action="store_true")
    p_run.add_argument("--device", default=None,
                       help="device of an embedded run (default: cuda; raises without a "
                            "GPU unless given --device cpu)")

    for name in ("list",):
        p = sub.add_parser(name)
        p.add_argument("--address", required=True)

    for name in ("info", "cancel", "metrics"):
        p = sub.add_parser(name)
        p.add_argument("job_id")
        p.add_argument("--address", required=True)

    p_sp = sub.add_parser("savepoint")
    p_sp.add_argument("job_id")
    p_sp.add_argument("target_dir")
    p_sp.add_argument("--address", required=True)

    args = parser.parse_args(argv)

    if args.action == "run":
        if args.address is None:
            return _run_local(args.script, args.entry, args.detached, args.device)
        out = _http("POST", f"{args.address}/jars/run", {"module": args.script, "entry": args.entry})
        print(json.dumps(out))
        return 0 if "jobid" in out else 1
    if args.action == "list":
        print(json.dumps(_http("GET", f"{args.address}/jobs"), indent=2))
        return 0
    if args.action == "info":
        print(json.dumps(_http("GET", f"{args.address}/jobs/{args.job_id}"), indent=2))
        return 0
    if args.action == "metrics":
        print(json.dumps(_http("GET", f"{args.address}/jobs/{args.job_id}/metrics"), indent=2))
        return 0
    if args.action == "cancel":
        print(json.dumps(_http("POST", f"{args.address}/jobs/{args.job_id}/cancel")))
        return 0
    if args.action == "savepoint":
        out = _http(
            "POST",
            f"{args.address}/jobs/{args.job_id}/savepoints",
            {"target-directory": args.target_dir},
        )
        print(json.dumps(out))
        return 0
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
