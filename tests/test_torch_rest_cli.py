"""The port's REST server, dashboard, flame graph and CLI against the JAX
package's (the cases of JAX tests/test_rest_cli.py, each on both packages).

Both packages' `RestServer` serve a MiniCluster each, on port 0, and run the
same application script (the port's on the CPU) submitted through
`POST /jars/run`. Equal across the packages, job ids and wall-clock values
aside: the route set and each route's status code, the JSON keys of every
route and the values that do not follow the wall clock (records in,
restarts, checkpoints, statuses, the empty payloads), the Prometheus metric
families, the 404s and 400s, bearer auth, the OTLP span names of a
checkpointed job, and the CLI's output embedded (the port's with
`--device cpu`) and against REST. The distributed bridge (`jm_gateway`)
serves each package's cluster job under the same routes and keys. The
OTLP service name is each package's own (`flink-tpu`, `flink-tpu-torch`).
"""

import json
import re
import textwrap
import time
import urllib.error
import urllib.request

import pytest

pytest.importorskip("jax")

import flink_tpu.chaos.scenarios as jscen  # noqa: E402
import flink_tpu.cli.frontend as jcli  # noqa: E402
import flink_tpu.runtime.minicluster as jmc  # noqa: E402
import flink_tpu.runtime.rest as jrest  # noqa: E402
import flink_tpu_torch.chaos.scenarios as tscen  # noqa: E402
import flink_tpu_torch.cli.frontend as tcli  # noqa: E402
import flink_tpu_torch.runtime.minicluster as tmc  # noqa: E402
import flink_tpu_torch.runtime.rest as trest  # noqa: E402

PKGS = {"jax": (jmc, jrest, "flink_tpu", ""), "port": (tmc, trest, "flink_tpu_torch",
                                                         ', device="cpu"')}


@pytest.fixture()
def servers():
    """{pkg: (cluster, server)}, each server started on port 0."""
    out = {}
    try:
        for pkg, (mc, rest, _name, _dev) in PKGS.items():
            cluster = mc.MiniCluster()
            out[pkg] = (cluster, rest.RestServer(cluster).start())
        yield out
    finally:
        for _c, server in out.values():
            server.stop()


def _get(url, token=None):
    req = urllib.request.Request(url)
    if token:
        req.add_header("Authorization", f"Bearer {token}")
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _post(url, body=None):
    data = json.dumps(body).encode() if body is not None else b""
    req = urllib.request.Request(url, data=data, method="POST")
    req.add_header("Content-Type", "application/json")
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _app_script(tmp_path, pkg, count=500, sleep=0.0, checkpoint_ms=0):
    """JAX tests/test_rest_cli.py's application, written for `pkg` (the
    port's environment on the CPU)."""
    _mc, _rest, name, dev = PKGS[pkg]
    script = tmp_path / f"app_{pkg}_{count}_{checkpoint_ms}.py"
    script.write_text(textwrap.dedent(f"""
        import time
        import numpy as np
        from {name}.api.datastream import StreamExecutionEnvironment
        from {name}.api.windowing.assigners import TumblingEventTimeWindows
        from {name}.config import CheckpointingOptions, Configuration, ExecutionOptions
        from {name}.connectors.sink import CollectSink
        from {name}.connectors.source import Batch, DataGeneratorSource
        from {name}.core.watermarks import WatermarkStrategy
        from {name}.utils.arrays import obj_array

        def gen(idx):
            time.sleep({sleep})
            values = [(int(i % 3), 1.0, int(i * 10)) for i in idx]
            return Batch(obj_array(values), (idx * 10).astype(np.int64))

        def main():
            config = Configuration()
            config.set(ExecutionOptions.BATCH_SIZE, 50)
            if {checkpoint_ms}:
                config.set(CheckpointingOptions.INTERVAL_MS, {checkpoint_ms})
            env = StreamExecutionEnvironment(config{dev})
            stream = env.from_source(
                DataGeneratorSource(gen, count={count}),
                watermark_strategy=WatermarkStrategy.for_monotonous_timestamps(),
            )
            (stream.key_by(lambda x: x[0])
                .window(TumblingEventTimeWindows.of(1000))
                .count()
                .sink_to(CollectSink()))
            return env
    """))
    return str(script)


def _keys(obj, depth=2):
    """The key structure of a JSON value, `depth` levels down."""
    if isinstance(obj, dict) and depth:
        return {k: _keys(v, depth - 1) for k, v in obj.items()}
    if isinstance(obj, list) and obj and depth:
        return [_keys(obj[0], depth - 1)]
    return type(obj).__name__ if obj is not None else None


def _families(text: bytes):
    return set(re.findall(rb"^# TYPE (\S+) ", text, re.M))


def _submit(server, script):
    status, out = _post(f"{server.url}/jars/run", {"module": script})
    assert status == 200, out
    return out["jobid"]


ROUTES = ("", "/metrics", "/vertices/{uid}/backpressure", "/checkpoints", "/checkpoints/1",
          "/checkpoints/x", "/exceptions", "/autoscaler", "/device", "/latency", "/history",
          "/history?since=abc", "/doctor", "/traces", "/state/{uid}", "/nosuch")


def _uid(client):
    uid = next(k.split(".")[2] for k in client.metrics.all_metrics()
               if k.startswith("job.operator."))
    return uid


def test_every_route_answers_as_the_jax_packages(servers, tmp_path):
    got = {}
    for pkg, (cluster, server) in servers.items():
        job = _submit(server, _app_script(tmp_path, pkg))
        client = cluster.jobs[job]
        assert client.wait(60).value == "FINISHED"
        uid = _uid(client)
        routes = {}
        for r in ROUTES:
            status, body = _get(f"{server.url}/jobs/{job}{r.format(uid=uid)}")
            routes[r] = (status, json.loads(body))
        for r in ("/overview", "/jobs", "/jobs/nonexistent", "/jobs/nonexistent/metrics",
                  "/nosuch"):
            status, body = _get(server.url + r)
            routes[r] = (status, json.loads(body))
        got[pkg] = (job, routes, _get(server.url + "/metrics"), _get(server.url + "/"))
    (jjob, jr, jprom, jdash), (tjob, tr, tprom, tdash) = got["jax"], got["port"]
    assert {r: s for r, (s, _b) in tr.items()} == {r: s for r, (s, _b) in jr.items()}
    assert tr["/state/{uid}"][0] == tr["/checkpoints/x"][0] == tr["/history?since=abc"][0] == 400
    assert tr["/checkpoints/1"][0] == tr["/nosuch"][0] == tr["/jobs/nonexistent"][0] == 404
    for r in tr:
        assert _keys(tr[r][1]) == _keys(jr[r][1]), (r, tr[r][1], jr[r][1])
    detail = ("status", "records_in", "num_restarts", "num_checkpoints", "error")
    assert {k: tr[""][1][k] for k in detail} == {k: jr[""][1][k] for k in detail}
    assert tr[""][1]["records_in"] == 500 and tr[""][1]["error"] is None
    for r in ("/checkpoints", "/exceptions", "/overview"):
        assert tr[r][1] == jr[r][1], r
    assert tr["/doctor"][1]["verdict"] == jr["/doctor"][1]["verdict"]
    assert tr["/metrics"][1]["job.numRecordsIn"] == jr["/metrics"][1]["job.numRecordsIn"] == 500
    assert [(j["status"]) for j in tr["/jobs"][1]["jobs"]] == ["FINISHED"]
    assert tr["/jobs"][1]["jobs"][0]["id"] == tjob
    auto = ("enabled", "policy", "num_rescales", "decisions", "parallelism")
    assert {k: tr["/autoscaler"][1][k] for k in auto} == {k: jr["/autoscaler"][1][k] for k in auto}
    # Prometheus: the same families, each sample labeled by its job
    assert tprom[0] == jprom[0] == 200
    assert _families(tprom[1]) == _families(jprom[1]) and _families(tprom[1])
    assert f'job_numRecordsIn{{job="{tjob}"}} 500'.encode() in tprom[1]
    assert b"# TYPE job_numRecordsIn gauge" in tprom[1]
    # the dashboard polls the JSON routes and renders the device plane's table
    assert tdash[0] == 200 and b"flink-tpu-torch" in tdash[1] and b"/jobs" in tdash[1]
    assert b"device plane" in tdash[1] and b"/device" in tdash[1]


def test_rest_cancel_and_savepoint(servers, tmp_path):
    for pkg, (cluster, server) in servers.items():
        job = _submit(server, _app_script(tmp_path, pkg, count=50_000, sleep=0.01))
        client = cluster.jobs[job]
        deadline = time.time() + 30
        while client.records_in < 200 and time.time() < deadline:
            time.sleep(0.01)
        assert _post(f"{server.url}/jobs/{job}/savepoints", {})[0] == 400
        status, out = _post(f"{server.url}/jobs/{job}/savepoints",
                            {"target-directory": str(tmp_path / f"sp-{pkg}")})
        assert status == 200 and out["location"], (pkg, out)
        assert (tmp_path / f"sp-{pkg}").exists()
        assert _post(f"{server.url}/jobs/{job}/cancel") == (202, {"status": "cancelling"})
        assert client.wait(30).value == "CANCELED"
        assert _post(f"{server.url}/jobs/nonexistent/cancel")[0] == 404
        assert _post(f"{server.url}/nosuch")[0] == 404
        status, out = _post(f"{server.url}/jars/run", {"module": str(tmp_path / "none.py")})
        assert status == 400 and "error" in out


def test_rest_traces_otlp(servers, tmp_path):
    """Checkpoint lifecycle spans as OTLP/JSON at /jobs/<id>/traces."""
    names = {}
    for pkg, (cluster, server) in servers.items():
        job = _submit(server, _app_script(tmp_path, pkg, count=400, sleep=0.02,
                                          checkpoint_ms=50))
        assert cluster.jobs[job].wait(60).value == "FINISHED"
        status, body = _get(f"{server.url}/jobs/{job}/traces")
        assert status == 200
        doc = json.loads(body)
        spans = doc["resourceSpans"][0]["scopeSpans"][0]["spans"]
        names[pkg] = {s["name"] for s in spans}
        assert {"checkpointing.Checkpoint", "checkpointing.CheckpointCapture",
                "checkpointing.CheckpointPersist"} <= names[pkg]
        s0 = next(s for s in spans if s["name"] == "checkpointing.Checkpoint")
        assert len(s0["traceId"]) == 32
        assert "checkpointId" in {a["key"] for a in s0["attributes"]}
        status, body = _get(f"{server.url}/jobs/{job}/checkpoints")
        assert json.loads(body)["counts"]["completed"] >= 1
        status, body = _get(f"{server.url}/jobs/{job}/checkpoints/1")
        assert status == 200 and json.loads(body)["id"] == 1
    # a device.XlaCompile span marks a program geometry's first dispatch in
    # the process, in both packages: it follows what the worker ran before
    assert names["port"] - {"device.XlaCompile"} == names["jax"] - {"device.XlaCompile"}


@pytest.mark.parametrize("pkg", list(PKGS))
def test_rest_bearer_auth(pkg):
    mc, rest, _name, _dev = PKGS[pkg]
    cluster = mc.MiniCluster()
    server = rest.RestServer(cluster, auth_token="s3cret").start()
    try:
        assert _get(f"{server.url}/jobs")[0] == 401
        assert _get(f"{server.url}/jobs", token="wrong")[0] == 401
        assert _get(f"{server.url}/jobs", token="s3cret") == (200, b'{"jobs": []}')
        assert _post(f"{server.url}/jars/run", {})[0] == 401
    finally:
        server.stop()


def test_the_config_derived_bearer_token_is_the_jax_packages():
    """security.rest.auth.enabled: the token derives from the transport
    secret, the same token in both packages for one secret."""
    import flink_tpu.config as jcfg
    import flink_tpu_torch.config as tcfg

    tokens = {}
    for pkg, cfg in (("jax", jcfg), ("port", tcfg)):
        mc, rest, _name, _dev = PKGS[pkg]
        conf = cfg.Configuration({"security.rest.auth.enabled": True,
                                  "security.transport.enabled": True,
                                  "security.transport.secret": "one-cluster-secret"})
        server = rest.RestServer(mc.MiniCluster(), config=conf).start()
        try:
            tokens[pkg] = server._httpd.RequestHandlerClass.auth_token
            assert _get(f"{server.url}/overview")[0] == 401
            assert _get(f"{server.url}/overview", token=tokens[pkg])[0] == 200
        finally:
            server.stop()
    assert tokens["port"] == tokens["jax"] and len(tokens["port"]) == 64


def test_flamegraph_samples_live_threads(servers):
    import threading

    stop = threading.Event()
    worker = threading.Thread(target=stop.wait, name="task-flame", daemon=True)
    worker.start()
    try:
        trees = {}
        for pkg, (_cluster, server) in servers.items():
            status, body = _get(f"{server.url}/flamegraph?duration=0.1&hz=100&filter=task-flame")
            assert status == 200
            doc = json.loads(body)
            assert set(doc) == {"samples", "duration_s", "tree", "folded"}
            assert doc["samples"] > 0 and doc["tree"]["value"] == doc["samples"]
            trees[pkg] = [c["name"] for c in doc["tree"]["children"]]
            assert _get(f"{server.url}/flamegraph?duration=x")[0] == 400
        assert trees["port"] == trees["jax"] == ["task-flame"]
    finally:
        stop.set()
        worker.join()


def test_flamegraph_folds_as_the_jax_packages():
    from flink_tpu.metrics import flamegraph as jfg
    from flink_tpu_torch.metrics import flamegraph as tfg

    folded = {"t1;a;b": 3, "t1;a;c": 1, "t2;d": 2}
    assert tfg.fold_to_tree(folded) == jfg.fold_to_tree(folded)
    assert tfg.fold_to_tree(folded)["value"] == 6


def test_cli_embedded_run(tmp_path, capsys):
    rc = jcli.main(["run", _app_script(tmp_path, "jax"), "--entry", "main"])
    jout = capsys.readouterr().out
    rc_port = tcli.main(["run", _app_script(tmp_path, "port"), "--entry", "main",
                         "--device", "cpu"])
    tout = capsys.readouterr().out
    assert rc == rc_port == 0
    assert re.sub(r"[0-9a-f]{16}", "ID", tout) == re.sub(r"[0-9a-f]{16}", "ID", jout)
    assert "finished with status FINISHED" in tout


def test_cli_embedded_run_takes_the_card_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    """Without --device the embedded run resolves cuda: with no GPU it
    raises before the script runs; an environment the script built
    without a device takes --device."""
    import torch

    from flink_tpu_torch.api import datastream

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        tcli.main(["run", _app_script(tmp_path, "port")])
    devices = []
    real = datastream.StreamExecutionEnvironment.execute_async

    def spy(env, *a, **kw):
        devices.append(env.device)
        return real(env, *a, **kw)

    monkeypatch.setattr(datastream.StreamExecutionEnvironment, "execute_async", spy)
    script = tmp_path / "nodevice.py"
    script.write_text(open(_app_script(tmp_path, "port")).read().replace(
        ', device="cpu")', ")"))
    assert tcli.main(["run", str(script), "--device", "cpu"]) == 0
    assert [str(d) for d in devices] == ["cpu"]


def test_cli_against_rest(servers, tmp_path, capsys):
    outs = {}
    for pkg, (cluster, server) in servers.items():
        cli = tcli if pkg == "port" else jcli
        assert cli.main(["run", _app_script(tmp_path, pkg), "--address", server.url]) == 0
        job = json.loads(capsys.readouterr().out)["jobid"]
        cluster.jobs[job].wait(60)
        assert cli.main(["list", "--address", server.url]) == 0
        listed = json.loads(capsys.readouterr().out)
        assert cli.main(["info", job, "--address", server.url]) == 0
        info = json.loads(capsys.readouterr().out)
        assert cli.main(["metrics", job, "--address", server.url]) == 0
        metrics = json.loads(capsys.readouterr().out)
        assert listed["jobs"][0]["id"] == job and info["status"] == "FINISHED"
        # a long job: a savepoint while it runs, then cancel
        assert cli.main(["run", _app_script(tmp_path, pkg, count=50_000, sleep=0.01),
                         "--address", server.url]) == 0
        long_job = json.loads(capsys.readouterr().out)["jobid"]
        client = cluster.jobs[long_job]
        deadline = time.time() + 30
        while client.records_in < 200 and time.time() < deadline:
            time.sleep(0.01)
        sp = tmp_path / f"sp-{pkg}"
        assert cli.main(["savepoint", long_job, str(sp), "--address", server.url]) == 0
        savepoint = json.loads(capsys.readouterr().out)
        assert cli.main(["cancel", long_job, "--address", server.url]) == 0
        cancel = json.loads(capsys.readouterr().out)
        assert client.wait(30).value == "CANCELED" and sp.exists()
        outs[pkg] = (_keys(listed), {k: info[k] for k in ("status", "records_in")},
                     metrics["job.numRecordsIn"], cancel, _keys(savepoint))
    assert outs["port"] == outs["jax"]


def _bridge(pkg, tmp_path):
    """Each package's cluster (a JobManager and two TaskExecutors) running
    a drill's job to its end, served by a RestServer with its jm_gateway."""
    if pkg == "jax":
        from flink_tpu.runtime.cluster import JobManagerEndpoint, TaskExecutorEndpoint
        from flink_tpu.runtime.rpc import RpcService
        from flink_tpu.testing.harness import ephemeral_transport_security
        scen, kw = jscen, {}
    else:
        from flink_tpu_torch.runtime.cluster import JobManagerEndpoint, TaskExecutorEndpoint
        from flink_tpu_torch.runtime.rpc import RpcService
        from flink_tpu_torch.testing.harness import ephemeral_transport_security
        scen, kw = tscen, {"device": "cpu"}
    mc, rest, _name, _dev = PKGS[pkg]
    sec = ephemeral_transport_security(f"rest-{pkg}")
    svcs = [RpcService(security=sec) for _ in range(3)]
    jm = JobManagerEndpoint(svcs[0], checkpoint_dir=str(tmp_path / f"chk-{pkg}"),
                            checkpoint_interval=0.1, heartbeat_interval=0.2)
    tes = [TaskExecutorEndpoint(s, slots=1, shipping_interval_ms=50, **kw) for s in svcs[1:]]
    server = None
    try:
        for te in tes:
            te.connect(svcs[0].address)
        gw = svcs[0].gateway(svcs[0].address, "jobmanager")
        source = scen.PacedKeyedSource(steps=20, batch=40, n_keys=9, interval_s=0.02)
        job = gw.submit_job(scen._dist_spec(source, "bridged").to_bytes(), 2)
        assert scen._await_job(gw, job)["status"] == "FINISHED"
        time.sleep(0.3)   # the final metric shipment
        server = rest.RestServer(mc.MiniCluster(), jm_gateway=gw).start()
        routes = {}
        for r in ("", "/metrics", "/traces", "/latency", "/history", "/doctor",
                  "/vertices/x/backpressure", "/checkpoints", "/checkpoints/1",
                  "/checkpoints/x", "/exceptions", "/autoscaler", "/device", "/nosuch"):
            status, body = _get(f"{server.url}/jobs/{job}{r}")
            routes[r] = (status, json.loads(body))
        listed = json.loads(_get(f"{server.url}/jobs")[1])["jobs"]
        prom = _get(f"{server.url}/metrics")[1]
        return job, routes, listed, prom, scen._collect_dist(gw.job_result(job)), \
            scen._dist_expected(source)
    finally:
        if server is not None:
            server.stop()
        for te in tes:
            te.stop()
        jm.stop()
        for s in svcs:
            s.stop()


def test_the_distributed_bridge_serves_the_cluster_job_as_the_jax_packages(tmp_path):
    tjob, tr, tlisted, tprom, trows, want = _bridge("port", tmp_path)
    jjob, jr, jlisted, jprom, jrows, _w = _bridge("jax", tmp_path)
    assert trows == jrows == want
    assert {r: s for r, (s, _b) in tr.items()} == {r: s for r, (s, _b) in jr.items()}
    assert tr[""][0] == tr["/metrics"][0] == 200 and tr["/checkpoints/x"][0] == 400
    for r in ("", "/checkpoints", "/exceptions", "/autoscaler", "/device", "/latency",
              "/doctor", "/vertices/x/backpressure"):
        assert _keys(tr[r][1], 1) == _keys(jr[r][1], 1), (r, tr[r][1], jr[r][1])
    assert tr[""][1]["status"] == jr[""][1]["status"] == "FINISHED"
    assert tr[""][1]["num_restarts"] == jr[""][1]["num_restarts"] == 0
    assert set(tr["/metrics"][1]) == set(jr["/metrics"][1])
    assert [j["id"] for j in tlisted] == [tjob] and [j["status"] for j in tlisted] == \
        [j["status"] for j in jlisted]
    tspans = tr["/traces"][1]["resourceSpans"][0]
    assert {a["value"]["stringValue"] for a in tspans["resource"]["attributes"]
            if a["key"] == "service.name"} == {"flink-tpu-torch"}
    assert f'job="{tjob}"'.encode() in tprom and b'shard="0"' in tprom
    assert _families(tprom) == _families(jprom)
