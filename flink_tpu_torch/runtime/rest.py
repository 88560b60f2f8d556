"""REST endpoint + minimal web dashboard.

Capability parity with the reference's web monitor / REST stack
(runtime/rest handlers, WebMonitorEndpoint.java:224, RestClusterClient
submission, the Angular dashboard O5 — here a dependency-free single-page
view). Endpoints:

  GET  /                      → HTML dashboard (jobs + metrics, auto-refresh)
  GET  /overview              → cluster overview JSON
  GET  /jobs                  → [{id, name, status}]
  GET  /jobs/<id>             → job detail JSON
  PATCH/POST /jobs/<id>/cancel→ cancel
  POST /jobs/<id>/savepoints  → {"target-directory": dir} → trigger savepoint
  GET  /jobs/<id>/metrics     → metrics JSON
  GET  /jobs/<id>/vertices/<uid>/backpressure
                              → busy/idle/backPressured ratios + level
                                (JobVertexBackPressureHandler analogue)
  GET  /jobs/<id>/checkpoints → checkpoint statistics: counts, summary,
                                latest completed/failed/restored, bounded
                                per-checkpoint history
                                (CheckpointingStatisticsHandler analogue)
  GET  /jobs/<id>/checkpoints/<cid>
                              → one retained checkpoint's record
  GET  /jobs/<id>/exceptions  → bounded exception history + recovery
                                timeline (JobExceptionsHandler analogue)
  GET  /jobs/<id>/autoscaler  → autoscaler decision log + rescale counters
                                (scheduler/ — signals seen, action taken,
                                outcome, rescale durations)
  GET  /jobs/<id>/device      → device-plane observability: compile/
                                recompile counters + bounded event ring
                                with cause attribution, per-operator
                                roofline utilization and phase counters,
                                key-skew telemetry, profiler capture
                                surface (metrics/device_stats.py)
  GET  /metrics               → Prometheus text exposition (all jobs)
  POST /jars/run              → {"module": "/path/script.py", "entry": "main"}
                                application-mode submission: the script builds
                                an env and returns it (or calls execute_async)

Implementation: stdlib http.server (threaded), JSON payloads.

Distributed bridge: constructed with `jm_gateway` (an RPC gateway to a
JobManagerEndpoint), the same routes ALSO serve that cluster's jobs — the
JM aggregates the metric snapshots and trace spans its TaskExecutors ship
on the authenticated RPC plane, and this server renders them as JSON,
OTLP/JSON traces, and Prometheus text (per-shard samples labeled
{job,shard}).

Counterpart of `flink_tpu/runtime/rest.py`: the same routes, payloads and
status codes over the port's MiniCluster and JobManagerEndpoint. A job
submitted through `POST /jars/run` runs on its environment's device (the
card unless the script asked for the CPU). A port JobClient carries its
observability planes from the moment its job thread wires them (`metrics`
and the rest are None before), so a route reads a plane only once it is
there and answers the JAX package's empty payload until then.
"""

from __future__ import annotations

import importlib.util
import json
import logging
import threading
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from flink_tpu_torch.metrics.registry import (
    merge_prometheus_text,
    prometheus_text,
    prometheus_text_from_snapshot,
)
from flink_tpu_torch.metrics.task_io import backpressure_level
from flink_tpu_torch.runtime.minicluster import MiniCluster
from flink_tpu_torch.runtime.web_dashboard import DASHBOARD_HTML


def _has(client, plane: str) -> bool:
    """Whether a job carries an observability plane yet (wired when its
    job thread starts)."""
    return getattr(client, plane, None) is not None


class _Handler(BaseHTTPRequestHandler):
    cluster: MiniCluster = None  # set by RestServer
    jm = None                    # optional JobManagerEndpoint RPC gateway

    # -- plumbing ---------------------------------------------------------
    def log_message(self, fmt, *args):  # quiet
        pass

    def _send(self, code: int, body: bytes, content_type="application/json"):
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _json(self, code: int, obj):
        self._send(code, json.dumps(obj).encode())

    def _read_body(self) -> dict:
        length = int(self.headers.get("Content-Length", 0))
        if length == 0:
            return {}
        return json.loads(self.rfile.read(length))

    def _job(self, job_id: str):
        return self.cluster.jobs.get(job_id)

    # -- GET --------------------------------------------------------------
    auth_token: Optional[str] = None

    def _authorized(self) -> bool:
        if self.auth_token is None:
            return True
        from flink_tpu_torch.security import bearer_header_equal

        if bearer_header_equal(self.headers.get("Authorization", ""),
                               self.auth_token):
            return True
        self._json(401, {"error": "missing or invalid bearer token"})
        return False

    def do_GET(self):
        if not self._authorized():
            return
        parts = [p for p in self.path.split("?")[0].split("/") if p]
        if not parts:
            # the live dashboard (web_dashboard.py) polls the JSON routes
            return self._send(200, DASHBOARD_HTML.encode(), "text/html")
        if parts == ["overview"]:
            by_status = {}
            for c in self.cluster.jobs.values():
                by_status[c.status().value] = by_status.get(c.status().value, 0) + 1
            return self._json(200, {"jobs": len(self.cluster.jobs), "by_status": by_status})
        if parts == ["jobs"]:
            jobs = [
                {"id": c.job_id, "name": c.job_name, "status": c.status().value}
                for c in self.cluster.jobs.values()
            ]
            if self.jm is not None:
                try:
                    jobs.extend(self.jm.list_jobs())
                except Exception as e:   # unreachable JM: local jobs still
                    logging.getLogger(__name__).debug(   # serve
                        "jm list_jobs unavailable: %r", e)
            return self._json(200, {"jobs": jobs})
        if parts == ["metrics"]:
            texts = []
            for c in self.cluster.jobs.values():
                if _has(c, "metrics"):
                    # every sample labeled by job id: two jobs share family
                    # names, and unlabeled duplicates are invalid exposition
                    texts.append(prometheus_text(c.metrics.all_metrics(),
                                                 labels={"job": c.job_id}))
            if self.jm is not None:
                # distributed jobs: per-shard snapshots the TMs shipped over
                # RPC, labeled so Prometheus keeps shards distinguishable
                try:
                    for j in self.jm.list_jobs():
                        jm_metrics = self.jm.job_metrics(j["id"])
                        for shard, snap in jm_metrics["per_shard"].items():
                            texts.append(prometheus_text_from_snapshot(
                                snap, labels={"job": j["id"], "shard": shard}))
                        # JM-side control-plane gauges (checkpoint stats,
                        # restart/downtime, watermark skew) live on the
                        # coordinator, not any shard — own labeled snapshot
                        jm_side = jm_metrics.get("jm") or {}
                        if jm_side:
                            texts.append(prometheus_text_from_snapshot(
                                jm_side, labels={"job": j["id"]}))
                except Exception as e:   # unreachable JM: local exposition
                    logging.getLogger(__name__).debug(   # still serves
                        "jm metrics unavailable: %r", e)
            # one TYPE line per family, samples grouped — naive
            # concatenation is invalid exposition once two jobs/shards
            # share a family name
            text = merge_prometheus_text(texts) if texts else ""
            return self._send(200, text.encode(), "text/plain; version=0.0.4")
        if parts == ["flamegraph"]:
            # on-demand thread sampling (JobVertexFlameGraphHandler analogue);
            # ?duration=0.5&filter=task samples live process threads
            from urllib.parse import parse_qs, urlparse

            from flink_tpu_torch.metrics.flamegraph import flame_graph

            q = parse_qs(urlparse(self.path).query)
            try:
                duration = min(max(float(q.get("duration", ["0.3"])[0]), 0.01), 10.0)
                hz = min(max(float(q.get("hz", ["50"])[0]), 1.0), 1000.0)
            except ValueError:
                return self._json(400, {"error": "duration/hz must be numbers"})
            return self._json(200, flame_graph(
                duration_s=duration, hz=hz,
                thread_filter=(q.get("filter", [None])[0]),
            ))
        if len(parts) >= 2 and parts[0] == "jobs":
            client = self._job(parts[1])
            if client is None:
                if self.jm is not None:
                    return self._jm_job_routes(parts)
                return self._json(404, {"error": f"unknown job {parts[1]}"})
            if len(parts) == 2:
                detail = {
                    "id": client.job_id,
                    "name": client.job_name,
                    "status": client.status().value,
                    "records_in": client.records_in,
                    "num_restarts": client.num_restarts,
                    "num_checkpoints": getattr(client, "num_checkpoints", 0),
                    "trace_id": getattr(client, "trace_id", None),
                    "error": repr(client.error) if client.error else None,
                }
                # SQL front-door path selection: jobs whose window steps
                # came from the SQL planner carry job.sqlFusedSelected
                # (1 = fused superscan, 0 = interpreted-style execution);
                # non-SQL jobs simply omit the field
                if _has(client, "metrics"):
                    g = client.metrics.all_metrics().get(
                        "job.sqlFusedSelected")
                    if g is not None:
                        detail["sqlFusedSelected"] = g.value()
                return self._json(200, detail)
            if parts[2] == "vertices" and len(parts) == 5 \
                    and parts[4] == "backpressure":
                return self._backpressure(client, parts[3])
            if parts[2] == "traces":
                # OTLP/JSON resourceSpans (OpenTelemetryTraceReporter SPI)
                if not _has(client, "otel"):
                    return self._json(200, {"resourceSpans": []})
                return self._json(200, client.otel.payload())
            if parts[2] == "latency" and len(parts) == 3:
                # emission-latency plane: event-time tail + stall attribution
                from flink_tpu_torch.metrics.emission_latency import (
                    build_latency_report,
                )

                if hasattr(client, "latency_report"):
                    return self._json(200, _jsonable(client.latency_report()))
                return self._json(200, _jsonable(build_latency_report({}, [])))
            if parts[2] == "history" and len(parts) == 3:
                # metrics history plane: bounded per-key time-series rings
                # sampled on the job's processing-time tick
                metric, since = self._history_query()
                if since is None and "since" in self.path:
                    return self._json(400, {"error": "since must be a number"})
                if hasattr(client, "history_report"):
                    return self._json(200, _jsonable(
                        client.history_report(metric=metric, since=since)))
                return self._json(200, {"enabled": False, "series": {},
                                        "sample_count": 0})
            if parts[2] == "doctor" and len(parts) == 3:
                # job doctor: ranked bottleneck attribution over the recent
                # history window joined with the span stream
                if hasattr(client, "doctor_report"):
                    return self._json(200, _jsonable(client.doctor_report()))
                return self._json(200, {"verdict": "unknown", "score": 0.0,
                                        "diagnoses": []})
            if parts[2] == "metrics":
                if not _has(client, "metrics"):
                    return self._json(200, {})
                out = {}
                for k, m in client.metrics.all_metrics().items():
                    v = m.value()
                    out[k] = v if isinstance(v, (int, float, dict)) else str(v)
                return self._json(200, out)
            if parts[2] == "checkpoints":
                from flink_tpu_torch.metrics.checkpoint_stats import (
                    empty_checkpoints_payload,
                )

                stats = getattr(client, "checkpoint_stats", None)
                if len(parts) == 3:
                    return self._json(200, _jsonable(
                        stats.payload() if stats is not None
                        else empty_checkpoints_payload()))
                if len(parts) == 4:
                    if not parts[3].isdigit():
                        return self._json(
                            400, {"error": "checkpoint id must be an integer"})
                    rec = stats.checkpoint(int(parts[3])) if stats else None
                    if rec is None:
                        return self._json(404, {
                            "error": f"no retained stats for checkpoint "
                                     f"{parts[3]}"})
                    return self._json(200, _jsonable(rec))
            if parts[2] == "exceptions" and len(parts) == 3:
                from flink_tpu_torch.metrics.checkpoint_stats import (
                    empty_exceptions_payload,
                )

                hist = getattr(client, "exceptions", None)
                return self._json(200, _jsonable(
                    hist.payload() if hist is not None
                    else empty_exceptions_payload()))
            if parts[2] == "autoscaler" and len(parts) == 3:
                # decision log + rescale counters (scheduler/); MiniCluster
                # jobs run observe-only, so decisions carry outcome
                # 'observe-only' and parallelism is the single in-process task
                from flink_tpu_torch.scheduler import empty_autoscaler_payload

                auto = getattr(client, "autoscaler", None)
                payload = (auto.payload(client.job_id) if auto is not None
                           else empty_autoscaler_payload())
                payload.setdefault("parallelism", 1)
                return self._json(200, _jsonable(payload))
            if parts[2] == "device" and len(parts) == 3:
                # device plane (metrics/device_stats.py): compile events,
                # roofline/phase attribution, key skew, profiler captures
                from flink_tpu_torch.metrics.device_stats import (
                    empty_device_payload,
                )

                rt = getattr(client, "_runtime", None)
                return self._json(200, _jsonable(
                    rt.device_snapshot() if rt is not None
                    else empty_device_payload()))
            if parts[2] == "state" and len(parts) == 4:
                # queryable state (S13): /jobs/<id>/state/<uid>?key=K
                from urllib.parse import parse_qs, urlparse

                qs = parse_qs(urlparse(self.path).query)
                if "key" not in qs:
                    return self._json(400, {"error": "key query param required"})
                raw = qs["key"][0]
                key: object = int(raw) if raw.lstrip("-").isdigit() else raw
                try:
                    result = client.query_state(parts[3], key)
                except KeyError as e:
                    return self._json(404, {"error": str(e)})
                except RuntimeError as e:
                    return self._json(409, {"error": str(e)})
                return self._json(200, _jsonable(result))
        self._json(404, {"error": f"no route {self.path}"})

    # -- observability helpers --------------------------------------------
    def _history_query(self):
        """Parse ?metric=&since= for the history routes; `since` is epoch
        ms (None when absent or non-numeric — the caller 400s on the
        latter when the param was present)."""
        from urllib.parse import parse_qs, urlparse

        qs = parse_qs(urlparse(self.path).query)
        metric = qs.get("metric", [None])[0]
        since = None
        raw = qs.get("since", [None])[0]
        if raw is not None:
            try:
                since = float(raw)
            except ValueError:
                since = None
        return metric, since

    def _backpressure(self, client, uid: str):
        """Backpressure view of an in-process (MiniCluster) job: the job
        runs as ONE task, so the task-level busy/idle/backPressured ratios
        are its single subtask's sample; vertex-scoped metrics (latency
        histogram, device time, state bytes) ride along for the vertex."""
        if not _has(client, "metrics"):
            return self._json(200, {"status": "deprecated", "subtasks": []})
        snap = {}
        for k, m in client.metrics.all_metrics().items():
            try:
                snap[k] = m.value()
            except Exception:
                continue
        bp = float(snap.get("job.backPressuredTimeRatio", 0.0) or 0.0)
        busy = float(snap.get("job.busyTimeRatio", 0.0) or 0.0)
        idle = float(snap.get("job.idleTimeRatio", 0.0) or 0.0)
        prefix = f"job.operator.{uid}."
        vertex_metrics = {
            k[len(prefix):]: v for k, v in snap.items() if k.startswith(prefix)
        }
        return self._json(200, _jsonable({
            "status": "ok",
            "vertex": uid,
            "backpressureLevel": backpressure_level(bp),
            "busyRatio": busy,
            "idleRatio": idle,
            "backPressuredRatio": bp,
            "subtasks": [{
                "subtask": 0,
                "backpressureLevel": backpressure_level(bp),
                "backPressuredRatio": bp,
                "busyRatio": busy,
                "idleRatio": idle,
            }],
            "metrics": vertex_metrics,
        }))

    def _jm_job_routes(self, parts):
        """Serve a distributed job from the bridged JobManagerEndpoint (the
        aggregates its TaskExecutors shipped over the RPC plane)."""
        job_id = parts[1]
        try:
            if len(parts) == 2:
                st = self.jm.job_status(job_id)
                return self._json(200, {
                    "id": job_id, "name": st["name"], "status": st["status"],
                    "num_restarts": st["restarts"],
                    "trace_id": st.get("trace_id"),
                    "checkpoints": st["checkpoints"],
                    "error": st.get("failure"),
                })
            if parts[2] == "metrics" and len(parts) == 3:
                return self._json(200, _jsonable(self.jm.job_metrics(job_id)))
            if parts[2] == "traces" and len(parts) == 3:
                from flink_tpu_torch.metrics.otel import span_to_otlp, spans_to_otlp
                from flink_tpu_torch.metrics.traces import Span

                enc = [span_to_otlp(Span.from_dict(d))
                       for d in self.jm.job_spans(job_id)]
                return self._json(200, spans_to_otlp(enc, "flink-tpu-torch"))
            if parts[2] == "latency" and len(parts) == 3:
                return self._json(200, _jsonable(
                    self.jm.job_latency(job_id)))
            if parts[2] == "history" and len(parts) == 3:
                metric, since = self._history_query()
                return self._json(200, _jsonable(
                    self.jm.job_history(job_id, metric=metric, since=since)))
            if parts[2] == "doctor" and len(parts) == 3:
                return self._json(200, _jsonable(
                    self.jm.job_doctor(job_id)))
            if parts[2] == "vertices" and len(parts) == 5 \
                    and parts[4] == "backpressure":
                return self._json(200, _jsonable(
                    self.jm.job_backpressure(job_id)))
            if parts[2] == "checkpoints" and len(parts) == 3:
                return self._json(200, _jsonable(
                    self.jm.job_checkpoints(job_id)))
            if parts[2] == "checkpoints" and len(parts) == 4:
                if not parts[3].isdigit():
                    return self._json(
                        400, {"error": "checkpoint id must be an integer"})
                return self._json(200, _jsonable(
                    self.jm.job_checkpoint(job_id, int(parts[3]))))
            if parts[2] == "exceptions" and len(parts) == 3:
                return self._json(200, _jsonable(
                    self.jm.job_exceptions(job_id)))
            if parts[2] == "autoscaler" and len(parts) == 3:
                return self._json(200, _jsonable(
                    self.jm.job_autoscaler(job_id)))
            if parts[2] == "device" and len(parts) == 3:
                return self._json(200, _jsonable(
                    self.jm.job_device(job_id)))
        except Exception as e:  # noqa: BLE001 — JM lookup failures -> 404
            return self._json(404, {"error": repr(e)})
        return self._json(404, {"error": f"no route {self.path}"})

    # -- POST/PATCH -------------------------------------------------------
    def do_POST(self):
        if not self._authorized():
            return
        parts = [p for p in self.path.split("?")[0].split("/") if p]
        if parts == ["jars", "run"]:
            body = self._read_body()
            try:
                client = _run_application(self.cluster, body["module"], body.get("entry", "main"))
            except Exception as e:  # noqa: BLE001 — surface to caller
                return self._json(400, {"error": repr(e)})
            return self._json(200, {"jobid": client.job_id})
        if len(parts) == 3 and parts[0] == "jobs":
            client = self._job(parts[1])
            if client is None:
                return self._json(404, {"error": f"unknown job {parts[1]}"})
            if parts[2] == "cancel":
                client.cancel()
                return self._json(202, {"status": "cancelling"})
            if parts[2] == "savepoints":
                body = self._read_body()
                target = body.get("target-directory")
                if not target:
                    return self._json(400, {"error": "target-directory required"})
                try:
                    path = client.trigger_savepoint(target)
                except TimeoutError as e:
                    return self._json(409, {"error": str(e)})
                return self._json(200, {"location": path})
        self._json(404, {"error": f"no route {self.path}"})

    do_PATCH = do_POST


# single-sourced with the SQL gateway (utils/arrays.jsonable)
from flink_tpu_torch.utils.arrays import jsonable as _jsonable  # noqa: E402


def _run_application(cluster: MiniCluster, module_path: str, entry: str):
    """Application-mode submission: import the script, call its entry — the
    entry must return a JobClient (via env.execute_async()) or a
    StreamExecutionEnvironment (which we then submit, on the environment's
    device: CUDA unless the script asked for the CPU)."""
    spec = importlib.util.spec_from_file_location(f"flink_tpu_torch_app_{uuid.uuid4().hex}",
                                                  module_path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fn = getattr(mod, entry)
    result = fn()
    from flink_tpu_torch.api.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.graph.transformation import plan
    from flink_tpu_torch.runtime.minicluster import JobClient

    if isinstance(result, JobClient):
        cluster.jobs.setdefault(result.job_id, result)
        return result
    if isinstance(result, StreamExecutionEnvironment):
        if len(result._sinks) != 1:
            raise RuntimeError("application must define exactly one sink")
        # iteration tails live in env._roots (reachable only via close_with)
        roots = result._sinks[:1] + getattr(result, "_roots", [])
        return cluster.submit(plan(roots), result.config, device=result.device)
    raise TypeError(f"{entry}() must return JobClient or StreamExecutionEnvironment")


class RestServer:
    """Threaded REST server bound to a MiniCluster (WebMonitorEndpoint)."""

    def __init__(self, cluster: Optional[MiniCluster] = None, port: int = 0,
                 auth_token: Optional[str] = None, config=None,
                 jm_gateway=None):
        """auth_token: when set, every request must carry
        `Authorization: Bearer <token>` (the reference's SSL/Kerberos
        plumbing is deployment-level — TLS terminates at the ingress in the
        K8s deployment, this guards the API itself).

        With `config` given and `security.rest.auth.enabled: true`, the
        token derives from the SAME cluster secret that authenticates the
        internal planes (flink_tpu_torch.security.rest_bearer_token) — one secret
        to provision for the whole cluster."""
        self.cluster = cluster or MiniCluster.get_shared()
        if auth_token is None and config is not None:
            from flink_tpu_torch.config import SecurityOptions
            from flink_tpu_torch.security import SecurityConfig, rest_bearer_token

            if config.get(SecurityOptions.REST_AUTH_ENABLED):
                # explicit security.transport.* settings win; otherwise the
                # token derives from the bound cluster's own resolved
                # identity so REST and the internal planes share ONE secret
                explicit = any(config.contains(o) for o in (
                    SecurityOptions.TRANSPORT_ENABLED,
                    SecurityOptions.TRANSPORT_SECRET,
                    SecurityOptions.TRANSPORT_SECRET_FILE,
                ))
                sec = (SecurityConfig.resolve(config) if explicit
                       else self.cluster.security)
                if not sec.enabled:
                    raise ValueError(
                        "security.rest.auth.enabled requires "
                        "security.transport.enabled (the bearer token "
                        "derives from the transport secret)"
                    )
                auth_token = rest_bearer_token(sec)
        handler = type("BoundHandler", (_Handler,),
                       {"cluster": self.cluster, "auth_token": auth_token,
                        "jm": jm_gateway})
        self._httpd = ThreadingHTTPServer(("127.0.0.1", port), handler)
        self.port = self._httpd.server_port
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def start(self) -> "RestServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="rest-server", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
