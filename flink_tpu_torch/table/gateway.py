"""SQL gateway: REST sessions executing SQL statements (T4 analogue).

Counterpart of `flink_tpu/table/gateway.py`. Mirrors the reference's SQL
gateway REST surface (flink-sql-gateway: SqlGateway.java:47,
SqlGatewayServiceImpl.java:65; the JDBC driver speaks this protocol):

  POST   /v1/sessions                                  → {sessionHandle}
  DELETE /v1/sessions/<sh>                             → close
  POST   /v1/sessions/<sh>/tables                      → register a table
         {"name", "columns": [..], "rows": [...], "time_col",
          "watermark_delay_ms", "types": ["int"|"float"|"str", ..]}
  POST   /v1/sessions/<sh>/statements                  → {"statement": sql}
                                   → {operationHandle, executionPath,
                                      fallbackReason}
  GET    /v1/sessions/<sh>/operations/<oh>/status      → {status,
                                      executionPath, fallbackReason}
  GET    /v1/sessions/<sh>/operations/<oh>/result/<tk> → {columns, data, resultType}

Each session owns a TableEnvironment on the gateway's device (CUDA unless
the gateway was made with device="cpu"); statements run the SQL planner
(planner/ → table_env.py) on the session's tables, and every submitted
statement reports which execution path it selected: `executionPath` is
"fused" when the planner lowered it onto the fused device chain (kernel
K1; requires declared numeric column `types`), else "interpreted" with the
catalogued `fallbackReason` attributed. A statement the port cannot run
yet (joins, UNION ALL, multi-aggregate SELECTs, ML_PREDICT) ends in ERROR
with the error naming its ROADMAP.md item.

With `auth_token` set, every request must carry `Authorization: Bearer
<token>`; a missing or wrong token is a 401 before any route logic runs.
"""

from __future__ import annotations

import json
import threading
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

from flink_tpu_torch.api.datastream import StreamExecutionEnvironment
from flink_tpu_torch.security import bearer_header_equal
from flink_tpu_torch.table.table_env import TableEnvironment, TableSchema
from flink_tpu_torch.utils.arrays import jsonable as _json_value


class _Session:
    def __init__(self, device=None):
        self.tenv = TableEnvironment(StreamExecutionEnvironment(device=device))
        self.operations: Dict[str, dict] = {}
        # statements on ONE session run sequentially (the reference
        # gateway's per-session operation ordering): the session's
        # TableEnvironment is shared mutable state — its sink list and
        # last_plan_report would cross-stamp under the ThreadingHTTPServer
        # if two statements interleaved
        self.lock = threading.Lock()


class SqlGateway:
    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 auth_token: Optional[str] = None, device=None):
        self._sessions: Dict[str, _Session] = {}
        gw = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def _json(self, code: int, obj) -> None:
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _authorized(self) -> bool:
                if auth_token is None:
                    return True
                # single-sourced with runtime/rest.py (security layer):
                # one constant-time, non-ASCII-safe comparison for every
                # HTTP plane
                if bearer_header_equal(
                        self.headers.get("Authorization") or "",
                        auth_token):
                    return True
                self._json(401, {"error": "missing or invalid bearer token"})
                return False

            def _body(self) -> dict:
                n = int(self.headers.get("Content-Length") or 0)
                return json.loads(self.rfile.read(n) or b"{}")

            def do_POST(self):
                if not self._authorized():
                    return
                parts = self.path.strip("/").split("/")
                try:
                    if parts == ["v1", "sessions"]:
                        sh = uuid.uuid4().hex[:16]
                        gw._sessions[sh] = _Session(device)
                        return self._json(200, {"sessionHandle": sh})
                    if len(parts) == 4 and parts[:2] == ["v1", "sessions"]:
                        sess = gw._sessions.get(parts[2])
                        if sess is None:
                            return self._json(404, {"error": "unknown session"})
                        if parts[3] == "tables":
                            b = self._body()
                            with sess.lock:
                                sess.tenv.from_rows(
                                    b["name"], b["rows"],
                                    TableSchema(
                                        b["columns"], b.get("time_col"),
                                        b.get("watermark_delay_ms", 0),
                                        field_types=b.get("types"),
                                    ),
                                )
                            return self._json(200, {"registered": b["name"]})
                        if parts[3] == "statements":
                            b = self._body()
                            oh = uuid.uuid4().hex[:16]
                            op = {"status": "RUNNING", "rows": None,
                                  "error": None, "executionPath": None,
                                  "fallbackReason": None}
                            sess.operations[oh] = op
                            with sess.lock:
                                try:
                                    op["rows"] = sess.tenv.execute_sql_to_list(
                                        b["statement"])
                                    op["status"] = "FINISHED"
                                except Exception as e:  # noqa: BLE001 — surfaced via REST
                                    op["status"] = "ERROR"
                                    op["error"] = f"{type(e).__name__}: {e}"
                                # path selection (flink_tpu/planner):
                                # which execution path the statement took,
                                # with the catalogued reason when it fell
                                # back — read under the SAME lock so a
                                # concurrent statement cannot cross-stamp
                                report = sess.tenv.last_plan_report
                            if report is not None:
                                op["executionPath"] = report.path
                                op["fallbackReason"] = report.reason
                            return self._json(200, {
                                "operationHandle": oh,
                                "executionPath": op["executionPath"],
                                "fallbackReason": op["fallbackReason"],
                            })
                    return self._json(404, {"error": f"no route {self.path}"})
                except Exception as e:  # noqa: BLE001
                    return self._json(500, {"error": f"{type(e).__name__}: {e}"})

            def do_GET(self):
                if not self._authorized():
                    return
                parts = self.path.strip("/").split("/")
                if (len(parts) >= 6 and parts[:2] == ["v1", "sessions"]
                        and parts[3] == "operations"):
                    sess = gw._sessions.get(parts[2])
                    op = sess.operations.get(parts[4]) if sess else None
                    if op is None:
                        return self._json(404, {"error": "unknown operation"})
                    if parts[5] == "status":
                        return self._json(200, {
                            "status": op["status"], "error": op["error"],
                            "executionPath": op["executionPath"],
                            "fallbackReason": op["fallbackReason"],
                        })
                    if parts[5] == "result":
                        if op["status"] == "ERROR":
                            return self._json(400, {"error": op["error"]})
                        rows = op["rows"] or []
                        columns = sorted({k for r in rows for k in r}) if rows else []
                        return self._json(200, {
                            "resultType": "EOS",
                            "columns": columns,
                            "data": [[_json_value(r.get(c)) for c in columns]
                                     for r in rows],
                        })
                return self._json(404, {"error": f"no route {self.path}"})

            def do_DELETE(self):
                if not self._authorized():
                    return
                parts = self.path.strip("/").split("/")
                if len(parts) == 3 and parts[:2] == ["v1", "sessions"]:
                    gw._sessions.pop(parts[2], None)
                    return self._json(200, {"closed": True})
                return self._json(404, {"error": f"no route {self.path}"})

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._server.server_address
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name=f"sql-gateway-{self.port}", daemon=True)
        self._thread.start()

    @property
    def address(self) -> str:
        return f"http://{self.host}:{self.port}"

    def session_env(self, session_handle: str) -> TableEnvironment:
        """Server-side access to a session's environment (e.g. to register
        tables over streams, which are not JSON)."""
        return self._sessions[session_handle].tenv

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()


class SqlGatewayClient:
    """Minimal client speaking the gateway protocol (JDBC-driver analogue)."""

    def __init__(self, address: str, auth_token: Optional[str] = None):
        self.address = address.rstrip("/")
        self.auth_token = auth_token

    def _request(self, method: str, path: str, body: Optional[dict] = None) -> dict:
        import urllib.request

        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(self.address + path, data=data, method=method)
        req.add_header("Content-Type", "application/json")
        if self.auth_token is not None:
            req.add_header("Authorization", f"Bearer {self.auth_token}")
        try:
            with urllib.request.urlopen(req, timeout=60) as resp:
                return json.loads(resp.read())
        except urllib.error.HTTPError as e:
            try:
                detail = json.loads(e.read()).get("error", str(e))
            except Exception:
                detail = str(e)
            raise RuntimeError(f"gateway {method} {path}: {detail}") from None

    def open_session(self) -> str:
        return self._request("POST", "/v1/sessions")["sessionHandle"]

    def register_table(self, sh: str, name: str, columns: List[str], rows: List[dict],
                       time_col: Optional[str] = None,
                       watermark_delay_ms: int = 0,
                       types: Optional[List[str]] = None) -> None:
        """`types` (one of 'int'/'float'/'str' per column) declares the
        schema the SQL planner needs to lower statements onto the fused
        device path; untyped tables always interpret."""
        self._request("POST", f"/v1/sessions/{sh}/tables", {
            "name": name, "columns": columns, "rows": rows,
            "time_col": time_col, "watermark_delay_ms": watermark_delay_ms,
            "types": types,
        })

    def execute(self, sh: str, statement: str) -> List[dict]:
        oh = self._request("POST", f"/v1/sessions/{sh}/statements",
                           {"statement": statement})["operationHandle"]
        status = self._request("GET", f"/v1/sessions/{sh}/operations/{oh}/status")
        if status["status"] == "ERROR":
            raise RuntimeError(status["error"])
        res = self._request("GET", f"/v1/sessions/{sh}/operations/{oh}/result/0")
        return [dict(zip(res["columns"], row)) for row in res["data"]]

    def statement_status(self, sh: str, oh: str) -> dict:
        """Raw status payload incl. executionPath/fallbackReason."""
        return self._request("GET", f"/v1/sessions/{sh}/operations/{oh}/status")

    def close_session(self, sh: str) -> None:
        self._request("DELETE", f"/v1/sessions/{sh}")
